#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (any exception ends the run with a non-zero
exit code and no result line):

1. card   — the device's name and power limit from nvidia-smi;
2. build  — nvcc builds all four kernels (int8_gemm, ita_attention, igelu,
   itamax) from src/repro_torch/csrc, one process each, in parallel, and
   prints each kernel's registers and spills (-Xptxas -v); where the
   toolkit has cuobjdump, the SASS of int8_gemm and ita_attention must
   hold integer tensor-core instructions (IMMA for mma.sync, a GMMA form
   for wgmma), and each kernel function of itamax and igelu prints its
   count of SASS instructions;
3. kernels — each kernel, launched on the card at the shapes the main
   paths give it (plus ragged, multi-block, padded, GQA and causal cases),
   must equal its plain PyTorch version run on CPU copies of the same
   inputs (integer-exact: tolerance zero); then it is timed on the device
   (CUDA graph replays between CUDA events), per call with its dispatch,
   and its plain version on the card per call.  int8_gemm and
   ita_attention print each shape's time beside the recorded time of the
   CUDA-core versions they replaced and, for the GEMM, torch._int_mm's
   time in the same call; itamax and igelu print theirs beside the
   recorded time of their first versions and beside their floor: the same
   kernel timed the same way on one row of one element (itamax) or on 16
   elements (igelu), which tells a kernel bound by its launch from one
   that is still slow.  The exact integer product
   of the plain path (``quant.qparams.imatmul`` on CUDA: ``torch._int_mm``
   or float64) must equal the CPU's int32 product, a wrapping case included,
   and every product shape that ``torch._int_mm`` refuses on the card must
   be one that the exact product keeps off it;
4. slice  — compile(cfg, backend) -> session(8) -> forward on the card, for
   - ``ita``: MobileBERT, Whisper-tiny-encoder and DINOv2-small at their
     full configs (int8_gemm and ita_attention);
   - ``w8a8``: the same three (exact integer products and the itamax
     kernel, once per layer);
   - ``ita`` at DeiT-Ti widths (dinov2-small with d_model 192, 3x64 heads,
     d_ff 768, 197 patches; Touvron et al. 2021, Table 1): the GEMMs go to
     the cluster, so each GELU stays a node of its own and runs the igelu
     kernel;
   random weights from seed 0, batch 8.  The launch counters, set to 0
   just before the timed forwards, must grow by exactly the plan's kernel
   calls, and the output must equal, bit for bit, the same session's
   forward on the CPU;
5. decoder — OLMo-1B at its full published width and depth (16 layers,
   d_model 2048, 16 heads of 128, d_ff 8192, vocab 50304): compile(seq_len
   128, max_len 160) -> session(8) -> one prefill and 16 greedy decode
   steps, on ``ita`` and ``w8a8``, with one set of weights (seed 0) for
   every session.  int8_gemm must launch exactly 112 times per ``ita``
   prefill (7 GEMMs a layer) and no kernel at all per decode step; the
   two backends' logits and KV caches must be equal at every step, and
   equal to the port's own prefill_w8a8 / decode_step_w8a8 chain on the
   card.  A short prompt (seq_len 32, max_len 40, batch 2, 3 decode steps)
   checks the card against the CPU at full width and depth, and the
   prefill time, the time per decode step and the generated tokens per
   second print per backend;
6. head-by-head — the paper's per-head MHA schedule: compile(cfg,
   head_by_head=True) -> session(8) -> forward for the three encoders at
   their full configs on ``ita`` and ``w8a8``.  The launches per forward
   must be the plan's (``ita``: ita_attention once a head at H = 1, and
   int8_gemm for the MLP only, since a head's Q/K/V projections are 64
   wide and go to the cluster; ``w8a8``: itamax once a head) and the
   output must equal the CPU forward bit for bit.  The kernel phase holds
   ita_attention at these H = 1 shapes against its plain version and
   times it;
7. paged  — OLMo-1B at full width and depth over a paged KV region
   (seq_len 128, blocks of 16 rows, max_len 272, a pool of 145 blocks),
   batch 8, both backends, one weight draw: every slot prefills a
   2-chunk prompt by prefill_chunks; half the slots are freed, attach the
   first 200 rows of slot 0's chain (a partial last block) and prefill
   their tails, which copies the shared blocks they overwrite; 16 greedy
   decode steps follow with one slot parked by ``active``, and one slot
   is freed and re-prefilled mid-run.  int8_gemm must launch 112 times
   per ``ita`` chunk and never in a decode step; the logits must equal
   the dense pair's (the same prompts prefilled and teacher-forced over a
   dense region of 272 rows, where both attend in one flash block) at
   every step, the shared slots' must equal the same prompts prefilled
   unshared, ``ita`` must equal ``w8a8`` (pools included), and the free
   blocks and copy-on-write copies must be those the block arithmetic
   predicts.  A short prompt (seq_len 32, batch 2) runs the same steps on
   the card and on the CPU and must give the same ints.  The chunk and
   decode-step times print beside the dense pair's.

8. engine — OLMo-1B at full width through the request-level engine
   (``Engine``) over the paged phase's pool (blocks of 16 rows, 145 blocks,
   chunks of 128, max_len 272, 8 slots, prefix cache on), one weight draw:
   12 greedy requests of 16 tokens whose prompts (128-256 tokens) share a
   200-token prefix (four of them) or repeat another exactly (two), one
   cancelled while resident.  The ``ita`` engine, the ``w8a8`` engine and
   an ``ita`` engine without the prefix cache must stream the same tokens;
   int8_gemm must launch 112 times per prefill dispatch of the ``ita``
   engines (counted per ``prefill_slot`` / ``prefill_chunks`` call) and no
   kernel in a decode step; the prefix cache's hits and the sharing audit
   must be those predicted.  The ``ita`` engine then serves the first 8
   requests behind ``AsyncEngine`` + ``ServingFrontend`` to 8 concurrent
   HTTP streams, which must carry the same tokens.  Each run prints
   ``EngineStats.summary()`` (tok/s, TTFT, TPOT and step p50 / p99, prefix
   hit rate, occupancy, the plan's verification time).
9. audit  — the static plan verifier and the autotuner (every phase above
   compiles with ``verify=True``, the default): the verifier's time and
   findings by rule for the three encoders on both backends, fused and
   head-by-head, and OLMo-1B dense (fused, unfused) and paged, on both
   backends; no error, each file's findings equal to the verifier's over
   the saved file, 32 ``QNT002`` warnings on each OLMo-1B pair (the JAX
   package's count) and none on an encoder, and ``python -m
   repro_torch.deploy.verify`` exiting 0 over them (1 with ``--strict``).
   The fused dense OLMo-1B pair, saved with one activation moved onto a
   live tensor's offset, must make ``CompiledModel.load`` raise
   ``PlanVerificationError`` (MEM001) with the card's allocated memory
   unchanged, and load with ``verify=False``.  Then ``compile(...,
   autotune=True)`` with the engine phase's options must pick the JAX
   package's knobs (37 blocks of 64, fusion boundary 2), and an ``Engine``
   over the tuned pair, with the engine phase's weights and 12 requests,
   must stream the untuned ``ita`` engine's tokens, with int8_gemm 112
   times per prefill dispatch, no kernel in a decode step and
   ``EngineStats.verify_ms`` > 0; tok/s, TPOT, step p50 / p99, prefill
   dispatches and ms per decode step print for both engines (the tuned
   knobs minimise the ITA ASIC model's step, not the card's).
10. sanitize — the concurrency and KV-lifetime sanitizer, under
   ``REPRO_SANITIZE=1`` for this phase only: ``python -m
   repro_torch.deploy.sanitize --interleavings`` (the lock-order and
   affinity lints over the port's ``deploy/``, the bounded interleaving
   checks) must exit 0 with no finding; a fresh paged ``ita`` engine with
   the prefix cache (tracked locks, a shadow block pool) serves the engine
   phase's 12 requests at OLMo-1B's full width with the same weights and
   must stream the same tokens with no lockdep or shadow finding, a clean
   sharing audit and a shadow whose block counts equal the allocator's;
   8 concurrent HTTP streams from its loop thread must equal them again,
   with ``/v1/stats`` reporting the sanitizer on and clean.  Then one slot
   attaches 200 shared rows, its copy-on-write is skipped on purpose, and
   its tail chunk must raise ``SanitizerError`` (BLK003) on the host with
   no kernel launched and the card's pool bit-identical.  The sanitized
   engine's tok/s, TPOT and step percentiles print beside the unsanitized
   engine's, with the host ms the shadow hooks add per dispatch.

It prints the kernels line (JSON), the nvidia-smi line, and last the
contract line {"ok": true, "device": {...}}.  It exits non-zero, printing
no result, when no CUDA device is available or when it is not run from a
checkout of the repository.  JAX is never imported.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH = 8
SEED = 0

# H100 SXM published dense peaks (NVIDIA data sheet), used for bound_ms
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1979e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / PEAK_INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def call_ms(fn, reps: int = 50) -> float:
    """One call as the caller sees it: median of ``reps`` calls, each timed
    by CUDA events around it, so the host's dispatch cost is included."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device time of one ``fn()``: ``calls`` calls captured in a CUDA graph,
    the graph replayed ``reps`` times between CUDA events (median), so the
    host's dispatch cost between launches is not counted."""
    import torch

    fn()  # warm caches (scales, LUTs) outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)




#: device ms of the CUDA-core kernels that the tensor-core ones replaced
#: (this script on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md §6):
#: int8_gemm by (label, K, N), ita_attention by label
CUDA_CORE_GEMM_MS = {
    ("mobilebert", 128, 256): 0.0171, ("mobilebert", 256, 128): 0.0305,
    ("mobilebert", 128, 512): 0.0176, ("mobilebert", 512, 128): 0.0588,
    ("whisper-tiny-encoder", 384, 384): 0.0540, ("whisper-tiny-encoder", 384, 1536): 0.1643,
    ("whisper-tiny-encoder", 1536, 384): 0.2010, ("dinov2-small", 384, 384): 0.0473,
    ("dinov2-small", 384, 1536): 0.0983, ("dinov2-small", 1536, 384): 0.1778,
}
CUDA_CORE_GEMM_LAYER_MS = 0.1557  # one MobileBERT layer's six launches
CUDA_CORE_ATTN_MS = {"mobilebert": 0.0193, "whisper-tiny-encoder": 0.1847,
                "dinov2-small": 0.0529, "gqa-group2": 0.0527, "causal": 0.0407}


#: device ms of the first CUDA versions of itamax (one warp per row, the
#: exponential evaluated per element) and igelu (the polynomial and the
#: requant per element), this script on an NVIDIA H100 80GB HBM3 at 700 W
#: (PERF.md §6): by case label
ITAMAX_WARP_PER_ROW_MS = {"mobilebert": 0.0033, "whisper-tiny-encoder": 0.0278,
                          "dinov2-small": 0.0124}
IGELU_PER_ELEMENT_MS = {"deit-ti-widths": 0.0032}


def vs_old(what: str, ms: float, old: float | None) -> str:
    """A time beside the recorded time of the version it replaced."""
    if old is None:
        return f"{what}: not recorded"
    return f"{what} {old:.4f} ms ({old / ms:.2f}x)"


def tensor_core_sass(build) -> None:
    """Count the integer tensor-core instructions in the SASS of the
    tensor-core kernels' libraries; each must hold some.  Skipped (and
    said so) where the toolkit has no cuobjdump."""
    import re

    tool = _cuobjdump()
    if tool is None:
        log("  cuobjdump not found: the SASS is not inspected")
        return
    for name in ("int8_gemm", "ita_attention"):
        sass = subprocess.run([tool, "-sass", str(build._lib_path(name))], capture_output=True,
                              text=True, timeout=120, check=True).stdout
        ops = re.findall(r"\b(IMMA|[A-Z]*GMMA)\.?([\w.]*)", sass)
        kinds = sorted({f"{op}.{form}" if form else op for op, form in ops})
        log(f"  {name}: {len(ops)} integer tensor-core instructions in the SASS "
            f"({', '.join(kinds[:4])})")
        require(len(ops) > 0, f"{name}: no IMMA/GMMA instruction in its SASS")


def _cuobjdump():
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump") or (
        str(Path(CUDA_HOME) / "bin" / "cuobjdump") if CUDA_HOME else None)
    return tool if tool and Path(tool).exists() else None


def pointwise_sass(build) -> None:
    """Count the SASS instructions of each kernel function in the itamax
    and igelu libraries (one line per instruction in cuobjdump's listing).
    Skipped (and said so) where the toolkit has no cuobjdump."""
    import re

    tool = _cuobjdump()
    if tool is None:
        log("  cuobjdump not found: the SASS is not counted")
        return
    for name in ("itamax", "igelu"):
        sass = subprocess.run([tool, "-sass", str(build._lib_path(name))], capture_output=True,
                              text=True, timeout=120, check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            head = re.match(r"\s*Function : (\S+)", line)
            if head:
                fn = head.group(1)
                counts[fn] = 0
            elif fn and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+[A-Z@]", line):
                counts[fn] += 1
        require(bool(counts), f"{name}: no kernel function in its SASS")
        for fn, c in counts.items():
            tag = re.search(r"ILi(\d+)E", fn)
            log(f"  {name}: {c} SASS instructions in {fn[:48]}"
                f"{f' (template {tag.group(1)})' if tag else ''}")


def max_abs_err(got, want) -> float:
    """Largest |card - plain| over one comparison (0 when integer-exact)."""
    return float((got.cpu().to(want.dtype).int() - want.int()).abs().max())


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

#: (M, K, N, act) of every int8_gemm call on the three encoders' paths and
#: OLMo-1B's prefill at batch 8 (M padded to the 128-row granule), plus a
#: ragged case
def gemm_cases():
    from repro_torch.core.quant_linear import ACT_GELU, ACT_IDENTITY, ACT_RELU

    mb = [(1024, 128, 256, ACT_IDENTITY), (1024, 256, 128, ACT_IDENTITY),
          (1024, 128, 512, ACT_GELU), (1024, 512, 128, ACT_IDENTITY)]
    wide = [(384, 384, ACT_IDENTITY), (384, 1536, ACT_GELU), (1536, 384, ACT_IDENTITY)]
    cases = [("mobilebert", *c) for c in mb]
    cases += [("whisper-tiny-encoder", 4096, k, n, a) for k, n, a in wide]
    cases += [("dinov2-small", 2048, k, n, a) for k, n, a in wide]
    cases += [("ragged", 1000, 200, 300, ACT_RELU)]
    # OLMo-1B's prefill at batch 8 x 128 tokens: Q/K/V/O, gate/up, down
    cases += [("olmo-1b", 1024, k, n, ACT_IDENTITY) for k, n in OLMO_GEMM_KN]
    return cases


#: (K, N) of OLMo-1B's prefill GEMMs (d_model 2048, d_ff 8192)
OLMO_GEMM_KN = [(2048, 2048), (2048, 8192), (8192, 2048)]


#: (label, B, H, Hkv, S, D, kv_valid, causal) of the ita_attention checks;
#: the head-by-head schedule calls it one head at a time (H = 1, B*H = 8)
ATTN_CASES = [
    ("mobilebert", 8, 4, 4, 128, 64, None, False),
    ("whisper-tiny-encoder", 8, 6, 6, 512, 64, None, False),
    ("dinov2-small", 8, 6, 6, 256, 64, 241, False),
    ("gqa-group2", 8, 6, 3, 256, 64, None, False),
    ("causal", 8, 4, 4, 256, 64, None, True),
    ("one-head-mobilebert", 8, 1, 1, 128, 64, None, False),
    ("one-head-whisper", 8, 1, 1, 512, 64, None, False),
    ("one-head-dinov2", 8, 1, 1, 256, 64, 241, False),
]

#: (label, rows, n) of the itamax checks: one w8a8 layer's softmax at
#: batch 8 (B*H*S rows of S logits), plus a ragged case
ITAMAX_CASES = [
    ("mobilebert", 8 * 4 * 128, 128),
    ("whisper-tiny-encoder", 8 * 6 * 512, 512),
    ("dinov2-small", 8 * 6 * 241, 241),
    ("ragged", 1001, 77),
]

#: (label, shape) of the igelu checks: one DeiT-Ti-width layer's GELU at
#: batch 8 (B*S rows of d_ff), plus a ragged case
IGELU_CASES = [("deit-ti-widths", (8 * 197, 768)), ("ragged", (3, 7, 241))]

S_GEMM = dict(s_in=0.05, s_w=0.01, s_out=0.05, s_preact=0.05)
S_ATTN = dict(s_q=0.05, s_k=0.05, s_v=0.05, s_out=0.05)
S_GELU = dict(in_scale=0.05, out_scale=0.05)


def gemm_bytes_ops(m, k, n):
    return m * k + k * n + 3 * 4 * n + m * n, 2 * m * n * k


def attn_bytes_ops(bh, bhkv, s, d, kv_valid, causal):
    """q, k, v read once, out written once, the kernel's tables; int8 ops of
    Q K^T and P V over the (query, key) pairs this run's masks keep."""
    n_bytes = 2 * bh * s * d + 2 * bhkv * s * d + 96 * 4
    keys = s if kv_valid is None else kv_valid
    pairs = s * (s + 1) // 2 if causal else s * keys
    return n_bytes, 2 * 2 * bh * pairs * d


def rows_bytes(n_elem: int) -> tuple[int, int]:
    """An elementwise or rowwise int8 -> int8 kernel: each input byte read
    once, each output byte written once; its integer instructions run on
    the CUDA cores, for which the published table gives no rate, so the
    bound is the bytes alone."""
    return 2 * n_elem, 0


def itamax_shapes(torch, gen, dev) -> None:
    """The launch shape that ``itamax_grid`` picks at each path shape,
    timed beside half and twice its lanes a row (the raw launch, outside
    the wrapper's count), each checked against the plain version."""
    from repro_torch.kernels.itamax import itamax_ref, ops

    launch, lut = ops._lib(), ops._lut(dev)
    for label, r, n in ITAMAX_CASES:
        if label == "ragged":
            continue
        x = torch.randint(-128, 128, (r, n), generator=gen, dtype=torch.int8)
        want = itamax_ref(x)
        xd = x.to(dev)
        out = torch.empty_like(xd)
        lanes0 = ops.itamax_grid(r, n)[1]
        times = []
        for lanes in (lanes0 // 2, lanes0, lanes0 * 2):
            if not 1 <= lanes <= 32 or -(-ops._chunks_spanned(n) // lanes) > ops.MAX_CH:
                continue
            smem = ops.itamax_smem(n, lanes)
            rpb = ops.itamax_rows_per_block(r, n, lanes)

            def run(rpb=rpb, lanes=lanes, smem=smem):  # on the stream current at the call
                return launch(xd.data_ptr(), lut.data_ptr(), out.data_ptr(), r, n, rpb, lanes,
                              smem, torch.cuda.current_stream(dev).cuda_stream)

            require(run() == 0, f"itamax {label} lanes={lanes}: launch failed")
            torch.cuda.synchronize()
            require(torch.equal(out.cpu(), want), f"itamax {label} lanes={lanes} != plain")
            ms = device_ms(run)
            times.append(f"{lanes} lanes a row {ms:.4f} ms{' (chosen)' if lanes == lanes0 else ''}")
        log(f"  itamax {label:22s} R={r:6d} n={n:4d}: equal at each shape; " + ", ".join(times))


def exact_product_phase(torch, gen, dev) -> None:
    """``imatmul`` on CUDA tensors against the CPU's int32 product (the
    exact product in int64, wrapped to int32) at the plain path's shapes."""
    from repro_torch.quant.qparams import imatmul

    def ri(lo, hi, *shape, dtype=torch.int8):
        return torch.randint(lo, hi, shape, generator=gen, dtype=dtype)

    cases = [
        ("qlinear, _int_mm", ri(-128, 128, 8, 197, 192), ri(-127, 128, 192, 768)),
        ("down projection, _int_mm", ri(-128, 128, 8 * 512, 1536), ri(-127, 128, 1536, 384)),
        ("ragged N, float64", ri(-128, 128, 1000, 200), ri(-127, 128, 200, 300)),
        ("Q K^T, float64", ri(-128, 128, 8, 6, 241, 64),
         ri(-128, 128, 8, 6, 241, 64).transpose(-1, -2)),
        ("A V, float64", ri(0, 128, 8, 6, 241, 241), ri(-128, 128, 8, 6, 241, 64)),
        ("int32 that wraps, float64", ri(-(1 << 20), 1 << 20, 64, 32, dtype=torch.int32),
         ri(-(1 << 20), 1 << 20, 32, 48, dtype=torch.int32)),
    ]
    for label, a, b in cases:
        wide = torch.matmul(a.long(), b.long())
        want = wide.to(torch.int32)
        got = imatmul(a.to(dev), b.to(dev))
        torch.cuda.synchronize()
        require(got.dtype == torch.int32 and torch.equal(got.cpu(), want),
                f"imatmul {label} {tuple(a.shape)} @ {tuple(b.shape)} != the CPU int32 product")
        wraps = not torch.equal(wide, want.long())
        require(wraps == label.startswith("int32"), f"imatmul {label}: wrap {wraps}")
        log(f"  imatmul {label:26s} {tuple(a.shape)} @ {tuple(b.shape)}: equal"
            f"{' (the int32 accumulator wraps)' if wraps else ''}")


def int_mm_depth_phase(torch, dev) -> None:
    """Which int8 products ``torch._int_mm`` (cuBLASLt) takes on this card,
    over the depths and row counts of the paths: every product it refuses
    must be one that ``imatmul_exact`` keeps off it (K below
    ``INT_MM_MIN_DEPTH``)."""
    from repro_torch.quant.qparams import INT_MM_MIN_DEPTH

    refused, shapes = [], [(m, k, n) for m in (24, 40, 1000, 1024, 1576, 1928, 4096)
                           for k in (32, 64, 96, 128, 192) for n in (64, 128, 384)]
    for m, k, n in shapes:
        a = torch.ones((m, k), dtype=torch.int8, device=dev)
        b = torch.ones((k, n), dtype=torch.int8, device=dev)
        try:
            torch._int_mm(a, b)
            torch.cuda.synchronize()
        except RuntimeError as e:
            require("NOT_SUPPORTED" in str(e), f"_int_mm {(m, k, n)}: {e}")
            refused.append((m, k, n))
    log(f"  torch._int_mm refuses {len(refused)} of {len(shapes)} products: "
        f"{sorted({(m, k) for m, k, _ in refused})} (rows, depth), at every N of 64, 128, 384")
    require(all(k < INT_MM_MIN_DEPTH for _, k, _ in refused),
            f"_int_mm refuses products of depth >= {INT_MM_MIN_DEPTH}: {refused}")


def kernel_phase(torch, gen, dev) -> list[dict]:
    from repro_torch.kernels.igelu import igelu, igelu_ref
    from repro_torch.kernels.igelu.ops import igelu_grid
    from repro_torch.kernels.int8_gemm import int8_gemm, int8_gemm_ref
    from repro_torch.kernels.int8_gemm.ops import gemm_grid
    from repro_torch.kernels.ita_attention import ita_attention, ita_attention_ref
    from repro_torch.kernels.ita_attention.ops import attn_grid
    from repro_torch.kernels.itamax import itamax, itamax_ref
    from repro_torch.kernels.itamax.ops import itamax_grid

    def ri8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8)

    # -- int8_gemm: correctness at every path shape
    mb_layer = []  # one MobileBERT layer's six calls, for the timings
    g_err = a_err = 0.0
    for label, m, k, n, act in gemm_cases():
        x, w = ri8(m, k), ri8(k, n)
        w[w == -128] = -127  # weights are symmetric int8
        bias = torch.randint(-4000, 4000, (n,), generator=gen, dtype=torch.int32)
        s_w = (torch.rand(n, generator=gen).double() * 0.01 + 0.002).numpy() \
            if label == "ragged" else S_GEMM["s_w"]
        kw = dict(S_GEMM, s_w=s_w, act=act)
        got = int8_gemm(x.to(dev), w.to(dev), bias.to(dev), **kw)
        torch.cuda.synchronize()
        want = int8_gemm(x, w, bias, **kw)
        g_err = max(g_err, max_abs_err(got, want))
        require(torch.equal(got.cpu(), want), f"int8_gemm {label} {(m, k, n, act)} != plain")
        xd, wd, bd = x.to(dev), w.to(dev), bias.to(dev)
        ms = device_ms(lambda: int8_gemm(xd, wd, bd, **kw))
        per_call = call_ms(lambda: int8_gemm(xd, wd, bd, **kw), reps=20)
        lib = device_ms(lambda: torch._int_mm(xd, wd)) \
            if m > 16 and k % 8 == 0 and n % 8 == 0 else None
        bnd, by = bound_ms(*gemm_bytes_ops(m, k, n))
        bm, bn, gx, gy = gemm_grid(m, n)
        log(f"  int8_gemm {label:22s} M={m:5d} K={k:5d} N={n:5d} act={act}: equal; "
            f"device {ms:.4f} ms (per call with dispatch {per_call:.4f} ms), "
            f"{vs_old('CUDA-core version', ms, CUDA_CORE_GEMM_MS.get((label, k, n)))}, _int_mm "
            f"{'n/a' if lib is None else f'{lib:.4f} ms ({lib / ms:.2f}x)'}, bound "
            f"{bnd:.5f} ms ({by}); tile {bm}x{bn}, {gx * gy} blocks")
        if label == "mobilebert":
            reps = 3 if (k, n) == (128, 256) else 1  # Q, K and V share a shape
            mb_layer += [(x, w, bias, kw)] * reps

    # -- int8_gemm timings over one MobileBERT layer's six launches
    xs = [(x.to(dev), w.to(dev), b.to(dev), kw) for x, w, b, kw in mb_layer]
    gemm_ms = device_ms(lambda: [int8_gemm(*a[:3], **a[3]) for a in xs])
    gemm_plain = call_ms(lambda: [int8_gemm_ref(*a[:3], **a[3]) for a in xs], reps=10)
    ints = [(x.to(dev), w.to(dev)) for x, w, _, _ in mb_layer]
    lib_ms = device_ms(lambda: [torch._int_mm(x, w) for x, w in ints])
    g_bytes = g_ops = 0
    for x, w, _, _ in mb_layer:
        b_, o_ = gemm_bytes_ops(x.shape[0], x.shape[1], w.shape[1])
        g_bytes, g_ops = g_bytes + b_, g_ops + o_
    g_bound, g_by = bound_ms(g_bytes, g_ops)
    log(f"  int8_gemm one MobileBERT layer (6 launches): {gemm_ms:.4f} ms, "
        f"{vs_old('CUDA-core version', gemm_ms, CUDA_CORE_GEMM_LAYER_MS)}, _int_mm {lib_ms:.4f} ms "
        f"({lib_ms / gemm_ms:.2f}x), bound {g_bound:.5f} ms ({g_by})")

    # -- ita_attention: correctness on every case
    attn_mb = None
    for label, b, h, hkv, s, d, kv_valid, causal in ATTN_CASES:
        q, k, v = ri8(b, h, s, d), ri8(b, hkv, s, d), ri8(b, hkv, s, d)
        kw = dict(S_ATTN, causal=causal, block_k=128, kv_valid=kv_valid)
        got = ita_attention(q.to(dev), k.to(dev), v.to(dev), **kw)
        torch.cuda.synchronize()
        want = ita_attention(q, k, v, **kw)
        a_err = max(a_err, max_abs_err(got, want))
        require(torch.equal(got.cpu(), want), f"ita_attention {label} != plain")
        qd, kd, vd = q.to(dev), k.to(dev), v.to(dev)
        ms = device_ms(lambda: ita_attention(qd, kd, vd, **kw))
        per_call = call_ms(lambda: ita_attention(qd, kd, vd, **kw), reps=20)
        bnd, by = bound_ms(*attn_bytes_ops(b * h, b * hkv, s, d, kv_valid, causal))
        w, split, _, gx, gy = attn_grid(b * h, s, d, 128)
        old = vs_old("CUDA-core version", ms, CUDA_CORE_ATTN_MS.get(label))
        log(f"  ita_attention {label:22s} BH={b * h:3d} S={s:4d} D={d} kv_valid={kv_valid} "
            f"causal={causal} group={h // hkv}: equal; device {ms:.4f} ms (per call with "
            f"dispatch {per_call:.4f} ms), {old}, bound "
            f"{bnd:.5f} ms ({by}); {w * split} warps a block ({split} per 16 rows), "
            f"{gx * gy} blocks")
        if label == "mobilebert":
            attn_mb = (q, k, v, kw)

    q, k, v, kw = attn_mb
    qd, kd, vd = q.to(dev), k.to(dev), v.to(dev)
    attn_ms = device_ms(lambda: ita_attention(qd, kd, vd, **kw))
    attn_plain = call_ms(lambda: ita_attention_ref(qd, kd, vd, **kw), reps=10)
    bh, s, d = q.shape[0] * q.shape[1], q.shape[2], q.shape[3]
    a_bound, a_by = bound_ms(*attn_bytes_ops(bh, bh, s, d, None, False))

    # -- itamax: correctness on every case (rows of all-equal, one dominant
    # entry and all -128 logits first), then the timings
    m_err = 0.0
    itamax_mb = None
    one = torch.zeros((1, 1), dtype=torch.int8, device=dev)
    m_floor = device_ms(lambda: itamax(one))
    log(f"  itamax floor (one row of one element): device {m_floor:.4f} ms")
    for label, r, n in ITAMAX_CASES:
        x = ri8(r, n)
        x[0] = 17
        x[1] = -128
        x[1, n // 2] = 127
        x[2] = -128
        got = itamax(x.to(dev))
        torch.cuda.synchronize()
        want = itamax_ref(x)
        m_err = max(m_err, max_abs_err(got, want))
        require(torch.equal(got.cpu(), want), f"itamax {label} ({r}x{n}) != plain")
        xd = x.to(dev)
        ms = device_ms(lambda: itamax(xd))
        per_call = call_ms(lambda: itamax(xd), reps=20)
        plain = call_ms(lambda: itamax_ref(xd), reps=10)
        bnd, by = bound_ms(*rows_bytes(r * n))
        rpb, lanes, smem = itamax_grid(r, n)
        old = vs_old("first version", ms, ITAMAX_WARP_PER_ROW_MS.get(label))
        log(f"  itamax {label:22s} R={r:6d} n={n:4d}: equal; device {ms:.4f} ms (per call "
            f"with dispatch {per_call:.4f} ms), {old}, "
            f"floor {m_floor:.4f} ms (+{(ms - m_floor) * 1e3:.2f} us), plain on the card "
            f"{plain:.4f} ms, bound {bnd:.5f} ms ({by}); {lanes} lanes a row, {rpb} rows a "
            f"block, {-(-r // rpb)} blocks, {smem} shared bytes")
        if label == "mobilebert":
            itamax_mb = (ms, plain, bnd, by)

    itamax_shapes(torch, gen, dev)

    # -- igelu: correctness on every case (every int8 value first), timings
    e_err = 0.0
    igelu_deit = None
    sixteen = torch.zeros((16,), dtype=torch.int8, device=dev)
    e_floor = device_ms(lambda: igelu(sixteen, **S_GELU))
    log(f"  igelu floor (16 elements): device {e_floor:.4f} ms")
    for label, shape in IGELU_CASES:
        x = ri8(*shape)
        x.view(-1)[:256] = torch.arange(-128, 128, dtype=torch.int8)
        got = igelu(x.to(dev), **S_GELU)
        torch.cuda.synchronize()
        want = igelu_ref(x, **S_GELU)
        e_err = max(e_err, max_abs_err(got, want))
        require(torch.equal(got.cpu(), want), f"igelu {label} {shape} != plain")
        xd = x.to(dev)
        ms = device_ms(lambda: igelu(xd, **S_GELU))
        per_call = call_ms(lambda: igelu(xd, **S_GELU), reps=20)
        plain = call_ms(lambda: igelu_ref(xd, **S_GELU), reps=10)
        bnd, by = bound_ms(*rows_bytes(x.numel()))
        blocks, wpt = igelu_grid(x.numel())
        old = vs_old("first version", ms, IGELU_PER_ELEMENT_MS.get(label))
        log(f"  igelu {label:22s} {str(shape):16s}: equal; device "
            f"{ms:.4f} ms (per call with dispatch {per_call:.4f} ms), {old}, floor "
            f"{e_floor:.4f} ms "
            f"(+{(ms - e_floor) * 1e3:.2f} us), plain on the card {plain:.4f} ms, bound "
            f"{bnd:.5f} ms ({by}); {blocks} blocks of {wpt} words a thread")
        if label == "deit-ti-widths":
            igelu_deit = (ms, plain, bnd, by)

    return [
        {"name": "int8_gemm", "route": "cuda", "source": "src/repro_torch/csrc/int8_gemm.cu",
         "replaces": "src/repro/kernels/int8_gemm/kernel.py:87", "launches": 0,
         "max_abs_err": g_err, "ms": gemm_ms, "plain_ms": gemm_plain, "bound_ms": g_bound,
         "bound_by": g_by, "library_ms": lib_ms,
         "work": "one MobileBERT layer at batch 8: 6 launches, M=1024"},
        {"name": "ita_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/ita_attention.cu",
         "replaces": "src/repro/kernels/ita_attention/kernel.py:130", "launches": 0,
         "max_abs_err": a_err, "ms": attn_ms, "plain_ms": attn_plain, "bound_ms": a_bound,
         "bound_by": a_by, "library_ms": None,
         "work": "one MobileBERT layer at batch 8: BH=32, S=128, D=64, block_k=128; no "
                 "PyTorch call computes integer flash-ITAMax attention"},
        {"name": "igelu", "route": "cuda", "source": "src/repro_torch/csrc/igelu.cu",
         "replaces": "src/repro/kernels/igelu/kernel.py:31", "launches": 0,
         "max_abs_err": e_err, "ms": igelu_deit[0], "plain_ms": igelu_deit[1],
         "bound_ms": igelu_deit[2], "bound_by": igelu_deit[3], "library_ms": None,
         "work": "one DeiT-Ti-width layer's GELU at batch 8: (8*197, 768) int8; no "
                 "PyTorch call computes integer i-GeLU"},
        {"name": "itamax", "route": "cuda", "source": "src/repro_torch/csrc/itamax.cu",
         "replaces": "src/repro/kernels/itamax/kernel.py:29", "launches": 0,
         "max_abs_err": m_err, "ms": itamax_mb[0], "plain_ms": itamax_mb[1],
         "bound_ms": itamax_mb[2], "bound_by": itamax_mb[3], "library_ms": None,
         "work": "one MobileBERT w8a8 layer's softmax at batch 8: 4096 rows of 128 int8; "
                 "no PyTorch call computes integer ITAMax"},
    ]


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------

def deit_ti_widths(get_config):
    """dinov2-small at DeiT-Ti widths (Touvron et al. 2021, Table 1;
    facebook/deit-tiny-patch16-224): 12 layers, d_model 192, 3 heads of 64,
    d_ff 768, 197 patches.  No width is a multiple of 128, so on ``ita``
    every GEMM goes to the cluster and each GELU stays a node of its own."""
    return get_config("dinov2-small").replace(
        name="dinov2-small-deit-ti-widths", d_model=192, n_heads=3, n_kv_heads=3,
        head_dim=64, d_ff=768, n_patches=197, max_seq=197)


#: (phase, arch, backend, forwards, launches per forward of each kernel).
#: ``ita``: per layer the MHA node runs 4 GEMMs (Q, K, V, O) and one
#: attention, the MLP 2 GEMMs; ``w8a8``: one rowwise softmax per layer;
#: DeiT-Ti widths on ``ita``: one attention and one GELU per layer, every
#: GEMM on the cluster.
SLICE = [
    ("ita", "mobilebert", "ita", 3, dict(int8_gemm=144, ita_attention=24)),
    ("ita", "whisper-tiny-encoder", "ita", 2, dict(int8_gemm=24, ita_attention=4)),
    ("ita", "dinov2-small", "ita", 2, dict(int8_gemm=72, ita_attention=12)),
    ("w8a8", "mobilebert", "w8a8", 2, dict(itamax=24)),
    ("w8a8", "whisper-tiny-encoder", "w8a8", 2, dict(itamax=4)),
    ("w8a8", "dinov2-small", "w8a8", 2, dict(itamax=12)),
    ("deit-ti", "deit-ti-widths", "ita", 2, dict(ita_attention=12, igelu=12)),
]


def slice_phase(torch, card: str, dev) -> dict[str, int]:
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.deploy import api
    from repro_torch.launch.serve import make_requests

    wrappers = kernels.wrappers()
    launches = dict.fromkeys(wrappers, 0)
    for phase, arch, backend, steps, per_fwd in SLICE:
        cfg = deit_ti_widths(get_config) if arch == "deit-ti-widths" else get_config(arch)
        model = api.compile(cfg, backend=backend, use_cache=False)
        plan = model.artifact
        # the card by default: the device is named only when it is not
        session = model.session(BATCH, seed=SEED, device=None if dev.type == "cuda" else dev)
        require(session.device == dev, f"session on {session.device}, not {dev}")
        reqs = make_requests(cfg, plan, BATCH, steps, SEED)
        dev_reqs = [r.to(session.device) for r in reqs]
        session.forward(dev_reqs[0])  # warm-up
        torch.cuda.synchronize()

        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        outs = [session.forward(r) for r in dev_reqs]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = {name: w.launches for name, w in wrappers.items()}
        want = {name: steps * per_fwd.get(name, 0) for name in wrappers}
        require(got == want, f"{phase} {arch}: launches {got}, expected {want}")
        for name, n in got.items():
            launches[name] += n

        out = outs[0]
        want_shape = (BATCH, plan.seq_len, cfg.vocab if cfg.vocab else cfg.d_model)
        require(tuple(out.shape) == want_shape, f"{arch}: output {tuple(out.shape)}")
        require(bool(torch.isfinite(out).all()), f"{arch}: non-finite output")
        cpu = model.session(BATCH, seed=SEED, device="cpu")
        require(torch.equal(out.cpu(), cpu.forward(reqs[0])),
                f"{phase} {arch}: card forward != CPU forward")
        inf_s = steps * BATCH / dt
        counts = plan.counts()
        per = ", ".join(f"{n} {c // steps}" for n, c in got.items() if c) or "none"
        log(f"  [{phase}] {arch} ({backend}): {counts['nodes']} plan nodes ({counts['ita']} "
            f"ita / {counts['cluster']} cluster); launches per forward: {per}; output "
            f"{want_shape} equals the CPU forward bit for bit; {steps} forwards of "
            f"{BATCH}x{plan.seq_len} in {dt:.4f}s: {inf_s:.1f} inf/s, "
            f"{inf_s * plan.seq_len:.0f} tok/s on {card}")
    return launches


# ---------------------------------------------------------------------------
# decoder phase
# ---------------------------------------------------------------------------

#: OLMo-1B on the card: the pair's prompt length and KV rows, the batch
#: and the greedy decode steps; and the short prompt of the CPU check
DECODER = dict(seq_len=128, max_len=160, batch=8, steps=16)
DECODER_CPU = dict(seq_len=32, max_len=40, batch=2, steps=3)


def _greedy(torch, logits):
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def _on(qp, dev):
    if isinstance(qp, dict):
        return {k: _on(v, dev) for k, v in qp.items()}
    if isinstance(qp, list):
        return [_on(v, dev) for v in qp]
    return qp.to(dev)


def decoder_phase(torch, card: str, dev) -> dict[str, int]:
    """OLMo-1B at full width on both backends, against each other, the
    model chain on the card and (short prompt) the CPU."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.deploy import api
    from repro_torch.models import transformer as T

    cfg = get_config("olmo-1b")
    wrappers = kernels.wrappers()
    launches = dict.fromkeys(wrappers, 0)
    seq, cap, batch, steps = (DECODER[k] for k in ("seq_len", "max_len", "batch", "steps"))
    models = {be: api.compile(cfg, backend=be, seq_len=seq, max_len=cap, use_cache=False)
              for be in ("ita", "w8a8")}
    t0 = time.perf_counter()
    _, qp = models["ita"].bind(seed=SEED)  # one draw for every session
    log(f"  weights drawn and quantized (seed {SEED}) in {time.perf_counter() - t0:.1f}s")
    # the card by default: the device is named only when it is not
    on_card = None if dev.type == "cuda" else dev
    sessions = {be: m.session(batch, qp=qp, device=on_card) for be, m in models.items()}
    for be, sess in sessions.items():
        require(sess.device == dev, f"{be} session on {sess.device}, not {dev}")
    gemm_per_prefill = sum(n.kind == "gemm" and n.engine == "ita"
                           for n in models["ita"].artifact.prefill.flat_nodes())
    require(gemm_per_prefill == 7 * cfg.n_layers, f"{gemm_per_prefill} ita GEMMs a prefill")
    gen = torch.Generator().manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab, (batch, seq), generator=gen, dtype=torch.int32)
    prompts = prompts.to(dev)
    for sess in sessions.values():  # warm-up: cuBLAS handles, RoPE tables, scale caches
        sess.decode(_greedy(torch, sess.prefill(prompts)))
    qp_dev = _on(qp, dev)
    torch.cuda.synchronize()

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t)

    def count(be, what, want_gemm):
        got = {name: w.launches for name, w in wrappers.items()}
        want = {name: want_gemm if name == "int8_gemm" else 0 for name in wrappers}
        require(got == want, f"{be} {what}: launches {got}, expected {want}")
        for name, n in got.items():
            launches[name] += n
        for w in wrappers.values():
            w.launches = 0

    def same(a, b, what):
        require(a.shape == b.shape and torch.equal(a, b), f"decoder {what} differ")

    ms = {be: {"prefill": 0.0, "decode": []} for be in sessions}
    for w in wrappers.values():
        w.launches = 0
    logits = {}
    for be, sess in sessions.items():
        logits[be], ms[be]["prefill"] = timed(lambda sess=sess: sess.prefill(prompts))
        count(be, "prefill", gemm_per_prefill if be == "ita" else 0)
    ref_logits, ref_cache = T.prefill_w8a8(cfg, qp_dev, {"tokens": prompts}, cap)
    for step in range(steps + 1):
        kv = {be: sess.kv_cache for be, sess in sessions.items()}
        same(logits["ita"], logits["w8a8"], f"ita and w8a8 logits at step {step}")
        same(logits["w8a8"], ref_logits, f"session and model-chain logits at step {step}")
        for part in ("k", "v"):
            same(kv["ita"][part], kv["w8a8"][part], f"ita and w8a8 {part} caches, step {step}")
            same(kv["w8a8"][part], ref_cache[part], f"session and model {part}, step {step}")
        require(bool(torch.isfinite(ref_logits).all()), f"non-finite logits at step {step}")
        if step == steps:
            break
        tok = _greedy(torch, ref_logits)
        for be, sess in sessions.items():
            logits[be], t_ms = timed(lambda sess=sess: sess.decode(tok))
            ms[be]["decode"].append(t_ms)
            count(be, f"decode step {step}", 0)
        ref_logits, ref_cache = T.decode_step_w8a8(cfg, qp_dev, ref_cache, tok[:, None])
    require(tuple(ref_logits.shape) == (batch, 1, cfg.vocab_padded),
            f"logits {tuple(ref_logits.shape)}")
    for be, m in ms.items():
        dec = m["decode"]
        counts = models[be].counts()
        log(f"  [decoder] olmo-1b ({be}): plan nodes prefill {counts['prefill']['nodes']} "
            f"({counts['prefill']['ita']} ita), decode {counts['decode']['nodes']}; int8_gemm "
            f"{gemm_per_prefill if be == 'ita' else 0} launches a prefill, no kernel a decode "
            f"step; prefill {batch}x{seq} {m['prefill']:.3f} ms; decode step median "
            f"{statistics.median(dec):.3f} ms (min {min(dec):.3f}, max {max(dec):.3f}) over "
            f"{steps} steps: {batch * steps / (sum(dec) / 1e3):.1f} tok/s on {card}")
    log(f"  [decoder] logits and K/V caches: ita == w8a8 == the model chain on the card at "
        f"the prefill and all {steps} decode steps (batch {batch}, {cap} KV rows)")
    del sessions, ref_cache, qp_dev

    # the card against the CPU, full width and depth, short prompt
    seq, cap, batch, steps = (DECODER_CPU[k] for k in ("seq_len", "max_len", "batch", "steps"))
    prompts = torch.randint(0, cfg.vocab, (batch, seq), generator=gen, dtype=torch.int32)
    runs = {}
    for label, be, device in (("card", "ita", on_card), ("card", "w8a8", on_card),
                              ("cpu", "w8a8", "cpu")):
        model = api.compile(cfg, backend=be, seq_len=seq, max_len=cap, use_cache=False)
        sess = model.session(batch, qp=qp, device=device)
        t0 = time.perf_counter()
        out = [sess.prefill(prompts)]
        for _ in range(steps):
            out.append(sess.decode(_greedy(torch, out[-1].cpu())))
        out += [sess.kv_cache["k"], sess.kv_cache["v"]]
        runs[(be, label)] = [t.cpu() for t in out]
        log(f"  [decoder] short prompt {batch}x{seq} + {steps} steps, {be} on "
            f"{sess.device.type}: {time.perf_counter() - t0:.1f}s")
    cpu = runs[("w8a8", "cpu")]
    for key in (("ita", "card"), ("w8a8", "card")):
        for i, (a, b) in enumerate(zip(runs[key], cpu)):
            same(a, b, f"{key[0]} card and CPU output {i} (short prompt)")
    log("  [decoder] short prompt: the card equals the CPU on both backends (logits at "
        "every step, K and V caches)")
    for w in wrappers.values():
        w.launches = 0
    return launches


# ---------------------------------------------------------------------------
# head-by-head phase
# ---------------------------------------------------------------------------

#: (arch, backend, launches per forward) of the paper's head-by-head
#: schedule at batch 8, from the plan's dispatch: on ``ita`` each head's
#: attention is one ita_attention launch at H = 1, and a head's Q/K/V
#: projections (N = head_dim = 64, below the kernel backend's 128 granule)
#: run on the cluster, so int8_gemm runs the MLP's two GEMMs a layer; on
#: ``w8a8`` each head's rowwise softmax is one itamax launch
HEAD_BY_HEAD = [
    ("mobilebert", "ita", dict(int8_gemm=48, ita_attention=96)),
    ("mobilebert", "w8a8", dict(itamax=96)),
    ("whisper-tiny-encoder", "ita", dict(int8_gemm=8, ita_attention=24)),
    ("whisper-tiny-encoder", "w8a8", dict(itamax=24)),
    ("dinov2-small", "ita", dict(int8_gemm=24, ita_attention=72)),
    ("dinov2-small", "w8a8", dict(itamax=72)),
]
HBH_FORWARDS = 2


def head_by_head_phase(torch, card: str, dev) -> dict[str, int]:
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.deploy import api
    from repro_torch.launch.serve import make_requests

    wrappers = kernels.wrappers()
    launches = dict.fromkeys(wrappers, 0)
    for arch, backend, per_fwd in HEAD_BY_HEAD:
        cfg = get_config(arch)
        model = api.compile(cfg, backend=backend, head_by_head=True, use_cache=False)
        plan = model.artifact
        heads = sum(n.op == "MHAHead" for n in plan.nodes)
        require(heads == cfg.n_layers * cfg.n_heads, f"{arch}: {heads} MHAHead nodes")
        session = model.session(BATCH, seed=SEED, device=None if dev.type == "cuda" else dev)
        require(session.device == dev, f"session on {session.device}, not {dev}")
        reqs = make_requests(cfg, plan, BATCH, HBH_FORWARDS, SEED)
        dev_reqs = [r.to(dev) for r in reqs]
        session.forward(dev_reqs[0])  # warm-up
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        outs = [session.forward(r) for r in dev_reqs]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = {name: w.launches for name, w in wrappers.items()}
        want = {name: HBH_FORWARDS * per_fwd.get(name, 0) for name in wrappers}
        require(got == want, f"head-by-head {arch} {backend}: launches {got}, expected {want}")
        for name, n in got.items():
            launches[name] += n
        out = outs[0]
        want_shape = (BATCH, plan.seq_len, cfg.vocab if cfg.vocab else cfg.d_model)
        require(tuple(out.shape) == want_shape, f"{arch}: output {tuple(out.shape)}")
        require(bool(torch.isfinite(out).all()), f"{arch}: non-finite output")
        cpu = model.session(BATCH, seed=SEED, device="cpu")
        require(torch.equal(out.cpu(), cpu.forward(reqs[0])),
                f"head-by-head {arch} {backend}: card forward != CPU forward")
        inf_s = HBH_FORWARDS * BATCH / dt
        per = ", ".join(f"{n} {c // HBH_FORWARDS}" for n, c in got.items() if c) or "none"
        log(f"  [head-by-head] {arch} ({backend}): {len(plan.nodes)} plan nodes, {heads} "
            f"heads; launches per forward: {per}; output {want_shape} equals the CPU forward "
            f"bit for bit; {HBH_FORWARDS} forwards of {BATCH}x{plan.seq_len} in {dt:.4f}s: "
            f"{inf_s:.1f} inf/s on {card}")
    for w in wrappers.values():
        w.launches = 0
    return launches


# ---------------------------------------------------------------------------
# paged phase
# ---------------------------------------------------------------------------

#: OLMo-1B over a paged KV region at batch 8: prompts of two seq_len
#: chunks, blocks of 16 rows, max_len 272 (17 blocks a slot: 256 prompt
#: rows and 16 decode steps) and a pool of 145 blocks (eight 2-chunk
#: prompts hold 128); half the slots attach the first 200 rows of slot
#: 0's chain (12.5 blocks); slot 2 is freed and re-prefilled after step 8
PAGED = dict(seq_len=128, block=16, max_len=272, kv_blocks=145, batch=8, steps=16,
             shared_rows=200, free_at=8)
#: the short prompt of the card-vs-CPU check, same steps
PAGED_CPU = dict(seq_len=32, block=16, max_len=72, kv_blocks=10, batch=2, steps=3,
                 shared_rows=40, free_at=2)


def _dispatch(torch, flow: dict, step_done, label: str, kind: str, fn):
    """Run one timed dispatch ``fn()`` (a prefill chunk or a decode step),
    keep its logits under ``label`` and its ms under ``kind``."""
    t = time.perf_counter()
    logits = fn()
    if logits.is_cuda:
        torch.cuda.synchronize()
    flow["ms"][kind].append(1e3 * (time.perf_counter() - t))
    step_done(label, kind)
    flow["logits"][label] = logits
    return logits


def paged_flow(torch, sess, prompts, fresh, cfg_p: dict, step_done) -> dict:
    """The paged steps on one session; returns the logits by label (on the
    session's device) and the times.  ``step_done(label, kind)`` runs after
    every dispatch (the launch counts).  Checks the block arithmetic."""
    from repro_torch.deploy.paging import blocks_for_rows

    b_n, s, bs, pool = cfg_p["batch"], cfg_p["seq_len"], cfg_p["block"], cfg_p["kv_blocks"]
    half = b_n // 2  # slots [half, b_n) attach slot 0's prefix
    # a slot of the first half is parked through the decode steps and
    # another freed and re-prefilled (the attached slot when there is one
    # slot a half)
    parked, again = (half - 1, 2) if b_n > 2 else (None, 1)
    flow = {"logits": {}, "ms": {"chunk": [], "decode": []}, "parked": parked,
            "again": again, "half": half}
    out = flow["logits"]

    def run(label, kind, fn):
        return _dispatch(torch, flow, step_done, label, kind, fn)

    def expect(free, cows, what):
        require((sess.blocks_free, sess.cow_copies) == (free, cows),
                f"paged {what}: {sess.blocks_free} free blocks and {sess.cow_copies} copies, "
                f"predicted {free} and {cows}")

    two = blocks_for_rows(2 * s, bs)
    run("chunk 0", "chunk", lambda: sess.prefill_chunks(
        {b: (prompts[b: b + 1, :s], 0) for b in range(b_n)}))
    expect(pool - b_n * blocks_for_rows(s, bs), 0, "after chunk 0")
    run("chunk 1", "chunk", lambda: sess.prefill_chunks(
        {b: (prompts[b: b + 1, s: 2 * s], s) for b in range(b_n)}))
    expect(pool - b_n * two, 0, "after chunk 1")
    # half the slots start again from the first shared_rows rows of slot
    # 0's chain; their tail chunk overwrites (copies) the shared blocks
    # past row s and allocates the rest
    shared = blocks_for_rows(cfg_p["shared_rows"], bs)
    chain = sess.block_chain(0)[:shared]
    for b in range(half, b_n):
        sess.free_slot(b)
        sess.attach_prefix(b, chain, cfg_p["shared_rows"])
    expect(pool - half * two, 0, "after the attach")
    # each attached slot copies its shared blocks past row s and allocates
    # the rest of its two chunks; blocks [0, s / bs) stay shared with slot 0
    n_att, own = b_n - half, s // bs
    cows = n_att * (shared - own)
    run("shared tail", "chunk", lambda: sess.prefill_chunks(
        {b: (prompts[b: b + 1, s: 2 * s], s) for b in range(half, b_n)}))
    expect(pool - half * two - n_att * (two - own), cows, "after the shared tails")
    act = torch.ones(b_n, dtype=torch.bool)
    if parked is not None:
        act[parked] = False
    cur = out["chunk 1"].clone()
    cur[half:] = out["shared tail"][half:]
    for step in range(cfg_p["steps"]):
        if step == cfg_p["free_at"]:
            sess.free_slot(again)
            lg = run("re-prefill", "chunk",
                     lambda: sess.prefill_chunks({again: (fresh, 0)}))
            cur[again] = lg[again]
        tok = torch.argmax(cur[:, -1], dim=-1).to(torch.int32)
        cur = run(f"decode {step}", "decode",
                  lambda tok=tok: sess.decode(tok, active=act.numpy()))
    steps, free_at = cfg_p["steps"], cfg_p["free_at"]
    chains = [blocks_for_rows(2 * s + steps, bs)] * b_n
    chains[again] = blocks_for_rows(s + steps - free_at, bs)
    if parked is not None:
        chains[parked] = two
    # the slots still attached share blocks [0, s / bs) with slot 0
    attached = n_att - (again >= half)
    expect(pool - sum(chains) + attached * own, cows, "after the decode steps")
    return flow


def dense_flow(torch, sess, prompts, fresh, cfg_p: dict, step_done, parked, again) -> dict:
    """The same prompts over the dense region: prefill, teacher forcing of
    the second chunk, then the same decode steps and re-admission."""
    s = cfg_p["seq_len"]
    flow = {"logits": {}, "ms": {"chunk": [], "decode": []}}
    out = flow["logits"]

    def run(label, kind, fn):
        return _dispatch(torch, flow, step_done, label, kind, fn)

    run("chunk 0", "chunk", lambda: sess.prefill(prompts[:, :s]))
    for t in range(s, 2 * s):
        lg = sess.decode(prompts[:, t])
        step_done("teacher forcing", "decode")
    out["chunk 1"] = out["shared tail"] = lg
    cur = lg.clone()
    for step in range(cfg_p["steps"]):
        if step == cfg_p["free_at"]:
            lg = run("re-prefill", "chunk", lambda: sess.prefill_slot(again, fresh))
            cur[again] = lg[0]
        tok = torch.argmax(cur[:, -1], dim=-1).to(torch.int32)
        cur = run(f"decode {step}", "decode", lambda tok=tok: sess.decode(tok))
    return flow


def _rows(label: str, flow: dict, batch: int):
    """The lanes a label's logits are meaningful for."""
    if label == "shared tail":
        return list(range(flow["half"], batch))
    if label == "re-prefill":
        return [flow["again"]]
    return [b for b in range(batch) if b != flow["parked"]]


def compare_flows(torch, ref: dict, other: dict, batch: int, what: str) -> None:
    """Equal logits at every label, on the rows that carry them."""
    for label, lg in ref["logits"].items():
        rows = _rows(label, ref, batch)
        got = other["logits"][label]
        if label == "re-prefill" and got.shape[0] == 1:  # a dense prefill_slot
            want = lg[rows]
        else:
            want, got = lg[rows], got[rows]
        require(torch.equal(want.cpu(), got.cpu()), f"paged: {what} differ at {label}")


def paged_phase(torch, card: str, dev) -> dict[str, int]:
    """OLMo-1B over a paged KV region on both backends, against each other,
    the dense pair and (short prompt) the CPU."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.deploy import api
    from repro_torch.deploy.memory import kv_pool_bytes

    cfg = get_config("olmo-1b")
    wrappers = kernels.wrappers()
    launches = dict.fromkeys(wrappers, 0)
    on_card = None if dev.type == "cuda" else dev
    p = PAGED
    gemm_per_chunk = 7 * cfg.n_layers

    def counter(backend, plan_kind):
        def step_done(label, kind):
            got = {name: w.launches for name, w in wrappers.items()}
            gemm = gemm_per_chunk if (backend == "ita" and kind == "chunk") else 0
            want = {name: gemm if name == "int8_gemm" else 0 for name in wrappers}
            require(got == want, f"{plan_kind} {backend} {label}: launches {got}, expected {want}")
            for name, n in got.items():
                launches[name] += n
            for w in wrappers.values():
                w.launches = 0
        return step_done

    def compile_pair(backend, cp, paged):
        kw = dict(backend=backend, seq_len=cp["seq_len"], max_len=cp["max_len"],
                  use_cache=False)
        if paged:
            kw.update(kv_block_size=cp["block"], kv_blocks=cp["kv_blocks"], prefix_cache=True)
        return api.compile(cfg, **kw)

    t0 = time.perf_counter()
    _, qp = compile_pair("ita", p, True).bind(seed=SEED)
    log(f"  weights drawn and quantized (seed {SEED}) in {time.perf_counter() - t0:.1f}s; pool "
        f"{kv_pool_bytes(p['kv_blocks'], p['block'], cfg.n_kv_heads, cfg.head_dim, cfg.n_layers)}"
        f" bytes ({p['kv_blocks']} blocks of {p['block']} rows and the scratch block)")
    gen = torch.Generator().manual_seed(SEED + 1)
    s, b_n = p["seq_len"], p["batch"]
    prompts = torch.randint(0, cfg.vocab, (b_n, 2 * s), generator=gen, dtype=torch.int32)
    prompts[b_n // 2:, : p["shared_rows"]] = prompts[0, : p["shared_rows"]]
    fresh = torch.randint(0, cfg.vocab, (1, s), generator=gen, dtype=torch.int32)
    prompts, fresh = prompts.to(dev), fresh.to(dev)

    flows = {}
    for be in ("ita", "w8a8"):
        for paged in (True, False):
            model = compile_pair(be, p, paged)
            sess = model.session(b_n, qp=qp, device=on_card)
            require(sess.device == dev and sess.paged == paged, f"{be} session")
            # warm-up (cuBLAS handles, RoPE tables, scale caches), then afresh
            sess.decode(_greedy(torch, sess.prefill(prompts[:, :s])))
            for b in range(b_n):
                sess.free_slot(b)
            for w in wrappers.values():
                w.launches = 0
            kind = "paged" if paged else "dense"
            step_done = counter(be, kind)
            if paged:
                flows[(be, kind)] = paged_flow(torch, sess, prompts, fresh, p, step_done)
                # the scratch block (physical block 0) is left out: parked
                # lanes write their rows there, and where two lanes hit one
                # row the card keeps either
                flows[(be, "pool")] = {k: t[:, 1:].clone() for k, t in sess.kv_pool.items()}
            else:
                ref = flows[(be, "paged")]
                flows[(be, kind)] = dense_flow(torch, sess, prompts, fresh, p, step_done,
                                               ref["parked"], ref["again"])
            del sess
            torch.cuda.empty_cache()
    ref = flows[("w8a8", "paged")]
    compare_flows(torch, ref, flows[("ita", "paged")], b_n, "ita and w8a8 paged logits")
    for part in ("k", "v"):
        require(torch.equal(flows[("ita", "pool")][part], flows[("w8a8", "pool")][part]),
                f"paged: ita and w8a8 {part} pools differ")
    for be in ("ita", "w8a8"):
        compare_flows(torch, flows[(be, "paged")], flows[(be, "dense")], b_n,
                      f"{be} paged and dense logits")
    half = ref["half"]
    require(torch.equal(ref["logits"]["shared tail"][half:], ref["logits"]["chunk 1"][half:]),
            "paged: the shared-prefix slots differ from the same prompts prefilled unshared")
    n_steps = p["steps"]
    log(f"  [paged] logits: ita == w8a8 == the dense pair at both chunks and all {n_steps} "
        f"decode steps (rows of the {b_n - 1} active slots), the re-prefilled slot included; "
        f"the {b_n - half} slots that attached {p['shared_rows']} shared rows equal the same "
        f"prompts prefilled unshared; ita and w8a8 pools equal (but for the scratch block)")
    for be in ("ita", "w8a8"):
        pg, dn = flows[(be, "paged")]["ms"], flows[(be, "dense")]["ms"]
        log(f"  [paged] olmo-1b ({be}): chunk of {b_n}x{s} {pg['chunk'][0]:.3f} / "
            f"{pg['chunk'][1]:.3f} ms (dense prefill {dn['chunk'][0]:.3f} ms); decode step "
            f"median {statistics.median(pg['decode']):.3f} ms (dense "
            f"{statistics.median(dn['decode']):.3f} ms); int8_gemm "
            f"{gemm_per_chunk if be == 'ita' else 0} launches a chunk, no kernel a decode "
            f"step; on {card}")
    log(f"  [paged] copy-on-write copies {(b_n - half) * (-(-p['shared_rows'] // p['block']) - s // p['block'])}"
        f" and free blocks as predicted at every stage")
    del flows

    # the card against the CPU, full width and depth, short prompt
    c = PAGED_CPU
    prompts = torch.randint(0, cfg.vocab, (c["batch"], 2 * c["seq_len"]), generator=gen,
                            dtype=torch.int32)
    prompts[c["batch"] // 2:, : c["shared_rows"]] = prompts[0, : c["shared_rows"]]
    fresh = torch.randint(0, cfg.vocab, (1, c["seq_len"]), generator=gen, dtype=torch.int32)
    runs = {}
    for label, be, device in (("card", "ita", on_card), ("card", "w8a8", on_card),
                              ("cpu", "w8a8", "cpu")):
        sess = compile_pair(be, c, True).session(c["batch"], qp=qp, device=device)
        t0 = time.perf_counter()
        dv = sess.device
        flow = paged_flow(torch, sess, prompts.to(dv), fresh.to(dv), c,
                          counter(be, "paged short") if dv.type == "cuda" else
                          (lambda label, kind: None))
        flow["pool"] = {k: t[:, 1:].cpu() for k, t in sess.kv_pool.items()}  # no scratch
        runs[(be, label)] = flow
        log(f"  [paged] short prompt {c['batch']}x{2 * c['seq_len']} + {c['steps']} steps, {be} "
            f"on {dv.type}: {time.perf_counter() - t0:.1f}s")
    cpu = runs[("w8a8", "cpu")]
    for key in (("ita", "card"), ("w8a8", "card")):
        compare_flows(torch, cpu, runs[key], c["batch"], f"{key[0]} card and CPU")
        for part in ("k", "v"):
            require(torch.equal(runs[key]["pool"][part], cpu["pool"][part]),
                    f"paged: {key[0]} card and CPU {part} pools differ (short prompt)")
    log("  [paged] short prompt: the card equals the CPU on both backends (logits at every "
        "step, K and V pools but for the scratch block)")
    for w in wrappers.values():
        w.launches = 0
    return launches


# ---------------------------------------------------------------------------
# engine phase
# ---------------------------------------------------------------------------

#: OLMo-1B served by the request-level engine over the paged phase's pool
#: (blocks of 16 rows, 145 blocks, chunks of seq_len 128, max_len 272, 8
#: slots): 12 greedy requests of 16 tokens, request ``cancel`` cancelled
#: after its ``cancel_after``-th token, the first ``http`` requests again
#: as concurrent HTTP streams
ENGINE = dict(seq_len=128, block=16, max_len=272, kv_blocks=145, batch=8, gen=16,
              cancel=9, cancel_after=4, http=8)


def engine_prompts(vocab: int) -> list[list[int]]:
    """The 12 prompts, lengths staggered over 128-256 tokens: request 0 of
    256 tokens; 1-4 share its first 200 tokens (210, 228, 246 and 256
    tokens); 5 and 6 repeat 0 and 2 exactly; 7-11 are fresh (128, 150,
    175, 199 and 230 tokens).  Drawn from seed ``SEED + 2``."""
    import numpy as np

    rng = np.random.default_rng(SEED + 2)

    def fresh(n):
        return [int(t) for t in rng.integers(0, vocab, n)]

    base = fresh(256)
    shared = [base[:200] + fresh(n - 200) for n in (210, 228, 246, 256)]
    return [base, *shared, list(base), list(shared[1]),
            *[fresh(n) for n in (128, 150, 175, 199, 230)]]


#: what the block arithmetic and the admission rules give for these 12
#: requests (the same on any device: the schedule is the host's):
#: requests 1-4 attach 12 shared blocks of request 0, 5 and 6 are
#: zero-prefill repeats, 7-11 miss
ENGINE_PREFIX = dict(prefix_lookups=12, prefix_hits=6, full_prefix_hits=2)


def check_engine_launches(dev, what: str, model, counter, stats, launches: dict) -> None:
    """int8_gemm 7 times a layer (112 at OLMo-1B's 16) per prefill dispatch
    on ita, nothing else, and no kernel in any decode step; each call the
    engine counted.  Adds the run's launches to ``launches`` and sets the
    counts to 0."""
    from repro_torch import kernels

    wrappers = kernels.wrappers()
    got = {name: w.launches for name, w in wrappers.items()}
    require(counter.calls["prefill"] == stats.prefill_dispatches
            and counter.calls["decode"] == stats.decode_dispatches,
            f"{what}: {counter.calls} dispatches, the engine counted "
            f"{stats.prefill_dispatches} prefill and {stats.decode_dispatches} decode")
    if dev.type == "cuda":  # the wrappers count launches on the card only
        gemm = olmo_gemms(model) * counter.calls["prefill"]
        want = {name: gemm if name == "int8_gemm" else 0 for name in wrappers}
        require(got == want, f"{what}: launches {got}, expected {want}")
        require(not counter.launches["decode"],
                f"{what}: kernels in decode steps {counter.launches['decode']}")
    for name, n in got.items():
        launches[name] += n
        wrappers[name].launches = 0


def olmo_gemms(model) -> int:
    """int8_gemm launches per prefill dispatch: 7 GEMMs a layer on ita."""
    return 7 * model.cfg.n_layers if model.backend.value == "ita" else 0


def serve_engine(torch, card: str, dev, model, qp, prompts: list, what: str, launches: dict,
                 *, tag: str = "[engine]", prefix_counts: bool = True, on_ready=None):
    """The 12 requests through an ``Engine`` over ``model`` on ``dev``
    (after a warm-up request), request ``ENGINE["cancel"]`` cancelled
    while resident; checks the launches, the streams and, where
    ``prefix_counts``, the prefix cache's counts.  ``on_ready(engine)``
    runs after the warm-up, just before the timed run.  Returns the
    engine, the streams, the stats and the seconds of the run."""
    from repro_torch import kernels
    from repro_torch.deploy.engine import Engine
    from repro_torch.launch.serve import DispatchCounter

    e = ENGINE
    vocab = model.cfg.vocab
    engine = Engine(model, e["batch"], qp=qp, device=None if dev.type == "cuda" else dev)
    require(engine.session.device == dev, f"{what}: engine on {engine.session.device}")
    counter = DispatchCounter(engine.session)
    # warm-up (cuBLAS handles, RoPE tables, scale caches), then afresh
    engine.submit(prompts[7][: e["seq_len"]], 2)
    engine.run_until_idle()
    if engine.prefix_index is not None:
        engine.prefix_index.drop_all()
    engine.reset_stats()
    counter.reset()
    for w in kernels.wrappers().values():
        w.launches = 0
    if on_ready is not None:
        on_ready(engine)
    handles = []

    def cancel_on(tok):
        h = handles[e["cancel"]]
        if len(h.tokens) == e["cancel_after"]:
            h.cancel()  # resident: it is decoding

    t = time.perf_counter()
    for i, p in enumerate(prompts):
        handles.append(engine.submit(p, e["gen"],
                                     on_token=cancel_on if i == e["cancel"] else None))
    stats = engine.run_until_idle(max_steps=2000)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t
    check_engine_launches(dev, what, model, counter, stats, launches)
    streams = [(h.tokens, h.finish_reason) for h in handles]
    for i, (toks, reason) in enumerate(streams):
        n = e["cancel_after"] if i == e["cancel"] else e["gen"]
        want = "cancelled" if i == e["cancel"] else "length"
        require(reason == want and len(toks) == n,
                f"{what}: request {i} ended {reason} after {len(toks)} tokens")
        require(all(0 <= t < vocab for t in toks), f"{what}: request {i} off vocab")
    require(streams[5] == streams[0] and streams[6] == streams[2],
            f"{what}: an exact repeat streamed other tokens")
    if engine.prefix_index is not None:
        require(engine.audit_sharing() == [], f"{what}: the sharing audit found faults")
        if prefix_counts:
            got = {k: getattr(stats, k) for k in ENGINE_PREFIX}
            require(got == ENGINE_PREFIX, f"{what}: prefix cache {got}, expected {ENGINE_PREFIX}")
    log(f"  {tag} olmo-1b ({what}): {len(prompts)} requests in {secs:.2f}s on {card}; "
        f"{stats.prefill_dispatches} prefill dispatches (int8_gemm {olmo_gemms(model)} "
        f"launches each), {stats.decode_dispatches} decode steps (no kernel); "
        f"{stats.summary()}")
    return engine, streams, stats, secs


def serve_http(card: str, dev, engine, prompts: list, want: list, launches: dict,
               tag: str) -> dict:
    """The first ``ENGINE["http"]`` requests behind ``AsyncEngine`` +
    ``ServingFrontend`` over ``engine`` (its prefix cache emptied first),
    as concurrent HTTP streams that must equal ``want``; the loop thread
    launches.  Checks the launches; returns ``/v1/stats``."""
    import threading

    from repro_torch.deploy.serving import AsyncEngine, ServingFrontend
    from repro_torch.launch.cli import http_generate, http_get_json
    from repro_torch.launch.serve import DispatchCounter

    e = ENGINE
    engine.prefix_index.drop_all()
    engine.reset_stats()
    counter = DispatchCounter(engine.session)
    n = e["http"]
    got = [None] * n
    errors = []
    aengine = AsyncEngine(engine)
    frontend = ServingFrontend(aengine, port=0)
    host, port = frontend.start()

    def client(i):
        try:
            events = list(http_generate(host, port, prompts[i], e["gen"], timeout=900))
            toks = [ev["token"] for ev in events if "token" in ev]
            require(events[-1]["done"] and events[-1]["tokens"] == toks,
                    f"http request {i}: the summary line differs from the stream")
            got[i] = (toks, events[-1]["finish_reason"])
        except Exception as exc:  # noqa: BLE001 - reported by the caller's thread
            errors.append((i, exc))

    t = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    secs = time.perf_counter() - t
    stats_http = http_get_json(host, port, "/v1/stats")
    frontend.shutdown(drain=True, timeout=300)
    require(not any(th.is_alive() for th in threads), "http clients did not finish")
    require(not errors, f"http clients failed: {errors}")
    require(got == want[:n], f"{tag} the HTTP streams differ from the sync engine's")
    stats = engine.stats_snapshot()
    check_engine_launches(dev, "ita over HTTP", engine.session.model, counter, stats, launches)
    require(stats_http["requests_completed"] == n, f"/v1/stats: {stats_http}")
    log(f"  {tag} AsyncEngine + ServingFrontend on {card}: {n} concurrent HTTP streams "
        f"equal the sync engine's in {secs:.2f}s; {stats.prefill_dispatches} prefill "
        f"dispatches, {stats.decode_dispatches} decode steps from the loop thread; "
        f"{stats.summary()}")
    return stats_http


def engine_phase(torch, card: str, dev) -> tuple[dict[str, int], dict]:
    """OLMo-1B at full width through the request-level engine on the card:
    ``ita`` with the prefix cache, ``w8a8`` with it and ``ita`` without it
    must stream the same tokens; the ``ita`` engine then serves the first
    requests over HTTP from its loop thread, and must stream them again.
    Returns the launches and, for the audit phase, the weights, the
    prompts, the ``ita`` engine's streams and its stats and seconds."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.deploy import api

    cfg = get_config("olmo-1b")
    e = ENGINE
    launches = dict.fromkeys(kernels.wrappers(), 0)
    t_phase = time.perf_counter()

    def compile_paged(backend, prefix_cache):
        return api.compile(cfg, backend=backend, seq_len=e["seq_len"], max_len=e["max_len"],
                           kv_block_size=e["block"], kv_blocks=e["kv_blocks"],
                           prefix_cache=prefix_cache, use_cache=False)

    t0 = time.perf_counter()
    _, qp = compile_paged("ita", True).bind(seed=SEED)  # one draw for every engine
    log(f"  weights drawn and quantized (seed {SEED}) in {time.perf_counter() - t0:.1f}s")
    prompts = engine_prompts(cfg.vocab)

    ita, want, ita_stats, ita_secs = serve_engine(
        torch, card, dev, compile_paged("ita", True), qp, prompts, "ita, prefix cache",
        launches)
    for what, backend, prefix_cache in (("w8a8, prefix cache", "w8a8", True),
                                        ("ita, no prefix cache", "ita", False)):
        engine, streams, _, _ = serve_engine(
            torch, card, dev, compile_paged(backend, prefix_cache), qp, prompts, what, launches)
        require(streams == want, f"engine: {what} streams differ from ita with the prefix cache")
        del engine
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    log(f"  [engine] streams: ita == w8a8 == ita without the prefix cache, all "
        f"{len(prompts)} requests (request {e['cancel']} cancelled while resident after "
        f"{e['cancel_after']} tokens); the sharing audit is clean")

    # the same ita engine behind the HTTP frontend: the loop thread launches
    stats_http = serve_http(card, dev, ita, prompts, want, launches, "[engine]")
    require(not stats_http["sanitize"]["enabled"], f"/v1/stats: {stats_http}")
    log(f"  [engine] phase took {time.perf_counter() - t_phase:.1f}s")
    del ita
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches, dict(qp=qp, prompts=prompts, streams=want, stats=ita_stats,
                          secs=ita_secs)


#: what the JAX package's tuner picks for the [engine] phase's options
#: (ita, seq_len 128, max_len 272, 145 blocks of 16): 37 blocks of 64 keep
#: the pool's rows, not its slots (8 unshared slots at 272 rows need 40)
AUDIT_KNOBS = {"kv_block_size": 64, "kv_blocks": 37, "fuse_min_nodes": 2, "gemm_tiles": {}}
#: the JAX package's static verifier on each OLMo-1B full-width pair: 32
#: QNT002 warnings (the 8192-deep MLP-down GEMMs' requant bound), no error
AUDIT_OLMO_WARNINGS = {"QNT002": 32}
AUDIT_ENCODERS = ("mobilebert", "whisper-tiny-encoder", "dinov2-small")


def _co_live_overlap(plan: dict) -> str:
    """Move one activation input of the first node that reads two onto the
    other's offset: two live tensors then share arena bytes (the MEM001
    mutation of the reference's tests/test_verify.py).  Returns its name."""
    kv = {n for kv_pair in plan["kv_state"] for n in kv_pair if n}
    tensors = plan["tensors"]
    for n in plan["nodes"]:
        cands = [t for t in n["inputs"]
                 if t in tensors and not tensors[t]["weight"] and tensors[t]["offset"] is not None
                 and tensors[t]["size"] > 0 and t not in kv]
        if len(cands) >= 2 and tensors[cands[0]]["offset"] != tensors[cands[1]]["offset"]:
            tensors[cands[0]]["offset"] = tensors[cands[1]]["offset"]
            return cands[0]
    raise AssertionError("no co-live activation pair found")


def audit_phase(torch, card: str, dev, eng: dict) -> dict[str, int]:
    """The static plan verifier and the autotuner on the main path: the
    verifier's cost and findings on every artifact of the earlier phases,
    a plan corrupted on disk refused by ``CompiledModel.load`` before any
    bind, and the autotuned OLMo-1B pair served through an ``Engine`` on
    the card beside the [engine] phase's untuned one."""
    import collections
    import contextlib
    import io
    import os
    import tempfile

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.deploy import api
    from repro_torch.deploy import verify as V

    launches = dict.fromkeys(kernels.wrappers(), 0)
    olmo = get_config("olmo-1b")
    e = ENGINE
    t_phase = time.perf_counter()

    # 1. the verifier's cost and findings on every artifact of the run
    cases = [(f"{arch} {backend} {'head-by-head' if hbh else 'fused'}", get_config(arch),
              dict(backend=backend, head_by_head=hbh))
             for arch in AUDIT_ENCODERS for backend in ("ita", "w8a8") for hbh in (False, True)]
    for backend in ("ita", "w8a8"):
        cases += [
            (f"olmo-1b {backend} dense fused", olmo,
             dict(backend=backend, seq_len=DECODER["seq_len"], max_len=DECODER["max_len"])),
            (f"olmo-1b {backend} dense unfused", olmo,
             dict(backend=backend, seq_len=DECODER["seq_len"], max_len=DECODER["max_len"],
                  fuse=False)),
            (f"olmo-1b {backend} paged", olmo,
             dict(backend=backend, seq_len=e["seq_len"], max_len=e["max_len"],
                  kv_block_size=e["block"], kv_blocks=e["kv_blocks"], prefix_cache=True)),
        ]
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i, (what, cfg, kw) in enumerate(cases):
            model = api.compile(cfg, use_cache=False, **kw)
            path = os.path.join(tmp, f"{i}.json")
            model.save(path)
            paths.append(path)
            # the same verifier over the saved file, unvalidated, on the host
            again = V.verify(V.load_artifact(path))
            by_rule = dict(collections.Counter(d.rule for d in model.diagnostics))
            require(not [d for d in model.diagnostics if d.severity == "error"],
                    f"audit: {what}: errors {model.diagnostics}")
            require(list(model.diagnostics) == again,
                    f"audit: {what}: compile's findings differ from the verifier's on the file")
            want = AUDIT_OLMO_WARNINGS if cfg is olmo else {}
            require(by_rule == want, f"audit: {what}: findings {by_rule}, expected {want}")
            log(f"  [audit] {what}: verify_ms {model.verify_ms:.3f}, findings "
                f"{by_rule or 'none'} ({len(model.artifact.to_json())} bytes of plan)")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc, rc_strict = V.main(paths), V.main(paths + ["--strict"])
        strict_rc = 1 if AUDIT_OLMO_WARNINGS else 0  # warnings fail only under --strict
        require((rc, rc_strict) == (0, strict_rc),
                f"audit: the CLI exits {rc} / {rc_strict} --strict, expected 0 / {strict_rc}")
        log(f"  [audit] python -m repro_torch.deploy.verify over the {len(paths)} files: rc "
            f"{rc}, rc {rc_strict} with --strict (the OLMo-1B warnings)")

        # 2. a plan corrupted on disk: refused before anything is bound
        model = api.compile(olmo, backend="ita", seq_len=DECODER["seq_len"],
                            max_len=DECODER["max_len"], use_cache=False)
        payload = model.to_dict()
        moved = _co_live_overlap(payload["artifact"]["decode"])
        path = os.path.join(tmp, "corrupt.json")
        with open(path, "w") as f:
            json.dump(payload, f)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        before = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        raised = None
        try:
            api.CompiledModel.load(path, olmo)
        except V.PlanVerificationError as exc:
            raised = exc
        after = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        require(raised is not None, "audit: a plan with overlapping tensors loaded")
        rules = sorted({d.rule for d in raised.diagnostics if d.severity == "error"})
        require("MEM001" in rules, f"audit: the corrupt plan raised {rules}, not MEM001")
        require(after == before, f"audit: device memory {before} -> {after} across the load")
        unchecked = api.CompiledModel.load(path, olmo, verify=False)
        require(unchecked.kind == "decoder" and unchecked.verify_ms == 0.0,
                "audit: verify=False did not load the corrupt file")
        log(f"  [audit] olmo-1b dense fused with {moved!r} moved onto a live tensor: "
            f"CompiledModel.load raised PlanVerificationError ({', '.join(rules)}); device "
            f"memory {before} -> {after} bytes; verify=False loads it")
        del model, unchecked

    # 3. the autotuned pair on the card, beside the [engine] phase's untuned one
    t0 = time.perf_counter()
    tuned = api.compile(olmo, backend="ita", seq_len=e["seq_len"], max_len=e["max_len"],
                        kv_block_size=e["block"], kv_blocks=e["kv_blocks"], prefix_cache=True,
                        autotune=True, use_cache=False)
    knobs = tuned.options["autotune"]
    log(f"  [audit] compile(autotune=True) in {time.perf_counter() - t0:.2f}s: knobs "
        f"{json.dumps(knobs)}; {json.dumps(tuned.artifact.autotune)} (predicted_cost_s is "
        f"the ITA ASIC model's decode step, not the card's); verify_ms {tuned.verify_ms:.3f}")
    require(knobs == AUDIT_KNOBS and tuned.artifact.autotune["knobs"] == knobs,
            f"audit: knobs {knobs}, the JAX package's are {AUDIT_KNOBS}")
    engine, streams, stats, secs = serve_engine(
        torch, card, dev, tuned, eng["qp"], eng["prompts"], "ita, autotuned", launches,
        tag="[audit]", prefix_counts=False)
    require(streams == eng["streams"], "audit: the tuned engine streams other tokens")
    require(stats.verify_ms > 0.0 and stats.verify_ms == tuned.verify_ms,
            f"audit: EngineStats.verify_ms {stats.verify_ms}")
    log(f"  [audit] the tuned engine's {len(streams)} streams equal the untuned engine's; "
        f"EngineStats.verify_ms {stats.verify_ms:.3f}")
    for label, st, sec, bs, nb in (
            ("untuned", eng["stats"], eng["secs"], e["block"], e["kv_blocks"]),
            ("autotuned", stats, secs, knobs["kv_block_size"], knobs["kv_blocks"])):
        log(f"  [audit] ita engine {label} ({nb} blocks of {bs}) on {card}: "
            f"{st.tokens_per_s():.1f} gen tok/s, TPOT p50/p99 {st.tpot(50) * 1e3:.1f}/"
            f"{st.tpot(99) * 1e3:.1f} ms, step p50/p99 {st.step_latency_p50() * 1e3:.1f}/"
            f"{st.step_latency_p99() * 1e3:.1f} ms, {st.prefill_dispatches} prefill "
            f"dispatches, {st.decode_dispatches} decode steps at "
            f"{st.decode_time_s / max(st.decode_dispatches, 1) * 1e3:.1f} ms each, "
            f"{st.preemptions} preemptions, {sec:.2f}s")
    log(f"  [audit] phase took {time.perf_counter() - t_phase:.1f}s")
    del engine, tuned
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches


#: rows of request 0's prompt that the seeded copy-on-write check shares
#: (12.5 blocks of 16: the last block partial), and the tail chunk's start
SANITIZE_SHARED = 200
SANITIZE_TAIL = 128


def time_shadow_hooks(shadow, stats: dict) -> None:
    """Wrap a ``ShadowPool``'s hooks (on the instance) so that each call
    adds its host seconds and one call to ``stats``."""
    for name in ("allocate", "fork", "pre_cow", "cow", "free", "write"):
        def timed(*args, _fn=getattr(shadow, name)):
            t = time.perf_counter()
            try:
                return _fn(*args)
            finally:
                stats["s"] += time.perf_counter() - t
                stats["calls"] += 1
        setattr(shadow, name, timed)


def sanitize_phase(torch, card: str, dev, eng: dict) -> dict[str, int]:
    """The concurrency and KV-lifetime sanitizer on the main path, under
    ``REPRO_SANITIZE=1`` (restored after): (a) ``python -m
    repro_torch.deploy.sanitize --interleavings`` clean; (b) a fresh paged
    ``ita`` engine with the prefix cache at OLMo-1B's full width serves the
    [engine] phase's 12 requests with its streams and no finding; (c) 8
    concurrent HTTP streams through its loop thread, equal again, and
    ``/v1/stats`` reporting the sanitizer on and clean; (d) a seeded
    skipped copy-on-write refused with BLK003 before its launch, the card's
    pool bit-identical; (e) the sanitized engine's times beside the
    unsanitized one's."""
    import os

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.deploy import api, sanitize
    from repro_torch.launch.serve import DispatchCounter

    launches = dict.fromkeys(kernels.wrappers(), 0)
    e = ENGINE
    t_phase = time.perf_counter()
    prev = os.environ.get("REPRO_SANITIZE")
    os.environ["REPRO_SANITIZE"] = "1"
    try:
        sanitize.reset_runtime()

        # (a) the static lints and the bounded interleaving checks
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-W", "ignore", "-m", "repro_torch.deploy.sanitize",
             "--interleavings"], capture_output=True, text=True, timeout=300, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        last = (res.stdout.strip().splitlines() or [""])[-1]
        require(res.returncode == 0 and last.endswith("OK — 0 error(s), 0 warning(s)"),
                f"sanitize: the CLI exited {res.returncode}: {res.stdout}{res.stderr}")
        log(f"  [sanitize] python -m repro_torch.deploy.sanitize --interleavings: rc 0, "
            f"{last.split(': ', 1)[-1]} ({time.perf_counter() - t0:.1f}s)")

        # (b) a fresh sanitized engine: its locks and shadow pool are built now
        model = api.compile(get_config("olmo-1b"), backend="ita", seq_len=e["seq_len"],
                            max_len=e["max_len"], kv_block_size=e["block"],
                            kv_blocks=e["kv_blocks"], prefix_cache=True, use_cache=False)
        hooks = {"s": 0.0, "calls": 0}

        engine, streams, stats, secs = serve_engine(
            torch, card, dev, model, eng["qp"], eng["prompts"], "ita, sanitized", launches,
            tag="[sanitize]",
            on_ready=lambda engine: time_shadow_hooks(engine.session.allocator.shadow, hooks))
        alloc = engine.session.allocator
        shadow = alloc.shadow
        require(isinstance(engine._lock, sanitize._TrackedLock) and shadow is not None
                and shadow.n_blocks == e["kv_blocks"],
                "sanitize: the engine was built without its tracked lock or shadow pool")
        require(streams == eng["streams"], "sanitize: the sanitized engine streams other tokens")
        require(sanitize.runtime_findings() == (),
                f"sanitize: lockdep findings {sanitize.runtime_findings()}")
        require(shadow.findings == [] and shadow.audit(alloc) == [],
                f"sanitize: shadow findings {shadow.findings}")
        require(engine.audit_sharing(source="sanitizer") == [],
                "sanitize: the sharing audit found faults")
        snap = shadow.snapshot()
        live = {"free": alloc.n_free, "shared": alloc.n_shared,
                "exclusive + cow-pending": alloc.n_used - alloc.n_shared}
        mirror = {"free": snap["free"], "shared": snap["shared"],
                  "exclusive + cow-pending": snap["exclusive"] + snap["cow-pending"]}
        require(mirror == live, f"sanitize: shadow {snap}, allocator {live}")
        dispatches = stats.prefill_dispatches + stats.decode_dispatches
        log(f"  [sanitize] the sanitized engine's {len(streams)} streams equal the [engine] "
            f"phase's; 0 lockdep findings, 0 shadow findings, audit and "
            f"audit_sharing(source='sanitizer') clean; shadow {snap}, allocator {live}")

        # (c) the same engine behind the HTTP frontend, from its loop thread
        stats_http = serve_http(card, dev, engine, eng["prompts"], eng["streams"], launches,
                                "[sanitize]")
        sz = stats_http["sanitize"]
        require(sz == {"enabled": True, "lockdep_findings": 0, "shadow_findings": 0,
                       "audit_findings": 0} and sanitize.runtime_findings() == (),
                f"sanitize: /v1/stats {sz}")
        log(f"  [sanitize] /v1/stats sanitize section {json.dumps(sz)}")

        # (d) a seeded skipped copy-on-write: refused on the host, before the launch
        sess = engine.session
        sess.rebind_thread()  # the loop thread has stopped
        counter = DispatchCounter(sess)
        wrappers = kernels.wrappers()
        prompt = eng["prompts"][0]
        sess.prefill_slot(0, torch.tensor([prompt[:SANITIZE_SHARED]], dtype=torch.int32))
        sess.attach_prefix(1, sess.block_chain(0), SANITIZE_SHARED)
        tail = torch.tensor([prompt[SANITIZE_TAIL: SANITIZE_TAIL + e["seq_len"]]],
                            dtype=torch.int32)
        sess._cow_range = lambda *a, **k: None  # seeded: slot 1 skips its copy
        if dev.type == "cuda":
            torch.cuda.synchronize()
        pool = {part: t.clone() for part, t in sess.kv_pool.items()}
        before = ({n: w.launches for n, w in wrappers.items()}, dict(counter.calls),
                  json.dumps(counter.launches))
        raised = None
        try:
            sess.prefill_chunks({1: (tail, SANITIZE_TAIL)})
        except sanitize.SanitizerError as exc:
            raised = exc
        finally:
            del sess._cow_range
        if dev.type == "cuda":
            torch.cuda.synchronize()
        require(raised is not None and [d.rule for d in raised.diagnostics] == ["BLK003"],
                f"sanitize: the skipped copy-on-write raised {raised!r}")
        after = ({n: w.launches for n, w in wrappers.items()}, dict(counter.calls),
                 json.dumps(counter.launches))
        require(after == before, f"sanitize: launches {before} -> {after} for the refused call")
        same = all(torch.equal(sess.kv_pool[part], pool[part]) for part in pool)
        require(same, "sanitize: the pool changed under the refused call")
        for slot in (1, 0):
            sess.free_slot(slot)
        require(shadow.audit(alloc) == [], "sanitize: the refused call left the pool unsound")
        for name, w in wrappers.items():
            launches[name] += w.launches
            w.launches = 0
        log(f"  [sanitize] slot 1 attached {SANITIZE_SHARED} shared rows, its copy-on-write "
            f"skipped, tail chunk at {SANITIZE_TAIL}: SanitizerError "
            f"{raised.diagnostics[0].format()}; 0 launches, the pool "
            f"({sum(t.numel() for t in pool.values())} bytes on {sess.device}) bit-identical")

        # (e) times, for the record only
        for label, st, sec in (("unsanitized ([engine])", eng["stats"], eng["secs"]),
                               ("sanitized", stats, secs)):
            log(f"  [sanitize] ita engine {label} on {card}: {st.tokens_per_s():.1f} gen tok/s, "
                f"TPOT p50/p99 {st.tpot(50) * 1e3:.1f}/{st.tpot(99) * 1e3:.1f} ms, step "
                f"p50/p99 {st.step_latency_p50() * 1e3:.1f}/"
                f"{st.step_latency_p99() * 1e3:.1f} ms, {st.prefill_dispatches} prefill "
                f"dispatches, {st.decode_dispatches} decode steps, {sec:.2f}s")
        log(f"  [sanitize] shadow hooks, on the host of {card}: {hooks['s'] * 1e3:.3f} ms over "
            f"{hooks['calls']} calls in {dispatches} dispatches: "
            f"{hooks['s'] * 1e3 / max(dispatches, 1):.4f} ms per dispatch")
    finally:
        if prev is None:
            os.environ.pop("REPRO_SANITIZE", None)
        else:
            os.environ["REPRO_SANITIZE"] = prev
    log(f"  [sanitize] phase took {time.perf_counter() - t_phase:.1f}s")
    del engine, sess
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    start = time.perf_counter()

    def phase(msg: str) -> None:
        log(f"{msg} (at {time.perf_counter() - start:.1f}s)")

    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    _build.build(*_build.KERNELS)
    log(f"[build] {', '.join(_build.KERNELS)} in {time.perf_counter() - t0:.1f}s "
        f"(into {_build.build_dir()})")
    for name in _build.KERNELS:
        for line in _build.compile_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {name}: {line.strip()}")
    tensor_core_sass(_build)
    pointwise_sass(_build)

    gen = torch.Generator().manual_seed(SEED)
    phase("[kernels] the plain path's integer product against the CPU's int32 product")
    dev = torch.device("cuda")
    exact_product_phase(torch, gen, dev)
    int_mm_depth_phase(torch, dev)
    phase("[kernels] each kernel against its plain version (exact)")
    kernels = kernel_phase(torch, gen, dev)
    for k in kernels:
        log(f"  {k['name']}: {k['ms']:.4f} ms on the card, plain {k['plain_ms']:.4f} ms on "
            f"the card, bound {k['bound_ms']:.5f} ms ({k['bound_by']}), library "
            f"{k['library_ms']} ms; {k['work']}")

    phase("[slice] compile -> session(8) -> forward on the card, vs the CPU forward "
        "(ita, w8a8, DeiT-Ti widths on ita)")
    launches = slice_phase(torch, card, dev)
    phase("[decoder] OLMo-1B at full width: compile -> session(8) -> prefill + 16 decode "
        "steps on the card, ita vs w8a8 vs the model chain, and the card vs the CPU")
    for name, n in decoder_phase(torch, card, dev).items():
        launches[name] += n
    phase("[head-by-head] the paper's per-head schedule: compile(head_by_head=True) -> "
        "session(8) -> forward on the card (ita, w8a8), vs the CPU forward")
    for name, n in head_by_head_phase(torch, card, dev).items():
        launches[name] += n
    phase("[paged] OLMo-1B over a paged, prefix-shared KV region: chunks, attach, decode with "
        "a parked slot, free and re-prefill, on ita and w8a8 vs the dense pair and the CPU")
    for name, n in paged_phase(torch, card, dev).items():
        launches[name] += n
    phase("[engine] OLMo-1B through the request-level engine over the paged pool: 12 "
          "requests on ita, w8a8 and ita without the prefix cache, then 8 HTTP streams")
    engine_launches, engine_run = engine_phase(torch, card, dev)
    for name, n in engine_launches.items():
        launches[name] += n
    phase("[audit] the static plan verifier on every artifact of the run, a corrupt plan "
          "refused at load, and the autotuned OLMo-1B pair through the engine")
    for name, n in audit_phase(torch, card, dev, engine_run).items():
        launches[name] += n
    phase("[sanitize] the concurrency and KV-lifetime sanitizer: static lints and "
          "interleaving checks, the sanitized engine at full width, 8 HTTP streams, and a "
          "seeded skipped copy-on-write refused before its launch")
    for name, n in sanitize_phase(torch, card, dev, engine_run).items():
        launches[name] += n
    for k in kernels:
        k["launches"] = launches[k["name"]]
        require(k["launches"] > 0, f"{k['name']} was never launched on the main path")

    phase("[done]")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
