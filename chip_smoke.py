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
   or float64) must equal the CPU's int32 product, a wrapping case included;
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
   second print per backend.

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


#: (label, B, H, Hkv, S, D, kv_valid, causal) of the ita_attention checks
ATTN_CASES = [
    ("mobilebert", 8, 4, 4, 128, 64, None, False),
    ("whisper-tiny-encoder", 8, 6, 6, 512, 64, None, False),
    ("dinov2-small", 8, 6, 6, 256, 64, 241, False),
    ("gqa-group2", 8, 6, 3, 256, 64, None, False),
    ("causal", 8, 4, 4, 256, 64, None, True),
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
    log("[kernels] the plain path's integer product against the CPU's int32 product")
    dev = torch.device("cuda")
    exact_product_phase(torch, gen, dev)
    log("[kernels] each kernel against its plain version (exact)")
    kernels = kernel_phase(torch, gen, dev)
    for k in kernels:
        log(f"  {k['name']}: {k['ms']:.4f} ms on the card, plain {k['plain_ms']:.4f} ms on "
            f"the card, bound {k['bound_ms']:.5f} ms ({k['bound_by']}), library "
            f"{k['library_ms']} ms; {k['work']}")

    log("[slice] compile -> session(8) -> forward on the card, vs the CPU forward "
        "(ita, w8a8, DeiT-Ti widths on ita)")
    launches = slice_phase(torch, card, dev)
    log("[decoder] OLMo-1B at full width: compile -> session(8) -> prefill + 16 decode "
        "steps on the card, ita vs w8a8 vs the model chain, and the card vs the CPU")
    for name, n in decoder_phase(torch, card, dev).items():
        launches[name] += n
    for k in kernels:
        k["launches"] = launches[k["name"]]
        require(k["launches"] > 0, f"{k['name']} was never launched on the main path")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
