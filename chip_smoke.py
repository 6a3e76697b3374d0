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
   inputs (integer-exact: tolerance zero), and ita_attention_paged, at
   the benchmark's OLMo-1B shapes (16 lanes over 2048-row tables: a chunk
   at each offset, three chunks beside parked lanes, a decode step at
   mixed depths), its plain version (the gather) on the card; then it is
   timed on the device
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
   per ``ita`` chunk and never in a decode step, ita_attention_paged 16
   times per chunk and decode step on both backends (the dense pair: never);
   the logits must equal
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
   engines (counted per ``prefill_slot`` / ``prefill_chunks`` call),
   ita_attention_paged 16 times per prefill dispatch and decode step, and
   no other kernel; the prefix cache's hits and the sharing audit
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
   times per prefill dispatch, ita_attention_paged 16 times per prefill
   dispatch and decode step, and
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

11. ptq — post-training quantization from the float models (true float32
   matmuls: TF32 must be off).  MobileBERT at full width, batch 8 x 128:
   float params from seed 0, 4 calibration batches from a seeded numpy
   generator; the float forward and ``calibrate_encoder`` on the card must
   agree with the CPU's (logits within 1e-3, the scales within 1e-5
   relative); the params are quantized once on the host with the card's
   scales, and the calibrated ``forward_w8a8`` on ``ita`` (int8_gemm 96x,
   ita_attention 24x) and on ``w8a8`` (itamax 24x) must equal the CPU's bit
   for bit.  The fidelity against the float logits (cosine, relative
   error, argmax agreement) prints for the default and the calibrated
   grid, with the share of the embedding table that rounds to 0, and the
   float forward, the calibration and the integer forwards are timed.
   OLMo-1B at full width, batch 8: float params drawn on the card, a float
   prefill of 128 tokens and 15 greedy decode steps must agree with the
   float forward over the same 143 tokens (within 1e-3 of the largest
   logit); an ``ita`` session bound from the float params (quantized as
   ``CompiledModel.bind`` does) must launch int8_gemm 112 times in its
   prefill and give the model-level ``forward_w8a8``'s last row bit for
   bit; its fidelity and the greedy tokens it shares with the float chain
   print.
12. dryrun — ``repro_torch.launch.dryrun.run_via_plan`` in-process at
   batch 8: MobileBERT on ``ita``, MobileBERT head-by-head on ``w8a8``,
   and OLMo-1B on ``ita`` (128-token prompt, 16 decode steps); each must
   return 0 (the plan equals the model-level chain bit for bit) and write
   its record and plan under ``build/``.
13. families — StableLM-1.6B at full width through the deploy flow, as
   the decoder phase runs OLMo-1B (compile -> ``DecoderPlanPair`` ->
   session(8), a 128-token prefill and 16 greedy steps, ``ita`` ==
   ``w8a8`` == the model chain, ``int8_gemm`` 168 times an ``ita``
   prefill: 7 GEMMs a layer); Qwen1.5-110B and Mistral-Large-123B
   compiled and verified as plans (1120 / 1232 ``QNT002`` warnings, no
   other finding); then each other family at its full published width and
   depth through ``model_zoo.build(cfg)``: granite-moe-3b-a800m,
   qwen2-moe-a2.7b, mamba2-370m, zamba2-2.7b, seamless-m4t-large-v2 and
   llava-next-34b, serve params drawn on the card from seed 0 by a CUDA
   generator, a prefill of batch 8 by ``input_specs``' rule (128 tokens;
   seamless 32 frames; llava 576 patches + 448 tokens) and 16 greedy
   decode steps, each timed with its peak memory, freed before the next,
   and launching no kernel of ours (the families' model-level paths are
   cluster code in both packages).  Last, each family against the CPU at
   full width with its depth cut (llava also to 16 patches), batch 2, 16
   text positions and 3 steps on the same weights: MoE routing equal in
   every ``_route`` call and the integer outputs (MoE, seamless, llava)
   bit-exact; mamba2 and zamba2 on float32 and on their bfloat16 serve
   params within the stated share of the largest logit, and zamba2's
   integer shared-attention core bit-exact from one int8 input.
14. train — training on one card (no kernel of ours runs: float32
   products with TF32 off, on the CUDA cores).  OLMo-1B at its full
   published width and depth (1.18 G float32 params, 18.8 GB with grads
   and AdamW moments) through ``repro_torch.launch.train.main`` in-process
   at its defaults (batch 4 x 128, 10 steps, remat) and 3 steps with 2
   microbatches accumulated in bfloat16, all losses finite; the same step
   timed one by one (median and max ms, tok/s, peak memory, an mfu of
   6 N tokens over the step time and the card's dense float32 peak) and
   traced once (device busy and idle share, top kernels).  The card
   against the CPU at full width with 2 layers: two steps with 2
   microbatches and remat, plain and with QAT, from params drawn once on
   the CPU, loss, grad_norm and updated params within the stated
   tolerances.  A Supervisor(save_every=4) run of 10 steps on the
   example's narrowed OLMo with a failure injected at step 6 must equal
   the uninterrupted run bit for bit, and a checkpoint of card tensors
   must restore onto the card bit for bit.  examples/torch_train_tinylm.py
   --steps 30 in-process, with its own loss-falls assertion; then one step
   of every arch of the registry, reduced, on the card against the CPU.
15. distributed — the distributed runtime, after ``[train]``'s state is
   freed (no kernel of ours runs): (a) ``make_host_mesh()`` starts a world
   of one over NCCL (a 1x1 mesh), and OLMo-1B at full width and depth
   takes 3 steps through ``launch.train.shard_train_fn`` under
   ``activation_policy``, from ``[train]``'s params (seed 0) and its first
   3 batches, against the unsharded step in the same call: losses, grad
   norms and params equal (else held to ``[train]``'s tolerances, the
   difference printed), every param and AdamW leaf on the rules'
   placements, the step times side by side, and the sharded steps' peak
   allocation within ``DIST_PEAK_RTOL`` of the unsharded steps'; (b) ``compressed_psum`` on
   the card over that group, bit-exact with ``compress`` -> ``decompress``
   on the CPU; (d) on that mesh, OLMo-1B at full width cut to 2 layers
   through the sharded step under ``Supervisor(save_every=2)`` over 6
   steps with a failure injected at step 3: losses, grad norms, params
   and AdamW state equal the uninterrupted run's bit for bit, the last
   checkpoint equals a plain tree's save key by key, ``restore(...,
   shardings=)`` gives the saved values on the rules' placements; its
   GB, the seconds of ``save_async``'s return, a synchronous save and a
   restore printed; (c) 4 spawned ranks sharing the card over gloo (NCCL
   takes one rank a GPU): ``compressed_psum`` on CUDA tensors bit-exact
   with the same ranks on CPU tensors, and ``pipelined_apply`` over 4
   stages (sends staged through the host) within 1e-5 of the layers
   applied in turn.

16. multipod — the multi-pod dry run (no kernel of ours runs): (ii)
   ``[distributed]`` (a)'s step recorded by ``deploy.hlo_analysis`` in a
   fake world of one (a child process, ``FakeTensorMode`` on the card's
   device) and for real on the card over a new NCCL world of one: flops,
   every op's count and the argument bytes equal, and the card's peak
   allocation within ``MULTIPOD_PEAK_RATIO`` of the predicted peak; (i)
   ``python -m repro_torch.launch.dryrun --arch A --shape S [--multi-pod
   on]`` for each of ``MULTIPOD_CELLS`` in a fake 256- or 512-rank world
   of its own (``MULTIPOD_JOBS`` at a time; ``MULTIPOD_EARLY``, the
   costliest, each started niced when the script starts), every record ``ok``,
   its flops, collective bytes by op, argument and temp bytes a rank and
   host seconds printed, and each train cell's temp a rank within
   ``MULTIPOD_XLA_RATIO`` of GSPMD's (``MULTIPOD_XLA_TEMP``).

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


#: OLMo-1B's paged attention in the benchmark's cells: 16 lanes, 16 heads of
#: 128, blocks of 16 rows, 2048-row tables (128 blocks), KV blocks of 512
PAGED_ATTN = dict(lanes=16, heads=16, kv_heads=16, head_dim=128, block=16, cols=128,
                  block_k=512)


def paged_attn_cases(rng, lanes: int, rows: int) -> list:
    """(label, S, offsets, parked lanes) of the ita_attention_paged checks: a
    512-query chunk at each offset of the table, a docqa-like dispatch of
    three chunks whose other lanes are parked (all-scratch tables, offset
    0), and a decode step at mixed depths with one lane parked on scratch
    and one past its table."""
    quarter = [rows // 4 * (i % 4) for i in range(lanes)]
    docqa = [0, rows // 4, rows // 2] + [0] * (lanes - 3)
    depths = [int(x) for x in rng.integers(0, rows, lanes)]
    depths[-2:] = [0, rows]
    return [("chunk-each-offset", 512, quarter, []),
            ("chunk-docqa-parked", 512, docqa, list(range(3, lanes))),
            ("decode-mixed-depths", 1, depths, [lanes - 2])]


def paged_attn_bytes_ops(heads, kv_heads, s, d, offsets, rows):
    """q read once, out written once, each K and V row a lane's queries need
    read once, the tables; int8 ops of Q K^T and P V over each query's keys
    [0, pos + i] below the table's width."""
    need = sum(min(p + s, rows) for p in offsets)
    keys = sum(min(p + i + 1, rows) for p in offsets for i in range(s))
    n_bytes = 2 * len(offsets) * s * heads * d + 2 * need * kv_heads * d \
        + len(offsets) * rows // PAGED_ATTN["block"] * 4 + 96 * 4
    return n_bytes, 2 * 2 * heads * keys * d


def paged_attn_phase(torch, gen, dev) -> dict:
    """ita_attention_paged on the card against its plain version (the
    gather, on the card) at the cells' shapes, each case torch.equal, then
    timed; returns the chunk-at-each-offset case's ``kernels`` entry."""
    import numpy as np

    from repro_torch.kernels.ita_attention import ita_attention_paged, ita_attention_paged_ref
    from repro_torch.kernels.ita_attention.ops import paged_launch_grid

    c = PAGED_ATTN
    b, h, hkv, d, bs, cols = (c[k] for k in ("lanes", "heads", "kv_heads", "head_dim",
                                             "block", "cols"))
    rows = cols * bs
    kw = dict(heads=h, kv_heads=hkv, head_dim=d, block_k=c["block_k"], s_q=0.01, s_k=0.01,
              s_v=0.01, s_out=0.00125)
    pool = (b * cols + 1, hkv, bs, d)
    k_pool = torch.randint(-128, 128, pool, generator=gen, dtype=torch.int8).to(dev)
    v_pool = torch.randint(-128, 128, pool, generator=gen, dtype=torch.int8).to(dev)
    own = (torch.randperm(b * cols, generator=gen) + 1).reshape(b, cols).to(torch.int32)
    err, entry = 0.0, None
    for label, s, offsets, parked in paged_attn_cases(np.random.default_rng(SEED), b, rows):
        table = own.clone()
        table[parked] = 0  # the scratch block
        table = table.to(dev)
        pos = np.asarray(offsets, np.int32)
        q = torch.randint(-128, 128, (b, s, h * d), generator=gen, dtype=torch.int8).to(dev)
        before = ita_attention_paged.launches
        got = ita_attention_paged(q, k_pool, v_pool, pos, table, **kw)
        torch.cuda.synchronize()
        require(ita_attention_paged.launches == before + 1, f"ita_attention_paged {label}: "
                "not one launch")
        want = ita_attention_paged_ref(q, k_pool, v_pool, pos, table, **kw)
        err = max(err, max_abs_err(got, want.cpu()))
        require(torch.equal(got, want), f"ita_attention_paged {label} != plain")
        ms = device_ms(lambda: ita_attention_paged(q, k_pool, v_pool, pos, table, **kw))
        per_call = call_ms(lambda: ita_attention_paged(q, k_pool, v_pool, pos, table, **kw),
                           reps=20)
        plain = call_ms(lambda: ita_attention_paged_ref(q, k_pool, v_pool, pos, table, **kw),
                        reps=3)
        bnd, by = bound_ms(*paged_attn_bytes_ops(h, hkv, s, d, offsets, rows))
        out, groups, split, ring, gx, gy = paged_launch_grid(b, h, hkv, s, d, c["block_k"])
        log(f"  ita_attention_paged {label:20s} B={b} S={s:3d} H={h}/{hkv} D={d} rows={rows} "
            f"parked={len(parked)}: equal; device {ms:.4f} ms (per call with dispatch "
            f"{per_call:.4f} ms), plain on the card {plain:.4f} ms, bound {bnd:.5f} ms ({by}); "
            f"{out} columns, {groups} row groups x {split} warps, ring {ring}, {gx * gy} "
            f"blocks")
        if label == "chunk-each-offset":
            entry = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by)
    return {"name": "ita_attention_paged", "route": "cuda",
            "source": "src/repro_torch/csrc/ita_attention.cu",
            "replaces": "src/repro/core/heterogeneous.py:467", "launches": 0,
            "max_abs_err": err, **entry, "library_ms": None,
            "work": "one OLMo-1B layer's attn_paged in a 16 x 512 chunk dispatch, 4 lanes at "
                    "each offset of 2048-row tables: 16 heads of 128, blocks of 16, block_k "
                    "512; no PyTorch call computes integer flash-ITAMax attention"}


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

    paged = paged_attn_phase(torch, gen, dev)

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
        paged,
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
    from repro_torch.convert import to_device

    return to_device(qp, dev)


def decoder_phase(torch, card: str, dev, arch: str = "olmo-1b",
                  cpu_check: bool = True) -> dict[str, int]:
    """A dense decoder (OLMo-1B unless ``arch`` says otherwise) at full width
    on both backends, against each other, the model chain on the card and
    (short prompt, where ``cpu_check``) the CPU."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.deploy import api
    from repro_torch.models import transformer as T

    cfg = get_config(arch)
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
        log(f"  [decoder] {cfg.name} ({be}): plan nodes prefill {counts['prefill']['nodes']} "
            f"({counts['prefill']['ita']} ita), decode {counts['decode']['nodes']}; int8_gemm "
            f"{gemm_per_prefill if be == 'ita' else 0} launches a prefill, no kernel a decode "
            f"step; prefill {batch}x{seq} {m['prefill']:.3f} ms; decode step median "
            f"{statistics.median(dec):.3f} ms (min {min(dec):.3f}, max {max(dec):.3f}) over "
            f"{steps} steps: {batch * steps / (sum(dec) / 1e3):.1f} tok/s on {card}")
    log(f"  [decoder] {cfg.name} logits and K/V caches: ita == w8a8 == the model chain on "
        f"the card at the prefill and all {steps} decode steps (batch {batch}, {cap} KV rows)")
    del sessions, ref_cache, qp_dev
    if not cpu_check:
        return launches

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
            # a paged dispatch attends through the paged kernel once a layer
            attn = cfg.n_layers if plan_kind.startswith("paged") else 0
            want = {name: gemm if name == "int8_gemm" else attn
                    if name == "ita_attention_paged" else 0 for name in wrappers}
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
            f"{gemm_per_chunk if be == 'ita' else 0} launches a chunk, ita_attention_paged "
            f"{cfg.n_layers} a paged chunk or decode step; on {card}")
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
    on ita, over a paged pool ita_attention_paged once a layer per prefill
    dispatch and decode step, nothing else; each call the engine counted.
    Adds the run's launches to ``launches`` and sets the counts to 0."""
    from repro_torch import kernels

    wrappers = kernels.wrappers()
    got = {name: w.launches for name, w in wrappers.items()}
    require(counter.calls["prefill"] == stats.prefill_dispatches
            and counter.calls["decode"] == stats.decode_dispatches,
            f"{what}: {counter.calls} dispatches, the engine counted "
            f"{stats.prefill_dispatches} prefill and {stats.decode_dispatches} decode")
    if dev.type == "cuda":  # the wrappers count launches on the card only
        gemm = olmo_gemms(model) * counter.calls["prefill"]
        attn = model.cfg.n_layers if model.artifact.paged else 0
        want = {name: gemm if name == "int8_gemm" else
                attn * (counter.calls["prefill"] + counter.calls["decode"])
                if name == "ita_attention_paged" else 0 for name in wrappers}
        require(got == want, f"{what}: launches {got}, expected {want}")
        steps = attn * counter.calls["decode"]
        require(counter.launches["decode"] == ({"ita_attention_paged": steps} if steps else {}),
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
        f"launches each), {stats.decode_dispatches} decode steps; ita_attention_paged "
        f"{model.cfg.n_layers if model.artifact.paged else 0} launches a dispatch; "
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
    stats = engine.stats_snapshot()
    if got != want[:n]:
        detail = []
        for i in range(n):
            if got[i] != want[i]:
                (toks, reason), (wtoks, wreason) = got[i], want[i]
                at = next((j for j, (a, b) in enumerate(zip(toks, wtoks)) if a != b), None)
                detail.append(f"request {i}: {reason} after {len(toks)} tokens (sync {wreason} "
                              f"after {len(wtoks)}), first differing token at {at}")
        log(f"  {tag} HTTP streams {got}\n  sync streams {want[:n]}\n  {stats.summary()}")
        require(False, f"{tag} the HTTP streams differ from the sync engine's: "
                f"{'; '.join(detail)} (ci/torch_engine_http_repeat.py repeats this run)")
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


# ---------------------------------------------------------------------------
# ptq phase: float -> calibrate -> quantize -> the integer path
# ---------------------------------------------------------------------------

#: MobileBERT: batch, sequence and calibration batches; OLMo-1B: prompt,
#: KV rows, batch and greedy steps of the float and int8 chains
PTQ_ENCODER = dict(batch=8, seq=128, calib_batches=4)
PTQ_DECODER = dict(seq_len=128, max_len=160, batch=8, steps=16)
#: card vs CPU: the float logits (max |diff|) and the calibrated scales
#: (relative); float32 products and reductions run in another order on
#: the card, so these agree within float32 rounding, not bit for bit
PTQ_LOGITS_ATOL = 1e-3
PTQ_SCALE_RTOL = 1e-5
#: OLMo-1B's float decode chain against its float forward over the same
#: teacher-forced tokens: max |diff| over max(1, max |logit|)
PTQ_CHAIN_RTOL = 1e-3


def _counts_zero(wrappers) -> None:
    for w in wrappers.values():
        w.launches = 0


def _take(wrappers, launches: dict, dev, want: dict | None, what: str) -> dict:
    """Add the wrappers' counts to ``launches`` and set them to 0; on the
    card they must be ``want`` (kernels not named: 0)."""
    got = {name: w.launches for name, w in wrappers.items()}
    if want is not None and dev.type == "cuda":
        full = {name: want.get(name, 0) for name in wrappers}
        require(got == full, f"{what}: launches {got}, expected {full}")
    for name, n in got.items():
        launches[name] += n
    _counts_zero(wrappers)
    return got


def _median_s(torch, dev, fn, reps: int = 3) -> float:
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return statistics.median(times)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def ptq_phase(torch, card: str, dev, encoder: str = "mobilebert",
              decoder: str = "olmo-1b") -> dict[str, int]:
    """PTQ on the card: MobileBERT's float forward and calibration against
    the CPU's, its calibrated integer forward on ``ita`` and ``w8a8``
    equal to the CPU's bit for bit; OLMo-1B's float chain against its
    float forward, its float-bound ``ita`` session against the model-level
    ``forward_w8a8``, and the float / int8 fidelity of both."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.convert import tree_leaves
    from repro_torch.deploy import api
    from repro_torch.models import encoder as EN
    from repro_torch.models import transformer as T
    from repro_torch.quant.ptq import calibrate_encoder, quantization_error

    require(not torch.backends.cuda.matmul.allow_tf32
            and torch.get_float32_matmul_precision() == "highest",
            "float32 matmuls must run in float32 (TF32 is on)")
    wrappers = kernels.wrappers()
    launches = dict.fromkeys(wrappers, 0)
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()

    # MobileBERT: float -> calibrate on the card and on the CPU
    cfg = get_config(encoder)
    e = PTQ_ENCODER
    rng = np.random.default_rng(SEED)
    batches = [{"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (e["batch"], e["seq"]),
                                                        dtype=np.int32))}
               for _ in range(e["calib_batches"])]
    params = EN.init_params(cfg, SEED)
    params_dev = _on(params, dev)
    batches_dev = [{k: v.to(dev) for k, v in b.items()} for b in batches]
    with torch.no_grad():
        fl = EN.forward(cfg, params_dev, batches_dev[0])
        fl_cpu = EN.forward(cfg, params, batches[0])
        err = float((fl.cpu() - fl_cpu).abs().max())
        require(tuple(fl.shape) == (e["batch"], e["seq"], cfg.vocab)
                and bool(torch.isfinite(fl).all()), f"float logits {tuple(fl.shape)}")
        require(err <= PTQ_LOGITS_ATOL, f"float logits: card vs CPU max |diff| {err}")
        qc = calibrate_encoder(cfg, params_dev, batches_dev)
        qc_cpu = calibrate_encoder(cfg, params, batches)
        rels = {s: _rel(getattr(qc, s), getattr(qc_cpu, s)) for s in ("s_act", "s_res", "s_w")}
        require(max(rels.values()) <= PTQ_SCALE_RTOL, f"calibrated scales: card vs CPU {rels}")
        log(f"  [ptq] {encoder}: float logits {tuple(fl.shape)}, card vs CPU max |diff| "
            f"{err:.3g} (limit {PTQ_LOGITS_ATOL:g}); calibrated on {len(batches)} batches: "
            f"s_act {qc.s_act:.9g}, s_res {qc.s_res:.9g}, s_w {qc.s_w:.9g}; card vs CPU "
            f"relative {', '.join(f'{k} {v:.3g}' for k, v in rels.items())} (limit "
            f"{PTQ_SCALE_RTOL:g})")

        # quantize once on the host with the card's scales; the integer
        # forwards on the card equal the CPU's bit for bit
        qp = EN.quantize_params(cfg, params, qc)
        qp_dev = _on(qp, dev)
        q_default = EN.quantize_params(cfg, params)
        per_fwd = {"ita": dict(int8_gemm=4 * cfg.n_layers, ita_attention=cfg.n_layers),
                   "w8a8": dict(itamax=cfg.n_layers)}
        outs = {}
        for be in ("ita", "w8a8"):
            _counts_zero(wrappers)
            outs[be] = EN.forward_w8a8(cfg, qp_dev, batches_dev[0], q=qc, backend=be)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            _take(wrappers, launches, dev, per_fwd[be], f"ptq {encoder} {be}")
            want = EN.forward_w8a8(cfg, qp, batches[0], q=qc, backend=be)
            require(torch.equal(outs[be].cpu(), want),
                    f"ptq {encoder} {be}: calibrated forward_w8a8 card != CPU")
        _counts_zero(wrappers)
        default = EN.forward_w8a8(cfg, _on(q_default, dev), batches_dev[0], backend="ita")
        _take(wrappers, launches, dev, per_fwd["ita"], f"ptq {encoder} default grid")
        for label, out, table in (("default grid", default, q_default["embed"]["table_q"]),
                                  ("calibrated", outs["ita"], qp["embed"]["table_q"])):
            m = quantization_error(fl, out)
            zero = float((table == 0).float().mean())
            log(f"  [ptq] {encoder} ita vs float, {label}: cosine {m['cosine']:.6f}, rel_err "
                f"{m['rel_err']:.6f}, argmax agreement {m['argmax_agreement']:.6f}; "
                f"embedding table entries at 0 on the residual grid {zero:.6f}")
        m = quantization_error(outs["ita"], outs["w8a8"])
        log(f"  [ptq] {encoder} calibrated ita vs w8a8 (flash vs rowwise ITAMax): cosine "
            f"{m['cosine']:.6f}, argmax agreement {m['argmax_agreement']:.6f}")
        t_float = _median_s(torch, dev, lambda: EN.forward(cfg, params_dev, batches_dev[0]))
        t_cal = _median_s(torch, dev, lambda: calibrate_encoder(cfg, params_dev, batches_dev),
                          reps=1)
        t_int = {be: _median_s(torch, dev, lambda be=be: EN.forward_w8a8(
            cfg, qp_dev, batches_dev[0], q=qc, backend=be)) for be in ("ita", "w8a8")}
        _take(wrappers, launches, dev, None, "ptq timing")
        log(f"  [ptq] {encoder} batch {e['batch']}x{e['seq']} on {card}: float forward "
            f"{1e3 * t_float:.3f} ms, calibration ({len(batches)} batches) {t_cal:.3f} s, "
            f"calibrated forward_w8a8 ita {1e3 * t_int['ita']:.3f} ms, w8a8 "
            f"{1e3 * t_int['w8a8']:.3f} ms (median of 3, host clock)")
    del params_dev, qp_dev

    # OLMo-1B: the float chain against the float forward, then the
    # float-bound ita session against the model-level integer forward
    cfg = get_config(decoder)
    d = PTQ_DECODER
    t0 = time.perf_counter()
    params = T.init_params(cfg, SEED, device=dev)
    log(f"  [ptq] {decoder}: float params drawn (seed {SEED}) in "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{sum(t.numel() for t in tree_leaves(params)) * 4 / 1e9:.2f} GB in float32")
    gen = torch.Generator().manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab, (d["batch"], d["seq_len"]), generator=gen,
                            dtype=torch.int32).to(dev)
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = T.prefill(cfg, params, {"tokens": prompts}, d["max_len"])
        chain = [logits]
        toks = [_greedy(torch, logits)]
        for _ in range(d["steps"] - 1):
            logits, cache = T.decode_step(cfg, params, cache, toks[-1][:, None])
            chain.append(logits)
            toks.append(_greedy(torch, logits))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t_chain = time.perf_counter() - t0
        del cache
        seq = torch.cat([prompts] + [t[:, None] for t in toks[:-1]], dim=1)
        full = T.forward(cfg, params, {"tokens": seq})
        s0 = d["seq_len"] - 1
        got = torch.cat(chain, dim=1)
        want = full[:, s0:s0 + d["steps"]]
        scale = max(1.0, float(want.abs().max()))
        diff = float((got - want).abs().max())
        require(bool(torch.isfinite(got).all()), f"{decoder}: non-finite float logits")
        require(diff <= PTQ_CHAIN_RTOL * scale,
                f"{decoder}: float prefill + decode chain vs forward max |diff| {diff} "
                f"(max |logit| {scale})")
        del full
        log(f"  [ptq] {decoder} float: prefill {d['batch']}x{d['seq_len']} + "
            f"{d['steps'] - 1} decode steps in {t_chain:.2f}s; the chain's logits vs the "
            f"float forward over the same {seq.shape[1]} tokens: max |diff| {diff:.3g} "
            f"(limit {PTQ_CHAIN_RTOL:g} x {scale:.3g})")

        model = api.compile(cfg, backend="ita", seq_len=d["seq_len"], max_len=d["max_len"],
                            use_cache=False)
        t0 = time.perf_counter()
        sess = model.session(d["batch"], params=params, device=None if dev.type == "cuda"
                             else dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        require(sess.device == dev, f"session on {sess.device}, not {dev}")
        t_bind = time.perf_counter() - t0
        gemm = sum(n.kind == "gemm" and n.engine == "ita"
                   for n in model.artifact.prefill.flat_nodes())
        _counts_zero(wrappers)
        q_logits = sess.prefill(prompts)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        # on the card: 7 int8_gemm launches a layer, the plan's ita GEMMs
        _take(wrappers, launches, dev, dict(int8_gemm=7 * cfg.n_layers),
              f"ptq {decoder} prefill")
        ref = T.forward_w8a8(cfg, sess.qp, {"tokens": prompts})
        _take(wrappers, launches, dev, {}, f"ptq {decoder} forward_w8a8")
        require(torch.equal(q_logits, ref[:, -1:]),
                f"{decoder}: the float-bound session's prefill != forward_w8a8's last row")
        q_toks = [_greedy(torch, q_logits)]
        for _ in range(d["steps"] - 1):
            q_toks.append(_greedy(torch, sess.decode(q_toks[-1])))
        _take(wrappers, launches, dev, {}, f"ptq {decoder} decode")
        m = quantization_error(chain[0], q_logits)
        agree = int(sum(int((a == b).sum()) for a, b in zip(toks, q_toks)))
        first = int((toks[0] == q_toks[0]).sum())
        log(f"  [ptq] {decoder} ita session bound from float params (quantized on the card "
            f"in {t_bind:.1f}s): int8_gemm {gemm} launches a prefill; prefill logits equal "
            f"forward_w8a8's last row bit for bit; vs the float prefill: cosine "
            f"{m['cosine']:.6f}, rel_err {m['rel_err']:.6f}, argmax agreement "
            f"{m['argmax_agreement']:.6f}; greedy tokens equal to the float chain's: "
            f"{agree} of {d['steps'] * d['batch']} ({first} of {d['batch']} at the first step)")
    del sess, params, chain
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"  [ptq] phase took {time.perf_counter() - t_phase:.1f}s")
    return launches


# ---------------------------------------------------------------------------
# dryrun phase: python -m repro_torch.launch.dryrun --via-plan, in-process
# ---------------------------------------------------------------------------

#: (arch, backend, head_by_head, seq, gen) of each run_via_plan call, batch 8
DRYRUN = [
    ("mobilebert", "ita", False, None, 2),
    ("mobilebert", "w8a8", True, None, 2),
    ("olmo-1b", "ita", False, 128, 16),
]


def dryrun_phase(torch, card: str, dev, reduced_cfg: bool = False) -> dict[str, int]:
    """``run_via_plan`` for each row of :data:`DRYRUN` at batch 8: rc 0
    (the plan equals the model-level chain bit for bit), its record and
    plan written under ``build/``."""
    import tempfile

    from repro_torch import kernels
    from repro_torch.launch.dryrun import run_via_plan

    wrappers = kernels.wrappers()
    launches = dict.fromkeys(wrappers, 0)
    (ROOT / "build").mkdir(exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="dryrun-", dir=ROOT / "build")
    for arch, backend, hbh, seq, gen in DRYRUN:
        _counts_zero(wrappers)
        t0 = time.perf_counter()
        rc = run_via_plan(arch, reduced_cfg=reduced_cfg, backend=backend, batch_size=BATCH,
                          seq_len=seq, head_by_head=hbh, gen_steps=gen, out_dir=out_dir,
                          use_cache=False, device=None if dev.type == "cuda" else dev,
                          seed=SEED)
        got = _take(wrappers, launches, dev, None, f"dryrun {arch}")
        require(rc == 0, f"dryrun {arch} {backend}: run_via_plan returned {rc}")
        per = ", ".join(f"{n} {c}" for n, c in got.items() if c) or "none"
        log(f"  [dryrun] {arch} ({backend}{', head-by-head' if hbh else ''}): rc 0 in "
            f"{time.perf_counter() - t0:.1f}s on {card}; launches {per}")
    files = sorted(p.name for p in Path(out_dir).iterdir())
    require(len(files) == 2 * len(DRYRUN) - 1, f"dryrun wrote {files}")
    log(f"  [dryrun] records and plans in {out_dir}: {', '.join(files)}")
    return launches


# ---------------------------------------------------------------------------
# families phase: the other dense decoders and the other model families
# ---------------------------------------------------------------------------

#: the plan-only dense decoders and their QNT002 warnings (both packages)
PLAN_ONLY = [("qwen1.5-110b", 1120), ("mistral-large-123b", 1232)]
#: (arch, prompt positions of the prefill cell, input_specs' rule): batch 8
#: and 16 greedy decode steps each; llava prepends its 576 patches to 448
#: tokens (704 positions do not divide the flash blocks of 512 in either
#: package); seamless encodes min(1024, max(128 // 4, 16)) = 32 frames
FAMILIES = [("granite-moe-3b-a800m", 128), ("qwen2-moe-a2.7b", 128), ("mamba2-370m", 128),
            ("zamba2-2.7b", 128), ("seamless-m4t-large-v2", 128), ("llava-next-34b", 1024)]
FAMILY_BATCH, FAMILY_STEPS = 8, 16
#: the card against the CPU: full widths, the depth (and llava's patches)
#: cut so that the CPU's int32 products take seconds; batch 2, 16 text
#: positions, 3 decode steps
FAMILY_CPU_CUTS = {
    "granite-moe-3b-a800m": dict(n_layers=2), "qwen2-moe-a2.7b": dict(n_layers=2),
    "mamba2-370m": dict(n_layers=2), "zamba2-2.7b": dict(n_layers=6),
    "seamless-m4t-large-v2": dict(enc_layers=2, dec_layers=2),
    "llava-next-34b": dict(n_layers=1, n_patches=16),
}
FAMILY_CPU = dict(batch=2, seq=16, steps=3)
#: float chains card vs CPU, by (family, params): max |diff| over the
#: largest |logit|, float32 params (no TF32) and the bfloat16 serve params.
#: zamba2's float trunk meets its int8 attention at S_HYB: a last-bit
#: difference of the trunk moves h_q one step at a rounding boundary, and
#: the attention's output moves with it (its integer core is held bit for
#: bit from one h_q instead)
FAMILY_RTOL = {("ssm", "f32"): 1e-3, ("ssm", "bf16"): 0.1,
               ("hybrid", "f32"): 0.05, ("hybrid", "bf16"): 0.1}


def _family_chain(torch, api, sp, batch, max_len, steps, sync):
    """prefill, then ``steps`` greedy decode steps: the logits of each, the
    last cache, the prefill's and each step's ms (host clock, synced)."""
    t = time.perf_counter()
    logits, cache = api.prefill(sp, batch, max_len)
    sync()
    prefill_ms, step_ms, out = 1e3 * (time.perf_counter() - t), [], [logits]
    for _ in range(steps):
        tok = torch.argmax(logits[:, -1].float(), dim=-1).to(torch.int32)[:, None]
        t = time.perf_counter()
        logits, cache = api.decode_step(sp, cache, tok)
        sync()
        step_ms.append(1e3 * (time.perf_counter() - t))
        out.append(logits)
    return out, cache, prefill_ms, step_ms


def _hybrid_core_exact(torch, cfg, dev) -> str:
    """zamba2's integer shared attention from one int8 h_q, on the card and
    the CPU: the prefill form (16 positions) and a decode step at row 16
    of a 20-row cache; o_q and the K/V written bit for bit."""
    from repro_torch.convert import to_device
    from repro_torch.models import zamba2 as Z

    gen = torch.Generator().manual_seed(SEED + 2)
    shared = Z.init_params(cfg.replace(n_layers=0), SEED, device="cpu")["shared"]
    sq = Z.quantize_shared(shared)
    h_q = torch.randint(-128, 128, (2, 16, cfg.d_model), generator=gen, dtype=torch.int8)
    step = h_q[:, :1].clone()
    shape = (2, cfg.n_kv_heads, 20, cfg.head_dim)
    kc = torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8)
    vc = torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8)
    outs = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        q = to_device(sq, device)
        o1, (k1, v1) = Z._shared_attn_core_i8(cfg, q, h_q.to(device), torch.arange(16))
        kcd, vcd = kc.to(device), vc.to(device)
        o2, _ = Z._shared_attn_core_i8(cfg, q, step.to(device), [16], (kcd, vcd, 16))
        outs[where] = [t.cpu() for t in (o1, k1, v1, o2, kcd, vcd)]
    for i, (a, b) in enumerate(zip(outs["card"], outs["cpu"])):
        require(torch.equal(a, b), f"zamba2 shared attention core: card and CPU differ ({i})")
    return "the int8 shared-attention core from one h_q bit-exact (prefill and decode)"


def families_phase(torch, card: str, dev) -> dict[str, int]:
    """StableLM-1.6B through the deploy flow, the two large dense decoders as
    plans, and each other family at its full published width and depth
    through ``model_zoo.build(cfg)``, then the card against the CPU."""
    import collections

    from repro_torch import kernels
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.convert import to_device, tree_leaves
    from repro_torch.deploy import api as deploy_api
    from repro_torch.models import build, synthesize_batch
    from repro_torch.models import moe as M

    wrappers = kernels.wrappers()
    launches = dict.fromkeys(wrappers, 0)
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    for name, n in decoder_phase(torch, card, dev, arch="stablelm-1.6b",
                                 cpu_check=False).items():
        launches[name] += n
    log(f"  [families] stablelm-1.6b through the plan pair in {time.perf_counter() - t0:.1f}s")
    for arch, warnings in PLAN_ONLY:
        for be in ("ita", "w8a8"):
            t0 = time.perf_counter()
            m = deploy_api.compile(get_config(arch), backend=be, seq_len=DECODER["seq_len"],
                                   max_len=DECODER["max_len"], use_cache=False)
            rules = collections.Counter((d.rule, d.severity) for d in m.diagnostics)
            require(rules == collections.Counter({("QNT002", "warning"): warnings}),
                    f"{arch} {be}: findings {dict(rules)}")
            gemms = sum(n.kind == "gemm" and n.engine == "ita"
                        for n in m.artifact.prefill.flat_nodes())
            log(f"  [families] {arch} ({be}) plan only: {m.counts()['prefill']['nodes']} "
                f"prefill nodes ({gemms} ita GEMMs), {m.counts()['decode']['nodes']} decode "
                f"nodes, {warnings} QNT002 warnings, compiled and verified in "
                f"{time.perf_counter() - t0:.1f}s, fingerprint {m.fingerprint[:12]}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    on_card = None if dev.type == "cuda" else dev
    for arch, seq in FAMILIES:
        cfg = get_config(arch)
        api = build(cfg)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        _counts_zero(wrappers)
        t0 = time.perf_counter()
        sp = api.init_serve_params(SEED, device=on_card)
        sync()
        t_init = time.perf_counter() - t0
        leaves = list(tree_leaves(sp))
        require(all(t.device.type == dev.type for t in leaves), f"{arch}: params off {dev}")
        n_bytes = sum(t.numel() * t.element_size() for t in leaves)
        by_dtype = collections.Counter()
        for t in leaves:
            by_dtype[str(t.dtype).replace("torch.", "")] += t.numel() * t.element_size()
        cell = ShapeCell("prefill", seq, FAMILY_BATCH, "prefill")
        batch = synthesize_batch(cfg, cell, seed=SEED, device=on_card)
        positions = seq  # a vlm's patches are positions of the prompt
        max_len = positions + FAMILY_STEPS + 1
        out, cache, prefill_ms, step_ms = _family_chain(torch, api, sp, batch, max_len,
                                                        FAMILY_STEPS, sync)
        _take(wrappers, launches, dev, {}, f"{arch} serving chain")
        require(int(cache["len"]) == positions + FAMILY_STEPS, f"{arch}: len {cache['len']}")
        require(all(bool(torch.isfinite(x.float()).all()) for x in out),
                f"{arch}: non-finite logits")
        require(tuple(out[-1].shape) == (FAMILY_BATCH, 1, cfg.vocab_padded),
                f"{arch}: logits {tuple(out[-1].shape)}")
        peak = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else 0.0
        inputs = ", ".join(f"{k} {tuple(v.shape)} {str(v.dtype)[6:]}" for k, v in batch.items())
        log(f"  [families] {arch} ({cfg.family}; {cfg.n_layers or cfg.enc_layers} layers, "
            f"d {cfg.d_model}): serve params {n_bytes / 1e9:.3f} GB "
            f"({', '.join(f'{k} {v / 1e9:.3f}' for k, v in sorted(by_dtype.items()))}) drawn "
            f"on {dev.type} in {t_init:.2f}s; prefill [{inputs}] {prefill_ms:.3f} ms; decode "
            f"step median {statistics.median(step_ms):.3f} ms (min {min(step_ms):.3f}, max "
            f"{max(step_ms):.3f}) over {FAMILY_STEPS} steps: "
            f"{FAMILY_BATCH * FAMILY_STEPS / (sum(step_ms) / 1e3):.1f} tok/s; peak "
            f"{peak:.2f} GB allocated; no kernel of ours launched; on {card}")
        del sp, cache, out, batch, leaves

    # the card against the CPU: full width, depth cut, the same weights
    for arch, cuts in FAMILY_CPU_CUTS.items():
        cfg = get_config(arch).replace(**cuts)
        api = build(cfg)
        t0 = time.perf_counter()
        seq = FAMILY_CPU["seq"] + (cfg.n_patches if cfg.family == "vlm" else 0)
        cell = ShapeCell("prefill", seq, FAMILY_CPU["batch"], "prefill")
        batch = synthesize_batch(cfg, cell, seed=SEED + 1, device="cpu")
        max_len = seq + FAMILY_CPU["steps"] + 1
        runs = {}
        float_chain = cfg.family in ("ssm", "hybrid")
        variants = [("bf16", None)] + ([("f32", torch.float32)] if float_chain else [])
        routes = {}
        for label, dtype in variants:
            if dtype is None:
                sp = api.init_serve_params(SEED, device=on_card)
            else:  # the float32 model with the serve params' layout
                sp = api.init_params(SEED, dtype=dtype, device=on_card)
                if cfg.family == "hybrid":
                    from repro_torch.models import zamba2 as Z

                    sp = {"params": sp, "qshared": Z.quantize_shared(sp["shared"])}
            for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
                calls = []
                real_route = M._route

                def record(cfg_, w, h, calls=calls):
                    d, c, a = real_route(cfg_, w, h)
                    calls.append(d.cpu())
                    return d, c, a

                M._route = record
                try:
                    b = {k: v.to(device) for k, v in batch.items()}
                    out, cache, _, _ = _family_chain(
                        torch, api, to_device(sp, device), b, max_len, FAMILY_CPU["steps"],
                        sync if where == "card" else (lambda: None))
                finally:
                    M._route = real_route
                runs[(label, where)] = ([x.cpu() for x in out],
                                        {k: v.cpu() for k, v in cache.items()})
                routes[(label, where)] = calls
            del sp
        _counts_zero(wrappers)
        detail = []
        for label, _ in variants:
            (card_out, card_cache), (cpu_out, cpu_cache) = runs[(label, "card")], \
                runs[(label, "cpu")]
            if cfg.family == "moe":
                r_card, r_cpu = routes[(label, "card")], routes[(label, "cpu")]
                require(len(r_card) == len(r_cpu) > 0 and all(
                    torch.equal(a, b) for a, b in zip(r_card, r_cpu)),
                    f"{arch}: the card's routing differs from the CPU's")
                detail.append(f"routing equal in {len(r_card)} _route calls")
            if float_chain:
                scale = max(1.0, max(float(x.float().abs().max()) for x in cpu_out))
                err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(card_out, cpu_out))
                tol = FAMILY_RTOL[(cfg.family, label)]
                require(err <= tol * scale, f"{arch} {label}: card vs CPU {err} > "
                                            f"{tol} x {scale}")
                detail.append(f"{label} logits max |diff| {err:.3g} (largest |logit| "
                              f"{scale:.3g}, limit {tol} of it)")
                if cfg.family == "hybrid":
                    kv = torch.cat([(card_cache[k].int() - cpu_cache[k].int()).abs().flatten()
                                    for k in ("k", "v")])
                    detail.append(f"{label} int8 K/V differ on {float((kv > 0).float().mean()):.3%}"
                                  f" (max {int(kv.max())})")
            else:
                for i, (a, b) in enumerate(zip(card_out, cpu_out)):
                    require(torch.equal(a, b), f"{arch}: card and CPU logits differ at step {i}")
                for k in card_cache:
                    require(torch.equal(card_cache[k], cpu_cache[k]),
                            f"{arch}: card and CPU cache {k} differ")
                detail.append("logits and caches bit-exact")
        if cfg.family == "hybrid":
            detail.append(_hybrid_core_exact(torch, cfg, dev))
        log(f"  [families] {arch} card vs CPU ({', '.join(f'{k} {v}' for k, v in cuts.items())}"
            f"; batch {FAMILY_CPU['batch']}, {seq} positions, {FAMILY_CPU['steps']} steps): "
            f"{'; '.join(detail)} in {time.perf_counter() - t0:.1f}s")
    log(f"  [families] phase took {time.perf_counter() - t_phase:.1f}s on {card}")
    return launches


# ---------------------------------------------------------------------------
# train phase: training on one card (launch.train, AdamW, the data pipeline,
# checkpoint/restart supervision)
# ---------------------------------------------------------------------------

#: OLMo-1B at its full published width and depth through launch.train.main
#: at its defaults (batch 4, seq 128, 10 steps), then ``mb_steps`` steps
#: accumulating 2 microbatches in bfloat16; ``timed`` steps of the same
#: step timed one by one (host clock after a sync), then one traced step
TRAIN = dict(arch="olmo-1b", batch=4, seq=128, steps=10, mb_steps=3, timed=5)
#: H100 SXM dense float32 peak outside the tensor cores (NVIDIA data sheet):
#: the mfu's denominator, since TF32 is off and float32 products run there
PEAK_FP32_FLOP_PER_S = 67e12
#: the card against the CPU: OLMo-1B's full width, its depth cut to 2
#: layers; two steps of make_train_step(microbatches=2, remat=True), plain
#: and with QAT, from the same params drawn once on the CPU
TRAIN_CPU = dict(n_layers=2, batch=4, seq=64, steps=2)
#: card vs CPU tolerances, per step, by QAT (tests/test_torch_train.py
#: holds the port against the JAX package at reduced widths to the same
#: ones but the QAT share): float32 products and reductions run in another
#: order on the card; AdamW's early updates are about lr * sign(g), so an
#: element whose |g| is near eps, or whose bfloat16-accumulated gradient
#: crosses zero, may move up to 2 * lr apart: every element within
#: 2 * lr * steps, at most TRAIN_TIGHT_SHARE of them beyond TRAIN_TIGHT.
#: With QAT a fake-quant input one ulp apart rounds to the next int8 step,
#: so the forward moves by a whole step there and every gradient behind it
#: by more than rounding; how many params the second step then moves apart
#: grows with the width (a one-ulp perturbation of the params, on a CPU
#: alone: 0 at d 128, 6.4e-4 of them at d 512; an NVIDIA H100 80GB HBM3 at
#: 700 W against a CPU at OLMo-1B's d 2048: 1.9e-2), so QAT's share is held
#: to 5e-2
TRAIN_LOSS_RTOL = {False: 1e-5, True: 1e-4}
TRAIN_GNORM_RTOL = {False: 1e-4, True: 1e-3}
TRAIN_LR = 3e-4  # make_train_step's default schedule
TRAIN_TIGHT = 1e-5
TRAIN_TIGHT_SHARE = {False: 1e-3, True: 5e-2}
#: the example's narrowed OLMo (12 layers, d 768, 12x64 heads, d_ff 3072,
#: vocab 32000; 138M params, 1.65 GB a checkpoint with the AdamW state)
TINYLM = dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64, d_ff=3072,
              vocab=32000)
#: restart: Supervisor(save_every=4) over 10 steps with a failure injected
#: at step 6, against the same 10 steps uninterrupted; batch 4 x 128
TRAIN_RESTART = dict(save_every=4, steps=10, fail_at=6, batch=4, seq=128)
#: examples/torch_train_tinylm.py's arguments (its defaults: batch 8 x 256)
TINYLM_ARGS = ["--steps", "30"]
#: each arch of the registry, reduced: one step on the card and the CPU
TRAIN_FAMILY = dict(batch=2, seq=32)


def _train_batch(torch, batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _compare_steps(torch, card_run, cpu_run, qat: bool, what: str) -> str:
    """The card's (losses, grad norms, params) against the CPU's within the
    stated tolerances; returns what was measured."""
    from repro_torch.convert import tree_leaves

    (card_m, card_p), (cpu_m, cpu_p) = card_run, cpu_run
    worst_loss = worst_gn = 0.0
    for i, ((l1, g1), (l2, g2)) in enumerate(zip(card_m, cpu_m)):
        worst_loss, worst_gn = max(worst_loss, _rel(l1, l2)), max(worst_gn, _rel(g1, g2))
        require(_rel(l1, l2) <= TRAIN_LOSS_RTOL[qat], f"{what} step {i}: loss {l1} vs {l2}")
        require(_rel(g1, g2) <= TRAIN_GNORM_RTOL[qat], f"{what} step {i}: grad_norm {g1} vs {g2}")
    diff = [(a.float() - b.float()).abs() for a, b in zip(tree_leaves(card_p), tree_leaves(cpu_p))]
    worst = max(float(d.max()) for d in diff)
    n = sum(d.numel() for d in diff)
    share = sum(int((d > TRAIN_TIGHT).sum()) for d in diff) / n
    steps = len(card_m)
    require(worst <= 2 * TRAIN_LR * steps, f"{what}: params differ by {worst}")
    require(share <= TRAIN_TIGHT_SHARE[qat],
            f"{what}: {share:.3e} of params beyond {TRAIN_TIGHT}")
    return (f"loss rel {worst_loss:.2e} (limit {TRAIN_LOSS_RTOL[qat]}), grad_norm rel "
            f"{worst_gn:.2e} (limit {TRAIN_GNORM_RTOL[qat]}), params max |diff| {worst:.2e} "
            f"(limit {2 * TRAIN_LR * steps:.1e}), {share:.3e} of {n} beyond {TRAIN_TIGHT} "
            f"(limit {TRAIN_TIGHT_SHARE[qat]})")


def _run_steps(torch, api, params, batches, device, **kw):
    """make_train_step(api, **kw) over ``batches`` on ``device`` from a copy
    of ``params``: ([(loss, grad_norm)], the params on the host)."""
    from repro_torch.convert import to_device, tree_map
    from repro_torch.launch.train import make_train_step
    from repro_torch.optim import adamw

    p = to_device(tree_map(torch.clone, params), device)
    o = adamw.init(p)
    step = make_train_step(api, **kw)
    metrics = []
    for b in batches:
        p, o, m = step(p, o, _train_batch(torch, b, device))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, tree_map(lambda t: t.cpu(), p)


def _with_qat(api):
    import dataclasses

    return dataclasses.replace(api, loss_fn=lambda p, b, _f=api.loss_fn, **kw: _f(
        p, b, qat=True, **kw))


def train_phase(torch, card: str, dev, reduced_cfg: bool = False) -> dict[str, int]:
    """Training on one card: OLMo-1B at full width and depth through
    ``launch.train.main`` (timed and traced), the card against the CPU at
    full width, a supervised restart equal to the uninterrupted run, the
    tinylm example, and one step of every arch against the CPU."""
    import functools
    import importlib.util
    import math
    import shutil
    import tempfile

    from repro_torch import kernels
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import ShapeCell, get_config, list_archs, reduced
    from repro_torch.convert import tree_leaves, tree_map
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch import train as T
    from repro_torch.launch.serve import profile_call
    from repro_torch.models import build
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault import Supervisor

    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off for float parity")
    on_card = dev.type == "cuda"
    wrappers = kernels.wrappers()
    launches = dict.fromkeys(wrappers, 0)
    _counts_zero(wrappers)
    t_phase = time.perf_counter()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def cut(cfg):
        return reduced(cfg) if reduced_cfg else cfg

    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="train-", dir=ROOT / "build"))
    try:
        # 1. launch.train.main in-process at its defaults, then 2 microbatches
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        args = ["--arch", TRAIN["arch"], "--batch", str(TRAIN["batch"]), "--seq",
                str(TRAIN["seq"]), "--device", dev.type, "--ckpt-dir", str(work / "main")]
        args += ["--reduced"] if reduced_cfg else []
        t0 = time.perf_counter()
        losses = T.main(args + ["--steps", str(TRAIN["steps"])])
        t_main = time.perf_counter() - t0
        require(len(losses) == TRAIN["steps"] and all(map(math.isfinite, losses)),
                f"launch.train: losses {losses}")
        t0 = time.perf_counter()
        mb = T.main(args + ["--steps", str(TRAIN["mb_steps"]), "--microbatches", "2"])
        t_mb = time.perf_counter() - t0
        require(len(mb) == TRAIN["mb_steps"] and all(map(math.isfinite, mb)),
                f"launch.train --microbatches 2: losses {mb}")
        # the cosine schedule's lr is 0 at step 0: steps 0 and 1 see the same
        # params in both runs, so their losses agree to float32 rounding
        same = max(_rel(mb[i], losses[i]) for i in (0, 1))
        require(same <= TRAIN_LOSS_RTOL[False], f"microbatches 2 vs 1: losses {mb} vs {losses}")
        _take(wrappers, launches, dev, {}, "launch.train")
        peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
        log(f"  [train] launch.train.main ({TRAIN['arch']}, defaults: batch {TRAIN['batch']}, seq "
            f"{TRAIN['seq']}, {TRAIN['steps']} steps) in {t_main:.1f}s: loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}, all finite; --microbatches 2 (bfloat16 accumulation) "
            f"{TRAIN['mb_steps']} steps in {t_mb:.1f}s: {', '.join(f'{x:.4f}' for x in mb)} "
            f"(steps 0-1 within {same:.1e} of the single batch's); peak {peak:.2f} GB "
            f"allocated; no kernel of ours launched; on {card}")

        # 2. the same step timed one by one, then traced
        cfg = cut(get_config(TRAIN["arch"]))
        api = build(cfg)
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        params = api.init_params(SEED, device=None if on_card else dev)
        opt = adamw.init(params)
        n_params = sum(t.numel() for t in tree_leaves(params))
        sched = functools.partial(adamw.cosine_schedule, peak_lr=3e-4, warmup=10, total=20)
        step = T.make_train_step(api, lr_schedule=sched)
        dcfg = DataConfig(vocab=cfg.vocab, global_batch=TRAIN["batch"], seq_len=TRAIN["seq"])
        cell = ShapeCell("train", TRAIN["seq"], TRAIN["batch"], "train")
        times = []
        for s in range(TRAIN["timed"] + 1):
            batch = _train_batch(torch, make_batch(cfg, cell, dcfg, s), dev)
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
        require(math.isfinite(float(m["loss"])), "timed steps: non-finite loss")
        first, times = times[0], times[1:]
        med = statistics.median(times)
        tokens = TRAIN["batch"] * TRAIN["seq"]
        mfu = 6 * n_params * tokens / (med / 1e3) / PEAK_FP32_FLOP_PER_S
        peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
        log(f"  [train] {cfg.name} step ({n_params / 1e9:.3f} G params, batch {TRAIN['batch']} x "
            f"{TRAIN['seq']}, remat, AdamW in place): first {first:.3f} ms, then median "
            f"{med:.3f} ms, max {max(times):.3f} ms over {len(times)} steps; "
            f"{tokens / (med / 1e3):.1f} tok/s; mfu {100 * mfu:.1f}% (6 N tokens / step time "
            f"over the {PEAK_FP32_FLOP_PER_S / 1e12:.0f} TFLOP/s dense float32 peak of the H100 "
            f"SXM data sheet); peak {peak:.2f} GB allocated; on {card}")
        batch = _train_batch(torch, make_batch(cfg, cell, dcfg, TRAIN["timed"] + 1), dev)
        prof = profile_call(lambda: step(params, opt, batch), dev)
        busy = prof["device_busy_ms"] / med
        log(f"  [train] traced step: wall {prof['wall_ms']:.3f} ms, device busy "
            f"{prof['device_busy_ms']:.3f} ms of the untraced median {med:.3f} ms: busy "
            f"{100 * busy:.1f}%, idle {100 * (1 - busy):.1f}%, {prof['device_kernels']} device "
            f"kernels; on {card}")
        _take(wrappers, launches, dev, {}, "the timed and traced steps")
        del params, opt, step, batch, m

        # 3. the card against the CPU, full width, depth cut
        cfg2 = cut(get_config(TRAIN["arch"])).replace(n_layers=TRAIN_CPU["n_layers"])
        api2 = build(cfg2)
        p_cpu = api2.init_params(SEED, device="cpu")
        dcfg2 = DataConfig(vocab=cfg2.vocab, global_batch=TRAIN_CPU["batch"],
                           seq_len=TRAIN_CPU["seq"])
        cell2 = ShapeCell("train", TRAIN_CPU["seq"], TRAIN_CPU["batch"], "train")
        batches = [make_batch(cfg2, cell2, dcfg2, s) for s in range(TRAIN_CPU["steps"])]
        for qat in (False, True):
            a = _with_qat(api2) if qat else api2
            t0 = time.perf_counter()
            runs = [_run_steps(torch, a, p_cpu, batches, d, microbatches=2, remat=True)
                    for d in (dev, torch.device("cpu"))]
            what = f"{cfg2.name} {cfg2.n_layers} layers{' qat' if qat else ''}"
            detail = _compare_steps(torch, runs[0], runs[1], qat, what)
            log(f"  [train] card vs CPU, {what} (d {cfg2.d_model}, vocab {cfg2.vocab}; batch "
                f"{TRAIN_CPU['batch']} x {TRAIN_CPU['seq']}, 2 microbatches, remat, "
                f"{TRAIN_CPU['steps']} steps): {detail} in {time.perf_counter() - t0:.1f}s")
        _take(wrappers, launches, dev, {}, "card vs CPU")
        del p_cpu, runs

        # 4. a supervised restart against the uninterrupted run
        cfg3 = get_config("olmo-1b").replace(**TINYLM, max_seq=TRAIN_RESTART["seq"])
        cfg3 = reduced(cfg3) if reduced_cfg else cfg3
        api3 = build(cfg3)
        p0 = api3.init_params(SEED, device=None if on_card else dev)
        dcfg3 = DataConfig(vocab=cfg3.vocab, global_batch=TRAIN_RESTART["batch"],
                           seq_len=TRAIN_RESTART["seq"])
        cell3 = ShapeCell("tinylm", TRAIN_RESTART["seq"], TRAIN_RESTART["batch"], "train")
        step3 = T.make_train_step(api3, microbatches=2, lr_schedule=functools.partial(
            adamw.cosine_schedule, peak_lr=1e-3, warmup=5, total=100))

        def step_fn(state, batch):
            p, o, metrics = step3(*state, _train_batch(torch, batch, dev))
            return (p, o), metrics

        runs = {}
        for fail in (None, TRAIN_RESTART["fail_at"]):
            p = tree_map(torch.clone, p0)
            failed = []

            def inject(s, fail=fail, failed=failed):
                if s == fail and not failed:
                    failed.append(s)
                    raise RuntimeError("injected failure")

            ck = Checkpointer(str(work / f"restart-{fail}"))
            t0 = time.perf_counter()
            state, hist = Supervisor(ck, save_every=TRAIN_RESTART["save_every"]).run(
                step_fn, (p, adamw.init(p)), lambda s: make_batch(cfg3, cell3, dcfg3, s), 0,
                TRAIN_RESTART["steps"], inject_failure=inject)
            losses = {s: float(m["loss"]) for s, m in hist}
            runs[fail] = (state, losses, [s for s, _ in hist], time.perf_counter() - t0, ck)
        (a, la, sa, ta, _), (b, lb, sb, tb, ck) = runs[None], runs[TRAIN_RESTART["fail_at"]]
        require(sa == list(range(10)) and sb == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7, 8, 9],
                f"restart: steps {sa} / {sb}")
        leaves_a, leaves_b = list(_state_leaves(a)), list(_state_leaves(b))
        worst = max(float((x.float() - y.float()).abs().max()) for x, y in zip(leaves_a, leaves_b))
        require(la == lb and worst == 0.0 and all(torch.equal(x, y)
                                                  for x, y in zip(leaves_a, leaves_b)),
                f"restart: not bit-exact (losses {la} / {lb}, max |diff| {worst})")
        # a checkpoint written from card tensors restores onto the card bit for bit
        probe = (b[0], b[1], {"bf16": b[0]["embed"]["table"].to(torch.bfloat16)})
        ck.save(99, probe)
        back = ck.restore(99, probe)
        got, want = list(_state_leaves(back)), list(_state_leaves(probe))
        require(all(x.device == y.device and x.dtype == y.dtype and torch.equal(x, y)
                    for x, y in zip(got, want)), "checkpoint round trip on the card differs")
        last = TRAIN_RESTART["steps"] // TRAIN_RESTART["save_every"] * TRAIN_RESTART["save_every"]
        size = sum(f.stat().st_size for f in (work / f"restart-{TRAIN_RESTART['fail_at']}"
                                              / f"step_{last}").iterdir()) / 1e9
        log(f"  [train] restart ({cfg3.name} narrowed: {cfg3.n_layers} layers, d "
            f"{cfg3.d_model}; batch {TRAIN_RESTART['batch']} x {TRAIN_RESTART['seq']}, 2 "
            f"microbatches): Supervisor(save_every={TRAIN_RESTART['save_every']}) with a "
            f"failure at step {TRAIN_RESTART['fail_at']} replayed steps 4-5 and equals the "
            f"uninterrupted run bit for bit (losses, params, AdamW state; "
            f"{ta:.1f}s / {tb:.1f}s with async saves of {size:.2f} GB); a checkpoint of card "
            f"tensors (a bfloat16 leaf included) restores onto the card bit for bit; on {card}")
        _take(wrappers, launches, dev, {}, "restart")
        del runs, a, b, probe, back, p0

        # 5. the tinylm example, in-process
        path = ROOT / "examples" / "torch_train_tinylm.py"
        spec = importlib.util.spec_from_file_location("torch_train_tinylm", path)
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
        t0 = time.perf_counter()
        out = example.main(TINYLM_ARGS + ["--ckpt-dir", str(work / "tinylm"), "--device",
                                          dev.type])
        require(out["losses"][-1] < out["losses"][0], "tinylm: the loss did not fall")
        _take(wrappers, launches, dev, {}, "tinylm example")
        log(f"  [train] examples/torch_train_tinylm.py {' '.join(TINYLM_ARGS)}: "
            f"{out['n_params'] / 1e6:.1f}M params, loss {out['losses'][0]:.3f} -> "
            f"{out['losses'][-1]:.3f}, {out['tok_s']:.1f} tok/s (checkpoint writes included) "
            f"in {time.perf_counter() - t0:.1f}s; on {card}")

        # 6. one step of every arch, reduced, on the card against the CPU
        t0 = time.perf_counter()
        rows = []
        for arch in list_archs():
            cfg4 = reduced(get_config(arch))
            api4 = build(cfg4)
            p4 = api4.init_params(SEED, device="cpu")
            dcfg4 = DataConfig(vocab=max(cfg4.vocab, 2), global_batch=TRAIN_FAMILY["batch"],
                               seq_len=TRAIN_FAMILY["seq"])
            cell4 = ShapeCell("train", TRAIN_FAMILY["seq"], TRAIN_FAMILY["batch"], "train")
            b4 = [make_batch(cfg4, cell4, dcfg4, 0)]
            r = [_run_steps(torch, api4, p4, b4, d, remat=True) for d in (dev, torch.device("cpu"))]
            rows.append(f"{arch}: {_compare_steps(torch, r[0], r[1], False, arch)}")
        _take(wrappers, launches, dev, {}, "every arch")
        log(f"  [train] one step of every arch (reduced, batch {TRAIN_FAMILY['batch']} x "
            f"{TRAIN_FAMILY['seq']}, remat) on the card vs the CPU in "
            f"{time.perf_counter() - t0:.1f}s:")
        for row in rows:
            log(f"    {row}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"  [train] phase took {time.perf_counter() - t_phase:.1f}s on {card}")
    return launches


#: [distributed] (a): OLMo-1B at full width and depth through
#: shard_train_fn on a 1x1 NCCL mesh (a world of one) against the unsharded
#: step, from [train]'s params (seed 0) and its first 3 batches
DIST = dict(arch="olmo-1b", batch=4, seq=128, steps=3)
#: (b): compressed_psum's input, the reference test's shape
DIST_PSUM = (4, 2048)
#: (c): 4 spawned ranks sharing the card over gloo (NCCL refuses two ranks
#: on one GPU): compressed_psum on CUDA tensors, bit-exact against the same
#: 4 ranks on CPU tensors; the 4-stage pipeline on CUDA tensors (its sends
#: staged through the host: gloo cannot send a CUDA tensor) against the
#: layers applied in turn on the card.  A 2x2 step of OLMo-1B cut to 2
#: layers is left out: a rank died of SIGSEGV in it over gloo (ROADMAP.md
#: section 3, PERF.md section 6)
DIST_SPAWN = dict(world=4, pipe_d=2048, pipe_batch=16, timeout=300)
#: (d): checkpoint/restart around the sharded step on (a)'s 1x1 mesh:
#: OLMo-1B at full width (d 2048, vocab 50304) cut to 2 layers (237.5 M
#: params, 2.85 GB with the AdamW moments, so a save takes seconds; [train]
#: trains full depth), (a)'s batches of 4 x 128; Supervisor(save_every=2)
#: over 6 steps with one failure injected at step 3, against the same 6
#: steps uninterrupted.  The multi-rank saves and restores (8 -> 4 ranks)
#: run on gloo CPU ranks in tests/test_torch_distributed.py: over gloo an
#: all-gather of CUDA tensors kills the rank (ROADMAP.md section 3)
#: (a): the sharded steps' peak allocation within this share of the
#: unsharded steps' (the same state and activations on a world of one)
DIST_PEAK_RTOL = 0.05
DIST_CKPT = dict(n_layers=2, save_every=2, steps=6, fail_at=3)


def _olmo_steps_on(torch, api, params, batches, step_fn, sync):
    """``step_fn`` over ``batches`` from ``params``: ([(loss, grad_norm)],
    [ms a step], params, state)."""
    from repro_torch.optim import adamw

    opt = adamw.init(params)
    metrics, times = [], []
    for b in batches:
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, b)
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, times, params, opt


def _dist_psum(torch, rank: int, world: int, dev) -> dict:
    import torch.distributed as dist

    from repro_torch.optim.compression import compressed_psum

    gen = torch.Generator().manual_seed(SEED)
    g_all = torch.randn(DIST_PSUM, generator=gen) * 0.01
    err = torch.randn(DIST_PSUM[1:], generator=gen) * 1e-4
    g = g_all[rank]
    t0 = time.perf_counter()
    out_d, err_d = compressed_psum(g.to(dev), err.to(dev), dist.group.WORLD)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    out_h, err_h = compressed_psum(g, err, dist.group.WORLD)
    want = g_all.sum(0)
    return {"exact": torch.equal(out_d.cpu(), out_h) and torch.equal(err_d.cpu(), err_h),
            "device": str(out_d.device), "ms": ms,
            "rel": float((out_h - want).abs().max() / want.abs().max())}


def _dist_pipeline(torch, rank: int, world: int, dev) -> dict:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.pipeline import pipelined_apply

    d, b = DIST_SPAWN["pipe_d"], DIST_SPAWN["pipe_batch"]
    gen = torch.Generator().manual_seed(SEED)
    w = (torch.randn((world, d, d), generator=gen) / d ** 0.5).to(dev)
    x = torch.randn((b, d), generator=gen).to(dev)
    pods = make_mesh((world,), ("pod",), device=dev.type)
    t0 = time.perf_counter()
    y = pipelined_apply(pods, lambda p, h: torch.tanh(h @ p["w"]), {"w": w}, x, pipe_axis="pod",
                        n_micro=4)
    ms = 1e3 * (time.perf_counter() - t0)
    seq = x
    for s in range(world):
        seq = torch.tanh(seq @ w[s])
    return {"device": str(y.device), "ms": ms, "err": float((y - seq).abs().max())}


def _dist_rank(rank: int, world: int, out: str, dev_type: str) -> None:
    """One rank of [distributed] (c): compressed_psum and the pipeline, its
    results to a file."""
    import torch

    from repro_torch import kernels

    dev = torch.device(dev_type)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    wrappers = kernels.wrappers()
    _counts_zero(wrappers)
    res = {"psum": _dist_psum(torch, rank, world, dev),
           "pipeline": _dist_pipeline(torch, rank, world, dev)}
    res["launches"] = {name: w.launches for name, w in wrappers.items()}
    torch.save(res, Path(out) / f"rank{rank}.pt")


def _dist_checkpoint(torch, card: str, dev, mesh, cfg, dcfg, cell, sync) -> None:
    """[distributed] (d): a Supervisor restart around shard_train_fn's step
    on ``mesh`` against the uninterrupted run, bit for bit; the last save
    key by key against a plain tree's of the same values; the restore by
    the rules' placements.  On the CPU under
    ``torch.use_deterministic_algorithms``: its threaded
    ``index_put_(accumulate=True)`` (the embedding's backward) sums a
    repeated token's rows in a varying order (ROADMAP.md section 3)."""
    on_cpu = dev.type == "cpu"
    if on_cpu:
        torch.use_deterministic_algorithms(True)
    try:
        _dist_checkpoint_runs(torch, card, dev, mesh, cfg, dcfg, cell, sync)
    finally:
        if on_cpu:
            torch.use_deterministic_algorithms(False)


def _dist_checkpoint_runs(torch, card: str, dev, mesh, cfg, dcfg, cell, sync) -> None:
    import shutil
    import tempfile

    import numpy as np
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.checkpointer import _host_flat
    from repro_torch.data import make_batch
    from repro_torch.launch.train import make_train_step, shard_train_fn
    from repro_torch.models import build
    from repro_torch.optim import adamw
    from repro_torch.runtime.activations import activation_policy
    from repro_torch.runtime.fault import Supervisor
    from repro_torch.runtime.sharding import gather, opt_state_shardings, param_shardings

    cfg = cfg.replace(n_layers=DIST_CKPT["n_layers"])
    train_step = make_train_step(build(cfg), remat=True)
    on_card = dev.type == "cuda"

    def batch_fn(s):
        return _train_batch(torch, make_batch(cfg, cell, dcfg, s), dev)

    def start():
        p = build(cfg).init_params(SEED, device=None if on_card else dev)
        o = adamw.init(p)
        sstep = shard_train_fn(train_step, mesh, p, o, batch_fn(0))

        def step_fn(state, batch):
            with activation_policy(mesh):
                p, o, m = sstep(*state, batch)
            return (p, o), m

        return step_fn, (p, o)

    class Timed(Checkpointer):
        """The Supervisor's checkpointer, timing each save_async: the wait
        for the previous save's writer, then the return (gather, host copy)."""

        def __init__(self, directory):
            super().__init__(directory)
            self.waits, self.returns = [], []

        def save_async(self, step, tree):
            t0 = time.perf_counter()
            self.wait()
            t1 = time.perf_counter()
            super().save_async(step, tree)
            self.waits.append(t1 - t0)
            self.returns.append(time.perf_counter() - t1)

    def local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    t_d = time.perf_counter()
    step_fn, state = start()
    plain = []
    for s in range(DIST_CKPT["steps"]):
        state, m = step_fn(state, batch_fn(s))
        plain.append((float(m["loss"]), float(m["grad_norm"])))
    t_plain = time.perf_counter() - t_d
    want = [local(t).clone() for t in _state_leaves(state)]
    del state, step_fn

    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="dist-ckpt-", dir=ROOT / "build"))
    try:
        failed = []

        def inject(s):
            if s == DIST_CKPT["fail_at"] and not failed:
                failed.append(s)
                raise RuntimeError(f"failure injected at step {s}")

        step_fn, state = start()
        ck = Timed(str(work / "restart"))
        t0 = time.perf_counter()
        state, history = Supervisor(ck, save_every=DIST_CKPT["save_every"]).run(
            step_fn, state, batch_fn, 0, DIST_CKPT["steps"], inject_failure=inject)
        t_run = time.perf_counter() - t0
        steps = [s for s, _ in history]
        require(failed == [DIST_CKPT["fail_at"]] and steps == [0, 1, 2, 2, 3, 4, 5],
                f"(d) the supervised run's steps: {steps} (failed at {failed})")
        got = [(float(m["loss"]), float(m["grad_norm"])) for _, m in history]
        require(got == [plain[s] for s in steps],
                f"(d) the restarted run's losses and grad norms {got} differ from the "
                f"uninterrupted run's {plain}")
        leaves = [local(t) for t in _state_leaves(state)]
        require(len(leaves) == len(want) and all(
            a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(leaves, want)),
            "(d) the restarted run's params or AdamW state differ from the uninterrupted run's")
        last = DIST_CKPT["steps"]
        names = sorted(p.name for p in (work / "restart").iterdir())
        require(names == ["LATEST", "step_2", "step_4", f"step_{last}"] and ck.latest_step()
                == last, f"(d) the checkpoint directory holds {names}")
        size = sum(f.stat().st_size for f in (work / "restart" / f"step_{last}").iterdir())

        # a synchronous save of the sharded state (timed; its barrier ends it)
        sync()
        t0 = time.perf_counter()
        Checkpointer(str(work / "sync")).save(last, state)
        t_save = time.perf_counter() - t0

        # the supervised run's last save against what one process writes
        # from the same values as plain tensors (its host arrays and
        # manifest, held in memory)
        t0 = time.perf_counter()
        arrays, dtypes = _host_flat(gather(state))
        manifest = {"step": last, "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                                              for k, v in arrays.items()}}
        a = work / "restart" / f"step_{last}"
        require(json.loads((a / "manifest.json").read_text()) == manifest,
                "(d) the sharded save's manifest differs from a plain tree's")
        with np.load(a / "host0.npz") as fa:
            require(fa.files == list(arrays), "(d) the sharded save's keys differ")
            bad = [k for k in fa.files if not (fa[k].dtype == arrays[k].dtype
                                               and np.array_equal(fa[k], arrays[k]))]
            n_keys = len(fa.files)
        del arrays
        require(not bad, f"(d) arrays differ from a plain tree's save: {bad[:5]}")
        t_compare = time.perf_counter() - t0

        # restore by the rules' placements
        p_sh = param_shardings(mesh, state[0])
        shardings = (p_sh, opt_state_shardings(mesh, state[1], p_sh))
        t0 = time.perf_counter()
        step, back = ck.restore_latest(state, shardings=shardings)
        sync()
        t_restore = time.perf_counter() - t0
        placed = list(zip(_state_leaves(back), _state_leaves(shardings)))
        require(step == last and all(isinstance(t, DTensor) and tuple(t.placements)
                                     == sh.placements for t, sh in placed),
                f"(d) restore(shardings=) at step {step}: not on the rules' placements")
        require(all(torch.equal(local(t), w) for (t, _), w in zip(placed, want)),
                "(d) the restored state differs from the saved one")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"  [distributed] (d) {cfg.name} (d {cfg.d_model}, vocab {cfg.vocab}, cut to "
        f"{cfg.n_layers} layers; batch {dcfg.global_batch} x {dcfg.seq_len}, remat) through "
        f"shard_train_fn on the {tuple(mesh.shape)} mesh under Supervisor(save_every="
        f"{DIST_CKPT['save_every']}): a failure at step {DIST_CKPT['fail_at']} restored step 2 "
        f"and replayed it; the {DIST_CKPT['steps']} steps equal the uninterrupted run bit for "
        f"bit (losses, grad norms, params, AdamW moments and step); a checkpoint {size / 1e9:.3f} "
        f"GB ({n_keys} keys), equal key by key to one process's save of the same values as "
        f"plain tensors; save_async returned in "
        f"{', '.join(f'{t:.3f}' for t in ck.returns)} s (gather and host copy; before each, "
        f"{', '.join(f'{t:.3f}' for t in ck.waits)} s waiting for the previous writer), a "
        f"synchronous "
        f"save {t_save:.3f} s, restore(shardings=) {t_restore:.3f} s onto the rules' "
        f"placements, equal to the saved state; (d) took {time.perf_counter() - t_d:.1f}s: the "
        f"uninterrupted run {t_plain:.1f}s, the supervised run {t_run:.1f}s, the key-by-key "
        f"comparison (the last save read back against the gathered state's host arrays) "
        f"{t_compare:.1f}s; on {card}")


def distributed_phase(torch, card: str, dev, reduced_cfg: bool = False) -> dict[str, int]:
    """The distributed runtime: (a) OLMo-1B's full train step through
    shard_train_fn on a world of one over NCCL, equal to the unsharded
    step, (b) compressed_psum on the card over that group, bit-exact with
    compress -> decompress on the CPU, (d) checkpoint/restart around the
    sharded step on that mesh, (c) 4 spawned ranks on the card over
    gloo."""
    import gc
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.configs import ShapeCell, get_config, reduced
    from repro_torch.convert import tree_leaves, tree_map
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch.mesh import make_host_mesh, spawn
    from repro_torch.launch.train import make_train_step, shard_train_fn
    from repro_torch.models import build
    from repro_torch.optim import adamw
    from repro_torch.optim.compression import BLOCK, compress, compressed_psum, decompress
    from repro_torch.runtime.activations import activation_policy
    from repro_torch.runtime.sharding import opt_state_shardings, param_shardings

    on_card = dev.type == "cuda"
    wrappers = kernels.wrappers()
    launches = dict.fromkeys(wrappers, 0)
    _counts_zero(wrappers)
    t_phase = time.perf_counter()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        torch.cuda.empty_cache()
    # (a) a world of one: make_host_mesh starts it (NCCL on the card)
    require(not dist.is_initialized(), "a process group is already initialised")
    mesh = make_host_mesh(device=dev.type)
    require(tuple(mesh.shape) == (1, 1) and dist.get_world_size() == 1,
            f"make_host_mesh(): {tuple(mesh.shape)} over {dist.get_world_size()} rank(s)")
    backend = dist.get_backend()
    try:
        cfg = get_config(DIST["arch"])
        cfg = reduced(cfg) if reduced_cfg else cfg
        api = build(cfg)
        dcfg = DataConfig(vocab=cfg.vocab, global_batch=DIST["batch"], seq_len=DIST["seq"])
        cell = ShapeCell("train", DIST["seq"], DIST["batch"], "train")
        batches = [_train_batch(torch, make_batch(cfg, cell, dcfg, s), dev)
                   for s in range(DIST["steps"])]
        step = make_train_step(api, remat=True)
        params = api.init_params(SEED, device=None if on_card else dev)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        want, t_plain, p_plain, o_plain = _olmo_steps_on(torch, api, params, batches, step, sync)
        peak_plain = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
        p_plain = tree_map(lambda t: t.cpu(), p_plain)
        # the unsharded run's state freed before the sharded run's peak is
        # read: its AdamW moments (9.42 GB) would count in it
        del params, o_plain
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        params = api.init_params(SEED, device=None if on_card else dev)
        sstep = shard_train_fn(step, mesh, params, adamw.init(params), batches[0])

        def run(p, o, b):
            with activation_policy(mesh):
                return sstep(p, o, b)

        got, t_shard, p_shard, o_shard = _olmo_steps_on(torch, api, params, batches, run, sync)
        peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
        p_sh = param_shardings(mesh, p_shard)
        misplaced = [i for i, (t, s) in enumerate(zip(
            _state_leaves((p_shard, o_shard)),
            _state_leaves((p_sh, opt_state_shardings(mesh, o_shard, p_sh)))))
            if tuple(t.placements) != s.placements]
        require(not misplaced, f"(a): {len(misplaced)} leaves off the rules' placements")
        leaves = [t.to_local().cpu() for t in tree_leaves(p_shard)]
        diff = [(a - b).abs() for a, b in zip(leaves, tree_leaves(p_plain))]
        worst = max(float(d.max()) for d in diff)
        n = sum(d.numel() for d in diff)
        share = sum(int((d > TRAIN_TIGHT).sum()) for d in diff) / n
        exact = got == want and worst == 0.0
        if on_card:
            require(abs(peak - peak_plain) <= DIST_PEAK_RTOL * peak_plain,
                    f"(a) torch.cuda.max_memory_allocated sharded {peak:.2f} GB vs unsharded "
                    f"{peak_plain:.2f} GB: beyond {DIST_PEAK_RTOL:.0%}")
        if not exact:  # hold it to [train]'s tolerances, and say by how much
            _compare_steps(torch, (got, leaves), (want, list(tree_leaves(p_plain))), False,
                           "(a) sharded vs unsharded")
        med_plain, med_shard = statistics.median(t_plain[1:]), statistics.median(t_shard[1:])
        log(f"  [distributed] (a) {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}; batch "
            f"{DIST['batch']} x {DIST['seq']}, remat) through shard_train_fn on a "
            f"{tuple(mesh.shape)} {backend} mesh (world of one), under activation_policy: "
            f"losses {[round(m[0], 6) for m in got]}, grad norms "
            f"{[round(m[1], 6) for m in got]}; "
            + ("bit-exact with the unsharded step (losses, grad norms, every param)"
               if exact else f"vs the unsharded step: params max |diff| {worst:.3e}, "
               f"{share:.3e} of {n} beyond {TRAIN_TIGHT}")
            + f"; every param and AdamW leaf on the rules' placements; step ms sharded: "
            f"first {t_shard[0]:.3f}, then {', '.join(f'{t:.3f}' for t in t_shard[1:])} "
            f"(median {med_shard:.3f}); unsharded: first {t_plain[0]:.3f}, then "
            f"{', '.join(f'{t:.3f}' for t in t_plain[1:])} (median {med_plain:.3f}); DTensor "
            f"costs {med_shard - med_plain:.3f} ms a step ({med_shard / med_plain:.2f}x); "
            f"torch.cuda.max_memory_allocated sharded {peak:.2f} GB, unsharded "
            f"{peak_plain:.2f} GB; on {card}")
        del params, p_shard, o_shard, p_plain, sstep, batches
        _take(wrappers, launches, dev, {}, "(a) shard_train_fn")

        # (b) compressed_psum over the world of one against the CPU's grid
        gen = torch.Generator().manual_seed(SEED)
        g = torch.randn(DIST_PSUM, generator=gen) * 0.01
        err = torch.randn(DIST_PSUM, generator=gen) * 1e-4
        out, new_err = compressed_psum(g.to(dev), err.to(dev), dist.group.WORLD)
        q, scale, want_err = compress(g, err)
        want_out = decompress(q, scale, g.shape, (-g.numel()) % BLOCK)
        require(torch.equal(out.cpu(), want_out) and torch.equal(new_err.cpu(), want_err),
                "(b) compressed_psum on the card differs from compress -> decompress")
        log(f"  [distributed] (b) compressed_psum {tuple(g.shape)} on {out.device} over the "
            f"{backend} world of one: bit-exact with compress -> decompress on the CPU "
            f"(output and error feedback); on {card}")
        _take(wrappers, launches, dev, {}, "(b) compressed_psum")

        # (d) checkpoint/restart around the sharded step
        _dist_checkpoint(torch, card, dev, mesh, cfg, dcfg, cell, sync)
        _take(wrappers, launches, dev, {}, "(d) sharded checkpoint/restart")
    finally:
        dist.destroy_process_group()
        if on_card:
            # whatever earlier phases left in reference cycles goes before
            # (c)'s ranks take the card (the sharded steps leave none:
            # tests/test_torch_distributed.py holds that on the CPU)
            gc.collect()
            torch.cuda.empty_cache()

    # (c) 4 ranks sharing the card over gloo
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="dist-", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        spawn(_dist_rank, DIST_SPAWN["world"], str(work), dev.type,
              timeout=DIST_SPAWN["timeout"], workdir=work)
        t_spawn = time.perf_counter() - t0
        ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
                 for r in range(DIST_SPAWN["world"])]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for r, res in enumerate(ranks):
        require(not any(res["launches"].values()), f"(c) rank {r} launched {res['launches']}")
    ps = [res["psum"] for res in ranks]
    require(all(p["exact"] and p["device"].startswith(dev.type) for p in ps),
            f"(c) compressed_psum on {dev.type} tensors differs from the CPU's: {ps}")
    log(f"  [distributed] (c) compressed_psum {DIST_PSUM} over {DIST_SPAWN['world']} gloo ranks "
        f"on {ps[0]['device']} tensors: bit-exact with the same ranks on CPU tensors (output "
        f"and error feedback, every rank); int8 grid error {ps[0]['rel']:.2e} of the largest "
        f"sum; {max(p['ms'] for p in ps):.3f} ms (host clock, first call); on {card}")
    pl = [res["pipeline"] for res in ranks]
    worst = max(p["err"] for p in pl)
    require(all(p["device"].startswith(dev.type) for p in pl) and worst < 1e-5,
            f"(c) pipelined_apply vs the layers in turn: {pl}")
    log(f"  [distributed] (c) pipelined_apply, 4 stages of a {DIST_SPAWN['pipe_d']}-wide tanh "
        f"layer, batch {DIST_SPAWN['pipe_batch']} in 4 microbatches, over {DIST_SPAWN['world']} "
        f"gloo ranks on {pl[0]['device']} tensors (sends staged through the host): max |diff| "
        f"{worst:.2e} against the layers in turn on the card, every rank; "
        f"{max(p['ms'] for p in pl):.3f} ms (host clock, first call); the ranks in "
        f"{t_spawn:.1f}s; no kernel of ours launched; on {card}")
    log(f"  [distributed] phase took {time.perf_counter() - t_phase:.1f}s on {card}")
    return launches


#: [multipod] (i): multi-pod dry-run cells, each ``python -m
#: repro_torch.launch.dryrun --arch A --shape S [--multi-pod on]`` in a fake
#: world of its own on the card's device type: each group of open fault 1
#: (dense, MoE, SSM, and the VLM in MULTIPOD_EARLY), GQA heads over 16
#: model ranks (llava 56/8, granite 24/8), the int8 products on DTensors
#: (OLMo-1B prefill and decode), the sequence-sharded cache (zamba2
#: long_500k) and one cell of the two-pod mesh; run MULTIPOD_JOBS at a time
MULTIPOD_CELLS = [("olmo-1b", "train_4k", False), ("qwen2-moe-a2.7b", "train_4k", False),
                  ("mamba2-370m", "train_4k", False),
                  ("granite-moe-3b-a800m", "train_4k", False), ("olmo-1b", "prefill_32k", False),
                  ("olmo-1b", "decode_32k", False), ("mamba2-370m", "decode_32k", True)]
MULTIPOD_JOBS = 8
#: the costliest cells (zamba2 long_500k, 4-5 min of host time: 1024 KV
#: blocks at each of 9 sites; llava train_4k, 2-3.5 min) start as the
#: script does, at the lowest CPU priority, each in a child of its own
#: (host work only: their tensors are fake), and [multipod] collects their
#: records
MULTIPOD_EARLY = [("zamba2-2.7b", "long_500k", False), ("llava-next-34b", "train_4k", False)]
MULTIPOD_DIR = ROOT / "build" / "multipod"
#: [multipod] (i): GSPMD's temp bytes a rank for the train cells it runs,
#: XLA's memory_analysis of the reference's own cell on 256 forced host
#: devices (JAX 0.9 on a CPU): ``PYTHONPATH=src python tests/xla_memory.py
#: --arch olmo-1b qwen2-moe-a2.7b mamba2-370m granite-moe-3b-a800m
#: llava-next-34b --shape train_4k``; the port's temp a rank must stay
#: within MULTIPOD_XLA_RATIO of it
MULTIPOD_XLA_TEMP = {"olmo-1b": 7438979200, "qwen2-moe-a2.7b": 8409938120,
                     "mamba2-370m": 32890216456, "granite-moe-3b-a800m": 8909305408,
                     "llava-next-34b": 10624594776}
MULTIPOD_XLA_RATIO = 1.5


def start_early_cells(dev_type: str) -> list:
    """``MULTIPOD_EARLY``'s CLI children, niced, as ``(cell, child)``;
    [multipod] waits for them, and they are stopped at exit if the script
    ends first."""
    import atexit
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    children = [(cell, subprocess.Popen(
        ["nice", "-n", "19", sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cell[0], "--shape", cell[1], "--multi-pod", "on" if cell[2] else "off", "--out-dir",
         str(MULTIPOD_DIR), "--device", dev_type],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
        for cell in MULTIPOD_EARLY]

    def stop():
        for _, child in children:
            if child.poll() is None:
                child.kill()
                child.wait()

    atexit.register(stop)
    return children


#: [multipod] (ii): [distributed] (a)'s step (OLMo-1B, float32, 4 x 128,
#: remat) on a 1x1 mesh, recorded by deploy.hlo_analysis once in a fake
#: world of one (a child process) and once for real on the card; the
#: real step's peak allocation over the predicted one must fall in this
#: range (PERF.md section 6 holds the prediction)
MULTIPOD_PEAK_RATIO = (0.95, 1.10)


def _tie_step(torch, dev_type: str, fake: bool) -> dict:
    """[distributed] (a)'s step on a 1x1 mesh of the running world, its
    arguments placed first, one call recorded: the analysis, the argument
    bytes and (for real) the device's peak allocation.  Garbage is
    collected before the allocation is read: reference cycles left by
    earlier phases hold device tensors, and a collection inside the step
    would free them and pull its reading below the step's own peak."""
    import contextlib
    import gc

    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.deploy.hlo_analysis import OpRecorder, analyze_hlo
    from repro_torch.launch.dryrun import fake_mode, place
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import make_train_step, shard_train_fn
    from repro_torch.models import build
    from repro_torch.optim import adamw
    from repro_torch.runtime.activations import activation_policy
    from repro_torch.runtime.sharding import batch_shardings, opt_state_shardings, param_shardings

    cfg = get_config(DIST["arch"])
    api = build(cfg)
    mesh = make_mesh((1, 1), ("data", "model"), device=dev_type)
    cell = ShapeCell("train", DIST["seq"], DIST["batch"], "train")
    dcfg = DataConfig(vocab=cfg.vocab, global_batch=DIST["batch"], seq_len=DIST["seq"])
    host = make_batch(cfg, cell, dcfg, 0)
    with fake_mode() if fake else contextlib.nullcontext():
        params = api.init_params(SEED, device=dev_type)
        opt = adamw.init(params)
        batch = {k: torch.from_numpy(v).to(dev_type) for k, v in host.items()}
        p_sh = param_shardings(mesh, params)
        params = place(params, p_sh)
        opt = place(opt, opt_state_shardings(mesh, opt, p_sh))
        batch = place(batch, batch_shardings(mesh, batch))
        step = shard_train_fn(make_train_step(api, remat=True), mesh, params, opt, batch)
        on_card = not fake and dev_type == "cuda"
        if on_card:
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
        ops = OpRecorder(dev_type)
        arg_bytes = ops.track((params, opt, batch))
        with activation_policy(mesh), ops:
            step(params, opt, batch)
        res = analyze_hlo(ops)
        res["argument_bytes"] = arg_bytes
        if on_card:
            torch.cuda.synchronize()
            res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
            res["allocated_before"] = before
    return res


def _tie_child(dev_type: str) -> None:
    """The fake side of [multipod] (ii), in a process of its own (one
    process holds one world): prints its analysis as JSON."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import init_fake_world

    init_fake_world(1)
    print("TIE_JSON " + json.dumps(_tie_step(torch, dev_type, fake=True)))


def multipod_phase(torch, card: str, dev, early=()) -> dict[str, int]:
    """The multi-pod dry run: (i) cells of the reference's grid through
    the CLI in fake 256 / 512-rank worlds, each ``ok``; (ii) the analysis
    of [distributed] (a)'s step in a fake world of one equal, op for op,
    to the same step recorded for real on the card, and its predicted peak
    beside the card's."""
    import os

    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.launch.dryrun import run_grid
    from repro_torch.launch.mesh import make_host_mesh

    import threading

    wrappers = kernels.wrappers()
    launches = dict.fromkeys(wrappers, 0)
    _counts_zero(wrappers)
    t_phase = time.perf_counter()

    # (i) the cells, MULTIPOD_JOBS at a time, each in a child of its own,
    # while (ii) runs here
    grid: dict = {}

    def cells():
        t0 = time.perf_counter()
        try:
            grid["recs"] = run_grid(MULTIPOD_CELLS, out_dir=str(MULTIPOD_DIR), device=dev.type,
                                    jobs=MULTIPOD_JOBS)
        except Exception as e:  # noqa: BLE001 — reported below, as a failed phase
            grid["error"] = e
        grid["wall"] = time.perf_counter() - t0

    runner = threading.Thread(target=cells)
    runner.start()

    try:
        # (ii) the fake world of one in a child, the real world of one here
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        child = subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke._tie_child({dev.type!r})"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            require(not dist.is_initialized(), "a process group is already initialised")
            make_host_mesh(device=dev.type)
            try:
                real = _tie_step(torch, dev.type, fake=False)
            finally:
                dist.destroy_process_group()
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            out, err = child.communicate(timeout=600)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        line = [ln for ln in out.splitlines() if ln.startswith("TIE_JSON ")]
        require(child.returncode == 0 and bool(line),
                f"(ii) the fake world's step failed: {err[-2000:]}")
        fake = json.loads(line[0][len("TIE_JSON "):])
        diff = {k: (fake["op_counts"].get(k), real["op_counts"].get(k))
                for k in set(fake["op_counts"]) | set(real["op_counts"])
                if fake["op_counts"].get(k) != real["op_counts"].get(k)}
        require(fake["flops"] == real["flops"] and not diff,
                f"(ii) fake vs real: flops {fake['flops']} vs {real['flops']}; op counts that "
                f"differ (fake, real): {diff}")
        require(fake["argument_bytes"] == real["argument_bytes"],
                f"(ii) argument bytes {fake['argument_bytes']} vs {real['argument_bytes']}")
        peak = "not measured (no card)"
        if dev.type == "cuda":
            others = real["allocated_before"] - real["argument_bytes"]
            ratio = (real["max_memory_allocated"] - others) / fake["peak_bytes"]
            require(MULTIPOD_PEAK_RATIO[0] <= ratio <= MULTIPOD_PEAK_RATIO[1],
                    f"(ii) the card's peak over the predicted one: {ratio:.4f}")
            peak = (f"max_memory_allocated {real['max_memory_allocated'] / 1e9:.3f} GB of "
                    f"which {others / 1e9:.3f} GB were not the step's (allocated before it): "
                    f"ratio {ratio:.4f} (predicted {MULTIPOD_PEAK_RATIO[0]}-"
                    f"{MULTIPOD_PEAK_RATIO[1]})")
        log(f"  [multipod] (ii) {DIST['arch']} step ({DIST['batch']} x {DIST['seq']}, float32, "
            f"remat) on a 1x1 mesh: a fake world of one and the {dev.type} agree op for op: "
            f"{real['n_computations']} local ops of {len(real['op_counts'])} kinds, "
            f"{real['flops']:.6e} flops, {fake['mem_bytes']:.6e} result bytes; peak predicted "
            f"{fake['peak_bytes'] / 1e9:.3f} GB (arguments {fake['argument_bytes'] / 1e9:.3f}), "
            f"{peak}; on {card}")
    finally:
        runner.join()  # every child of (i) ends before the phase does
    require("error" not in grid, f"(i) the cells' runner failed: {grid.get('error')!r}")
    recs, wall = grid["recs"], grid["wall"]
    for (arch, shape, pod), child in early:  # MULTIPOD_EARLY, started with the script
        t0 = time.perf_counter()
        _, err = child.communicate(timeout=900)
        path = MULTIPOD_DIR / f"{arch}__{shape}__{'2x16x16' if pod else '16x16'}.json"
        require(child.returncode in (0, 1) and path.exists(),
                f"(i) {arch} {shape}: the cell's process exited {child.returncode}: {err[-1500:]}")
        recs.append(json.loads(path.read_text()))
        log(f"  [multipod] (i) {arch} {shape} started with the script (nice 19); waited "
            f"{time.perf_counter() - t0:.1f}s for it here")
    for r in recs:
        require(r["status"] == "ok", f"(i) {r['arch']} {r['shape']} {r['mesh']}: "
                f"{r.get('error', r.get('reason', ''))[:1500]}")
        c = r["collectives"]
        xla = ""
        if r["kind"] == "train" and r["mesh"] == "16x16":
            ratio = r["temp_size_in_bytes"] / MULTIPOD_XLA_TEMP[r["arch"]]
            require(ratio <= MULTIPOD_XLA_RATIO,
                    f"(i) {r['arch']} {r['shape']}: temp a rank "
                    f"{r['temp_size_in_bytes'] / 1e9:.3f} GB is {ratio:.3f}x XLA's "
                    f"{MULTIPOD_XLA_TEMP[r['arch']] / 1e9:.3f} GB (bound {MULTIPOD_XLA_RATIO})")
            xla = (f" ({ratio:.3f}x XLA's {MULTIPOD_XLA_TEMP[r['arch']] / 1e9:.3f} GB, "
                   f"tests/xla_memory.py; bound {MULTIPOD_XLA_RATIO})")
        log(f"  [multipod] (i) {r['arch']} {r['shape']} {r['mesh']}: {r['flops']:.4e} flops a "
            f"rank, collective bytes {json.dumps(c['bytes_by_op'])} ({c['total_bytes']:.4e} "
            f"in {sum(c['op_counts'].values())} ops), arguments "
            f"{r['argument_size_in_bytes'] / 1e9:.3f} GB, temp "
            f"{r['temp_size_in_bytes'] / 1e9:.3f} GB a rank{xla}, largest storage "
            f"{r['largest_bytes'] / 1e9:.3f} GB; host s: build {r['lower_s']}, "
            f"step {r['compile_s']}")
    log(f"  [multipod] (i) {len(recs)} cells ok; {len(MULTIPOD_CELLS)} in {wall:.1f}s "
        f"({MULTIPOD_JOBS} at a time); "
        f"(ii) and (i) took {time.perf_counter() - t_phase:.1f}s on {card}")
    _take(wrappers, launches, dev, {}, "[multipod]")
    return launches


def _state_leaves(tree):
    """Every tensor of a tree of dicts, lists and tuples (NamedTuples
    included), in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _state_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _state_leaves(v)
    else:
        yield tree


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

    early = start_early_cells("cuda")
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
    phase("[ptq] float -> calibrate -> quantize -> the integer path: MobileBERT calibrated "
          "on the card vs the CPU, OLMo-1B's float chain and its float-bound ita session")
    for name, n in ptq_phase(torch, card, dev).items():
        launches[name] += n
    phase("[dryrun] python -m repro_torch.launch.dryrun --via-plan in-process: MobileBERT "
          "(ita; head-by-head w8a8) and OLMo-1B (ita, 128 + 16 tokens), batch 8")
    for name, n in dryrun_phase(torch, card, dev).items():
        launches[name] += n
    phase("[families] StableLM-1.6B through the plan pair (ita vs w8a8 vs the model chain), "
          "Qwen1.5-110B and Mistral-Large-123B as plans, and MoE, Mamba2, Zamba2, "
          "SeamlessM4T and LLaVA-NeXT at full width (prefill + 16 decode steps), card vs CPU")
    for name, n in families_phase(torch, card, dev).items():
        launches[name] += n
    phase("[train] training on one card: OLMo-1B at full width and depth through "
          "launch.train (timed, traced), the card vs the CPU, a supervised restart, the "
          "tinylm example and one step of every arch")
    for name, n in train_phase(torch, card, dev).items():
        launches[name] += n
    phase("[distributed] the distributed runtime: OLMo-1B's full train step through "
          "shard_train_fn on a 1x1 NCCL mesh vs the unsharded step, compressed_psum on the "
          "card, a supervised restart of the sharded step, and 4 gloo ranks sharing the card")
    for name, n in distributed_phase(torch, card, dev).items():
        launches[name] += n
    phase("[multipod] the multi-pod dry run: cells of the reference's grid in fake 256 / "
          "512-rank worlds, and [distributed] (a)'s step analysed in a fake world of one "
          "against the same step on the card")
    for name, n in multipod_phase(torch, card, dev, early).items():
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
