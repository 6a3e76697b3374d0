#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (any exception ends the run with a non-zero
exit code and no result line):

1. card   — the device's name and power limit from nvidia-smi;
2. build  — nvcc builds every kernel of the main path from src/repro_torch/csrc;
3. kernels — each kernel, launched on the card at the shapes the main path
   gives it (plus ragged, multi-block, padded, GQA and causal cases), must
   equal its plain PyTorch version run on CPU copies of the same inputs
   (integer-exact: tolerance zero); then it is timed on the device (CUDA
   graph replays between CUDA events) and per call with its dispatch;
4. slice  — compile(cfg, backend="ita") -> session(8) -> forward for
   MobileBERT, Whisper-tiny-encoder and DINOv2-small at their full configs
   (random weights from seed 0): the launch counters must grow by exactly
   the plan's kernel calls, and the output must equal, bit for bit, the
   same session's forward on the CPU.

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


def host_ms(fn, reps: int = 3) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_abs_err(got, want) -> float:
    """Largest |card - plain| over one comparison (0 when integer-exact)."""
    return float((got.cpu().to(want.dtype).int() - want.int()).abs().max())


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

#: (M, K, N, act) of every int8_gemm call on the three encoders' paths at
#: batch 8 (M padded to the 128-row granule), plus a ragged case
def gemm_cases():
    from repro_torch.core.quant_linear import ACT_GELU, ACT_IDENTITY, ACT_RELU

    mb = [(1024, 128, 256, ACT_IDENTITY), (1024, 256, 128, ACT_IDENTITY),
          (1024, 128, 512, ACT_GELU), (1024, 512, 128, ACT_IDENTITY)]
    wide = [(384, 384, ACT_IDENTITY), (384, 1536, ACT_GELU), (1536, 384, ACT_IDENTITY)]
    cases = [("mobilebert", *c) for c in mb]
    cases += [("whisper-tiny-encoder", 4096, k, n, a) for k, n, a in wide]
    cases += [("dinov2-small", 2048, k, n, a) for k, n, a in wide]
    cases += [("ragged", 1000, 200, 300, ACT_RELU)]
    return cases


#: (label, B, H, Hkv, S, D, kv_valid, causal) of the ita_attention checks
ATTN_CASES = [
    ("mobilebert", 8, 4, 4, 128, 64, None, False),
    ("whisper-tiny-encoder", 8, 6, 6, 512, 64, None, False),
    ("dinov2-small", 8, 6, 6, 256, 64, 241, False),
    ("gqa-group2", 8, 6, 3, 256, 64, None, False),
    ("causal", 8, 4, 4, 256, 64, None, True),
]

S_GEMM = dict(s_in=0.05, s_w=0.01, s_out=0.05, s_preact=0.05)
S_ATTN = dict(s_q=0.05, s_k=0.05, s_v=0.05, s_out=0.05)


def gemm_bytes_ops(m, k, n):
    return m * k + k * n + 3 * 4 * n + m * n, 2 * m * n * k


def attn_bytes_ops(bh, bhkv, s, d, kv_valid, causal):
    """q, k, v read once, out written once, the two LUTs; int8 ops of
    Q K^T and P V over the (query, key) pairs this run's masks keep."""
    n_bytes = 2 * bh * s * d + 2 * bhkv * s * d + 64 * 4
    keys = s if kv_valid is None else kv_valid
    pairs = s * (s + 1) // 2 if causal else s * keys
    return n_bytes, 2 * 2 * bh * pairs * d


def kernel_phase(torch, gen) -> list[dict]:
    from repro_torch.kernels.int8_gemm import int8_gemm
    from repro_torch.kernels.ita_attention import ita_attention

    dev = torch.device("cuda")

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
        log(f"  int8_gemm {label:22s} M={m:5d} K={k:5d} N={n:5d} act={act}: equal; "
            f"device {ms:.4f} ms (per call with dispatch {per_call:.4f} ms), _int_mm "
            f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound {bnd:.5f} ms ({by})")
        if label == "mobilebert":
            reps = 3 if (k, n) == (128, 256) else 1  # Q, K and V share a shape
            mb_layer += [(x, w, bias, kw)] * reps

    # -- int8_gemm timings over one MobileBERT layer's six launches
    xs = [(x.to(dev), w.to(dev), b.to(dev), kw) for x, w, b, kw in mb_layer]
    gemm_ms = device_ms(lambda: [int8_gemm(*a[:3], **a[3]) for a in xs])
    gemm_plain = host_ms(lambda: [int8_gemm(*a[:3], **a[3]) for a in mb_layer])
    ints = [(x.to(dev), w.to(dev)) for x, w, _, _ in mb_layer]
    lib_ms = device_ms(lambda: [torch._int_mm(x, w) for x, w in ints])
    g_bytes = g_ops = 0
    for x, w, _, _ in mb_layer:
        b_, o_ = gemm_bytes_ops(x.shape[0], x.shape[1], w.shape[1])
        g_bytes, g_ops = g_bytes + b_, g_ops + o_
    g_bound, g_by = bound_ms(g_bytes, g_ops)

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
        log(f"  ita_attention {label:22s} BH={b * h:3d} S={s:4d} D={d} kv_valid={kv_valid} "
            f"causal={causal} group={h // hkv}: equal; device {ms:.4f} ms (per call with "
            f"dispatch {per_call:.4f} ms), bound {bnd:.5f} ms ({by})")
        if label == "mobilebert":
            attn_mb = (q, k, v, kw)

    q, k, v, kw = attn_mb
    qd, kd, vd = q.to(dev), k.to(dev), v.to(dev)
    attn_ms = device_ms(lambda: ita_attention(qd, kd, vd, **kw))
    attn_plain = host_ms(lambda: ita_attention(q, k, v, **kw))
    bh, s, d = q.shape[0] * q.shape[1], q.shape[2], q.shape[3]
    a_bound, a_by = bound_ms(*attn_bytes_ops(bh, bh, s, d, None, False))

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
         "work": "one MobileBERT layer at batch 8: BH=32, S=128, D=64, block_k=128"},
    ]


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------

#: (arch, forwards, int8_gemm and ita_attention launches per forward): per
#: layer the MHA node runs 4 GEMMs (Q, K, V, O) and one attention, the MLP 2
SLICE = [("mobilebert", 3, 144, 24), ("whisper-tiny-encoder", 2, 24, 4),
         ("dinov2-small", 2, 72, 12)]


def slice_phase(torch, card: str) -> dict[str, int]:
    from repro_torch.configs import get_config
    from repro_torch.deploy import api
    from repro_torch.kernels.int8_gemm import int8_gemm
    from repro_torch.kernels.ita_attention import ita_attention
    from repro_torch.launch.serve import make_requests

    launches = {"int8_gemm": 0, "ita_attention": 0}
    for arch, steps, n_gemm, n_attn in SLICE:
        cfg = get_config(arch)
        model = api.compile(cfg, backend="ita", use_cache=False)
        plan = model.artifact
        n_mha = sum(n.kind == "mha" and n.engine == "ita" for n in plan.nodes)
        n_mm = sum(n.kind == "gemm" and n.engine == "ita" for n in plan.nodes)
        require((n_mm + 4 * n_mha, n_mha) == (n_gemm, n_attn),
                f"{arch}: plan holds {n_mm} GEMM and {n_mha} MHA accelerator nodes")
        session = model.session(BATCH, seed=SEED)  # the card, by default
        require(session.device.type == "cuda", "session did not default to the card")
        reqs = make_requests(cfg, plan, BATCH, steps, SEED)
        dev_reqs = [r.to(session.device) for r in reqs]
        session.forward(dev_reqs[0])  # warm-up
        torch.cuda.synchronize()

        int8_gemm.launches = 0
        ita_attention.launches = 0
        t0 = time.perf_counter()
        outs = [session.forward(r) for r in dev_reqs]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got_g, got_a = int8_gemm.launches, ita_attention.launches
        launches["int8_gemm"] += got_g
        launches["ita_attention"] += got_a
        require(got_g == steps * n_gemm and got_a == steps * n_attn,
                f"{arch}: launches int8_gemm {got_g} ita_attention {got_a}, expected "
                f"{steps * n_gemm} and {steps * n_attn}")

        out = outs[0]
        want_shape = (BATCH, plan.seq_len, cfg.vocab if cfg.vocab else cfg.d_model)
        require(tuple(out.shape) == want_shape, f"{arch}: output {tuple(out.shape)}")
        require(bool(torch.isfinite(out).all()), f"{arch}: non-finite output")
        cpu = model.session(BATCH, seed=SEED, device="cpu")
        want = cpu.forward(reqs[0])
        require(torch.equal(out.cpu(), want), f"{arch}: card forward != CPU forward")
        inf_s = steps * BATCH / dt
        log(f"  {arch}: {plan.counts()['nodes']} plan nodes; {got_g // steps} int8_gemm + "
            f"{got_a // steps} ita_attention launches per forward; output {want_shape} "
            f"equals the CPU forward bit for bit; {steps} forwards of {BATCH}x{plan.seq_len} "
            f"in {dt:.4f}s: {inf_s:.1f} inf/s, {inf_s * plan.seq_len:.0f} tok/s on {card}")
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
    names = ("int8_gemm", "ita_attention")
    _build.build(*names)
    log(f"[build] {', '.join(names)} in {time.perf_counter() - t0:.1f}s "
        f"(into {_build.build_dir()})")
    for name in names:
        for line in _build.compile_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    gen = torch.Generator().manual_seed(SEED)
    log("[kernels] each kernel against its plain version (exact)")
    kernels = kernel_phase(torch, gen)
    for k in kernels:
        log(f"  {k['name']}: {k['ms']:.4f} ms on the card, plain {k['plain_ms']:.2f} ms on the "
            f"host CPU, bound {k['bound_ms']:.5f} ms ({k['bound_by']}), library "
            f"{k['library_ms']} ms; {k['work']}")

    log("[slice] compile -> session(8) -> forward on the card, vs the CPU forward")
    launches = slice_phase(torch, card)
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
