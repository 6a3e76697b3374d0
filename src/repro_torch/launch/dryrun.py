"""Plan-backed dry run of the port: the paper's deployment flow, executed and checked.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mobilebert --reduced --via-plan --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --reduced --via-plan --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mobilebert --via-plan --backend ita --batch 8

compiles the config through the unified API (``repro_torch.deploy.api.compile``
with its on-disk plan cache -> ``CompiledModel.session``) into its
deployment artifact — an encoder ``DeploymentPlan``, or a decoder
prefill/decode plan pair sharing a static KV region — executes it through
the ``InferenceSession`` (dispatch via the runtime dispatch table), and
checks bit-exactness against the model-level ``forward_w8a8`` (encoder;
with the plan's schedule, and flash attention where the plan runs its MHA
on the attention kernel) or ``prefill_w8a8`` + chained
``decode_step_w8a8`` (decoder) on the same quantized params.  The
model-level head-by-head schedule attends rowwise head by head, so a
head-by-head plan whose heads run on the attention kernel (``ita`` at
full width) has no model-level twin and reports a mismatch, in both
packages.  It prints the JAX package's ``[plan   ]`` and ``[ok
]`` / ``[MISMATCH]`` lines, writes its JSON record and the saved plan (or
pair) under ``--out-dir``, and exits 0 only when the run is bit-exact.
It runs on the card unless ``--device cpu``.  Inputs are drawn from a
``numpy.random.Generator`` seeded with 0 (the JAX package draws them from
``jax.random``; the records do not hold them).

The JAX package's dry run also lowers and compiles multi-pod cells
against TPU meshes (``run_cell``); the port has no counterpart of that
half yet, so ``main`` without ``--via-plan`` exits non-zero saying so.
The names that half is built from (the production mesh, the sharding
rules, the activation policy, the cells) are imported here already.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs import (  # noqa: F401
    ALL_SHAPES,
    get_config,
    list_archs,
    reduced,
    shape_applicable,
)
from repro_torch.convert import to_device
from repro_torch.deploy import api
from repro_torch.launch.mesh import make_production_mesh  # noqa: F401
from repro_torch.models import build, input_specs  # noqa: F401
from repro_torch.runtime.activations import activation_policy  # noqa: F401
from repro_torch.runtime.sharding import (  # noqa: F401
    batch_shardings,
    cache_shardings,
    opt_state_shardings,
    param_shardings,
)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_decoder_via_plan(model: api.CompiledModel, *, batch_size: int, gen_steps: int,
                         out_dir: str, device=None, seed: int = 0) -> int:
    """CompiledModel -> InferenceSession -> prefill + batched decode; the
    whole trajectory checked bit for bit against ``prefill_w8a8`` /
    ``decode_step_w8a8`` (logits and KV cache at every step)."""
    from repro_torch.models import transformer as T

    cfg, pair = model.cfg, model.artifact
    arch, max_len = cfg.name, pair.max_len
    s = pair.seq_len
    counts = pair.counts()
    print(
        f"[plan   ] {arch}: prefill {counts['prefill']['nodes']} nodes "
        f"({counts['prefill']['ita']} ita), decode {counts['decode']['nodes']} "
        f"nodes ({counts['decode']['ita']} ita), KV region "
        f"{len(pair.kv_tensors)} tensors x {max_len} tokens, "
        f"plan cache {'hit' if model.cache_hit else 'miss'}"
    )

    session = model.session(batch_size, device=device, seed=seed)
    dev = session.device
    qp = to_device(session.qp, dev)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (batch_size, s), dtype=np.int32)).to(dev)

    def same_state(ref_cache) -> bool:
        kv = session.kv_cache
        return torch.equal(kv["k"], ref_cache["k"]) and torch.equal(kv["v"], ref_cache["v"])

    t0 = time.perf_counter()
    logits = session.prefill(tokens)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    ref_logits, ref_cache = T.prefill_w8a8(cfg, qp, {"tokens": tokens}, max_len)
    exact = torch.equal(logits, ref_logits) and same_state(ref_cache)
    tok = torch.argmax(ref_logits[:, -1:], dim=-1).to(torch.int32)
    t0 = time.perf_counter()
    for _ in range(gen_steps):
        logits = session.decode(tok)
        ref_logits, ref_cache = T.decode_step_w8a8(cfg, qp, ref_cache, tok)
        exact = exact and torch.equal(logits, ref_logits) and same_state(ref_cache)
        tok = torch.argmax(ref_logits[:, -1:], dim=-1).to(torch.int32)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    be = model.backend
    status = "ok" if exact else "MISMATCH"
    print(
        f"[{status:7s}] decoder plan pair [{be.value}] vs prefill_w8a8 + "
        f"{gen_steps} x decode_step_w8a8: bit-exact={exact}; "
        f"prefill {batch_size}x{s} in {t_prefill:.2f}s (compile incl.), "
        f"decode {t_decode:.3f}s on {dev.type}"
    )
    os.makedirs(out_dir, exist_ok=True)
    rec = {
        "arch": arch, "backend": be.value,
        "status": "ok" if exact else "mismatch", "bit_exact": exact,
        "plan": counts, "max_len": max_len, "gen_steps": gen_steps,
        "memory_peak": {"prefill": pair.prefill.memory_peak,
                        "decode": pair.decode.memory_peak},
        "cache_hit": model.cache_hit,
        "fingerprint": model.fingerprint,
        "compiler_version": model.compiler_version,
    }
    with open(os.path.join(out_dir, f"{arch}__via_plan_decoder__{be.value}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    pair.save(os.path.join(out_dir, f"{arch}__plan_pair.json"))
    return 0 if exact else 1


def run_via_plan(
    arch: str,
    *,
    reduced_cfg: bool,
    backend,
    batch_size: int,
    seq_len: int | None,
    head_by_head: bool,
    gen_steps: int,
    out_dir: str,
    cache_dir: str | None = None,
    use_cache: bool = True,
    device=None,
    seed: int = 0,
) -> int:
    """compile() -> CompiledModel -> InferenceSession for one arch, on
    ``device`` (the card unless ``"cpu"``) with weights drawn from
    ``seed``; checked bit for bit against the model-level integer path
    (both families).  Returns 0 when exact, 1 otherwise."""
    from repro_torch.models import encoder as EN

    cfg = get_config(arch)
    if reduced_cfg:
        cfg = reduced(cfg)
    is_decoder = api.is_dense_decoder(cfg)
    if is_decoder and head_by_head:
        print("[note   ] --head-by-head is encoder-only; decoder pairs always "
              "emit fused attention (flag ignored)")
    t0 = time.perf_counter()
    try:
        model = api.compile(
            cfg,
            backend=backend,
            seq_len=(seq_len or 32) if is_decoder else seq_len,
            max_len=(seq_len or 32) + gen_steps + 1 if is_decoder else None,
            head_by_head=head_by_head and not is_decoder,
            cache_dir=cache_dir,
            use_cache=use_cache,
        )
    except api.UnsupportedFamilyError as e:
        raise SystemExit(f"--via-plan: {e}") from None
    t_lower = time.perf_counter() - t0

    if model.kind == "decoder":
        return run_decoder_via_plan(model, batch_size=batch_size, gen_steps=gen_steps,
                                    out_dir=out_dir, device=device, seed=seed)

    plan = model.artifact
    counts = plan.counts()
    print(
        f"[plan   ] {arch}: {counts['nodes']} nodes "
        f"({counts['ita']} ita / {counts['cluster']} cluster), "
        f"{len(plan.tilings)} tilings, static peak {plan.memory_peak / 1024:.0f} KiB, "
        f"{'plan cache hit' if model.cache_hit else 'lowered'} in {t_lower:.2f}s"
    )

    session = model.session(batch_size, device=device, seed=seed)
    dev = session.device
    qp = to_device(session.qp, dev)
    rng = np.random.default_rng(0)
    name = plan.inputs[0]
    if name == "tokens":
        x = rng.integers(0, cfg.vocab, (batch_size, plan.seq_len), dtype=np.int32)
    else:
        x = rng.integers(-64, 64, (batch_size, plan.seq_len, cfg.d_model), dtype=np.int8)
    x = torch.from_numpy(x).to(dev)

    t0 = time.perf_counter()
    out = session.forward(x)
    _sync(dev)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = session.forward(x)
    _sync(dev)
    t_steady = time.perf_counter() - t0

    # the model-level path that attends as the plan does: flash ITAMax
    # where the plan's MHA runs on the attention kernel, rowwise elsewhere
    # (the JAX package compares every plan with the rowwise path, so it
    # reports a mismatch wherever an MHA node is accelerated)
    flash = model.backend.value == "ita" and any(
        n.kind == "mha" and n.engine == "ita" for n in plan.nodes)
    ref_cfg = cfg.replace(ita_head_by_head=True) if head_by_head else cfg
    ref = EN.forward_w8a8(ref_cfg, qp, {name: x}, backend="ita" if flash else "w8a8")
    exact = torch.equal(out, ref)
    max_diff = float((out - ref).abs().max())
    be = model.backend
    status = "ok" if exact else "MISMATCH"
    print(
        f"[{status:7s}] plan-executor [{be.value}] vs forward_w8a8: "
        f"bit-exact={exact} (max |diff| {max_diff:.3g}); "
        f"compile+run {t_first:.2f}s, steady {t_steady * 1e3:.1f}ms "
        f"for batch {batch_size} x seq {plan.seq_len} on {dev.type}"
    )

    os.makedirs(out_dir, exist_ok=True)
    rec = {
        "arch": arch, "reduced": reduced_cfg, "backend": be.value,
        "status": "ok" if exact else "mismatch", "bit_exact": exact,
        "plan": counts, "memory_peak": plan.memory_peak,
        "lower_s": round(t_lower, 3), "steady_s": round(t_steady, 4),
        "head_by_head": head_by_head,
        "cache_hit": model.cache_hit,
        "fingerprint": model.fingerprint,
        "compiler_version": model.compiler_version,
    }
    with open(os.path.join(out_dir, f"{arch}__via_plan__{be.value}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    plan.save(os.path.join(out_dir, f"{arch}__plan.json"))
    return 0 if exact else 1


def main(argv=None) -> int:
    from repro_torch.launch.cli import add_plan_args

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--out-dir", default="experiments/dryrun")
    add_plan_args(ap, via_plan_help="compile --arch to its deployment artifact and "
                  "execute it, verifying bit-exactness vs the model-level w8a8 path "
                  "(both families)")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (CPU smoke) variant of --arch")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--gen", type=int, default=2,
                    help="decoder --via-plan: number of chained decode steps to verify "
                         "against decode_step_w8a8")
    ap.add_argument("--head-by-head", action="store_true",
                    help="lower with the paper's per-head MHA schedule")
    args = ap.parse_args(argv)

    if not args.via_plan:
        raise SystemExit(
            "dryrun: only --via-plan is ported; the multi-pod cells (lowered against TPU "
            "meshes in the JAX package) have no counterpart in the port yet")
    if not args.arch:
        raise SystemExit("--via-plan requires --arch")
    return run_via_plan(
        args.arch,
        reduced_cfg=args.reduced,
        backend=args.backend,
        batch_size=args.batch,
        seq_len=args.seq,
        head_by_head=args.head_by_head,
        gen_steps=args.gen,
        out_dir=args.out_dir,
        cache_dir=args.plan_cache,
        use_cache=not args.no_plan_cache,
        device=args.device,
        seed=args.seed,
    )


if __name__ == "__main__":
    raise SystemExit(main())
