"""Dry runs of the port: the plan-backed deployment flow, and the multi-pod grid.

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

Multi-pod dry run (without ``--via-plan``): for every (architecture x
input-shape) cell, run the real step — ``train_step`` (AdamW, remat,
microbatching, FSDP) for train cells, ``prefill`` / ``decode_step`` for
serving cells — once on the production mesh (16x16, or 2x16x16 with
``--multi-pod``), with the parameters, optimizer state, batch and cache
placed by the sharding rules, and record what one rank runs:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-370m --shape decode_32k \
      --device cpu

The world is a fake process group of 256 or 512 ranks in which this
process is rank 0 (``launch.mesh.init_fake_world``), and the state lives
in ``FakeTensorMode`` on the device ``--device`` names (the card by
default): no data moves and nothing is allocated, so the numbers are
shapes, ops and bytes per rank.  A cell that runs proves that DTensor
can shard the step as the rules place it; one that fails is recorded
``failed`` with DTensor's message, as the JAX package records a failed
lowering.  ``deploy.hlo_analysis`` reads the rank's local op stream where
the JAX package parses partitioned HLO.  Each record (one JSON per cell
under ``--out-dir``, the JAX package's file names) holds the JAX
package's keys with these meanings here:

  lower_s      seconds to build the cell: the state drawn in fake tensors
               and placed on the mesh as DTensors (no lowering in eager torch)
  compile_s    seconds to run the step once in the fake world: DTensor's
               sharding propagation and the local op stream (no compile)
  flops, mem_bytes, collectives   ``hlo_analysis.analyze_hlo`` of the stream
  argument_size_in_bytes  the rank's shards of the step's arguments
  output_size_in_bytes    the rank's shards of its results (a train step
               updates params and state in place and returns them: counted)
  temp_size_in_bytes      the most live bytes during the step above the
               arguments (``peak_bytes``, the port's own key, minus them)
  largest_bytes           the port's own: the largest single storage the
               rank held during the step (``hlo_analysis``)
  live_at_peak            with ``--live-at-peak N``: the N largest groups of
               the storages live at the step's peak, by the source, shape
               and dtype that made them (``hlo_analysis.live_at_peak``)

``xla_cost_flops``, ``generated_code_size_in_bytes`` and
``alias_size_in_bytes`` have no counterpart and are left out.  One
process holds one world, so ``--multi-pod both`` and ``--jobs`` run the
cells in child processes, each in its own world.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from repro_torch.configs import (
    ALL_SHAPES,
    get_config,
    list_archs,
    reduced,
    shape_applicable,
)
from repro_torch.convert import to_device
from repro_torch.deploy import api
from repro_torch.deploy.hlo_analysis import OpRecorder, analyze_hlo, live_at_peak
from repro_torch.launch.mesh import init_fake_world, make_production_mesh
from repro_torch.models import build, input_specs
from repro_torch.optim import adamw
from repro_torch.runtime.activations import activation_policy
from repro_torch.runtime.sharding import (
    _map2,
    batch_shardings,
    cache_shardings,
    opt_state_shardings,
    param_shardings,
)

# train-cell microbatch counts (memory fitting; the global batch is fixed)
MICROBATCHES = {
    "qwen1.5-110b": 16,
    "mistral-large-123b": 16,
    "llava-next-34b": 8,
    "seamless-m4t-large-v2": 4,
    "zamba2-2.7b": 4,
    "mamba2-370m": 2,
    "qwen2-moe-a2.7b": 2,
}

#: the world a production mesh needs, by ``multi_pod``
WORLD = {False: 256, True: 512}


def fake_mode():
    """The ``FakeTensorMode`` a dry run's state lives in (plain tensors the
    model makes on the host, such as a cache's length, are taken in)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def _spec_tensors(specs: dict, device) -> dict:
    """Zeros for ``model_zoo.input_specs``' stand-ins (fake under a fake mode)."""
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device) for k, s in specs.items()}


def place(tree, shardings):
    """Every tensor leaf of ``tree`` as a DTensor holding this rank's shard
    of it on its ``NamedSharding`` (a slice of the leaf; no collective
    runs)."""
    from torch.distributed.tensor import DTensor

    def put(leaf, sh):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        pl, coord = sh.placements, sh.mesh.get_coordinate()
        shape, offset = list(leaf.shape), [0] * leaf.dim()
        for i, p in enumerate(pl):  # the rules' shards divide evenly (sanitize_spec)
            if p.is_shard():
                shape[p.dim] //= sh.mesh.size(i)
                offset[p.dim] += coord[i] * shape[p.dim]
        local = leaf
        if tuple(shape) != tuple(leaf.shape):
            local = leaf[tuple(slice(o, o + n) for o, n in zip(offset, shape))].clone()
        return DTensor.from_local(local, sh.mesh, pl, run_check=False, shape=leaf.shape,
                                  stride=leaf.stride())

    return _map2(put, tree, shardings)


def _cell(shape_name: str):
    return next(c for c in ALL_SHAPES if c.name == shape_name)


def build_cell(arch: str, shape_name: str, mesh, *, seed: int = 0, device=None):
    """Returns ``(fn, args, shardings, meta)`` for one cell: ``fn(*args)``
    runs the cell's step on ``args``, already placed on ``mesh`` by
    ``shardings``.  Call it under :func:`fake_mode` for shapes alone
    (``run_cell`` does); outside one it draws real tensors."""
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = get_config(arch)
    cell = _cell(shape_name)
    api_ = build(cfg)
    dev = api.resolve_device(device)

    if cell.kind == "train":
        from repro_torch.launch.train import make_train_step, shard_train_fn

        params = api_.init_params(seed, torch.bfloat16, device=dev)
        opt_state = adamw.init(params)
        batch = _spec_tensors(input_specs(cfg, cell, torch.bfloat16), dev)
        mb = MICROBATCHES.get(arch, 1)
        step = make_train_step(api_, microbatches=mb, remat=True)
        # ZeRO-3/FSDP: params + optimizer fully sharded (data axes included)
        p_sh = param_shardings(mesh, params, fsdp=True)
        o_sh = opt_state_shardings(mesh, opt_state, p_sh)
        b_sh = batch_shardings(mesh, batch)
        fn = shard_train_fn(step, mesh, params, opt_state, batch, fsdp=True)
        args = (place(params, p_sh), place(opt_state, o_sh), place(batch, b_sh))
        return fn, args, (p_sh, o_sh, b_sh), {"microbatches": mb, "kind": "train",
                                               "fsdp": True}

    sparams = api_.init_serve_params(seed, device=dev)
    sp_sh = param_shardings(mesh, sparams)

    def serving(f):
        def run(*a):
            with implicit_replication():  # plain tensors the model makes: replicated
                return f(*a)
        return run

    if cell.kind == "prefill":
        batch = _spec_tensors(input_specs(cfg, cell, torch.bfloat16), dev)
        b_sh = batch_shardings(mesh, batch)
        fn = serving(lambda sp, b: api_.prefill(sp, b, cell.seq_len))
        return fn, (place(sparams, sp_sh), place(batch, b_sh)), (sp_sh, b_sh), {
            "kind": "prefill"}

    # decode
    cache = api_.init_cache_shape(cell.global_batch, cell.seq_len)(device=dev)
    seq_shard = cell.name == "long_500k"
    c_sh = cache_shardings(mesh, cache, seq_shard=seq_shard)
    token = _spec_tensors({"token": input_specs(cfg, cell)["token"]}, dev)["token"]
    t_sh = batch_shardings(mesh, {"token": token})["token"]
    fn = serving(api_.decode_step)
    placed = place(cache, c_sh)
    placed["len"] = cache["len"]  # host data: the decode step reads it on the host
    args = (place(sparams, sp_sh), placed, place(token, t_sh))
    return fn, args, (sp_sh, c_sh, t_sh), {"kind": "decode"}


def analyze_cell(arch: str, shape_name: str, mesh, *, device=None, fake: bool = True,
                 seed: int = 0, at_peak: int = 0) -> dict:
    """``build_cell`` on ``mesh`` and one run of its step, recorded by
    ``hlo_analysis``: the record's numbers.  ``fake``: the state in
    :func:`fake_mode` (shapes only); else real tensors on ``device``.
    ``at_peak``: also record that many of the largest groups of the storages
    live at the step's peak (``live_at_peak``)."""
    import contextlib

    dev = api.resolve_device(device)
    t0 = time.time()
    with fake_mode() if fake else contextlib.nullcontext():
        fn, args, _, meta = build_cell(arch, shape_name, mesh, seed=seed, device=dev)
        t_lower = time.time() - t0
        ops = OpRecorder(dev.type, at_peak=at_peak > 0)
        arg_bytes = ops.track(args)
        with activation_policy(mesh, sequence_parallel=(meta["kind"] == "train")), ops:
            out = fn(*args)
        t_compile = time.time() - t0 - t_lower
    hlo = analyze_hlo(ops)
    extra = {"live_at_peak": live_at_peak(ops, at_peak)} if at_peak else {}
    return {
        **meta,
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "flops": hlo["flops"],
        "mem_bytes": hlo["mem_bytes"],
        "collectives": {
            "bytes_by_op": hlo["collective_by_op"],
            "op_counts": hlo["collective_counts"],
            "total_bytes": hlo["collective_bytes"],
        },
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": OpRecorder.local_bytes(out, dev.type),
        "temp_size_in_bytes": hlo["peak_bytes"] - arg_bytes,
        "peak_bytes": hlo["peak_bytes"],
        "largest_bytes": hlo["largest_bytes"],
        "n_computations": hlo["n_computations"],
        "op_counts": hlo["op_counts"],
        **extra,
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, out_dir: str,
             device=None, at_peak: int = 0) -> dict:
    """One cell in a fake world of 256 / 512 ranks (started here unless a
    world is running): its record, also written to ``out_dir``."""
    import torch.distributed as dist

    cfg = get_config(arch)
    cell = _cell(shape_name)
    ok, reason = shape_applicable(cfg, cell)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec

    try:
        dev = api.resolve_device(device)
        if not dist.is_initialized():
            init_fake_world(WORLD[multi_pod])
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
        rec.update(analyze_cell(arch, shape_name, mesh, device=dev, at_peak=at_peak),
                   status="ok")
    except Exception as e:  # noqa: BLE001 — failures are findings
        rec.update(status="failed", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch.replace('/', '_')}__{shape_name}__{mesh_name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _cell_in_child(arch: str, shape: str, multi_pod: bool, out_dir: str,
                   device, at_peak: int = 0) -> subprocess.Popen:
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
            "--multi-pod", "on" if multi_pod else "off", "--out-dir", out_dir,
            "--live-at-peak", str(at_peak)]
    if device is not None:
        argv += ["--device", str(device)]
    # the child finds this package where this process found it
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    return subprocess.Popen(argv, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                            env=env)


#: the order in which a grid starts its cells: the costliest first (a train
#: step runs its layers forward, again under remat and backward, once a
#: microbatch; long_500k walks 256 KV blocks a layer), so that no long cell
#: starts last
_START_ORDER = {"train": 0, "prefill": 1, "decode": 2}


def run_grid(cells, *, out_dir: str, device=None, jobs: int = 1,
             at_peak: int = 0) -> list[dict]:
    """The records of ``cells`` ((arch, shape, multi_pod) each), in order,
    each run in a child process, ``jobs`` at a time (the costliest first),
    in a fake world of its own (a child that dies is a failed cell); each
    one's line prints as it ends."""
    results: dict = {}
    running: dict = {}

    def cost(item):
        (arch, shape, _mp) = item[1]
        cell = _cell(shape)
        return (_START_ORDER[cell.kind] if cell.name != "long_500k" else 0,
                -MICROBATCHES.get(arch, 1) * get_config(arch).n_layers)

    todo = sorted(enumerate(cells), key=cost)
    while todo or running:
        while todo and len(running) < max(jobs, 1):
            i, (arch, shape, mp) = todo.pop(0)
            ok, reason = shape_applicable(get_config(arch), _cell(shape))
            if not ok:
                results[i] = run_cell(arch, shape, multi_pod=mp, out_dir=out_dir)
                continue
            running[i] = _cell_in_child(arch, shape, mp, out_dir, device, at_peak)
        for i, proc in list(running.items()):
            if proc.poll() is None:
                continue
            err = proc.stderr.read()
            del running[i]
            arch, shape, mp = cells[i]
            mesh_name = "2x16x16" if mp else "16x16"
            path = os.path.join(out_dir, f"{arch.replace('/', '_')}__{shape}__{mesh_name}.json")
            try:
                with open(path) as f:
                    results[i] = json.load(f)
            except OSError:
                results[i] = {"arch": arch, "shape": shape, "mesh": mesh_name,
                              "status": "failed",
                              "error": f"the cell's process exited {proc.returncode}: "
                                       f"{err[-1500:]}"}
            print(_summary_line(results[i]), flush=True)
        time.sleep(0.2)
    return [results[i] for i in range(len(cells))]


def _summary_line(rec: dict) -> str:
    status = rec["status"]
    extra = (
        f"flops={rec.get('flops', 0):.3e} "
        f"coll={rec.get('collectives', {}).get('total_bytes', 0):.3e}B "
        f"compile={rec.get('compile_s', 0)}s"
        if status == "ok"
        else rec.get("reason", rec.get("error", ""))[:120]
    )
    return f"[{status:7s}] {rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:8s} {extra}"


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
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"], default="off")
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
    ap.add_argument("--jobs", type=int, default=1,
                    help="multi-pod cells run at once, each in a child process")
    ap.add_argument("--live-at-peak", type=int, default=0, metavar="N",
                    help="multi-pod: record the N largest groups of the storages live at "
                         "each step's peak (slower)")
    args = ap.parse_args(argv)

    if not args.via_plan:
        archs = [args.arch] if args.arch else list_archs()[:10]
        shapes = [args.shape] if args.shape else [c.name for c in ALL_SHAPES]
        pods = {"off": [False], "on": [True], "both": [False, True]}[args.multi_pod]
        cells = [(a, s, mp) for a in archs for s in shapes for mp in pods]
        if len(cells) == 1:
            results = [run_cell(archs[0], shapes[0], multi_pod=pods[0], out_dir=args.out_dir,
                                device=args.device, at_peak=args.live_at_peak)]
            print(_summary_line(results[0]), flush=True)
        else:
            results = run_grid(cells, out_dir=args.out_dir, device=args.device, jobs=args.jobs,
                               at_peak=args.live_at_peak)
        n_ok = sum(r["status"] == "ok" for r in results)
        n_skip = sum(r["status"] == "skipped" for r in results)
        n_fail = sum(r["status"] == "failed" for r in results)
        print(f"\ndry-run: {n_ok} ok, {n_skip} skipped (documented), {n_fail} failed")
        return 1 if n_fail else 0
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
