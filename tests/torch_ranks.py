"""What each rank runs for ``test_torch_distributed.py``.

``launch.mesh.spawn`` starts 8 ranks (gloo, on the CPU) and imports this
module by name in each of them, so it imports no JAX: the reference's
side runs in its own process, and the results meet in the test.  All 8
take part in the elastic 8 -> 4 re-mesh, in a sharded checkpoint saved
from a (4, 2) mesh and restored onto its (2, 2) re-mesh, and build every
mesh (a mesh's groups are made by every rank of the world); then ranks
0-3 ("A") and 4-7 ("B") each run their half of the checks on meshes of
their own four ranks, at the same time, the first of them a supervised
restart that both halves checkpoint together.  Ranks 0 and 4 write what their
half saw to ``<out>/rank<r>.pt``; the checkpoints stay under ``<out>``.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

#: (kind, shapes) of ``constrain``'s cases: each kind where it fits the
#: 2x2 mesh and where it does not
CONSTRAIN_CASES = [
    ("residual", (4, 8, 16)), ("residual", (3, 5, 16)), ("residual", (4, 5, 16)),
    ("gathered", (4, 8, 16)), ("gathered", (3, 8, 16)),
    ("heads", (4, 4, 8, 16)), ("heads", (4, 3, 8, 16)), ("heads", (3, 3, 5, 16)),
    ("ssd", (4, 8, 4, 16)), ("ssd", (3, 8, 3, 16)),
    ("ssd_l", (4, 2, 4, 8, 8)), ("ssd_l", (3, 2, 3, 8, 8)),
    ("tokens", (4, 8)), ("tokens", (3, 8)),
    ("experts", (4, 4, 8, 16)), ("experts", (3, 3, 8, 16)),
    ("residual", (4, 8)), ("unknown", (4, 8, 16)),
]
#: the activation policies the cases run under: (sequence_parallel, gather_boundary)
POLICIES = [(True, True), (False, True), (True, False)]

#: the sharded OLMo-1B steps: (mesh, fsdp, microbatches, under activation_policy);
#: 1x4 splits reduced OLMo-1B's 4 query heads and 2 K/V heads over 4 model ranks
OLMO_STEPS = [((2, 2), True, 1, True), ((4, 1), True, 1, False), ((2, 2), True, 2, True),
              ((1, 4), True, 1, True)]
#: which half runs which step and arch (by their cost on a CPU, about
#: 35 s each: a family's second arch is cheap where the first has taught
#: DTensor its ops)
HALF_B_STEPS = [((4, 1), True, 1, False), ((1, 4), True, 1, True)]
#: GQA archs whose reduced step also runs on 1x4 (2 K/V heads, 4 model ranks)
GQA_1X4 = ["granite-moe-3b-a800m"]
HALF_B_ARCHS = ["qwen1.5-110b", "mistral-large-123b", "stablelm-1.6b", "zamba2-2.7b",
                "mamba2-370m", "seamless-m4t-large-v2", "llava-next-34b"]
OLMO_BATCH, OLMO_SEQ, OLMO_STEPS_N = 4, 32, 2
ARCH_BATCH, ARCH_SEQ = 4, 16
#: the supervised restart of reduced OLMo-1B's 2x2 step (half A): a save
#: every 2 steps, one failure injected at step 3, 4 steps
RESTART = dict(save_every=2, fail_at=3, steps=4)
#: the vocab-parallel loss's cases: [B, S, V_padded] float32 logits and
#: the vocab each masks (512: none of the classes is padding; 500: the
#: last 12 of "model" rank 1's shard are), and the layouts the logits come
#: in on 2x2 (the product's, and a whole tensor the loss must slice)
NLL_SHAPE, NLL_VOCABS = (4, 6, 512), (512, 500)
NLL_LAYOUTS = ("batch-vocab", "whole")


def _placed_as_rules(tree, shardings) -> list[str]:
    """Paths of the DTensor leaves whose placements differ from their
    ``NamedSharding``'s."""
    from repro_torch.runtime.sharding import _map_with_path, _map2

    bad = []
    flags = _map2(lambda t, s: tuple(t.placements) == s.placements, tree, shardings)
    _map_with_path(lambda p, ok: ok or bad.append("/".join(map(str, p))), flags)
    return bad


def _cloned(tree):
    from repro_torch.runtime.sharding import _map_with_path

    return _map_with_path(lambda _, t: t.clone(), tree)


def _error(fn, *args) -> dict:
    """``fn(*args)``, or the error it raised (every rank raises alike, so
    the ranks stay in step and the other checks still run)."""
    import traceback

    try:
        return fn(*args)
    except Exception:  # noqa: BLE001 - reported by the test that reads it
        return {"error": traceback.format_exc()[-3000:]}


class _LiveWholes:
    """While entered, counts the bytes of the whole leaves that the
    checkpointer's gathers (``checkpointer._whole``) have returned and
    that are still alive, at each gather (weak references: a freed leaf
    drops out): ``peak`` of them at once, ``largest`` of one, ``total``."""

    def __enter__(self):
        import weakref

        from repro_torch.checkpoint import checkpointer

        self._mod, self._orig = checkpointer, checkpointer._whole
        self.refs, self.peak, self.largest, self.total = [], 0, 0, 0

        def whole(leaf):
            t = self._orig(leaf)
            if t is not leaf:
                self.refs = [r for r in self.refs if r() is not None] + [weakref.ref(t)]
                live = [r() for r in self.refs]
                self.peak = max(self.peak, sum(x.nbytes for x in live if x is not None))
                self.largest = max(self.largest, t.nbytes)
                self.total += t.nbytes
            return t

        checkpointer._whole = whole
        return self

    def __exit__(self, *exc):
        self._mod._whole = self._orig


def _restore_on_fewer_ranks(rank: int, out: Path, state, mesh8, mesh4) -> dict:
    """On all 8 ranks: ``state`` (reduced OLMo-1B's params and AdamW state)
    placed by the rules on the (4, 2) mesh and saved by the default group
    (the whole leaves each rank holds at once counted, and what each rank
    sees when ``save`` returns), then restored onto the (2, 2) re-mesh of
    ranks 0-3 by its rules; ranks 0-3 gather the restored values and take
    the next step there."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.train import make_train_step, shard_train_fn
    from repro_torch.models import build
    from repro_torch.runtime.activations import activation_policy
    from repro_torch.runtime.sharding import (
        device_put, gather, opt_state_shardings, param_shardings)

    params, opt, batch = state

    def rules(mesh):
        p_sh = param_shardings(mesh, params)
        return p_sh, opt_state_shardings(mesh, opt, p_sh)

    placed = device_put((params, opt), rules(mesh8))
    ck = Checkpointer(str(out / "ckpt8"))
    with _LiveWholes() as live:
        path = ck.save(1, placed)
    # no wait(): a synchronous save returns committed on every rank
    committed = {"latest": ck.latest_step(), "path": Path(path).is_dir()}
    step, (p4, o4) = ck.restore_latest(placed, shardings=rules(mesh4))
    p_sh4, o_sh4 = rules(mesh4)
    res = {"step": step, "misplaced": _placed_as_rules(p4, p_sh4) + _placed_as_rules(o4, o_sh4),
           "placements": [repr(p) for p in p4["embed"]["table"].placements],
           "committed": committed,
           "whole_bytes": {"peak": live.peak, "largest": live.largest, "total": live.total}}
    if rank < 4:
        res["values"] = _cloned(gather((p4, o4)))
        api = build(reduced(get_config("olmo-1b")))
        sstep = shard_train_fn(make_train_step(api, remat=True), mesh4, p4, o4, batch)
        with activation_policy(mesh4):
            p5, _, m = sstep(p4, o4, batch)
        res["metrics"] = (float(m["loss"]), float(m["grad_norm"]))
        res["params"] = gather(p5)
    return res


def _supervised_restart(mesh, out: Path, params) -> dict:
    """Reduced OLMo-1B's sharded step (2x2, fsdp, under the policy) run
    uninterrupted, and under ``Supervisor`` (``RESTART``): the metrics of
    every step and the final states, gathered.  Both halves run it at
    once, each on its own 2x2 mesh, as two replicas of one job: every
    rank calls the checkpointer, rank 0 writes the host's files, and half
    B restores what half A's gather wrote.  Both run under ``torch.use_deterministic_algorithms``:
    the CPU's threaded ``index_put_(accumulate=True)`` (the embedding
    gather's backward) sums a repeated token's rows in a varying order,
    so two runs of one step can differ in the last bit."""
    from repro_torch.configs import ShapeCell, get_config, reduced
    from repro_torch.convert import tree_map
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch.train import make_train_step, shard_train_fn
    from repro_torch.models import build
    from repro_torch.optim import adamw
    from repro_torch.runtime.activations import activation_policy

    cfg = reduced(get_config("olmo-1b"))
    dcfg = DataConfig(vocab=cfg.vocab, global_batch=OLMO_BATCH, seq_len=OLMO_SEQ)
    cell = ShapeCell("t", OLMO_SEQ, OLMO_BATCH, "train")
    train_step = make_train_step(build(cfg), remat=True)

    def batch_fn(s):
        return {k: torch.from_numpy(v) for k, v in make_batch(cfg, cell, dcfg, s).items()}

    def start():
        p = tree_map(torch.clone, params)
        o = adamw.init(p)
        sstep = shard_train_fn(train_step, mesh, p, o, batch_fn(0), fsdp=True)

        def step_fn(state, batch):
            with activation_policy(mesh):
                p, o, m = sstep(*state, batch)
            return (p, o), m

        return step_fn, (p, o)

    torch.use_deterministic_algorithms(True)
    try:
        return _restart_runs(start, batch_fn, out)
    finally:
        torch.use_deterministic_algorithms(False)


def _restart_runs(start, batch_fn, out: Path) -> dict:
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.runtime.fault import Supervisor
    from repro_torch.runtime.sharding import gather

    def metrics(m):
        return float(m["loss"]), float(m["grad_norm"])

    step_fn, state = start()
    plain = []
    for s in range(RESTART["steps"]):
        state, m = step_fn(state, batch_fn(s))
        plain.append(metrics(m))
    res = {"plain": plain, "plain_state": gather(state)}

    failed = []

    def inject(s):
        if s == RESTART["fail_at"] and not failed:
            failed.append(s)
            raise RuntimeError(f"failure injected at step {s}")

    step_fn, state = start()
    ck = Checkpointer(str(out / "restart"))
    state, history = Supervisor(ck, save_every=RESTART["save_every"]).run(
        step_fn, state, batch_fn, 0, RESTART["steps"], inject_failure=inject)
    res.update(history=[(s, *metrics(m)) for s, m in history], failed=failed,
               state=gather(state), latest=ck.latest_step())
    return res


def _olmo_steps(mesh, params, batches, fsdp, microbatches, policy):
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import tree_map
    from repro_torch.launch.train import make_train_step, shard_train_fn
    from repro_torch.models import build
    from repro_torch.optim import adamw
    from repro_torch.runtime.activations import activation_policy
    from repro_torch.runtime.sharding import gather, opt_state_shardings, param_shardings

    api = build(reduced(get_config("olmo-1b")))
    p = tree_map(torch.clone, params)
    o = adamw.init(p)
    step = shard_train_fn(make_train_step(api, microbatches=microbatches, remat=True), mesh, p,
                          o, batches[0], fsdp=fsdp)
    metrics = []
    t0 = time.perf_counter()
    for b in batches:
        if policy:
            with activation_policy(mesh):
                p, o, m = step(p, o, b)
        else:
            p, o, m = step(p, o, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        [repr(pl) for pl in m["loss"].placements]))
    seconds = time.perf_counter() - t0
    p_sh = param_shardings(mesh, p, fsdp=fsdp)
    bad = _placed_as_rules(p, p_sh) + _placed_as_rules(o, opt_state_shardings(mesh, o, p_sh))
    return {"metrics": metrics, "params": gather(p), "misplaced": bad, "seconds": seconds,
            "step": int(o.step.full_tensor())}


class StridedWatch:
    """A dispatch mode that notes each DTensor op with a ``_StridedShard``
    input: the layout torch 2.13 makes where torch 2.11 refuses to view two
    sharded dims as one (the sites of open fault 1; none must remain)."""

    def __new__(cls):
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.placement_types import _StridedShard
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves

        class Watch(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.seen = []

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                for a in tree_leaves((args, kwargs)):
                    if isinstance(a, DTensor) and any(isinstance(p, _StridedShard)
                                                      for p in a.placements):
                        self.seen.append(str(func))
                        break
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                return func(*args, **(kwargs or {}))

        return Watch()


def _arch_step(mesh, arch, sequence_parallel: bool = True):
    """One step of a reduced arch, sharded on ``mesh`` (fsdp, under the
    policy) and unsharded, from the same params: the worst differences,
    and the ops that saw a ``_StridedShard`` input."""
    from repro_torch.configs import ShapeCell, get_config, reduced
    from repro_torch.convert import tree_leaves, tree_map
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch.train import make_train_step, shard_train_fn
    from repro_torch.models import build
    from repro_torch.optim import adamw
    from repro_torch.runtime.activations import activation_policy
    from repro_torch.runtime.sharding import gather

    cfg = reduced(get_config(arch))
    api = build(cfg)
    p0 = api.init_params(0, device="cpu")
    dcfg = DataConfig(vocab=max(cfg.vocab, 2), global_batch=ARCH_BATCH, seq_len=ARCH_SEQ)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        cfg, ShapeCell("t", ARCH_SEQ, ARCH_BATCH, "train"), dcfg, 0).items()}
    step = make_train_step(api, remat=False)
    pr = tree_map(torch.clone, p0)
    _, _, mr = step(pr, adamw.init(pr), batch)
    ps = tree_map(torch.clone, p0)
    os_ = adamw.init(ps)
    sstep = shard_train_fn(step, mesh, ps, os_, batch, fsdp=True)
    watch = StridedWatch()
    try:
        with activation_policy(mesh, sequence_parallel=sequence_parallel), watch:
            ps, os_, ms = sstep(ps, os_, batch)
    except NotImplementedError as e:
        return {"refused": str(e), "strided": sorted(set(watch.seen))}
    diff = [(a - b).abs() for a, b in zip(tree_leaves(gather(ps)), tree_leaves(pr))]
    n = sum(d.numel() for d in diff)
    return {"loss": (float(ms["loss"]), float(mr["loss"])),
            "grad_norm": (float(ms["grad_norm"]), float(mr["grad_norm"])),
            "worst": max(float(d.max()) for d in diff),
            "share": sum(int((d > 1e-5).sum()) for d in diff) / n,
            "strided": sorted(set(watch.seen))}


def _int8_chain(mesh, qp, tokens, steps: int = 2):
    """Reduced OLMo-1B's int8 prefill and ``steps`` decode steps on ``mesh``
    (serve params and tokens placed by the rules), gathered: logits and
    caches of each call; and ``imatmul`` of two DTensors, gathered."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as T
    from repro_torch.quant.qparams import imatmul
    from repro_torch.runtime.activations import activation_policy
    from repro_torch.runtime.sharding import (
        batch_shardings, cache_shardings, device_put, gather, param_shardings)

    cfg = reduced(get_config("olmo-1b"))
    sp = device_put(qp, param_shardings(mesh, qp))
    b = device_put({"tokens": tokens}, batch_shardings(mesh, {"tokens": tokens}))
    out = []
    with activation_policy(mesh, sequence_parallel=False), implicit_replication():
        logits, cache = T.prefill_w8a8(cfg, sp, b, tokens.shape[1] + steps + 1)
        out.append(gather((logits, cache["k"], cache["v"])))
        tok = torch.argmax(logits.full_tensor()[:, -1:], dim=-1).to(torch.int32)
        for _ in range(steps):
            placed = device_put(cache, cache_shardings(mesh, cache))
            placed["len"] = cache["len"]
            logits, cache = T.decode_step_w8a8(
                cfg, sp, placed, device_put({"t": tok}, batch_shardings(mesh, {"t": tok}))["t"])
            out.append(gather((logits, cache["k"], cache["v"])))
            tok = torch.argmax(logits.full_tensor()[:, -1:], dim=-1).to(torch.int32)
    g = torch.Generator().manual_seed(1)
    a = torch.randint(-127, 128, (4, 6, 256), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (256, 64), generator=g, dtype=torch.int8)
    prods = []
    for pa, pw in (([Shard(0), Replicate()], [Replicate(), Shard(1)]),
                   ([Shard(0), Shard(2)], [Replicate(), Shard(0)]),
                   ([Replicate(), Shard(1)], [Shard(1), Replicate()])):
        prods.append(imatmul(distribute_tensor(a, mesh, pa),
                             distribute_tensor(w, mesh, pw)).full_tensor())
    return {"chain": out, "imatmul": (a, w, prods)}


def _custom_op_step(mesh):
    """shard_train_fn on a step whose loss runs an op DTensor has no rule for."""
    from repro_torch.launch.train import shard_train_fn
    from repro_torch.optim import adamw

    @torch.library.custom_op("repro_torch_test::twice", mutates_args=())
    def twice(x: torch.Tensor) -> torch.Tensor:
        return x * 2

    def step(params, opt_state, batch):
        return params, opt_state, {"loss": twice(params["w"]).sum()}

    p = {"w": torch.ones(4, 4)}
    try:
        shard_train_fn(step, mesh, p, adamw.init(p), {"x": torch.zeros(4, 2)})(
            p, adamw.init(p), {"x": torch.zeros(4, 2)})
    except NotImplementedError as e:
        return str(e)
    return None


def nll_inputs(vocab: int):
    """Logits and labels for the loss's cases, from a seeded numpy
    generator: labels on each "model" shard's first and last class and on
    the last real class, the others random; the padded classes' logits
    large, so that a class left unmasked would move the loss."""
    import numpy as np

    b, s, v = NLL_SHAPE
    rng = np.random.default_rng(vocab)
    logits = rng.standard_normal(NLL_SHAPE).astype(np.float32) * 3
    logits[..., vocab:] = 40.0
    labels = rng.integers(0, vocab, (b, s))
    half = v // 2
    special = [0, half - 1, half, min(v, vocab) - 1]
    labels[:, :len(special)] = special  # every row of the batch, both data shards
    return torch.from_numpy(logits), torch.from_numpy(labels.astype(np.int32))


def _vocab_nll(mesh, mesh11) -> dict:
    """``token_nll`` of DTensor logits on the 2x2 ``mesh`` (and, where
    ``mesh11`` is given, on that 1x1 mesh), the loss and the logits'
    gradient gathered, for every case."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import layers as L

    layouts = {"batch-vocab": [Shard(0), Shard(2)], "whole": [Replicate(), Replicate()]}
    out = {}
    for vocab in NLL_VOCABS:
        logits, labels = nll_inputs(vocab)
        cases = [(name, mesh, layouts[name]) for name in NLL_LAYOUTS]
        if mesh11 is not None:
            cases.append(("1x1", mesh11, [Replicate(), Replicate()]))
        for name, m, pl in cases:
            x = distribute_tensor(logits, m, pl).requires_grad_(True)
            y = distribute_tensor(labels, m, [Shard(0) if pl[0] == Shard(0) else Replicate(),
                                              Replicate()])
            loss = L.token_nll(x, y, vocab)
            loss.backward()
            out[(vocab, name)] = (loss.full_tensor().detach(), x.grad.full_tensor(),
                                  [repr(p) for p in loss.placements])
    return out


def _four_rank_checks(rank: int, inputs: dict, pods, mesh, mesh11) -> dict:
    """compressed_psum, the pipeline, the FSDP placement, constrain and the
    vocab-parallel loss, on ranks 0-3 (the loss also on rank 0's 1x1
    ``mesh11``)."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    from repro_torch.optim.compression import compressed_psum
    from repro_torch.runtime.activations import activation_policy, constrain
    from repro_torch.runtime.pipeline import pipelined_apply
    from repro_torch.runtime.sharding import device_put, param_shardings

    res: dict = {}
    group = pods.get_group("pod")

    # compressed_psum over a group of 4, and by mesh-dim name under a policy
    g, err = inputs["g"][rank], torch.zeros_like(inputs["g"][rank])
    s, new_err = compressed_psum(g, err, group)
    with activation_policy(pods):
        s2, e2 = compressed_psum(g, err, "pod")
    assert torch.equal(s, s2) and torch.equal(new_err, e2)
    outs = [torch.empty_like(s) for _ in range(4)]
    errs = [torch.empty_like(new_err) for _ in range(4)]
    dist.all_gather(outs, s, group=group)
    dist.all_gather(errs, new_err, group=group)
    res["psum"] = (torch.stack(outs), torch.stack(errs))

    # the GPipe pipeline: 4 stages of one tanh-linear layer
    y = pipelined_apply(pods, lambda p, x: torch.tanh(x @ p["w"]), {"w": inputs["w"]},
                        inputs["x"], pipe_axis="pod", n_micro=4)
    ys = [torch.empty_like(y) for _ in range(4)]
    dist.all_gather(ys, y, group=group)
    res["pipeline"] = torch.stack(ys)

    # FSDP placement of a layer leaf on 2x2
    params = {"layers": [{"attn": {"wqkv": {"w": torch.zeros(8, 16)}}}]}
    sh = param_shardings(mesh, params, fsdp=True)
    placed = device_put(params, sh)["layers"][0]["attn"]["wqkv"]["w"]
    res["fsdp"] = (sh["layers"][0]["attn"]["wqkv"]["w"].spec,
                   tuple(placed.to_local().shape), [repr(p) for p in placed.placements])

    # constrain's placements for every kind, a DTensor and a plain tensor each
    cases = {}
    for pol in POLICIES:
        for kind, shape in CONSTRAIN_CASES:
            x = torch.arange(float(torch.Size(shape).numel())).reshape(shape)
            xd = distribute_tensor(x, mesh, [Replicate(), Replicate()])
            with activation_policy(mesh, sequence_parallel=pol[0], gather_boundary=pol[1]):
                got = [constrain(xd, kind), constrain(x, kind)]
            same = [r is a for r, a in zip(got, (xd, x))]
            assert same[0] == same[1], (kind, shape)
            assert all(torch.equal(r.full_tensor() if isinstance(r, DTensor) else r, x)
                       for r in got)
            cases[(pol, kind, shape)] = None if same[0] else tuple(got[0].placements)
    res["constrain"] = cases
    res["custom_op"] = _custom_op_step(mesh)
    res["vocab_nll"] = _vocab_nll(mesh, mesh11 if rank == 0 else None)
    res["int8"] = _int8_chain(mesh, inputs["qp"], inputs["tokens"])
    return res


def world8(rank: int, world: int, out: str, archs: list) -> None:
    from repro_torch.data import pipeline as data_pipeline
    from repro_torch.launch.mesh import make_host_mesh, make_mesh, make_production_mesh
    from repro_torch.runtime import elastic
    from repro_torch.runtime.sharding import device_put, gather, param_shardings

    out = Path(out)
    res: dict = {"hosts": (data_pipeline.process_count(), data_pipeline.process_index())}

    # the elastic re-mesh: 8 ranks as (4, 2), then the first 4 as (2, 2)
    want = torch.arange(64.0).reshape(8, 8)
    mesh8 = elastic.remesh(range(8), 2, device="cpu")
    params = {"layers": {"mlp": {"up": {"w": want.clone()}}}}
    p8 = device_put(params, param_shardings(mesh8, params))
    mesh4 = elastic.remesh(range(4), 2, device="cpu")  # lose half the fleet
    p4 = elastic.reshard_state(p8, mesh4)
    w8, w4 = p8["layers"]["mlp"]["up"]["w"], p4["layers"]["mlp"]["up"]["w"]
    res["mesh"] = (tuple(mesh8.shape), tuple(mesh4.shape), mesh4.mesh.flatten().tolist())
    res["local"] = (tuple(w8.to_local().shape), tuple(w4.to_local().shape))
    res["placements"] = [repr(p) for p in w4.placements]
    if rank < 4:
        res["values"] = gather(p4)["layers"]["mlp"]["up"]["w"]
    inputs = torch.load(out / "inputs.pt", weights_only=False)  # written by the test
    res["restore8to4"] = _error(_restore_on_fewer_ranks, rank, out, inputs["ckpt_state"],
                                mesh8, mesh4)
    res["host_mesh"] = [tuple(make_host_mesh(d, m, device="cpu").shape)
                        for d, m in ((16, 1), (2, 8), (2, 2), (1, 1))]
    try:
        make_production_mesh(device="cpu")
        res["production"] = None
    except ValueError as e:
        res["production"] = str(e)

    # every mesh of both halves, built by all 8 ranks
    names = ("data", "model")
    meshes = {(half, shape): make_mesh(shape, names, device="cpu", ranks=range(lo, lo + 4))
              for half, lo in (("A", 0), ("B", 4)) for shape in ((2, 2), (4, 1), (1, 4))}
    pods = make_mesh((4,), ("pod",), device="cpu", ranks=range(4))
    mesh11 = make_mesh((1, 1), names, device="cpu", ranks=range(1))
    half = "A" if rank < 4 else "B"
    t0 = time.perf_counter()
    res["restart"] = _error(_supervised_restart, meshes[(half, (2, 2))], out, inputs["olmo"])
    res["restart"]["seconds"] = time.perf_counter() - t0
    if half == "A":
        res.update(_four_rank_checks(rank, inputs, pods, meshes[("A", (2, 2))], mesh11))
    for case in OLMO_STEPS:
        if (case in HALF_B_STEPS) == (half == "B"):
            res[("olmo", *case)] = _olmo_steps(meshes[(half, case[0])], inputs["olmo"],
                                               inputs["batches"], *case[1:])
    res["archs"] = {}
    for arch in archs:
        if (arch in HALF_B_ARCHS) == (half == "B"):
            t0 = time.perf_counter()
            res["archs"][arch] = _arch_step(meshes[(half, (2, 2))], arch)
            res["archs"][arch]["seconds"] = time.perf_counter() - t0
    res["gqa_1x4"] = {arch: _arch_step(meshes[("A", (1, 4))], arch)
                      for arch in GQA_1X4 if half == "A"}
    if rank in (0, 4):
        torch.save(res, out / f"rank{rank}.pt")


def fail_on(rank: int, world: int, bad: int) -> None:
    """Rank ``bad`` raises; the others wait at a barrier it never reaches."""
    if rank == bad:
        raise RuntimeError(f"rank {rank} fails on purpose")
    dist.barrier()


#: the cycle guard's sharded steps on a 1x1 mesh: (batch, seq, microbatches,
#: fsdp), two steps each
GC_STEPS = [(2, 16, 1, False), (4, 32, 2, True)]


def unreachable_after_steps(rank: int, world: int, out: str) -> None:
    """Reduced OLMo-1B's sharded step twice through ``shard_train_fn`` on
    a 1x1 mesh (a gloo world of one) for each of ``GC_STEPS``, then one
    ``gc.collect()`` under ``gc.DEBUG_SAVEALL``: the unreachable objects,
    and the tensors (plain or DTensor) among them, written to ``out`` as
    JSON.  Nothing a step made may be left in a reference cycle."""
    import gc
    import json

    from repro_torch.configs import ShapeCell, get_config, reduced
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import make_train_step, shard_train_fn
    from repro_torch.models import build
    from repro_torch.optim import adamw
    from repro_torch.runtime.activations import activation_policy

    cfg = reduced(get_config("olmo-1b"))
    api = build(cfg)
    mesh = make_host_mesh(device="cpu")
    res = []
    for batch, seq, microbatches, fsdp in GC_STEPS:
        cell = ShapeCell("train", seq, batch, "train")
        dcfg = DataConfig(vocab=cfg.vocab, global_batch=batch, seq_len=seq)
        batches = [{k: torch.from_numpy(v) for k, v in make_batch(cfg, cell, dcfg, s).items()}
                   for s in range(2)]
        params = api.init_params(0, device="cpu")
        opt = adamw.init(params)
        step = shard_train_fn(make_train_step(api, microbatches=microbatches, remat=True),
                              mesh, params, opt, batches[0], fsdp=fsdp)
        gc.collect()  # what building the step left
        for b in batches:
            with activation_policy(mesh):
                params, opt, _ = step(params, opt, b)
        gc.set_debug(gc.DEBUG_SAVEALL)
        try:
            gc.collect()
            found = list(gc.garbage)
        finally:
            gc.set_debug(0)
            gc.garbage.clear()
        res.append({"case": [batch, seq, microbatches, fsdp], "unreachable": len(found),
                    "tensors": sum(isinstance(o, torch.Tensor) for o in found)})
        del found
    Path(out).write_text(json.dumps(res))


def _sweep(rank: int, world: int, archs: list, sequence_parallel: bool,
           shape=(2, 2)) -> None:
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(*shape, device="cpu")
    for arch in archs:
        t0 = time.perf_counter()
        res = _arch_step(mesh, arch, sequence_parallel)
        if rank == 0:
            print(f"{arch}: {time.perf_counter() - t0:.1f}s {res}", flush=True)


if __name__ == "__main__":
    # Every arch's sharded step on a 2x2 mesh of 4 CPU gloo ranks with this
    # machine's torch, against the unsharded step: which ops its DTensor
    # refuses.  PYTHONPATH=src python tests/torch_ranks.py [--no-sp] [--mesh 1x4]
    # (--no-sp: the policy without sequence parallelism; --mesh: another
    # mesh of 4 ranks, 1x4 splitting the reduced GQA archs' 2 K/V heads)
    import tempfile

    from repro_torch.configs import list_archs
    from repro_torch.launch.mesh import spawn

    argv = sys.argv[1:]
    sp = "--no-sp" not in argv
    shape = tuple(int(n) for n in argv[argv.index("--mesh") + 1].split("x")) \
        if "--mesh" in argv else (2, 2)
    print(f"torch {torch.__version__}, sequence_parallel={sp}, mesh {shape}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        spawn(_sweep, 4, list_archs(), sp, shape, workdir=tmp, timeout=900)
