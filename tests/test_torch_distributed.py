"""The port's distributed runtime on spawned gloo ranks, against the JAX
package's on forced host devices.

One spawn of 8 ranks (``torch_ranks.world8``) holds every check: the
elastic 8 -> 4 re-mesh and the mesh builders on all 8; then, on groups of
4 ranks at once, ``compressed_psum`` (over a group and by mesh-dim name),
``pipelined_apply`` at 4 stages, the FSDP placement of a layer leaf on
2x2, ``constrain``'s placements for every kind, reduced OLMo-1B's
``shard_train_fn`` steps on 2x2 and 4x1, one sharded step of every other
arch, the refusal of an op DTensor cannot shard, and the vocab-parallel
cross-entropy against the loss of the gathered logits.  Sharded
checkpoints: a ``Supervisor`` restart around the 2x2 step, run by both
halves at once as replicas of one job (rank 0 writes, half B restores
half A's files), equals the uninterrupted sharded run bit for bit in
each half, and writes one set of files, equal key by key to a single
process's save of the gathered state and loadable by the JAX package's
``Checkpointer``; a state saved from a (4, 2) mesh of all 8 ranks
restores onto the (2, 2) re-mesh of ranks 0-3 by the rules, and the next
step there agrees with the unsharded step.  The reference runs
in a subprocess with 4 forced host devices (``jax.set_mesh`` before its
``shard_map``: without it JAX 0.9 refuses the reference's own
``compressed_psum`` test), at the same time as the ranks.

Tolerances of the sharded step (``chip_smoke.py`` ``[train]``'s, per step):
loss rtol 1e-5, grad_norm rtol 1e-4, params within 2 * lr * steps with at
most 1e-3 of them beyond 1e-5.  Two partitionings of one step sum in
another order, so they agree to these, not to the bit.  With 2
microbatches the gradient is rounded to bfloat16 after each, and one
float32 ulp apart can flip a rounding, which moves that element's update
by up to 2 * lr as a fake-quant step does: there the grad norm and the
share are held to ``[train]``'s QAT values, 1e-3 and 5e-2 (measured at
2x2 against the unsharded step: grad norm 6.1e-5, 2.2e-3 of the params
beyond 1e-5).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import ShapeCell, get_config, list_archs, reduced
from repro.data import DataConfig
from repro.data import make_batch as j_make_batch
from repro.models import build as j_build
from repro.optim import adamw as JA
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import from_jax_params, to_jax_layout, tree_map
from repro_torch.launch.mesh import spawn
from repro_torch.launch.train import make_train_step
from repro_torch.models import build as t_build
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as TA
from repro_torch.runtime.sharding import P, placements

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ranks as R  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LR = 3e-4
LOSS_RTOL, GNORM_RTOL, TIGHT, TIGHT_SHARE = 1e-5, 1e-4, 1e-5, 1e-3
GNORM_RTOL_BF16_ACCUM, TIGHT_SHARE_BF16_ACCUM = 1e-3, 5e-2
#: archs whose step this torch's DTensor cannot shard (``shard_train_fn``
#: refuses them loudly); none with torch 2.13.  ROADMAP.md section 3 lists
#: the ones an older DTensor refuses
REFUSED: set = set()
SPAWN_TIMEOUT = 300

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.configs import ShapeCell, get_config, reduced
from repro.data import DataConfig, make_batch
from repro.launch.train import make_train_step, shard_train_fn
from repro.models import build
from repro.optim import adamw, compression
from repro.runtime.activations import activation_policy, constrain
from repro.runtime.pipeline import pipelined_apply

out, batch, seq, steps, cases = sys.argv[1], *map(int, sys.argv[2:5]), sys.argv[5]
res = {}
pods = jax.make_mesh((4,), ("pod",))
g = jax.random.normal(jax.random.PRNGKey(0), (4, 2048)) * 0.01
def body(g, err):
    o, e = compression.compressed_psum(g[0], err[0], "pod")
    return o[None], e[None]
with jax.set_mesh(pods):
    fn = shard_map(body, mesh=pods, in_specs=(P("pod"), P("pod")), out_specs=(P("pod"), P("pod")))
    o, e = fn(g, jnp.zeros_like(g))
res["psum_out"], res["psum_err"] = np.asarray(o), np.asarray(e)

d = 16
w = jax.random.normal(jax.random.PRNGKey(0), (4, d, d)) / jnp.sqrt(d)
x = jax.random.normal(jax.random.PRNGKey(1), (8, d))
res["pipeline"] = np.asarray(pipelined_apply(pods, lambda p, x: jnp.tanh(x @ p["w"]), {"w": w}, x,
                                             pipe_axis="pod", n_micro=4))

# GSPMD's meshes (Auto axes): JAX 0.9's default Explicit axes refuse both
# with_sharding_constraint and the vocab-sharded embedding gather
auto = jax.make_mesh((2, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
import json
specs = []
for sp, gb, kind, shape in json.loads(cases):
    x = jnp.zeros(tuple(shape))
    with activation_policy(auto, sequence_parallel=sp, gather_boundary=gb):
        y = constrain(x, kind)
    specs.append(None if y is x else [list(e) if isinstance(e, tuple) else e for e in y.sharding.spec])
res["constrain"] = np.asarray(json.dumps(specs))

cfg = reduced(get_config("olmo-1b"))
api = build(cfg)
params = api.init_params(jax.random.PRNGKey(0))
opt = adamw.init(params)
dcfg = DataConfig(vocab=cfg.vocab, global_batch=batch, seq_len=seq)
cell = ShapeCell("t", seq, batch, "train")
b0 = jax.tree.map(jnp.asarray, make_batch(cfg, cell, dcfg, 0))
# 2x2, and 1x4: 4 query heads and 2 K/V heads over 4 model ranks
auto14 = jax.make_mesh((1, 4), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
for pre, m_ in (("", auto), ("m14_", auto14)):
    params = api.init_params(jax.random.PRNGKey(0))  # the step donates them
    opt = adamw.init(params)
    step = shard_train_fn(make_train_step(api, remat=True), m_, params, opt, b0)
    for s in range(steps):
        params, opt, m = step(params, opt, jax.tree.map(jnp.asarray, make_batch(cfg, cell, dcfg, s)))
        res[f"{pre}loss{s}"], res[f"{pre}grad_norm{s}"] = float(m["loss"]), float(m["grad_norm"])
    for i, leaf in enumerate(jax.tree.leaves(params)):
        res[f"{pre}param{i}"] = np.asarray(leaf)
np.savez(out, **res)
print("REFERENCE_OK")
"""


def _cases() -> list:
    return [[sp, gb, kind, list(shape)] for sp, gb in R.POLICIES
            for kind, shape in R.CONSTRAIN_CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and both spawns, run once for the module."""
    out = tmp_path_factory.mktemp("dist")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    for var in ("JAX_PLATFORMS", "TPU_SKIP_MDS_QUERY", "HOME"):
        if var in os.environ:
            env[var] = os.environ[var]
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(out / "ref.npz"), str(R.OLMO_BATCH),
         str(R.OLMO_SEQ), str(R.OLMO_STEPS_N), json.dumps(_cases())],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    try:
        cfg = reduced(get_config("olmo-1b"))
        jp = jax.tree.map(np.asarray, j_build(cfg).init_params(jax.random.PRNGKey(0)))
        dcfg = DataConfig(vocab=cfg.vocab, global_batch=R.OLMO_BATCH, seq_len=R.OLMO_SEQ)
        cell = ShapeCell("t", R.OLMO_SEQ, R.OLMO_BATCH, "train")
        batches = [j_make_batch(cfg, cell, dcfg, s) for s in range(R.OLMO_STEPS_N)]
        d = 16
        inputs = {
            "g": torch.from_numpy(np.array(
                jax.random.normal(jax.random.PRNGKey(0), (4, 2048)) * 0.01)),
            "w": torch.from_numpy(np.array(
                jax.random.normal(jax.random.PRNGKey(0), (4, d, d)) / jax.numpy.sqrt(d))),
            "x": torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(1), (8, d)))),
            "olmo": from_jax_params(jp),
            "batches": [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches],
            "qp": T.init_qparams(t_reduced(t_get_config("olmo-1b")), 0),
            "tokens": torch.from_numpy(np.random.default_rng(0).integers(
                0, cfg.vocab, (4, 16), dtype=np.int32)),
        }
        # (params, AdamW state) after the unsharded first step, and the second
        # batch: what the 8 ranks save, restore on 4 and step from
        api = t_build(t_reduced(t_get_config("olmo-1b")))
        p1 = tree_map(torch.clone, inputs["olmo"])
        p1, o1, _ = make_train_step(api, remat=True)(p1, TA.init(p1), inputs["batches"][0])
        inputs["ckpt_state"] = (p1, o1, inputs["batches"][1])
        torch.save(inputs, out / "inputs.pt")
        archs = [a for a in list_archs() if a != "olmo-1b"]
        spawn(R.world8, 8, str(out), archs, timeout=SPAWN_TIMEOUT, workdir=out)
        stdout, stderr = ref.communicate(timeout=SPAWN_TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert "REFERENCE_OK" in stdout, stderr[-3000:]
    a, b = (torch.load(out / f"rank{r}.pt", weights_only=False) for r in (0, 4))
    both = {**b, **a, "archs": {**a["archs"], **b["archs"]}}
    return {"ref": dict(np.load(out / "ref.npz")), "w4": both, "inputs": inputs, "w8": [a, b],
            "out": out}


def test_one_host_of_eight_ranks_sees_the_global_batch(runs):
    assert runs["w8"][0]["hosts"] == runs["w8"][1]["hosts"] == (1, 0)


def test_compressed_psum_bit_exact_with_reference(runs):
    out, err = runs["w4"]["psum"]
    np.testing.assert_array_equal(out.numpy(), runs["ref"]["psum_out"])
    np.testing.assert_array_equal(err.numpy(), runs["ref"]["psum_err"])
    g = runs["inputs"]["g"].numpy()
    want = g.sum(0)
    assert np.abs(out[0].numpy() - want).max() / np.abs(want).max() < 0.02  # int8 grid error
    assert all(torch.equal(out[0], o) for o in out)  # every rank holds the sum


def test_pipelined_apply_matches_reference_and_sequential(runs):
    got = runs["w4"]["pipeline"]
    assert all(torch.equal(got[0], y) for y in got)  # every rank holds the output
    np.testing.assert_allclose(got[0].numpy(), runs["ref"]["pipeline"], rtol=0, atol=1e-6)
    w, x = runs["inputs"]["w"], runs["inputs"]["x"]
    seq = x
    for s in range(4):
        seq = torch.tanh(seq @ w[s])
    assert float((got[0] - seq).abs().max()) < 1e-5


def test_fsdp_placement_on_2x2(runs):
    spec, local, pl = runs["w4"]["fsdp"]
    assert spec == P("data", "model") == ("data", "model")
    assert local == (4, 8)  # sharded both ways
    assert pl == ["Shard(dim=0)", "Shard(dim=1)"]


def test_constrain_placements_equal_reference(runs):
    from torch.distributed.tensor import Replicate

    ref = json.loads(str(runs["ref"]["constrain"]))
    mesh = type("M", (), {"axis_names": ("data", "model"), "shape": {"data": 2, "model": 2}})()
    got = runs["w4"]["constrain"]
    assert len(ref) == len(got) == len(R.POLICIES) * len(R.CONSTRAIN_CASES)
    n_moved = 0
    for (sp, gb, kind, shape), want in zip(_cases(), ref):
        have = got[((sp, gb), kind, tuple(shape))]
        if want is None:
            assert have is None, (sp, gb, kind, shape)
            continue
        spec = P(*[tuple(e) if isinstance(e, list) else e for e in want])
        assert have == placements(mesh, spec), (sp, gb, kind, shape, want, have)
        n_moved += any(p != Replicate() for p in have)
    assert n_moved >= 10


@pytest.mark.parametrize("vocab", R.NLL_VOCABS)
def test_vocab_parallel_token_nll_equals_the_gathered_loss(runs, vocab):
    """``token_nll`` of logits split over "data" (rows) and "model" (the
    vocab) on 2x2, or whole there, against ``token_nll`` of the whole
    logits: float32 sums in another order (loss rtol 1e-6, gradient rtol
    1e-5, atol 1e-12); on 1x1, the same ops: bit for bit.  The loss comes
    back replicated; the padded classes get no gradient."""
    from repro_torch.models import layers as L

    logits, labels = R.nll_inputs(vocab)
    x = logits.clone().requires_grad_(True)
    want = L.token_nll(x, labels, vocab)
    want.backward()
    got = runs["w4"]["vocab_nll"]
    for layout in R.NLL_LAYOUTS:
        loss, grad, pl = got[(vocab, layout)]
        assert pl == ["Replicate()"] * 2, layout
        np.testing.assert_allclose(loss.numpy(), want.detach().numpy(), rtol=1e-6,
                                   err_msg=layout)
        np.testing.assert_allclose(grad.numpy(), x.grad.numpy(), rtol=1e-5, atol=1e-12,
                                   err_msg=layout)
        assert not grad[..., vocab:].any(), layout
    loss, grad, _ = got[(vocab, "1x1")]
    assert torch.equal(loss, want.detach()) and torch.equal(grad, x.grad)


def _unsharded_olmo(inputs, microbatches):
    api = t_build(t_reduced(t_get_config("olmo-1b")))
    p = tree_map(torch.clone, inputs["olmo"])
    o = TA.init(p)
    step = make_train_step(api, microbatches=microbatches, remat=True)
    metrics = []
    for b in inputs["batches"]:
        p, o, m = step(p, o, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, p


def _hold(got_metrics, got_params, want_metrics, want_params, gnorm_rtol, what,
          tight_share=TIGHT_SHARE):
    for i, ((l1, g1), (l2, g2)) in enumerate(zip(got_metrics, want_metrics)):
        np.testing.assert_allclose(l1, l2, rtol=LOSS_RTOL, err_msg=f"{what} step {i}")
        np.testing.assert_allclose(g1, g2, rtol=gnorm_rtol, err_msg=f"{what} step {i}")
    diff = [np.abs(a - b) for a, b in zip(got_params, want_params)]
    steps = len(got_metrics)
    assert max(float(d.max()) for d in diff) <= 2 * LR * steps, what
    share = sum(int((d > TIGHT).sum()) for d in diff) / sum(d.size for d in diff)
    assert share <= tight_share, (what, share)


@pytest.mark.parametrize("case", R.OLMO_STEPS, ids=lambda c: (
    f"{c[0][0]}x{c[0][1]}-fsdp-mb{c[2]}{'-policy' if c[3] else ''}"))
def test_sharded_olmo_step_matches_unsharded(runs, case):
    shape, fsdp, mb, policy = case
    got = runs["w4"][("olmo", shape, fsdp, mb, policy)]
    assert got["misplaced"] == [], got["misplaced"]  # params and AdamW state on the rules
    assert got["step"] == R.OLMO_STEPS_N
    assert all(m[2] == ["Replicate()"] * 2 for m in got["metrics"])  # replicated metrics
    want_m, want_p = _unsharded_olmo(runs["inputs"], mb)
    leaves = lambda t: [x.numpy() for x in jax.tree.leaves(to_jax_layout(t))]  # noqa: E731
    _hold([m[:2] for m in got["metrics"]], leaves(got["params"]), want_m, leaves(want_p),
          GNORM_RTOL if mb == 1 else GNORM_RTOL_BF16_ACCUM, f"{shape} mb{mb}",
          TIGHT_SHARE if mb == 1 else TIGHT_SHARE_BF16_ACCUM)


@pytest.mark.parametrize("case", [c for c in R.OLMO_STEPS if c[2] == 1], ids=lambda c: (
    f"{c[0][0]}x{c[0][1]}-fsdp{'-policy' if c[3] else ''}"))
def test_sharded_olmo_step_matches_reference_sharded_step(runs, case):
    got = runs["w4"][("olmo", *case)]
    ref = runs["ref"]
    pre = "m14_" if case[0] == (1, 4) else ""  # the reference's step on the same mesh
    want_m = [(float(ref[f"{pre}loss{s}"]), float(ref[f"{pre}grad_norm{s}"]))
              for s in range(R.OLMO_STEPS_N)]
    n = sum(1 for k in ref if k.startswith(f"{pre}param"))
    want_p = [ref[f"{pre}param{i}"] for i in range(n)]
    got_p = [x.numpy() for x in jax.tree.leaves(to_jax_layout(got["params"]))]
    assert len(got_p) == n
    _hold([m[:2] for m in got["metrics"]], got_p, want_m, want_p, GNORM_RTOL, str(case))


@pytest.mark.parametrize("arch", [a for a in list_archs() if a != "olmo-1b"])
def test_every_arch_sharded_step_matches_or_is_refused(runs, arch):
    got = runs["w4"]["archs"][arch]
    if arch in REFUSED:
        assert "refused" in got and "cannot shard" in got["refused"], got
        return
    assert "refused" not in got, got.get("refused")
    np.testing.assert_allclose(*got["loss"], rtol=LOSS_RTOL, err_msg=arch)
    np.testing.assert_allclose(*got["grad_norm"], rtol=GNORM_RTOL, err_msg=arch)
    assert got["worst"] <= 2 * LR and got["share"] <= TIGHT_SHARE, (arch, got)


@pytest.mark.parametrize("arch", R.GQA_1X4)
def test_gqa_step_on_more_model_ranks_than_kv_heads(runs, arch):
    """4 query heads, 2 K/V heads, 4 model ranks: each rank attends with
    the K/V head its own query head uses."""
    got = runs["w4"]["gqa_1x4"][arch]
    assert "refused" not in got, got.get("refused")
    np.testing.assert_allclose(*got["loss"], rtol=LOSS_RTOL, err_msg=arch)
    np.testing.assert_allclose(*got["grad_norm"], rtol=GNORM_RTOL, err_msg=arch)
    assert got["worst"] <= 2 * LR and got["share"] <= TIGHT_SHARE, (arch, got)


@pytest.mark.parametrize("arch", [a for a in list_archs() if a != "olmo-1b"])
def test_no_op_of_a_sequence_parallel_step_sees_a_strided_shard(runs, arch):
    """torch 2.13 views two sharded dims as one by a ``_StridedShard``
    placement where torch 2.11 refuses (open fault 1): no op of the step
    may see one."""
    assert runs["w4"]["archs"][arch]["strided"] == []


def test_imatmul_of_dtensors_equals_the_unsharded_product(runs):
    from repro_torch.quant.qparams import imatmul

    a, w, prods = runs["w4"]["int8"]["imatmul"]
    want = imatmul(a, w)
    assert want.dtype == torch.int32
    for got in prods:  # columns split, contraction split (summed), rows split
        assert torch.equal(got, want)


def test_int8_prefill_and_decode_on_2x2_equal_the_unsharded_chain(runs):
    cfg = t_reduced(t_get_config("olmo-1b"))
    qp, tokens = runs["inputs"]["qp"], runs["inputs"]["tokens"]
    steps = len(runs["w4"]["int8"]["chain"]) - 1
    logits, cache = T.prefill_w8a8(cfg, qp, {"tokens": tokens}, tokens.shape[1] + steps + 1)
    want = [(logits, cache["k"], cache["v"])]
    for _ in range(steps):
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        logits, cache = T.decode_step_w8a8(cfg, qp, cache, tok)
        want.append((logits, cache["k"], cache["v"]))
    for i, (g, w) in enumerate(zip(runs["w4"]["int8"]["chain"], want)):
        for a, b in zip(g, w):
            assert torch.equal(a, b), f"call {i}"


def test_an_op_dtensor_cannot_shard_is_refused_loudly(runs):
    msg = runs["w4"]["custom_op"]
    assert msg is not None and msg.startswith("shard_train_fn: DTensor cannot shard"), msg
    assert "twice" in msg


def test_elastic_remesh_8_to_4_preserves_values(runs):
    rank0, rank4 = runs["w8"]
    assert rank0["mesh"] == ((4, 2), (2, 2), [0, 1, 2, 3])
    assert rank0["local"] == ((8, 4), (8, 4)) and rank0["placements"] == ["Replicate()",
                                                                          "Shard(dim=1)"]
    np.testing.assert_array_equal(rank0["values"].numpy(), np.arange(64.0).reshape(8, 8))
    assert "values" not in rank4 and rank4["local"][0] == (8, 4)  # rank 4 left the mesh


def test_mesh_builders_on_eight_ranks(runs):
    rank0 = runs["w8"][0]
    assert rank0["host_mesh"] == [(8, 1), (2, 4), (2, 2), (1, 1)]
    assert "(16, 16)" in rank0["production"] and "8" in rank0["production"]


def test_a_failing_rank_fails_the_spawn_and_no_process_is_left(tmp_path):
    import multiprocessing

    from torch.multiprocessing.spawn import ProcessRaisedException

    # the first rank to stop is reported: the failing one, or its peer,
    # whose barrier the failure broke
    with pytest.raises(ProcessRaisedException, match="fails on purpose|gloo"):
        spawn(R.fail_on, 2, 1, workdir=tmp_path, timeout=60)
    assert multiprocessing.active_children() == []


def test_sharded_steps_leave_no_tensor_in_a_reference_cycle(tmp_path):
    """Two reduced OLMo-1B steps through ``shard_train_fn`` on a 1x1 gloo
    mesh (plain, and 2 microbatches under FSDP): ``gc.collect()`` under
    ``gc.DEBUG_SAVEALL`` then finds no tensor among the unreachable
    objects, so a step's memory is freed when it returns."""
    spawn(R.unreachable_after_steps, 1, str(tmp_path / "gc.json"), workdir=tmp_path,
          timeout=SPAWN_TIMEOUT)
    got = json.loads((tmp_path / "gc.json").read_text())
    print(got)
    assert [g["case"] for g in got] == [list(c) for c in R.GC_STEPS]
    assert all(g["tensors"] == 0 for g in got), got


# ---------------------------------------------------------------------------
# sharded checkpoints
# ---------------------------------------------------------------------------


def _checked(res: dict) -> dict:
    assert "error" not in res, res["error"]
    return res


def _state_leaves(state):
    """The leaves of a (params, AdamWState) in the reference's layout, as numpy."""
    params, opt = state
    return [np.asarray(x) for x in jax.tree.leaves(
        (to_jax_layout(params), int(opt.step), to_jax_layout(opt.mu), to_jax_layout(opt.nu)))]


def _equal_states(a, b) -> bool:
    return all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(_state_leaves(a), _state_leaves(b), strict=True))


@pytest.mark.parametrize("half", [0, 1], ids=["A", "B"])
def test_supervised_sharded_restart_equals_the_uninterrupted_run(runs, half):
    got = _checked(runs["w8"][half]["restart"])
    assert got["failed"] == [R.RESTART["fail_at"]]
    # steps 0-2, the failure at 3, the replay from the save at step 2
    assert [h[0] for h in got["history"]] == [0, 1, 2, 2, 3]
    for s, loss, gnorm in got["history"]:
        assert (loss, gnorm) == got["plain"][s], s  # bit for bit
    assert got["latest"] == R.RESTART["steps"]
    assert int(got["state"][1].step) == R.RESTART["steps"]
    assert _equal_states(got["state"], got["plain_state"])


def test_sharded_save_writes_the_files_of_a_single_process(runs, tmp_path):
    got = _checked(runs["w4"]["restart"])
    root = runs["out"] / "restart"
    step = R.RESTART["steps"]
    assert sorted(os.listdir(root)) == ["LATEST", "step_2", f"step_{step}"]
    assert sorted(os.listdir(root / f"step_{step}")) == ["host0.npz", "manifest.json"]
    Checkpointer(str(tmp_path)).save(step, got["state"])  # no process group here
    want = tmp_path / f"step_{step}"
    assert (root / f"step_{step}" / "manifest.json").read_text() == \
        (want / "manifest.json").read_text()
    with np.load(root / f"step_{step}" / "host0.npz") as a, np.load(want / "host0.npz") as b:
        assert a.files == b.files and len(a.files) > 10
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_reference_checkpointer_loads_the_sharded_save(runs):
    got = _checked(runs["w4"]["restart"])
    params, opt = got["state"]
    numpy = lambda t: jax.tree.map(lambda x: x.numpy(), to_jax_layout(t))  # noqa: E731
    like = (numpy(params), JA.AdamWState(np.asarray(opt.step), numpy(opt.mu), numpy(opt.nu)))
    step, back = JCheckpointer(str(runs["out"] / "restart")).restore_latest(like)
    assert step == R.RESTART["steps"]
    want = jax.tree.leaves(like)
    assert len(jax.tree.leaves(back)) == len(want)
    for a, b in zip(jax.tree.leaves(back), want):
        assert np.asarray(a).dtype == b.dtype and np.array_equal(np.asarray(a), b)


def test_restore_on_fewer_ranks_places_the_saved_values_by_the_rules(runs):
    rank0, rank4 = (_checked(r["restore8to4"]) for r in runs["w8"])
    p1, o1, _ = runs["inputs"]["ckpt_state"]
    assert rank0["step"] == rank4["step"] == 1
    assert rank0["misplaced"] == rank4["misplaced"] == []
    assert rank0["placements"] == ["Replicate()", "Shard(dim=0)"]  # embed over "model"
    assert _equal_states(rank0["values"], (p1, o1))
    assert "values" not in rank4  # rank 4 left the mesh
    assert sorted(os.listdir(runs["out"] / "ckpt8" / "step_1")) == ["host0.npz",
                                                                    "manifest.json"]


def test_sharded_save_is_committed_when_it_returns(runs):
    """Rank 0 writes; rank 4, which does not, sees ``LATEST`` and the step's
    directory as soon as its ``save`` returns, with no ``wait()``."""
    for r in runs["w8"]:
        assert _checked(r["restore8to4"])["committed"] == {"latest": 1, "path": True}


@pytest.mark.parametrize("rank", [0, 4], ids=["writer", "not-writer"])
def test_sharded_save_holds_one_whole_leaf_at_a_time(runs, rank):
    """Each rank gathers every DTensor leaf whole, and frees it before the
    next: the whole leaves alive at once are never more than the largest."""
    got = _checked(runs["w8"][rank // 4]["restore8to4"])["whole_bytes"]
    p1, o1, _ = runs["inputs"]["ckpt_state"]
    assert got["total"] == sum(t.nbytes for t in jax.tree.leaves((p1, o1)))
    assert 0 < got["peak"] == got["largest"] < got["total"]


def test_next_step_after_restore_on_fewer_ranks_matches_unsharded(runs):
    got = _checked(runs["w8"][0]["restore8to4"])
    want_m, want_p = _unsharded_olmo(runs["inputs"], 1)  # its second step starts from p1, o1
    leaves = lambda t: [x.numpy() for x in jax.tree.leaves(to_jax_layout(t))]  # noqa: E731
    _hold([got["metrics"]], leaves(got["params"]), want_m[1:], leaves(want_p), GNORM_RTOL,
          "2x2 after the 8 -> 4 restore")
