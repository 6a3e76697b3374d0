"""The port's sharding rules, activation specs, elastic mesh plan and int8
gradient compression against the JAX package's, in one process.

The rules are the reference's table: for the params of every arch of the
registry (reduced; float and int8 layouts) the port's specs equal the
reference's, with the leading layer ``None`` dropped from a per-layer
leaf (the port keeps ``layers`` as a list).  ``sanitize_spec``,
``batch_shardings`` and ``cache_shardings`` read only the mesh's axis
sizes, so both packages run on meshes with no devices behind them (an
``AbstractMesh`` for the reference, a stub for the port) at 1x1, 2x2, 4x2
and 2x16x16.  ``compress`` / ``decompress`` are bit-exact.  The
multi-rank halves (placements, ``compressed_psum``, the pipeline, the
sharded step) are in ``test_torch_distributed.py``.
"""

import functools
import pickle
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config, list_archs, reduced
from repro.models import build as j_build
from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro.runtime import elastic as JE
from repro.runtime import sharding as JS
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import from_jax_params, from_jax_quantized, is_layer_list
from repro_torch.models import build as t_build
from repro_torch.optim import adamw as TA
from repro_torch.optim import compression as TC
from repro_torch.runtime import activations as TACT
from repro_torch.runtime import elastic as TE
from repro_torch.runtime import sharding as TS

MESHES = {"1x1": (1, 1), "2x2": (2, 2), "4x2": (4, 2), "2x16x16": (2, 16, 16)}


def _meshes(name):
    shape = MESHES[name]
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    stub = types.SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names)
    return AbstractMesh(shape, names), stub


def _spec(s) -> tuple:
    return tuple(s.spec if hasattr(s, "spec") else s)


def _ref_specs(tree):
    return jax.tree_util.tree_map(_spec, tree, is_leaf=lambda x: isinstance(x, NamedSharding))


def _stacked(tree):
    """The port's tree of specs in the reference's layout: each per-layer
    list becomes one spec with a leading ``None`` (every layer's spec must
    be the same; a replicated ``P()`` stays as it is)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if is_layer_list(k, v):
                out[k] = _stack(v)
            else:
                out[k] = _stacked(v)
        return out
    if isinstance(tree, list):
        return [_stacked(v) for v in tree]
    return _spec(tree)


def _stack(layers):
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lp[k] for lp in layers]) for k in first}
    if isinstance(first, list):
        return [_stack([lp[i] for lp in layers]) for i in range(len(first))]
    specs = {_spec(s) for s in layers}
    assert len(specs) == 1, specs
    spec = specs.pop()
    return (None, *spec) if spec else ()  # P(): replicated, in either layout


def _as_numpy(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the spec and its placements
# ---------------------------------------------------------------------------


def test_partition_spec_equals_reference_entry_by_entry():
    for entries in [(), (None,), ("model", None), (("pod", "data"), None, "model")]:
        assert TS.P(*entries) == tuple(JP(*entries)) == entries
    for entries in [(("data",), None), ((), "model"), (["pod", "data"],)]:
        assert TS.P(*entries) == tuple(JP(*entries))
    assert TS.P("a") != TS.P("b") and repr(TS.P(None, "model")) == "P(None, 'model')"
    spec = TS.P(("pod", "data"), None, "model")
    assert pickle.loads(pickle.dumps(spec)) == spec and type(pickle.loads(pickle.dumps(spec))) is TS.P


@pytest.mark.parametrize("spec,want", [
    ((None, "model"), ("R", "S1")),
    (("data", "model"), ("S0", "S1")),
    (("model", None), ("R", "S0")),
    ((), ("R", "R")),
    ((("pod", "data"), None), ("S0", "S0", "R")),
    ((None, ("data", "model")), ("S1", "S1")),
])
def test_placements_of_a_spec(spec, want):
    from torch.distributed.tensor import Replicate, Shard

    names = ("pod", "data", "model") if len(want) == 3 else ("data", "model")
    mesh = types.SimpleNamespace(shape=dict.fromkeys(names, 2), axis_names=names)
    exp = tuple(Replicate() if w == "R" else Shard(int(w[1])) for w in want)
    assert TS.placements(mesh, TS.P(*spec)) == exp
    ones = types.SimpleNamespace(shape=dict.fromkeys(names, 1), axis_names=names)
    assert TS.placements(ones, TS.P(*spec)) == (Replicate(),) * len(names)  # splits nothing


# ---------------------------------------------------------------------------
# parameter rules, every arch
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _param_pair(arch, layout):
    cfg = reduced(get_config(arch))
    japi = j_build(cfg)
    key = jax.random.PRNGKey(0)
    if layout == "float":
        jp = _as_numpy(japi.init_params(key))
        return jp, from_jax_params(jp, device="meta")
    if cfg.family == "encoder":  # its int8 params come from the float ones (PTQ)
        from repro.models.encoder import quantize_params

        jp = _as_numpy(quantize_params(cfg, japi.init_params(key)))
    else:
        jp = _as_numpy(japi.init_serve_params(key))
    return jp, from_jax_quantized(jp, device="meta")


@pytest.mark.parametrize("layout", ["float", "int8"])
@pytest.mark.parametrize("arch", list_archs())
def test_spec_for_param_equals_reference(arch, layout):
    """``spec_for_param`` on the reference's own paths and dims, and
    ``leaf_spec`` on the port's per-layer leaves."""
    jp, tp = _param_pair(arch, layout)
    for fsdp in (False, True):
        want = jax.tree_util.tree_map_with_path(
            lambda path, leaf: tuple(JS.spec_for_param(JS._path_str(path), np.ndim(leaf), fsdp)),
            jp)
        same = jax.tree_util.tree_map_with_path(
            lambda path, leaf: TS.spec_for_param(JS._path_str(path), np.ndim(leaf), fsdp), jp)
        assert same == want, (arch, layout, fsdp)
        got = TS._map_with_path(lambda path, leaf: TS.leaf_spec(path, leaf.ndim, fsdp), tp)
        assert _stacked(got) == want, (arch, layout, fsdp)


@pytest.mark.parametrize("layout", ["float", "int8"])
@pytest.mark.parametrize("mesh", ["2x2", "4x2", "2x16x16"])
def test_param_shardings_equal_reference(mesh, layout):
    jmesh, tmesh = _meshes(mesh)
    for arch in list_archs():
        jp, tp = _param_pair(arch, layout)
        for fsdp in (False, True):
            want = _ref_specs(JS.param_shardings(jmesh, jp, fsdp=fsdp))
            got = _stacked(TS.param_shardings(tmesh, tp, fsdp=fsdp))
            assert got == want, (arch, mesh, layout, fsdp)


def test_opt_state_shardings_mirror_the_params():
    jmesh, tmesh = _meshes("2x2")
    cfg = reduced(get_config("olmo-1b"))
    jp = _as_numpy(j_build(cfg).init_params(jax.random.PRNGKey(0)))
    tp = from_jax_params(jp)
    jsh = JS.param_shardings(jmesh, jp, fsdp=True)
    tsh = TS.param_shardings(tmesh, tp, fsdp=True)
    want = JS.opt_state_shardings(jmesh, JA.init(jp), jsh)
    got = TS.opt_state_shardings(tmesh, TA.init(tp), tsh)
    assert type(got).__name__ == type(want).__name__ == "AdamWState"
    assert _spec(got.step) == _spec(want.step) == ()
    assert _stacked(got.mu) == _ref_specs(want.mu) == _stacked(got.nu) == _ref_specs(want.nu)


# ---------------------------------------------------------------------------
# sanitize_spec, batches and caches, four meshes
# ---------------------------------------------------------------------------

SPECS = [
    (("data", "model"), (8, 16)), (("data", "model"), (1, 16)), (("model", None), (3, 32)),
    ((("pod", "data"), None), (64, 8)), ((("pod", "data"), None), (16, 8)),
    ((None, ("data", "model")), (5, 512)), (("model",), (0,)), (("data", None, "model"), (4,)),
]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sanitize_spec_equals_reference(mesh):
    jmesh, tmesh = _meshes(mesh)
    names = set(tmesh.axis_names)
    n = 0
    for spec, shape in SPECS:
        axes = {a for e in spec if e for a in (e if isinstance(e, tuple) else (e,))}
        if axes <= names:
            assert TS.sanitize_spec(tmesh, TS.P(*spec), shape) == tuple(
                JS.sanitize_spec(jmesh, JP(*spec), shape)), (spec, shape)
            n += 1
    assert n >= 6
    assert TS.data_axes(tmesh) == JS.data_axes(jmesh)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_shardings_equal_reference(mesh):
    jmesh, tmesh = _meshes(mesh)
    for b in (1, 2, 4, 8, 32, 64):
        batch = {"tokens": np.zeros((b, 16), np.int32), "labels": np.zeros((b, 16), np.int32),
                 "patches": np.zeros((b, 4, 8), np.float32), "step": np.zeros((), np.int32)}
        want = _ref_specs(JS.batch_shardings(jmesh, batch))
        got = TS._map_with_path(lambda _, s: _spec(s), TS.batch_shardings(tmesh, batch))
        assert got == want, (mesh, b)


def _cache_pair(arch, batch, max_len):
    cfg = reduced(get_config(arch))
    jc = jax.eval_shape(j_build(cfg).init_cache_shape(batch, max_len))
    tc = t_build(t_reduced(t_get_config(arch))).init_cache_shape(batch, max_len)(device="meta")
    return jc, tc


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_shardings_equal_reference(mesh):
    jmesh, tmesh = _meshes(mesh)
    for arch in list_archs():
        if reduced(get_config(arch)).family == "encoder":
            continue  # encoders keep no cache
        for batch, max_len in ((1, 64), (4, 32), (32, 512)):
            jc, tc = _cache_pair(arch, batch, max_len)
            for seq_shard in (False, True):
                want = _ref_specs(JS.cache_shardings(jmesh, jc, seq_shard=seq_shard))
                got = TS._map_with_path(lambda _, s: _spec(s),
                                        TS.cache_shardings(tmesh, tc, seq_shard=seq_shard))
                assert got == want, (arch, mesh, batch, max_len, seq_shard)


def test_synthetic_cache_leaves_equal_reference():
    """Every leaf name the rules know (k/v/ck/cv, conv, ssm, len) and one
    they do not, at shapes that divide and shapes that do not."""
    for mesh in MESHES:
        jmesh, tmesh = _meshes(mesh)
        for b, h, s in ((32, 16, 64), (1, 3, 5), (2, 32, 512)):
            leaves = {"k": (2, b, h, s, 8), "v": (2, b, h, s, 8), "ck": (2, b, h, s, 8),
                      "cv": (2, b, h, s, 8), "conv": (2, b, 4, 16 * h), "ssm": (2, b, h, 8, 4),
                      "len": (), "other": (b, h)}
            cache = {"dec": {k: np.zeros(v, np.int8) for k, v in leaves.items()}}
            for seq_shard in (False, True):
                want = _ref_specs(JS.cache_shardings(jmesh, cache, seq_shard=seq_shard))
                got = TS._map_with_path(lambda _, s: _spec(s),
                                        TS.cache_shardings(tmesh, cache, seq_shard=seq_shard))
                assert got == want, (mesh, b, h, s, seq_shard)


# ---------------------------------------------------------------------------
# activation specs (the placements on ranks are in test_torch_distributed)
# ---------------------------------------------------------------------------


def test_constrain_outside_a_policy_returns_its_argument():
    x = torch.zeros(4, 8, 16)
    for kind in ("residual", "gathered", "heads", "ssd", "ssd_l", "tokens", "experts", "foo"):
        assert TACT.constrain(x, kind) is x
    assert TACT.active_mesh() is None


def test_policy_nests_and_restores():
    _, outer = _meshes("2x2")
    _, inner = _meshes("2x16x16")
    with TACT.activation_policy(outer):
        with TACT.activation_policy(inner, sequence_parallel=False):
            assert TACT.active_mesh() is inner
            assert TACT.spec_for((64, 32, 8), "residual") == (("pod", "data"), None, None)
        assert TACT.active_mesh() is outer
        assert TACT.spec_for((4, 8, 16), "residual") == ("data", "model", None)
    assert TACT.active_mesh() is None


# ---------------------------------------------------------------------------
# elastic plan, compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,mp", [(8, 2), (4, 2), (7, 2), (16, 16), (512, 16), (3, 1), (5, 5)])
def test_plan_mesh_equals_reference(n, mp):
    assert TE.plan_mesh(n, mp) == JE.plan_mesh(n, mp)
    assert TE.plan_mesh(n, mp, ("pod", "x")) == JE.plan_mesh(n, mp, ("pod", "x"))


def test_plan_mesh_refuses_as_reference():
    with pytest.raises(ValueError) as t:
        TE.plan_mesh(1, 2)
    with pytest.raises(ValueError) as j:
        JE.plan_mesh(1, 2)
    assert str(t.value) == str(j.value)


def _grads(shape, seed, scale=0.01):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(shape) * scale).astype(np.float32)
    err = (rng.standard_normal(shape) * scale * 1e-2).astype(np.float32)
    return g, err


@pytest.mark.parametrize("shape", [(4, 2048), (3000,), (7, 5, 11), (1024,), (1,)])
def test_compress_decompress_bit_exact(shape):
    g, err = _grads(shape, seed=len(shape))
    g.reshape(-1)[: min(g.size, 1024)] = 0.0  # a zero block: the 1e-12 floor
    if g.size > 1024:
        g.reshape(-1)[1024] = 127.0 * 0.5  # a tie at the top of the grid
    err.reshape(-1)[: min(g.size, 1024)] = 0.0
    jq, js, je = (np.asarray(a) for a in JC.compress(jax.numpy.asarray(g), jax.numpy.asarray(err)))
    tq, ts, te = (a.numpy() for a in TC.compress(torch.from_numpy(g), torch.from_numpy(err)))
    assert tq.dtype == jq.dtype == np.int8 and ts.dtype == js.dtype == np.float32
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(te, je)
    pad = (-g.size) % TC.BLOCK
    assert TC.BLOCK == JC.BLOCK
    want = np.asarray(JC.decompress(jax.numpy.asarray(jq), jax.numpy.asarray(js), shape, pad))
    got = TC.decompress(torch.from_numpy(tq), torch.from_numpy(ts), shape, pad).numpy()
    np.testing.assert_array_equal(got, want)


def test_compress_of_bfloat16_gradients_bit_exact():
    g, err = _grads((2, 1500), seed=7)
    jg = jax.numpy.asarray(g).astype(jax.numpy.bfloat16)
    tg = torch.from_numpy(np.array(jg.astype(jax.numpy.float32))).to(torch.bfloat16)
    want = [np.asarray(a) for a in JC.compress(jg, jax.numpy.asarray(err))]
    got = [a.numpy() for a in TC.compress(tg, torch.from_numpy(err))]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_compressed_psum_needs_a_group_or_a_policy():
    g = torch.zeros(8)
    with pytest.raises(ValueError, match="activation_policy"):
        TC.compressed_psum(g, torch.zeros_like(g), "pod")
