"""The port's checkpointer (``repro_torch.checkpoint``) against the JAX package's.

Files interchange: the port writes the reference's keys (tree paths joined
by ``//``), manifest and layout (per-layer lists stacked to the leading
layer axis), so a ``(params, AdamWState)`` written by either package
restores in the other bit for bit, into the port's list layout or the
reference's stacked arrays.  bfloat16 leaves are stored as the reference
stores them (2-byte void, manifest dtype ``bfloat16``) and come back as
``torch.bfloat16`` in the port; the reference's own restore hands back the
void array, which ``jnp.asarray`` refuses (a fault of the reference,
asserted here as recorded).
"""

import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config, reduced
from repro.models import build as j_build
from repro.optim import adamw as JA
from repro_torch.checkpoint import Checkpointer
from repro_torch.convert import from_jax_params, to_jax_layout, tree_leaves
from repro_torch.optim import adamw as TA

ARCHS = ["olmo-1b", "granite-moe-3b-a800m", "seamless-m4t-large-v2"]


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((16, 8), generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32)}}


def _same(a, b):
    """Equal bit for bit, dtype included (torch or numpy leaves)."""
    a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else np.asarray(a)
    b = b.view(torch.int16).numpy() if getattr(b, "dtype", None) == torch.bfloat16 \
        else np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


class TestCheckpointer:
    """The JAX package's ``tests/test_substrates.py::TestCheckpointer``, spelled for the port."""

    def test_roundtrip(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        tree = _tree()
        ck.save(7, tree)
        assert ck.latest_step() == 7
        restored = ck.restore(7, tree)
        assert all(_same(a, b) for a, b in zip(tree_leaves(tree), tree_leaves(restored)))

    def test_async_save_then_restore(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        tree = _tree(1)
        ck.save_async(3, tree)
        ck.wait()
        step, restored = ck.restore_latest(tree)
        assert step == 3
        assert _same(restored["a"], tree["a"])

    def test_crash_mid_save_preserves_previous(self, tmp_path):
        """A stale .tmp dir must not corrupt LATEST."""
        ck = Checkpointer(str(tmp_path))
        tree = _tree(2)
        ck.save(1, tree)
        os.makedirs(os.path.join(str(tmp_path), "step_2.tmp999"), exist_ok=True)
        assert ck.latest_step() == 1
        _, restored = ck.restore_latest(tree)
        assert restored is not None

    def test_shape_mismatch_detected(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, _tree())
        bad = {"a": torch.zeros((4, 4)), "nested": {"b": torch.zeros(10, dtype=torch.int32)}}
        with pytest.raises(ValueError):
            ck.restore(1, bad)


def test_missing_leaf_and_no_checkpoint(tmp_path):
    ck = Checkpointer(str(tmp_path))
    assert ck.restore_latest(_tree()) == (None, None)
    ck.save(2, {"a": torch.zeros(3)})
    with pytest.raises(KeyError, match="missing leaf nested//b"):
        ck.restore(2, {"a": torch.zeros(3), "nested": {"b": torch.zeros(1)}})


def test_async_snapshot_is_taken_before_return(tmp_path):
    """The step after a save updates params in place: the saved values are
    those at the call, not those the writer thread finds later."""
    ck = Checkpointer(str(tmp_path))
    tree = _tree(3)
    want = tree["a"].clone()
    ck.save_async(1, tree)
    tree["a"].add_(1.0)  # the next step, in place
    ck.wait()
    assert _same(ck.restore(1, tree)["a"], want)


def _members(path) -> dict:
    """{name: bytes} of an npz's members (the zip's own timestamps left out)."""
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_without_a_process_group_the_files_are_a_single_process_save(tmp_path):
    """No process group: the port writes from its own process, the files
    the reference writes for the same tree, byte for byte (manifest,
    ``LATEST``, every array of the npz), mixed leaves included; but for
    the bfloat16 leaf's header, which names its 2-byte void ``|V2`` where
    the reference's names it ``<V2`` (the same dtype to ``np.load``)."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    g = torch.Generator().manual_seed(5)
    layers = [torch.randn((3, 4), generator=g) for _ in range(2)]
    b16 = torch.randn((2, 6), generator=g).to(torch.bfloat16)
    port = {"layers": [{"w": w} for w in layers], "b16": b16,
            "i": torch.arange(7, dtype=torch.int32), "n": np.linspace(0, 1, 5), "s": 3}
    ref = {"layers": {"w": jnp.asarray(torch.stack(layers).numpy())},
           "b16": jnp.asarray(b16.float().numpy()).astype(jnp.bfloat16),
           "i": jnp.arange(7, dtype=jnp.int32), "n": np.linspace(0, 1, 5), "s": 3}
    Checkpointer(str(tmp_path / "port")).save(5, port)
    JCheckpointer(str(tmp_path / "jax")).save(5, ref)
    for d in ("port", "jax"):
        assert sorted(os.listdir(tmp_path / d)) == ["LATEST", "step_5"]
        assert sorted(os.listdir(tmp_path / d / "step_5")) == ["host0.npz", "manifest.json"]
    for name in ("LATEST", "step_5/manifest.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    got, want = (_members(tmp_path / d / "step_5" / "host0.npz") for d in ("port", "jax"))
    assert sorted(got) == sorted(want) == ["b16.npy", "i.npy", "layers//w.npy", "n.npy", "s.npy"]
    b16_got, b16_want = got.pop("b16.npy"), want.pop("b16.npy")
    assert got == want
    assert b16_got == b16_want.replace(b"'<V2'", b"'|V2'", 1)


def test_bfloat16_roundtrip_in_the_port(tmp_path):
    ck = Checkpointer(str(tmp_path))
    g = torch.Generator().manual_seed(4)
    tree = {"w": torch.randn((5, 7), generator=g).to(torch.bfloat16),
            "layers": [{"x": torch.randn(3, generator=g).to(torch.bfloat16)} for _ in range(2)]}
    ck.save(1, tree)
    manifest = json.load(open(tmp_path / "step_1" / "manifest.json"))
    assert manifest["leaves"]["w"] == {"shape": [5, 7], "dtype": "bfloat16"}
    assert manifest["leaves"]["layers//x"] == {"shape": [2, 3], "dtype": "bfloat16"}
    with np.load(tmp_path / "step_1" / "host0.npz") as data:
        assert data["w"].dtype == np.dtype("V2")  # the reference's storage
    got = ck.restore(1, tree)
    assert got["w"].dtype == torch.bfloat16
    assert all(_same(a, b) for a, b in zip(tree_leaves(tree), tree_leaves(got)))


def test_reference_restore_of_bfloat16_is_the_recorded_fault(tmp_path):
    """``src/repro/checkpoint/checkpointer.py:121`` hands back the stored
    2-byte void array and never reads the manifest's dtype; the port reads
    the reference's file as bfloat16, bit for bit."""
    w = jnp.asarray(np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4), jnp.bfloat16)
    JCheckpointer(str(tmp_path)).save(1, {"w": w})
    back = JCheckpointer(str(tmp_path)).restore(1, {"w": w})
    assert back["w"].dtype == np.dtype("V2")
    with pytest.raises(TypeError, match="V2"):
        jnp.asarray(back["w"])
    got = Checkpointer(str(tmp_path)).restore(1, {"w": torch.zeros((3, 4), dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    assert np.array_equal(got["w"].view(torch.int16).numpy(),
                          np.asarray(w).view(np.int16))


def _reference_state(arch, steps=1):
    """The JAX package's (params, AdamWState) of the reduced ``arch`` after
    ``steps`` AdamW updates (moments and step non-trivial)."""
    api = j_build(reduced(get_config(arch)))
    params = api.init_params(jax.random.PRNGKey(0))
    state = JA.init(params)

    @jax.jit
    def update(params, state, i):
        grads = jax.tree.map(lambda p: jnp.sin(p * 3.0 + i), params)
        return JA.apply(grads, state, params, 1e-3)[:2]

    for i in range(steps):
        params, state = update(params, state, i)
    return params, state


def _port_state(params, state):
    numpy = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (from_jax_params(numpy(params)),
            TA.AdamWState(torch.tensor(int(state.step), dtype=torch.int32),
                          from_jax_params(numpy(state.mu)), from_jax_params(numpy(state.nu))))


def _stacked(tree):
    """The port's tree in the reference's layout, as numpy."""
    return jax.tree.map(lambda t: t.numpy(), to_jax_layout(tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_file_restores_into_the_port_layout(tmp_path, arch):
    jtree = _reference_state(arch)
    JCheckpointer(str(tmp_path)).save(5, jtree)
    like = _port_state(*jax.tree.map(jnp.zeros_like, jtree))
    step, got = Checkpointer(str(tmp_path)).restore_latest(like)
    assert step == 5
    assert isinstance(got[1], TA.AdamWState)
    assert isinstance(got[0]["layers" if "layers" in got[0] else "enc_layers"], list)
    want = _port_state(*jtree)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert all(_same(a, b) for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_file_restores_in_the_reference(tmp_path, arch):
    jtree = _reference_state(arch)
    Checkpointer(str(tmp_path)).save(5, _port_state(*jtree))
    step, got = JCheckpointer(str(tmp_path)).restore_latest(jtree)
    assert step == 5
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("arch", ["olmo-1b", "seamless-m4t-large-v2"])
def test_manifests_and_keys_equal_for_the_same_tree(tmp_path, arch):
    jtree = _reference_state(arch)
    JCheckpointer(str(tmp_path / "jax")).save(2, jtree)
    Checkpointer(str(tmp_path / "port")).save(2, _port_state(*jtree))
    texts = [open(tmp_path / d / "step_2" / "manifest.json").read() for d in ("jax", "port")]
    assert texts[0] == texts[1]
    keys = json.loads(texts[1])["leaves"]
    assert "1//step" in keys and any(k.startswith("1//mu//") for k in keys)
    with np.load(tmp_path / "jax" / "step_2" / "host0.npz") as a, \
            np.load(tmp_path / "port" / "step_2" / "host0.npz") as b:
        assert a.files == b.files
        assert all(np.array_equal(a[k], b[k]) for k in a.files)


def test_to_jax_layout_is_the_inverse_of_from_jax_params():
    params, _ = _reference_state("granite-moe-3b-a800m", steps=0)
    port = from_jax_params(jax.tree.map(np.asarray, params))
    back = _stacked(port)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    assert all(np.array_equal(a, np.asarray(b))
               for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)))
