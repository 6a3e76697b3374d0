"""The port's data pipeline (``repro_torch.data``) against the JAX package's.

Batches are drawn by numpy from the same ``default_rng((seed, step,
process))`` in both packages, so they must be equal bit for bit, for every
arch of the registry (its reduced config), every family's inputs, and any
step.  The process index comes from ``torch.distributed`` in the port and
from ``jax.process_index()`` in the reference: a shard of a two-process
run is checked with both faked.  A JAX process is a host; torch ranks on
one host (``LOCAL_WORLD_SIZE`` of them) share its shard, so four ranks of
one host see the reference's single-process global batch, for every arch.
"""

import numpy as np
import pytest

import repro.data.pipeline as J
from repro.configs import ShapeCell, get_config, list_archs, reduced
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import list_archs as t_list_archs
from repro_torch.configs import reduced as t_reduced
from repro_torch.data import DataConfig, PrefetchIterator, make_batch
from repro_torch.data import pipeline as T


def _pair(arch, batch=4, seq=64):
    cfg, tcfg = reduced(get_config(arch)), t_reduced(t_get_config(arch))
    cell = ShapeCell("t", seq, batch, "train")
    jd = J.DataConfig(vocab=cfg.vocab, global_batch=batch, seq_len=seq)
    td = DataConfig(vocab=tcfg.vocab, global_batch=batch, seq_len=seq)
    return (cfg, cell, jd), (tcfg, cell, td)


def test_registry_is_the_references():
    assert t_list_archs() == list_archs()


@pytest.mark.parametrize("step", [0, 17])
@pytest.mark.parametrize("arch", list_archs())
def test_make_batch_equals_reference(arch, step):
    (cfg, cell, jd), (tcfg, _, td) = _pair(arch)
    want = J.make_batch(cfg, cell, jd, step)
    got = make_batch(tcfg, cell, td, step)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (arch, k)


@pytest.mark.parametrize("arch", ["olmo-1b", "llava-next-34b", "seamless-m4t-large-v2"])
def test_full_config_shapes_equal_reference(arch):
    """The full configs' inputs (llava's patches, seamless' frames) at a
    small batch: the same keys, shapes and values."""
    cfg, tcfg = get_config(arch), t_get_config(arch)
    cell = ShapeCell("t", 128, 1, "train")
    want = J.make_batch(cfg, cell, J.DataConfig(vocab=cfg.vocab, global_batch=1), 3)
    got = make_batch(tcfg, cell, DataConfig(vocab=tcfg.vocab, global_batch=1), 3)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_process_shard_equals_reference(monkeypatch):
    """Rank 1 of 2: half the global batch, drawn from the rank's stream."""
    (cfg, cell, jd), (tcfg, _, td) = _pair("olmo-1b")
    monkeypatch.setattr(J.jax, "process_count", lambda: 2)
    monkeypatch.setattr(J.jax, "process_index", lambda: 1)
    monkeypatch.setattr(T.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(T.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(T.dist, "get_rank", lambda: 1)
    want = J.make_batch(cfg, cell, jd, 5)
    got = make_batch(tcfg, cell, td, 5)
    assert got["tokens"].shape == (2, 64)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert T._host_slice(4) == (2, 2)


def _fake_world(monkeypatch, world, rank, per_host):
    monkeypatch.setattr(T.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(T.dist, "get_world_size", lambda: world)
    monkeypatch.setattr(T.dist, "get_rank", lambda: rank)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(per_host))


@pytest.mark.parametrize("arch", list_archs())
def test_ranks_of_one_host_see_the_reference_global_batch(monkeypatch, arch):
    """A 2x2 mesh on one host: each of the 4 ranks draws the reference's
    single-process batch (the mesh places it)."""
    (cfg, cell, jd), (tcfg, _, td) = _pair(arch)
    want = J.make_batch(cfg, cell, jd, 3)
    for rank in range(4):
        _fake_world(monkeypatch, 4, rank, 4)
        assert (T.process_count(), T.process_index()) == (1, 0)
        got = make_batch(tcfg, cell, td, 3)
        assert all(np.array_equal(got[k], want[k]) for k in want), (arch, rank)


def test_two_hosts_of_two_ranks_shard_as_two_processes(monkeypatch):
    """World 4, 2 ranks a host: rank 3 is on host 1 of 2, and draws the
    reference's second process's half."""
    (cfg, cell, jd), (tcfg, _, td) = _pair("olmo-1b")
    monkeypatch.setattr(J.jax, "process_count", lambda: 2)
    monkeypatch.setattr(J.jax, "process_index", lambda: 1)
    _fake_world(monkeypatch, 4, 3, 2)
    assert (T.process_count(), T.process_index()) == (2, 1)
    want = J.make_batch(cfg, cell, jd, 5)
    got = make_batch(tcfg, cell, td, 5)
    assert got["tokens"].shape == (2, 64)
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_single_process_without_a_group():
    assert T.process_count() == 1 and T.process_index() == 0


def test_deterministic_replay():
    (_, _, _), (cfg, cell, dcfg) = _pair("olmo-1b")
    a = make_batch(cfg, cell, dcfg, step=17)
    b = make_batch(cfg, cell, dcfg, step=17)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = make_batch(cfg, cell, dcfg, step=18)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_prefetch_iterator():
    cfg = t_reduced(t_get_config("olmo-1b"))
    cell = ShapeCell("t", 32, 2, "train")
    dcfg = DataConfig(vocab=cfg.vocab, global_batch=2, seq_len=32)
    it = PrefetchIterator(cfg, cell, dcfg, start_step=3)
    try:
        for want_step in (3, 4, 5):
            step, batch = next(it)
            assert step == want_step
            np.testing.assert_array_equal(batch["tokens"],
                                          make_batch(cfg, cell, dcfg, step)["tokens"])
    finally:
        it.close()
    it.thread.join(timeout=5)
    assert not it.thread.is_alive()
