"""The port's model zoo: the twin of ``tests/test_models_smoke.py``, and its
configs, registry and input specs against the JAX package's.

* every arch of the port's ``list_archs()``: one float forward and
  training loss on the reduced config with finite gradients through plain
  autograd (the training step, ``launch.train.make_train_step``, is held
  against the JAX package's in ``tests/test_torch_train.py``), and where
  the family decodes,
  ``init_serve_params`` -> ``prefill`` (64 positions) -> ``decode_step``
  with finite logits and a cache of 65 rows;
* each config, full and reduced, equal to the JAX package's field by
  field; the registry's name tuples equal;
* ``input_specs`` equal to the JAX package's (shape and dtype of every
  input) for every (arch, shape cell), and ``shape_applicable`` too.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.models.model_zoo import input_specs as j_specs
from repro_torch.models import build, input_specs, synthesize_batch
from repro_torch.models.model_zoo import TensorSpec

SMOKE_CELL = TC.ShapeCell("smoke", 64, 2, "train")
ARCHS = TC.list_archs()
DTYPES = {jnp.int32: torch.int32, jnp.int8: torch.int8, jnp.bfloat16: torch.bfloat16,
          jnp.float32: torch.float32}


def test_registry_equals_reference():
    assert TC.list_archs() == JC.list_archs()
    assert TC.ASSIGNED_ARCHS == JC.ASSIGNED_ARCHS and len(TC.ASSIGNED_ARCHS) == 10
    assert TC.PAPER_MODELS == JC.PAPER_MODELS
    assert [c.name for c in TC.ALL_SHAPES] == [c.name for c in JC.ALL_SHAPES]
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_config("gpt-2")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    want, got = JC.get_config(arch), TC.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(TC.reduced(got)) == dataclasses.asdict(JC.reduced(want))
    assert got.vocab_padded == want.vocab_padded and got.has_decoder == want.has_decoder


@pytest.mark.parametrize("cell", [c.name for c in JC.ALL_SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch, cell):
    jcell = next(c for c in JC.ALL_SHAPES if c.name == cell)
    tcell = next(c for c in TC.ALL_SHAPES if c.name == cell)
    cfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    want = j_specs(cfg, jcell)
    got = input_specs(tcfg, tcell)
    assert list(got) == list(want)
    for name, spec in want.items():
        assert got[name] == TensorSpec(tuple(spec.shape), DTYPES[spec.dtype.type]), name
    assert build(tcfg).input_specs(tcell) == got
    assert TC.shape_applicable(tcfg, tcell) == JC.shape_applicable(cfg, jcell)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_train_step(arch):
    cfg = TC.reduced(TC.get_config(arch))
    api = build(cfg)
    params = api.init_params(0, device="cpu")
    leaves = [t for t in _leaves(params) if t.is_floating_point()]
    for t in leaves:
        t.requires_grad_(True)
    batch = synthesize_batch(cfg, SMOKE_CELL, seed=0, device="cpu")
    loss = api.loss_fn(params, batch)
    assert torch.isfinite(loss), (arch, float(loss))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert all(g is None or bool(torch.isfinite(g).all()) for g in grads), arch
    assert sum(g is not None and bool(g.abs().sum() > 0) for g in grads) > len(leaves) // 2
    with torch.no_grad():
        out = api.forward(params, batch)
    assert bool(torch.isfinite(out).all()) and out.dim() == 3 and out.shape[0] == 2


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("arch", [a for a in ARCHS if TC.get_config(a).has_decoder])
def test_serve_prefill_decode(arch):
    cfg = TC.reduced(TC.get_config(arch))
    api = build(cfg)
    sp = api.init_serve_params(1, device="cpu")
    batch = synthesize_batch(cfg, TC.ShapeCell("smoke_prefill", 64, 2, "prefill"), seed=1,
                             device="cpu")
    logits, cache = api.prefill(sp, batch, max_len=96)
    assert bool(torch.isfinite(logits).all()), arch
    logits2, cache = api.decode_step(sp, cache, torch.zeros((2, 1), dtype=torch.int32))
    assert bool(torch.isfinite(logits2.float()).all()), arch
    assert int(cache["len"]) == 65, (arch, int(cache["len"]))
    assert tuple(logits2.shape) == (2, 1, cfg.vocab_padded)
    empty = api.init_cache_shape(2, 96)(device="cpu")
    assert set(empty) == set(cache) and int(empty["len"]) == 0


def test_serve_params_dtypes_and_devices(monkeypatch):
    """int8 where the technique applies, bfloat16 for the ssm / hybrid
    trunks (as the JAX package); the default device is the card, and
    without one the call raises instead of drawing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch, want in [("granite-moe-3b-a800m", torch.int8), ("mamba2-370m", torch.bfloat16),
                       ("seamless-m4t-large-v2", torch.int8)]:
        api = build(TC.reduced(TC.get_config(arch)))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.init_serve_params(0)
        sp = api.init_serve_params(0, device="cpu")
        dtypes = {t.dtype for t in _leaves(sp)}
        assert want in dtypes and all(t.device.type == "cpu" for t in _leaves(sp))
    hybrid = build(TC.reduced(TC.get_config("zamba2-2.7b"))).init_serve_params(0, device="cpu")
    assert hybrid["params"]["embed"]["table"].dtype == torch.bfloat16
    assert hybrid["qshared"]["wqkv"]["w_q"].dtype == torch.int8
    assert build(TC.reduced(TC.get_config("mobilebert"))).init_serve_params(0) is None


def test_synthesize_batch_is_seeded():
    cfg = TC.reduced(TC.get_config("seamless-m4t-large-v2"))
    cell = TC.ShapeCell("p", 64, 2, "prefill")
    a = synthesize_batch(cfg, cell, seed=3, device="cpu")
    b = synthesize_batch(cfg, cell, seed=3, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["frames"].dtype == torch.int8 and tuple(a["frames"].shape) == (2, 16, 128)
    assert int(a["tokens"].max()) < cfg.vocab
    np.testing.assert_array_equal(sorted(a), sorted(j_specs(JC.reduced(JC.get_config(
        "seamless-m4t-large-v2")), JC.ShapeCell("p", 64, 2, "prefill"))))
