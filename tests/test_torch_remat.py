"""``remat`` of the mamba2, zamba2 and encoder-decoder float forwards, and
the last keywords of the reference's core API, against the JAX package.

* ``remat=True`` checkpoints each layer body (``torch.utils.checkpoint``,
  non-reentrant; zamba2: a trunk layer with its shared-attention site;
  encdec: both stacks), as the reference's ``jax.checkpoint`` of its scan
  body: the loss and every gradient equal those without remat bit for bit
  on the CPU, and fewer bytes are saved for the backward pass (counted by
  ``torch.autograd.graph.saved_tensors_hooks``);
* the reference's ``forward(..., remat=True)`` equals the port's within
  ``tests/test_torch_families.py``'s ``MODEL`` (rtol 1e-4, atol 2e-5);
* ``DispatchTable.kinds()`` of the default tables are equal, and
  ``flash_block_update(luts=)`` with the reference's tables equals the
  call that builds its own, and the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeCell, get_config, reduced
from repro.core import heterogeneous as JH
from repro.core import itamax as JI
from repro.models import encdec as JED
from repro.models import mamba2 as JMB
from repro.models import zamba2 as JZ
from repro.models.model_zoo import input_specs as j_specs
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import to_jax_layout, tree_leaves, tree_map
from repro_torch.core import heterogeneous as TH
from repro_torch.core import itamax as TI
from repro_torch.models import build as t_build
from repro_torch.models import encdec as TED
from repro_torch.models import mamba2 as TMB
from repro_torch.models import zamba2 as TZ

MODEL = dict(rtol=1e-4, atol=2e-5)
#: arch -> (the reference's module, the port's)
MODULES = {"mamba2-370m": (JMB, TMB), "zamba2-2.7b": (JZ, TZ),
           "seamless-m4t-large-v2": (JED, TED)}
SEQ, BATCH = 32, 2


def _params(tcfg, seed: int):
    """The port's params drawn from ``seed``, and the same values in the
    reference's stacked layout."""
    tparams = t_build(tcfg).init_params(seed, device="cpu")
    return tparams, jax.tree.map(lambda t: jnp.asarray(t.numpy()), to_jax_layout(tparams))


@pytest.fixture(scope="module", params=list(MODULES))
def family(request):
    """The reduced arch's params in both packages and one seeded batch."""
    arch = request.param
    cfg, tcfg = reduced(get_config(arch)), t_reduced(t_get_config(arch))
    tparams, params = _params(tcfg, 0)
    rng = np.random.default_rng(0)
    batch = {}
    for name, spec in j_specs(cfg, ShapeCell("t", SEQ, BATCH, "train"), jnp.float32).items():
        if spec.dtype == jnp.int32:
            batch[name] = rng.integers(0, cfg.vocab, spec.shape).astype(np.int32)
        else:
            batch[name] = rng.standard_normal(spec.shape).astype(np.float32)
    f = {"arch": arch, "cfg": cfg, "tcfg": tcfg, "params": params, "batch": batch,
         "tparams": tparams, "tbatch": {k: torch.from_numpy(v) for k, v in batch.items()}}
    f["runs"] = {remat: _loss_grads_saved(f, remat) for remat in (False, True)}
    return f


def _loss_grads_saved(f, remat: bool):
    """(loss, grads, bytes saved for backward) of the port's loss_fn."""
    mod = MODULES[f["arch"]][1]
    live = tree_map(lambda p: p.detach().requires_grad_(True), f["tparams"])
    saved = 0

    def pack(t):
        nonlocal saved
        saved += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = mod.loss_fn(f["tcfg"], live, f["tbatch"], remat=remat)
    grads = torch.autograd.grad(loss, list(tree_leaves(live)), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), grads, saved


def test_remat_loss_and_grads_bit_exact(family):
    (loss, grads, _), (loss_r, grads_r, _) = family["runs"][False], family["runs"][True]
    assert torch.equal(loss, loss_r)
    assert len(grads) == len(grads_r)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_r))
    assert any(bool(g.abs().max() > 0) for g in grads)


def test_remat_saves_fewer_bytes(family):
    plain, remat = family["runs"][False][2], family["runs"][True][2]
    assert 0 < remat < plain, (remat, plain)


def test_reference_remat_forward_equals_port(family):
    jmod, tmod = MODULES[family["arch"]]
    cfg = family["cfg"]
    want = jax.jit(lambda p, b: jmod.forward(cfg, p, b, remat=True))(
        family["params"], {k: jnp.asarray(v) for k, v in family["batch"].items()})
    got = tmod.forward(family["tcfg"], family["tparams"], family["tbatch"], remat=True)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MODEL)


def test_encode_remat_keyword_equals_reference():
    cfg, tcfg = reduced(get_config("seamless-m4t-large-v2")), \
        t_reduced(t_get_config("seamless-m4t-large-v2"))
    tparams, params = _params(tcfg, 1)
    frames = np.random.default_rng(1).standard_normal((BATCH, 16, cfg.d_model)) \
        .astype(np.float32)
    want = JED.encode(cfg, params, jnp.asarray(frames), remat=True)
    got = TED.encode(tcfg, tparams, torch.from_numpy(frames), remat=True)
    plain = TED.encode(tcfg, tparams, torch.from_numpy(frames))
    assert torch.equal(got, plain)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)


def test_dispatch_table_kinds_equal_reference():
    want = JH.populate_default_table(JH.DispatchTable()).kinds()
    got = TH.populate_default_table(TH.DispatchTable()).kinds()
    assert got == want and isinstance(got, set) and "gemm" in got
    assert TH.DispatchTable().kinds() == set()


@pytest.mark.parametrize("masked", [False, True])
def test_flash_block_update_with_the_references_luts(masked):
    rng = np.random.default_rng(8)
    luts = (np.array(JI.exp_lut7()), np.array(JI.renorm_lut()))
    sj, st, st_l = JI.flash_init((4, 8), 16), TI.flash_init((4, 8), 16), \
        TI.flash_init((4, 8), 16)
    v = rng.integers(-128, 128, size=(4, 100, 16)).astype(np.int8)
    for i in range(4):  # rising maxima: every block renormalizes
        lg = np.clip(rng.integers(-128, 100, size=(4, 8, 100)) + 7 * i, -128, 127) \
            .astype(np.int8)
        mask = rng.random((4, 8, 100)) > 0.2 if masked else None
        tm = None if mask is None else torch.from_numpy(mask)
        sj = jax.jit(JI.flash_block_update)(sj, jnp.asarray(lg), v, mask,
                                           luts=tuple(jnp.asarray(t) for t in luts))
        st = TI.flash_block_update(st, torch.from_numpy(lg), torch.from_numpy(v), tm)
        st_l = TI.flash_block_update(st_l, torch.from_numpy(lg), torch.from_numpy(v), tm,
                                     luts=luts)
        for a, b, c in zip(sj, st, st_l):
            assert torch.equal(b, c)
            assert np.array_equal(np.asarray(a), c.numpy())
    assert torch.equal(TI.flash_finalize_q77(st_l), TI.flash_finalize_q77(st))


@pytest.mark.parametrize("dt", [np.int64, np.float64])
def test_flash_block_update_takes_given_luts_as_int32(dt):
    """Tables of another type do not change the arithmetic's type."""
    rng = np.random.default_rng(9)
    luts = tuple(torch.from_numpy(np.array(t, dtype=dt))
                 for t in (JI.exp_lut7(), JI.renorm_lut()))
    lg = torch.from_numpy(rng.integers(-128, 128, size=(2, 4, 32)).astype(np.int8))
    v = torch.from_numpy(rng.integers(-128, 128, size=(2, 32, 8)).astype(np.int8))
    st = TI.flash_init((2, 4), 8)
    got = TI.flash_block_update(st, lg, v, luts=luts)
    want = TI.flash_block_update(st, lg, v)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
