"""The port's model-level encoder against the JAX package, bit for bit.

``reduced(mobilebert)`` with ``head_dim=64``, so the MHA runs the
attention kernel's path; seq 128 and seq 100 (the 128-row padding and
``kv_valid`` masking).  The JAX side's Pallas kernels run in interpret
mode on the CPU; the port's wrappers run their plain versions.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import encoder as JE
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import from_jax_params, from_jax_quantized
from repro_torch.models import encoder as TE


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("mobilebert")).replace(head_dim=64)
    tcfg = t_reduced(t_get_config("mobilebert")).replace(head_dim=64)
    params = JE.init_params(cfg, jax.random.PRNGKey(1))
    qp = JE.quantize_params(cfg, params)
    return cfg, tcfg, params, qp


def test_configs_are_the_reference_configs():
    for arch in ("mobilebert", "dinov2-small", "whisper-tiny-encoder"):
        assert get_config(arch).__dict__ == t_get_config(arch).__dict__
        assert reduced(get_config(arch)).__dict__ == t_reduced(t_get_config(arch)).__dict__


def test_quantize_params_matches(setup):
    cfg, tcfg, params, qp = setup
    got = TE.quantize_params(tcfg, from_jax_params(jax.tree.map(np.asarray, params)))
    want = from_jax_quantized(jax.tree.map(np.asarray, qp))
    flat_got, flat_want = [], []

    def walk(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, list):
            for x, y in zip(a, b, strict=True):
                walk(x, y)
        else:
            flat_got.append(a)
            flat_want.append(b)

    walk(got, want)
    assert flat_got and all(torch.equal(a, b) for a, b in zip(flat_got, flat_want))


def test_init_params_is_seeded():
    cfg = t_reduced(t_get_config("mobilebert"))
    a, b = TE.init_params(cfg, 3), TE.init_params(cfg, 3)
    assert torch.equal(a["layers"][1]["mlp"]["up"]["w"], b["layers"][1]["mlp"]["up"]["w"])
    assert len(a["layers"]) == cfg.n_layers


@pytest.mark.parametrize("seq,batch", [(128, 2), (100, 1)])
@pytest.mark.parametrize("backend", ["w8a8", "ita"])
def test_forward_w8a8_matches(setup, seq, batch, backend):
    cfg, tcfg, _, qp = setup
    tokens = np.random.default_rng(seq).integers(0, cfg.vocab, size=(batch, seq)).astype(np.int32)
    want = np.asarray(JE.forward_w8a8(cfg, qp, {"tokens": tokens}, backend=backend))
    tqp = from_jax_quantized(jax.tree.map(np.asarray, qp))
    got = TE.forward_w8a8(tcfg, tqp, {"tokens": torch.from_numpy(tokens)}, backend=backend)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
