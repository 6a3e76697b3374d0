"""The port's PTQ flow against the JAX package: qparams helpers, observers,
calibration, fidelity metrics and fake quantization.

Calibrated scales are absmax values of float forwards, which differ from
XLA's in the last bits, so they agree within ``SCALE_RTOL``; everything
downstream of one shared ``QuantConfig`` (quantized params, the
calibrated integer forward) is equal bit for bit.  ``fake_quant*`` values
are the same float32 operations in both packages and equal bit for bit;
their gradients equal ``jax.grad``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import encoder as JE
from repro.models import layers as JL
from repro.quant import fake_quant as JF
from repro.quant import observers as JO
from repro.quant import ptq as JP
from repro.quant import qparams as JQP
from repro_torch import quant as t_quant
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import from_jax_params, from_jax_quantized
from repro_torch.core.igelu import MIN_GELU_SCALE
from repro_torch.models import encoder as TE
from repro_torch.models import layers as TL
from repro_torch.quant import fake_quant as TF
from repro_torch.quant import observers as TO
from repro_torch.quant import ptq as TP
from repro_torch.quant import qparams as TQP

#: calibrated scales, port vs reference (float absmax, last-bit differences)
SCALE_RTOL = 1e-5
#: percentiles: XLA simplifies ``pct / 100 * (n - 1)`` its own way, so the
#: interpolation rank can differ by one float32 ulp (6e-5 at n = 1000),
#: which moves the result by that much of the gap between two neighbours
PCT_RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _tq(jq) -> TL.QuantConfig:
    return TL.QuantConfig(jq.s_act, jq.s_res, jq.s_w, tuple(jq.overrides))


# ---------------------------------------------------------------------------
# qparams helpers, observers
# ---------------------------------------------------------------------------


def test_quant_package_exports_the_reference_names():
    import repro.quant as j_quant

    assert t_quant.__all__ == j_quant.__all__
    for name in t_quant.__all__:
        assert hasattr(t_quant, name), name


@pytest.mark.parametrize("absmax", [0.0, -1.0, 0.5, 3.75])
def test_scale_from_absmax(absmax):
    assert TQP.scale_from_absmax(absmax) == JQP.scale_from_absmax(absmax)
    assert TQP.scale_from_absmax(absmax, 63) == JQP.scale_from_absmax(absmax, 63)


def test_quantize_dequantize_and_weight_helpers():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 40)) * 4).astype(np.float32)
    x[0, :4] = [0.025, -0.075, 0.125, 1e9]  # ties at scale 0.05, and saturation
    for scale in (0.05, np.float32(0.031), np.linspace(0.01, 0.2, 40).astype(np.float32)):
        want = np.asarray(JQP.quantize_array(x, scale))
        got = TQP.quantize_array(_t(x), scale)
        assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
        want_f = np.asarray(JQP.dequantize_array(want, scale))
        got_f = TQP.dequantize_array(got, scale)
        assert got_f.dtype == torch.float32 and np.array_equal(got_f.numpy(), want_f)
    w = (rng.standard_normal((32, 24)) * 0.1).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero channel keeps scale 1
    for axis in (0, 1, -1):
        jq, js = JQP.quantize_weight_per_channel(w, axis)
        tq, ts = TQP.quantize_weight_per_channel(_t(w), axis)
        assert np.array_equal(tq.numpy(), np.asarray(jq))
        assert ts.shape == js.shape and np.array_equal(ts.numpy(), np.asarray(js))
    jq, js = JQP.quantize_weight_per_tensor(w)
    tq, ts = TQP.quantize_weight_per_tensor(_t(w))
    assert np.array_equal(tq.numpy(), np.asarray(jq)) and float(ts) == float(js)
    tq, ts = TQP.quantize_weight_per_tensor(torch.zeros(3, 3))
    assert float(ts) == 1.0 and not tq.any()


def test_absmax_and_ema_observers():
    rng = np.random.default_rng(1)
    xs = [(rng.standard_normal((4, 16)) * s).astype(np.float32) for s in (1.0, 5.0, 0.5)]
    js, ts = JO.AbsMaxState.init(), TO.AbsMaxState.init()
    je, te = JO.EmaAbsMaxState.init(), TO.EmaAbsMaxState.init()
    for x in xs:
        js, ts = JO.absmax_update(js, x), TO.absmax_update(ts, _t(x))
        je, te = JO.ema_absmax_update(je, x, 0.8), TO.ema_absmax_update(te, _t(x), 0.8)
        assert float(ts.absmax) == float(js.absmax)
        assert float(te.value) == float(je.value) and bool(te.initialized)
    for qmax, margin in ((127, 1.0), (63, 1.05)):
        assert float(TO.absmax_scale(ts, qmax, margin)) == float(JO.absmax_scale(js, qmax, margin))
    assert float(TO.absmax_scale(TO.AbsMaxState.init())) == float(
        JO.absmax_scale(JO.AbsMaxState.init()))


@pytest.mark.parametrize("n,pct", [(1000, 99.9), (4097, 50.0), (1 << 20, 99.9), (7, 100.0),
                                   (1, 99.9)])
def test_percentile_scale(n, pct):
    v = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    want = float(JO.percentile_scale(jnp.asarray(v), pct))
    assert float(TO.percentile_scale(_t(v), pct)) == pytest.approx(want, rel=PCT_RTOL)


def test_percentile_scale_past_the_quantile_limit():
    """``torch.quantile`` refuses more than 2^24 elements; the port's
    percentile has no such limit and still equals ``jnp.percentile``."""
    n = (1 << 24) + 3
    v = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(_t(v), 0.999)
    want = float(JO.percentile_scale(jnp.asarray(v)))
    assert float(TO.percentile_scale(_t(v))) == pytest.approx(want, rel=PCT_RTOL)


# ---------------------------------------------------------------------------
# calibration and fidelity
# ---------------------------------------------------------------------------


def _calib_batches(arch, cfg, rng, n=2):
    if arch == "mobilebert":
        return [{"tokens": rng.integers(0, cfg.vocab, (2, 64)).astype(np.int32)}
                for _ in range(n)]
    return [{"patches": rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("arch", ["mobilebert", "dinov2-small"])
def test_calibrate_encoder_scales_and_integer_forward(arch):
    cfg, tcfg = reduced(get_config(arch)), t_reduced(t_get_config(arch))
    params = JE.init_params(cfg, jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, params))
    batches = _calib_batches(arch, cfg, np.random.default_rng(2))
    jq = JP.calibrate_encoder(cfg, params, [{k: jnp.asarray(v) for k, v in b.items()}
                                            for b in batches])
    tq = TP.calibrate_encoder(tcfg, tp, [{k: _t(v) for k, v in b.items()} for b in batches])
    for f in ("s_act", "s_res", "s_w"):
        assert getattr(tq, f) == pytest.approx(getattr(jq, f), rel=SCALE_RTOL), f
    assert tq.overrides == () and jq.overrides == ()
    # one QuantConfig (the reference's) for both: the integer path is exact
    q = _tq(jq)
    qp = JE.quantize_params(cfg, params, jq)
    tqp = TE.quantize_params(tcfg, tp, q)
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(jax.tree.map(_t, from_jax_quantized(jax.tree.map(np.asarray, qp)))),
        jax.tree.leaves(tqp)))
    b0 = batches[0]
    fl = np.asarray(JE.forward(cfg, params, {k: jnp.asarray(v) for k, v in b0.items()}))
    for backend in ("w8a8", "ita"):
        want = np.asarray(JE.forward_w8a8(cfg, qp, {k: jnp.asarray(v) for k, v in b0.items()},
                                          q=jq, backend=backend))
        got = TE.forward_w8a8(tcfg, tqp, {k: _t(v) for k, v in b0.items()}, q=q,
                              backend=backend)
        assert np.array_equal(got.numpy(), want), backend
        assert TP.quantization_error(_t(fl), got) == JP.quantization_error(fl, want)


def test_quantization_error_equals_reference():
    rng = np.random.default_rng(3)
    f = rng.standard_normal((2, 8, 50)).astype(np.float32)
    q = (f + rng.standard_normal(f.shape) * 0.3).astype(np.float32)
    want = JP.quantization_error(jnp.asarray(f), jnp.asarray(q))
    got = TP.quantization_error(_t(f), _t(q))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k
    assert TP.quantization_error(f, f)["cosine"] == pytest.approx(1.0, abs=1e-12)


# twins of tests/test_ptq.py, on the port's own float model


def test_calibration_improves_fidelity():
    cfg = t_reduced(t_get_config("mobilebert"))
    params = TE.init_params(cfg, 0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 64),
                                                                dtype=np.int32))
    batch = {"tokens": tokens}
    with torch.no_grad():
        fl = TE.forward(cfg, params, batch)
        default = TP.quantization_error(
            fl, TE.forward_w8a8(cfg, TE.quantize_params(cfg, params), batch))
        q = TP.calibrate_encoder(cfg, params, [batch])
        calibrated = TP.quantization_error(
            fl, TE.forward_w8a8(cfg, TE.quantize_params(cfg, params, q), batch, q=q))
    assert calibrated["cosine"] > default["cosine"] + 0.2
    assert calibrated["rel_err"] < default["rel_err"]
    assert calibrated["argmax_agreement"] > default["argmax_agreement"]
    assert calibrated["cosine"] > 0.6


def test_calibrated_scales_within_gelu_guard():
    cfg = t_reduced(t_get_config("dinov2-small"))
    params = TE.init_params(cfg, 1)
    gen = torch.Generator().manual_seed(1)
    patches = torch.randn((2, 32, cfg.d_model), generator=gen)
    q = TP.calibrate_encoder(cfg, params, [{"patches": patches}])
    assert q.s_act >= MIN_GELU_SCALE
    assert q.s_res > 0 and q.s_w > 0


# ---------------------------------------------------------------------------
# fake quantization: values and gradients
# ---------------------------------------------------------------------------


def _inputs():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((16, 24)) * 3).astype(np.float32)
    x[0, :3] = [0.025, -0.075, 6.35]  # ties at 0.05, and the range edge
    return x, np.linspace(-1.0, 1.0, x.size, dtype=np.float32).reshape(x.shape)


@pytest.mark.parametrize("kind", ["act", "narrow", "weight", "weight_ch0", "weight_ch1",
                                  "logits"])
def test_fake_quant_values_and_grads(kind):
    x, cot = _inputs()
    jfn, tfn = {
        "act": (lambda a: JF.fake_quant(a, 0.05), lambda a: TF.fake_quant(a, 0.05)),
        "narrow": (lambda a: JF.fake_quant(a, 0.02, -127, 127),
                   lambda a: TF.fake_quant(a, 0.02, -127, 127)),
        "weight": (JF.fake_quant_weight, TF.fake_quant_weight),
        "weight_ch0": (lambda a: JF.fake_quant_weight(a, 0), lambda a: TF.fake_quant_weight(a, 0)),
        "weight_ch1": (lambda a: JF.fake_quant_weight(a, 1), lambda a: TF.fake_quant_weight(a, 1)),
        "logits": (JF.fake_quant_logits, TF.fake_quant_logits),
    }[kind]
    want = np.asarray(jfn(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    got = tfn(xt)
    assert np.array_equal(got.detach().numpy(), want)
    g_want = np.asarray(jax.grad(lambda a: jnp.sum(jfn(a) * cot))(jnp.asarray(x)))
    (g_got,) = torch.autograd.grad((got * _t(cot)).sum(), xt)
    assert np.array_equal(g_got.numpy(), g_want)
    if kind == "act":  # 1 inside the range, 0 outside
        inside = (x >= -128 * 0.05) & (x <= 127 * 0.05)
        assert not inside.all() and np.array_equal(g_got.numpy(), np.where(inside, cot, 0))


def test_qat_forward_gradient_equals_reference():
    """The float forward's ``qat=True`` path trains through the STE: the
    gradient of the MLM loss w.r.t. a projection equals ``jax.grad``'s."""
    cfg, tcfg = reduced(get_config("mobilebert")), t_reduced(t_get_config("mobilebert"))
    params = JE.init_params(cfg, jax.random.PRNGKey(2))
    tp = from_jax_params(jax.tree.map(np.asarray, params))
    tok = np.random.default_rng(6).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(tok)}

    def j_loss(w):
        layers = dict(params["layers"])
        layers["attn"] = {**layers["attn"], "wqkv": {**layers["attn"]["wqkv"], "w": w}}
        return JE.loss_fn(cfg, {**params, "layers": layers}, jb, qat=True)

    g_want = np.asarray(jax.grad(j_loss)(params["layers"]["attn"]["wqkv"]["w"]))[0]
    w = tp["layers"][0]["attn"]["wqkv"]["w"].requires_grad_(True)
    loss = TE.loss_fn(tcfg, tp, {"tokens": _t(tok), "labels": _t(tok)}, qat=True)
    (g_got,) = torch.autograd.grad(loss, w)
    np.testing.assert_allclose(g_got.numpy(), g_want, rtol=1e-4, atol=1e-6)
    assert np.count_nonzero(g_want) > 0


def test_quant_config_is_a_frozen_dataclass():
    q = TL.QuantConfig()
    with pytest.raises(dataclasses.FrozenInstanceError):
        q.s_act = 1.0
    assert dataclasses.asdict(q) == dataclasses.asdict(JL.QuantConfig()) | {"overrides": ()}
