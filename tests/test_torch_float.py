"""The port's float references and float models against the JAX package.

The same seeded numpy inputs go through each JAX function and its port.
Floats cannot be bit-exact across XLA and torch (``erf``, ``pow``, the
order of matmul and reduction sums differ in the last bits), so float
results agree within a stated tolerance: ``F32`` for one float32 op
chain, ``MODEL`` for a whole float model at reduced widths.  Integer
results (``igelu_i8``, ``irelu_i8``, ``flash_itamax_reference``,
``quantize_linear_params``, the decoder's ``forward_w8a8``) are equal bit
for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core import attention as JA
from repro.core import igelu as JG
from repro.core import ilayernorm as JN
from repro.core import itamax as JI
from repro.core import quant_linear as JQ
from repro.models import encoder as JE
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import from_jax_params, from_jax_quantized
from repro_torch.core import attention as TA
from repro_torch.core import igelu as TG
from repro_torch.core import ilayernorm as TN
from repro_torch.core import itamax as TI
from repro_torch.core import quant_linear as TQ
from repro_torch.models import encoder as TE
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

#: one float32 op chain: a few ulps of values of order 1-10
F32 = dict(rtol=1e-5, atol=2e-6)
#: a reduced float model (2 layers) or one attention: summation order
MODEL = dict(rtol=1e-4, atol=2e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# core float references
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("affine", [False, True])
def test_norms_f32(affine):
    rng = _rng(0)
    x, g, b = _f32(rng, 4, 7, 96, scale=3.0), _f32(rng, 96), _f32(rng, 96)
    args = (g, b) if affine else ()
    _close(TN.layernorm_f32(_t(x), *map(_t, args)), JN.layernorm_f32(x, *args), F32)
    args = (g,) if affine else ()
    _close(TN.rmsnorm_f32(_t(x), *map(_t, args)), JN.rmsnorm_f32(x, *args), F32)


def test_gelu_references():
    x = _f32(_rng(1), 4096, scale=3.0)
    # torch.erf and XLA's erf differ in the last bits (up to ~3e-7 here)
    _close(TG.gelu_f32(_t(x)), JG.gelu_f32(jnp.asarray(x)), F32)
    _close(TG.igelu_f32(_t(x)), JG.igelu_f32(jnp.asarray(x)), F32)


@pytest.mark.parametrize("in_scale,out_scale", [(0.05, 0.05), (0.02, 0.1), (0.0011, 0.003)])
def test_igelu_and_irelu_i8_exact(in_scale, out_scale):
    q = np.arange(-128, 128, dtype=np.int8)
    got = TG.igelu_i8(_t(q), in_scale, out_scale)
    assert np.array_equal(got.numpy(), np.asarray(JG.igelu_i8(jnp.asarray(q), in_scale,
                                                              out_scale)))
    got = TG.irelu_i8(_t(q), in_scale, out_scale)
    assert np.array_equal(got.numpy(), np.asarray(JG.irelu_i8(jnp.asarray(q), in_scale,
                                                              out_scale)))


@pytest.mark.parametrize("act", [JQ.ACT_IDENTITY, JQ.ACT_RELU, JQ.ACT_GELU])
@pytest.mark.parametrize("bias", [False, True])
def test_linear_f32(act, bias):
    rng = _rng(2)
    x, w, b = _f32(rng, 3, 5, 64), _f32(rng, 64, 48, scale=0.2), _f32(rng, 48)
    bb = b if bias else None
    got = TQ.linear_f32(_t(x), _t(w), None if bb is None else _t(bb), act)
    _close(got, JQ.linear_f32(jnp.asarray(x), jnp.asarray(w), bb, act), F32)


ATTN_CASES = [
    dict(h=4, hkv=4, sq=16, sk=16, causal=False, clip=None, mask=False),
    dict(h=4, hkv=2, sq=16, sk=16, causal=True, clip=None, mask=False),
    dict(h=4, hkv=1, sq=4, sk=24, causal=True, clip=0.5, mask=False),
    dict(h=2, hkv=2, sq=1, sk=24, causal=False, clip=None, mask=True),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(f"{k}{v}" for k, v in
                                                                   c.items()))
def test_attention_f32(case):
    rng = _rng(3)
    q = _f32(rng, 2, case["h"], case["sq"], 32)
    k = _f32(rng, 2, case["hkv"], case["sk"], 32)
    v = _f32(rng, 2, case["hkv"], case["sk"], 32)
    mask = (np.arange(case["sk"]) <= 9)[None, None, None, :] if case["mask"] else None
    want = JA.attention_f32(q, k, v, causal=case["causal"], logit_clip=case["clip"],
                            mask=None if mask is None else jnp.asarray(mask))
    got = TA.attention_f32(_t(q), _t(k), _t(v), causal=case["causal"],
                           logit_clip=case["clip"], mask=None if mask is None else _t(mask))
    _close(got, want, MODEL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk,block_q", [(32, 32, 8), (16, 40, 8), (12, 12, 8)])
def test_attention_f32_chunked(causal, sq, sk, block_q):
    rng = _rng(4)
    q, k, v = _f32(rng, 2, 4, sq, 16), _f32(rng, 2, 2, sk, 16), _f32(rng, 2, 2, sk, 16)
    want = JA.attention_f32_chunked(q, k, v, causal=causal, block_q=block_q, logit_clip=0.7)
    got = TA.attention_f32_chunked(_t(q), _t(k), _t(v), causal=causal, block_q=block_q,
                                   logit_clip=0.7)
    _close(got, want, MODEL)
    # the blocked form is the one-pass form, query block by query block
    _close(got, TA.attention_f32(_t(q), _t(k), _t(v), causal=causal, logit_clip=0.7), MODEL)


def test_neg_mask_constant():
    assert TA.NEG_MASK_I32 == JA.NEG_MASK_I32


def test_itamax_references():
    rng = _rng(5)
    x = _f32(rng, 6, 40, scale=4.0)
    _close(TI.itamax_rowwise_f32(_t(x)), JI.itamax_rowwise_f32(jnp.asarray(x)), F32)
    logits = rng.integers(-128, 128, (2, 3, 5, 64), dtype=np.int8)
    v = rng.integers(-128, 128, (2, 3, 64, 16), dtype=np.int8)
    mask = rng.random((2, 3, 5, 64)) < 0.8
    for block, m in ((16, None), (32, mask), (64, mask)):
        want = JI.flash_itamax_reference(jnp.asarray(logits), jnp.asarray(v), block,
                                         None if m is None else jnp.asarray(m))
        got = TI.flash_itamax_reference(_t(logits), _t(v), block, None if m is None else _t(m))
        assert np.array_equal(got.numpy(), np.asarray(want)), block
    with pytest.raises(ValueError, match="multiple"):
        TI.flash_itamax_reference(_t(logits), _t(v), 48)


# ---------------------------------------------------------------------------
# models/layers.py
# ---------------------------------------------------------------------------


def test_quant_config_site():
    q = TL.QuantConfig(s_act=0.04, overrides=(("l0.attn.out", 0.02), ("l1.res", 0.1)))
    jq = JL.QuantConfig(s_act=0.04, overrides=(("l0.attn.out", 0.02), ("l1.res", 0.1)))
    for name, default in (("l0.attn.out", None), ("l1.res", 0.5), ("l2", None), ("l2", 0.3)):
        assert q.site(name, default) == jq.site(name, default)
    assert q.site("l0.attn.out") == 0.02 and q.site("missing") == 0.04
    assert q.site("missing", 0.3) == 0.3
    hash(q)  # frozen and hashable with its overrides
    assert TL.QuantConfig() == TL.QuantConfig(0.05, 0.08, 0.01, ())


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm", "np_layernorm"])
def test_norm_apply(kind):
    rng = _rng(6)
    x = _f32(rng, 2, 9, 64, scale=2.0)
    p = {"layernorm": {"g": _f32(rng, 64), "b": _f32(rng, 64)},
         "rmsnorm": {"g": _f32(rng, 64)}, "np_layernorm": {}}[kind]
    _close(TL.norm_apply(kind, {k: _t(v) for k, v in p.items()}, _t(x)),
           JL.norm_apply(kind, p, x), F32)


@pytest.mark.parametrize("head_dim,theta", [(32, 10000.0), (64, 500000.0), (128, 10000.0)])
def test_rope_float(head_dim, theta):
    pos = np.arange(0, 300, 7)
    jc, js = JL.rope_cos_sin(jnp.asarray(pos), head_dim, theta)
    tc, ts = TL.rope_cos_sin(_t(pos), head_dim, theta)
    assert tc.dtype == torch.float32 and tc.shape == (len(pos), head_dim // 2)
    # torch's float32 pow differs from XLA's in the last bit of a few
    # frequencies, which the angles carry to ~1e-4 at position 300
    _close(tc, jc, dict(rtol=0, atol=2e-4))
    _close(ts, js, dict(rtol=0, atol=2e-4))
    x = _f32(_rng(7), 2, 3, len(pos), head_dim)
    _close(TL.apply_rope(_t(x), tc, ts), JL.apply_rope(x, jc, js), dict(rtol=0, atol=1e-3))
    # with the same tables, apply_rope is the same float32 arithmetic
    _close(TL.apply_rope(_t(x), _t(jc), _t(js)), JL.apply_rope(x, jc, js), F32)


def test_silu_mask_mlp_and_quantize_linear():
    rng = _rng(8)
    x = _f32(rng, 3, 7, 32, scale=3.0)
    _close(TL.silu(_t(x)), JL.silu(jnp.asarray(x)), F32)
    _close(TL.silu_i8_ref_f32(_t(x)), JL.silu_i8_ref_f32(jnp.asarray(x)), F32)
    logits = _f32(rng, 2, 4, 40)
    _close(TL.mask_padded_logits(_t(logits), 33), JL.mask_padded_logits(logits, 33), F32)
    assert TL.mask_padded_logits(_t(logits), 40) is not None
    for kind in ("gelu", "swiglu"):
        names = ("gate", "up", "down") if kind == "swiglu" else ("up", "down")
        p = {n: {"w": _f32(rng, 32 if n != "down" else 48, 48 if n != "down" else 32,
                           scale=0.2)} for n in names}
        if kind == "gelu":
            p["up"]["b"] = _f32(rng, 48)
        tp = {n: {k: _t(v) for k, v in d.items()} for n, d in p.items()}
        _close(TL.mlp_forward(tp, _t(x), kind), JL.mlp_forward(p, x, kind), MODEL)
    p = {"w": _f32(rng, 32, 48, scale=0.2), "b": _f32(rng, 48)}
    got, s_w = TL.quantize_linear_params({k: _t(v) for k, v in p.items()}, 0.05)
    want, j_s_w = JL.quantize_linear_params(p, 0.05)
    assert s_w == j_s_w
    for k in ("w_q", "b_q"):
        assert got[k].dtype == {"w_q": torch.int8, "b_q": torch.int32}[k]
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


# ---------------------------------------------------------------------------
# float models: the three encoders and OLMo
# ---------------------------------------------------------------------------


def _encoder_batch(cfg, arch, rng, s=32):
    if arch == "mobilebert":
        tok = rng.integers(0, cfg.vocab, (2, s)).astype(np.int32)
        return {"tokens": tok, "labels": tok}
    name = "patches" if arch == "dinov2-small" else "frames"
    return {name: _f32(rng, 2, s, cfg.d_model), "targets": _f32(rng, 2, s, cfg.d_model)}


@pytest.mark.parametrize("arch", ["mobilebert", "dinov2-small", "whisper-tiny-encoder"])
@pytest.mark.parametrize("qat", [False, True])
def test_encoder_forward_and_loss(arch, qat):
    cfg, tcfg = reduced(get_config(arch)), t_reduced(t_get_config(arch))
    params = JE.init_params(cfg, jax.random.PRNGKey(3))
    tp = from_jax_params(jax.tree.map(np.asarray, params))
    batch = _encoder_batch(cfg, arch, _rng(9))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    _close(TE.forward(tcfg, tp, tb, qat=qat), JE.forward(cfg, params, jb, qat=qat), MODEL)
    _close(TE.loss_fn(tcfg, tp, tb, qat=qat), JE.loss_fn(cfg, params, jb, qat=qat), MODEL)


@pytest.fixture(scope="module")
def olmo():
    cfg, tcfg = reduced(get_config("olmo-1b")), t_reduced(t_get_config("olmo-1b"))
    params = JT.init_params(cfg, jax.random.PRNGKey(5))
    return cfg, tcfg, params, from_jax_params(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("qat", [False, True])
def test_decoder_forward_and_loss(olmo, qat):
    cfg, tcfg, params, tp = olmo
    tok = _rng(10).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    jb, tb = {"tokens": tok, "labels": tok}, {"tokens": _t(tok), "labels": _t(tok)}
    logits = TT.forward(tcfg, tp, tb, qat=qat)
    assert logits.shape == (2, 24, tcfg.vocab_padded)
    _close(logits, JT.forward(cfg, params, jb, qat=qat), MODEL)
    _close(TT.loss_fn(tcfg, tp, tb, qat=qat), JT.loss_fn(cfg, params, jb, qat=qat), MODEL)
    # remat recomputes the layers in the backward pass: same loss, same grads
    w = tp["layers"][0]["attn"]["wo"]["w"].requires_grad_(True)
    try:
        g = torch.autograd.grad(TT.loss_fn(tcfg, tp, tb, qat=qat), w)[0]
        g_remat = torch.autograd.grad(TT.loss_fn(tcfg, tp, tb, qat=qat, remat=True), w)[0]
    finally:
        w.requires_grad_(False)
    assert torch.equal(g, g_remat)


def test_decoder_float_chunked_attention_path(olmo, monkeypatch):
    """At ``_CHUNKED_ATTN_MIN_SEQ`` and beyond, ``attn_block`` attends one
    query block at a time; lowered to 16 here, the logits are unchanged."""
    cfg, tcfg, params, tp = olmo
    tok = _t(_rng(11).integers(0, cfg.vocab, (1, 32)).astype(np.int32))
    want = TT.forward(tcfg, tp, {"tokens": tok})
    monkeypatch.setattr(TT, "_CHUNKED_ATTN_MIN_SEQ", 16)
    calls = []
    real = TT.attention_f32_chunked
    monkeypatch.setattr(TT, "attention_f32_chunked",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw, block_q=8))
    _close(TT.forward(tcfg, tp, {"tokens": tok}), want.numpy(), MODEL)
    assert len(calls) == tcfg.n_layers


def test_decoder_prefill_decode_chain(olmo):
    cfg, tcfg, params, tp = olmo
    tok = _rng(12).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    jl, jc = JT.prefill(cfg, params, {"tokens": jnp.asarray(tok)}, 24)
    tl, tc = TT.prefill(tcfg, tp, {"tokens": _t(tok)}, 24)
    _close(tl, jl, MODEL)
    _close(tc["k"], jc["k"], MODEL)
    _close(tc["v"], jc["v"], MODEL)
    assert int(tc["len"]) == int(jc["len"]) == 16
    nxt = np.asarray(jnp.argmax(jl[:, -1:], -1)).astype(np.int32)
    for _ in range(3):
        before = tc["k"].clone()
        jl, jc = JT.decode_step(cfg, params, jc, jnp.asarray(nxt))
        tl, tc2 = TT.decode_step(tcfg, tp, tc, _t(nxt))
        assert torch.equal(tc["k"], before)  # pure: the argument is unchanged
        tc = tc2
        _close(tl, jl, MODEL)
        _close(tc["k"], jc["k"], MODEL)
        assert int(tc["len"]) == int(jc["len"])
        nxt = np.asarray(jnp.argmax(jl[:, -1:], -1)).astype(np.int32)


def test_decoder_forward_w8a8_exact(olmo):
    cfg, tcfg, params, tp = olmo
    q = JL.QuantConfig(s_act=0.04, s_res=0.06, s_w=0.008)
    qp = JT.quantize_params(cfg, params, q)
    tqp = from_jax_quantized(jax.tree.map(np.asarray, qp))
    tok = _rng(13).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    want = np.asarray(JT.forward_w8a8(cfg, qp, {"tokens": jnp.asarray(tok)}, q))
    got = TT.forward_w8a8(tcfg, tqp, {"tokens": _t(tok)}, TL.QuantConfig(0.04, 0.06, 0.008))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    # the prefill's last row is the forward's last row
    last, _ = TT.prefill_w8a8(tcfg, tqp, {"tokens": _t(tok)}, 32,
                              TL.QuantConfig(0.04, 0.06, 0.008))
    assert torch.equal(last, got[:, -1:])


def test_moe_float_path_refuses():
    """The float MLP block of a mixture-of-experts config no longer refuses:
    it routes through ``models.moe`` and agrees with the JAX package's
    block (output within ``MODEL``, the load-balance term within ``F32``)."""
    cfg = reduced(get_config("olmo-1b")).replace(n_experts=4, top_k=2, d_ff_expert=64,
                                                 family="moe")
    tcfg = t_reduced(t_get_config("olmo-1b")).replace(n_experts=4, top_k=2, d_ff_expert=64,
                                                      family="moe")
    lp = JT.init_layer(cfg, jax.random.PRNGKey(5), jnp.float32)
    tlp = from_jax_params(jax.tree.map(np.asarray, {"layers": jax.tree.map(
        lambda a: a[None], lp)}))["layers"][0]
    x = _f32(_rng(17), 2, 16, cfg.d_model)
    want, want_aux = JT.mlp_block(cfg, lp, jnp.asarray(x))
    got, got_aux = TT.mlp_block(tcfg, tlp, _t(x))
    _close(got, want, MODEL)
    _close(got_aux, want_aux, F32)
