"""The port's integer primitives against the JAX package, bit for bit.

Inputs come from seeded numpy generators and go through both packages;
every comparison is ``np.array_equal`` (the arithmetic is integer-exact,
so the tolerance is zero).  Negative accumulators, int32 extremes, the
flash path's renormalization and its 2^21 guard are covered.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as JA
from repro.core import igelu as JG
from repro.core import ilayernorm as JL
from repro.core import itamax as JI
from repro.core import quant_linear as JQ
from repro.quant import qparams as JP
from repro_torch.core import attention as TA
from repro_torch.core import igelu as TG
from repro_torch.core import ilayernorm as TL
from repro_torch.core import itamax as TI
from repro_torch.core import quant_linear as TQ
from repro_torch.quant import qparams as TP


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def same(j, p):
    return np.array_equal(np.asarray(j), p.numpy() if isinstance(p, torch.Tensor) else p)


def _accs(seed, shape, lim=1 << 21):
    rng = np.random.default_rng(seed)
    acc = rng.integers(-lim, lim, size=shape).astype(np.int32)
    acc.flat[:8] = [2**31 - 1, -(2**31), 2**30, -(2**30), 0, -1, 1, -(2**21)]
    return acc, rng


@pytest.mark.parametrize("narrow", [False, True])
def test_requantize_per_channel_and_scalar(narrow):
    acc, rng = _accs(0, (64, 256))
    mult = rng.integers(0, TP.MULT_MAX + 1, size=256).astype(np.int32)
    shift = rng.integers(TP.SHIFT_MIN, TP.SHIFT_MAX + 1, size=256).astype(np.int32)
    assert same(JP.requantize(acc, mult, shift, narrow=narrow),
                TP.requantize(t(acc), t(mult), t(shift), narrow=narrow))
    for m, s in [(1, 10), (32767, 31), (12345, 20), (0, 15)]:
        assert same(JP.requantize(acc, m, s, zero_point=3, narrow=narrow),
                    TP.requantize(t(acc), m, s, zero_point=3, narrow=narrow))


@pytest.mark.parametrize("out_bits", [14, 16])
def test_requantize_wide(out_bits):
    acc, rng = _accs(1, (32, 128))
    mult = rng.integers(1, TP.MULT_MAX + 1, size=128).astype(np.int32)
    shift = rng.integers(TP.SHIFT_MIN, TP.SHIFT_MAX + 1, size=128).astype(np.int32)
    assert same(JP.requantize_wide(acc, mult, shift, out_bits=out_bits),
                TP.requantize_wide(t(acc), t(mult), t(shift), out_bits=out_bits))
    assert same(JP.requantize_wide(acc, 30000, 12, -5, out_bits),
                TP.requantize_wide(t(acc), 30000, 12, -5, out_bits))


def test_rounding_rshift_all_shifts():
    acc, _ = _accs(2, (32, 32), lim=1 << 29)
    shift = np.tile(np.arange(32, dtype=np.int32), (32, 1))
    assert same(JP.rounding_rshift(acc, shift), TP.rounding_rshift(t(acc), t(shift)))
    assert same(JI.rounding_rshift_safe(acc, shift), TI.rounding_rshift_safe(t(acc), t(shift)))


def test_quantize_multiplier():
    rng = np.random.default_rng(3)
    real = np.concatenate([10.0 ** rng.uniform(-12, 1, size=500), [0.0, 1e-30, 1.0, 2.0]])
    jm, js = JP.np_quantize_multiplier(real)
    tm, ts = TP.np_quantize_multiplier(real)
    assert np.array_equal(jm, tm) and np.array_equal(js, ts)
    for r in real[:50]:
        assert JP.quantize_multiplier(float(r)) == TP.quantize_multiplier(float(r))
    assert tuple(JP.make_qparams(0.05, 0.01, 0.07, 2)) == tuple(TP.make_qparams(0.05, 0.01, 0.07, 2))


@pytest.mark.parametrize("scale", [1e-3, 0.02, 0.05, 0.5])
def test_igelu_int_every_int8(scale):
    q = np.arange(-128, 128, dtype=np.int8)
    assert tuple(JG.make_igelu_params(scale)) == tuple(TG.make_igelu_params(scale))
    assert same(JG.igelu_int(q, JG.make_igelu_params(scale)),
                TG.igelu_int(t(q), TG.make_igelu_params(scale)))


def test_isqrt():
    rng = np.random.default_rng(4)
    v = rng.integers(0, 2**31 - 1, size=4096).astype(np.int32)
    v[:8] = [0, 1, 2, 3, 2**31 - 1, 46340**2, 46340**2 - 1, 65025]
    assert same(JL.isqrt(v), TL.isqrt(t(v)))


@pytest.mark.parametrize("width", [128, 384])
def test_norms(width):
    rng = np.random.default_rng(width)
    x = rng.integers(-128, 128, size=(16, width)).astype(np.int8)
    x[0] = -128  # all-equal row: variance 0
    x[1, ::2], x[1, 1::2] = 127, -128
    g = rng.integers(-127, 128, size=width).astype(np.int8)
    b = rng.integers(-20000, 20000, size=width).astype(np.int32)
    assert same(JL.ilayernorm_i8(x, g, b, 1 / 64, 0.05), TL.ilayernorm_i8(t(x), t(g), t(b), 1 / 64, 0.05))
    assert same(JL.irmsnorm_i8(x, g, 1 / 64, 0.05), TL.irmsnorm_i8(t(x), t(g), 1 / 64, 0.05))
    assert same(JL.ilayernorm_np_i8(x, 0.03), TL.ilayernorm_np_i8(t(x), 0.03))


@pytest.mark.parametrize("masked", [False, True])
def test_itamax_rowwise(masked):
    rng = np.random.default_rng(5)
    lg = rng.integers(-128, 128, size=(4, 8, 100)).astype(np.int8)
    mask = rng.random((4, 8, 100)) > 0.3 if masked else None
    assert same(JI.itamax_rowwise(lg, mask),
                TI.itamax_rowwise(t(lg), None if mask is None else t(mask)))


def _flash_pair(state_j, state_t, logits, v, mask):
    state_j = JI.flash_block_update(state_j, jnp.asarray(logits), v, mask)
    state_t = TI.flash_block_update(state_t, t(logits), t(v), None if mask is None else t(mask))
    for a, b in zip(state_j, state_t):
        assert same(a, b)
    return state_j, state_t


@pytest.mark.parametrize("dtype,masked", [(np.int8, True), (np.int8, False), (np.int32, True)])
def test_flash_block_update_and_finalize(dtype, masked):
    rng = np.random.default_rng(6)
    sj, st = JI.flash_init((4, 8), 16), TI.flash_init((4, 8), 16)
    v = rng.integers(-128, 128, size=(4, 100, 16)).astype(np.int8)
    for i in range(5):  # rising maxima: every block renormalizes
        lg = np.clip(rng.integers(-128, 100, size=(4, 8, 100)) + 7 * i, -128, 127).astype(dtype)
        mask = rng.random((4, 8, 100)) > 0.2 if masked else None
        sj, st = _flash_pair(sj, st, lg, v, mask)
    assert int(np.asarray(sj.acc).min()) < 0  # negative accumulators reach the floor division
    assert same(JI.flash_finalize_q77(sj), TI.flash_finalize_q77(st))


def test_flash_magnitude_guard():
    """Flat rows of 4096 keys per block push d past 2^21: the guard fires."""
    rng = np.random.default_rng(7)
    sj, st = JI.flash_init((2,), 8), TI.flash_init((2,), 8)
    v = rng.integers(-128, 128, size=(4096, 8)).astype(np.int8)
    for _ in range(6):
        sj, st = _flash_pair(sj, st, np.full((2, 4096), 90, np.int8), v, None)
    assert same(JI.flash_finalize_q77(sj), TI.flash_finalize_q77(st))
    assert int(np.asarray(sj.d).max()) < JI.RESCALE_THRESH


def test_floor_division_of_negative_accumulators():
    acc = np.array([[-1000001, -1, 0, 1, -128 * 7 - 3, 2**27, -(2**27)]], np.int32)
    d = np.array([[3]], np.int32)
    state_j = JI.FlashItamaxState(m=jnp.zeros((1, 1), jnp.int32), d=d, acc=acc)
    state_t = TI.FlashItamaxState(m=torch.zeros((1, 1), dtype=torch.int32), d=t(d), acc=t(acc))
    assert same(JI.flash_finalize_q77(state_j), TI.flash_finalize_q77(state_t))


@pytest.mark.parametrize("act", [TQ.ACT_IDENTITY, TQ.ACT_RELU, TQ.ACT_GELU])
def test_qlinear_i8(act):
    rng = np.random.default_rng(8 + act)
    x = rng.integers(-128, 128, size=(2, 20, 96)).astype(np.int8)
    w = rng.integers(-127, 128, size=(96, 40)).astype(np.int8)
    b = rng.integers(-3000, 3000, size=40).astype(np.int32)
    s_w = rng.uniform(0.002, 0.01, size=40)
    jp = JQ.make_qlinear_params(0.05, s_w, 0.04, act, s_preact=0.03)
    tp = TQ.make_qlinear_params(0.05, s_w, 0.04, act, s_preact=0.03)
    assert same(JQ.qlinear_i8(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jp),
                TQ.qlinear_i8(t(x), t(w), t(b), tp))


def test_int8_matmul_widens():
    """int8 @ int8 in torch wraps; the plain path widens to int32 first."""
    a = torch.full((1, 64), 100, dtype=torch.int8)
    assert int(TP.imatmul(a, a.T)) == 64 * 100 * 100


@pytest.mark.parametrize("hkv,causal,kv_len", [(4, False, None), (2, True, None), (1, False, 200)])
def test_attention_flash_and_rowwise(hkv, causal, kv_len):
    rng = np.random.default_rng(9 + hkv)
    q = rng.integers(-128, 128, size=(2, 4, 64, 32)).astype(np.int8)
    k = rng.integers(-128, 128, size=(2, hkv, 256, 32)).astype(np.int8)
    v = rng.integers(-128, 128, size=(2, hkv, 256, 32)).astype(np.int8)
    p = JA.MhaQParams.make_flash(0.05, 0.05, 0.05, 0.04, 32)
    assert tuple(p) == tuple(TA.MhaQParams.make_flash(0.05, 0.05, 0.05, 0.04, 32))
    want = JA.attention_flash_i8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), p,
                                 causal=causal, block_k=64,
                                 kv_len=None if kv_len is None else jnp.int32(kv_len))
    got = TA.attention_flash_i8(t(q), t(k), t(v), TA.MhaQParams(*p), causal=causal,
                                block_k=64, kv_len=kv_len)
    assert same(want, got)
    pr = JA.MhaQParams.make(0.05, 0.05, 0.05, 0.04, 32)
    assert same(JA.attention_rowwise_i8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pr,
                                        causal=causal),
                TA.attention_rowwise_i8(t(q), t(k), t(v), TA.MhaQParams(*pr), causal=causal))
