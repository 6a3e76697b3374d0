"""The port's other model families against the JAX package, on reduced configs.

MoE (granite-moe: no shared experts; qwen2-moe: shared experts), SSM
(mamba2), hybrid (zamba2), encoder-decoder (seamless-m4t) and VLM
(llava-next).  The whole-model tests carry the JAX package's params into
the port (``repro_torch.convert``); the tests of one part draw its params
in the port and stack them for the JAX package (``_to_jax``), which is
quicker.  Both packages run the same seeded numpy inputs.

Tolerances, as measured at these sizes:

* float forwards and losses (float32): ``MODEL`` (rtol 1e-4, atol 2e-5;
  measured max |diff| 5.3e-06 on logits of magnitude 4-5);
* integer serving chains (MoE, encdec, VLM): bit-exact logits and caches
  at the prefill and both decode steps; MoE routing indices equal, its
  combine weights within 1e-6, and the expert path bit-exact from the
  reference's own routing;
* mamba2 / zamba2 chains: float32 params within ``MODEL`` (zamba2's int8
  K/V within one LSB on 0.1 % of entries at most; measured: equal); the
  bfloat16 serve params of ``model_zoo`` within ``BF16`` (0.1 of the
  largest logit; measured 0.055): XLA keeps bfloat16 chains in float32
  inside its fusions, torch rounds after each op;
* zamba2's integer shared attention bit-exact from the same int8 input
  (``h_q``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeCell, get_config, reduced
from repro.models import build as j_build
from repro.models import layers as JL
from repro.models import mamba2 as JMB
from repro.models import moe as JM
from repro.models import zamba2 as JZ
from repro.models.model_zoo import input_specs as j_specs
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import from_jax_params, from_jax_quantized
from repro_torch.models import build as t_build
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TMB
from repro_torch.models import moe as TM
from repro_torch.models import zamba2 as TZ

MODEL = dict(rtol=1e-4, atol=2e-5)
#: bfloat16 serving chains: max |diff| over the largest |logit|
BF16 = 0.1

FAMILIES = ["granite-moe-3b-a800m", "qwen2-moe-a2.7b", "mamba2-370m", "zamba2-2.7b",
            "seamless-m4t-large-v2", "llava-next-34b"]
MOE = ["granite-moe-3b-a800m", "qwen2-moe-a2.7b"]
INTEGER = ["granite-moe-3b-a800m", "qwen2-moe-a2.7b", "seamless-m4t-large-v2",
           "llava-next-34b"]
PROMPT, MAX_LEN = 64, 96


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch):
    return reduced(get_config(arch)), t_reduced(t_get_config(arch))


def _batch(cfg, kind: str, seed: int) -> dict:
    """Numpy inputs of the reference's ``input_specs`` (batch 2, 64 positions)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in j_specs(cfg, ShapeCell("t", PROMPT, 2, kind), jnp.float32).items():
        if spec.dtype == jnp.int32:
            out[name] = rng.integers(0, cfg.vocab, spec.shape).astype(np.int32)
        elif spec.dtype == jnp.int8:
            out[name] = rng.integers(-127, 128, spec.shape).astype(np.int8)
        else:
            out[name] = rng.standard_normal(spec.shape).astype(np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _to_jax(tree):
    """The port's params as the JAX package's pytree: each list of layers
    stacked on a leading axis, bfloat16 carried exactly."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return jax.tree.map(lambda *xs: jnp.stack(xs), *map(_to_jax, tree))
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(tree.numpy())


def _f(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("arch", FAMILIES)
def test_float_forward_and_loss(arch):
    cfg, tcfg = _cfgs(arch)
    ja, ta = j_build(cfg), t_build(tcfg)
    params = jax.jit(ja.init_params)(jax.random.PRNGKey(0))
    tparams = from_jax_params(_np(params))
    batch = _batch(cfg, "train", 0)
    want, want_loss = jax.jit(lambda p, b: (ja.forward(p, b), ja.loss_fn(p, b)))(
        params, _j(batch))
    got = ta.forward(tparams, _t(batch))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MODEL)
    np.testing.assert_allclose(float(ta.loss_fn(tparams, _t(batch))), float(want_loss), **MODEL)


def _chain(ja, ta, sp, tsp, batch):
    """Prefill 64 positions, then 2 greedy decode steps, in both packages:
    [(reference logits, cache), (port logits, cache)] per step."""
    j_prefill = jax.jit(ja.prefill, static_argnums=2)
    j_decode = jax.jit(ja.decode_step)
    jl, jc = j_prefill(sp, _j(batch), MAX_LEN)
    tl, tc = ta.prefill(tsp, _t(batch), MAX_LEN)
    steps = [((jl, jc), (tl, tc))]
    for _ in range(2):
        tok = np.argmax(_f(jl)[:, -1], -1).astype(np.int32)[:, None]
        jl, jc = j_decode(sp, jc, jnp.asarray(tok))
        tl, tc = ta.decode_step(tsp, tc, torch.from_numpy(tok))
        steps.append(((jl, jc), (tl, tc)))
    return steps


@pytest.mark.parametrize("arch", FAMILIES)
def test_serving_chain(arch):
    """``init_serve_params`` -> ``prefill`` -> 2 ``decode_step``s: the cache
    holds 65 rows after 64 + 1, as the JAX package's smoke test asserts."""
    cfg, tcfg = _cfgs(arch)
    ja, ta = j_build(cfg), t_build(tcfg)
    sp = jax.jit(ja.init_serve_params)(jax.random.PRNGKey(1))
    steps = _chain(ja, ta, sp, from_jax_quantized(_np(sp)), _batch(cfg, "prefill", 1))
    assert int(steps[1][1][1]["len"]) == 65 and int(steps[1][0][1]["len"]) == 65
    for (jl, jc), (tl, tc) in steps:
        assert tuple(tl.shape) == jl.shape and set(tc) == set(jc)
        if arch in INTEGER:
            assert np.array_equal(_f(tl), np.asarray(jl)), arch
            for k in jc:
                assert np.array_equal(tc[k].numpy(), np.asarray(jc[k])), (arch, k)
        else:  # bfloat16 trunk
            assert tl.dtype == torch.bfloat16
            err = np.abs(_f(tl) - _f(jl)).max()
            assert err <= BF16 * np.abs(_f(jl)).max(), (arch, err)
            assert int(tc["len"]) == int(jc["len"])


@pytest.mark.parametrize("arch,length", [("mamba2-370m", 64), ("mamba2-370m", 40),
                                         ("zamba2-2.7b", 64), ("zamba2-2.7b", 40)])
def test_float32_chain(arch, length):
    """The ssm / hybrid chain on float32 params: prefill (40 tokens needs
    the chunk pad: chunk 32) and 2 decode steps within ``MODEL``."""
    cfg, tcfg = _cfgs(arch)
    mod, tmod = (JMB, TMB) if arch.startswith("mamba") else (JZ, TZ)
    tparams = tmod.init_params(tcfg, seed=2)
    params = _to_jax(tparams)
    extra, textra = (), ()
    if mod is JZ:
        qs = JZ.quantize_shared(params["shared"])
        tqs = TZ.quantize_shared(tparams["shared"])
        assert all(np.array_equal(tqs[n]["w_q"].numpy(), np.asarray(qs[n]["w_q"])) for n in qs)
        extra, textra = (qs,), (tqs,)
    tok = np.random.default_rng(3).integers(0, cfg.vocab, (2, length)).astype(np.int32)
    jl, jc = mod.prefill(cfg, params, {"tokens": jnp.asarray(tok)}, MAX_LEN, *extra)
    tl, tc = tmod.prefill(tcfg, tparams, {"tokens": torch.from_numpy(tok)}, MAX_LEN, *textra)
    for step in range(3):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **MODEL)
        for k in ("k", "v") if mod is JZ else ():
            diff = np.abs(tc[k].numpy().astype(int) - np.asarray(jc[k]).astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (k, step)
        assert int(tc["len"]) == int(jc["len"]) == length + step
        if step == 2:
            break
        t = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        jl, jc = mod.decode_step(cfg, params, jc, jnp.asarray(t), *extra)
        tl, tc = tmod.decode_step(tcfg, tparams, tc, torch.from_numpy(t), *textra)


# ---------------------------------------------------------------------------
# MoE routing and the integer expert path
# ---------------------------------------------------------------------------


def _moe_layer(arch, seed=0):
    """One integer MoE layer drawn by the port, in both packages' form."""
    cfg, tcfg = _cfgs(arch)
    tlp = TM.init_qmoe_layer(tcfg, torch.Generator().manual_seed(seed))
    return cfg, tcfg, _to_jax(tlp), tlp


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("tokens", [128, 8, 6])
def test_moe_route(arch, tokens):
    """``_route``: equal dispatch (the routing indices and slots), combine
    weights and load-balance loss within 1e-6, for a prefill group and
    decode groups of 8 and 6 tokens (capacity ``top_k``)."""
    cfg, tcfg, lp, tlp = _moe_layer(arch)
    h = np.random.default_rng(tokens).standard_normal((1, tokens, cfg.d_model)) * 0.05
    h = h.astype(np.float32)
    jd, jc, ja = JM._route(cfg, lp["router"]["w"], jnp.asarray(h))
    td, tc, ta = TM._route(tcfg, tlp["router"]["w"], torch.from_numpy(h))
    assert td.shape == jd.shape and np.array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", MOE)
def test_moe_route_ties_pick_the_lower_expert(arch):
    """A zero router makes every probability equal: ``jax.lax.top_k`` takes
    the lowest expert indices, and so does the port's stable sort."""
    cfg, tcfg, lp, tlp = _moe_layer(arch)
    h = np.random.default_rng(5).standard_normal((1, 16, cfg.d_model)).astype(np.float32)
    w = np.zeros_like(np.asarray(lp["router"]["w"]))
    jd, jc, _ = JM._route(cfg, jnp.asarray(w), jnp.asarray(h))
    td, tc, _ = TM._route(tcfg, torch.from_numpy(w), torch.from_numpy(h))
    assert np.array_equal(td.numpy(), np.asarray(jd)) and np.array_equal(tc.numpy(), np.asarray(jc))
    assert td[0, :, cfg.top_k:].sum() == 0  # experts 0 .. top_k - 1 only


@pytest.mark.parametrize("arch", MOE)
def test_moe_experts_exact_from_reference_routing(arch):
    """The reference's ``dispatch`` / ``combine`` into the port's expert
    path and combine: int8 outputs bit-exact with the reference's
    ``moe_ffn_w8a8`` (shared experts left out), and the whole
    ``moe_ffn_w8a8`` with its shared experts bit-exact too."""
    cfg, tcfg, lp, tlp = _moe_layer(arch, seed=4)
    q, tq = JL.QuantConfig(), TL.QuantConfig()
    h = np.random.default_rng(6).integers(-128, 128, (2, 64, cfg.d_model)).astype(np.int8)
    grouped = h.reshape(1, 128, -1)
    jd, jc, _ = JM._route(cfg, lp["router"]["w"],
                          jnp.asarray(grouped).astype(jnp.float32) * q.s_act)
    ye = TM._experts_w8a8(tlp["experts"], torch.from_numpy(grouped),
                          torch.from_numpy(np.asarray(jd)), tq)
    got = TM._combine_w8a8(torch.from_numpy(np.asarray(jc)), ye, tq, tcfg.top_k)
    routed = {k: v for k, v in lp.items() if k != "shared"}
    want = np.asarray(JM.moe_ffn_w8a8(cfg, routed, jnp.asarray(h), q)).reshape(1, 128, -1)
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    full = TM.moe_ffn_w8a8(tcfg, tlp, torch.from_numpy(h), tq)
    assert np.array_equal(full.numpy(), np.asarray(JM.moe_ffn_w8a8(cfg, lp, jnp.asarray(h), q)))


@pytest.mark.parametrize("arch", MOE)
def test_moe_float_ffn(arch):
    cfg, tcfg = _cfgs(arch)
    tlp = {"mlp": TM.init_moe_layer(tcfg, torch.Generator().manual_seed(7))}
    lp = _to_jax(tlp)
    h = np.random.default_rng(8).standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    want, want_aux = JM.moe_ffn(cfg, lp["mlp"], jnp.asarray(h))
    got, got_aux = TM.moe_ffn(tcfg, tlp["mlp"], torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)
    assert TM.n_experts_padded(tcfg) == JM.n_experts_padded(cfg) == 16
    assert TM.capacity(tcfg, 8) == 5 and TM.capacity(tcfg, 1) == tcfg.top_k  # 2 of 4


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------


def _recurrence(x, dta, Bm, Cm, s0):
    """Step by step in float64: S_t = S_{t-1} exp(a_t) + x_t (outer) B_t,
    y_t = S_t C_t."""
    x, dta, Bm, Cm, s = (np.asarray(a, np.float64) for a in (x, dta, Bm, Cm, s0))
    ys = []
    for t in range(x.shape[1]):
        s = s * np.exp(dta[:, t])[:, :, None, None] + \
            x[:, t][..., None] * Bm[:, t][:, None, None, :]
        ys.append(np.einsum("bhpn,bn->bhp", s, Cm[:, t]))
    return np.stack(ys, axis=1), s


@pytest.mark.parametrize("length,chunk,pad", [(64, 16, 0), (40, 32, 24), (24, 8, 0)])
def test_ssd_chunked(length, chunk, pad):
    """``ssd_chunked`` against the reference's and against the recurrence;
    ``pad`` zero steps at the end (zero input, zero log-decay) leave the
    state as it was, which is what ``block_forward``'s chunk pad relies on."""
    rng = np.random.default_rng(length)
    b, h, p, n = 2, 3, 4, 5
    x = rng.standard_normal((b, length, h, p)).astype(np.float32)
    dta = -np.abs(rng.standard_normal((b, length, h))).astype(np.float32) * 0.3
    Bm = rng.standard_normal((b, length, n)).astype(np.float32)
    Cm = rng.standard_normal((b, length, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2)) for a in (x, dta, Bm, Cm)]
    jy, js = JMB.ssd_chunked(*map(jnp.asarray, padded), chunk, jnp.asarray(s0))
    ty, ts = TMB.ssd_chunked(*map(torch.from_numpy, padded), chunk, torch.from_numpy(s0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MODEL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **MODEL)
    ry, rs = _recurrence(x, dta, Bm, Cm, s0)
    np.testing.assert_allclose(ty.numpy()[:, :length], ry, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), rs, rtol=1e-4, atol=1e-4)


def test_segsum_masks_before_exp():
    a = torch.tensor([[-0.5, -1.0, -0.25]])
    seg = TMB._segsum(a)
    assert torch.isinf(seg[0, 0, 1]) and seg[0, 2, 0] == -1.25
    assert torch.equal(torch.exp(seg), torch.tril(torch.exp(seg)))
    np.testing.assert_array_equal(seg.numpy(), np.asarray(JMB._segsum(jnp.asarray(a.numpy()))))


# ---------------------------------------------------------------------------
# zamba2's integer shared attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("decode", [False, True])
def test_zamba2_shared_attention_exact_from_same_h_q(monkeypatch, decode):
    """With both packages' float norms set to the identity and the shared
    MLP zeroed, the float input x meets the integer path as the same
    ``h_q = rint(x / S_HYB)`` in both; from there the QKV and O products,
    the integer RoPE, the flash (prefill) or cached (decode) attention and
    the K/V written and the int8 ``o_q`` are bit-exact."""
    cfg, tcfg = _cfgs("zamba2-2.7b")
    tshared = TZ.init_params(tcfg, seed=9)["shared"]
    tshared["mlp"] = {k: {n: torch.zeros_like(t) for n, t in v.items()}
                      for k, v in tshared["mlp"].items()}
    shared = _to_jax(tshared)
    qs = JZ.quantize_shared(shared)
    tqs = from_jax_quantized(_np(qs))
    monkeypatch.setattr(JL, "norm_apply", lambda kind, p, x: x)
    monkeypatch.setattr(TL, "norm_apply", lambda kind, p, x: x)
    rng = np.random.default_rng(10)
    s, max_len, pos = (1, 32, 17) if decode else (32, 32, 0)
    x = (rng.standard_normal((2, s, cfg.d_model)) * 3).astype(np.float32)
    shape = (2, cfg.n_kv_heads, max_len, cfg.head_dim)
    kc = rng.integers(-128, 128, shape).astype(np.int8)
    vc = rng.integers(-128, 128, shape).astype(np.int8)
    j_attn = jax.jit(JZ._shared_attn_i8, static_argnums=0)
    if decode:
        jx, (jk, jv) = j_attn(cfg, shared, qs, jnp.asarray(x), jnp.asarray([pos]),
                              (jnp.asarray(kc), jnp.asarray(vc), pos))
        tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        tx, (tk, tv) = TZ._shared_attn_i8(tcfg, tshared, tqs, torch.from_numpy(x), [pos],
                                          (tk, tv, pos))
    else:
        jx, (jk, jv) = j_attn(cfg, shared, qs, jnp.asarray(x), jnp.arange(s))
        tx, (tk, tv) = TZ._shared_attn_i8(tcfg, tshared, tqs, torch.from_numpy(x),
                                          torch.arange(s))
    assert np.array_equal(tk.numpy(), np.asarray(jk)) and np.array_equal(tv.numpy(), np.asarray(jv))
    # x + o_q * S_HYB: the int8 o_q read back from each output is equal
    # (XLA fuses the multiply-add, so the float sums may differ by an ulp)
    o_t = np.rint((tx.numpy() - x) / TZ.S_HYB)
    o_j = np.rint((np.asarray(jx) - x) / JZ.S_HYB)
    assert np.array_equal(o_t, o_j) and np.abs(o_t).max() > 0
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
