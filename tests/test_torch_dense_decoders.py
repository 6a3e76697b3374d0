"""The three other dense decoders through the port's deploy flow, against the JAX package.

StableLM-1.6B (parametric LayerNorm, SwiGLU), Qwen1.5-110B (QKV bias,
GQA with 8 KV heads) and Mistral-Large-123B (GQA with 8 KV heads), all
with an untied LM head:

* at full width, plans only (no weights): the ``DecoderPlanPair``'s JSON,
  fingerprint and options equal the JAX package's on both backends, and
  so do the static verifier's findings (0, 1120 and 1232 ``QNT002``);
* at reduced widths (2 layers, GQA 4/2): the plan pair's prefill and
  chained decode steps, and the model-level ``prefill_w8a8`` /
  ``decode_step_w8a8``, equal the JAX package's bit for bit (tolerance
  zero) on the same ints (the reference's bound weights, carried by
  ``repro_torch.convert``).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.deploy import api as j_api
from repro.deploy.executor import execute_decode as j_decode
from repro.deploy.executor import execute_prefill as j_prefill
from repro.models import transformer as JT
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import from_jax_quantized
from repro_torch.deploy import api as t_api
from repro_torch.deploy.executor import execute_decode as t_decode
from repro_torch.deploy.executor import execute_prefill as t_prefill
from repro_torch.models import transformer as TT

ARCHS = ["stablelm-1.6b", "qwen1.5-110b", "mistral-large-123b"]
#: the verifier's QNT002 warnings on each full-width pair (both packages)
QNT002 = {"stablelm-1.6b": 0, "qwen1.5-110b": 1120, "mistral-large-123b": 1232}
SEQ, GEN = 16, 3
MAX_LEN = SEQ + GEN + 1


def _equal(got: torch.Tensor, want) -> bool:
    return np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", ["w8a8", "ita"])
@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_plan_pair_equals_reference(arch, backend):
    kw = dict(backend=backend, seq_len=128, max_len=160, use_cache=False)
    want = j_api.compile(get_config(arch), **kw)
    got = t_api.compile(t_get_config(arch), **kw)
    assert got.kind == want.kind == "decoder"
    assert got.artifact.to_dict() == want.artifact.to_dict()
    assert got.fingerprint == want.fingerprint and got.options == want.options
    rules = collections.Counter(d.rule for d in got.diagnostics)
    assert rules == collections.Counter(d.rule for d in want.diagnostics)
    assert rules == (collections.Counter({"QNT002": QNT002[arch]}) if QNT002[arch]
                     else collections.Counter())
    cfg = t_get_config(arch)
    gemms = sum(n.kind == "gemm" and n.engine == "ita"
                for n in got.artifact.prefill.flat_nodes())
    assert gemms == 7 * cfg.n_layers  # Q, K, V, O, gate, up, down a layer
    assert all(n.engine == "cluster" for n in got.artifact.decode.flat_nodes())


def test_configs_cover_the_decoder_features():
    """What each config brings to the deploy flow that OLMo-1B does not."""
    stablelm, qwen, mistral = (t_get_config(a) for a in ARCHS)
    assert stablelm.norm == "layernorm" and stablelm.mlp == "swiglu"
    assert qwen.qkv_bias and qwen.n_kv_heads == 8 < qwen.n_heads
    assert mistral.n_kv_heads == 8 < mistral.n_heads and not mistral.qkv_bias
    assert not any(c.tie_embeddings for c in (stablelm, qwen, mistral))


def _compile_both(arch, backend, key):
    cfg, tcfg = reduced(get_config(arch)), t_reduced(t_get_config(arch))
    jm = j_api.compile(cfg, backend=backend, seq_len=SEQ, max_len=MAX_LEN, use_cache=False,
                       verify=False)
    weights, qp = jm.bind(key=jax.random.PRNGKey(key))
    tm = t_api.compile(tcfg, backend=backend, seq_len=SEQ, max_len=MAX_LEN, use_cache=False)
    tqp = from_jax_quantized(jax.tree.map(np.asarray, qp))
    tweights, _ = tm.bind(qp=tqp)
    assert tm.artifact.to_dict() == jm.artifact.to_dict()
    return cfg, tcfg, jm, weights, qp, tm, tweights, tqp


@pytest.mark.parametrize("backend", ["w8a8", "ita"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_plan_chain_equals_reference(arch, backend):
    """The fused plan pair's prefill and 3 chained decode steps: logits, K
    and V caches and ``len`` equal at every step (``ita``: the JAX
    package's Pallas kernels in interpret mode, the port's plain
    versions)."""
    cfg, _, jm, weights, _, tm, tweights, _ = _compile_both(arch, backend, key=5)
    pair = jm.artifact
    j_pre = jax.jit(lambda w, b: j_prefill(pair, w, b, backend=backend))
    j_dec = jax.jit(lambda w, c, t: j_decode(pair, w, c, t, backend=backend))
    tokens = np.random.default_rng(21).integers(0, cfg.vocab, (2, SEQ)).astype(np.int32)
    jl, jc = j_pre(weights, {"tokens": jnp.asarray(tokens)})
    tl, tc = t_prefill(tm.artifact, tweights, {"tokens": torch.from_numpy(tokens)},
                       backend=backend)
    for step in range(GEN + 1):
        assert _equal(tl, jl), f"logits, step {step}"
        assert _equal(tc["k"], jc["k"]) and _equal(tc["v"], jc["v"]), f"cache, step {step}"
        assert int(tc["len"]) == int(jc["len"]) == SEQ + step
        if step == GEN:
            break
        tok = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
        jl, jc = j_dec(weights, jc, jnp.asarray(tok))
        tl, tc = t_decode(tm.artifact, tweights, tc, torch.from_numpy(tok), backend=backend)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_model_chain_equals_reference(arch):
    """``prefill_w8a8`` + 3 ``decode_step_w8a8`` of both packages, and the
    plan's prefill equal to the model's."""
    cfg, tcfg, _, weights, qp, tm, tweights, tqp = _compile_both(arch, "w8a8", key=6)
    tokens = np.random.default_rng(22).integers(0, cfg.vocab, (2, SEQ)).astype(np.int32)
    jl, jc = jax.jit(JT.prefill_w8a8, static_argnums=(0, 3))(
        cfg, qp, {"tokens": jnp.asarray(tokens)}, MAX_LEN)
    tl, tc = TT.prefill_w8a8(tcfg, tqp, {"tokens": torch.from_numpy(tokens)}, MAX_LEN)
    plan_logits, _ = t_prefill(tm.artifact, tweights, {"tokens": torch.from_numpy(tokens)},
                               backend="w8a8")
    assert torch.equal(plan_logits, tl)
    step_fn = jax.jit(JT.decode_step_w8a8, static_argnums=0)
    for step in range(GEN + 1):
        assert _equal(tl, jl) and _equal(tc["k"], jc["k"]) and _equal(tc["v"], jc["v"])
        assert int(tc["len"]) == int(jc["len"]) == SEQ + step
        if step == GEN:
            break
        tok = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
        jl, jc = step_fn(cfg, qp, jc, jnp.asarray(tok))
        tl, tc = TT.decode_step_w8a8(tcfg, tqp, tc, torch.from_numpy(tok))
