"""The second slice of the port against the JAX package: the unfused-GELU
path on ``ita``, the ``softmax``/``gelu`` dispatch kinds, and the card's
integer arithmetic of the ``w8a8`` backend, bit for bit, on the CPU.

* dinov2-small at DeiT-Ti widths (d_model 192, 3 heads of 64; Touvron et
  al. 2021, Table 1), cut to 2 layers and d_ff 512: no GEMM width is a
  multiple of 128, so on ``ita`` every GEMM goes to the cluster and each
  GELU stays a node of its own, on the ``igelu`` slot.  Its plan equals
  the JAX package's, and its CPU forward equals the JAX ``execute``, which
  runs the Pallas i-GeLU kernel in interpret mode.
* At 100 tokens the port's executor resolves the GELU rows padded to the
  granule, as the plan does, so the node still takes the ``igelu`` slot
  (the JAX executor takes its plain form there: the same ints).
* With ``imatmul`` swapped for ``imatmul_exact`` (what it runs on CUDA
  tensors) the forwards still equal the reference on both backends.
"""

import inspect

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.deploy import api as j_api
from repro.deploy.executor import execute as j_execute
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import from_jax_quantized
from repro_torch.core import attention as t_attention
from repro_torch.core import quant_linear as t_quant_linear
from repro_torch.core.heterogeneous import (
    DEFAULT_TABLE,
    Backend,
    DispatchTable,
    Engine,
    OpDesc,
    populate_default_table,
)
from repro_torch.deploy import api as t_api
from repro_torch.kernels.igelu import igelu, igelu_ref
from repro_torch.kernels.itamax import itamax
from repro_torch.quant.qparams import imatmul_exact

DEIT_TI = dict(name="dinov2-small-deit-ti-widths", n_layers=2, d_model=192, n_heads=3,
               n_kv_heads=3, head_dim=64, d_ff=512)


def _configs(seq):
    kw = dict(DEIT_TI, n_patches=seq, max_seq=seq)
    return get_config("dinov2-small").replace(**kw), t_get_config("dinov2-small").replace(**kw)


def _carried(cfg, tcfg, backend, key=4):
    jm = j_api.compile(cfg, backend=backend, use_cache=False, verify=False)
    weights, qp = jm.bind(key=jax.random.PRNGKey(key))
    tm = t_api.compile(tcfg, backend=backend, use_cache=False)
    return jm, weights, tm, from_jax_quantized(jax.tree.map(np.asarray, qp))


def _patches(cfg, seq, seed):
    x = np.random.default_rng(seed).integers(-64, 64, size=(1, seq, cfg.d_model))
    return x.astype(np.int8)


def _engines(plan):
    out: dict = {}
    for n in plan.nodes:
        out.setdefault(n.kind, {}).setdefault(n.engine, 0)
        out[n.kind][n.engine] += 1
    return out


def _counting_table():
    """The default runners, with the ``ita`` GELU slot counted."""
    table = populate_default_table(DispatchTable())
    calls = []
    ita_gelu = table.overrides[("gelu", Engine.ACCELERATOR, Backend.ITA)]

    def counted(x_q, **kw):
        calls.append(tuple(x_q.shape))
        return ita_gelu(x_q, **kw)

    table.register("gelu", Engine.ACCELERATOR, counted, backend=Backend.ITA)
    return table, calls


@pytest.mark.parametrize("seq", [128, 100])
def test_deit_ti_widths_plan_equals_reference(seq):
    cfg, tcfg = _configs(seq)
    want = j_api.compile(cfg, backend="ita", use_cache=False, verify=False)
    got = t_api.compile(tcfg, backend="ita", use_cache=False)
    assert got.artifact.to_dict() == want.artifact.to_dict()
    assert got.fingerprint == want.fingerprint
    assert _engines(got.artifact)["gelu"] == {"ita": 2}
    assert _engines(got.artifact)["mha"] == {"ita": 2}
    assert _engines(got.artifact)["gemm"] == {"cluster": 4}


@pytest.mark.parametrize("seq", [128, 100])
def test_deit_ti_widths_forward_equals_reference(seq):
    """At 128 tokens the JAX executor runs the Pallas i-GeLU (interpret
    mode); at 100 its plain form.  The port takes the igelu slot at both."""
    cfg, tcfg = _configs(seq)
    jm, weights, tm, tqp = _carried(cfg, tcfg, "ita")
    patches = _patches(cfg, seq, seq)
    want = np.asarray(j_execute(jm.artifact, weights, {"patches": patches}, backend="ita"))
    table, calls = _counting_table()
    got = tm.session(1, qp=tqp, device="cpu", table=table).forward(torch.from_numpy(patches))
    assert got.shape == (1, seq, cfg.d_model)
    assert np.array_equal(got.numpy(), want)
    assert calls == [(1, seq, cfg.d_ff)] * cfg.n_layers


@pytest.mark.parametrize("backend", ["w8a8", "ita"])
def test_card_arithmetic_forward_equals_reference(monkeypatch, backend):
    """The products as the card computes them (``torch._int_mm`` or
    float64): the DeiT-Ti-width forward at 100 tokens, both backends."""
    monkeypatch.setattr(t_attention, "imatmul", imatmul_exact)
    monkeypatch.setattr(t_quant_linear, "imatmul", imatmul_exact)
    cfg, tcfg = _configs(100)
    jm, weights, tm, tqp = _carried(cfg, tcfg, backend, key=5)
    patches = _patches(cfg, 100, 7)
    want = np.asarray(j_execute(jm.artifact, weights, {"patches": patches}, backend=backend))
    got = tm.session(1, qp=tqp, device="cpu").forward(torch.from_numpy(patches))
    assert np.array_equal(got.numpy(), want)


def test_default_table_has_softmax_and_gelu():
    assert {"softmax", "gelu"} <= set(DEFAULT_TABLE.table)
    # softmax: the cluster only (the ITAMax unit serves the MHA datapath alone)
    desc = OpDesc("softmax", shapes=((3, 256, 256),))
    for backend in Backend:
        assert DEFAULT_TABLE.resolve(desc, backend) == (Engine.CLUSTER, itamax)
    # gelu: the igelu kernel in the ita slot, the plain form elsewhere
    aligned = OpDesc("gelu", shapes=((256, 768),))
    engine, fn = DEFAULT_TABLE.resolve(aligned, Backend.ITA)
    assert engine is Engine.ACCELERATOR
    assert inspect.getclosurevars(fn).nonlocals == {"igelu": igelu}
    for desc, backend in [(aligned, Backend.W8A8), (OpDesc("gelu", shapes=((256, 192),)),
                                                   Backend.ITA)]:
        _, fn = DEFAULT_TABLE.resolve(desc, backend)
        assert inspect.getclosurevars(fn).nonlocals == {"igelu_ref": igelu_ref}
    x = torch.arange(-128, 128, dtype=torch.int8).reshape(2, 128)
    assert torch.equal(fn(x, s_in=0.05, s_out=0.05), igelu(x, in_scale=0.05, out_scale=0.05))
