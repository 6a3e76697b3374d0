"""The paper's head-by-head MHA schedule in the port, against the JAX package.

* ``compile(head_by_head=True)`` lowers the three full encoders to the
  reference's plans (JSON and fingerprint), on both backends;
* ``deploy_pipeline(g)`` with no flag splits the heads in both packages
  and returns the same graph;
* the port's session forward of a head-by-head plan equals the
  reference's ``execute`` (``w8a8``, and ``ita`` with Pallas in interpret
  mode), and the port's model branch (``forward_w8a8`` with
  ``ita_head_by_head``) equals the reference's, bit for bit.

Head-by-head is held against head-by-head: its bias is requantized on its
own after the head sum, so it agrees with the fused MHA only closely.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core.heterogeneous import DEFAULT_TABLE as J_TABLE
from repro.core.heterogeneous import Backend as JBackend
from repro.core.heterogeneous import OpDesc as JOpDesc
from repro.deploy import api as j_api
from repro.deploy import patterns as j_patterns
from repro.deploy.executor import execute as j_execute
from repro.deploy.lowering import build_runtime_encoder_graph as j_graph
from repro.deploy.lowering import schedule as j_schedule
from repro.deploy.plan import DeploymentPlan as JPlan
from repro.models import encoder as JE
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import from_jax_quantized
from repro_torch.core.heterogeneous import DEFAULT_TABLE as T_TABLE
from repro_torch.core.heterogeneous import Backend as TBackend
from repro_torch.core.heterogeneous import OpDesc as TOpDesc
from repro_torch.deploy import api as t_api
from repro_torch.deploy import patterns as t_patterns
from repro_torch.deploy.lowering import build_runtime_encoder_graph as t_graph
from repro_torch.deploy.lowering import schedule as t_schedule
from repro_torch.models import encoder as TE

ARCHS = ("mobilebert", "whisper-tiny-encoder", "dinov2-small")


@pytest.mark.parametrize("backend", ["w8a8", "ita"])
@pytest.mark.parametrize("arch", ARCHS)
def test_head_by_head_plan_equals_reference(arch, backend):
    kw = dict(backend=backend, head_by_head=True, use_cache=False)
    want = j_api.compile(get_config(arch), verify=False, **kw)
    got = t_api.compile(t_get_config(arch), **kw)
    assert got.artifact.to_dict() == want.artifact.to_dict()
    assert got.fingerprint == want.fingerprint and got.options == want.options
    assert JPlan.from_json(got.artifact.to_json()) == want.artifact
    cfg = t_get_config(arch)
    heads = [n for n in got.artifact.nodes if n.op == "MHAHead"]
    assert len(heads) == cfg.n_layers * cfg.n_heads
    assert all(n.engine == "ita" for n in heads)
    assert sum(n.op == "HeadAccum" and n.engine == "cluster"
               for n in got.artifact.nodes) == cfg.n_layers


def _graph_dict(g):
    return [(n.name, n.op, list(n.inputs), list(n.outputs), n.engine,
             {k: tuple(v) if isinstance(v, list) else v for k, v in n.attrs.items()})
            for n in g.nodes], {k: dataclasses.astuple(v) for k, v in g.tensors.items()}


@pytest.mark.parametrize("arch,full,seq", [
    ("mobilebert", True, 64), ("mobilebert", False, 64), ("whisper-tiny-encoder", False, 64),
], ids=["mobilebert-full", "mobilebert-reduced", "whisper-reduced"])
def test_default_pipeline_splits_heads_as_reference(arch, full, seq):
    """``deploy_pipeline(g)`` defaults to the head split in both packages."""
    cfg = get_config(arch) if full else reduced(get_config(arch))
    tcfg = t_get_config(arch) if full else t_reduced(t_get_config(arch))
    want = j_patterns.deploy_pipeline(j_graph(cfg, seq))
    got = t_patterns.deploy_pipeline(t_graph(tcfg, seq))
    assert _graph_dict(got) == _graph_dict(want)
    heads = [n for n in got.nodes if n.op == "MHAHead"]
    assert len(heads) == tcfg.n_layers * tcfg.n_heads  # 96 for full MobileBERT
    assert not any(n.op == "MHA" for n in got.nodes)
    # the reference's own default-call checks (tests/test_deploy.py,
    # tests/test_plan_executor.py), on the port
    engines = {n.op: n.engine for n in got.nodes}
    # the single-head datapath takes a head of 64 (reduced configs have 32)
    assert engines["MHAHead"] == ("ita" if tcfg.head_dim % 64 == 0 else "cluster")
    assert engines["HeadAccum"] == "cluster"
    assert engines["LayerNorm"] == "cluster" and engines["Add"] == "cluster"
    assert not any(n.op == "GELU" for n in got.nodes)
    assert any(n.attrs.get("activation") == "gelu" for n in got.nodes)
    order = t_schedule(got)
    assert [n.name for n in order] == [n.name for n in j_schedule(want)]
    seen = set(got.inputs) | set(got.weights)
    for n in order:
        assert all(t in seen for t in n.inputs), n.name
        seen.update(n.outputs)
    fused = t_patterns.deploy_pipeline(t_graph(tcfg, seq), head_by_head=False)
    assert sum(n.op == "MHA" for n in fused.nodes) == tcfg.n_layers


def _carried(cfg, tcfg, backend, seq_len, key=3):
    jm = j_api.compile(cfg, backend=backend, seq_len=seq_len, head_by_head=True,
                       use_cache=False, verify=False)
    weights, qp = jm.bind(key=jax.random.PRNGKey(key))
    tm = t_api.compile(tcfg, backend=backend, seq_len=seq_len, head_by_head=True,
                       use_cache=False)
    return jm, weights, qp, tm, from_jax_quantized(jax.tree.map(np.asarray, qp))


#: (arch, backend, seq): head_dim 64 so that the heads are accelerated on
#: ``ita``, where the per-head projections (N = 64) go to the cluster and
#: a sequence of 64 is padded to the attention kernel's 128-row blocks
#: (the reference's model path needs 128-row GEMMs: batch 2 x 64)
CASES = [("mobilebert", "w8a8", 64), ("mobilebert", "ita", 128),
         ("dinov2-small", "ita", 64), ("whisper-tiny-encoder", "w8a8", 64)]


@pytest.mark.parametrize("arch,backend,seq", CASES,
                         ids=[f"{a}-{b}-{s}" for a, b, s in CASES])
def test_head_by_head_forward_equals_reference(arch, backend, seq):
    base = dict(head_dim=64, max_seq=seq)
    if arch != "mobilebert":
        base.update(vocab=0, n_patches=seq) if arch == "dinov2-small" else \
            base.update(vocab=0, n_frames=seq)
    cfg = reduced(get_config(arch)).replace(**base)
    tcfg = t_reduced(t_get_config(arch)).replace(**base)
    jm, weights, qp, tm, tqp = _carried(cfg, tcfg, backend, seq)
    assert tm.artifact.to_dict() == jm.artifact.to_dict()
    name = tm.artifact.inputs[0]
    rng = np.random.default_rng(7)
    if name == "tokens":
        x = rng.integers(0, cfg.vocab, size=(2, seq)).astype(np.int32)
    else:
        x = rng.integers(-64, 64, size=(2, seq, cfg.d_model)).astype(np.int8)
    want = np.asarray(j_execute(jm.artifact, weights, {name: x}, backend=backend))
    got = tm.session(2, qp=tqp, device="cpu").forward(torch.from_numpy(x))
    assert np.array_equal(got.numpy(), want)
    # the plan's schedule is the model's head-by-head branch, in both packages
    batch = {name: x}
    j_model = JE.forward_w8a8(cfg.replace(ita_head_by_head=True), qp, batch, backend=backend)
    t_model = TE.forward_w8a8(tcfg.replace(ita_head_by_head=True), tqp,
                              {name: torch.from_numpy(x)}, backend=backend)
    assert np.array_equal(t_model.numpy(), np.asarray(j_model))
    if backend == "w8a8":
        assert np.array_equal(got.numpy(), np.asarray(j_model))


def test_model_head_by_head_equals_reference_with_gqa():
    """The model branch with grouped KV heads (4 query heads on 2 KV heads)."""
    shape = dict(head_dim=64, n_kv_heads=2, max_seq=64, vocab=512)
    cfg = reduced(get_config("mobilebert")).replace(ita_head_by_head=True, **shape)
    tcfg = t_reduced(t_get_config("mobilebert")).replace(ita_head_by_head=True, **shape)
    qp = JE.quantize_params(cfg, JE.init_params(cfg, jax.random.PRNGKey(4)))
    tqp = from_jax_quantized(jax.tree.map(np.asarray, qp))
    tokens = np.random.default_rng(8).integers(0, cfg.vocab, size=(2, 64)).astype(np.int32)
    for backend in ("w8a8", "ita"):
        want = JE.forward_w8a8(cfg, qp, {"tokens": jnp.asarray(tokens)}, backend=backend)
        got = TE.forward_w8a8(tcfg, tqp, {"tokens": torch.from_numpy(tokens)}, backend=backend)
        assert np.array_equal(got.numpy(), np.asarray(want)), backend


def test_head_accum_runner_equals_reference():
    """The cluster ``headaccum``: int32 sum (wrapping), one requant, then the
    separately requantized bias added after it."""
    rng = np.random.default_rng(9)
    parts = [rng.integers(-(1 << 29), 1 << 29, size=(2, 5, 16)).astype(np.int32)
             for _ in range(6)]
    bias = rng.integers(-5000, 5000, size=(16,)).astype(np.int32)
    scales = (0.05, 0.01, 0.04)
    _, j_fn = J_TABLE.resolve(JOpDesc("headaccum", shapes=((5, 16),)), JBackend.W8A8)
    _, t_fn = T_TABLE.resolve(TOpDesc("headaccum", shapes=((5, 16),)), TBackend.W8A8)
    for b in (None, bias):
        want = j_fn([jnp.asarray(p) for p in parts], None if b is None else jnp.asarray(b),
                    scales=scales)
        got = t_fn([torch.from_numpy(p) for p in parts],
                   None if b is None else torch.from_numpy(b), scales=scales)
        assert got.dtype == torch.int8 and np.array_equal(got.numpy(), np.asarray(want))


def test_serve_head_by_head_cli_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "mobilebert", "--reduced", "--batch", "2", "--gen", "1",
                "--device", "cpu", "--no-plan-cache", "--backend", "w8a8", "--head-by-head"])
    out = capsys.readouterr().out
    assert "plan-serving [w8a8] mobilebert on cpu" in out and "inf/s" in out
    # 2 layers: 4 heads and one head accumulation each, on top of the fused plan
    fused = t_api.compile(t_reduced(t_get_config("mobilebert")), use_cache=False)
    split = t_api.compile(t_reduced(t_get_config("mobilebert")), head_by_head=True,
                          use_cache=False)
    assert split.fingerprint[:12] in out  # the plan compiled with the head split
    assert split.counts()["nodes"] == fused.counts()["nodes"] + 2 * 4
    assert f"{split.counts()['nodes']} nodes" in out


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernel_calls(plan, backend: str) -> dict:
    """Kernel launches of one forward, from the plan and the dispatch table:
    an accelerated GEMM on ``ita`` is one int8_gemm, an accelerated head on
    ``ita`` one ita_attention, and any other attention the rowwise one,
    whose softmax is one itamax."""
    from repro_torch.core.heterogeneous import Backend, Engine, backend_granule
    from repro_torch.deploy.executor import _gemm_desc, _mha_desc

    be = Backend(backend)
    g = backend_granule(be)
    calls = {"int8_gemm": 0, "ita_attention": 0, "itamax": 0}

    def on_ita(desc):
        return be is Backend.ITA and T_TABLE.resolve(desc, be)[0] is Engine.ACCELERATOR

    for n in plan.nodes:
        a = n.attrs
        if n.kind == "gemm":
            m, k, nn = a["dims"]
            calls["int8_gemm"] += on_ita(_gemm_desc(m, k, nn, g, a.get("activation", "identity")))
        elif n.op == "MHAHead":
            calls["int8_gemm"] += 3 * on_ita(_gemm_desc(a["seq"], a["d_model"], a["head_dim"], g))
            attn = "ita_attention" if on_ita(_mha_desc(a["seq"], a["head_dim"], g)) else "itamax"
            calls[attn] += 1
        else:
            assert n.kind in ("layernorm", "add", "headaccum", "embed", "classifier", "dequant")
    return {k: v for k, v in calls.items() if v}


def test_chip_smoke_launch_table_is_the_plans():
    """chip_smoke.py requires these launches per forward on the card."""
    table = _chip_smoke().HEAD_BY_HEAD
    assert {(a, b) for a, b, _ in table} == {(a, b) for a in ARCHS for b in ("ita", "w8a8")}
    for arch, backend, want in table:
        model = t_api.compile(t_get_config(arch), backend=backend, head_by_head=True,
                              use_cache=False)
        assert _kernel_calls(model.artifact, backend) == want, (arch, backend)


def test_attention_grid_at_one_head():
    """ita_attention's launch shape at the schedule's B*H = 8: two row
    groups a block, two warps a 16-row tile, every output row once."""
    from repro_torch.kernels.ita_attention.ops import attn_grid, attn_smem, SMEM_MAX

    for s in (128, 256, 512):
        groups, split, slots, gx, gy = attn_grid(8, s, 64, 128)
        assert (groups, split, gy) == (2, 2, 1) and groups * split == 4
        assert gx == 8 * s // 32 and attn_smem(groups, 128, 64, slots) <= SMEM_MAX


def test_head_partial_product_skips_int_mm(monkeypatch):
    """A head's partial output projection has depth head_dim = 64, which
    cuBLASLt's int8 GEMM does not take at every row count: the exact
    product runs it in float64, and deeper products keep torch._int_mm."""
    from repro_torch.quant.qparams import INT_MM_MIN_DEPTH, imatmul_exact

    calls = []

    def int_mm(a, b):
        calls.append(tuple(a.shape))
        return torch.matmul(a.int(), b.int())

    monkeypatch.setattr(torch, "_int_mm", int_mm)
    g = torch.Generator().manual_seed(1)
    for k in (64, INT_MM_MIN_DEPTH):
        a = torch.randint(-128, 128, (2, 241, k), generator=g, dtype=torch.int8)
        w = torch.randint(-127, 128, (k, 384), generator=g, dtype=torch.int8)
        assert torch.equal(imatmul_exact(a, w), torch.matmul(a.int(), w.int()))
    assert calls == [(482, INT_MM_MIN_DEPTH)]
