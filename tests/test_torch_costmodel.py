"""The port's ITA cost model and autotuner against the JAX package's, float for float.

The cost model's constants are the paper's 22 nm ITA ASIC's; the tuner
argmins over its predicted decode-step time and the result enters the
plan JSON and the compile fingerprint, so every float must be equal
(``==``, never ``isclose``):

* ``gemm_util`` / ``gemm_cycles`` / ``mha_head_cycles`` over a shape sweep,
  with the reference's anchors (85.1 % GEMM utilisation, 870.4 GOp/s
  peak, standalone above integrated);
* ``network_cost`` and ``network_cost_cluster_only`` of
  ``build_encoder_graph`` for the three paper encoders, every field;
* ``fit_cluster_constants`` on the paper's Table I times;
* ``plan_step_cost`` / ``plan_node_cycles`` of fused, unfused and paged
  decode plans, reduced and at OLMo-1B's full width;
* ``tune_decoder`` and ``compile(autotune=True)``: knobs, payload, plan
  JSON and fingerprint, reduced OLMo dense and paged, and full-width
  OLMo-1B paged with the chip smoke's options;
* the reference's autotune tests of ``tests/test_fusion.py`` (round trip,
  the encoder refusal, the cache hit, the fingerprint change, the cost
  ordering of fusion), ``hw_target``, and on the CPU the tuned pair's
  greedy streams against the untuned pair's on both backends.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

from repro.configs import get_config, reduced
from repro.deploy import api as j_api
from repro.deploy import autotune as j_tune
from repro.deploy import costmodel as j_cost
from repro.deploy import graph as j_graph
from repro.deploy import patterns as j_patterns
from repro.deploy.plan import DeploymentPlan as JPlan
from repro.models import transformer as JT
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import from_jax_quantized
from repro_torch.deploy import api as t_api
from repro_torch.deploy import autotune as t_tune
from repro_torch.deploy import costmodel as t_cost
from repro_torch.deploy import graph as t_graph
from repro_torch.deploy import patterns as t_patterns
from repro_torch.deploy.engine import Engine
from repro_torch.deploy.lowering import lower_decoder as t_lower_decoder
from repro_torch.deploy.plan import DeploymentPlan as TPlan

#: the reduced decoder geometry of the reference's tests/test_fusion.py
SEQ, MAX_LEN, BLOCK, KV_BLOCKS = 8, 24, 4, 14
#: paper Table I inferences per second, and the sequence lengths of
#: benchmarks/table1_e2e.py
PAPER_INF_S = {"mobilebert": 32.5, "dinov2-small": 4.83, "whisper-tiny-encoder": 6.52}
PAPER_SEQ = {"mobilebert": 128, "dinov2-small": 241, "whisper-tiny-encoder": 512}
#: the chip smoke's engine options, and the JAX package's knobs for them
OLMO_PAGED = dict(backend="ita", seq_len=128, max_len=272, kv_block_size=16,
                  kv_blocks=145, prefix_cache=True)
OLMO_KNOBS = {"kv_block_size": 64, "kv_blocks": 37, "fuse_min_nodes": 2, "gemm_tiles": {}}
OLMO_PREDICTED_COST_S = 3.2326556330493577

NET_FIELDS = ("gop", "t_ita_s", "t_cluster_s", "e_j", "n_tiles", "t_total_s", "inf_per_s",
              "gop_per_s", "gop_per_j", "mj_per_inf")


@pytest.fixture(scope="module")
def cfgs():
    return reduced(get_config("olmo-1b")), t_reduced(t_get_config("olmo-1b"))


def _fields(obj, names):
    return {k: getattr(obj, k) for k in names}


# ---------------------------------------------------------------------------
# accelerated op costs
# ---------------------------------------------------------------------------

GEMM_SHAPES = [(512, 512, 512), (128, 768, 768), (1, 2048, 2048), (197, 192, 768),
               (64, 64, 64), (241, 384, 1536), (128, 2048, 8192), (1500, 384, 1536)]


@pytest.mark.parametrize("standalone", [False, True], ids=["integrated", "standalone"])
def test_gemm_costs_equal(standalone):
    for m, n, k in GEMM_SHAPES:
        assert t_cost.gemm_util(m, n, k, standalone=standalone) == \
            j_cost.gemm_util(m, n, k, standalone=standalone)
        t_t = t_cost.solve_gemm_tiling(m, n, k)
        j_t = j_cost.solve_gemm_tiling(m, n, k)
        assert dataclasses.astuple(t_t) == dataclasses.astuple(j_t)
        assert t_cost.gemm_cycles(t_t, standalone=standalone) == \
            j_cost.gemm_cycles(j_t, standalone=standalone)


def test_gemm_anchors():
    """The reference's microbenchmark anchors (tests/test_deploy.py)."""
    u = t_cost.gemm_util(512, 512, 512)
    assert abs(u - 0.851) < 0.01, u
    hw = t_cost.HW
    peak = hw.ita_ops_per_cyc * hw.freq_hz / 1e9
    assert abs(peak - 870.4) < 1.0
    assert abs(peak * 0.851 - 741) < 6
    assert t_cost.gemm_util(512, 512, 512, standalone=True) > u
    assert dataclasses.asdict(t_cost.HW) == dataclasses.asdict(j_cost.HW)


@pytest.mark.parametrize("standalone", [False, True], ids=["integrated", "standalone"])
def test_mha_costs_equal(standalone):
    for seq, head_dim, d_model in [(128, 32, 128), (241, 64, 384), (512, 64, 384),
                                   (64, 64, 512), (1500, 64, 384)]:
        t_t, j_t = t_cost.solve_mha_tiling(seq, head_dim), j_cost.solve_mha_tiling(seq, head_dim)
        assert dataclasses.astuple(t_t) == dataclasses.astuple(j_t)
        assert t_t.n_tiles == j_t.n_tiles
        assert t_cost.mha_head_cycles(t_t, d_model, standalone=standalone) == \
            j_cost.mha_head_cycles(j_t, d_model, standalone=standalone)
        assert t_cost.mha_head_ops(seq, head_dim, d_model) == \
            j_cost.mha_head_ops(seq, head_dim, d_model)


# ---------------------------------------------------------------------------
# network-level cost of the paper graphs
# ---------------------------------------------------------------------------


def _graphs(arch, head_by_head=True):
    t = t_patterns.deploy_pipeline(
        t_graph.build_encoder_graph(t_get_config(arch), seq_len=PAPER_SEQ[arch]),
        head_by_head=head_by_head)
    j = j_patterns.deploy_pipeline(
        j_graph.build_encoder_graph(get_config(arch), seq_len=PAPER_SEQ[arch]),
        head_by_head=head_by_head)
    return t, j


def _graph_rows(g):
    return [(n.name, n.op, n.inputs, n.outputs, n.attrs, n.engine) for n in g.nodes]


@pytest.mark.parametrize("head_by_head", [True, False], ids=["head-by-head", "fused-mha"])
@pytest.mark.parametrize("arch", list(PAPER_SEQ))
def test_network_cost_equal(arch, head_by_head):
    raw_t = t_graph.build_encoder_graph(t_get_config(arch), seq_len=PAPER_SEQ[arch])
    raw_j = j_graph.build_encoder_graph(get_config(arch), seq_len=PAPER_SEQ[arch])
    assert _graph_rows(raw_t) == _graph_rows(raw_j)
    t, j = _graphs(arch, head_by_head)
    assert _graph_rows(t) == _graph_rows(j)
    for fn in ("network_cost", "network_cost_cluster_only"):
        got, want = getattr(t_cost, fn)(t), getattr(j_cost, fn)(j)
        assert _fields(got, NET_FIELDS) == _fields(want, NET_FIELDS), fn


def test_cluster_only_anchor():
    """Table I "Multi-Core": 0.74 GOp/s, ~28.9 GOp/J (tests/test_deploy.py)."""
    g = t_patterns.deploy_pipeline(
        t_graph.build_encoder_graph(t_get_config("mobilebert"), seq_len=128))
    c = t_cost.network_cost_cluster_only(g)
    assert abs(c.gop_per_s - 0.74) < 0.01
    assert abs(c.gop_per_j - 28.5) < 1.0


@pytest.mark.parametrize("arch", list(PAPER_SEQ))
def test_memory_plan_of_the_paper_graph(arch):
    """The static arena of the deployed paper graph against the reference's
    (tests/test_deploy.py): equal peaks and lower bounds, no overlap, the
    greedy best fit within 4x of the bound."""
    from repro.deploy import memory as j_memory
    from repro_torch.deploy import memory as t_memory

    t, j = _graphs(arch)
    t_plan, j_plan = t_memory.plan_memory(t), j_memory.plan_memory(j)
    lb = t_memory.peak_lower_bound(t)
    assert lb == j_memory.peak_lower_bound(j)
    assert t_plan.peak == j_plan.peak
    assert t_plan.check_no_overlap()
    assert lb <= t_plan.peak <= 4 * lb


def test_fit_cluster_constants_equal():
    pairs = {a: _graphs(a) for a in PAPER_INF_S}
    got = t_cost.fit_cluster_constants({a: (1.0 / PAPER_INF_S[a], t) for a, (t, _) in
                                        pairs.items()})
    want = j_cost.fit_cluster_constants({a: (1.0 / PAPER_INF_S[a], j) for a, (_, j) in
                                         pairs.items()})
    assert got == want
    d, c, _ = got
    t_hw = t_cost.HwConfig(dispatch_cyc_per_granule=d, aux_cyc_per_elem=c)
    j_hw = j_cost.HwConfig(dispatch_cyc_per_granule=d, aux_cyc_per_elem=c)
    for a, (t, j) in pairs.items():
        assert _fields(t_cost.network_cost(t, t_hw), NET_FIELDS) == \
            _fields(j_cost.network_cost(j, j_hw), NET_FIELDS)


def test_hw_target_ita_only():
    assert dataclasses.asdict(t_cost.hw_target("ita")) == dataclasses.asdict(j_cost.ITA_HET)
    assert t_cost.hw_target("ita").peak_flops == 2048 * 425e6
    assert not hasattr(t_cost, "TPU_V5E")
    with pytest.raises(ValueError, match=r"unknown hw target 'tpu'; choose from \['ita'\]"):
        t_cost.hw_target("tpu")


# ---------------------------------------------------------------------------
# decode-step plan cost
# ---------------------------------------------------------------------------

DECODE_PLANS = {
    "reduced-unfused": (True, dict(seq_len=8, max_len=24, fuse=False)),
    "reduced-fused": (True, dict(seq_len=8, max_len=24)),
    "reduced-paged": (True, dict(seq_len=8, max_len=24, kv_block_size=4, kv_blocks=14,
                                 fuse=False)),
    "reduced-paged-fused": (True, dict(seq_len=8, max_len=24, kv_block_size=4,
                                       kv_blocks=14)),
    "olmo-1b-fused": (False, dict(seq_len=128, max_len=160)),
    "olmo-1b-unfused": (False, dict(seq_len=128, max_len=160, fuse=False)),
    "olmo-1b-paged": (False, dict(seq_len=128, max_len=272, kv_block_size=16,
                                  kv_blocks=145)),
}


@pytest.mark.parametrize("backend", ["w8a8", "ita"])
@pytest.mark.parametrize("name", list(DECODE_PLANS))
def test_plan_step_cost_equal(name, backend):
    """Lowered by the port, priced by both packages (the reference's plan
    from the port's JSON): every node's cycles and the step cost."""
    is_reduced, kw = DECODE_PLANS[name]
    tcfg = t_get_config("olmo-1b")
    tcfg = t_reduced(tcfg) if is_reduced else tcfg
    pair = t_api.compile(tcfg, backend=backend, use_cache=False, verify=False, **kw).artifact
    for t_plan in (pair.prefill, pair.decode):
        j_plan = JPlan.from_dict(json.loads(json.dumps(t_plan.to_dict())))
        opts = dict(max_len=t_plan.max_len, kv_block_size=t_plan.kv_block_size)
        assert [t_cost.plan_node_cycles(n, **opts) for n in t_plan.nodes] == \
            [j_cost.plan_node_cycles(n, **opts) for n in j_plan.nodes]
        got, want = t_cost.plan_step_cost(t_plan), j_cost.plan_step_cost(j_plan)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.t_s == want.t_s


def test_plan_step_cost_orders_fusion(cfgs):
    """The cost model prices the launch overhead fusion removes: fused
    strictly cheaper, dispatch counts exact, the paged gather term
    visible (tests/test_fusion.py)."""
    _, tcfg = cfgs
    pair = t_lower_decoder(tcfg, SEQ, max_len=MAX_LEN, fuse=False)
    unf = t_cost.plan_step_cost(pair.decode)
    fus = t_cost.plan_step_cost(t_patterns.fuse_regions(pair.decode))
    assert unf.n_dispatches == len(pair.decode.nodes)
    assert fus.n_dispatches <= unf.n_dispatches // 3
    assert fus.t_s < unf.t_s
    assert fus.t_compute_s == pytest.approx(unf.t_compute_s)
    paged = t_lower_decoder(tcfg, SEQ, max_len=MAX_LEN, kv_block_size=BLOCK,
                            kv_blocks=KV_BLOCKS, fuse=False).decode
    assert t_cost.plan_step_cost(paged).t_compute_s > unf.t_compute_s


# ---------------------------------------------------------------------------
# the tuner and compile(autotune=True)
# ---------------------------------------------------------------------------


def test_tuner_helpers_equal(cfgs):
    for args in [(0, 0, 24), (4, 14, 24), (16, 145, 272), (64, 3, 40), (8, 9, 1)]:
        assert t_tune._block_candidates(*args) == j_tune._block_candidates(*args)
    _, tcfg = cfgs
    for backend_granule in (64, 128):
        prefill = t_lower_decoder(tcfg, SEQ, max_len=MAX_LEN,
                                  granule=backend_granule).prefill
        j_prefill = JPlan.from_dict(json.loads(prefill.to_json()))
        assert t_tune._gemm_tiles(prefill) == j_tune._gemm_tiles(j_prefill)
    assert t_tune.FUSE_MIN_NODES_CANDIDATES == j_tune.FUSE_MIN_NODES_CANDIDATES
    assert t_tune.KV_BLOCK_CANDIDATES == j_tune.KV_BLOCK_CANDIDATES


TUNE_CASES = {
    "reduced-dense": (True, dict(seq_len=SEQ, max_len=MAX_LEN)),
    "reduced-dense-unfused": (True, dict(seq_len=SEQ, max_len=MAX_LEN, fuse=False)),
    "reduced-paged": (True, dict(seq_len=SEQ, max_len=MAX_LEN, kv_block_size=BLOCK,
                                 kv_blocks=KV_BLOCKS)),
    "olmo-1b-paged": (False, dict(seq_len=128, max_len=272, kv_block_size=16,
                                  kv_blocks=145)),
}


@pytest.mark.parametrize("granule", [64, 128])
@pytest.mark.parametrize("name", list(TUNE_CASES))
def test_tune_decoder_equal(name, granule):
    is_reduced, kw = TUNE_CASES[name]
    cfg, tcfg = get_config("olmo-1b"), t_get_config("olmo-1b")
    if is_reduced:
        cfg, tcfg = reduced(cfg), t_reduced(tcfg)
    got = t_tune.tune_decoder(tcfg, granule=granule, **kw)
    want = j_tune.tune_decoder(cfg, granule=granule, **kw)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.payload() == want.payload()
    assert json.dumps(got.payload()) == json.dumps(want.payload())
    if name == "olmo-1b-paged":
        assert got.knobs == OLMO_KNOBS
        assert got.predicted_cost_s == OLMO_PREDICTED_COST_S


COMPILE_CASES = {
    "reduced-dense": (True, dict(backend="w8a8", seq_len=SEQ, max_len=MAX_LEN)),
    "reduced-paged-ita": (True, dict(backend="ita", seq_len=SEQ, max_len=MAX_LEN,
                                     kv_block_size=BLOCK, kv_blocks=KV_BLOCKS,
                                     prefix_cache=True)),
    "reduced-paged-w8a8": (True, dict(backend="w8a8", seq_len=SEQ, max_len=MAX_LEN,
                                      kv_block_size=BLOCK, kv_blocks=KV_BLOCKS)),
    "olmo-1b-paged": (False, OLMO_PAGED),
    "olmo-1b-paged-w8a8": (False, dict(OLMO_PAGED, backend="w8a8", prefix_cache=False)),
}


@pytest.mark.parametrize("name", list(COMPILE_CASES))
def test_compile_autotune_equal(name):
    is_reduced, kw = COMPILE_CASES[name]
    cfg, tcfg = get_config("olmo-1b"), t_get_config("olmo-1b")
    if is_reduced:
        cfg, tcfg = reduced(cfg), t_reduced(tcfg)
    tm = t_api.compile(tcfg, autotune=True, use_cache=False, **kw)
    jm = j_api.compile(cfg, autotune=True, use_cache=False, **kw)
    assert tm.options == jm.options
    assert tm.fingerprint == jm.fingerprint
    assert tm.artifact.to_json() == jm.artifact.to_json()
    assert tm.artifact.autotune == jm.artifact.autotune
    assert tm.artifact.autotune["knobs"] == tm.options["autotune"]
    assert [dataclasses.astuple(d) for d in tm.diagnostics] == \
        [dataclasses.astuple(d) for d in jm.diagnostics]
    if name.startswith("olmo-1b"):
        assert tm.options["autotune"] == OLMO_KNOBS
        assert tm.artifact.kv_block_size * tm.artifact.kv_blocks >= 16 * 145
    if name == "olmo-1b-paged":
        assert tm.artifact.autotune == {"knobs": OLMO_KNOBS,
                                        "predicted_cost_s": OLMO_PREDICTED_COST_S,
                                        "n_dispatches": 49, "considered": 16}


def test_autotune_json_round_trip(cfgs):
    _, tcfg = cfgs
    model = t_api.compile(tcfg, seq_len=SEQ, max_len=MAX_LEN, kv_block_size=BLOCK,
                          kv_blocks=KV_BLOCKS, autotune=True, use_cache=False)
    plan = model.artifact.decode
    assert plan.fused and plan.autotune and model.artifact.autotune is plan.autotune
    rt = TPlan.from_dict(json.loads(json.dumps(plan.to_dict())))
    assert rt.to_dict() == plan.to_dict()
    assert rt.fused and rt.autotune == plan.autotune
    rt.validate()
    orig = {n.name: n for n in plan.nodes if n.fused}
    for n in rt.nodes:
        if n.fused:
            assert [b.name for b in n.body] == [b.name for b in orig[n.name].body]
    # the reference loads the port's tuned plan as it is
    j_rt = JPlan.from_dict(json.loads(plan.to_json()))
    assert j_rt.to_dict() == JPlan.from_dict(rt.to_dict()).to_dict()


def test_encoder_refuses_autotune():
    enc = t_reduced(t_get_config("mobilebert"))
    model = t_api.compile(enc, seq_len=SEQ, use_cache=False)
    assert not model.artifact.fused
    with pytest.raises(ValueError, match="autotune") as got:
        t_api.compile(enc, seq_len=SEQ, autotune=True, use_cache=False)
    with pytest.raises(ValueError) as want:
        j_api.compile(reduced(get_config("mobilebert")), seq_len=SEQ, autotune=True,
                      use_cache=False)
    assert str(got.value) == str(want.value)


def test_second_autotune_compile_is_cache_hit(cfgs, tmp_path):
    _, tcfg = cfgs
    kw = dict(seq_len=SEQ, max_len=MAX_LEN, kv_block_size=BLOCK, kv_blocks=KV_BLOCKS,
              autotune=True, cache_dir=str(tmp_path))
    m1 = t_api.compile(tcfg, **kw)
    m2 = t_api.compile(tcfg, **kw)
    assert not m1.cache_hit and m2.cache_hit
    assert m1.fingerprint == m2.fingerprint
    assert m2.artifact.decode.autotune == m1.artifact.decode.autotune
    knobs = m1.artifact.decode.autotune["knobs"]
    assert set(knobs) == {"kv_block_size", "kv_blocks", "fuse_min_nodes", "gemm_tiles"}
    assert knobs["kv_block_size"] * knobs["kv_blocks"] >= BLOCK * KV_BLOCKS
    assert m1.options["autotune"] == knobs
    assert m2.verify_ms > 0.0


def test_knob_change_changes_fingerprint(cfgs):
    _, tcfg = cfgs
    plain = t_api.compile(tcfg, seq_len=SEQ, max_len=MAX_LEN, use_cache=False)
    tuned = t_api.compile(tcfg, seq_len=SEQ, max_len=MAX_LEN, autotune=True, use_cache=False)
    assert plain.fingerprint != tuned.fingerprint


# ---------------------------------------------------------------------------
# the tuned pair serves the same tokens (CPU)
# ---------------------------------------------------------------------------

#: prompt lengths (up to three chunks of SEQ), drawn from one numpy seed
PROMPT_LENS = (8, 11, 13, 17, 20, 9)
GEN = 4
#: the tuner keeps the pool's rows, not its slots: 14 blocks of 4 become
#: 4 blocks of 16, which cannot hold 3 slots at MAX_LEN (2 blocks each),
#: so a request there ends "kv_capacity", as in the JAX package.  24
#: blocks of 4 (6 of 16) hold the 3 slots in either blocking.
STREAM_KV_BLOCKS = 24


@pytest.mark.parametrize("backend", ["w8a8", "ita"])
def test_tuned_streams_equal_untuned(cfgs, backend):
    """Greedy streams of the tuned paged pair (re-blocked pool, tuned
    fusion boundary) equal the untuned pair's, request for request, on a
    pool that holds every slot at ``MAX_LEN`` in either blocking."""
    cfg, tcfg = cfgs
    qp = JT.quantize_params(cfg, JT.init_params(cfg, jax.random.PRNGKey(7)))
    tqp = from_jax_quantized(jax.tree.map(np.asarray, qp))
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, tcfg.vocab, n)] for n in PROMPT_LENS]
    kw = dict(backend=backend, seq_len=SEQ, max_len=MAX_LEN, kv_block_size=BLOCK,
              kv_blocks=STREAM_KV_BLOCKS, prefix_cache=True, use_cache=False)
    streams = []
    for autotune in (False, True):
        model = t_api.compile(tcfg, autotune=autotune, **kw)
        engine = Engine(model, 3, qp=tqp, device="cpu")
        handles = [engine.submit(p, GEN) for p in prompts]
        engine.run_until_idle(max_steps=500)
        assert engine.audit_sharing() == []
        streams.append([(h.tokens, h.finish_reason) for h in handles])
    assert model.artifact.kv_block_size != BLOCK  # the tuner re-blocked the pool
    assert streams[1] == streams[0]
    assert all(len(t) == GEN and r == "length" for t, r in streams[0])


def test_chip_smoke_expectations_are_the_reference_s():
    """``chip_smoke.py``'s ``[audit]`` phase requires, on the card, the
    knobs and the findings the JAX package gives for the same options."""
    import collections
    import importlib.util
    from pathlib import Path

    from repro.deploy import verify as j_verify

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    e = smoke.ENGINE
    jm = j_api.compile(get_config("olmo-1b"), backend="ita", seq_len=e["seq_len"],
                       max_len=e["max_len"], kv_block_size=e["block"],
                       kv_blocks=e["kv_blocks"], prefix_cache=True, autotune=True,
                       use_cache=False, verify=False)
    assert smoke.AUDIT_KNOBS == jm.options["autotune"] == OLMO_KNOBS
    for kw in (dict(seq_len=smoke.DECODER["seq_len"], max_len=smoke.DECODER["max_len"]),
               dict(seq_len=e["seq_len"], max_len=e["max_len"], kv_block_size=e["block"],
                    kv_blocks=e["kv_blocks"])):
        pair = j_api.compile(get_config("olmo-1b"), use_cache=False, verify=False,
                             **kw).artifact
        found = collections.Counter(d.rule for d in j_verify.verify(pair))
        assert dict(found) == smoke.AUDIT_OLMO_WARNINGS
