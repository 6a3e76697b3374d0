"""The port's static plan verifier against the JAX package's, finding for finding.

Every artifact is lowered by one package and reaches the other as JSON
(``to_dict`` -> ``from_dict(validate=False)``), and the two diagnostic
lists must be equal element by element: rule, severity, plan, node,
tensor, message, hint and source, in the same order.  Covered:

* reduced OLMo (seq 8, max_len 14): unfused dense, fused dense, paged
  (blocks of 4, 8 blocks) and autotuned pairs, all clean;
* the three paper encoders at full width (plans only), fused MHA and
  head-by-head, on both backends, all clean;
* OLMo-1B at full width (plans only): fused and unfused dense pairs at
  seq 128 / max_len 160 and the paged pair at max_len 272 with 145 blocks
  of 16 — each gives the reference's 32 ``QNT002`` warnings, so a strict
  ``check`` fails alike in both packages;
* every mutation of the reference's ``tests/test_verify.py::TestMutations``,
  applied once to the JSON and loaded by both packages: equal lists, and
  the mutation's rule is caught;
* the wiring: ``compile`` verifies (fresh and cache hits), ``verify=False``
  skips, ``CompiledModel.load`` re-verifies, the CLI's exit codes 0/1/2
  and ``--strict`` (its output equal to the reference's), the
  ``CompiledModel`` envelope, and ``EngineStats.verify_ms``.

Tolerance zero throughout.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro.configs import get_config, reduced
from repro.deploy import api as j_api
from repro.deploy import verify as j_verify
from repro.deploy.plan import DecoderPlanPair as JPair
from repro.deploy.plan import DeploymentPlan as JPlan
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.deploy import api as t_api
from repro_torch.deploy import verify as t_verify
from repro_torch.deploy.plan import DecoderPlanPair as TPair
from repro_torch.deploy.plan import DeploymentPlan as TPlan

ENCODERS = ("mobilebert", "whisper-tiny-encoder", "dinov2-small")
#: OLMo-1B's full-width pairs: fused dense, unfused dense, paged
OLMO_FULL = {
    "dense-fused": dict(seq_len=128, max_len=160),
    "dense-unfused": dict(seq_len=128, max_len=160, fuse=False),
    "paged": dict(seq_len=128, max_len=272, kv_block_size=16, kv_blocks=145),
}
#: the JAX package's count of QNT002 warnings on each OLMo-1B pair
OLMO_QNT002 = 32


def _rows(diags) -> list[tuple]:
    return [dataclasses.astuple(d) for d in diags]


def _load(d: dict, package: str):
    """A JSON dict as the given package's artifact, unvalidated."""
    pair, plan = (TPair, TPlan) if package == "torch" else (JPair, JPlan)
    if "prefill" in d and "decode" in d:
        return pair.from_dict(d, validate=False)
    return plan.from_dict(d, validate=False)


def _both(d: dict) -> tuple[list, list]:
    """The port's and the reference's diagnostics on one JSON artifact."""
    d = json.loads(json.dumps(d))
    return (_rows(t_verify.verify(_load(d, "torch"))),
            _rows(j_verify.verify(_load(d, "jax"))))


def _strict(check, artifact):
    try:
        return "clean", _rows(check(artifact, strict=True)), ""
    except Exception as exc:  # noqa: BLE001 - compared across the packages
        return type(exc).__name__, _rows(exc.diagnostics), str(exc)


@pytest.fixture(scope="module")
def cfgs():
    return reduced(get_config("olmo-1b")), t_reduced(t_get_config("olmo-1b"))


#: reduced OLMo fixtures of the reference's tests/test_verify.py
REDUCED = {
    "dense": dict(fuse=False),
    "fused": dict(),
    "paged": dict(kv_block_size=4, kv_blocks=8, fuse=False),
    "autotuned": dict(autotune=True),
}


@pytest.fixture(scope="module")
def reduced_dicts(cfgs):
    """Each reduced fixture lowered by the JAX package, as JSON dicts."""
    cfg, _ = cfgs
    return {name: j_api.compile(cfg, seq_len=8, max_len=14, use_cache=False,
                                verify=False, **kw).artifact.to_dict()
            for name, kw in REDUCED.items()}


# ---------------------------------------------------------------------------
# shipped artifacts: the same (empty or warning-only) report
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(REDUCED))
def test_reduced_olmo_same_report(cfgs, reduced_dicts, name):
    """Lowered by the reference, verified by both; lowered by the port,
    verified by both: equal, clean, and the two lowerings are one JSON."""
    _, tcfg = cfgs
    got, want = _both(reduced_dicts[name])
    assert got == want == []
    tm = t_api.compile(tcfg, seq_len=8, max_len=14, use_cache=False, **REDUCED[name])
    assert tm.artifact.to_dict() == reduced_dicts[name]
    got, want = _both(tm.artifact.to_dict())
    assert got == want == []
    assert _strict(t_verify.check, tm.artifact) == _strict(
        j_verify.check, _load(tm.artifact.to_dict(), "jax")) == ("clean", [], "")


@pytest.mark.parametrize("backend", ["w8a8", "ita"])
@pytest.mark.parametrize("head_by_head", [False, True], ids=["fused", "head-by-head"])
@pytest.mark.parametrize("arch", ENCODERS)
def test_full_encoders_clean(arch, head_by_head, backend):
    tm = t_api.compile(t_get_config(arch), backend=backend, head_by_head=head_by_head,
                       use_cache=False)
    assert tm.diagnostics == () and tm.verify_ms > 0.0
    got, want = _both(tm.artifact.to_dict())
    assert got == want == []


@pytest.mark.parametrize("backend", ["w8a8", "ita"])
@pytest.mark.parametrize("which", list(OLMO_FULL))
def test_full_olmo_qnt002_warnings(which, backend):
    """The 32 QNT002 warnings at full width, equal to the reference's, in
    ``compile``'s record too; strict ``check`` fails alike in both."""
    tm = t_api.compile(t_get_config("olmo-1b"), backend=backend, use_cache=False,
                       **OLMO_FULL[which])
    d = tm.artifact.to_dict()
    got, want = _both(d)
    assert got == want
    assert len(want) == OLMO_QNT002
    assert {(r[0], r[1]) for r in want} == {("QNT002", "warning")}
    assert _rows(tm.diagnostics) == want
    t_out = _strict(t_verify.check, _load(d, "torch"))
    j_out = _strict(j_verify.check, _load(d, "jax"))
    assert t_out == j_out
    assert t_out[0] == "PlanVerificationError"
    assert _rows(t_verify.check(_load(d, "torch"))) == want  # non-strict: returned


# ---------------------------------------------------------------------------
# mutations: one defect class -> its rule, in both packages alike
# ---------------------------------------------------------------------------


def _overlap(p):
    kv = {n for kv_pair in p["kv_state"] for n in kv_pair if n}
    for n in p["nodes"]:
        cands = [
            t for t in n["inputs"]
            if t in p["tensors"] and not p["tensors"][t]["weight"]
            and p["tensors"][t]["offset"] is not None
            and p["tensors"][t]["size"] > 0 and t not in kv
        ]
        if len(cands) >= 2 and (p["tensors"][cands[0]]["offset"]
                                != p["tensors"][cands[1]]["offset"]):
            p["tensors"][cands[0]]["offset"] = p["tensors"][cands[1]]["offset"]
            return
    raise AssertionError("no co-live activation pair found")


def _swap_dependent(p):
    nodes = p["nodes"]
    for i in range(len(nodes) - 1):
        if set(nodes[i]["outputs"]) & set(nodes[i + 1]["inputs"]):
            nodes[i], nodes[i + 1] = nodes[i + 1], nodes[i]
            sched = p["schedule"]
            sched[i], sched[i + 1] = sched[i + 1], sched[i]
            return
    raise AssertionError("no adjacent dependent nodes")


def _stale_read(p):
    cin, cout = p["kv_state"][0]
    for n in p["nodes"]:
        if cout in n["inputs"]:
            n["inputs"] = [cin if t == cout else t for t in n["inputs"]]
            return
    raise AssertionError(f"no reader of {cout}")


def _swap_cache_offsets(p):
    (k_in, k_out), (v_in, v_out) = p["kv_state"][0], p["kv_state"][1]
    t = p["tensors"]
    ko, vo = t[k_in]["offset"], t[v_in]["offset"]
    for name in (k_in, k_out):
        t[name]["offset"] = vo
    for name in (v_in, v_out):
        t[name]["offset"] = ko


def _merge_barrier(p):
    nodes = p["nodes"]
    for i in range(len(nodes) - 1):
        region, cw = nodes[i], nodes[i + 1]
        if region["kind"] == "fused_region" and \
                cw["kind"] in ("cache_write", "cache_write_paged"):
            produced = {o for b in region["body"] for o in b["outputs"]}
            region["inputs"] = list(region["inputs"]) + [
                t for t in cw["inputs"] if t not in produced and t not in region["inputs"]
            ]
            region["body"] = list(region["body"]) + [cw]
            region["outputs"] = list(region["outputs"]) + list(cw["outputs"])
            del nodes[i + 1]
            p["schedule"] = [n["name"] for n in nodes]
            return
    raise AssertionError("no region adjacent to a cache write")


def _blow_up_weight_scale(p):
    for n in p["nodes"]:
        if n["kind"] == "gemm":
            s = n["attrs"]["scales"]
            n["attrs"]["scales"] = [s[0], 1e6, s[2]]
            return
    raise AssertionError("no gemm node")


def _flip_engine(p):
    for n in p["nodes"]:
        if n["kind"] == "cache_write":
            n["engine"] = "ita"
            return
    raise AssertionError("no cache_write node")


def _direct_pool_access(p):
    for n in p["nodes"]:
        if n["kind"] == "attn_paged":
            n["kind"] = "attn_cached"
            return
    raise AssertionError("no attn_paged node")


def _deepen_contraction(p):
    for n in p["nodes"]:
        if n["kind"] == "gemm":
            m, _, nn = n["attrs"]["dims"]
            n["attrs"]["dims"] = [m, 150_000, nn]
            return
    raise AssertionError("no gemm node")


def _corrupt_pool_shape(p):
    cin, _ = p["kv_state"][0]
    shape = p["tensors"][cin]["shape"]
    p["tensors"][cin]["shape"] = [shape[0] + 1] + list(shape[1:])


def _move_past_peak(p):
    for t in p["tensors"].values():
        if not t["weight"] and t["offset"] is not None and t["size"]:
            t["offset"] = p["memory_peak"] + 64
            return
    raise AssertionError("no activation tensor")


def _rename_in_schedule(p):
    p["schedule"][0] = "bogus_node"


def _alien_kind(p):
    p["nodes"][0]["kind"] = "quantum_annealer"


#: (fixture, mutation of the decode plan, the rule it must trip)
MUTATIONS = {
    "offset_overlap_mem001": ("dense", _overlap, "MEM001"),
    "def_before_use_df001": ("dense", _swap_dependent, "DF001"),
    "kv_war_hazard_kv001": ("dense", _stale_read, "KV001"),
    "pair_offset_mismatch_kv002": ("dense", _swap_cache_offsets, "KV002"),
    "barrier_crossing_fusion_kv003": ("fused", _merge_barrier, "KV003"),
    "scale_overflow_qnt001": ("dense", _blow_up_weight_scale, "QNT001"),
    "illegal_engine_eng001": ("dense", _flip_engine, "ENG001"),
    "paged_scratch_read_kv004": ("paged", _direct_pool_access, "KV004"),
    "accumulator_overflow_qnt002": ("dense", _deepen_contraction, "QNT002"),
    "paged_geometry_kv005": ("paged", _corrupt_pool_shape, "KV005"),
    "beyond_peak_mem002": ("dense", _move_past_peak, "MEM002"),
    "schedule_desync_df004": ("dense", _rename_in_schedule, "DF004"),
    "unknown_kind_eng002": ("dense", _alien_kind, "ENG002"),
}


def _mutated(d: dict, mutate, which: str = "decode") -> dict:
    d = json.loads(json.dumps(d))
    mutate(d[which] if which else d)
    return d


@pytest.mark.parametrize("name", list(MUTATIONS))
def test_mutation_same_report(reduced_dicts, name):
    fixture, mutate, rule = MUTATIONS[name]
    d = _mutated(reduced_dicts[fixture], mutate)
    got, want = _both(d)
    assert got == want
    assert rule in {r[0] for r in got if r[1] == "error"}
    t_out = _strict(t_verify.check, _load(d, "torch"))
    assert t_out == _strict(j_verify.check, _load(d, "jax"))
    assert t_out[0] == "PlanVerificationError"


def test_pair_level_mutations_same_report(reduced_dicts):
    """Pair-level defects (PAIR01, cross-plan KV002) alike in both."""
    def desync(d):
        d["decode"]["max_len"] = d["max_len"] + 1
        d["prefill"]["phase"] = "forward"
        d["decode"]["kv_block_size"] = 4

    def moved(d):
        name = d["prefill"]["kv_state"][0][1]
        d["decode"]["tensors"][name]["offset"] += 64

    for base, mutate, rules in (("dense", desync, {"PAIR01", "KV005"}),
                                ("dense", moved, {"KV002"})):
        d = _mutated(reduced_dicts[base], mutate, which=None)
        got, want = _both(d)
        assert got == want
        assert rules <= {r[0] for r in got}


# ---------------------------------------------------------------------------
# severities, check(), labels
# ---------------------------------------------------------------------------


def _widen(p):
    """k = 16384 keeps the int32 accumulator legal but exceeds the exact
    requant decomposition bound: a warning, not an error."""
    for n in p["nodes"]:
        if n["kind"] == "gemm":
            m, _, nn = n["attrs"]["dims"]
            n["attrs"]["dims"] = [m, 16_384, nn]
            return


def test_decomposition_bound_is_warning_not_error(reduced_dicts):
    d = _mutated(reduced_dicts["dense"], _widen)
    mutant = _load(d, "torch")
    diags = t_verify.verify(mutant)
    assert _rows(diags) == _rows(j_verify.verify(_load(d, "jax")))
    assert diags and all(x.severity == "warning" for x in diags)
    assert {x.rule for x in diags} == {"QNT002"}
    assert t_verify.check(mutant) == diags
    with pytest.raises(t_verify.PlanVerificationError):
        t_verify.check(mutant, strict=True)


def test_error_raises_with_all_diagnostics(reduced_dicts):
    def two_defects(p):
        _rename_in_schedule(p)
        _blow_up_weight_scale(p)

    d = _mutated(reduced_dicts["dense"], two_defects)
    with pytest.raises(t_verify.PlanVerificationError) as got:
        t_verify.check(_load(d, "torch"), context="unit-test")
    with pytest.raises(j_verify.PlanVerificationError) as want:
        j_verify.check(_load(d, "jax"), context="unit-test")
    assert {"DF004", "QNT001"} <= {x.rule for x in got.value.diagnostics}
    assert str(got.value) == str(want.value)
    assert "unit-test" in str(got.value)


def test_labels_and_format(reduced_dicts):
    d = _mutated(reduced_dicts["dense"], _rename_in_schedule)
    got = [x for x in t_verify.verify(_load(d, "torch")) if x.rule == "DF004"]
    want = [x for x in j_verify.verify(_load(d, "jax")) if x.rule == "DF004"]
    assert got and got[0].plan == "decode"
    assert [x.format() for x in got] == [x.format() for x in want]
    line = got[0].format()
    assert "ERROR" in line and "DF004" in line and "decode" in line


def test_verify_plan_standalone_and_type_error(reduced_dicts):
    pair = _load(reduced_dicts["dense"], "torch")
    assert t_verify.verify_plan(pair.decode, "decode") == []
    with pytest.raises(TypeError, match="DeploymentPlan or DecoderPlanPair"):
        t_verify.verify({"not": "a plan"})


# ---------------------------------------------------------------------------
# compile() / load() wiring
# ---------------------------------------------------------------------------


def test_compile_records_verification(cfgs):
    _, tcfg = cfgs
    m = t_api.compile(tcfg, seq_len=8, max_len=14, use_cache=False)
    assert m.diagnostics == ()
    assert m.verify_ms > 0.0


def test_compile_verify_false_skips_and_keeps_fingerprint(cfgs):
    _, tcfg = cfgs
    m = t_api.compile(tcfg, seq_len=8, max_len=14, use_cache=False, verify=False)
    assert m.diagnostics == () and m.verify_ms == 0.0
    assert m.fingerprint == t_api.compile(tcfg, seq_len=8, max_len=14,
                                          use_cache=False).fingerprint
    assert "verify" not in m.options


def _corrupt_engine(path: str) -> None:
    """Flip a cache write onto the accelerator: a defect the constructor's
    checks cannot see."""
    with open(path) as f:
        payload = json.load(f)
    for n in payload["artifact"]["decode"]["nodes"]:
        if n["kind"] == "cache_write":
            n["engine"] = "ita"
            break
    with open(path, "w") as f:
        json.dump(payload, f)


def test_cache_hit_is_reverified(cfgs, tmp_path):
    _, tcfg = cfgs
    kw = dict(seq_len=8, max_len=14, fuse=False, cache_dir=str(tmp_path / "plans"))
    m = t_api.compile(tcfg, **kw)
    assert not m.cache_hit and m.cache_path
    hit = t_api.compile(tcfg, **kw)
    assert hit.cache_hit and hit.verify_ms > 0.0 and hit.diagnostics == ()
    _corrupt_engine(m.cache_path)
    with pytest.raises(t_verify.PlanVerificationError, match="ENG001"):
        t_api.compile(tcfg, **kw)
    assert t_api.compile(tcfg, **kw, verify=False).cache_hit  # the escape hatch


def test_model_load_reverifies(cfgs, tmp_path):
    _, tcfg = cfgs
    m = t_api.compile(tcfg, seq_len=8, max_len=14, fuse=False, use_cache=False)
    path = str(tmp_path / "model.json")
    m.save(path)
    loaded = t_api.CompiledModel.load(path, tcfg)
    assert loaded.verify_ms > 0.0 and loaded.diagnostics == ()
    _corrupt_engine(path)
    with pytest.raises(t_verify.PlanVerificationError) as exc:
        t_api.CompiledModel.load(path, tcfg)
    assert path in str(exc.value) and "ENG001" in str(exc.value)
    unchecked = t_api.CompiledModel.load(path, tcfg, verify=False)
    assert unchecked is not None and unchecked.verify_ms == 0.0


def test_overlap_on_disk_raises_before_bind(cfgs, tmp_path):
    """The MEM001 corruption that the chip smoke writes: ``load`` raises
    naming the rule; ``verify=False`` loads the same file."""
    _, tcfg = cfgs
    m = t_api.compile(tcfg, seq_len=8, max_len=14, use_cache=False)
    d = m.to_dict()
    _overlap(d["artifact"]["decode"])
    path = str(tmp_path / "overlap.json")
    with open(path, "w") as f:
        json.dump(d, f)
    with pytest.raises(t_verify.PlanVerificationError, match="MEM001"):
        t_api.CompiledModel.load(path, tcfg)
    assert t_api.CompiledModel.load(path, tcfg, verify=False).kind == "decoder"


def test_engine_stats_carry_verify_ms(cfgs):
    from repro_torch.deploy.engine import Engine

    _, tcfg = cfgs
    m = t_api.compile(tcfg, seq_len=8, max_len=14, use_cache=False)
    eng = Engine(m, max_batch=1, device="cpu")
    assert eng.stats.verify_ms == m.verify_ms > 0.0
    assert f"plan verified in {m.verify_ms:.1f} ms" in eng.stats.summary()
    assert eng.reset_stats().verify_ms == m.verify_ms
    unverified = t_api.compile(tcfg, seq_len=8, max_len=14, use_cache=False, verify=False)
    assert Engine(unverified, max_batch=1, device="cpu").stats.verify_ms == 0.0


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _cli_both(paths, capsys):
    """(rc, stdout) of the port's and of the reference's CLI on the paths."""
    rc_t = t_verify.main(list(paths))
    out_t = capsys.readouterr().out
    rc_j = j_verify.main(list(paths))
    out_j = capsys.readouterr().out
    return (rc_t, out_t), (rc_j, out_j)


def test_cli_clean_artifacts_pass(reduced_dicts, tmp_path, capsys):
    a, b = str(tmp_path / "fused.json"), str(tmp_path / "paged.json")
    _load(reduced_dicts["fused"], "torch").save(a)
    _load(reduced_dicts["paged"], "torch").save(b)
    for args in ([a, b], [a, b, "--strict"]):
        got, want = _cli_both(args, capsys)
        assert got == want and got[0] == 0


def test_cli_corrupt_artifact_fails(reduced_dicts, tmp_path, capsys):
    d = _mutated(reduced_dicts["dense"], _rename_in_schedule)
    path = str(tmp_path / "corrupt.json")
    with open(path, "w") as f:
        json.dump(d, f)
    got, want = _cli_both([path], capsys)
    assert got == want and got[0] == 1
    assert "DF004" in got[1] and "FAIL" in got[1]


def test_cli_warnings_fail_only_under_strict(reduced_dicts, tmp_path, capsys):
    path = str(tmp_path / "warn.json")
    _load(_mutated(reduced_dicts["dense"], _widen), "torch").save(path)
    got, want = _cli_both([path], capsys)
    assert got == want and got[0] == 0
    got, want = _cli_both([path, "--strict"], capsys)
    assert got == want and got[0] == 1


def test_cli_compiled_model_envelope_loads(cfgs, tmp_path, capsys):
    cfg, tcfg = cfgs
    mine, theirs = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    t_api.compile(tcfg, seq_len=8, max_len=14, use_cache=False).save(mine)
    j_api.compile(cfg, seq_len=8, max_len=14, use_cache=False).save(theirs)
    for path in (mine, theirs):
        assert isinstance(t_verify.load_artifact(path), TPair)
    got, want = _cli_both([mine, theirs, "--strict"], capsys)
    assert got == want and got[0] == 0


def test_cli_unreadable_path_is_rc2(tmp_path, capsys):
    missing = str(tmp_path / "missing.json")
    got, want = _cli_both([missing], capsys)
    assert got == want and got[0] == 2


def test_cli_module_entry_point(reduced_dicts, tmp_path):
    """``python -m repro_torch.deploy.verify`` exits 1 on a corrupt file."""
    path = str(tmp_path / "corrupt.json")
    with open(path, "w") as f:
        json.dump(_mutated(reduced_dicts["dense"], _rename_in_schedule), f)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    run = subprocess.run([sys.executable, "-m", "repro_torch.deploy.verify", path],
                         capture_output=True, text=True, env=env, timeout=120)
    assert run.returncode == 1, run.stderr
    assert "DF004" in run.stdout and "FAIL" in run.stdout
