"""The port's entry points and public names against the JAX package's.

* ``serve`` and ``deploy.serving`` install ``--via-plan`` (accepted for
  compatibility: serving is always plan-backed) and take the JAX
  package's defaults (``--arch olmo-1b``, ``--backend w8a8``); the
  reference's CI decoder smoke, spelled for the port, serves the same
  tokens with and without the flag;
* ``serve`` and ``dryrun --via-plan`` refuse a MoE, SSM, hybrid, encdec
  or VLM config with the JAX package's message, and ``lower()`` a dense
  config with experts with its detail;
* every public name of a JAX package module (a function or class of the
  package, or a constant) is also a name of the port's twin module,
  except the deliberate list below;
* every keyword of such a function, of such a class (its constructor) and
  of each public method of it is also a keyword of the port's twin, by
  name (a ``**kwargs`` that swallows it does not count), except the
  deliberate keywords below;
* ``dryrun`` without ``--via-plan`` (the multi-pod grid) parses the JAX
  package's defaults.  The port's own additions (the
  device, the exact integer products, the kernels' launch geometry) are
  not compared.
"""

import importlib
import inspect
import pathlib

import pytest

from repro.configs import get_config, reduced
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: names of the JAX package that the port does not carry, on purpose:
#: the Pallas entry points and TPU constants, the JAX-only erf, and the
#: HLO-text parsing of the dry run's analysis (the port reads an op stream)
DELIBERATE = {
    "repro.deploy.hlo_analysis": {"Computation", "SKIP_MEMORY_OPS"},
    "repro.core.igelu": {"jax_erf"},
    "repro.deploy.tiler": {"TPU_GRANULE", "TPU_VMEM_BYTES"},
    "repro.kernels.igelu.ops": {"igelu_pallas"},
    "repro.kernels.int8_gemm.ops": {"int8_gemm_pallas"},
    "repro.kernels.ita_attention.ops": {"ita_attention_pallas"},
    "repro.kernels.itamax.ops": {"itamax_pallas"},
}
_SIMPLE = (int, float, str, bool, tuple, frozenset, set, dict, bytes)

#: keywords of the JAX package that the port does not take, on purpose:
#: ``key`` anywhere (the port draws torch bits from seeds and generators);
#: of the kernel wrappers (by the reference function's module and name),
#: ``interpret`` and the Pallas tile sizes (the port's wrappers choose
#: their launch shape per call: ``gemm_grid``, ``attn_grid``,
#: ``itamax_grid``, ``igelu_grid``; ``ita_attention``'s ``block_k``
#: changes the numbers and stays compared); ``devices`` of
#: ``elastic.remesh`` (the port's mesh is laid over ranks); and the HLO
#: text or compiled object of the dry run's analysis (the port reads an
#: op stream)
DELIBERATE_KWARGS = {
    "*": {"key"},
    "repro.kernels.int8_gemm.ops.int8_gemm": {"interpret", "block_m", "block_n", "block_k"},
    "repro.kernels.igelu.ops.igelu": {"interpret", "block_m", "block_n"},
    "repro.kernels.ita_attention.ops.ita_attention": {"interpret", "block_q"},
    "repro.kernels.ita_attention.ops.ita_decode": {"interpret"},
    "repro.kernels.itamax.ops.itamax": {"interpret", "block_rows"},
    "repro.runtime.elastic.remesh": {"devices"},
    "repro.deploy.hlo_analysis.analyze_hlo": {"text"},
    "repro.deploy.hlo_analysis.analyze_compiled": {"compiled"},
    "repro.deploy.hlo_analysis.top_dots": {"text"},
    "repro.deploy.hlo_analysis.top_collectives": {"text"},
    "repro.launch.dryrun.analyze_hlo": {"text"},
}


def _module_pairs() -> list[str]:
    """Every module of the JAX package that has a twin file in the port."""
    names = []
    for f in sorted((ROOT / "src" / "repro").rglob("*.py")):
        rel = f.relative_to(ROOT / "src" / "repro")
        if (ROOT / "src" / "repro_torch" / rel).exists():
            parts = ["repro", *rel.with_suffix("").parts]
            names.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return names


def _public(mod, pkg: str) -> set[str]:
    out = set()
    for name, value in vars(mod).items():
        if name.startswith("_") or type(value).__name__ == "module":
            continue
        owner = getattr(value, "__module__", None) or ""
        if callable(value) and (owner == pkg or owner.startswith(pkg + ".")):
            out.add(name)
        elif isinstance(value, _SIMPLE):
            out.add(name)
    return out


@pytest.mark.parametrize("name", _module_pairs())
def test_public_names_of_the_reference_exist_in_the_port(name):
    ref = importlib.import_module(name)
    port = importlib.import_module("repro_torch" + name[len("repro"):])
    want = _public(ref, "repro") - DELIBERATE.get(name, set())
    missing = sorted(n for n in want if not hasattr(port, n))
    assert not missing, f"{name}: {missing}"


def test_deliberate_names_are_still_the_references():
    """Each deliberate omission names something the reference has."""
    for name, names in DELIBERATE.items():
        assert names <= _public(importlib.import_module(name), "repro"), name


def _keywords(fn) -> set[str]:
    """The names ``fn`` takes as keywords (``self`` and ``*args`` /
    ``**kwargs`` left out)."""
    params = inspect.signature(fn).parameters.values()
    return {p.name for p in params if p.name not in ("self", "cls")
            and p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}


def _callables(mod, pkg: str) -> dict:
    """{qualified name: callable} of the module's public functions and
    classes, and of each public method of those classes."""
    out = {}
    for name in _public(mod, pkg):
        value = getattr(mod, name)
        if not callable(value):
            continue
        out[name] = value
        if inspect.isclass(value):
            for attr, f in vars(value).items():
                f = getattr(f, "__func__", f)  # staticmethod / classmethod
                if not attr.startswith("_") and inspect.isfunction(f):
                    out[f"{name}.{attr}"] = f
    return out


def _deliberate_kwargs(fn) -> set[str]:
    where = f"{getattr(fn, '__module__', '')}.{getattr(fn, '__qualname__', '')}"
    return DELIBERATE_KWARGS["*"] | DELIBERATE_KWARGS.get(where, set())


@pytest.mark.parametrize("name", _module_pairs())
def test_keywords_of_the_reference_exist_in_the_port(name):
    ref = importlib.import_module(name)
    port = importlib.import_module("repro_torch" + name[len("repro"):])
    missing = []
    for qual, fn in _callables(ref, "repro").items():
        twin = port
        for part in qual.split("."):
            twin = getattr(twin, part, None)
        if twin is None:
            assert qual in DELIBERATE.get(name, set()), f"{name}: {qual} is missing"
            continue
        gone = _keywords(fn) - _keywords(twin) - _deliberate_kwargs(fn)
        missing += [f"{qual}({k}=)" for k in sorted(gone)]
    assert not missing, f"{name}: {missing}"


def test_deliberate_kwargs_are_still_the_references():
    """Each deliberate keyword is one the reference takes."""
    for where, kws in DELIBERATE_KWARGS.items():
        if where == "*":
            continue
        mod, fn = where.rsplit(".", 1)
        assert kws <= _keywords(getattr(importlib.import_module(mod), fn)), where
    takes_key = [q for name in _module_pairs()
                 for q, fn in _callables(importlib.import_module(name), "repro").items()
                 if "key" in _keywords(fn)]
    assert len(takes_key) >= 10, takes_key


def test_dispatch_table_kinds_is_a_checked_method():
    from repro.core.heterogeneous import DispatchTable

    assert "DispatchTable.kinds" in _callables(
        importlib.import_module("repro.core.heterogeneous"), "repro")
    assert _keywords(DispatchTable.kinds) == set()


def test_kernel_reexports_are_the_wrappers():
    import repro_torch.kernels as K
    from repro_torch.kernels import int8_gemm, itamax_ref
    from repro_torch.kernels.int8_gemm.ops import int8_gemm as wrapper
    from repro_torch.kernels.itamax.ref import itamax_rowwise

    assert int8_gemm is wrapper and K.int8_gemm is wrapper and callable(itamax_ref)
    assert itamax_rowwise.__module__ == "repro_torch.core.itamax"
    assert K.wrappers()["int8_gemm"] is wrapper
    with pytest.raises(AttributeError):
        K.not_a_kernel  # noqa: B018


# ---------------------------------------------------------------------------
# the serving CLIs: --via-plan and the defaults
# ---------------------------------------------------------------------------


class _Parsed(Exception):
    pass


def _parsed_args(monkeypatch, serve_mod, main, argv):
    """The namespace ``main`` parses from ``argv``: its compile step is
    stopped before it lowers anything."""
    seen = {}

    def stop(cfg, args, **kw):
        seen["args"] = args
        raise _Parsed

    monkeypatch.setattr(serve_mod, "compile_for_serving", stop)
    with pytest.raises(_Parsed):
        main(argv)
    return vars(seen["args"])


def _plain(value):
    return getattr(value, "value", value)


@pytest.mark.parametrize("entry", ["launch.serve", "deploy.serving.__main__"])
def test_defaults_and_via_plan_equal_reference(monkeypatch, entry):
    j_serve = importlib.import_module("repro.launch.serve")
    t_serve = importlib.import_module("repro_torch.launch.serve")
    j_main = importlib.import_module(f"repro.{entry}").main
    t_main = importlib.import_module(f"repro_torch.{entry}").main
    for argv in ([], ["--via-plan"]):
        want = _parsed_args(monkeypatch, j_serve, j_main, argv)
        got = _parsed_args(monkeypatch, t_serve, t_main, argv)
        assert {k: _plain(got[k]) for k in want} == {k: _plain(v) for k, v in want.items()}
        assert got["via_plan"] is bool(argv)
    assert got["arch"] == "olmo-1b" and _plain(got["backend"]) == "w8a8"


def test_ci_decoder_smoke_with_and_without_via_plan(capsys):
    """``python -m repro_torch.launch.serve --arch olmo-1b --reduced
    --via-plan --prompt-len 16 --gen 2 --batch 2`` (on the CPU) serves, and
    the flag changes nothing."""
    from repro_torch.launch import serve

    argv = ["--arch", "olmo-1b", "--reduced", "--prompt-len", "16", "--gen", "2", "--batch",
            "2", "--device", "cpu", "--no-plan-cache"]
    plain = serve.main(argv)
    via = serve.main(argv + ["--via-plan"])
    out = capsys.readouterr().out
    assert via["tokens"] == plain["tokens"] and len(plain["tokens"]) == 4
    assert out.count("engine-serving [w8a8] olmo-1b on cpu") == 2


# ---------------------------------------------------------------------------
# refusals of the families plan lowering does not support
# ---------------------------------------------------------------------------

REFUSED = ["granite-moe-3b-a800m", "mamba2-370m", "zamba2-2.7b", "seamless-m4t-large-v2",
           "llava-next-34b"]


def _exit_message(main, argv) -> str:
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code not in (0, None)
    return str(e.value.code)


@pytest.mark.parametrize("arch", REFUSED)
def test_serve_refuses_family_as_reference(arch):
    from repro.launch import serve as j_serve
    from repro_torch.launch import serve as t_serve

    argv = ["--arch", arch, "--reduced", "--no-plan-cache"]
    want = _exit_message(j_serve.main, argv)
    got = _exit_message(t_serve.main, argv + ["--device", "cpu"])
    assert got == want and got.startswith(f"cannot serve {reduced(get_config(arch)).name}: ")


@pytest.mark.parametrize("arch", REFUSED)
def test_dryrun_via_plan_refuses_family_as_reference(arch):
    from repro.launch import dryrun as j_dryrun
    from repro_torch.launch import dryrun as t_dryrun

    argv = ["--arch", arch, "--reduced", "--via-plan", "--no-plan-cache"]
    want = _exit_message(j_dryrun.main, argv)
    got = _exit_message(t_dryrun.main, argv + ["--device", "cpu"])
    assert got == want and got.startswith("--via-plan: plan lowering does not support")


def test_lower_names_experts_in_a_dense_config():
    from repro.deploy import lowering as JLow
    from repro_torch.deploy import lowering as TLow

    cfg = reduced(get_config("olmo-1b")).replace(n_experts=4, top_k=2)
    tcfg = t_reduced(t_get_config("olmo-1b")).replace(n_experts=4, top_k=2)
    with pytest.raises(JLow.UnsupportedFamilyError) as want:
        JLow.lower(cfg)
    with pytest.raises(TLow.UnsupportedFamilyError) as got:
        TLow.lower(tcfg)
    assert str(got.value) == str(want.value) and "n_experts=4 routes as MoE" in str(got.value)


@pytest.mark.parametrize("argv", [[], ["--all", "--multi-pod", "both"],
                                  ["--arch", "olmo-1b", "--shape", "train_4k"]])
def test_dryrun_grid_defaults_equal_reference(monkeypatch, argv):
    import argparse

    seen = {}
    parse = argparse.ArgumentParser.parse_args

    def stop(self, *a, **kw):
        seen["args"] = vars(parse(self, *a, **kw))
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    out = {}
    for pkg in ("repro", "repro_torch"):
        with pytest.raises(_Parsed):
            importlib.import_module(f"{pkg}.launch.dryrun").main(argv)
        out[pkg] = seen.pop("args")
    want, got = out["repro"], out["repro_torch"]
    assert {k: _plain(got[k]) for k in want} == {k: _plain(v) for k, v in want.items()}
    assert got["via_plan"] is False and got["out_dir"] == "experiments/dryrun"
