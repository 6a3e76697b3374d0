"""The port's ``dryrun --via-plan`` and shared CLI block against the JAX package.

Twins of the reference's ``TestSharedCli`` and ``TestDryrunHeadByHead``
(``tests/test_api.py``), and ``run_via_plan`` on both packages for
reduced MobileBERT (both backends), reduced Whisper on ``ita`` at seq 100
(the padding path) and reduced OLMo-1B: every run exact (rc 0), the JSON
records equal but for the timings, the saved plans equal as JSON.  The
port draws its inputs and weights from its own seeds: neither enters a
record or a plan.
"""

import argparse
import inspect
import json

import pytest

from repro_torch.core.heterogeneous import Backend
from repro_torch.launch import cli, dryrun, serve

#: record keys that are wall-clock times
TIMINGS = ("lower_s", "steady_s")


class TestSharedCli:
    def test_backend_names_come_from_dispatch_vocabulary(self):
        assert cli.plan_backend_names() == ("w8a8", "ita")

    @pytest.mark.parametrize("build_parser", [lambda: argparse.ArgumentParser()])
    def test_parser_validates_and_normalizes(self, build_parser):
        ap = build_parser()
        cli.add_plan_args(ap, via_plan_help="x")
        args = ap.parse_args(["--via-plan", "--backend", "ita"])
        assert args.via_plan and args.backend is Backend.ITA
        assert ap.parse_args(["--backend", "W8A8"]).backend is Backend.W8A8
        assert ap.parse_args([]).backend is Backend.W8A8
        with pytest.raises(SystemExit):
            ap.parse_args(["--backend", "bogus"])
        with pytest.raises(SystemExit):
            ap.parse_args(["--backend", "float"])  # model-path only

    def test_parse_backend_messages(self):
        with pytest.raises(argparse.ArgumentTypeError, match="model-path only"):
            cli.parse_backend("float")
        with pytest.raises(argparse.ArgumentTypeError, match="unknown backend"):
            cli.parse_backend("tpu")

    def test_serve_and_dryrun_share_the_block(self):
        assert "add_plan_args" in inspect.getsource(serve.main)
        assert "add_plan_args" in inspect.getsource(dryrun.main)

    def test_serving_entry_points_keep_the_kernel_default(self):
        """The serving entry points take the JAX package's default backend
        (``w8a8``; ``--backend ita`` picks the kernels) and accept
        ``--via-plan``, as the shared block installs them."""
        ap = argparse.ArgumentParser()
        cli.add_plan_args(ap, via_plan_help="accepted for compatibility")
        args = ap.parse_args([])
        assert args.backend is Backend.W8A8 and args.via_plan is False
        assert ap.parse_args(["--backend", "ita"]).backend is Backend.ITA


class TestDryrunHeadByHead:
    def test_decoder_ignores_encoder_only_flag(self, tmp_path, capsys):
        rc = dryrun.run_via_plan(
            "olmo-1b", reduced_cfg=True, backend="w8a8", batch_size=1, seq_len=8,
            head_by_head=True, gen_steps=1, out_dir=str(tmp_path), use_cache=False,
            device="cpu")
        assert rc == 0
        assert "encoder-only" in capsys.readouterr().out


#: (arch, backend, seq, head_by_head, gen) of each reduced run, both packages
CASES = [
    ("mobilebert", "w8a8", None, False, 2),
    ("mobilebert", "ita", None, False, 2),
    ("mobilebert", "w8a8", None, True, 2),
    ("whisper-tiny-encoder", "ita", 100, False, 2),
    ("olmo-1b", "w8a8", None, False, 2),
    ("olmo-1b", "ita", 12, False, 3),
]


def _files(path):
    return {p.name: json.loads(p.read_text()) for p in sorted(path.iterdir())}


@pytest.mark.parametrize("arch,backend,seq,hbh,gen", CASES,
                         ids=[f"{a}-{b}-{s}-{'hbh' if h else 'fused'}" for a, b, s, h, _ in CASES])
def test_run_via_plan_equals_reference(tmp_path, capsys, arch, backend, seq, hbh, gen):
    from repro.launch.dryrun import run_via_plan as j_run_via_plan

    kw = dict(reduced_cfg=True, backend=backend, batch_size=2, seq_len=seq, head_by_head=hbh,
              gen_steps=gen, use_cache=False)
    t_dir, j_dir = tmp_path / "port", tmp_path / "jax"
    assert dryrun.run_via_plan(arch, out_dir=str(t_dir), device="cpu", **kw) == 0
    t_out = capsys.readouterr().out
    assert j_run_via_plan(arch, out_dir=str(j_dir), **kw) == 0
    j_out = capsys.readouterr().out
    assert "[ok     ]" in t_out and "[ok     ]" in j_out
    # the [plan] line is the reference's but for the lowering time
    strip = lambda out: out.splitlines()[0].split(" in ")[0]  # noqa: E731
    assert strip(t_out) == strip(j_out)
    got, want = _files(t_dir), _files(j_dir)
    assert got.keys() == want.keys()
    for name in got:
        for k in TIMINGS:
            got[name].pop(k, None)
            want[name].pop(k, None)
        assert got[name] == want[name], name


def test_cli_main_on_cpu(tmp_path, capsys):
    argv = ["--arch", "mobilebert", "--reduced", "--via-plan", "--device", "cpu",
            "--no-plan-cache", "--out-dir", str(tmp_path), "--batch", "2"]
    assert dryrun.main(argv + ["--backend", "ita"]) == 0
    assert dryrun.main(argv) == 0  # the reference's default backend, w8a8
    out = capsys.readouterr().out
    assert out.count("[ok     ]") == 2 and "on cpu" in out
    assert {p.name for p in tmp_path.iterdir()} == {
        "mobilebert__plan.json", "mobilebert__via_plan__ita.json",
        "mobilebert__via_plan__w8a8.json"}


def test_cli_main_refuses_what_is_not_ported(tmp_path, monkeypatch, capsys):
    """Without ``--via-plan`` the multi-pod cells run (the grid is ported):
    on a host with no card each applicable cell is recorded ``failed``
    (no CPU fallback) and the exit code is 1; ``--via-plan`` still needs
    ``--arch``."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = dryrun.main(["--arch", "mobilebert", "--shape", "train_4k", "--out-dir",
                      str(tmp_path)])
    assert rc == 1 and "0 ok, 0 skipped (documented), 1 failed" in capsys.readouterr().out
    rec = json.loads((tmp_path / "mobilebert__train_4k__16x16.json").read_text())
    assert rec["status"] == "failed" and "no CUDA device" in rec["error"]
    with pytest.raises(SystemExit, match="requires --arch"):
        dryrun.main(["--via-plan"])


def test_mismatch_is_reported_and_fails(tmp_path, capsys, monkeypatch):
    """A plan that disagrees with the model path prints ``[MISMATCH]``,
    records it, and returns 1."""
    from repro_torch.models import encoder as EN

    real = EN.forward_w8a8
    monkeypatch.setattr(EN, "forward_w8a8", lambda *a, **kw: real(*a, **kw) + 1.0)
    rc = dryrun.run_via_plan("mobilebert", reduced_cfg=True, backend="w8a8", batch_size=1,
                             seq_len=None, head_by_head=False, gen_steps=1,
                             out_dir=str(tmp_path), use_cache=False, device="cpu")
    assert rc == 1 and "[MISMATCH]" in capsys.readouterr().out
    rec = json.loads((tmp_path / "mobilebert__via_plan__w8a8.json").read_text())
    assert rec["status"] == "mismatch" and rec["bit_exact"] is False


def test_session_keeps_the_bound_params():
    from repro_torch.configs import get_config, reduced
    from repro_torch.deploy import api
    from repro_torch.models import encoder as EN

    cfg = reduced(get_config("mobilebert"))
    model = api.compile(cfg, backend="w8a8", use_cache=False)
    sess = model.session(1, seed=3, device="cpu")
    want = EN.quantize_params(cfg, EN.init_params(cfg, 3))
    assert sess.qp.keys() == want.keys()
    assert (sess.qp["embed"]["table_q"] == want["embed"]["table_q"]).all()


def test_torch_quickstart_runs_on_cpu(capsys):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "torch_quickstart.py"
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for step in ("== 1.", "== 2-3.", "== 4.", "== 5."):
        assert step in out
    assert "no-overlap=True" in out and "Inf/s" in out
