"""The port's training path against the JAX package's, on reduced configs.

``launch.train.make_train_step`` (microbatched accumulation in bfloat16,
remat, QAT through a wrapped ``loss_fn``) with ``optim.adamw``, under
``runtime.fault.Supervisor`` with the checkpointer and the data pipeline.
The params come from the reference (``convert.from_jax_params``), and both
packages train on the same ``make_batch`` numpy batches.

Tolerances, per step, as measured at these sizes on every arch of the
registry (three steps; the worst case in brackets):

* loss: ``LOSS_RTOL`` 1e-5 of the loss [5.1e-7], QAT 1e-4 [2.0e-5];
* grad_norm: ``GNORM_RTOL`` 1e-4 [6.1e-6], QAT 1e-3 [1.7e-4]; from the
  second step on, a fake-quant input one ulp apart can round to the next
  int8 step, and the straight-through gradient moves with it;
* updated params: every element within ``2 * lr * steps`` of the
  reference's [3.7e-4 at lr 3e-4 after 3 steps], and at most
  ``TIGHT_SHARE`` 1e-3 of the elements beyond ``TIGHT`` 1e-5 [5.4e-4, QAT;
  1.3e-4 otherwise].  AdamW's early updates are about lr * sign(g): an
  element whose |g| is near eps, or whose bfloat16-accumulated or
  fake-quantized gradient crosses zero, may move by up to 2 * lr apart.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeCell, get_config, list_archs, reduced
from repro.data import DataConfig
from repro.data import make_batch as j_make_batch
from repro.launch import train as JT
from repro.models import build as j_build
from repro.optim import adamw as JA
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import from_jax_params, to_jax_layout
from repro_torch.launch import train as TT
from repro_torch.models import build as t_build
from repro_torch.optim import adamw as TA
from repro_torch.runtime.fault import StragglerDetector, Supervisor

ROOT = Path(__file__).resolve().parents[1]
LR = 3e-4  # make_train_step's default schedule
LOSS_RTOL = {False: 1e-5, True: 1e-4}  # by qat
GNORM_RTOL = {False: 1e-4, True: 1e-3}
TIGHT, TIGHT_SHARE = 1e-5, 1e-3
BATCH, SEQ = 2, 32


def _with_qat(api):
    """The example's QAT: ``loss_fn`` wrapped with ``qat=True``."""
    return dataclasses.replace(api, loss_fn=lambda p, b, _f=api.loss_fn, **kw: _f(
        p, b, qat=True, **kw))


def _without_remat(api):
    """The reference's encoder ``loss_fn`` refuses the ``remat`` keyword that
    ``make_train_step`` always passes (``src/repro/models/encoder.py:87-88``);
    its step runs here with the keyword dropped, as its ``model_zoo`` drops
    it for the SSM, hybrid and encoder-decoder families."""
    return dataclasses.replace(api, loss_fn=lambda p, b, _f=api.loss_fn, **kw: _f(
        p, b, **{k: v for k, v in kw.items() if k != "remat"}))


def _pair(arch, qat=False):
    cfg = reduced(get_config(arch))
    japi, tapi = j_build(cfg), t_build(t_reduced(t_get_config(arch)))
    if cfg.family == "encoder":
        japi = _without_remat(japi)
    if qat:
        japi, tapi = _with_qat(japi), _with_qat(tapi)
    return cfg, japi, tapi


def _batches(cfg, steps):
    dcfg = DataConfig(vocab=max(cfg.vocab, 2), global_batch=BATCH, seq_len=SEQ)
    cell = ShapeCell("t", SEQ, BATCH, "train")
    return [j_make_batch(cfg, cell, dcfg, s) for s in range(steps)]


def _compare(arch, steps=3, microbatches=1, remat=True, qat=False):
    cfg, japi, tapi = _pair(arch, qat)
    jp = japi.init_params(jax.random.PRNGKey(0))
    js = JA.init(jp)
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    ts = TA.init(tp)
    jstep = jax.jit(JT.make_train_step(japi, microbatches=microbatches, remat=remat))
    tstep = TT.make_train_step(tapi, microbatches=microbatches, remat=remat)
    for i, batch in enumerate(_batches(cfg, steps)):
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v) for k, v in batch.items()})
        what = f"{arch} step {i}"
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL[qat], err_msg=what)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=GNORM_RTOL[qat], err_msg=what)
        assert int(ts.step) == int(js.step) == i + 1
        got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), to_jax_layout(tp)))
        want = jax.tree.leaves(jax.tree.map(np.asarray, jp))
        diff = [np.abs(a - b) for a, b in zip(got, want)]
        assert max(float(d.max()) for d in diff) <= 2 * LR * (i + 1), what
        beyond = sum(int((d > TIGHT).sum()) for d in diff) / sum(d.size for d in diff)
        assert beyond <= TIGHT_SHARE, (what, beyond)


@pytest.mark.parametrize("microbatches,remat,qat", [
    (1, True, False), (1, False, False), (2, True, False), (2, True, True)],
    ids=["mb1-remat", "mb1", "mb2-remat", "mb2-remat-qat"])
def test_three_steps_match_reference(microbatches, remat, qat):
    _compare("olmo-1b", microbatches=microbatches, remat=remat, qat=qat)


@pytest.mark.parametrize("arch", list_archs())
def test_one_step_per_arch_matches_reference(arch):
    _compare(arch, steps=1)


def test_remat_changes_no_number():
    """remat recomputes each layer in the backward; the step is the same
    (the encoder included, whose reference refuses the keyword)."""
    for arch in ("olmo-1b", "mobilebert"):
        cfg, _, tapi = _pair(arch)
        batch = {k: torch.from_numpy(v) for k, v in _batches(cfg, 1)[0].items()}
        out = []
        for remat in (True, False):
            p = tapi.init_params(0, device="cpu")
            _, _, m = TT.make_train_step(tapi, remat=remat)(p, TA.init(p), batch)
            out.append((float(m["loss"]), float(m["grad_norm"]), p))
        assert out[0][:2] == out[1][:2], arch
        assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(out[0][2]),
                                                     jax.tree.leaves(out[1][2])))


# ---------------------------------------------------------------------------
# supervision: the reference's cases, and a restart of a real step
# ---------------------------------------------------------------------------


class TestSupervisor:
    """The JAX package's ``tests/test_substrates.py::TestSupervisor``, spelled for the port."""

    def test_restart_after_injected_failure(self, tmp_path):
        """A mid-run failure restores the last checkpoint and replays."""
        ck = Checkpointer(str(tmp_path))

        def step_fn(state, batch):
            return {"x": state["x"] + batch}, {"loss": float(state["x"])}

        def batch_fn(step):
            return torch.tensor(1.0)

        failed = {"done": False}

        def inject(step):
            if step == 7 and not failed["done"]:
                failed["done"] = True
                raise RuntimeError("simulated node failure")

        sup = Supervisor(ck, save_every=5)
        state, hist = sup.run(
            step_fn, {"x": torch.tensor(0.0)}, batch_fn, 0, 10, inject_failure=inject
        )
        # deterministic replay: final state == 10 regardless of the failure
        assert float(state["x"]) == 10.0
        steps = [s for s, _ in hist]
        assert steps[-1] == 9 and 7 in steps

    def test_straggler_detection(self):
        det = StragglerDetector(window=16, threshold=2.0)
        for _ in range(10):
            assert not det.observe(0.1)
        assert det.observe(0.5)  # 5x median
        assert det.flags == 1


def test_supervised_restart_of_a_train_step_is_bit_exact(tmp_path):
    """Ten steps with a failure at step 6 (checkpoints every 4, async)
    equal ten uninterrupted steps bit for bit: the restored (params,
    AdamWState) and the data replay are exact."""
    cfg, _, tapi = _pair("olmo-1b")
    batches = _batches(cfg, 10)
    step = TT.make_train_step(tapi, microbatches=2)

    def step_fn(state, batch):
        p, o, m = step(*state, {k: torch.from_numpy(v) for k, v in batch.items()})
        return (p, o), m

    runs = []
    for fail in (None, 6):
        p = tapi.init_params(0, device="cpu")
        done = []

        def inject(s, fail=fail, done=done):
            if s == fail and not done:
                done.append(s)
                raise RuntimeError("simulated failure")

        sup = Supervisor(Checkpointer(str(tmp_path / str(fail))), save_every=4)
        state, hist = sup.run(step_fn, (p, TA.init(p)), batches.__getitem__, 0, 10,
                              inject_failure=inject)
        runs.append((state, {s: float(m["loss"]) for s, m in hist}, [s for s, _ in hist]))
    (a, la, sa), (b, lb, sb) = runs
    assert sa == list(range(10)) and sb == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7, 8, 9]
    assert la == lb
    assert int(a[1].step) == int(b[1].step) == 10
    assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


class _Parsed(Exception):
    pass


def _parsed(monkeypatch, main, argv):
    import argparse

    real = argparse.ArgumentParser.parse_args
    seen = {}

    def stop(self, args=None, namespace=None):
        seen["args"] = real(self, args, namespace)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed):
        main(argv)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", real)
    return vars(seen["args"])


def test_main_defaults_equal_reference(monkeypatch):
    want = _parsed(monkeypatch, JT.main, [])
    got = _parsed(monkeypatch, TT.main, [])
    assert {k: v for k, v in got.items() if k not in ("device", "seed")} == want
    assert got["device"] is None and got["seed"] == 0
    assert want == dict(arch="olmo-1b", reduced=False, steps=10, batch=4, seq=128,
                        microbatches=1, ckpt_dir="/tmp/repro_ckpt", save_every=50, qat=False)


def test_main_runs_on_cpu(tmp_path, capsys):
    losses = TT.main(["--arch", "olmo-1b", "--reduced", "--steps", "3", "--batch", "2",
                      "--seq", "32", "--save-every", "2", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "steps=3 time=" in capsys.readouterr().out
    assert Checkpointer(str(tmp_path)).latest_step() == 2


def test_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.main(["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path)])


def test_module_entry_point_on_cpu(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "mamba2-370m", "--reduced",
         "--steps", "2", "--batch", "2", "--seq", "32", "--device", "cpu",
         "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("steps=2 time=")


def _example():
    import importlib.util

    path = ROOT / "examples" / "torch_train_tinylm.py"
    spec = importlib.util.spec_from_file_location("torch_train_tinylm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_zipf_map_and_run_on_cpu(tmp_path, capsys):
    """The example's batches: the pipeline's draws mapped onto a Zipf law
    (deterministic, inside the vocab, P(j) = ln(1 + 1/(j + 1)) / ln(vocab));
    two steps run."""
    ex = _example()
    vocab = 32000
    k = np.arange(vocab, dtype=np.int32)
    j = ex.zipf({"tokens": k}, vocab)["tokens"]
    assert j.dtype == np.int32 and j.min() == 0 and j.max() < vocab
    counts = np.bincount(j, minlength=vocab)
    assert np.all(np.diff(j) >= 0) and counts[0] > counts[1] > counts[3] > counts[100]
    assert abs(counts[0] / counts[9] - np.log(2) / np.log(1.1)) < 0.05
    out = ex.main(["--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu",
                   "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert "tok/s on the CPU" in capsys.readouterr().out
