"""The port's example twins on the CPU, at reduced widths.

``examples/torch_deploy_mobilebert.py`` prints every line of the JAX
package's ``examples/deploy_mobilebert.py`` (graph passes, tiling, memory,
cost model: deterministic, so equal line for line) and runs each plan bit
for bit against the model-level path; ``torch_serve_batched.py`` and
``torch_serve_async.py`` serve their requests to the end with the
reference's arguments (their tokens come from the port's seeded weights,
not the reference's, so the counts are compared, not the tokens).
"""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_deploy_mobilebert_twin_prints_the_reference_lines(capsys):
    _load("deploy_mobilebert").main()
    want = capsys.readouterr().out.splitlines()
    costs = _load("torch_deploy_mobilebert").main(["--device", "cpu", "--reduced"])
    got = capsys.readouterr().out.splitlines()
    assert [line for line in got if "plan on cpu" not in line] == want
    assert sum("bit-exact=True" in line for line in got) == 3
    assert costs["mobilebert"].gop > 0


def test_serve_batched_twin_serves_every_request(capsys):
    handles = _load("torch_serve_batched").main(
        ["--batch", "2", "--gen", "3", "--prompt-len", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(handles) == 4  # twice --batch: slots evicted and recycled
    assert all(h.finish_reason == "length" and len(h.tokens) == 3 for h in handles)
    assert "submitted 4 requests onto 2 slots" in out and "request 0 finished streaming" in out


@pytest.mark.parametrize("clients", [3])
def test_serve_async_twin_answers_every_client(capsys, clients):
    results = _load("torch_serve_async").main(
        ["--batch", "2", "--clients", str(clients), "--gen", "3", "--prompt-len", "16",
         "--device", "cpu"])
    out = capsys.readouterr().out
    assert sorted(results) == list(range(clients))
    assert results[0].startswith("http  length")
    assert all(r.startswith("async length") for i, r in results.items() if i)
    assert f"stats: {clients} completed" in out and "priority-deadline" in out
