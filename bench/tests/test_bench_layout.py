"""The harness is driven by data: a configuration, a traffic mix or a
per-layer metric dropped into a copy of ``bench/`` as a new file, with its
entry in ``BENCHMARK.json``, is found by name with no other file edited;
and nothing the benchmark runs loads JAX or the JAX package."""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys

from conftest import ROOT

from bench.harness.spec import load_cell, metric_reader


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path / "bench")
    b = tmp_path / "bench"
    cfg = json.loads((b / "configs" / "olmo-1b-ita-paged.json").read_text())
    cfg["name"] = "olmo-1b-ita-dense"
    (b / "configs" / "olmo-1b-ita-dense.json").write_text(json.dumps(cfg))
    (b / "traffic" / "chat.json").write_text(json.dumps(
        {"loop": "open", "rate_per_s": 1.0, "prompt_len": [128, 512],
         "max_new_tokens": [128, 512], "check_requests": 4}))
    (b / "metrics" / "tpot_ms.chat.py").write_text("def read(run):\n    return 42.0\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "olmo-1b-ita-dense", "source": "x",
                             "file": "bench/configs/olmo-1b-ita-dense.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "olmo-1b-chat", "config": "olmo-1b-ita-dense",
                               "traffic": "chat", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "tpot_p95_ms", "unit": "ms", "better": "lower",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["olmo-1b-chat"]})
    bench["per_layer"].append({"name": "tpot_ms.chat", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "engine",
                               "moves": "tpot_p95_ms", "workloads": ["olmo-1b-chat"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = load_cell("olmo-1b-chat", root=tmp_path)
    assert spec["config"]["name"] == "olmo-1b-ita-dense"
    assert spec["traffic"]["max_new_tokens"] == [128, 512]
    assert [m["name"] for m in spec["end_to_end"]] == ["setup_s", "tpot_p95_ms"]
    assert [m["name"] for m in spec["per_layer"]] == ["tpot_ms.chat"]
    assert metric_reader("tpot_ms.chat", root=tmp_path)(None) == 42.0
    after = _digests(tmp_path / "bench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_every_metric_of_the_benchmark_has_its_reader():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert callable(metric_reader(m["name"]))
    for w in bench["workloads"]:
        spec = load_cell(w["name"])
        assert spec["per_layer"] and len(spec["end_to_end"]) >= 2


def _top_level_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         capture_output=True, text=True, check=True, cwd=ROOT)
    return set(eval(out.stdout.strip().splitlines()[-1]))


PATHS = f"import sys\nsys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"


def test_the_harness_loads_no_jax():
    code = PATHS + (
        "import bench.run as r\nr._environment()\n"
        "from bench.harness import cells, check, counts, readers, spec, trace, traffic, weights\n"
        "from bench.harness.spec import load_benchmark, metric_reader\n"
        "[metric_reader(m['name']) for m in load_benchmark()['per_layer']]\n"
        "import repro_torch.deploy.api, repro_torch.deploy.engine\n")
    names = _top_level_modules(code)
    assert "repro_torch" in names and "bench" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level_modules(PATHS + "from bench.reference import intops, olmo\n")
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_without_a_card_the_run_fails_and_prints_no_result(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for where in (ROOT, tmp_path):  # the checkout, and bench/ alone
        out = subprocess.run([sys.executable, "bench/run.py", "--workload", "olmo-1b-score",
                              "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
                             capture_output=True, text=True, cwd=where,
                             env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0 and out.stdout.strip() == ""
