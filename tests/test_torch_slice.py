"""The port's deployment flow end to end against the JAX package.

* ``compile`` lowers the same plan, node for node (full configs, both
  backends) and fingerprints a config identically;
* ``session(device="cpu").forward`` equals the JAX package's ``execute``
  on carried weights, bit for bit, on both backends;
* sessions run on the card by default and raise without one;
* the port imports nothing of JAX or of the JAX package (tested in a
  fresh process and by a scan of the sources).
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.deploy import api as j_api
from repro.deploy.executor import execute as j_execute
from repro.deploy.plan import DeploymentPlan as JPlan
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import from_jax_quantized
from repro_torch.deploy import api as t_api
from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("mobilebert", "dinov2-small", "whisper-tiny-encoder")


@pytest.mark.parametrize("backend", ["w8a8", "ita"])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_equals_reference(arch, backend):
    want = j_api.compile(get_config(arch), backend=backend, use_cache=False, verify=False)
    got = t_api.compile(t_get_config(arch), backend=backend, use_cache=False)
    assert got.artifact.to_dict() == want.artifact.to_dict()
    assert got.fingerprint == want.fingerprint and got.options == want.options
    # the JSON schema is shared: the port's plan loads in the JAX package
    assert JPlan.from_json(got.artifact.to_json()) == want.artifact


def test_plan_cache_round_trip(tmp_path):
    cfg = t_get_config("mobilebert")
    first = t_api.compile(cfg, backend="ita", cache_dir=str(tmp_path))
    again = t_api.compile(cfg, backend="ita", cache_dir=str(tmp_path))
    assert not first.cache_hit and again.cache_hit
    assert again.artifact.to_dict() == first.artifact.to_dict()
    path = tmp_path / "saved.json"
    first.save(str(path))
    loaded = t_api.CompiledModel.load(str(path), cfg)
    assert loaded.artifact.to_dict() == first.artifact.to_dict()
    with pytest.raises(ValueError, match="fingerprint"):
        t_api.CompiledModel.load(str(path), cfg.replace(n_layers=3))


def test_unsupported_family_raises():
    # dense decoders lower since the decoder slice; a family the port has
    # no lowering for still raises, naming the family
    cfg = t_get_config("mobilebert").replace(family="moe", name="moe-probe")
    with pytest.raises(t_api.UnsupportedFamilyError, match="'moe'"):
        t_api.compile(cfg, use_cache=False)


def _carried(cfg, tcfg, backend, seq_len=None, key=3):
    jm = j_api.compile(cfg, backend=backend, seq_len=seq_len, use_cache=False, verify=False)
    weights, qp = jm.bind(key=jax.random.PRNGKey(key))
    tm = t_api.compile(tcfg, backend=backend, seq_len=seq_len, use_cache=False)
    return jm, weights, tm, from_jax_quantized(jax.tree.map(np.asarray, qp))


@pytest.mark.parametrize("backend", ["w8a8", "ita"])
def test_session_forward_equals_reference_execute(backend):
    cfg = reduced(get_config("mobilebert")).replace(head_dim=64)
    tcfg = t_reduced(t_get_config("mobilebert")).replace(head_dim=64)
    jm, weights, tm, tqp = _carried(cfg, tcfg, backend)
    assert tm.artifact.to_dict() == jm.artifact.to_dict()
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, size=(1, 128)).astype(np.int32)
    want = np.asarray(j_execute(jm.artifact, weights, {"tokens": tokens}, backend=backend))
    got = tm.session(1, qp=tqp, device="cpu").forward(torch.from_numpy(tokens))
    assert np.array_equal(got.numpy(), want)


def test_session_features_with_padding_equals_reference():
    """Patch input, 100 tokens: the GEMM rows and the attention sequence are
    padded to 128 on the kernel backend."""
    base = dict(vocab=0, head_dim=64, n_layers=1, max_seq=100, n_patches=100)
    cfg = reduced(get_config("dinov2-small")).replace(**base)
    tcfg = t_reduced(t_get_config("dinov2-small")).replace(**base)
    jm, weights, tm, tqp = _carried(cfg, tcfg, "ita")
    patches = np.random.default_rng(6).integers(-64, 64, size=(1, 100, cfg.d_model))
    patches = patches.astype(np.int8)
    want = np.asarray(j_execute(jm.artifact, weights, {"patches": patches}, backend="ita"))
    got = tm.session(1, qp=tqp, device="cpu").forward(torch.from_numpy(patches))
    assert got.shape == (1, 100, cfg.d_model)
    assert np.array_equal(got.numpy(), want)


def test_session_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = t_api.compile(t_reduced(t_get_config("mobilebert")), backend="ita", use_cache=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.session(2)
    assert model.session(2, device="cpu").device.type == "cpu"


def test_serve_cli_on_cpu(capsys, tmp_path):
    serve.main(["--arch", "mobilebert", "--reduced", "--batch", "2", "--gen", "1",
                "--backend", "ita", "--device", "cpu", "--plan-cache", str(tmp_path),
                "--profile"])
    out = capsys.readouterr().out
    assert "plan cache miss" in out and "inf/s" in out and "on cpu" in out
    assert "device busy 0.000 ms" in out  # no device kernels on the CPU


def test_import_leaves_no_jax():
    code = (
        "import sys, json\n"
        "import repro_torch.deploy.api, repro_torch.launch.serve, repro_torch.convert\n"
        "import repro_torch.deploy.executor, repro_torch.models.transformer\n"
        "import repro_torch.quant.ptq, repro_torch.launch.dryrun, repro_torch.quant.fake_quant\n"
        "import repro_torch.models.model_zoo, repro_torch.kernels, repro_torch.configs\n"
        "import repro_torch.launch.train, repro_torch.optim, repro_torch.data\n"
        "import repro_torch.checkpoint, repro_torch.runtime\n"
        "import repro_torch.runtime.sharding, repro_torch.runtime.activations\n"
        "import repro_torch.runtime.pipeline, repro_torch.runtime.elastic\n"
        "import repro_torch.optim.compression, repro_torch.launch.mesh\n"
        "import repro_torch.deploy.hlo_analysis\n"
        "repro_torch.kernels.wrappers()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print(json.dumps(bad))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout) == []


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_jax_or_reference_package():
    files = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
             + sorted((ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"])
    assert len(files) > 20
    bad = [
        (f.relative_to(ROOT).as_posix(), mod)
        for f in files for mod in _imports(f)
        if mod.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert bad == []
