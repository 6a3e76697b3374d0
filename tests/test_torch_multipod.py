"""The multi-pod dry run of the port against the JAX package's.

* ``deploy.hlo_analysis`` counts a nested loop of products exactly (the
  twin of ``tests/test_substrates.py``'s HLO check), and the collective
  bytes of known redistributions on a fake 2x2 world as reckoned by hand;
* ``launch.dryrun.build_cell`` against the reference's, for reduced
  OLMo-1B, qwen2-moe-a2.7b and mamba2-370m at small train / prefill /
  decode cells: the port runs in a fake world of 4 (one spawned process),
  the reference in a subprocess with 4 forced host devices on ``Auto``-
  axis meshes (JAX 0.9's Explicit axes refuse its own constraints), its
  ``get_config`` / ``ALL_SHAPES`` patched there.  Held: the per-rank
  argument bytes equal XLA's ``argument_size_in_bytes``, on 1x1 and 2x2;
  the flops agree within ``FLOPS_RTOL`` on 1x1; on 2x2 the flops ratio and
  the collective counts are recorded (printed) with the bounds below;
* one full-width cell through the CLI on the CPU.

On 1x1 both count every product of the same step; OLMo-1B's equal XLA's
to the flop in all three cells (dense: the same products both ways).
The others differ where the two take other products for the same work
(measured port / XLA: mamba2 train 0.988, its float SSD contracting its
five-operand einsums pairwise; qwen2-moe 1.063 / 0.745 / 0.985, its
experts one exact product per padded expert in the port).  On 2x2 GSPMD
and DTensor choose their own layouts: the port keeps each rank's share
of the products, so its flops a rank are between a quarter of its 1x1
flops and all of them (a product DTensor replicates).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.deploy.hlo_analysis import COLLECTIVES, OpRecorder, analyze_hlo, top_dots
from repro_torch.launch.mesh import spawn

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["olmo-1b", "qwen2-moe-a2.7b", "mamba2-370m"]
#: (name, seq_len, global batch, kind): the reference's cell names, small
CELLS = [("train_4k", 32, 8, "train"), ("prefill_32k", 32, 4, "prefill"),
         ("decode_32k", 32, 4, "decode")]
MESHES = [(1, 1), (2, 2)]
FLOPS_RTOL = 0.3

REFERENCE = r"""
import json, os, sys
import repro.launch.dryrun as RD  # sets XLA_FLAGS for 512 devices: set it back first
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro.configs import ShapeCell, get_config, reduced
from repro.deploy.hlo_analysis import analyze_hlo
from repro.runtime.activations import activation_policy

archs, cells, meshes = json.loads(sys.argv[1])
RD.get_config = lambda a: reduced(get_config(a))
RD.ALL_SHAPES = tuple(ShapeCell(*c) for c in cells)
res = {}
for shape in meshes:
    n = shape[0] * shape[1]
    mesh = jax.make_mesh(tuple(shape), ("data", "model"), devices=jax.devices()[:n],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    for arch in archs:
        for name, *_ in cells:
            fn, specs, shardings, meta = RD.build_cell(arch, name, mesh)
            with mesh, activation_policy(mesh, sequence_parallel=(meta["kind"] == "train")):
                compiled = jax.jit(fn, in_shardings=shardings).lower(*specs).compile()
            hlo = analyze_hlo(compiled.as_text())
            res[f"{arch}|{name}|{shape[0]}x{shape[1]}"] = {
                "arg": int(compiled.memory_analysis().argument_size_in_bytes),
                "flops": hlo["flops"], "counts": hlo["collective_counts"]}
print("REFERENCE_JSON " + json.dumps(res))
"""


def _port_cells(rank, world, out):
    """One spawned process: a fake world of 4, every cell on 1x1 and 2x2."""
    import torch.distributed as dist

    import repro_torch.launch.dryrun as D
    from repro_torch.configs import ShapeCell, get_config, reduced
    from repro_torch.launch.mesh import init_fake_world, make_mesh

    dist.destroy_process_group()  # the spawn's gloo group of one
    init_fake_world(4)
    D.get_config = lambda a: reduced(get_config(a))
    D.ALL_SHAPES = tuple(ShapeCell(*c) for c in CELLS)
    res = {}
    for shape in MESHES:
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        for arch in ARCHS:
            for name, *_ in CELLS:
                r = D.analyze_cell(arch, name, mesh, device="cpu")
                res[f"{arch}|{name}|{shape[0]}x{shape[1]}"] = {
                    "arg": r["argument_size_in_bytes"], "flops": r["flops"],
                    "counts": r["collectives"]["op_counts"], "kind": r["kind"]}
    res["collectives"] = _known_redistributions()
    Path(out).write_text(json.dumps(res))


def _known_redistributions() -> dict:
    """Each case's collective bytes and counts on a fake 2x2 mesh: f32 [8, 16]."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch.dryrun import fake_mode
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    cases = {
        "gather_rows": ([Shard(0), Replicate()], [Replicate(), Replicate()]),
        "reduce": ([Replicate(), Partial()], [Replicate(), Replicate()]),
        "reduce_scatter": ([Replicate(), Partial()], [Replicate(), Shard(0)]),
        "gather_both": ([Shard(0), Shard(1)], [Replicate(), Replicate()]),
    }
    out = {}
    with fake_mode():
        for name, (src, dst) in cases.items():
            local = [8, 16]
            for i, p in enumerate(src):
                if p.is_shard():
                    local[p.dim] //= 2
            x = DTensor.from_local(torch.zeros(local), mesh, src, run_check=False)
            rec = OpRecorder()
            with rec:
                x.redistribute(mesh, dst)
            a = analyze_hlo(rec)
            out[name] = {"bytes": a["collective_by_op"], "counts": a["collective_counts"]}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("multipod")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    for var in ("JAX_PLATFORMS", "TPU_SKIP_MDS_QUERY", "HOME"):
        if var in os.environ:
            env[var] = os.environ[var]
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, json.dumps([ARCHS, CELLS, MESHES])],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                           cwd=ROOT)
    try:
        spawn(_port_cells, 1, str(out / "port.json"), workdir=out, timeout=300)
        stdout, stderr = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    line = [l for l in stdout.splitlines() if l.startswith("REFERENCE_JSON ")]
    assert line, stderr[-3000:]
    return {"ref": json.loads(line[0][len("REFERENCE_JSON "):]),
            "port": json.loads((out / "port.json").read_text())}


def test_flops_of_a_nested_loop_are_exact():
    a, w = torch.randn(32, 128), torch.randn(128, 128)
    rec = OpRecorder()
    with rec:
        for _ in range(6):
            for _ in range(3):
                a @ w
    got = analyze_hlo(rec)
    assert got["flops"] == 2 * 32 * 128 * 128 * 6 * 3
    assert got["op_counts"]["aten.mm.default"] == 18
    assert got["collective_bytes"] == 0 and set(got["collective_by_op"]) == set(COLLECTIVES)
    (top,) = top_dots(rec)
    assert top["mult"] == 18 and top["flops_each"] == 2 * 32 * 128 * 128
    assert top["source"] == "<autograd>"  # no frame of the port's own code above it


def test_collective_bytes_of_known_redistributions(runs):
    got = runs["port"]["collectives"]
    full = 8 * 16 * 4
    zero = dict.fromkeys(COLLECTIVES, 0)
    for name, (kind, n, nbytes) in {
        "gather_rows": ("all-gather", 1, full),  # the gathered result
        "reduce": ("all-reduce", 1, full),
        "reduce_scatter": ("reduce-scatter", 1, full),  # its operand: what a rank sends
        "gather_both": ("all-gather", 2, full // 2 + full),  # [4, 8] -> [4 or 8, 16] -> all
    }.items():
        assert got[name]["counts"] == {**zero, kind: n}, name
        assert got[name]["bytes"][kind] == nbytes, name
        assert sum(got[name]["bytes"].values()) == nbytes, name


@pytest.mark.parametrize("mesh", ["1x1", "2x2"])
@pytest.mark.parametrize("cell", [c[0] for c in CELLS])
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_a_rank_equal_xla(runs, arch, cell, mesh):
    key = f"{arch}|{cell}|{mesh}"
    assert runs["port"][key]["arg"] == runs["ref"][key]["arg"], key


@pytest.mark.parametrize("cell", [c[0] for c in CELLS])
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_on_one_rank_agree_with_xla(runs, arch, cell):
    key = f"{arch}|{cell}|1x1"
    got, want = runs["port"][key]["flops"], runs["ref"][key]["flops"]
    print(f"{key}: port/XLA flops {got / want:.4f}")
    assert got > 0 and abs(got - want) <= FLOPS_RTOL * want, (key, got, want)
    if arch == "olmo-1b":
        assert got == want, (key, got, want)
    assert sum(runs["port"][key]["counts"].values()) == 0  # one rank moves nothing


@pytest.mark.parametrize("cell", [c[0] for c in CELLS])
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_and_collectives_on_2x2(runs, arch, cell):
    one, four = runs["port"][f"{arch}|{cell}|1x1"], runs["port"][f"{arch}|{cell}|2x2"]
    ref = runs["ref"][f"{arch}|{cell}|2x2"]
    ratio = four["flops"] / one["flops"]
    print(f"{arch} {cell}: port 2x2/1x1 flops {ratio:.3f} (XLA "
          f"{ref['flops'] / runs['ref'][f'{arch}|{cell}|1x1']['flops']:.3f}); "
          f"collectives port {four['counts']} XLA {ref['counts']}")
    assert 0.25 <= ratio <= 1.0 + 1e-9, ratio
    assert sum(four["counts"].values()) > 0  # a sharded step moves something


def test_one_full_width_cell_through_the_cli(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mamba2-370m", "--shape",
         "decode_32k", "--device", "cpu", "--out-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "[ok     ] mamba2-370m" in proc.stdout and "1 ok, 0 skipped" in proc.stdout
    rec = json.loads((tmp_path / "mamba2-370m__decode_32k__16x16.json").read_text())
    for key in ("arch", "shape", "mesh", "status", "kind", "lower_s", "compile_s", "flops",
                "mem_bytes", "collectives", "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes"):
        assert key in rec, key
    assert rec["status"] == "ok" and rec["mesh"] == "16x16" and rec["kind"] == "decode"
    assert set(rec["collectives"]) == {"bytes_by_op", "op_counts", "total_bytes"}
    assert rec["flops"] > 0 and rec["argument_size_in_bytes"] > 0
