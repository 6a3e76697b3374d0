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
* the train step's memory against GSPMD's: with reduced widths and the
  published vocab (50304), batch 8 x 128, in the same subprocess and fake
  world, the port's temp bytes a rank on 2x2 are held to
  ``TEMP_RATIO_2X2`` x XLA's ``temp_size_in_bytes`` and no single storage
  reaches half of a microbatch's global float32 logits; OLMo-1B's
  ``train_4k`` at full width on 16x16 (the port's CLI cell, XLA's on 256
  forced host devices through ``tests/xla_memory.py``) is held to
  ``TEMP_RATIO_FULL`` x XLA's;
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
from dataclasses import replace
from pathlib import Path

import pytest
import torch

from repro_torch.deploy.hlo_analysis import (
    COLLECTIVES,
    OpRecorder,
    analyze_hlo,
    live_at_peak,
    top_dots,
)
from repro_torch.launch.mesh import spawn

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["olmo-1b", "qwen2-moe-a2.7b", "mamba2-370m"]
#: (name, seq_len, global batch, kind): the reference's cell names, small
CELLS = [("train_4k", 32, 8, "train"), ("prefill_32k", 32, 4, "prefill"),
         ("decode_32k", 32, 4, "decode")]
MESHES = [(1, 1), (2, 2)]
FLOPS_RTOL = 0.3
#: the train cell whose temp bytes a rank are held against XLA's: reduced
#: widths with a published vocab, so that the logits weigh as they do at
#: full width (a batch x sequence x vocab float32 tensor is 206 MB here)
TEMP_VOCAB = 50304
TEMP_CELLS = [("train_4k", 128, 8, "train")]
#: the weight-heavy set: reduced() with wider layers (d 512, d_ff 2048, 4
#: layers, the SSM's heads 64 wide), batch 32 x 128 so that each data rank
#: of 2x2 routes 2 MoE dispatch groups and each of qwen1.5's 16
#: microbatches splits over "data"; on 2x2 only.  FSDP's gradients, the
#: MoE masks and the SSM blocks' saved elementwise results weigh here as
#: at full width
HEAVY = "heavy|"
HEAVY_ARCHS = ["qwen1.5-110b", "granite-moe-3b-a800m", "mamba2-370m"]
HEAVY_CELLS = [("train_4k", 128, 32, "train")]
HEAVY_WIDTHS = {"vocab": 512, "d_model": 512, "d_ff": 2048, "n_layers": 4, "n_heads": 8,
                "head_dim": 64, "ssm_state": 64, "ssm_head_dim": 64, "ssm_chunk": 128}
#: (key prefix, archs, cells, reduced()'s fields replaced, meshes): every
#: set runs in the same reference subprocess and the same fake world
SETS = [("", ARCHS, CELLS, {}, MESHES),
        (f"v{TEMP_VOCAB}|", ARCHS, TEMP_CELLS, {"vocab": TEMP_VOCAB}, MESHES),
        (HEAVY, HEAVY_ARCHS, HEAVY_CELLS, HEAVY_WIDTHS, [(2, 2)])]
#: temp a rank, port / XLA: on 2x2 with the published vocab (the loss's
#: and the head's layout), and at full width (OLMo-1B train_4k on 16x16)
TEMP_RATIO_2X2, TEMP_RATIO_FULL = 1.25, 1.5

REFERENCE = r"""
import dataclasses, json, os, sys
import repro.launch.dryrun as RD  # sets XLA_FLAGS for 512 devices: set it back first
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro.configs import ShapeCell, get_config, reduced
from repro.deploy.hlo_analysis import analyze_hlo
from repro.runtime.activations import activation_policy

sets, meshes = json.loads(sys.argv[1])
res = {}
for shape in meshes:
    n = shape[0] * shape[1]
    mesh = jax.make_mesh(tuple(shape), ("data", "model"), devices=jax.devices()[:n],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    for pre, archs, cells, fields, on in sets:
        if shape not in on:
            continue
        RD.get_config = lambda a, f=fields: dataclasses.replace(reduced(get_config(a)), **f)
        RD.ALL_SHAPES = tuple(ShapeCell(*c) for c in cells)
        for arch in archs:
            for name, *_ in cells:
                fn, specs, shardings, meta = RD.build_cell(arch, name, mesh)
                with mesh, activation_policy(mesh, sequence_parallel=(meta["kind"] == "train")):
                    compiled = jax.jit(fn, in_shardings=shardings).lower(*specs).compile()
                hlo = analyze_hlo(compiled.as_text())
                mem = compiled.memory_analysis()
                res[f"{pre}{arch}|{name}|{shape[0]}x{shape[1]}"] = {
                    "arg": int(mem.argument_size_in_bytes), "temp": int(mem.temp_size_in_bytes),
                    "flops": hlo["flops"], "counts": hlo["collective_counts"]}
print("REFERENCE_JSON " + json.dumps(res))
"""


def _port_cells(rank, world, out):
    """One spawned process: a fake world of 4, every cell of every set on
    1x1 and 2x2."""
    import dataclasses

    import torch.distributed as dist

    import repro_torch.launch.dryrun as D
    from repro_torch.configs import ShapeCell, get_config, reduced
    from repro_torch.launch.mesh import init_fake_world, make_mesh

    dist.destroy_process_group()  # the spawn's gloo group of one
    init_fake_world(4)
    res = {}
    for shape in MESHES:
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        for pre, archs, cells, fields, on in SETS:
            if shape not in on:
                continue
            D.get_config = lambda a, f=fields: dataclasses.replace(reduced(get_config(a)), **f)
            D.ALL_SHAPES = tuple(ShapeCell(*c) for c in cells)
            for arch in archs:
                for name, *_ in cells:
                    heavy = pre == HEAVY
                    r = D.analyze_cell(arch, name, mesh, device="cpu", at_peak=PEAK_ALL * heavy)
                    res[f"{pre}{arch}|{name}|{shape[0]}x{shape[1]}"] = {
                        "arg": r["argument_size_in_bytes"], "flops": r["flops"],
                        "counts": r["collectives"]["op_counts"], "kind": r["kind"],
                        "temp": r["temp_size_in_bytes"], "largest": r["largest_bytes"],
                        **({"peak": r["live_at_peak"],
                            "gathered": _gathered_weights(D.get_config(arch), mesh)}
                           if heavy else {})}
    res["collectives"] = _known_redistributions()
    Path(out).write_text(json.dumps(res))


#: every group of the storages live at a heavy cell's peak
PEAK_ALL = 10**6


def _gathered_weights(cfg, mesh) -> list:
    """[shape, dtype] of each >= 2-D leaf of one layer of ``cfg``'s train
    params (bfloat16, as a train cell draws them) as a product gathers it
    on ``mesh``: the rank's shard with the FSDP split over "data" undone.
    Its gradient comes at this shape too, until it is reduce-scattered."""
    from repro_torch.convert import tree_leaves
    from repro_torch.launch.dryrun import fake_mode
    from repro_torch.models import build
    from repro_torch.runtime.sharding import param_shardings

    with fake_mode():
        layer = build(cfg).init_params(0, torch.bfloat16, device="cpu")["layers"][0]
    out = []
    for leaf, sh in zip(tree_leaves(layer), tree_leaves(param_shardings(mesh, layer, fsdp=True))):
        shape = list(leaf.shape)
        for name, pl in zip(mesh.mesh_dim_names, sh.placements):
            if pl.is_shard() and name != "data":
                shape[pl.dim] //= mesh.size(mesh.mesh_dim_names.index(name))
        if leaf.dim() >= 2:
            out.append([shape, "bfloat16"])
    return out


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
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, json.dumps([SETS, MESHES])],
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


def test_live_at_peak_groups_the_storages_of_the_peak():
    w = torch.randn(64, 64)
    rec = OpRecorder(at_peak=True)
    rec.track(w)
    with rec:
        a = [torch.zeros(256) for _ in range(3)]  # 3 x 1 KiB, live at the peak
        b = torch.ones(1024)  # 4 KiB: the peak
        del b
        c = torch.ones(512)  # 2 KiB, made after the peak: not in it
    assert rec.peak_bytes == 64 * 64 * 4 + 3 * 1024 + 4096 and rec.largest_bytes == 64 * 64 * 4
    assert rec.live_bytes == 64 * 64 * 4 + 3 * 1024 + 2048
    assert live_at_peak(rec) == [
        {"bytes_total": 16384, "count": 1, "source": "<argument>", "shape": [64, 64],
         "dtype": "float32"},
        {"bytes_total": 4096, "count": 1, "source": "<autograd>", "shape": [1024],
         "dtype": "float32"},
        {"bytes_total": 3072, "count": 3, "source": "<autograd>", "shape": [256],
         "dtype": "float32"}]
    assert live_at_peak(rec, 1)[0]["source"] == "<argument>"
    assert len(a) == 3 and c.numel() == 512
    assert analyze_hlo(rec)["largest_bytes"] == 64 * 64 * 4
    assert OpRecorder().peak_live == []  # kept only with at_peak


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


def _temp_ratios(runs, pre: str, cell: str, mesh: str, archs=ARCHS) -> dict:
    return {a: runs["port"][f"{pre}{a}|{cell}|{mesh}"]["temp"]
            / runs["ref"][f"{pre}{a}|{cell}|{mesh}"]["temp"] for a in archs}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_temp_a_rank_within_xla(runs, arch):
    """The train step's temp bytes a rank (the most live above the
    arguments) against XLA's ``temp_size_in_bytes`` on 2x2, with the
    published vocab: the loss and the head run on each rank's logits shard.
    The 1x1 ratios and the vocab-512 set's are printed, not bounded (the
    vocab-512 qwen2-moe cell holds its MoE routing masks whole: ROADMAP
    section 3)."""
    pre, cell = f"v{TEMP_VOCAB}|", TEMP_CELLS[0][0]
    ratio = _temp_ratios(runs, pre, cell, "2x2")[arch]
    print(f"{arch} {cell} vocab {TEMP_VOCAB}: port/XLA temp 2x2 {ratio:.3f}, 1x1 "
          f"{_temp_ratios(runs, pre, cell, '1x1')[arch]:.3f}; vocab 512 "
          + ", ".join(f"{c} {m} {_temp_ratios(runs, '', c, m)[arch]:.3f}"
                      for c, *_ in CELLS for m in ("1x1", "2x2")))
    assert 0 < ratio <= TEMP_RATIO_2X2, ratio


@pytest.mark.parametrize("arch", ARCHS)
def test_no_rank_holds_the_global_logits(runs, arch):
    """On 2x2 no single storage of the train step reaches half of one
    microbatch's float32 logits at their global shape."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.dryrun import MICROBATCHES

    _, s, b, _ = TEMP_CELLS[0]
    v_pad = replace(reduced(get_config(arch)), vocab=TEMP_VOCAB).vocab_padded
    logits = b // MICROBATCHES.get(arch, 1) * s * v_pad * 4
    got = runs["port"][f"v{TEMP_VOCAB}|{arch}|{TEMP_CELLS[0][0]}|2x2"]["largest"]
    print(f"{arch}: largest storage {got / 1e6:.1f} MB, a microbatch's global logits "
          f"{logits / 1e6:.1f} MB")
    assert 0 < got < logits / 2, got


def test_full_width_olmo_train_temp_within_xla(tmp_path):
    """OLMo-1B ``train_4k`` at full width on 16x16: the port's CLI cell (a
    fake world of 256, with the storages live at its peak) against XLA's
    memory analysis of the reference's ``build_cell`` on 256 forced host
    devices (``tests/xla_memory.py``), both at once."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    for var in ("JAX_PLATFORMS", "TPU_SKIP_MDS_QUERY", "HOME"):
        if var in os.environ:
            env[var] = os.environ[var]
    ref = subprocess.Popen([sys.executable, str(ROOT / "tests" / "xla_memory.py"), "--arch",
                            "olmo-1b", "--shape", "train_4k"], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    try:
        port = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "olmo-1b", "--shape",
             "train_4k", "--device", "cpu", "--out-dir", str(tmp_path), "--live-at-peak", "4"],
            capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            cwd=ROOT, timeout=300)
        stdout, stderr = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert port.returncode == 0, port.stdout[-2000:] + port.stderr[-2000:]
    line = [l for l in stdout.splitlines() if l.startswith("XLA_MEMORY ")]
    assert line, stderr[-3000:]
    want = json.loads(line[0][len("XLA_MEMORY "):])["olmo-1b|train_4k|16x16"]
    got = json.loads((tmp_path / "olmo-1b__train_4k__16x16.json").read_text())
    top = got["live_at_peak"]
    print(f"olmo-1b train_4k 16x16: temp port {got['temp_size_in_bytes'] / 1e9:.2f} GB, XLA "
          f"{want['temp'] / 1e9:.2f} GB; largest storage {got['largest_bytes'] / 1e9:.3f} GB; "
          f"live at the peak: {top}")
    assert got["argument_size_in_bytes"] == want["arg"]
    assert 0 < got["temp_size_in_bytes"] <= TEMP_RATIO_FULL * want["temp"], (got, want)
    # the peak's largest groups, largest first, within the peak
    assert len(top) == 4 and sorted(top, key=lambda g: -g["bytes_total"]) == top
    assert sum(g["bytes_total"] for g in top) <= got["peak_bytes"]
    assert all(g["bytes_total"] / g["count"] <= got["largest_bytes"] for g in top)


@pytest.mark.parametrize("arch", HEAVY_ARCHS)
def test_heavy_train_temp_a_rank_within_xla(runs, arch):
    """The weight-heavy set on 2x2: the train step's temp bytes a rank
    within ``TEMP_RATIO_2X2`` x XLA's.  FSDP gradients held at their
    gathered shape until the backward ends (qwen1.5: 2.16x on the parent)
    and MoE routing held as three dense float32 [G, g, E x C] masks
    (granite: 1.99x) broke it."""
    key = f"{HEAVY}{arch}|{HEAVY_CELLS[0][0]}|2x2"
    port, ref = runs["port"][key], runs["ref"][key]
    ratio = port["temp"] / ref["temp"]
    print(f"{key}: temp port {port['temp'] / 1e6:.2f} MB, XLA {ref['temp'] / 1e6:.2f} MB "
          f"({ratio:.3f}x); flops port {port['flops']:.4e} XLA {ref['flops']:.4e}; "
          f"collectives port {port['counts']} XLA {ref['counts']}")
    assert port["arg"] == ref["arg"], key
    assert 0 < ratio <= TEMP_RATIO_2X2, ratio


def _live(runs, arch, pred) -> int:
    peak = runs["port"][f"{HEAVY}{arch}|{HEAVY_CELLS[0][0]}|2x2"]["peak"]
    return sum(g["count"] for g in peak if pred(g))


@pytest.mark.parametrize("arch", HEAVY_ARCHS)
def test_no_more_than_two_layers_of_gathered_weights_at_the_peak(runs, arch):
    """At the 2x2 peak, the storages with the shape of a layer weight as
    a product gathers it (a gathered weight, or a gradient not yet
    reduce-scattered) are at most two layers' worth: FSDP's gradients are
    reduce-scattered as each layer's backward ends (the parent held every
    layer's until the backward returned)."""
    key = f"{HEAVY}{arch}|{HEAVY_CELLS[0][0]}|2x2"
    weights = runs["port"][key]["gathered"]
    shapes = {(tuple(s), dt) for s, dt in weights}
    got = _live(runs, arch, lambda g: (tuple(g["shape"]), g["dtype"]) in shapes
                and g["source"] != "<argument>")
    print(f"{key}: {got} storages of a gathered layer weight's shape live at the peak; "
          f"{len(weights)} weights a layer")
    assert got <= 2 * len(weights), got


def test_ssm_blocks_keep_no_elementwise_intermediates(runs):
    """mamba2 at the 2x2 peak: storages made by the causal conv and the
    SiLUs are each block's SiLU output (the scan's x, B and C) and at most
    one block's stretch being made again in its backward, not every
    block's padded conv input, partial sums and sigmoids (the parent
    held 40 such storages over 4 blocks)."""
    arch = "mamba2-370m"
    got = _live(runs, arch, lambda g: g["source"].endswith((" silu", " _conv1d_causal")))
    n = HEAVY_WIDTHS["n_layers"]
    print(f"{arch}: {got} storages of the conv and the SiLUs live at the peak, {n} blocks")
    assert got <= n + 4, got
