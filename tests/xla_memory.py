"""XLA's memory analysis of the JAX package's dry-run cells: GSPMD's bytes a rank.

The reference's ``repro.launch.dryrun.build_cell`` compiled on an
``Auto``-axis mesh of forced host devices (JAX 0.9's default Explicit axes
refuse the reference's own constraints, so its CLI fails), and
``memory_analysis()`` read.  Nothing runs: a full-width cell compiles in
seconds on a CPU, so GSPMD's figure is always at hand to hold the port's
``launch.dryrun`` record against.

  PYTHONPATH=src python tests/xla_memory.py --arch olmo-1b --shape train_4k
  PYTHONPATH=src python tests/xla_memory.py --arch olmo-1b mamba2-370m --mesh 16x16

prints one line ``XLA_MEMORY <json>``: ``{"<arch>|<shape>|<mesh>": {"temp",
"arg", "out", "compile_s", "flops", "collective_bytes",
"collective_counts"}}`` (bytes a rank; flops and collectives as the
reference's ``deploy.hlo_analysis`` reads the partitioned HLO), or
``{"error": ...}`` for a cell that does not compile.
"""

import argparse
import json
import os
import sys
import time
import traceback


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", required=True)
    ap.add_argument("--shape", nargs="+", default=["train_4k"])
    ap.add_argument("--mesh", default="16x16", help="data x model")
    args = ap.parse_args(argv)
    shape = tuple(int(n) for n in args.mesh.split("x"))
    n = shape[0] * shape[1]

    import repro.launch.dryrun as RD  # sets XLA_FLAGS for 512 devices: set it back first

    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
    import jax

    from repro.deploy.hlo_analysis import analyze_hlo
    from repro.runtime.activations import activation_policy

    mesh = jax.make_mesh(shape, ("data", "model"), devices=jax.devices()[:n],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    res = {}
    for arch in args.arch:
        for name in args.shape:
            key = f"{arch}|{name}|{args.mesh}"
            t0 = time.time()
            try:
                fn, specs, shardings, meta = RD.build_cell(arch, name, mesh)
                with mesh, activation_policy(mesh, sequence_parallel=(meta["kind"] == "train")):
                    compiled = jax.jit(fn, in_shardings=shardings).lower(*specs).compile()
                mem = compiled.memory_analysis()
                hlo = analyze_hlo(compiled.as_text())
                res[key] = {"temp": int(mem.temp_size_in_bytes),
                            "arg": int(mem.argument_size_in_bytes),
                            "out": int(mem.output_size_in_bytes),
                            "compile_s": round(time.time() - t0, 2), "flops": hlo["flops"],
                            "collective_bytes": hlo["collective_bytes"],
                            "collective_counts": hlo["collective_counts"]}
            except Exception:  # noqa: BLE001 - reported in the line
                res[key] = {"error": traceback.format_exc()[-2000:]}
            print(f"{key}: {res[key]}", file=sys.stderr, flush=True)
    print("XLA_MEMORY " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
