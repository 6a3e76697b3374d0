"""The paper's deployment flow, end to end, for all three workloads — port.

The twin of ``examples/deploy_mobilebert.py``: ONNX-equivalent graph ->
MHA fusion -> head-by-head split -> engine mapping -> geometric tiling
(64-granule, 128 KiB L1, double-buffered) -> static memory layout
(lifetime analysis) -> calibrated cost/energy model -> Table I.  Then each
workload's compiled plan runs one batch on the device and is checked bit
for bit against the model-level integer path.

Run:  PYTHONPATH=src python examples/torch_deploy_mobilebert.py [--device cpu] [--reduced]

The card by default; ``--device cpu`` runs the plain PyTorch versions.
The planning itself is host work; ``--reduced`` runs the reduced models
(the plans printed are the full ones either way).
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.convert import to_device
from repro_torch.deploy import api, costmodel, memory, patterns, tiler
from repro_torch.deploy.graph import build_encoder_graph
from repro_torch.models import encoder as EN

SEQ = {"mobilebert": 128, "dinov2-small": 241, "whisper-tiny-encoder": 512}


def deploy(name: str):
    print(f"\n=== {name} (S={SEQ[name]}) ===")
    g = build_encoder_graph(get_config(name), seq_len=SEQ[name])
    print(f"  ONNX-equivalent graph: {len(g.nodes)} nodes, "
          f"{len(g.weights)} weight tensors")
    g = patterns.fuse_mha(g)
    print(f"  after MHA fusion: {len(g.nodes)} nodes "
          f"({sum(n.op == 'MHA' for n in g.nodes)} fused MHA)")
    g = patterns.split_heads(g)
    heads = sum(n.op == "MHAHead" for n in g.nodes)
    print(f"  after head split: {heads} single-head ITA tasks "
          f"+ {sum(n.op == 'HeadAccum' for n in g.nodes)} cluster accumulations")
    g = patterns.map_engines(g)
    g = patterns.fuse_gelu_epilogue(g)
    ita = sum(n.engine == "ita" for n in g.nodes)
    print(f"  engine mapping: {ita} ITA / {len(g.nodes) - ita} cluster")

    # tiling of a representative FFN GEMM
    cfg = get_config(name)
    t = tiler.solve_gemm_tiling(SEQ[name], cfg.d_ff, cfg.d_model)
    print(f"  FFN tiling {SEQ[name]}x{cfg.d_model}x{cfg.d_ff}: "
          f"tiles {t.tile_m}x{t.tile_k}x{t.tile_n}, L1 {t.l1_bytes//1024} KiB "
          f"(double-buffered), DMA {t.dma_bytes/1e6:.2f} MB")

    plan = memory.plan_memory(g)
    lb = memory.peak_lower_bound(g)
    print(f"  static memory: peak {plan.peak/1024:.0f} KiB "
          f"(lower bound {lb/1024:.0f} KiB), overlap-free: {plan.check_no_overlap()}")

    cost = costmodel.network_cost(g)
    mc = costmodel.network_cost_cluster_only(g)
    print(f"  cost model: {cost.gop:.2f} GOp | +ITA: {cost.inf_per_s:.2f} Inf/s, "
          f"{cost.mj_per_inf:.2f} mJ/Inf | Multi-Core: {mc.inf_per_s:.3f} Inf/s "
          f"| speedup {cost.inf_per_s/mc.inf_per_s:.0f}x")
    return cost


def run_plan(name: str, device, reduced_cfg: bool) -> bool:
    """The compiled plan's session forward on ``device`` against the
    model-level ``forward_w8a8`` (both on the same quantized params)."""
    cfg = get_config(name)
    if reduced_cfg:
        cfg = reduced(cfg)
    model = api.compile(cfg, backend="w8a8", use_cache=False)
    plan = model.artifact
    sess = model.session(1, device=device)
    rng = np.random.default_rng(0)
    name_in = plan.inputs[0]
    if name_in == "tokens":
        x = rng.integers(0, cfg.vocab, (1, plan.seq_len), dtype=np.int32)
    else:
        x = rng.integers(-64, 64, (1, plan.seq_len, cfg.d_model), dtype=np.int8)
    x = torch.from_numpy(x).to(sess.device)
    out = sess.forward(x)
    ref = EN.forward_w8a8(cfg, to_device(sess.qp, sess.device), {name_in: x})
    exact = torch.equal(out, ref)
    print(f"  plan on {sess.device.type}: {plan.counts()['nodes']} nodes, bit-exact={exact}")
    return exact


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="run the reduced models' plans on the device")
    args = ap.parse_args(argv)
    dev = api.resolve_device(args.device)
    costs = {}
    for name in SEQ:
        costs[name] = deploy(name)
        assert run_plan(name, dev, args.reduced)
    return costs


if __name__ == "__main__":
    main()
