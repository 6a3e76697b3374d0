"""Quickstart of the PyTorch port: the paper's technique in five minutes.

1. Build MobileBERT (the paper's flagship workload) in float.
2. Calibrate it (PTQ) and quantize it to end-to-end int8.
3. Run integer inference — ITAMax softmax, i-GeLU, int8 GEMMs.
4. Run the same integers through the ``ita`` backend: the ``int8_gemm`` /
   ``ita_attention`` CUDA kernels on the card, their plain versions on
   the CPU.
5. Plan the deployment like Deeploy: fuse MHA, split heads, map engines,
   lay out memory statically, and predict the end-to-end cost on the ITA
   ASIC with the calibrated Snitch + ITA cost model.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] [--full]

The card by default; ``--device cpu`` runs the plain PyTorch versions.
``--full`` uses the full MobileBERT (24 layers) instead of the reduced one.
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.convert import to_device
from repro_torch.deploy import costmodel, memory, patterns
from repro_torch.deploy.api import resolve_device
from repro_torch.deploy.graph import build_encoder_graph
from repro_torch.models import encoder as EN
from repro_torch.quant.ptq import calibrate_encoder, quantization_error


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--full", action="store_true", help="the full MobileBERT, not the reduced")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("mobilebert")
    if not args.full:
        cfg = reduced(cfg)

    print(f"== 1. float MobileBERT ({'full' if args.full else 'reduced'}) on {dev.type} ==")
    params = to_device(EN.init_params(cfg, 0), dev)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64), dtype=np.int32)).to(dev)
    batch = {"tokens": tokens, "labels": tokens}
    with torch.no_grad():
        logits = EN.forward(cfg, params, batch)
        loss = float(EN.loss_fn(cfg, params, batch))
    print(f"  float logits: {tuple(logits.shape)}, loss={loss:.3f}")

    print("== 2-3. PTQ (calibrated) -> end-to-end int8 inference ==")
    qc = calibrate_encoder(cfg, params, [{"tokens": tokens}])
    qp = EN.quantize_params(cfg, params, qc)
    int8_logits = EN.forward_w8a8(cfg, qp, {"tokens": tokens}, q=qc)
    err = quantization_error(logits, int8_logits)
    print(f"  scales: s_act {qc.s_act:.5f}, s_res {qc.s_res:.5f}, s_w {qc.s_w:.5f}")
    print(f"  int8 logits: {tuple(int8_logits.shape)}; cosine vs float {err['cosine']:.3f}, "
          f"argmax agreement {err['argmax_agreement']:.1%}")
    print("  (random-init model — the adversarial PTQ case; per-op integer")
    print("   fidelity is bit-tested in tests/)")

    print("== 4. the kernel backend (ita) ==")
    ita_logits = EN.forward_w8a8(cfg, qp, {"tokens": tokens}, q=qc, backend="ita")
    drift = float((ita_logits - int8_logits).abs().max())
    rel = drift / (float(int8_logits.abs().max()) + 1e-9)
    print(f"  ita-vs-w8a8 max |delta|: {drift:.4f} ({rel:.1%} of range — same integer "
          "GEMMs; flash vs rowwise softmax schedule)")

    print("== 5. Deeploy-style deployment plan (full MobileBERT, S=128) ==")
    g = build_encoder_graph(get_config("mobilebert"), seq_len=128)
    g = patterns.deploy_pipeline(g, head_by_head=True)
    ita_nodes = sum(n.engine == "ita" for n in g.nodes)
    print(f"  graph: {len(g.nodes)} nodes after fusion; {ita_nodes} on ITA, "
          f"{len(g.nodes) - ita_nodes} on the cluster")
    plan = memory.plan_memory(g)
    print(f"  static memory plan: peak {plan.peak / 1e3:.1f} kB, "
          f"no-overlap={plan.check_no_overlap()}")
    cost = costmodel.network_cost(g)
    print(f"  ITA ASIC cost model: {cost.gop:.2f} GOp, {cost.inf_per_s:.1f} Inf/s, "
          f"{cost.mj_per_inf:.2f} mJ/Inf (paper: 4.74 GOp, 32.5 Inf/s, 1.60 mJ/Inf)")


if __name__ == "__main__":
    main()
