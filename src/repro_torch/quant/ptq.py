"""Post-training quantization: calibrate activation scales from float runs (torch port).

The QuantLib-analogue flow for the paper's models: run the float model on
calibration batches, record the absmax of the residual stream and of the
post-norm activations, and derive the static ``QuantConfig`` the integer
path bakes into its requantization multipliers.  The scales are python
floats, so one ``QuantConfig`` feeds the integer path on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.convert import tree_leaves
from repro_torch.models import layers as L


def _absmax(x: torch.Tensor) -> float:
    return float(torch.amax(torch.abs(x)))


@torch.no_grad()
def calibrate_encoder(cfg: ArchConfig, params: dict, batches: list[dict],
                      margin: float = 1.05) -> L.QuantConfig:
    """Calibrated (s_act, s_res, s_w) for the encoder integer path.

    Tracks |residual stream| and |post-norm activations| across layers and
    calibration batches; scales = absmax * margin / 127.  The weight grid
    spans every per-layer parameter: the JAX package takes the leaves of
    its stacked layers with two or more dims, which with the layer axis
    is every one of them, biases and norm gains included.
    """
    from repro_torch.models.encoder import embed
    from repro_torch.models.transformer import layer_fwd

    res_max, act_max = 0.0, 0.0
    for batch in batches:
        x = embed(cfg, params, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        res_max = max(res_max, _absmax(x))
        for lp in params["layers"]:
            h = L.norm_apply(cfg.norm, lp["norm1"], x)
            act_max = max(act_max, _absmax(h))
            x, _ = layer_fwd(cfg, lp, x, positions, causal=False)
            res_max = max(res_max, _absmax(x))
    s_res = max(res_max, 1e-3) * margin / 127.0
    s_act = max(act_max, 1e-3) * margin / 127.0
    w_absmax = 0.0
    for leaf in tree_leaves(params["layers"]):
        if leaf.dim() >= 1:
            w_absmax = max(w_absmax, _absmax(leaf))
    s_w = max(w_absmax, 1e-3) / 127.0
    return L.QuantConfig(s_act=s_act, s_res=s_res, s_w=s_w)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def quantization_error(float_logits, int8_logits) -> dict:
    """Fidelity metrics between float and integer model outputs (float64
    numpy on the host, as the JAX package computes them)."""
    fa, qa = _np(float_logits), _np(int8_logits)
    f = np.asarray(fa, np.float64).reshape(-1)
    q = np.asarray(qa, np.float64).reshape(-1)
    cos = float(f @ q / (np.linalg.norm(f) * np.linalg.norm(q) + 1e-12))
    rel = float(np.linalg.norm(f - q) / (np.linalg.norm(f) + 1e-12))
    agree = float(np.mean(np.argmax(fa, -1) == np.argmax(qa, -1)))
    return {"cosine": cos, "rel_err": rel, "argmax_agreement": agree}
