"""Unified model API of the port: ``build(cfg)`` returns the per-family function set.

Every architecture exposes the same surface, as in the JAX package:

  init_params(seed, dtype, device)    float training params
  loss_fn(params, batch)              scalar loss (causal CE / seq2seq CE / MLM)
  forward(params, batch)              logits
  init_serve_params(seed, device)     serving params (int8 where the
                                      technique applies)
  prefill(sparams, batch, max_len)    -> (logits, cache)
  decode_step(sparams, cache, token)  -> (logits, cache)
  input_specs(cell)                   :class:`TensorSpec` stand-ins

Serve params per family:
  dense / vlm / moe : fully int8 (w8a8)
  encdec            : fully int8 (w8a8)
  hybrid            : bfloat16 trunk + int8 shared attention (+ int8 KV cache)
  ssm               : bfloat16 (the technique does not apply)
  encoder           : built from float params by PTQ; no decode

Params are drawn on ``device``, the card unless the caller asks for the
CPU (``deploy.api.resolve_device``), by a generator seeded there: a
34 GB int8 model is drawn in seconds on the card.  The bits differ from
``jax.random``'s, and from one device's generator to another's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models import encdec as ED
from repro_torch.models import encoder as EN
from repro_torch.models import mamba2 as MB
from repro_torch.models import transformer as T
from repro_torch.models import zamba2 as Z


def _device(device) -> torch.device:
    from repro_torch.deploy.api import resolve_device

    return resolve_device(device)


class TensorSpec(NamedTuple):
    """Shape and dtype of one model input (``jax.ShapeDtypeStruct``'s role)."""

    shape: tuple
    dtype: torch.dtype


@dataclass
class ModelApi:
    cfg: ArchConfig
    init_params: Callable
    loss_fn: Callable
    forward: Callable
    init_serve_params: Callable
    prefill: Callable | None
    decode_step: Callable | None
    init_cache_shape: Callable | None  # (batch, max_len) -> fn building the cache

    def input_specs(self, cell: ShapeCell, dtype=torch.bfloat16) -> dict:
        return input_specs(self.cfg, cell, dtype)


def build(cfg: ArchConfig) -> ModelApi:
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        return ModelApi(
            cfg=cfg,
            init_params=lambda seed=0, dtype=torch.float32, device=None: T.init_params(
                cfg, seed, dtype, _device(device)),
            loss_fn=lambda p, b, **kw: T.loss_fn(cfg, p, b, **kw),
            forward=lambda p, b, **kw: T.forward(cfg, p, b, **kw),
            init_serve_params=lambda seed=0, device=None: T.init_qparams(
                cfg, seed, _device(device)),
            prefill=lambda sp, b, max_len: T.prefill_w8a8(cfg, sp, b, max_len),
            decode_step=lambda sp, c, t: T.decode_step_w8a8(cfg, sp, c, t),
            init_cache_shape=lambda batch, max_len: (
                lambda device=None: T.init_cache_w8a8(cfg, batch, max_len, device)),
        )
    if fam == "ssm":
        return ModelApi(
            cfg=cfg,
            init_params=lambda seed=0, dtype=torch.float32, device=None: MB.init_params(
                cfg, seed, dtype, _device(device)),
            loss_fn=lambda p, b, **kw: MB.loss_fn(cfg, p, b),
            forward=lambda p, b, **kw: MB.forward(cfg, p, b),
            init_serve_params=lambda seed=0, device=None: MB.init_params(
                cfg, seed, torch.bfloat16, _device(device)),
            prefill=lambda sp, b, max_len: MB.prefill(cfg, sp, b, max_len),
            decode_step=lambda sp, c, t: MB.decode_step(cfg, sp, c, t),
            init_cache_shape=lambda batch, max_len: (
                lambda device=None: MB.init_cache(cfg, batch, torch.bfloat16, device)),
        )
    if fam == "hybrid":

        def init_serve(seed=0, device=None):
            p = Z.init_params(cfg, seed, torch.bfloat16, _device(device))
            return {"params": p, "qshared": Z.quantize_shared(p["shared"])}

        return ModelApi(
            cfg=cfg,
            init_params=lambda seed=0, dtype=torch.float32, device=None: Z.init_params(
                cfg, seed, dtype, _device(device)),
            loss_fn=lambda p, b, **kw: Z.loss_fn(cfg, p, b),
            forward=lambda p, b, **kw: Z.forward(cfg, p, b),
            init_serve_params=init_serve,
            prefill=lambda sp, b, max_len: Z.prefill(cfg, sp["params"], b, max_len,
                                                     sp["qshared"]),
            decode_step=lambda sp, c, t: Z.decode_step(cfg, sp["params"], c, t, sp["qshared"]),
            init_cache_shape=lambda batch, max_len: (
                lambda device=None: Z.init_cache(cfg, batch, max_len, torch.bfloat16, device)),
        )
    if fam == "encdec":
        return ModelApi(
            cfg=cfg,
            init_params=lambda seed=0, dtype=torch.float32, device=None: ED.init_params(
                cfg, seed, dtype, _device(device)),
            loss_fn=lambda p, b, **kw: ED.loss_fn(cfg, p, b),
            forward=lambda p, b, **kw: ED.forward(cfg, p, b),
            init_serve_params=lambda seed=0, device=None: ED.init_qparams(
                cfg, seed, _device(device)),
            prefill=lambda sp, b, max_len: ED.prefill_w8a8(cfg, sp, b, max_len),
            decode_step=lambda sp, c, t: ED.decode_step_w8a8(cfg, sp, c, t),
            init_cache_shape=lambda batch, max_len: (
                lambda device=None: ED.init_cache_w8a8(cfg, batch, max_len, device)),
        )
    if fam == "encoder":
        return ModelApi(
            cfg=cfg,
            init_params=lambda seed=0, dtype=torch.float32, device=None: EN.init_params(
                cfg, seed, dtype, _device(device)),
            loss_fn=lambda p, b, **kw: EN.loss_fn(cfg, p, b, **kw),
            forward=lambda p, b, **kw: EN.forward(cfg, p, b, **kw),
            init_serve_params=lambda seed=0, device=None: None,  # built by PTQ
            prefill=None,
            decode_step=None,
            init_cache_shape=None,
        )
    raise ValueError(f"unknown family {fam}")


# ---------------------------------------------------------------------------
# Input specs
# ---------------------------------------------------------------------------


def _tok_spec(b: int, s: int) -> TensorSpec:
    return TensorSpec((b, s), torch.int32)


def input_specs(cfg: ArchConfig, cell: ShapeCell, dtype=torch.bfloat16) -> dict:
    """:class:`TensorSpec` stand-ins for every model input of this cell.

    train:   the loss_fn batch.
    prefill: the prefill batch (prompt length = cell.seq_len; a vlm's
             patches count in it).
    decode:  {"token": [B, 1]}; the cache is built by ``init_cache_shape``.
    """
    b, s = cell.global_batch, cell.seq_len
    fam = cfg.family
    if fam in ("dense", "moe", "ssm", "hybrid"):
        batch = {"tokens": _tok_spec(b, s)}
    elif fam == "vlm":
        toks = max(s - cfg.n_patches, 1)
        patch_dtype = torch.int8 if cell.kind != "train" else dtype
        batch = {"tokens": _tok_spec(b, toks),
                 "patches": TensorSpec((b, cfg.n_patches, cfg.d_model), patch_dtype)}
    elif fam == "encdec":
        frames = min(cfg.n_frames, max(s // 4, 16))
        frame_dtype = torch.int8 if cell.kind != "train" else dtype
        batch = {"frames": TensorSpec((b, frames, cfg.d_model), frame_dtype),
                 "tokens": _tok_spec(b, s)}
    elif fam == "encoder":
        if cfg.vocab:
            batch = {"tokens": _tok_spec(b, min(s, cfg.max_seq))}
        elif cfg.n_patches:
            batch = {"patches": TensorSpec((b, cfg.n_patches, cfg.d_model), dtype)}
        else:
            batch = {"frames": TensorSpec((b, cfg.n_frames, cfg.d_model), dtype)}
    else:
        raise ValueError(fam)

    if cell.kind == "train":
        lab = batch["tokens"].shape if "tokens" in batch else (b, s)
        batch["labels"] = TensorSpec(lab, torch.int32)
    if cell.kind == "decode":
        batch = {"token": _tok_spec(b, 1)}
    return batch


def synthesize_batch(cfg: ArchConfig, cell: ShapeCell, seed: int = 0, dtype=torch.float32,
                     device=None) -> dict:
    """A random batch matching ``input_specs``, drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` and moved to ``device`` (the
    card unless the caller asks for the CPU)."""
    dev = _device(device)
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, spec in input_specs(cfg, cell, dtype).items():
        if spec.dtype == torch.int32:
            hi = max(cfg.vocab, 2) if name in ("tokens", "labels", "token") else 2
            t = torch.randint(0, hi, spec.shape, generator=gen, dtype=torch.int32)
        elif spec.dtype == torch.int8:
            t = torch.randint(-127, 128, spec.shape, generator=gen, dtype=torch.int8)
        else:
            t = torch.randn(spec.shape, generator=gen, dtype=spec.dtype)
        out[name] = t.to(dev)
    return out
