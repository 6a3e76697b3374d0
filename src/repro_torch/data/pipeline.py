"""Synthetic data pipeline: deterministic, host-sharded, prefetching.

The stream is a pure function of (seed, step, process) — drawn by numpy
from the same generator as the JAX package's, so every batch equals the
reference's bit for bit — and a restart from a checkpoint replays it
exactly.  Each host materializes only its shard of the global batch.  A
JAX process is a host that sees all of its devices; a torch rank drives
one device, and the ranks of one host share its shard: ``process_count()``
/ ``process_index()`` count hosts, ``LOCAL_WORLD_SIZE`` ranks a host (as
``torchrun`` and ``launch.mesh.spawn`` set it; one rank a host where it
is unset), over the ``torch.distributed`` world when a process group is
initialised, and 1 / 0 otherwise.  So a mesh of several ranks on one host
sees the reference's single-host global batch.  Batches stay numpy: the
training step moves them to the device.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig, ShapeCell


def _ranks_per_host() -> int:
    return max(int(os.environ.get("LOCAL_WORLD_SIZE", "1")), 1)


def process_count() -> int:
    """Hosts in the world (``jax.process_count()``)."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return max(dist.get_world_size() // _ranks_per_host(), 1)


def process_index() -> int:
    """This rank's host (``jax.process_index()``)."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_rank() // _ranks_per_host()


@dataclass
class DataConfig:
    seed: int = 0
    vocab: int = 32000
    global_batch: int = 8
    seq_len: int = 128
    prefetch: int = 2


def _host_slice(global_batch: int) -> tuple[int, int]:
    n = process_count()
    idx = process_index()
    per = global_batch // n
    return idx * per, per


def make_batch(cfg: ArchConfig, cell: ShapeCell, dcfg: DataConfig, step: int) -> dict:
    """Deterministic synthetic batch for ``step`` (host-local shard)."""
    start, per = _host_slice(dcfg.global_batch)
    rng = np.random.default_rng((dcfg.seed, step, process_index()))
    s = dcfg.seq_len
    batch: dict = {}
    if cfg.family == "vlm":
        toks = max(s - cfg.n_patches, 1)
        batch["tokens"] = rng.integers(0, cfg.vocab, (per, toks), dtype=np.int32)
        batch["patches"] = rng.normal(size=(per, cfg.n_patches, cfg.d_model)).astype(np.float32)
        batch["labels"] = rng.integers(0, cfg.vocab, (per, toks), dtype=np.int32)
    elif cfg.family == "encdec":
        frames = min(cfg.n_frames, max(s // 4, 16))
        batch["frames"] = rng.normal(size=(per, frames, cfg.d_model)).astype(np.float32)
        batch["tokens"] = rng.integers(0, cfg.vocab, (per, s), dtype=np.int32)
        batch["labels"] = rng.integers(0, cfg.vocab, (per, s), dtype=np.int32)
    elif cfg.family == "encoder" and not cfg.vocab:
        key = "patches" if cfg.n_patches else "frames"
        n = cfg.n_patches or cfg.n_frames
        batch[key] = rng.normal(size=(per, n, cfg.d_model)).astype(np.float32)
        batch["targets"] = rng.normal(size=(per, n, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (per, s), dtype=np.int32)
        batch["labels"] = rng.integers(0, cfg.vocab, (per, s), dtype=np.int32)
    return batch


class PrefetchIterator:
    """Background-thread prefetch of ``make_batch`` (host side)."""

    def __init__(self, cfg, cell, dcfg: DataConfig, start_step: int = 0):
        self.cfg, self.cell, self.dcfg = cfg, cell, dcfg
        self.step = start_step
        self.q: queue.Queue = queue.Queue(maxsize=dcfg.prefetch)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = make_batch(self.cfg, self.cell, self.dcfg, step)
            try:
                self.q.put((step, batch), timeout=1.0)
                step += 1
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        step, batch = self.q.get()
        return step, batch

    def close(self):
        self._stop.set()
