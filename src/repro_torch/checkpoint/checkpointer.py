"""Atomic, async-capable checkpointing in the JAX package's on-disk format.

Layout:  <dir>/step_<N>/
           manifest.json           (leaf shapes and dtypes, step)
           host<K>.npz             (this process's leaves)
         <dir>/step_<N>.tmp...     (staging; atomic rename on commit)
         <dir>/LATEST              (pointer file, written last)

Files load in either package.  Leaves are keyed as the reference keys them
(``jax.tree_util`` paths joined by ``//``: dict keys in sorted order,
sequence indices, NamedTuple field names), in the reference's layout:
the port's per-layer lists (``layers``, ``enc_layers``, ``dec_layers``)
are stacked to the leading layer axis on save
(``convert.to_jax_layout``) and unstacked into lists on restore.
bfloat16 leaves are written as the reference's files hold them (2-byte
void, manifest dtype ``bfloat16``), through 16-bit views, and restore as
``torch.bfloat16`` bit for bit: the manifest's dtype is read.

Fault-tolerance contract:
 * a crash mid-save never corrupts the previous checkpoint (staging dir +
   atomic rename + LATEST pointer written last);
 * restore() places each leaf on the device of the matching leaf of the
   tree it is given, or, given ``shardings``, on their meshes
   (``runtime.sharding.device_put``: every rank of the meshes calls it),
   so a state saved on one mesh restores onto a re-meshed one
   (``runtime.elastic.remesh``);
 * save_async() copies every leaf to host memory before it returns (the
   training step updates params in place, so the copy cannot wait), and
   writes the files in a background thread (``wait()`` joins it before
   the next save).

Sharded state: with a process group up, every rank of the default group
calls ``save`` / ``save_async``.  The DTensor leaves are gathered whole
one at a time (collective, before the call returns): the writer copies
each to the host at once, and every rank frees it before the next, so a
rank holds at most one whole leaf on its device beside its shards.  One
rank a host writes the files: its local rank 0 (the host
``data.pipeline.process_index`` counts), so they are the bytes a single
process writes from the gathered tree.  No rank reads ``LATEST`` or
``step_<N>`` before the writer has committed them: ``save`` ends with a
barrier of the default group, and after ``save_async`` so does
``wait()``, once it has joined the writer.  Without ``shardings``, a
DTensor leaf of the tree given to ``restore`` is matched by its global
shape and its value comes back as a plain tensor on its device.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.convert import is_layer_list, to_jax_layout
from repro_torch.data.pipeline import _ranks_per_host, process_index
from repro_torch.runtime.sharding import device_put

_SEP = "//"
_BF16 = "bfloat16"


class _Layers(list):
    """One leaf of the reference's layout: the per-layer leaves it stacks."""


def _flatten(tree) -> dict:
    """{key: leaf or _Layers} of ``tree`` in the reference's layout and order."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for name in node._fields:
                walk(getattr(node, name), path + (name,))
        elif isinstance(node, (list, tuple)) and not isinstance(node, _Layers):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out[_SEP.join(path)] = node

    walk(to_jax_layout(tree, stack=_Layers), ())
    return out


def _rebuild(like, values: dict, path=(), layer=None):
    """``like``'s structure (the port's layout) with its leaves from
    ``values`` (keyed as :func:`_flatten` keys them)."""
    if isinstance(like, dict):
        return {k: ([_rebuild(lp, values, path + (str(k),), i) for i, lp in enumerate(v)]
                    if is_layer_list(k, v) else _rebuild(v, values, path + (str(k),), layer))
                for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, n), values, path + (n,), layer)
                            for n in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, values, path + (str(i),), layer)
                          for i, v in enumerate(like))
    value = values[_SEP.join(path)]
    return value if layer is None else value[layer]


def _host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of ``leaf`` (taken now) and its manifest dtype."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.array(leaf, copy=True)
        return arr, str(arr.dtype)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")), _BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _whole(leaf):
    """``leaf`` whole: a DTensor's all-gather (collective), else ``leaf``."""
    from torch.distributed.tensor import DTensor

    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


def _host_flat(tree, write: bool = True) -> tuple[dict, dict] | None:
    """Host arrays and manifest dtypes of ``tree``, taken now, each DTensor
    leaf gathered and dropped before the next (collective: every rank
    gathers every leaf in the same order); None on a rank that does not
    ``write``."""
    arrays, dtypes = {}, {}
    for key, leaf in _flatten(tree).items():
        parts = []
        for t in leaf if isinstance(leaf, _Layers) else (leaf,):
            whole = _whole(t)
            if write:
                parts.append(_host(whole))
            del whole
        if write:
            arrays[key] = np.stack([a for a, _ in parts]) if isinstance(leaf, _Layers) \
                else parts[0][0]
            dtypes[key] = parts[0][1]
    return (arrays, dtypes) if write else None


def _tensor(arr: np.ndarray, dtype: str, like) -> torch.Tensor:
    arr = np.require(arr, requirements="C")  # keeps 0-d leaves 0-d
    if dtype == _BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(like.device) if isinstance(like, torch.Tensor) else t


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


class Checkpointer:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._in_group = False  # the last save ran with a group up

    # -- save -----------------------------------------------------------

    def _snapshot(self, tree) -> tuple[dict, dict] | None:
        """Host arrays and manifest dtypes of ``tree``, taken now; None on a
        rank that does not write.  Collective when a group is up."""
        self._in_group = _group_up()
        return _host_flat(tree, not self._in_group
                          or dist.get_rank() % _ranks_per_host() == 0)

    def save(self, step: int, tree) -> str:
        """Write ``step`` and return its committed directory (on every rank
        of the default group, when one is up)."""
        self.wait()
        snap = self._snapshot(tree)
        final = self._write(step, *snap) if snap is not None \
            else os.path.join(self.dir, f"step_{step}")
        self.wait()  # the group's barrier: the writer has committed
        return final

    def save_async(self, step: int, tree) -> None:
        """Snapshot to host memory now; write in the background."""
        self.wait()
        snap = self._snapshot(tree)  # D2H copy now, synchronous
        if snap is not None:
            self._thread = threading.Thread(target=self._write, args=(step, *snap), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the writer; after a save made with a group up, a barrier of
        the default group (every rank calls ``wait``)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._in_group:
            self._in_group = False
            dist.barrier()

    def _write(self, step: int, host_flat: dict, dtypes: dict) -> str:
        final = os.path.join(self.dir, f"step_{step}")
        tmp = final + f".tmp{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        manifest = {
            "step": step,
            "leaves": {
                k: {"shape": list(v.shape), "dtype": dtypes[k]} for k, v in host_flat.items()
            },
        }
        np.savez(os.path.join(tmp, f"host{process_index()}.npz"), **host_flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        with open(os.path.join(self.dir, "LATEST.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(self.dir, "LATEST.tmp"), os.path.join(self.dir, "LATEST"))
        return final

    # -- restore ----------------------------------------------------------

    def latest_step(self) -> int | None:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            step = int(f.read().strip())
        # the pointer may outlive a deleted dir; verify
        if not os.path.exists(os.path.join(self.dir, f"step_{step}", "manifest.json")):
            return None
        return step

    def restore(self, step: int, like_tree, shardings=None):
        """Load ``step`` shaped like ``like_tree`` (the port's layout), in the
        manifest's dtype, each leaf on the device of ``like_tree``'s leaf;
        with ``shardings`` (a ``NamedSharding`` tree, as
        ``param_shardings`` / ``opt_state_shardings`` give), placed on
        their meshes by ``device_put`` (collective)."""
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        out = {}
        with np.load(os.path.join(path, f"host{process_index()}.npz")) as data:
            for key, like in _flatten(like_tree).items():
                if key not in manifest["leaves"]:
                    raise KeyError(f"checkpoint missing leaf {key}")
                arr = data[key]
                dtype = manifest["leaves"][key]["dtype"]
                if isinstance(like, _Layers):
                    want = [len(like), *like[0].shape]
                    if list(arr.shape) != want:
                        raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {want}")
                    out[key] = [_tensor(a, dtype, t) for a, t in zip(arr, like)]
                else:
                    if list(arr.shape) != list(np.shape(like)):
                        raise ValueError(
                            f"shape mismatch for {key}: {arr.shape} vs {np.shape(like)}")
                    out[key] = _tensor(arr, dtype, like)
        tree = _rebuild(like_tree, out)
        return tree if shardings is None else device_put(tree, shardings)

    def restore_latest(self, like_tree, shardings=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like_tree, shardings)
