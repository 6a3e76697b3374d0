"""Build-on-first-use of the CUDA kernels and their ctypes bindings.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with
a plain C interface (no PyTorch headers: seconds, not minutes), cached in
``build/repro_torch/`` at the repository root (or ``$REPRO_TORCH_BUILD``)
under a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads at once.  Nothing here runs at import time: the
package imports on a host with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: every kernel library: ``csrc/<name>.cu`` -> ``<name>-<hash>.so``
KERNELS = ("int8_gemm", "ita_attention", "igelu", "itamax")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: streaming multiprocessors of the H100 SXM the launch shapes are chosen
#: for (one block per SM is one wave)
NUM_SMS = 132

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    """nvcc of the CUDA toolkit PyTorch finds ($CUDA_HOME, PATH, or the
    toolkit's standard prefix)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start nvcc for ``name`` unless its library is built already."""
    out = _lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out.parent, suffix=".so.tmp")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic publish: a reader never sees a torn library
    (out.parent / f"{out.stem}.log").write_text(log)


def build(*names: str) -> None:
    """Compile the named kernels, one ``nvcc`` process each, all at once."""
    with _lock:
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build(name)
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return _libs[name]


def as_kernel_arg(t):
    """Contiguous, 16-byte-aligned ``t`` (the kernels read whole words)."""
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def stream_of(t) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def compile_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) for
    the library built from the current sources, or "" if it came cached
    without one."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
