"""Phase clocks of the ita_attention kernel's blocks, on the card.

    PYTHONPATH=src python -m repro_torch.launch.trace_attention

Builds a copy of ``csrc/ita_attention.cu`` with ``clock64()`` marks at the
phase boundaries of each block (thread 0 of blocks with blockIdx.y = 0),
launches it at the three encoders' attention shapes (batch 8, block_k
128) with the wrapper's launch shape (three warm launches, then the marked
one), and prints the median cycles of each phase over the blocks:

- copy: the Q tile's and the first ring slots' ``cp.async`` copies started;
- tables: the exponential and renormalization tables stored;
- wait: the first sub-tile's wait and barrier;
- unit 0, 1, ...: each K or V sub-tile's work, up to the next one's wait;
- finalize: the floor division, the output requant and the stores.

The production kernel carries no marks; only the copy built here does.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import numpy as np
import torch

from repro_torch.core.attention import MhaQParams
from repro_torch.kernels import _build
from repro_torch.kernels.ita_attention import ita_attention_ref, ops

MARKS = 16
CASES = [("mobilebert", 32, 128, None), ("whisper-tiny-encoder", 48, 512, None),
         ("dinov2-small", 48, 256, 241)]

_PRELUDE = f"""
__device__ unsigned long long g_marks[8192][{MARKS}];
#define MARK(i) do {{ if (threadIdx.x == 0 && blockIdx.x < 8192 && blockIdx.y == 0) \\
    g_marks[blockIdx.x][i] = clock64(); }} while (0)
"""

# (anchor in the kernel source, text put before it)
_MARKS = [
    ("  const bool vec = D % 16 == 0;\n", None),  # mark 0 after this line
    ("  // the tables, while the copies", "  MARK(1);\n"),
    ("  // per-row state of rows g", "  MARK(2);\n"),
    ("    // sub-tile u (and Q) landed", "    if (u < 8) MARK(3 + u);\n"),
    ("  mma::cp_async_wait<0>();\n\n  // finalize", "  MARK(12);\n"),
]


def _traced_source() -> str:
    src = (_build.CSRC / "ita_attention.cu").read_text()
    src = src.replace("namespace {\n", "namespace {\n" + _PRELUDE, 1)
    for anchor, text in _MARKS:
        if anchor not in src:
            raise RuntimeError(f"trace anchor not found in ita_attention.cu: {anchor!r}")
        src = (src.replace(anchor, anchor + "  MARK(0);\n", 1) if text is None
               else src.replace(anchor, text + anchor, 1))
    src = src.replace("    __syncthreads();\n    if (u == 0) {",
                      "    __syncthreads();\n    if (u == 0) MARK(11);\n    if (u == 0) {", 1)
    end = src.index("template <int KSPLIT>\nint launch(")
    end = src.rindex("}", 0, end)
    src = src[:end] + "  MARK(13);\n" + src[end:]
    return src + (f"\nextern \"C\" int ita_marks(void* dst, int clear) {{\n"
                  f"  static unsigned long long zero[8192][{MARKS}];\n"
                  "  return clear ? (int)cudaMemcpyToSymbol(g_marks, zero, sizeof(zero))\n"
                  "               : (int)cudaMemcpyFromSymbol(dst, g_marks, sizeof(g_marks));\n}\n")


def _build_traced():
    out = _build.build_dir() / "trace"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "ita_attention_marks.cu", out / "ita_attention_marks.so"
    cu.write_text(_traced_source())
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
                    str(cu)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.ita_attention_launch.restype = ctypes.c_int
    lib.ita_attention_launch.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 17
                                         + [ctypes.c_void_p])
    lib.ita_marks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_attention needs a CUDA device")
    lib = _build_traced()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    for label, bh, s, kv_valid in CASES:
        q, k, v = (torch.randint(-128, 128, (bh, s, 64), generator=gen, dtype=torch.int8)
                   for _ in range(3))
        p = MhaQParams.make_flash(0.05, 0.05, 0.05, 0.05, 64)
        qd, kd, vd = (t.to(dev) for t in (q, k, v))
        out = torch.empty_like(qd)
        groups, split, slots, gx, gy = ops.attn_grid(bh, s, 64, 128)

        def run():
            rc = lib.ita_attention_launch(
                qd.data_ptr(), kd.data_ptr(), vd.data_ptr(), ops._luts(dev).data_ptr(),
                out.data_ptr(), bh, s, s, 64, 1, int(p.logit_mult), int(p.logit_shift),
                int(p.out_mult), int(p.out_shift), 0, 128, s if kv_valid is None else kv_valid,
                groups, split, slots, gx, gy, torch.cuda.current_stream().cuda_stream)
            _build.check(rc, "ita_attention (marked)")

        for _ in range(3):  # warm: code, tables and operands in the caches
            run()
        torch.cuda.synchronize()
        lib.ita_marks(None, 1)
        run()
        torch.cuda.synchronize()
        want = ita_attention_ref(q[None], k[None], v[None], s_q=0.05, s_k=0.05, s_v=0.05,
                                 s_out=0.05, block_k=128, kv_valid=kv_valid)[0]
        if not torch.equal(out.cpu(), want):
            raise SystemExit(f"{label}: the marked kernel disagrees with the plain version")
        buf = (ctypes.c_ulonglong * (8192 * MARKS))()
        lib.ita_marks(buf, 0)
        m = np.frombuffer(buf, np.uint64).reshape(8192, MARKS)[:min(gx, 8192)].astype(np.int64)
        units = max(i for i in range(8) if (m[:, 3 + i] > 0).any()) + 1
        phases = [("copy", 0, 1), ("tables", 1, 2), ("wait", 3, 11)]
        phases += [(f"unit {u}", 11 if u == 0 else 3 + u, 3 + u + 1) for u in range(units - 1)]
        phases += [(f"unit {units - 1}", 3 + units - 1 if units > 1 else 11, 12),
                   ("finalize", 12, 13)]
        cells = ", ".join(f"{name} {int(np.median(m[:, b] - m[:, a]))}" for name, a, b in phases)
        print(f"{label}: {gx}x{gy} blocks of {32 * groups * split} threads ({split} warps per "
              f"16 rows), {units} units; median cycles: {cells}; block total "
              f"{int(np.median(m[:, 13] - m[:, 0]))} on {torch.cuda.get_device_name(0)}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
