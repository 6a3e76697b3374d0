"""The port's kernel modules: plain versions against the JAX oracles and the
interpret-mode Pallas kernels, the CUDA kernels against the plain versions.

On the CPU a wrapper runs its kernel's plain version (the tensor lies on
the CPU); that version must equal the JAX package's ``*_ref`` oracle and
its Pallas kernel run in interpret mode, bit for bit.  The CUDA kernels
themselves are held against the plain versions in ``test_torch_cuda.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant_linear import ACT_GELU, ACT_IDENTITY, ACT_RELU
from repro.kernels import int8_gemm as j_gemm
from repro.kernels import int8_gemm_ref as j_gemm_ref
from repro.kernels import ita_attention as j_attn
from repro.kernels import ita_attention_ref as j_attn_ref
from repro.kernels.ita_attention.ops import ita_decode as j_decode
from repro_torch.kernels.int8_gemm import int8_gemm, int8_gemm_ref
from repro_torch.kernels.ita_attention import ita_attention, ita_attention_ref, ita_decode

SRC = Path(__file__).resolve().parents[1] / "src"


def _ri8(rng, shape, lo=-128):
    return rng.integers(lo, 128, size=shape).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# int8_gemm
# ---------------------------------------------------------------------------

GEMM_KW = dict(s_in=0.02, s_w=0.005, s_out=0.05, s_preact=0.04)


@pytest.mark.parametrize("act", [ACT_IDENTITY, ACT_RELU, ACT_GELU])
def test_int8_gemm_plain_vs_jax_oracle_and_pallas(act):
    rng = np.random.default_rng(10 + act)
    x, w = _ri8(rng, (128, 256)), _ri8(rng, (256, 128), lo=-127)
    bias = rng.integers(-1000, 1000, size=(128,)).astype(np.int32)
    kw = dict(GEMM_KW, act=act)
    got = int8_gemm(_t(x), _t(w), _t(bias), **kw).numpy()
    assert np.array_equal(got, np.asarray(j_gemm_ref(x, w, bias, **kw)))
    assert np.array_equal(int8_gemm_ref(_t(x), _t(w), _t(bias), **kw).numpy(), got)
    pallas = j_gemm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                    block_m=128, block_n=128, block_k=128, interpret=True, **kw)
    assert np.array_equal(got, np.asarray(pallas))


def test_int8_gemm_per_channel_ragged_rows():
    rng = np.random.default_rng(11)
    x, w = _ri8(rng, (2, 50, 128)), _ri8(rng, (128, 64), lo=-127)
    s_w = rng.uniform(0.001, 0.01, size=(64,))
    kw = dict(s_in=0.02, s_w=s_w, s_out=0.05)
    got = int8_gemm(_t(x), _t(w), None, **kw)
    assert got.shape == (2, 50, 64) and got.dtype == torch.int8
    assert np.array_equal(got.numpy(), np.asarray(j_gemm_ref(x, w, None, **kw)))
    pallas = j_gemm(jnp.asarray(x), jnp.asarray(w), None, block_m=100, block_n=64,
                    block_k=128, interpret=True, **kw)
    assert np.array_equal(got.numpy(), np.asarray(pallas))


# ---------------------------------------------------------------------------
# ita_attention
# ---------------------------------------------------------------------------

ATTN_KW = dict(s_q=0.02, s_k=0.02, s_v=0.02, s_out=0.02)


@pytest.mark.parametrize("hkv,causal", [(2, False), (1, True)])
def test_ita_attention_plain_vs_jax_oracle_and_pallas(hkv, causal):
    """Sk = 256 in two 128-row KV blocks (renormalization across blocks);
    GQA with group 2 and multi-query causal."""
    rng = np.random.default_rng(20 + hkv)
    q, k, v = _ri8(rng, (1, 2, 128, 64)), _ri8(rng, (1, hkv, 256, 64)), _ri8(rng, (1, hkv, 256, 64))
    kw = dict(ATTN_KW, causal=causal, block_k=128)
    got = ita_attention(_t(q), _t(k), _t(v), **kw).numpy()
    assert np.array_equal(got, np.asarray(j_attn_ref(q, k, v, **kw)))
    pallas = j_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
                    interpret=True, **kw)
    assert np.array_equal(got, np.asarray(pallas))
    assert np.array_equal(ita_attention_ref(_t(q), _t(k), _t(v), **kw).numpy(), got)


def test_ita_attention_kv_valid_padding():
    """A 100-token sequence padded to 128 with the KV tail masked, as the
    runners do, against the interpret-mode kernel."""
    rng = np.random.default_rng(30)
    q, k, v = (np.pad(_ri8(rng, (1, 2, 100, 64)), ((0, 0), (0, 0), (0, 28), (0, 0)))
               for _ in range(3))
    kw = dict(ATTN_KW, block_k=128, kv_valid=100)
    got = ita_attention(_t(q), _t(k), _t(v), **kw).numpy()
    pallas = j_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
                    interpret=True, **kw)
    assert np.array_equal(got, np.asarray(pallas))


def test_ita_decode_plain_vs_pallas():
    rng = np.random.default_rng(40)
    q, kc, vc = _ri8(rng, (2, 4, 1, 64)), _ri8(rng, (2, 2, 128, 64)), _ri8(rng, (2, 2, 128, 64))
    got = ita_decode(_t(q), _t(kc), _t(vc), 90, block_k=64, **ATTN_KW).numpy()
    want = j_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), 90, block_k=64,
                    interpret=True, **ATTN_KW)
    assert np.array_equal(got, np.asarray(want))


def test_kernel_modules_import_without_nvcc():
    """The build is lazy: with no nvcc and no CUDA_HOME the kernel modules
    import and their wrappers run the plain versions on CPU tensors."""
    code = (
        "import torch\n"
        "from repro_torch.kernels.int8_gemm import int8_gemm\n"
        "from repro_torch.kernels.ita_attention import ita_attention\n"
        "x = torch.ones((4, 8), dtype=torch.int8)\n"
        "y = int8_gemm(x, x.T.contiguous(), None, s_in=0.1, s_w=0.1, s_out=0.1)\n"
        "q = torch.ones((1, 1, 8, 8), dtype=torch.int8)\n"
        "a = ita_attention(q, q, q, s_q=0.1, s_k=0.1, s_v=0.1, s_out=0.1)\n"
        "assert int8_gemm.launches == 0 and ita_attention.launches == 0\n"
        "print(tuple(y.shape), tuple(a.shape))\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env.update(PATH="/nonexistent", PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "(4, 4) (1, 1, 8, 8)"

