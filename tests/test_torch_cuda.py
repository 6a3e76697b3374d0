"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (a CUDA kernel has no CPU mode): it is
marked ``cuda`` and skips on a host without one.  Run on a machine with an
H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
"""

import pytest
import torch

from repro_torch.core.quant_linear import ACT_GELU, ACT_IDENTITY, ACT_RELU
from repro_torch.kernels.int8_gemm import int8_gemm
from repro_torch.kernels.ita_attention import ita_attention, ita_decode

GEMM_KW = dict(s_in=0.02, s_w=0.005, s_out=0.05, s_preact=0.04)
ATTN_KW = dict(s_q=0.02, s_k=0.02, s_v=0.02, s_out=0.02)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _ri8(gen, shape, lo=-128):
    return torch.randint(lo, 128, shape, generator=gen, dtype=torch.int8)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,act", [
    (1024, 128, 512, ACT_GELU), (1000, 200, 300, ACT_RELU), (7, 5, 3, ACT_IDENTITY),
])
def test_int8_gemm_cuda_vs_plain(cuda_device, m, k, n, act):
    gen = torch.Generator().manual_seed(m + n)
    x, w = _ri8(gen, (m, k)), _ri8(gen, (k, n), lo=-127)
    bias = torch.randint(-1000, 1000, (n,), generator=gen, dtype=torch.int32)
    kw = dict(GEMM_KW, act=act)
    before = int8_gemm.launches
    got = int8_gemm(x.to(cuda_device), w.to(cuda_device), bias.to(cuda_device), **kw)
    torch.cuda.synchronize()
    assert int8_gemm.launches == before + 1
    assert torch.equal(got.cpu(), int8_gemm(x, w, bias, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("hkv,s,kv_valid,causal,block_k", [
    (4, 512, None, False, 128), (2, 256, 241, True, 128), (1, 512, 300, False, 512),
])
def test_ita_attention_cuda_vs_plain(cuda_device, hkv, s, kv_valid, causal, block_k):
    gen = torch.Generator().manual_seed(s + hkv)
    q, k, v = (_ri8(gen, (2, h, s, 64)) for h in (4, hkv, hkv))
    kw = dict(ATTN_KW, causal=causal, block_k=block_k, kv_valid=kv_valid)
    got = ita_attention(q.to(cuda_device), k.to(cuda_device), v.to(cuda_device), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ita_attention(q, k, v, **kw))


@pytest.mark.cuda
def test_ita_decode_cuda_vs_plain(cuda_device):
    gen = torch.Generator().manual_seed(5)
    q, kc, vc = _ri8(gen, (2, 8, 1, 64)), _ri8(gen, (2, 2, 256, 64)), _ri8(gen, (2, 2, 256, 64))
    dev = [t.to(cuda_device) for t in (q, kc, vc)]
    got = ita_decode(*dev, 200, block_k=64, **ATTN_KW)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ita_decode(q, kc, vc, 200, block_k=64, **ATTN_KW))


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros((4, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        int8_gemm(x, x.T, None, s_in=0.1, s_w=0.1, s_out=0.1)
    q = torch.zeros((1, 1, 8, 6), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="multiples of 4"):
        ita_attention(q, q, q, **ATTN_KW)
