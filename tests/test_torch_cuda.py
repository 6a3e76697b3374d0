"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (a CUDA kernel has no CPU mode): it is
marked ``cuda`` and skips on a host without one.  Run on a machine with an
H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.quant_linear import ACT_GELU, ACT_IDENTITY, ACT_RELU
from repro_torch.deploy import api
from repro_torch.kernels.igelu import igelu, igelu_ref
from repro_torch.kernels.int8_gemm import int8_gemm
from repro_torch.kernels.int8_gemm.ops import gemm_grid
from repro_torch.kernels.ita_attention import ita_attention, ita_decode
from repro_torch.kernels.ita_attention.ops import attn_grid
from repro_torch.kernels.itamax import itamax, itamax_ref
from repro_torch.kernels.itamax.ops import itamax_grid
from repro_torch.quant.qparams import imatmul

GEMM_KW = dict(s_in=0.02, s_w=0.005, s_out=0.05, s_preact=0.04)


def _chip_smoke():
    """chip_smoke.py at the repository root (its path shapes)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: (M, K, N, tile the wrapper picks): M, N and K one past and one short of
#: each block tile and of the 64-deep K slice, K < 32, K and N whose rows
#: are not 16-byte aligned, N < 8
GEMM_EDGES = [
    (1537, 65, 703, (128, 64)), (1535, 63, 705, (128, 64)),
    (769, 127, 641, (64, 64)), (767, 129, 705, (64, 64)),
    (1023, 129, 289, (64, 32)), (1025, 31, 287, (64, 32)),
    (1025, 31, 127, (32, 32)), (1055, 33, 97, (32, 32)),
    (65, 200, 33, (16, 32)), (15, 5, 31, (16, 32)), (17, 16, 5, (16, 32)),
    (100, 200, 7, (16, 32)),
]
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


def _gemm_check(device, m, k, n, act, seed, bias_lo=-1000, bias_hi=1000):
    gen = torch.Generator().manual_seed(seed)
    x, w = _ri8(gen, (m, k)), _ri8(gen, (k, n), lo=-127)
    bias = torch.randint(bias_lo, bias_hi, (n,), generator=gen, dtype=torch.int32)
    kw = dict(GEMM_KW, act=act)
    before = int8_gemm.launches
    got = int8_gemm(x.to(device), w.to(device), bias.to(device), **kw)
    torch.cuda.synchronize()
    assert int8_gemm.launches == before + 1
    assert torch.equal(got.cpu(), int8_gemm(x, w, bias, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,tile", GEMM_EDGES)
@pytest.mark.parametrize("act", [ACT_IDENTITY, ACT_GELU])
def test_int8_gemm_cuda_tile_edges(cuda_device, m, k, n, tile, act):
    assert gemm_grid(m, n)[:2] == tile
    _gemm_check(cuda_device, m, k, n, act, seed=m * 7 + k * 3 + n)


@pytest.mark.cuda
def test_int8_gemm_cuda_every_path_shape(cuda_device):
    for label, m, k, n, act in _chip_smoke().gemm_cases():
        _gemm_check(cuda_device, m, k, n, act, seed=m + k + n)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 8192), (8192, 2048)])
def test_int8_gemm_cuda_olmo_shapes(cuda_device, k, n):
    """OLMo-1B's prefill GEMMs at batch 8 x 128 tokens (K and N up to 8192)."""
    _gemm_check(cuda_device, 1024, k, n, ACT_IDENTITY, seed=k + n)


@pytest.mark.cuda
def test_int8_gemm_cuda_int32_sum_wraps(cuda_device):
    """A bias next to 2^31 makes x @ w + bias wrap; the kernel's int32
    accumulator and epilogue wrap as the reference's do."""
    _gemm_check(cuda_device, 256, 512, 128, ACT_IDENTITY, seed=31,
                bias_lo=(1 << 31) - 4000, bias_hi=(1 << 31) - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,kv_valid,causal,block_k", [
    (2, 4, 4, 1, 256, 64, None, False, 128),      # Sq 1 (a decode row)
    (2, 4, 2, 3, 256, 64, 200, False, 128),       # Sq 3, GQA
    (2, 4, 4, 17, 256, 64, None, True, 128),      # Sq 17, causal with Sq < Sk
    (1, 2, 2, 1024, 1024, 64, 900, False, 512),   # kv_valid inside the last 512-key block
    (2, 3, 3, 256, 256, 32, None, False, 128),    # D 32
    (2, 3, 3, 256, 256, 128, 241, False, 128),    # D 128: two output-column blocks
    (1, 2, 2, 100, 256, 64, None, True, 128),     # causal with Sq < Sk, ragged rows
    (1, 2, 1, 60, 300, 36, 250, True, 100),       # D and block_k not multiples of 16
    (1, 2, 2, 40, 160, 192, None, False, 32),     # D 192: Q k-steps past the registers
    # enough 16-row tiles for one warp per tile (the cases above split a
    # tile's keys between two warps)
    (8, 8, 8, 512, 512, 64, 500, True, 128),
    (8, 8, 8, 256, 256, 128, None, False, 64),
    (8, 8, 4, 300, 300, 36, 250, True, 100),
])
def test_ita_attention_cuda_edges(cuda_device, b, h, hkv, sq, sk, d, kv_valid, causal, block_k):
    split = attn_grid(b * h, sq, d, min(block_k, sk))[1]
    assert split == (1 if b * h * -(-sq // 16) * -(-d // 64) >= 8 * 132 else 2)
    gen = torch.Generator().manual_seed(sq * 13 + sk + d)
    q, k, v = _ri8(gen, (b, h, sq, d)), _ri8(gen, (b, hkv, sk, d)), _ri8(gen, (b, hkv, sk, d))
    kw = dict(ATTN_KW, causal=causal, block_k=block_k, kv_valid=kv_valid)
    before = ita_attention.launches
    got = ita_attention(q.to(cuda_device), k.to(cuda_device), v.to(cuda_device), **kw)
    torch.cuda.synchronize()
    assert ita_attention.launches == before + 1
    assert torch.equal(got.cpu(), ita_attention(q, k, v, **kw))


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8 * 197, 768), (3, 7, 241), (5,)])
def test_igelu_cuda_vs_plain(cuda_device, shape):
    gen = torch.Generator().manual_seed(sum(shape))
    x = _ri8(gen, shape)
    kw = dict(in_scale=0.04, out_scale=0.05)
    before = igelu.launches
    got = igelu(x.to(cuda_device), **kw)
    torch.cuda.synchronize()
    assert igelu.launches == before + 1
    assert torch.equal(got.cpu(), igelu_ref(x, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("r,n", [(8 * 4 * 128, 128), (8 * 6 * 241, 241), (1001, 77), (3, 4096)])
def test_itamax_cuda_vs_plain(cuda_device, r, n):
    gen = torch.Generator().manual_seed(r + n)
    x = _ri8(gen, (r, n))
    x[0], x[1], x[2] = 5, -128, -128
    x[1, n // 2] = 127
    before = itamax.launches
    got = itamax(x.to(cuda_device))
    torch.cuda.synchronize()
    assert itamax.launches == before + 1
    assert torch.equal(got.cpu(), itamax_ref(x))


@pytest.mark.cuda
def test_itamax_cuda_refuses_a_mask(cuda_device):
    x = torch.zeros((4, 8), dtype=torch.int8, device=cuda_device)
    with pytest.raises(NotImplementedError, match="mask"):
        itamax(x, mask=torch.ones((4, 8), dtype=torch.bool, device=cuda_device))
    with pytest.raises(TypeError):
        itamax(x.to(torch.int32))


#: row lengths of the itamax edge cases: one to three bytes, one short of,
#: at and one past a 16-byte chunk, odd rows, the three encoders' rows, one
#: past a warp's 32 chunks, the longest row a warp holds, the longest row
ITAMAX_EDGE_N = [1, 2, 3, 15, 16, 17, 77, 128, 241, 512, 513, 4096, 1 << 15]
#: R of the three encoders' w8a8 softmax at batch 8, by row length
ITAMAX_PATH_R = {128: 8 * 4 * 128, 241: 8 * 6 * 241, 512: 8 * 6 * 512}


def _itamax_edge_rows(n):
    """1, 7, a count of several blocks that is not a multiple of the rows
    per block (when that is more than one), and the path's R."""
    ragged = next(r for r in range(2 * itamax_grid(1, n)[0] + 5, 1 << 20, 7)
                  if r % itamax_grid(r, n)[0] or itamax_grid(r, n)[0] == 1)
    rows = [1, 7, ragged] + ([ITAMAX_PATH_R[n]] if n in ITAMAX_PATH_R else [])
    return list(dict.fromkeys(rows))


#: (R, n) past one wave of blocks: several staging steps a block, the last
#: block's last step short
ITAMAX_MULTI_STEP = [(200003, 77), (100001, 241)]


@pytest.mark.cuda
@pytest.mark.parametrize("r,n", [(r, n) for n in ITAMAX_EDGE_N for r in _itamax_edge_rows(n)]
                         + ITAMAX_MULTI_STEP)
def test_itamax_cuda_edges(cuda_device, r, n):
    """Every staging and segment case of the kernel: rows that start
    anywhere in a chunk, rows of 1..L lanes and of a whole block, a last
    block and a last step that are short.  Row 0 has t = 255 (-128 beside
    127), row 1 is all equal, row 2 all -128."""
    gen = torch.Generator().manual_seed(7 * r + n)
    x = _ri8(gen, (r, n))
    x[0] = -128
    x[0, (n - 1) // 2] = 127
    if r > 2:
        x[1], x[2] = 31, -128
    before = itamax.launches
    got = itamax(x.to(cuda_device))
    torch.cuda.synchronize()
    assert itamax.launches == before + 1
    assert torch.equal(got.cpu(), itamax_ref(x))


#: (in_scale, out_scale) of the igelu edge cases: each builds another table
IGELU_SCALES = [(0.04, 0.05), (0.01, 0.003), (0.2, 0.5)]
#: element counts: under, at and past one 16-byte word, every int8 value,
#: the DeiT-Ti-width path, and past the grid's cap (the grid-stride loop wraps)
IGELU_SIZES = [1, 15, 16, 17, 256, 8 * 197 * 768, 2 * 132 * 8 * 256 * 3 * 16 + 7]


@pytest.mark.cuda
@pytest.mark.parametrize("scales", IGELU_SCALES)
@pytest.mark.parametrize("size", IGELU_SIZES)
def test_igelu_cuda_every_value(cuda_device, scales, size):
    x = ((torch.arange(size, dtype=torch.int32) * 97 + size) % 256 - 128).to(torch.int8)
    if size >= 256:
        x[:256] = torch.arange(-128, 128, dtype=torch.int8)
        assert x.unique().numel() == 256
    kw = dict(in_scale=scales[0], out_scale=scales[1])
    before = igelu.launches
    got = igelu(x.to(cuda_device), **kw)
    torch.cuda.synchronize()
    assert igelu.launches == before + 1
    assert torch.equal(got.cpu(), igelu_ref(x, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["int_mm", "float64", "batched", "int32_wraps"])
def test_exact_product_cuda_vs_int32(cuda_device, case):
    gen = torch.Generator().manual_seed(len(case))

    def ri(lo, hi, *shape, dtype=torch.int8):
        return torch.randint(lo, hi, shape, generator=gen, dtype=dtype)

    a, b = {
        "int_mm": (ri(-128, 128, 2, 100, 1536), ri(-127, 128, 1536, 384)),
        "float64": (ri(-128, 128, 100, 200), ri(-127, 128, 200, 30)),
        "batched": (ri(-128, 128, 2, 3, 97, 64), ri(-128, 128, 2, 3, 64, 97)),
        "int32_wraps": (ri(-(1 << 20), 1 << 20, 40, 16, dtype=torch.int32),
                        ri(-(1 << 20), 1 << 20, 16, 24, dtype=torch.int32)),
    }[case]
    want = torch.matmul(a.long(), b.long()).to(torch.int32)
    got = imatmul(a.to(cuda_device), b.to(cuda_device))
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 16])
def test_exact_product_cuda_small_m(cuda_device, m):
    """Decode-step products (M = batch <= 16) take torch._int_mm through
    zero rows padded to 32, and the tied LM head reads table.T in place."""
    gen = torch.Generator().manual_seed(m)
    a = _ri8(gen, (m, 2048))
    w = _ri8(gen, (2048, 8192), lo=-127)
    table = _ri8(gen, (4096, 2048), lo=-127)
    for b in (w, table.T):
        want = torch.matmul(a.int(), b.int())
        got = imatmul(a.to(cuda_device), b.to(cuda_device) if b is w else
                      table.to(cuda_device).T)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["ita", "w8a8"])
def test_decoder_session_on_the_card(cuda_device, backend):
    """Reduced OLMo: prefill and 3 decode steps on the card equal the CPU
    session (logits and KV caches); int8_gemm runs the ``ita`` prefill's
    accelerated GEMMs and no kernel runs in a decode step."""
    cfg = reduced(get_config("olmo-1b"))
    model = api.compile(cfg, backend=backend, seq_len=16, max_len=20, use_cache=False)
    _, qp = model.bind(seed=0)
    card, cpu = model.session(2, qp=qp), model.session(2, qp=qp, device="cpu")
    assert card.device.type == "cuda"
    gemms = sum(n.kind == "gemm" and n.engine == "ita"
                for n in model.artifact.prefill.flat_nodes()) if backend == "ita" else 0
    kernels = (itamax, int8_gemm, ita_attention, igelu)
    prompts = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(5),
                            dtype=torch.int32)
    counts = {f: f.launches for f in kernels}
    got, want = card.prefill(prompts), cpu.prefill(prompts)
    torch.cuda.synchronize()
    assert int8_gemm.launches - counts[int8_gemm] == gemms
    for step in range(4):
        assert torch.equal(got.cpu(), want)
        for part in ("k", "v"):
            assert torch.equal(card.kv_cache[part].cpu(), cpu.kv_cache[part])
        if step == 3:
            break
        tok = torch.argmax(want[:, -1], dim=-1).to(torch.int32)
        counts = {f: f.launches for f in kernels}
        got, want = card.decode(tok), cpu.decode(tok)
        torch.cuda.synchronize()
        assert all(f.launches == n for f, n in counts.items())


@pytest.mark.cuda
def test_w8a8_session_forward_on_the_card(cuda_device):
    """The default backend runs on the card: its products are exact integer
    products and its softmax the itamax kernel, once per layer."""
    cfg = reduced(get_config("mobilebert"))
    model = api.compile(cfg, use_cache=False)
    assert model.backend.value == "w8a8"
    tokens = torch.randint(0, cfg.vocab, (2, 128), generator=torch.Generator().manual_seed(3),
                           dtype=torch.int32)
    session = model.session(2)
    assert session.device.type == "cuda"
    counts = {f: f.launches for f in (itamax, int8_gemm, ita_attention, igelu)}
    got = session.forward(tokens)
    torch.cuda.synchronize()
    assert itamax.launches - counts[itamax] == cfg.n_layers
    assert all(f.launches == n for f, n in counts.items() if f is not itamax)
    assert torch.equal(got.cpu(), model.session(2, device="cpu").forward(tokens))
