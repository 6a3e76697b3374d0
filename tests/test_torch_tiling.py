"""Launch shapes of the tensor-core kernels, chosen by their wrappers.

``int8_gemm`` and ``ita_attention`` pick their block tile per call from
the problem's shape (``gemm_grid``, ``attn_grid``: pure functions, so the
CPU can check them).  Every output element must belong to exactly one
block, and MobileBERT's shapes must give at least one block per SM of the
H100 (one wave).  The kernels themselves are held against their plain
versions on the card (``test_torch_cuda.py``).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels import _build
from repro_torch.kernels.int8_gemm.ops import GEMM_TILES, gemm_grid
from repro_torch.kernels.ita_attention.ops import SMEM_MAX, attn_grid, attn_smem


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()
PATH_GEMMS = [(m, n) for _, m, _, n, _ in SMOKE.gemm_cases()]
RAGGED_GEMMS = [(m, n) for m in (1, 7, 15, 16, 17, 100, 129, 1000, 1928, 4097)
                for n in (1, 5, 31, 32, 33, 300, 385, 1537)]


def _gemm_cover(m, n):
    bm, bn, gx, gy = gemm_grid(m, n)
    cover = np.zeros((m, n), np.int32)
    for x in range(gx):
        for y in range(gy):
            cover[x * bm:(x + 1) * bm, y * bn:(y + 1) * bn] += 1
    return (bm, bn), cover


@pytest.mark.parametrize("m,n", PATH_GEMMS + RAGGED_GEMMS)
def test_gemm_tiles_cover_every_output_once(m, n):
    tile, cover = _gemm_cover(m, n)
    assert tile in GEMM_TILES
    assert (cover == 1).all()
    bm, bn, gx, gy = gemm_grid(m, n)  # no block lies wholly outside
    assert (gx - 1) * bm < m and (gy - 1) * bn < n


@pytest.mark.parametrize("m,n", [(m, n) for label, m, _, n, _ in SMOKE.gemm_cases()
                                 if label == "mobilebert"])
def test_gemm_tile_fills_a_wave_on_mobilebert(m, n):
    _, _, gx, gy = gemm_grid(m, n)
    assert gx * gy >= _build.NUM_SMS


def test_gemm_tile_prefers_the_largest_that_fills_a_wave():
    assert gemm_grid(4096, 1536)[:2] == GEMM_TILES[0]
    assert gemm_grid(7, 3)[:2] == GEMM_TILES[-1]  # nothing fills a wave: the smallest
    for m, n in PATH_GEMMS:
        bm, bn = gemm_grid(m, n)[:2]
        larger = GEMM_TILES[:GEMM_TILES.index((bm, bn))]
        assert all(-(-m // a) * -(-n // b) < _build.NUM_SMS for a, b in larger)


#: (BH, Sq, D, block_k): the three encoders at batch 8, chip_smoke's GQA and
#: causal cases, decode rows, and ragged rows, head dims and blocks
PATH_ATTN = [(8 * h, s, d, 128) for _, _, h, _, s, d, _, _ in SMOKE.ATTN_CASES]
RAGGED_ATTN = [(bh, sq, d, bk) for bh in (1, 3, 64) for sq in (1, 3, 17, 100)
               for d, bk in ((32, 128), (36, 100), (64, 512), (68, 64), (128, 128), (192, 32),
                             (800, 512))]


def _attn_cover(bh, sq, d, bk):
    w, split, slots, gx, gy = attn_grid(bh, sq, d, bk)
    assert split in (1, 2) and w * split <= 4  # at most 128 threads a block
    assert 2 <= slots <= 4 and attn_smem(w, bk, d, slots) <= SMEM_MAX
    rows = 16 * w
    tiles = -(-sq // rows)
    cover = np.zeros((bh, sq, d), np.int32)
    for x in range(gx):
        head, q0 = divmod(x, tiles)
        for y in range(gy):
            cover[head, q0 * rows:(q0 + 1) * rows, 64 * y:64 * (y + 1)] += 1
    return w, cover


@pytest.mark.parametrize("bh,sq,d,bk", PATH_ATTN + RAGGED_ATTN)
def test_attention_blocks_cover_every_output_once(bh, sq, d, bk):
    w, cover = _attn_cover(bh, sq, d, bk)
    assert (cover == 1).all()


def test_attention_grid_fills_the_card_on_mobilebert():
    """256 tiles of 16 rows: two warps each, four warps a block, so 128
    blocks put a warp on nearly every scheduler (4 per SM)."""
    w, split, _, gx, gy = attn_grid(8 * 4, 128, 64, 128)  # batch 8, 4 heads, S 128
    assert split == 2 and w * split == 4
    assert gx * gy * w * split >= 0.95 * 4 * _build.NUM_SMS


def test_attention_grid_fits_wide_heads_and_refuses_what_does_not_fit():
    assert attn_grid(48, 512, 64, 128)[:3] == (4, 1, 4)  # Whisper: 1536 tiles, no split
    groups, _, slots, _, _ = attn_grid(1, 16, 800, 512)
    assert (groups, slots) == (1, 2)  # a shallower ring for a wide head
    with pytest.raises(ValueError, match="shared memory"):
        attn_grid(1, 16, 2048, 512)


# ---------------------------------------------------------------------------
# itamax and igelu: the pointwise kernels' launch shapes
# ---------------------------------------------------------------------------

from repro_torch.kernels.igelu.ops import NT as IGELU_NT  # noqa: E402
from repro_torch.kernels.igelu.ops import igelu_grid  # noqa: E402
from repro_torch.kernels.itamax.ops import (  # noqa: E402
    MAX_CH, MAX_ROW, NT, SMEM_MAX as ITAMAX_SMEM_MAX, _chunks_spanned, itamax_grid,
    itamax_smem,
)

#: (R, n): the three encoders' w8a8 softmax at batch 8, and rows that are
#: short, odd, one past a chunk, one past a warp's 32 chunks, the longest
#: a warp holds and the longest there is, over 1, 7 and 300 rows
PATH_ITAMAX = [(r, n) for _, r, n in SMOKE.ITAMAX_CASES]
RAGGED_ITAMAX = [(r, n) for n in (1, 2, 3, 15, 16, 17, 77, 128, 241, 512, 513, 4096, 4097,
                                  MAX_ROW - 1, MAX_ROW)
                 for r in (1, 7, 300)]
#: past one wave of blocks: several staging steps a block, the last short
MULTI_STEP_ITAMAX = [(200003, 77), (100001, 241)]


def _itamax_stores(r, n):
    """Where the kernel (csrc/itamax.cu) puts each row's bytes: for every
    block, step, row segment and chunk slot, the bytes [lo, hi) of the
    chunk that the slot loads and stores, as positions in the tensor.
    Returns how often each byte is stored and the row that stored it."""
    rpb, lanes, smem = itamax_grid(r, n)
    g_rows = NT // lanes
    ch = -(-_chunks_spanned(n) // lanes)
    stage = (smem - 256 * 32 * 4) // 2
    count = np.zeros(r * n, np.int32)
    owner = np.full(r * n, -1, np.int64)
    seg = np.arange(g_rows)[:, None, None]
    j = np.arange(lanes)[None, :, None]
    k = np.arange(ch)[None, None, :]
    e = np.arange(16)
    for b in range(-(-r // rpb)):
        row0, rows = b * rpb, min(rpb, r - b * rpb)
        cbase, skew = (row0 * n) >> 4, (row0 * n) & 15
        for s in range(-(-rows // g_rows)):
            b0 = skew + s * g_rows * n
            b1 = skew + min((s + 1) * g_rows, rows) * n
            assert 16 * ((b1 + 15) // 16 - b0 // 16) <= stage  # the staged chunks fit
            live = seg < min(g_rows, rows - s * g_rows)
            rs = (b0 & 15) + seg * n
            c = (rs >> 4) + j + k * lanes
            lo = np.maximum(rs - 16 * c, 0)
            hi = np.where(live, np.minimum(rs + n - 16 * c, 16), 0)
            keep = (e >= lo[..., None]) & (e < hi[..., None])
            assert (16 * c + 16 <= stage)[hi > lo].all()
            pos = cbase * 16 + (b0 >> 4) * 16 + 16 * c[..., None] + e
            row = np.broadcast_to(row0 + s * g_rows + seg[..., None], pos.shape)
            np.add.at(count, pos[keep], 1)
            owner[pos[keep]] = row[keep]
    return count, owner


@pytest.mark.parametrize("r,n", PATH_ITAMAX + RAGGED_ITAMAX + MULTI_STEP_ITAMAX)
def test_itamax_blocks_store_every_byte_once(r, n):
    count, owner = _itamax_stores(r, n)
    assert (count == 1).all()
    assert (owner == np.arange(r * n) // n).all()  # each byte by the segment of its row


@pytest.mark.parametrize("r,n", PATH_ITAMAX + RAGGED_ITAMAX + MULTI_STEP_ITAMAX)
def test_itamax_blocks_start_aligned_and_fit(r, n):
    rpb, lanes, smem = itamax_grid(r, n)
    blocks = -(-r // rpb)
    assert (blocks - 1) * rpb < r  # no block lies wholly outside
    assert all(b * rpb * n % 16 == 0 for b in range(blocks - 1))
    assert rpb % (NT // lanes) == 0 and rpb * n <= 1 << 30
    assert lanes == NT or (lanes <= 32 and 32 % lanes == 0)
    assert 1 <= -(-_chunks_spanned(n) // lanes) <= MAX_CH
    assert smem == itamax_smem(n, lanes) <= ITAMAX_SMEM_MAX


@pytest.mark.parametrize("first", range(1, MAX_ROW + 1, 4096))
def test_itamax_shared_memory_fits_every_row_length(first):
    for n in range(first, first + 4096):
        for r in (1, 1000, 1 << 20):
            rpb, lanes, smem = itamax_grid(r, n)
            assert smem <= 232448
            assert lanes == NT or 32 % lanes == 0


@pytest.mark.parametrize("n", [0, MAX_ROW + 1])
def test_itamax_grid_refuses_rows_it_cannot_take(n):
    with pytest.raises(ValueError, match="rows of"):
        itamax_grid(8, n)


def test_itamax_grid_on_the_path():
    """Fewer lanes a row (more chunks a lane) where the rows still give
    every SM a step; MobileBERT's 4096 short rows keep 8 lanes a row."""
    assert itamax_grid(4096, 128)[1] == 8
    assert itamax_grid(24576, 512)[1] == 8
    assert itamax_grid(11568, 241)[1] == 4
    assert itamax_grid(3, 1 << 15)[1] == NT  # a row takes the whole block
    for r, n in MULTI_STEP_ITAMAX:  # several steps a block, the last block short
        rpb, lanes, _ = itamax_grid(r, n)
        assert rpb >= 3 * (NT // lanes) and r % rpb


#: element counts: under, at and past one 16-byte word, the DeiT-Ti-width
#: path, ragged sizes, and sizes that take the grid-stride loop past one round
IGELU_COUNTS = [0, 1, 15, 16, 17, 255, 4096, 5061, 8 * 197 * 768, 8 * 197 * 768 + 9,
                2 * 132 * 8 * 256 * 3 * 16 + 7]


@pytest.mark.parametrize("n", IGELU_COUNTS)
def test_igelu_grid_maps_every_element_once(n):
    """Mirrors csrc/igelu.cu: thread t of T maps words t + k T of each round
    of wpt T words, then elements n_vec 16 + t + i T of the tail."""
    blocks, wpt = igelu_grid(n)
    assert blocks >= 1 and 1 <= wpt <= 3
    assert blocks <= _build.NUM_SMS * (2048 // IGELU_NT)
    threads = blocks * IGELU_NT
    n_vec = n // 16
    count = np.zeros(n_vec, np.int32)
    t = np.arange(threads)
    for base in range(0, n_vec, wpt * threads):
        for k in range(wpt):
            w = base + t + k * threads
            np.add.at(count, w[w < n_vec], 1)
    assert (count == 1).all()
    tail = np.zeros(n - 16 * n_vec, np.int32)
    for i in range(16 * n_vec, n, threads):
        idx = i + t
        np.add.at(tail, idx[idx < n] - 16 * n_vec, 1)
    assert (tail == 1).all()


def test_igelu_grid_on_the_path():
    """The DeiT-Ti-width GELU: one block per SM, every load in one round."""
    blocks, wpt = igelu_grid(8 * 197 * 768)
    assert blocks == _build.NUM_SMS
    assert blocks * IGELU_NT * wpt >= 8 * 197 * 768 // 16
