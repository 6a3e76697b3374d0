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
