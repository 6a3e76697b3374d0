"""The operations and bytes behind the rooflines and ``mfu``, against
counts made by hand from the configurations' shapes."""

from __future__ import annotations

from bench.harness import counts as C
from bench.harness.spec import load_cell

OLMO = load_cell("olmo-1b-docqa")["config"]["arch"]


def test_one_olmo_chunk_by_hand():
    calls = C.decoder_chunk_calls(OLMO, lanes=16, seq=512)
    assert len(calls) == 7 * 16  # int8_gemm 112x a chunk dispatch
    m = 16 * 512
    # 4 x [2048 x 2048] and 3 x [2048 x 8192] a layer: 2^30 weights over 16 layers
    assert sum(o for o, _ in calls) == 2 * m * (1 << 30) == 17_592_186_044_416
    assert calls[0] == (2 * m * 2048 * 2048, m * 2048 + 2048 * 2048 + m * 2048)
    assert calls[6] == (2 * m * 8192 * 2048, m * 8192 + 8192 * 2048 + m * 2048)
    # one token at row r: the layers' 2^30 weights twice, attention over r + 1 keys
    assert C.decoder_rows_ops(OLMO, 0, 1) == 16 * (2 * (1 << 26) + 4 * 2048)
    assert C.decoder_rows_ops(OLMO, 100, 612) == sum(
        16 * (2 * (1 << 26) + 4 * 2048 * (r + 1)) for r in range(100, 612))
    assert C.decoder_head_ops(OLMO) == 2 * 2048 * 50304


def test_the_bound_is_the_larger_of_the_two():
    ops, nbytes = C.gemm(8192, 2048, 8192, False)
    assert C.bound_s(ops, nbytes) == ops / 1979e12  # a large GEMM: compute
    ops, nbytes = C.gemm(16, 2048, 2048, False)
    assert C.bound_s(ops, nbytes) == nbytes / 3.35e12  # a decode step's: bytes
