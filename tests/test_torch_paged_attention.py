"""The paged flash-ITAMax attention (``ita_attention_paged``) and its
plain version (``ita_attention_paged_ref``: each lane's blocks gathered,
under ``attention_decode_i8``).

On the CPU the ``attn_paged`` runner is the wrapper, whose plain version
must give the JAX package's ``attn_paged`` ints bit for bit on the named
cases; the shapes the kernel takes are checked by the rule that raises
for the others.  The tests marked ``cuda`` hold the kernel against the
plain version on the card, and a full-width OLMo-1B chunk dispatch and
decode step through the executor against the plain version, with no
blocking copy inside ``attn_paged``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_paged_attention.py
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.heterogeneous import (
    DEFAULT_TABLE,
    DispatchTable,
    Engine,
    populate_default_table,
)
from repro_torch.kernels.ita_attention import ita_attention_paged, ita_attention_paged_ref
from repro_torch.kernels.ita_attention.ops import MAX_LANES, _luts, paged_launch_grid
from repro_torch.kernels.ita_attention.ref import paged_block_k

#: logits spread over the int8 grid unclipped and outputs fine enough that
#: another KV block partition changes some of them
SCALES = dict(s_act=0.01, s_out=0.00125)


def _runner():
    return DEFAULT_TABLE.table["attn_paged"][Engine.CLUSTER]


def _case(name: str):
    """(q_m, k_pool, v_pool, pos, table, kw) of one named case: lanes of
    ``s`` queries at offsets ``pos`` over tables of 16-row blocks."""
    rng = np.random.default_rng(sum(map(ord, name)))
    heads, kv_heads, d, bs, cols, block_k = 2, 2, 64, 16, 128, 512
    s = 512
    if name == "chunk-offsets":  # one chunk at each offset of a 2048-row table
        pos = [0, 512, 1024, 1536]
    elif name == "pinned-tail":  # a last chunk overlapping the one before it
        pos = [788, 1300]
    elif name == "decode-depths":
        s, pos = 1, [0, 17, 511, 512, 1000, 1535, 2047]
    elif name == "parked":  # all-scratch tables at depth 0 and one past its table
        pos = [0, 0, 3000]
    elif name == "gqa-d128":
        heads, kv_heads, d, pos = 4, 2, 128, [0, 700]
    elif name == "gqa-one-kv-head-decode":
        heads, kv_heads, s, pos = 4, 1, 1, [5, 1100, 2040]
    elif name == "fallback-576-rows":  # 36 blocks: 576 % 512 != 0, one KV block of 576
        cols, s, pos = 36, 64, [0, 100, 512, 530]
    elif name == "cow-shared-block":
        s, pos = 64, [40, 40, 90]
    else:
        raise KeyError(name)
    b = len(pos)
    pool_blocks = b * cols + 8  # every lane's blocks its own, but where shared
    q = rng.integers(-128, 128, (b, s, heads * d)).astype(np.int8)
    k_pool = rng.integers(-128, 128, (pool_blocks, kv_heads, bs, d)).astype(np.int8)
    v_pool = rng.integers(-128, 128, (pool_blocks, kv_heads, bs, d)).astype(np.int8)
    # each lane's own blocks, in a scrambled order; unallocated entries scratch
    perm = rng.permutation(np.arange(1, pool_blocks))
    table = np.zeros((b, cols), np.int32)
    for lane, p in enumerate(pos):
        need = min(cols, -(-(p + s) // bs))
        table[lane, :need] = perm[lane * cols: lane * cols + need]
    if name == "parked":
        table[:2] = 0
    if name == "cow-shared-block":
        # lanes 0 and 1 attached one prefix (blocks 0-2 shared); lane 1 wrote
        # into the partial block 2 after a copy-on-write, lane 0 did not
        table[1, :2] = table[0, :2]
        table[2, :3] = table[0, :3]
    kw = dict(heads=heads, kv_heads=kv_heads, head_dim=d, block_k=block_k)
    return (torch.from_numpy(q), torch.from_numpy(k_pool), torch.from_numpy(v_pool),
            np.asarray(pos, np.int32), torch.from_numpy(table), kw)


CASES = ["chunk-offsets", "pinned-tail", "decode-depths", "parked", "gqa-d128",
         "gqa-one-kv-head-decode", "fallback-576-rows", "cow-shared-block"]


def _wrapper(q, k_pool, v_pool, pos, table, kw, fn=ita_attention_paged):
    return fn(q, k_pool, v_pool, pos, table, s_q=SCALES["s_act"], s_k=SCALES["s_act"],
              s_v=SCALES["s_act"], s_out=SCALES["s_out"], **kw)


@pytest.mark.parametrize("name", CASES)
def test_paged_reference_equals_the_jax_runner(name):
    """The runner's plain version (the wrapper on CPU tensors) gives the JAX
    package's ``attn_paged`` ints bit for bit."""
    import jax.numpy as jnp

    from repro.core.heterogeneous import DEFAULT_TABLE as J_TABLE
    from repro.core.heterogeneous import Backend, Engine as JEngine

    q, k_pool, v_pool, pos, table, kw = _case(name)
    j_fn = J_TABLE._lookup("attn_paged", JEngine.CLUSTER, Backend.W8A8)
    want = j_fn(*(jnp.asarray(np.asarray(t)) for t in (q, k_pool, v_pool, pos, table)),
                **SCALES, **kw)
    got = _runner()(q, k_pool, v_pool, pos, table, **SCALES, **kw)
    assert got.dtype == torch.int8 and got.shape == q.shape
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(_wrapper(q, k_pool, v_pool, pos, table, kw, ita_attention_paged_ref), got)
    if name == "fallback-576-rows":
        assert paged_block_k(kw["block_k"], table.shape[1] * k_pool.shape[2]) == 576


def test_paged_reference_takes_one_table_for_every_lane_and_a_scalar_offset():
    """A session's single-slot chunk: a [cols] table and a scalar start."""
    q, k_pool, v_pool, _, table, kw = _case("chunk-offsets")
    q, table = q[:1], table[2:3]
    want = _wrapper(q, k_pool, v_pool, np.asarray([1024], np.int32), table, kw)
    assert torch.equal(_wrapper(q, k_pool, v_pool, 1024, table[0], kw), want)


@pytest.mark.parametrize("shape,fits", [
    ((16, 16, 16, 512, 128, 512), True),  # the cells' chunk dispatch
    ((16, 16, 16, 1, 128, 512), True),  # their decode step
    ((2, 4, 2, 8, 32, 24), True),  # reduced OLMo: GQA, a 24-row table
    ((3, 4, 1, 1, 64, 576), True),  # the bk = rows fallback
    ((MAX_LANES, 2, 2, 1, 64, 512), True),
    ((MAX_LANES + 1, 2, 2, 1, 64, 512), False),  # offsets past the launch argument
    ((2, 6, 4, 8, 64, 512), False),  # GQA groups not whole
    ((2, 4, 4, 8, 6, 512), False),  # head_dim not a multiple of 4
    ((2, 4, 4, 8, 64, 18), False),  # block_k not a multiple of 4
    ((1, 1, 1, 16, 2048, 512), False),  # no shared-memory layout
])
def test_paged_launch_shape_rule(shape, fits):
    """Which shapes the kernel takes: the rule reads the shapes alone, and
    raises for a shape it does not take."""
    if fits:
        assert len(paged_launch_grid(*shape)) == 6
    else:
        with pytest.raises(ValueError):
            paged_launch_grid(*shape)


@pytest.mark.parametrize("bh,sq,d,bk", [(256, 512, 128, 512), (256, 1, 128, 512),
                                         (256, 512, 128, 528), (4, 8, 32, 24), (48, 100, 64, 576)])
def test_paged_grid_covers_every_output_and_fits(bh, sq, d, bk):
    """Block x takes row groups of one head, block y ``out`` columns: every
    (head, row, column) once; the block fits the shared memory, two to an
    SM where they can (at the cells' shapes they do)."""
    from repro_torch.kernels.ita_attention.ops import (
        BLOCK_SMEM_EXTRA, SM_SMEM, SMEM_MAX, attn_smem, paged_grid)

    out, groups, split, ring, gx, gy = paged_grid(bh, sq, d, bk)
    assert out in (64, 128) and groups * split <= 4 and 2 <= ring <= 4
    rows = 16 * groups
    assert gx * rows >= bh * sq and (gx // bh - 1) * rows < sq and gx % bh == 0
    assert gy * out >= d > (gy - 1) * out
    smem = attn_smem(groups, bk, d, ring, out)
    assert smem <= SMEM_MAX
    if d == 128:
        assert (out, split) == (128, 2) and 2 * (smem + BLOCK_SMEM_EXTRA) <= SM_SMEM


def test_attn_paged_runner_is_the_wrapper():
    """The ``attn_paged`` runner calls the wrapper on every device: on CPU
    tensors its plain version, which launches nothing; serve's launch
    counts and --profile read the wrapper's counter."""
    q, k_pool, v_pool, pos, table, kw = _case("cow-shared-block")
    launches = ita_attention_paged.launches
    got = _runner()(q, k_pool, v_pool, pos, table, **SCALES, **kw)
    assert torch.equal(got, _wrapper(q, k_pool, v_pool, pos, table, kw, ita_attention_paged_ref))
    assert ita_attention_paged.launches == launches
    assert kernels.wrappers()["ita_attention_paged"] is ita_attention_paged


def test_paged_launch_binding_matches_the_c_signature():
    """ctypes passes what the kernel library's C entry point declares:
    a pointer for each pointer, a 32-bit int for each int, in order; the
    wrapper's lane limit is the kernel's."""
    import ctypes
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels.ita_attention.ops import PAGED_ARGTYPES

    src = (_build.CSRC / "ita_attention.cu").read_text()
    sig = re.search(r'extern "C" int ita_attention_paged_launch\((.*?)\)', src, re.S)
    params = [p.strip() for p in sig.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert all("*" in p or p.startswith("int ") for p in params)
    assert PAGED_ARGTYPES == want
    assert f"constexpr int MAX_LANES = {MAX_LANES};" in src  # the offsets' launch argument


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_paged_kernel_equals_the_reference_on_the_card(cuda_device, name):
    q, k_pool, v_pool, pos, table, kw = (t.to(cuda_device) if isinstance(t, torch.Tensor)
                                         else t for t in _case(name))
    before = ita_attention_paged.launches
    got = _runner()(q, k_pool, v_pool, pos, table, **SCALES, **kw)
    torch.cuda.synchronize()
    assert ita_attention_paged.launches == before + 1
    want = _wrapper(q, k_pool, v_pool, pos, table, kw, ita_attention_paged_ref)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_paged_kernel_raises_for_what_it_cannot_take_on_the_card(cuda_device):
    """On the card nothing falls back to the gather: a shape the kernel does
    not take (head_dim 6) and a pool view that is not contiguous raise, and
    launch nothing; a query that is not contiguous is copied whole and
    gives the reference's ints."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.integers(-128, 128, (2, 8, 2 * 6)).astype(np.int8))
    pool = torch.from_numpy(rng.integers(-128, 128, (6, 2, 4, 6)).astype(np.int8))
    table = torch.tensor([[1, 2, 3], [4, 5, 0]], dtype=torch.int32)
    pos = np.asarray([3, 0], np.int32)
    kw = dict(heads=2, kv_heads=2, head_dim=6, block_k=512, **SCALES)
    before = ita_attention_paged.launches
    qd, pd, td = q.to(cuda_device), pool.to(cuda_device), table.to(cuda_device)
    with pytest.raises(ValueError):
        _runner()(qd, pd, pd, pos, td, **kw)
    qc, kc, vc, pos, table, kw = (t.to(cuda_device) if isinstance(t, torch.Tensor)
                                  else t for t in _case("cow-shared-block"))
    view = torch.cat([kc, kc], dim=1)[:, ::2]  # the pool's values, strided
    with pytest.raises(ValueError):
        _runner()(qc, view, vc, pos, table, **SCALES, **kw)
    assert ita_attention_paged.launches == before
    strided = torch.cat([qc, qc], dim=2)[:, :, ::2]
    got = _runner()(strided, kc, vc, pos, table, **SCALES, **kw)
    want = _wrapper(strided, kc, vc, pos, table, kw, ita_attention_paged_ref)
    assert ita_attention_paged.launches == before + 1 and torch.equal(got, want)


def _tables(dev):
    """The default runners with ``attn_paged`` held to no blocking copy (the
    kernel), and with it on its plain version (the reference)."""
    kernel, plain = populate_default_table(DispatchTable()), populate_default_table(
        DispatchTable())
    runner = kernel.table["attn_paged"][Engine.CLUSTER]

    def no_sync(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return runner(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def reference(q_m, k_pool, v_pool, pos, table_q, *, s_act, s_out, **kw):
        return ita_attention_paged_ref(q_m, k_pool, v_pool, pos, table_q, s_q=s_act, s_k=s_act,
                                       s_v=s_act, s_out=s_out, **kw)

    kernel.register("attn_paged", Engine.CLUSTER, no_sync)
    plain.register("attn_paged", Engine.CLUSTER, reference)
    return kernel, plain


@pytest.mark.cuda
def test_olmo_width_chunk_and_decode_dispatches_on_the_card(cuda_device):
    """OLMo-1B's widths (2 of its 16 layers), 16 lanes, chunks of 512 over
    blocks of 16: chunk dispatches with lanes at offsets 0 / 512 / 1024 /
    1536, a pinned tail and parked lanes, then a 16-lane decode step, equal
    the plain version's logits (named lanes) and pool (but for the scratch
    block), with every attn_paged call on the kernel and none waiting for
    the device."""
    from repro_torch.configs import get_config
    from repro_torch.deploy import api

    cfg = dataclasses.replace(get_config("olmo-1b"), n_layers=2)
    model = api.compile(cfg, backend="ita", seq_len=512, max_len=2048, kv_block_size=16,
                        kv_blocks=16 * 128, use_cache=False)
    _, qp = model.bind(seed=0)
    kernel_t, plain_t = _tables(cuda_device)
    card, plain = (model.session(16, qp=qp, table=t) for t in (kernel_t, plain_t))
    _luts(card.kv_pool["k"].device)  # built once a device, before the checked calls
    gen = torch.Generator().manual_seed(31)
    prompts = torch.randint(0, cfg.vocab, (16, 2048), generator=gen, dtype=torch.int32)

    def both(fn, lanes):
        before = ita_attention_paged.launches
        got, want = fn(card), fn(plain)
        torch.cuda.synchronize()
        assert ita_attention_paged.launches - before == cfg.n_layers
        assert torch.equal(got[lanes], want[lanes])
        for part in ("k", "v"):
            assert torch.equal(card.kv_pool[part][:, 1:], plain.kv_pool[part][:, 1:])
        return want

    steps = [
        {0: 0, 1: 0, 2: 0, 3: 0},
        {1: 512, 2: 512, 3: 512, 4: 0},
        {2: 1024, 3: 1024, 5: 0, 1: 700},  # lane 1: a tail overlapping [512, 1024)
        {3: 1536, 6: 0, 2: 1400},
    ]
    for chunks in steps:
        both(lambda s: s.prefill_chunks(
            {b: (prompts[b, p: p + 512], p) for b, p in chunks.items()}), sorted(chunks))
    lanes = [0, 1, 2, 4, 5, 6]  # lane 3 is full (2048 rows): parked with the rest
    active = [b in lanes for b in range(16)]
    tok = torch.randint(0, cfg.vocab, (16,), generator=gen, dtype=torch.int32)
    both(lambda s: s.decode(tok.to(cuda_device), active=active), lanes)
