"""The port's ``igelu`` and ``itamax`` kernel modules and its exact integer
product, against the JAX package, bit for bit.

On the CPU a wrapper runs its kernel's plain version (the tensor lies on
the CPU); that version must equal the JAX package's interpret-mode Pallas
kernel where the JAX wrapper accepts the shape, and its ``*_ref`` oracle
at the path's real widths, which the JAX wrapper refuses.  The exact
product of the plain path (``imatmul_exact``, what ``imatmul`` runs on
CUDA tensors) is held against the int32 product of both packages on CPU
tensors, wrapping cases included.  The CUDA kernels themselves are held
against the plain versions in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import igelu as j_igelu
from repro.kernels import igelu_ref as j_igelu_ref
from repro.kernels import itamax as j_itamax
from repro.kernels import itamax_ref as j_itamax_ref
from repro_torch.kernels.igelu import igelu, igelu_ref
from repro_torch.kernels.itamax import itamax, itamax_ref
from repro_torch.quant.qparams import imatmul, imatmul_exact


def _ri8(rng, shape, lo=-128):
    return rng.integers(lo, 128, size=shape).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# igelu
# ---------------------------------------------------------------------------

GELU_SCALES = [(0.05, 0.05), (0.02, 0.1), (0.1, 0.01)]


@pytest.mark.parametrize("in_scale,out_scale", GELU_SCALES)
@pytest.mark.parametrize("shape", [(128, 512), (2, 256, 1024), (64, 384)])
def test_igelu_plain_vs_pallas(shape, in_scale, out_scale):
    """Shapes the JAX wrapper takes (n <= 512 or n % 512 == 0); every int8
    value appears."""
    rng = np.random.default_rng(sum(shape))
    x = _ri8(rng, shape)
    x.reshape(-1)[:256] = np.arange(-128, 128)
    kw = dict(in_scale=in_scale, out_scale=out_scale)
    before = igelu.launches
    got = igelu(_t(x), **kw)
    assert igelu.launches == before  # the plain version on CPU tensors
    assert got.dtype == torch.int8 and got.shape == shape
    assert np.array_equal(got.numpy(), np.asarray(j_igelu(jnp.asarray(x), interpret=True, **kw)))
    assert np.array_equal(igelu_ref(_t(x), **kw).numpy(), got.numpy())


@pytest.mark.parametrize("shape", [(8 * 197, 768), (2 * 100, 768), (3, 7, 241)])
def test_igelu_plain_vs_oracle_at_path_widths(shape):
    """d_ff = 768 (DeiT-Ti widths) and ragged shapes: the JAX wrapper's
    ``block_n = min(512, n)`` refuses them, its oracle does not."""
    rng = np.random.default_rng(len(shape) + shape[-1])
    x = _ri8(rng, shape)
    for in_scale, out_scale in GELU_SCALES:
        kw = dict(in_scale=in_scale, out_scale=out_scale)
        want = np.asarray(j_igelu_ref(jnp.asarray(x), **kw))
        assert np.array_equal(igelu(_t(x), **kw).numpy(), want)


def test_igelu_reference_wrapper_refuses_768():
    """The reference fault the port does not copy (ROADMAP §3)."""
    x = jnp.zeros((512, 768), jnp.int8)
    with pytest.raises(AssertionError):
        j_igelu(x, in_scale=0.05, out_scale=0.05, interpret=True)
    assert igelu(torch.zeros((512, 768), dtype=torch.int8), in_scale=0.05,
                 out_scale=0.05).shape == (512, 768)


# ---------------------------------------------------------------------------
# itamax
# ---------------------------------------------------------------------------


def _logits(rng, r, n):
    """Random rows, then one row of equal logits, one with a single dominant
    entry, one of all -128 and one of all 127."""
    x = _ri8(rng, (r, n))
    x[0] = 17
    x[1] = -128
    x[1, n // 2] = 127
    x[2] = -128
    x[3] = 127
    return x


@pytest.mark.parametrize("r,n", [(128, 128), (256, 241), (512, 512), (768, 77)])
def test_itamax_plain_vs_pallas(r, n):
    """Row counts the JAX wrapper takes (R <= 256 or R % 256 == 0)."""
    x = _logits(np.random.default_rng(r + n), r, n)
    before = itamax.launches
    got = itamax(_t(x))
    assert itamax.launches == before
    assert got.dtype == torch.int8 and int(got.min()) >= 0
    assert np.array_equal(got.numpy(), np.asarray(j_itamax(jnp.asarray(x), interpret=True)))
    assert np.array_equal(itamax_ref(_t(x)).numpy(), got.numpy())


@pytest.mark.parametrize("shape", [(8 * 6 * 241, 241), (3, 5, 100), (1001, 128)])
def test_itamax_plain_vs_oracle_at_path_rows(shape):
    """DINOv2-small's w8a8 softmax (8 * 6 * 241 rows of 241) and ragged row
    counts, which the JAX wrapper refuses."""
    rng = np.random.default_rng(shape[-1])
    x = _logits(rng, int(np.prod(shape[:-1])), shape[-1]).reshape(shape)
    want = np.asarray(j_itamax_ref(jnp.asarray(x)))
    assert np.array_equal(itamax(_t(x)).numpy(), want)


def test_itamax_weight_table_is_the_reference_exponential():
    """The kernel tabulates W[t] = exp2_lut(lut, t) for t = m - x, which
    int8 logits keep in [0, 255], from the LUT its wrapper passes.  Worked
    out as ``csrc/int_arith.cuh exp2_lut`` does, every entry equals the JAX
    package's exponential at the t (clipped to 2^20) the reference uses."""
    from repro.core import itamax as j_im
    from repro_torch.kernels.itamax import ops

    lut = ops._lut(torch.device("cpu")).numpy()
    t = np.arange(256)
    q = np.minimum(t >> 5, 31)
    table = (lut[t & 31] + np.where(q > 0, 1 << np.maximum(q - 1, 0), 0)) >> q
    x = np.arange(-128, 128)  # beside the max 127, t = 127 - x covers [0, 255]
    t_ref = jnp.clip(127 - jnp.asarray(x, jnp.int32), 0, 1 << 20)
    want = np.asarray(j_im._exp2_int(t_ref, j_im.exp_lut(), j_im.EXP_LUT_BITS))
    assert np.array_equal(table[127 - x], want)


def test_itamax_mask_on_cpu_tensors():
    """On CPU tensors the wrapper takes a mask (the plain version does)."""
    rng = np.random.default_rng(3)
    x = _ri8(rng, (4, 8, 100))
    mask = rng.random((4, 8, 100)) > 0.3
    assert np.array_equal(itamax(_t(x), mask=_t(mask)).numpy(),
                          itamax_ref(_t(x), mask=_t(mask)).numpy())


# ---------------------------------------------------------------------------
# the exact integer product of the plain path
# ---------------------------------------------------------------------------


def _int32_product(a, b):
    """The int32 accumulator: exact in int64, wrapped to int32."""
    return (a.astype(np.int64) @ b.astype(np.int64)).astype(np.int32)


PRODUCTS = {
    # label: (a shape, |a| bound, b shape, |b| bound, b dtype); a is int8 at bound 128
    "int8, _int_mm": ((2, 100, 1536), 128, (1536, 384), 128, np.int8),
    "int8, float64 (N % 8 != 0)": ((100, 192), 128, (192, 30), 128, np.int8),
    "int8, float64 (16 rows)": ((16, 64), 128, (64, 64), 128, np.int8),
    "int8 batched, float64": ((2, 3, 97, 64), 128, (2, 3, 64, 97), 128, np.int8),
    "int32 x int8, float64": ((4, 50, 128), 1 << 16, (128, 16), 128, np.int8),
    "int32 wraps, float64": ((40, 16), 1 << 20, (16, 24), 1 << 20, np.int32),
}


@pytest.mark.parametrize("label", list(PRODUCTS))
def test_exact_product_vs_int32_product(label):
    a_shape, a_lim, b_shape, b_lim, b_dtype = PRODUCTS[label]
    rng = np.random.default_rng(len(label))
    a_dtype = np.int8 if a_lim == 128 else np.int32
    a = rng.integers(-a_lim, a_lim, size=a_shape).astype(a_dtype)
    b = rng.integers(-b_lim, b_lim, size=b_shape).astype(b_dtype)
    want = _int32_product(a, b)
    got = imatmul_exact(_t(a), _t(b))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(imatmul(_t(a), _t(b)).numpy(), want)  # the CPU product
    j = jnp.matmul(jnp.asarray(a), jnp.asarray(b), preferred_element_type=jnp.int32)
    assert np.array_equal(np.asarray(j), want)
    wide = a.astype(np.int64) @ b.astype(np.int64)
    assert (label == "int32 wraps, float64") == (not np.array_equal(wide, want))


def test_exact_product_raises_past_float64():
    """Past 2^53 the float64 product would round: it raises instead."""
    a = torch.full((2, 1 << 10), 1 << 22, dtype=torch.int32)
    b = torch.full((1 << 10, 2), -(1 << 22), dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^53"):
        imatmul_exact(a, b)
    small = imatmul_exact(a[:, :4] >> 12, b[:4] >> 12)  # 4 * 2^20 fits
    assert torch.equal(small, torch.full((2, 2), -(4 << 20), dtype=torch.int32))
