"""Shared model layers of the port: the float layers and the integer (w8a8) helpers.

Float layers run the float models (optionally with QAT fake-quant) and
serve as accuracy references.  Integer activations are int8 tensors
threaded between ops, with static python float scales carried by a
:class:`QuantConfig` (the PTQ product).  Engine mapping (the paper's
heterogeneous split): the accelerator runs qlinear (GEMM + act) and the
quantized attention; the cluster runs norms, residual adds, the
classifier, and the decoder's integer RoPE and SiLU.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import ilayernorm as iln
from repro_torch.core import itamax as im
from repro_torch.core.igelu import gelu_f32
from repro_torch.core.quant_linear import (  # noqa: F401  (ACT_* re-exported)
    ACT_GELU,
    ACT_IDENTITY,
    ACT_RELU,
    QLinearParams,
    make_qlinear_params,
    qlinear_i8,
)
from repro_torch.quant.qparams import (
    _is_dtensor,
    i32,
    make_qparams,
    quantize_weight_per_tensor,
    requantize,
    requantize_wide,
)

# ---------------------------------------------------------------------------
# Quantization configuration (static scales)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class QuantConfig:
    """Static per-site activation scales for the integer path.

    Uniform defaults serve shape-only runs (one set of multipliers shared
    by all layers); PTQ (``quant.ptq.calibrate_encoder``) sets calibrated
    values, and per-site ones go in ``overrides``.
    """

    s_act: float = 0.05  # generic activation grid
    s_res: float = 0.08  # residual stream grid
    s_w: float = 0.01  # weight grid
    overrides: tuple = ()  # ((site_name, scale), ...) — kept hashable

    def site(self, name: str, default: float | None = None) -> float:
        """The scale of site ``name``: its override, else ``default``,
        else ``s_act``."""
        for k, v in self.overrides:
            if k == name:
                return v
        return default if default is not None else self.s_act


# ---------------------------------------------------------------------------
# Float init (torch.Generator; the JAX package's numbers are not reproduced)
# ---------------------------------------------------------------------------


def init_linear(gen: torch.Generator, d_in: int, d_out: int, bias: bool,
                dtype=torch.float32, device=None) -> dict:
    """Drawn on ``gen``'s device, then moved to ``device`` (default: there)."""
    device = gen.device if device is None else device
    w = torch.randn((d_in, d_out), generator=gen, dtype=dtype, device=gen.device)
    p = {"w": (w / math.sqrt(d_in)).to(device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``.  On DTensors its gradient comes back laid out as its
    output (``activations.grad_as_output``), so that the product's backward
    views rows no DTensor version refuses."""
    from repro_torch.runtime.activations import grad_as_output

    return grad_as_output(x @ w)


def head_logits(x: torch.Tensor, w: torch.Tensor, *, tied: bool = False) -> torch.Tensor:
    """``x @ w``: an LM head's logits, ``w [D, V]`` its weight, or with
    ``tied`` the embedding table ``[V, D]`` (``x @ w.T``).

    On a sharded step (DTensors) the product runs on each rank's shards
    (``activations.local_shards``): ``x``'s rows split over the data axes,
    the weight whole along D (FSDP's gather) and split over "model" along
    the vocab where it divides it, so the logits come out as the loss
    takes them, ``[B/data, S, V/model]``.  DTensor's own rule may instead
    contract over an FSDP-split D and leave every rank a sum still to
    reduce of the whole batch's logits."""
    fn = (lambda a, t: matmul(a, t.T)) if tied else matmul
    if not _is_dtensor(x) and not _is_dtensor(w):
        return fn(x, w)
    from repro_torch.runtime import activations as A
    from repro_torch.runtime.sharding import P, data_axes

    mesh = (x if _is_dtensor(x) else w).device_mesh
    da = data_axes(mesh)
    b_ax = da if A.fits(x.shape[0], da, mesh) else None
    v_ax = "model" if A.fits(w.shape[0 if tied else 1], "model", mesh) else None
    rows = (None,) * (x.dim() - 2)
    return A.local_shards(fn, (x, w), (P(b_ax, *rows, None),
                                       P(v_ax, None) if tied else P(None, v_ax)),
                          P(b_ax, *rows, v_ax), mesh=mesh)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``: the embedding gather.

    On a sharded step (DTensors) it is the vocab-parallel gather, run on
    each rank's shards (``activations.local_shards``): a rank looks its
    tokens up in its slice of the vocab ("model"), zero where a token lies
    outside it, and the rows are a sum still to reduce over "model" (one
    rank holds each row, so the sum is exact).  DTensor's own rules for
    the gather's backward (``index_put``) are refused by some torch
    versions ("Shard dim -1 ... must be normalized").  The sum is reduced
    at once: the integer path's next ops work in place."""
    from repro_torch.runtime import activations as A

    try:
        from torch.distributed.tensor import DTensor, Partial
    except ImportError:
        DTensor = ()
    if not isinstance(table, DTensor) and not isinstance(tokens, DTensor):
        return table[tokens.long()]
    from repro_torch.runtime.sharding import P, axis_names, data_axes, placements

    mesh = table.device_mesh if isinstance(table, DTensor) else tokens.device_mesh
    names = axis_names(mesh)
    da = data_axes(mesh)
    b_ax = da if A.fits(tokens.shape[0], da, mesh) else None
    tok_spec = P(b_ax, *([None] * (tokens.dim() - 1)))
    out_spec = P(b_ax, *([None] * tokens.dim()))
    v = table.shape[0]
    if "model" not in names or mesh.size(names.index("model")) == 1 \
            or not A.fits(v, "model", mesh):
        return A.local_shards(lambda t, i: t[i.long()], (table, tokens),
                              (P(None, None), tok_spec), out_spec, mesh=mesh)
    m = names.index("model")
    per = v // mesh.size(m)
    lo = mesh.get_local_rank(m) * per

    def lookup(t, i):
        i = i.long() - lo
        inside = (i >= 0) & (i < per)
        rows = t[torch.where(inside, i, 0)]
        return rows * inside[..., None].to(rows.dtype)

    out_pl = tuple(Partial() if n == "model" else p
                   for n, p in zip(names, placements(mesh, out_spec)))
    return A._reduced(A.local_shards(lookup, (table, tokens), (P("model", None), tok_spec),
                                     out_pl, mesh=mesh))


def init_norm(kind: str, d: int, dtype=torch.float32, device=None) -> dict:
    if kind == "np_layernorm":
        return {}
    if kind == "rmsnorm":
        return {"g": torch.ones((d,), dtype=dtype, device=device)}
    return {"g": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def norm_apply(kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "rmsnorm":
        return iln.rmsnorm_f32(x, p["g"])
    if kind == "np_layernorm":
        return iln.layernorm_f32(x)
    return iln.layernorm_f32(x, p["g"], p["b"])


def rope_cos_sin(positions, head_dim: int, theta: float, dtype=torch.float32, device=None):
    """Float ``cos``/``sin`` [..., head_dim // 2] of ``positions``, computed
    on ``device`` as the JAX package does: ``theta ** (-arange / half)`` and
    the angles in float32 (the float path's tables; the integer path's
    Q0.7 tables come from :func:`_rope_cos_sin_host`)."""
    half = head_dim // 2
    freqs = float(theta) ** (-torch.arange(0, half, dtype=torch.float32, device=device) / half)
    ang = torch.as_tensor(positions, device=device).to(torch.float32)[..., None] * freqs
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, S, D]; cos/sin [S, D/2] (or broadcastable)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[None, None] if cos.dim() == 2 else cos
    s = sin[None, None] if sin.dim() == 2 else sin
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def mask_padded_logits(logits: torch.Tensor, vocab: int, start: int = 0) -> torch.Tensor:
    """-1e9 on the vocab-padding classes before softmax / cross-entropy.
    ``start``: the global index of ``logits``' first class (a rank's shard
    of the vocab); a class is padding where its global index is ``>= vocab``."""
    if start + logits.shape[-1] <= vocab:
        return logits
    ids = torch.arange(logits.shape[-1], device=logits.device) + start
    return torch.where(ids < vocab, logits, torch.full_like(logits, -1e9))


def token_nll(logits: torch.Tensor, labels: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mean cross-entropy of ``labels`` under ``logits`` (vocab padding
    masked; log-softmax in float32): the LMs' ``loss_fn``.

    On a sharded step (DTensors) it runs on each rank's shards
    (:func:`_token_nll_sharded`): no rank makes a tensor of the global
    logits' shape."""
    if _is_dtensor(logits):
        return _token_nll_sharded(logits, labels, vocab)
    logits = mask_padded_logits(logits, vocab)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0].mean()


class _VocabParallelNLL(torch.autograd.Function):
    """``sum(-log softmax(x)[label]) / n`` over the rows of a rank's shard
    ``x`` of the vocab (global classes ``[start, start + x.shape[-1])``),
    the softmax taken over the whole vocab: the row max, the sum of
    ``exp(x - max)`` and the label's logit (picked by the rank that holds
    it) are reduced over ``group``.  The backward, ``(softmax - onehot) *
    g / n`` on the shard, moves nothing."""

    @staticmethod
    def forward(ctx, logits, labels, vocab, start, n, group):
        from torch.distributed import _functional_collectives as funcol

        def reduce(t, op):
            return funcol.wait_tensor(funcol.all_reduce(t, op, group))

        x = mask_padded_logits(logits.to(torch.float32), vocab, start)
        m = reduce(x.amax(-1), "max")
        s = reduce(torch.exp(x - m[..., None]).sum(-1), "sum")
        idx = labels.long() - start
        inside = (idx >= 0) & (idx < x.shape[-1])
        picked = torch.gather(x, -1, torch.where(inside, idx, 0)[..., None])[..., 0]
        picked = reduce(picked * inside.to(picked.dtype), "sum")
        ctx.save_for_backward(logits, idx, inside, m, s)
        ctx.vocab, ctx.start, ctx.n = vocab, start, n
        return (torch.log(s) + m - picked).sum() / n

    @staticmethod
    def backward(ctx, g):
        logits, idx, inside, m, s = ctx.saved_tensors
        x = mask_padded_logits(logits.to(torch.float32), ctx.vocab, ctx.start)
        p = torch.exp(x - m[..., None]).div_(s[..., None])
        p.scatter_add_(-1, torch.where(inside, idx, 0)[..., None],
                       -inside[..., None].to(p.dtype))
        return p.mul_(g / ctx.n).to(logits.dtype), None, None, None, None, None


def _token_nll_sharded(logits, labels, vocab: int):
    """:func:`token_nll` of DTensor ``logits [B, S, V]`` on each rank's
    shards (``activations.local_shards``), as ``embed_lookup`` gathers:
    the batch split over the data axes, the vocab over "model" where it
    divides it (``_VocabParallelNLL``), else whole (the plain loss on the
    rank's rows).  Each rank's share of the mean (its rows' sum over the
    global token count) is reduced over the data axes."""
    from torch.distributed.tensor import Partial, Replicate

    from repro_torch.runtime import activations as A
    from repro_torch.runtime.sharding import P, axis_names, data_axes, placements

    mesh = logits.device_mesh
    names, da = axis_names(mesh), data_axes(mesh)
    b_ax = da if A.fits(labels.shape[0], da, mesh) else None
    n, v = labels.numel(), logits.shape[-1]
    m = names.index("model") if "model" in names else None
    if m is None or mesh.size(m) == 1 or not A.fits(v, "model", mesh):
        def nll(lg, lb):
            loss = token_nll(lg, lb, vocab)
            return loss if lb.numel() == n else loss * (lb.numel() / n)
        v_ax = None
    else:
        start, group = mesh.get_local_rank(m) * (v // mesh.size(m)), mesh.get_group(m)

        def nll(lg, lb):
            return _VocabParallelNLL.apply(lg, lb, vocab, start, n, group)
        v_ax = "model"
    spec = P(b_ax, *([None] * (logits.dim() - 2)), v_ax)
    out_pl = tuple(Partial() if p.is_shard(0) else Replicate() for p in placements(mesh, spec))
    return A._reduced(A.local_shards(nll, (logits, labels),
                                     (spec, P(b_ax, *([None] * (labels.dim() - 1)))),
                                     out_pl, mesh=mesh))


def mlp_forward(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        return matmul(silu(linear(p["gate"], x)) * linear(p["up"], x), p["down"]["w"])
    return matmul(gelu_f32(linear(p["up"], x)), p["down"]["w"])


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32, device=None, kind: str = "gelu") -> dict:
    """The GELU MLP (up and down projections, with biases) or, for
    ``kind="swiglu"``, the gated MLP (gate, up, down; no biases)."""
    if kind == "swiglu":
        return {
            "gate": init_linear(gen, d_model, d_ff, False, dtype, device),
            "up": init_linear(gen, d_model, d_ff, False, dtype, device),
            "down": init_linear(gen, d_ff, d_model, False, dtype, device),
        }
    return {
        "up": init_linear(gen, d_model, d_ff, True, dtype, device),
        "down": init_linear(gen, d_ff, d_model, True, dtype, device),
    }


def init_qlinear(gen: torch.Generator, d_in: int, d_out: int, bias: bool) -> dict:
    """Shape-only int8 init (weights uniform in [-127, 127], zero bias), on
    ``gen``'s device."""
    p = {"w_q": torch.randint(-127, 128, (d_in, d_out), generator=gen, dtype=torch.int8,
                              device=gen.device)}
    if bias:
        p["b_q"] = torch.zeros((d_out,), dtype=torch.int32, device=gen.device)
    return p


# ---------------------------------------------------------------------------
# Integer ("cluster") helpers
# ---------------------------------------------------------------------------


def norm_apply_i8(kind: str, pq: dict, x_q: torch.Tensor, s_gamma: float, s_out: float):
    if _is_dtensor(x_q):  # each rank's rows, whole (see activations.pointwise_local)
        from repro_torch.runtime.activations import pointwise_local

        keys = sorted(pq)
        return pointwise_local(lambda x, *g: norm_apply_i8(kind, dict(zip(keys, g)), x, s_gamma,
                                                           s_out),
                               x_q, *(pq[k] for k in keys), rows=True)
    if kind == "rmsnorm":
        return iln.irmsnorm_i8(x_q, pq["g_q"], s_gamma, s_out)
    if kind == "np_layernorm":
        return iln.ilayernorm_np_i8(x_q, s_out)
    return iln.ilayernorm_i8(x_q, pq["g_q"], pq["beta_q"], s_gamma, s_out)


def iadd_i8(a_q, b_q, mult_a, shift_a, mult_b, shift_b) -> torch.Tensor:
    """Residual add on a common grid: requant each operand, saturating add."""
    if _is_dtensor(a_q):
        from repro_torch.runtime.activations import pointwise_local

        return pointwise_local(lambda a, b: iadd_i8(a, b, mult_a, shift_a, mult_b, shift_b),
                               a_q, b_q)
    a = requantize_wide(a_q, mult_a, shift_a, out_bits=16)
    b = requantize_wide(b_q, mult_b, shift_b, out_bits=16)
    return torch.clamp(a + b, -128, 127).to(torch.int8)


def make_iadd_params(s_a: float, s_b: float, s_out: float):
    qa = make_qparams(s_a, 1.0, s_out)
    qb = make_qparams(s_b, 1.0, s_out)
    return (qa.mult, qa.shift, qb.mult, qb.shift)


# ---------------------------------------------------------------------------
# Decoder helpers: integer RoPE and SiLU (cluster ops)
# ---------------------------------------------------------------------------

_ROPE_BITS = 7  # Q0.7 trig tables


def _rope_cos_sin_host(positions, head_dim: int, theta: float):
    """float32 ``cos``/``sin`` [..., head_dim // 2] of ``positions``, on the
    CPU, for the integer path's Q0.7 tables.

    The JAX package computes ``theta ** (-arange(half) / half)`` in float32;
    torch's float32 power differs from XLA's in the last bit of a few
    frequencies (3 of 64 at head_dim 128), so the power runs in float64 on
    the float32 exponent and is cast to float32, which gives XLA's
    frequencies.  The angles are float32 products as in the reference, and
    ``cos``/``sin`` are torch's float32 functions on the CPU (CUDA's
    ``sinf``/``cosf`` are another implementation: never build them there).
    """
    half = head_dim // 2
    expo = -torch.arange(0, half, dtype=torch.float32) / half
    freqs = torch.pow(float(theta), expo.to(torch.float64)).to(torch.float32)
    pos = torch.as_tensor(np.asarray(positions)).to(torch.float32)
    ang = pos[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


@functools.lru_cache(maxsize=32)
def _rope_table(n: int, head_dim: int, theta: float, device: torch.device):
    """Q0.7 ``cos``/``sin`` tables of positions ``[0, n)``, int32 [n, half],
    built on the host and moved to ``device`` once per key.  They are
    constants: built outside any dispatch mode (a fake world's tensors or
    an op recorder), so the cache holds real tables."""
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        cos, sin = _rope_cos_sin_host(np.arange(n), head_dim, theta)
        scale = 1 << _ROPE_BITS
        c_q = torch.clamp(torch.round(cos * scale), -127, 127).to(torch.int32)
        s_q = torch.clamp(torch.round(sin * scale), -127, 127).to(torch.int32)
        return c_q.to(device), s_q.to(device)


def rope_tables_i8(positions, head_dim: int, theta: float, device=None):
    """Q0.7 tables [..., head_dim // 2] (int32) of integer ``positions``.

    ``positions`` are host data (an int, a numpy array or a CPU tensor):
    the rows are gathered from a table of every position below the next
    power of two past the largest one, built once per (size, head_dim,
    theta, device) by :func:`_rope_table`.
    """
    pos = np.asarray(positions, dtype=np.int64)
    top = int(pos.max()) + 1 if pos.size else 1
    n = max(64, 1 << (top - 1).bit_length())
    c_tab, s_tab = _rope_table(n, head_dim, float(theta), torch.device(device or "cpu"))
    idx = torch.from_numpy(pos).to(c_tab.device)
    return c_tab[idx], s_tab[idx]


def apply_rope_i8(x_q: torch.Tensor, c_q: torch.Tensor, s_q: torch.Tensor) -> torch.Tensor:
    """Integer rotary embedding (cluster op): Q0.7 rotation, scale preserved.

    ``x_q`` int8 [B, H, S, D]; tables [S, D/2] or broadcastable.  The int32
    ``>>`` is arithmetic (floor), as XLA's, after adding 2^6 to round.
    """
    if _is_dtensor(x_q):
        from repro_torch.runtime.activations import pointwise_local

        return pointwise_local(lambda x: apply_rope_i8(x, c_q, s_q), x_q)
    x = i32(x_q)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = c_q[None, None] if c_q.dim() == 2 else c_q
    s = s_q[None, None] if s_q.dim() == 2 else s_q
    r = 1 << (_ROPE_BITS - 1)
    y1 = (x1 * c - x2 * s + r) >> _ROPE_BITS
    y2 = (x1 * s + x2 * c + r) >> _ROPE_BITS
    return torch.clamp(torch.cat([y1, y2], dim=-1), -128, 127).to(torch.int8)


def isilu_i8(x_q: torch.Tensor, s_in: float, s_out: float) -> torch.Tensor:
    """Integer SiLU (cluster op — ITA's activation unit has no SiLU mode).

    sigma(x) = 2^(x log2 e) / (1 + 2^(x log2 e)) with the ITAMax exp2
    machinery: requantize x onto the log2 grid, exponentiate with the
    8-bit table, one integer division per element (both dividends and the
    divisor are positive, so torch's floor division is the reference's).
    """
    if _is_dtensor(x_q):
        from repro_torch.runtime.activations import pointwise_local

        return pointwise_local(lambda x: isilu_i8(x, s_in, s_out), x_q)
    qp = make_qparams(s_in, 1.0, im.ITAMAX_LOGIT_SCALE)
    v = requantize_wide(x_q, qp.mult, qp.shift, out_bits=14)  # log-grid value
    t = torch.clamp(torch.abs(v), 0, 1 << 13)
    e = im._exp2_int(t, im.exp_lut(v.device), im.EXP_LUT_BITS)  # ~256 * e^-|x|
    denom = 256 + e
    sig_pos = (256 * 256) // denom  # x >= 0 branch, Q8 in [128, 256]
    sig_neg = (256 * e) // denom  # x < 0 branch, Q8 in [0, 128]
    sig = torch.where(v >= 0, sig_pos, sig_neg)
    acc = i32(x_q) * sig  # scale s_in / 256
    qo = make_qparams(s_in, 1.0 / 256.0, s_out)
    return requantize(acc, qo.mult, qo.shift)


#: |int8 x int8| summed over K stays below 2^24 — exact in float32 — while
#: K * 128 * 127 < 2^24, i.e. K <= 1032.
_F32_EXACT_K = (1 << 24) // (128 * 127)


def silu_i8_ref_f32(x: torch.Tensor) -> torch.Tensor:
    return silu(x)


def classifier_f32(h_q: torch.Tensor, table_q: torch.Tensor, scale: float) -> torch.Tensor:
    """Tied MLM head: ``float32(h_q @ table_q.T) * scale``, exact on any device.

    CUDA has no int32 matmul, and the vocabulary (30522) is no multiple of
    8 as ``torch._int_mm`` needs.  The product runs in float32 instead:
    every partial sum is an integer below 2^24 while K <= 1032, so float32
    holds it exactly in any summation order (TF32 too, whose 10-bit
    mantissa holds int8 operands exactly), and the result equals the int32
    accumulator cast to float32.
    """
    k = h_q.shape[-1]
    if k > _F32_EXACT_K:
        raise ValueError(f"K={k} > {_F32_EXACT_K}: float32 no longer holds the int8 dot exactly")
    acc = torch.matmul(h_q.to(torch.float32), table_q.to(torch.float32).T)
    return acc * scale


# ---------------------------------------------------------------------------
# Quantized linear plumbing
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class QLinearSite:
    """Static description of one quantized linear site."""

    s_in: float
    s_w: float
    s_out: float
    act: int = ACT_IDENTITY
    s_preact: float | None = None

    def params(self) -> QLinearParams:
        return make_qlinear_params(self.s_in, self.s_w, self.s_out, self.act, self.s_preact)


def qlinear(pq: dict, x_q: torch.Tensor, site: QLinearSite) -> torch.Tensor:
    return qlinear_i8(x_q, pq["w_q"], pq.get("b_q"), site.params())


def quantize_linear_params(p: dict, s_in: float) -> tuple[dict, float]:
    """Float linear params -> int8 weights (+ int32 bias), per-tensor scale."""
    w_q, s_w = quantize_weight_per_tensor(p["w"])
    s_w = float(s_w)
    out = {"w_q": w_q}
    if "b" in p:
        out["b_q"] = torch.round(p["b"] / (s_in * s_w)).to(torch.int32)
    return out, s_w
