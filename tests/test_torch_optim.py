"""The port's AdamW (``repro_torch.optim.adamw``) against the JAX package's.

Both packages get the same numpy trees (nested dicts and a list of
per-layer dicts).  Each element runs through the same float32 operations
in the same order, so the updated params and moments agree to float32
rounding: ``F32`` (rtol 2e-6, atol 1e-9); the bias corrections use each
library's ``pow``, which may differ by one ulp.  Gradients in bfloat16
take the clip scale rounded to bfloat16 first (``adamw.py:36``), in both
packages, and agree to the same tolerance against the reference run op by
op; under ``jax.jit`` XLA may keep the scaled bfloat16 gradient in float32
inside its fusion, so the jitted reference is held to one bfloat16
rounding of the gradient instead (``JIT_BF16``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as J
from repro_torch.optim import adamw as T

F32 = dict(rtol=2e-6, atol=1e-9)
SCHED = dict(peak_lr=3e-3, warmup=2, total=6)
#: the jitted reference with bfloat16 gradients: one bfloat16 rounding of g
#: (relative 2^-8) moves m_hat / sqrt(v_hat) by at most about 2^-8 of
#: itself, and AdamW scales it by lr: lr * 2^-8 (1.2e-5 at the peak lr)
JIT_BF16 = dict(rtol=1e-5, atol=SCHED["peak_lr"] * 2 ** -8)


def _tree(rng, scale=1.0, dtype=np.float32):
    leaf = lambda *s: (rng.normal(size=s) * scale).astype(dtype)  # noqa: E731
    return {"a": leaf(16, 8), "nested": {"b": leaf(10)},
            "layers": [{"w": leaf(4, 6), "n": {"g": leaf(6)}} for _ in range(3)]}


def _grads(rng, dtype=np.float32):
    g = _tree(rng, 0.3, dtype)
    g["a"][0, :4] = np.asarray([1e-9, -1e-8, 3e-8, 0.0], dtype)  # near eps, and zero
    return g


def _t(tree, dtype=None):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, copy=True)).to(dtype), tree)


def _j(tree, dtype=None):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _np(tree):
    return jax.tree.map(lambda a: a.float().numpy() if isinstance(a, torch.Tensor)
                        else np.asarray(a, np.float32), tree)


def _close(a, b, tol):
    for x, y in zip(jax.tree.leaves(_np(a)), jax.tree.leaves(_np(b))):
        np.testing.assert_allclose(x, y, **tol)



def _run(grad_dtype, steps=5, jit=False):
    """``steps`` AdamW updates in both packages from the same params and
    gradients (the cosine schedule's lr): yields (port, reference) after
    each step (the port's tensors are updated in place: read them before
    the next step)."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    tp, jp = _t(params), _j(params)
    ts, js = T.init(tp), J.init(jp)
    j_apply = jax.jit(J.apply) if jit else J.apply
    j_sched = functools.partial(J.cosine_schedule, **SCHED)
    for _ in range(steps):
        g = _grads(rng)
        tg = _t(g, torch.bfloat16 if grad_dtype == "bf16" else None)
        jg = _j(g, jnp.bfloat16 if grad_dtype == "bf16" else None)
        tp, ts, tm = T.apply(tg, ts, tp, T.cosine_schedule(ts.step, **SCHED))
        jp, js, jm = j_apply(jg, js, jp, j_sched(js.step))
        yield (tp, ts, tm), (jp, js, jm)


@pytest.mark.parametrize("grad_dtype", ["f32", "bf16"])
def test_apply_matches_reference_op_by_op(grad_dtype):
    for (tp, ts, tm), (jp, js, jm) in _run(grad_dtype):
        assert int(ts.step) == int(js.step)
        _close(tp, jp, F32)
        _close(ts.mu, js.mu, F32)
        _close(ts.nu, js.nu, F32)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)


@pytest.mark.parametrize("grad_dtype", ["f32", "bf16"])
def test_apply_matches_jitted_reference(grad_dtype):
    tol = F32 if grad_dtype == "f32" else JIT_BF16
    for (tp, ts, tm), (jp, js, jm) in _run(grad_dtype, steps=3, jit=True):
        _close(tp, jp, tol)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)


def test_apply_updates_in_place_and_returns_the_same_tensors():
    rng = np.random.default_rng(1)
    params = _t(_tree(rng))
    state = T.init(params)
    leaves = [params["a"], params["layers"][1]["w"], state.mu["a"], state.nu["nested"]["b"]]
    before = params["a"].clone()
    p2, s2, _ = T.apply(_t(_grads(rng)), state, params, 1e-2)
    assert p2 is params and s2.mu is state.mu and s2.step is state.step
    assert [p2["a"], p2["layers"][1]["w"], s2.mu["a"], s2.nu["nested"]["b"]] == leaves
    assert int(s2.step) == 1 and not torch.equal(p2["a"], before)


def test_first_step_at_lr_zero_moves_only_the_moments():
    """``cosine_schedule(0)`` is 0, so ``main``'s first step changes no param."""
    rng = np.random.default_rng(2)
    params = _t(_tree(rng))
    before = [t.clone() for t in jax.tree.leaves(params)]
    state = T.init(params)
    lr = T.cosine_schedule(state.step, peak_lr=3e-4, warmup=10, total=20)
    assert float(lr) == 0.0
    T.apply(_t(_grads(rng)), state, params, lr)
    assert all(torch.equal(a, b) for a, b in zip(before, jax.tree.leaves(params)))
    assert float(state.mu["a"].abs().max()) > 0


@pytest.mark.parametrize("grad_dtype", ["f32", "bf16"])
def test_clip_and_global_norm(grad_dtype):
    rng = np.random.default_rng(3)
    g = _tree(rng, 50.0)
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if grad_dtype == "bf16" else (None, None)
    tg, tn = T.clip_by_global_norm(_t(g, tdt), 1.0)
    jg, jn = J.clip_by_global_norm(_j(g, jdt), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(T.global_norm(_t(g))), float(J.global_norm(_j(g))),
                               rtol=1e-6)
    # the scale may differ in its last bit (each library sums in its own
    # order): one float32, or one bfloat16, rounding of the clipped value
    rtol = 2 ** -8 if grad_dtype == "bf16" else 2e-6
    for a, b in zip(jax.tree.leaves(tg), jax.tree.leaves(jg)):
        assert a.dtype == (tdt or torch.float32)
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), rtol=rtol)
    # below the limit the scale is 1: the gradients come back unchanged
    small = _t(_tree(rng, 1e-4))
    same, _ = T.clip_by_global_norm(small, 1.0)
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(same), jax.tree.leaves(small)))


def test_cosine_schedule_matches_reference():
    steps = np.arange(0, 40, dtype=np.int32)
    kw = dict(peak_lr=3e-4, warmup=10, total=30, floor=0.1)
    got = T.cosine_schedule(torch.from_numpy(steps), **kw).numpy()
    want = np.asarray(J.cosine_schedule(jnp.asarray(steps), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == 0.0 and got.dtype == np.float32


def test_init_layout_matches_reference():
    params = _tree(np.random.default_rng(4))
    ts, js = T.init(_t(params)), J.init(_j(params))
    assert ts._fields == js._fields == ("step", "mu", "nu")
    assert ts.step.dtype == torch.int32 and ts.step.shape == () and int(ts.step) == 0
    assert jax.tree.structure(_np(ts.mu)) == jax.tree.structure(js.mu)
    assert all(t.dtype == torch.float32 and not t.any() for t in jax.tree.leaves(ts.nu))
    assert ts.mu["a"] is not ts.nu["a"]


class TestAdamW:
    """The JAX package's ``tests/test_substrates.py::TestAdamW``, spelled for the port."""

    def test_descends_quadratic(self):
        params = {"w": torch.tensor([5.0, -3.0])}
        state = T.init(params)
        for _ in range(200):
            grads = {"w": 2 * params["w"]}
            params, state, m = T.apply(grads, state, params, lr=0.1, weight_decay=0.0)
        assert float(params["w"].abs().max()) < 0.2

    def test_grad_clipping(self):
        g, norm = T.clip_by_global_norm({"w": torch.full((4,), 100.0)}, 1.0)
        assert float(norm) > 100
        assert abs(float(T.global_norm(g)) - 1.0) < 1e-5
