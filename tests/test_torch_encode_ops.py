"""The port's encode-side elementary ops against the JAX package's, on the
same numpy inputs made from a seed: the Laplace CDF, the rate proxy (with
its 2^-16 floor), softround, the Kumaraswamy noise map, the five quantizer
types and the causal spatial context. Values and gradients (jax.grad
against autograd) agree within 1e-5: |port - jax| <= 1e-5 * (|jax| +
max(1, max |jax|)) per tensor, the largest magnitude standing for the
tensor's scale. Where the Laplace probability of a symbol is tiny, both
packages take the difference of two CDF values near 1 in f32 (and the
derivative of expm1 as expm1 + 1), so one ulp of expm1 moves the rate by
up to 4 ulp(1) / (p ln 2) bits: those far-tail symbols (over 10 bits) are
held to that bound instead. The spatial context is an exact copy of input
values, so it is held to exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coolchic_tpu.core import laplace as jl
from coolchic_tpu.core import quantizer as jq
from coolchic_tpu.ops.context import spatial_context as j_ctx
from coolchic_tpu.ops.context import spatial_context_slices as j_ctx_slices
from coolchic_tpu_torch.core import laplace as pl
from coolchic_tpu_torch.core import quantizer as pq
from coolchic_tpu_torch.ops.context import spatial_context as p_ctx

torch.set_num_threads(2)
TOL = 1e-5


def _inputs(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 6, n).astype(np.float32)
    x[:64] = np.round(x[:64])                       # integer symbols
    mu = (x + rng.normal(0, 2, n)).astype(np.float32)
    mu[64:96] = x[64:96]                            # x == mu exactly
    scale = np.exp(rng.uniform(-5, 5, n)).astype(np.float32)
    scale[96:160] = np.float32(np.exp(-5.0))        # very peaked: hits MIN_PROBA
    return x, mu, scale


def _torch_grad(fn, *arrays):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    grads = torch.autograd.grad(out.sum(), ts, allow_unused=True)
    return out.detach().numpy(), [np.zeros_like(a) if g is None else g.numpy()
                                  for a, g in zip(arrays, grads)]


def _jax_grad(fn, *arrays):
    out = np.asarray(fn(*map(jnp.asarray, arrays)))
    grads = jax.grad(lambda *a: fn(*a).sum(), argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    return out, [np.asarray(g) for g in grads]


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * max(1.0, float(np.abs(b).max())))


def _assert_close(port, ref, tol=TOL):
    (pv, pg), (jv, jg) = port, ref
    _close(pv, jv, tol)
    for a, b in zip(pg, jg):
        _close(a, b, tol)


def test_laplace_cdf():
    x, mu, scale = _inputs(1)
    _assert_close(_torch_grad(pl.laplace_cdf, x, mu, scale),
                  _jax_grad(jl.laplace_cdf, x, mu, scale))


def test_rate_bits_and_floor():
    x, mu, scale = _inputs(2)
    port = _torch_grad(pl.rate_bits, x, mu, scale)
    ref = _jax_grad(jl.rate_bits, x, mu, scale)
    assert (ref[0] >= 16.0 - 1e-6).sum() > 0, "no symbol reaches the 2^-16 floor"
    body = ref[0] <= 10.0
    _close(port[0][body], ref[0][body])
    for a, b in zip(port[1], ref[1]):
        _close(a[body], b[body])
    tail_bound = 4 * 2.0**-24 / (2.0 ** -ref[0][~body] * np.log(2))
    assert (np.abs(port[0][~body] - ref[0][~body]) <= tail_bound).all()


def test_rate_bits_tie_gradient_is_split():
    """At proba == MIN_PROBA exactly both packages give half the gradient
    to each side of the max (torch.maximum, as jnp.maximum)."""
    p = np.float32(2.0**-16)
    tp = torch.tensor(p, requires_grad=True)
    torch.maximum(tp, tp.new_tensor(2.0**-16)).backward()
    jg = jax.grad(lambda v: jnp.maximum(v, 2.0**-16))(jnp.float32(p))
    assert float(tp.grad) == float(jg) == 0.5


@pytest.mark.parametrize("t", [0.35, 0.08, 1e-4])
def test_softround(t):
    x, _, _ = _inputs(3)
    x = x / 3
    _assert_close(_torch_grad(lambda a: pq.softround(a, t), x),
                  _jax_grad(lambda a: jq.softround(a, t), x))


@pytest.mark.parametrize("a", [1.0, 2.0, 3.7])
def test_kumaraswamy_noise(a):
    u = np.random.default_rng(4).uniform(0.0, 1.0, 4096).astype(np.float32)
    _assert_close(_torch_grad(lambda v: pq.kumaraswamy_noise(v, a), u),
                  _jax_grad(lambda v: jq.kumaraswamy_noise(v, a), u), tol=1e-4)


@pytest.mark.parametrize("qtype", list(jq.QUANTIZER_TYPES))
def test_quantize(qtype):
    rng = np.random.default_rng(5)
    x = rng.normal(0, 4, 4096).astype(np.float32)
    x[:32] = np.arange(-16, 16) + 0.5               # half-way: round half to even
    noise = rng.normal(0, 0.22, 4096).astype(np.float32)
    kw = dict(quantizer_type=qtype, soft_round_temperature=0.3)
    port = _torch_grad(lambda a, n: pq.quantize(a, noise=n, **kw), x, noise)
    ref = _jax_grad(lambda a, n: jq.quantize(a, noise=n, **kw), x, noise)
    if qtype in ("hardround", "ste"):
        np.testing.assert_array_equal(port[0], ref[0])
    _assert_close(port, ref)


@pytest.mark.parametrize("n_ctx", [6, 14, 20])
def test_spatial_context(n_ctx):
    grid = np.random.default_rng(6).integers(-40, 40, (3, 37, 53)).astype(np.float32)
    got = p_ctx(torch.tensor(grid), n_ctx).numpy()
    assert got.shape == (3, 37 * 53, n_ctx)
    for g in range(3):
        np.testing.assert_array_equal(got[g], np.asarray(j_ctx(jnp.asarray(grid[g]), n_ctx)))
        np.testing.assert_array_equal(got[g], np.asarray(j_ctx_slices(jnp.asarray(grid[g]),
                                                                      n_ctx)))
