"""The XLA attention path (``layers.attend`` and the hash dropout mask)
against float64 NumPy oracles: padding, causal, rectangular cross and
banded patterns, gradients, bf16 inputs and dropout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asr_chinese_e2e.models.layers import attend, hash_keep_mask
from asr_chinese_e2e.ops.masks import (
    banded_bias,
    causal_banded_bias,
    causal_padding_bias,
    padding_bias,
)


def make(seed=0, B=2, Tq=12, Tk=12, H=2, D=8):
    rng = np.random.RandomState(seed)
    mk = lambda t: rng.randn(B, t, H, D).astype(np.float32)
    return mk(Tq), mk(Tk), mk(Tk)


def oracle(q, k, v, bias, mask=None):
    """(out, softmax weights) in float64; ``mask`` multiplies the weights
    (dropout) before the value product."""
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if bias is not None:
        s = s + np.asarray(bias, np.float64)
    s = s - s.max(-1, keepdims=True)
    w = np.exp(s)
    w = w / w.sum(-1, keepdims=True)
    wd = w if mask is None else w * mask
    return np.einsum("bhqk,bkhd->bqhd", wd, v), w


def oracle_grads(q, k, v, bias, cot, mask=None):
    """Analytic float64 grads of sum(out * cot) w.r.t. (q, k, v)."""
    q64, k64, v64 = (np.asarray(a, np.float64) for a in (q, k, v))
    _, w = oracle(q, k, v, bias)
    m = np.ones_like(w) if mask is None else mask
    g = np.asarray(cot, np.float64)
    dv = np.einsum("bhqk,bqhd->bkhd", w * m, g)
    dw = np.einsum("bqhd,bkhd->bhqk", g, v64) * m
    ds = w * (dw - (dw * w).sum(-1, keepdims=True))
    scale = 1.0 / np.sqrt(q.shape[-1])
    dq = np.einsum("bhqk,bkhd->bqhd", ds, k64) * scale
    dk = np.einsum("bhqk,bqhd->bkhd", ds, q64) * scale
    return dq, dk, dv


def live_rows(bias, shape):
    """(B, Tq, 1, 1) 1.0 where a query row can attend at least one key:
    rows with every key masked are padding, and float32 rounds their
    -1e9-biased scores differently from float64."""
    b = np.broadcast_to(np.asarray(bias), (shape[0], 1, shape[1], bias.shape[-1]))
    return (b.max(-1) > -1e8).transpose(0, 2, 1)[..., None].astype(np.float32)


LENS = jnp.asarray([12, 7])
BIASES = {
    "padding": lambda t: padding_bias(LENS, t),
    "causal": lambda t: causal_padding_bias(LENS, t),
    "banded": lambda t: padding_bias(LENS, t) + banded_bias(t, 3),
    "causal_banded": lambda t: padding_bias(LENS, t) + causal_banded_bias(t, 4),
}


@pytest.mark.parametrize("pattern", sorted(BIASES))
def test_forward_matches_oracle(pattern):
    q, k, v = make()
    bias = BIASES[pattern](12)
    got = attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias, jnp.float32)
    want, _ = oracle(q, k, v, bias)
    live = live_rows(bias, q.shape)
    np.testing.assert_allclose(
        np.asarray(got) * live, want * live, rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize("pattern", ["padding", "causal_banded"])
def test_grads_match_oracle(pattern):
    q, k, v = make(seed=1)
    bias = BIASES[pattern](12)
    cot = np.random.RandomState(2).randn(*q.shape).astype(np.float32)
    cot = cot * live_rows(bias, q.shape)

    def f(q, k, v):
        return jnp.sum(attend(q, k, v, bias, jnp.float32) * cot)

    got = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for g, w in zip(got, oracle_grads(q, k, v, bias, cot)):
        np.testing.assert_allclose(np.asarray(g), w, rtol=1e-4, atol=1e-5)


def test_rectangular_cross_attention():
    """Decoder cross-attention: Tq target positions over Tk encoder frames
    with the keys masked by encoder length."""
    q, k, v = make(seed=3, Tq=5, Tk=12)
    bias = padding_bias(LENS, 12)
    got = attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias, jnp.float32)
    want, w = oracle(q, k, v, bias)
    assert got.shape == (2, 5, 2, 8)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)
    assert w[1, :, :, 7:].max() < 1e-12  # padded keys get no weight


def test_bf16_inputs():
    q, k, v = make(seed=4)
    bias = BIASES["padding"](12)
    args = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    got = attend(*args, bias, jnp.bfloat16)
    assert got.dtype == jnp.bfloat16
    want, _ = oracle(q, k, v, bias)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=5e-2)


def host_keep_mask(seed, shape, rate):
    """NumPy replica of ``hash_keep_mask``."""
    i = np.arange(int(np.prod(shape)), dtype=np.uint64).reshape(shape)
    m = lambda a, b: (a * np.uint64(b)) & np.uint64(0xFFFFFFFF)
    h = m(i, 0x9E3779B9) ^ m(np.uint64(seed), 0xC2B2AE35)
    h = h ^ (h >> np.uint64(16))
    h = m(h, 0x85EBCA6B)
    h = h ^ (h >> np.uint64(13))
    h = m(h, 0xC2B2AE35)
    h = h ^ (h >> np.uint64(16))
    thr = int(rate * (1 << 32))
    return (h >= thr).astype(np.float64) / (1.0 - rate)


def test_hash_mask_matches_host_replica_and_keep_rate():
    shape, rate = (2, 2, 12, 12), 0.3
    got = np.asarray(hash_keep_mask(jnp.uint32(12345), shape, rate, jnp.float32))
    want = host_keep_mask(12345, shape, rate)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    big = np.asarray(hash_keep_mask(jnp.uint32(7), (256, 256), rate, jnp.float32))
    assert abs((big > 0).mean() - (1 - rate)) < 0.01


def test_hash_dropout_deterministic_per_seed():
    shape = (2, 2, 12, 12)
    a = hash_keep_mask(jnp.uint32(5), shape, 0.25, jnp.float32)
    b = hash_keep_mask(jnp.uint32(5), shape, 0.25, jnp.float32)
    c = hash_keep_mask(jnp.uint32(6), shape, 0.25, jnp.float32)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not np.array_equal(np.asarray(a), np.asarray(c))


def test_weight_dropout_grads_match_host_mask_oracle():
    """Hash dropout on the attention weights: forward and gradients equal
    the float64 oracle with the same mask built on the host."""
    q, k, v = make(seed=5)
    bias = BIASES["padding"](12)
    rate, seed = 0.2, 99
    mask = host_keep_mask(seed, (2, 2, 12, 12), rate)
    drop = lambda w: w * hash_keep_mask(jnp.uint32(seed), w.shape, rate, w.dtype)
    cot = np.random.RandomState(6).randn(*q.shape).astype(np.float32)
    args = tuple(jnp.asarray(a) for a in (q, k, v))
    out = attend(*args, bias, jnp.float32, drop)
    want, _ = oracle(q, k, v, bias, mask)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-5, atol=1e-5)

    def f(q, k, v):
        return jnp.sum(attend(q, k, v, bias, jnp.float32, drop) * cot)

    got = jax.grad(f, argnums=(0, 1, 2))(*args)
    for g, w in zip(got, oracle_grads(q, k, v, bias, cot, mask)):
        np.testing.assert_allclose(np.asarray(g), w, rtol=1e-4, atol=1e-5)
