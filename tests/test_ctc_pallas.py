"""Pallas CTC kernel vs the scan implementation and optax (values + grads).

The CPU tests run the kernels in the Pallas interpreter (``interpret=True``);
the ``gpu`` tests compile them for the card at the flagship shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from asr_chinese_e2e.losses import model_loss, resolve_ctc_impl
from asr_chinese_e2e.ops.ctc import ctc_loss
from asr_chinese_e2e.ops.ctc_pallas import (
    ctc_loss_kernel,
    ctc_loss_pallas,
    padded_width,
)


def ctc_oracle(logits, logit_lens, labels, label_lens):
    """Float64 NumPy forward-backward: per-utterance NLL and the gradient
    of their sum w.r.t. the logits (softmax minus label posteriors)."""
    x = np.asarray(logits, np.float64)
    logp = x - np.logaddexp.reduce(x, axis=-1, keepdims=True)
    bsz, t_max, _ = x.shape
    loss, grad = np.zeros(bsz), np.zeros_like(x)
    for b in range(bsz):
        n, ln = int(logit_lens[b]), int(label_lens[b])
        ext = np.zeros(2 * ln + 1, np.int64)
        ext[1::2] = np.asarray(labels[b][:ln])
        s = len(ext)
        skip = np.zeros(s, bool)
        skip[2:] = (ext[2:] != 0) & (ext[2:] != ext[:-2])
        e = logp[b, :n][:, ext]  # (n, S)
        alpha = np.full((n, s), -np.inf)
        beta = np.full((n, s), -np.inf)
        right = lambda a, k: np.concatenate([np.full(k, -np.inf), a])[:s]
        left = lambda a, k: np.concatenate([a, np.full(k, -np.inf)])[k:]
        alpha[0, : min(2, s)] = e[0, : min(2, s)]
        for t in range(1, n):
            a = alpha[t - 1]
            prev = np.logaddexp(a, right(a, 1))
            alpha[t] = np.where(skip, np.logaddexp(prev, right(a, 2)), prev) + e[t]
        beta[n - 1, max(s - 2, 0):] = e[n - 1, max(s - 2, 0):]
        for t in range(n - 2, -1, -1):
            nb = beta[t + 1]
            nxt = np.logaddexp(nb, left(nb, 1))
            skip_src = left(np.where(skip, nb, -np.inf), 2)
            beta[t] = np.logaddexp(nxt, skip_src) + e[t]
        logz = np.logaddexp.reduce(alpha[n - 1, max(s - 2, 0):])
        loss[b] = -logz
        post = np.exp(alpha + beta - e - logz)  # (n, S)
        grad[b, :n] = np.exp(logp[b, :n])
        for j, c in enumerate(ext):
            grad[b, :n, c] -= post[:, j]
    return loss, grad


def kernel(logits, logit_lens, labels, ll):
    return ctc_loss_pallas(logits, logit_lens, labels, ll, 0, True)


def make_case(seed, B=4, T=20, L=6, C=10, lens=None, label_lens=None, scale=1.0):
    rng = np.random.RandomState(seed)
    logits = jnp.asarray(rng.randn(B, T, C).astype(np.float32) * scale)
    logit_lens = jnp.asarray(lens if lens is not None else [T] * B)
    ll = label_lens if label_lens is not None else [L] * B
    labels = rng.randint(1, C, size=(B, L))
    for b in range(B):
        labels[b, ll[b] :] = 0
    return logits, logit_lens, jnp.asarray(labels), jnp.asarray(ll)


@pytest.mark.parametrize(
    "lens,label_lens",
    [
        (None, None),
        ([20, 17, 12, 9], [6, 4, 3, 1]),
        ([20, 20, 20, 20], [6, 6, 1, 2]),
    ],
)
def test_pallas_ctc_matches_scan(lens, label_lens):
    logits, logit_lens, labels, ll = make_case(0, lens=lens, label_lens=label_lens)
    got = kernel(logits, logit_lens, labels, ll)
    want = ctc_loss(logits, logit_lens, labels, ll)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4)


def test_pallas_ctc_grad_matches_optax():
    logits, logit_lens, labels, ll = make_case(
        1, lens=[20, 15, 20, 11], label_lens=[5, 3, 6, 2]
    )
    B, T, L = 4, 20, 6
    logit_pad = (np.arange(T)[None] >= np.asarray(logit_lens)[:, None]).astype(
        np.float32
    )
    label_pad = (np.arange(L)[None] >= np.asarray(ll)[:, None]).astype(np.float32)

    def ours(x):
        return kernel(x, logit_lens, labels, ll).sum()

    def theirs(x):
        return optax.ctc_loss(
            x, jnp.asarray(logit_pad), labels, jnp.asarray(label_pad)
        ).sum()

    v1, g1 = jax.value_and_grad(ours)(logits)
    v2, g2 = jax.value_and_grad(theirs)(logits)
    np.testing.assert_allclose(float(v1), float(v2), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-3, atol=1e-4)


def test_pallas_ctc_weighted_cotangent():
    logits, logit_lens, labels, ll = make_case(2)
    w = jnp.asarray([1.0, 0.5, 2.0, 0.0])

    def weighted(x):
        return (kernel(x, logit_lens, labels, ll) * w).sum()

    def weighted_ref(x):
        return (ctc_loss(x, logit_lens, labels, ll) * w).sum()

    g1 = jax.grad(weighted)(logits)
    g2 = jax.grad(weighted_ref)(logits)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-3, atol=1e-4)


def test_pallas_ctc_odd_shapes():
    # batch and S far from any power of two
    logits, logit_lens, labels, ll = make_case(3, B=3, T=7, L=2, C=5)
    got = kernel(logits, logit_lens, labels, ll)
    want = ctc_loss(logits, logit_lens, labels, ll)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4)


def test_pallas_ctc_under_jit_and_vjp_composition():
    logits, logit_lens, labels, ll = make_case(4)

    @jax.jit
    def f(x):
        return kernel(x * 2.0, logit_lens, labels, ll).mean()

    @jax.jit
    def f_ref(x):
        return ctc_loss(x * 2.0, logit_lens, labels, ll).mean()

    g1 = jax.grad(f)(logits)
    g2 = jax.grad(f_ref)(logits)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-3, atol=1e-4)


def test_bf16_logits_select_exactly():
    """The emission-selection einsum (one-hot matmul at HIGHEST precision)
    equals log_softmax(logits.astype(f32)) gathered at the label —
    bit-for-bit, with no f32 (B, T, C) log-prob materialization. Pin that
    equivalence, including the log-zero padding of the extra lanes."""
    from asr_chinese_e2e.ops.ctc import BIG_NEG, extend_labels
    from asr_chinese_e2e.ops.ctc_pallas import _emissions

    logits, logit_lens, labels, ll = make_case(9, B=2, T=6, L=2, C=7)
    logits = logits.astype(jnp.bfloat16)
    emit, _, _ = _emissions(logits, labels, 0)  # (B, T, Sp)
    x32 = logits.astype(jnp.float32)
    lse = jax.scipy.special.logsumexp(x32, axis=-1)  # (B, T)
    ext = extend_labels(labels, 0)  # (B, S)
    want = (
        jnp.take_along_axis(
            x32, ext[:, None, :].repeat(x32.shape[1], 1), axis=-1
        )
        - lse[:, :, None]
    )  # (B, T, S) — same association as the implementation
    s = want.shape[2]
    assert emit.shape[2] == padded_width(s)
    np.testing.assert_array_equal(np.asarray(emit[:, :, :s]), np.asarray(want))
    assert (np.asarray(emit[:, :, s:]) == BIG_NEG).all()


def test_oracle_matches_optax():
    logits, logit_lens, labels, ll = make_case(
        12, lens=[20, 15, 20, 11], label_lens=[5, 3, 6, 0]
    )
    loss, grad = ctc_oracle(logits, logit_lens, labels, ll)
    T, L = 20, 6
    logit_pad = jnp.asarray(np.arange(T)[None] >= np.asarray(logit_lens)[:, None], jnp.float32)
    label_pad = jnp.asarray(np.arange(L)[None] >= np.asarray(ll)[:, None], jnp.float32)
    f = lambda x: optax.ctc_loss(x, logit_pad, labels, label_pad)
    np.testing.assert_allclose(np.asarray(f(logits)), loss, rtol=1e-5)
    g = jax.grad(lambda x: f(x).sum())(logits)
    np.testing.assert_allclose(np.asarray(g), grad, atol=1e-5)


def test_pallas_ctc_grads_exact_at_long_t():
    """Per-frame posterior normalization keeps the kernel's gradient exact
    where alpha + beta - log p would cancel large numbers: T=200 frames of
    peaky logits put |log p| in the hundreds. The float64 oracle judges
    (the scan's autodiff itself drifts ~2e-4 here)."""
    logits, logit_lens, labels, ll = make_case(
        5, B=2, T=200, L=12, C=40, lens=[200, 170], label_lens=[12, 7],
        scale=4.0,
    )
    want_loss, want_grad = ctc_oracle(logits, logit_lens, labels, ll)
    f = lambda x: kernel(x, logit_lens, labels, ll)
    g = jax.grad(lambda x: f(x).sum())(logits)
    assert want_loss.min() > 500.0
    np.testing.assert_allclose(np.asarray(f(logits)), want_loss, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g), want_grad, atol=2e-5)


@pytest.mark.parametrize("s,want", [(1, 32), (13, 32), (33, 64), (41, 64), (129, 256)])
def test_padded_width_is_pow2_at_least_a_warp(s, want):
    assert padded_width(s) == want


def test_ctc_route_resolution_is_explicit():
    """'auto' resolves by backend; a named route that cannot run here
    raises instead of falling back to the interpreter or the scan."""
    assert resolve_ctc_impl("auto") == "scan"  # tests run on the CPU
    assert resolve_ctc_impl("scan") == "scan"
    assert resolve_ctc_impl("pallas_interpret") == "pallas_interpret"
    with pytest.raises(ValueError, match="needs a GPU"):
        resolve_ctc_impl("pallas")
    with pytest.raises(ValueError, match="unknown ctc_impl"):
        resolve_ctc_impl("fused")
    logits, logit_lens, labels, ll = make_case(6)
    with pytest.raises(ValueError, match="GPU only"):
        ctc_loss_pallas(logits, logit_lens, labels, ll)


def test_model_loss_kernel_route_matches_scan():
    logits, logit_lens, labels, ll = make_case(7, lens=[20, 18, 16, 20])
    out = {"ctc_logits": logits, "enc_lengths": logit_lens}
    got, m1 = model_loss(out, labels, ll, 1.0, 0.0, "pallas_interpret")
    want, m2 = model_loss(out, labels, ll, 1.0, 0.0, "scan")
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(m1["ctc_loss"]), float(m2["ctc_loss"]), rtol=1e-5)


def test_kernel_sharded_over_active_mesh_matches_unsharded():
    """Under an active mesh the kernel runs per data shard (shard_map);
    values and grads equal the single-device call."""
    from asr_chinese_e2e.parallel.context import active_mesh
    from asr_chinese_e2e.parallel.sharding import make_mesh

    logits, logit_lens, labels, ll = make_case(
        8, B=8, lens=[20, 19, 18, 17, 16, 15, 14, 13],
        label_lens=[6, 5, 4, 3, 2, 1, 6, 5],
    )
    f = lambda x: ctc_loss_kernel(x, logit_lens, labels, ll, 0, True).sum()
    want_v, want_g = jax.value_and_grad(f)(logits)
    with active_mesh(make_mesh(data=4, devices=jax.devices()[:4])):
        got_v, got_g = jax.jit(jax.value_and_grad(f))(logits)
    np.testing.assert_allclose(float(got_v), float(want_v), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(got_g), np.asarray(want_g), atol=1e-6)


# -- on the card, at the flagship shapes ---------------------------------------
# B=64 utterances of 8 s: T=267 frames after LFR, vocabulary C=4233, labels up
# to L=20 (an AISHELL sentence) and L=64. The reference is the float64 NumPy
# oracle. Tolerances: the loss agrees to 1e-5 relative (float32 rounding
# over ~267 sequential log-add steps); gradient entries, which lie in
# [-1, 1], agree to 1e-4 absolute (float32 logits) or 1e-2 (bf16 logits,
# whose cotangent rounds to 2^-8 relative).


# (label length, logits dtype) -> (loss relative, gradient absolute) bound
FLAGSHIP_TOLERANCES = {
    (20, "float32"): (1e-5, 1e-4),
    (64, "float32"): (1e-5, 1e-4),
    (20, "bfloat16"): (1e-5, 1e-2),
}


def flagship_case(L, dtype):
    logits, _, labels, _ = make_case(10, B=64, T=267, L=L, C=4233, scale=3.0)
    rng = np.random.RandomState(11)
    lens = jnp.asarray(rng.randint(200, 268, size=64))
    ll = jnp.asarray(rng.randint(L // 2, L + 1, size=64))
    labels = jnp.where(jnp.arange(L)[None] < ll[:, None], labels, 0)
    return logits.astype(dtype), lens, labels, ll


def flagship_errors(L, dtype):
    """(loss max relative error, grad max absolute error) of the compiled
    kernel against the float64 oracle."""
    x, lens, labels, ll = flagship_case(L, dtype)
    f = jax.jit(lambda x: ctc_loss_pallas(x, lens, labels, ll))
    g = jax.jit(jax.grad(lambda x: ctc_loss_pallas(x, lens, labels, ll).sum()))
    want_loss, want_grad = ctc_oracle(
        np.asarray(x.astype(jnp.float32)), lens, labels, ll
    )
    rel = float(np.max(np.abs(np.asarray(f(x)) - want_loss) / want_loss))
    gerr = float(np.max(np.abs(np.asarray(g(x).astype(jnp.float32)) - want_grad)))
    return rel, gerr


@pytest.mark.gpu
@pytest.mark.parametrize("L,dtype", sorted(FLAGSHIP_TOLERANCES))
def test_kernel_on_gpu_matches_oracle_at_flagship_shapes(L, dtype):
    rel, gerr = flagship_errors(L, jnp.dtype(dtype))
    rel_tol, grad_tol = FLAGSHIP_TOLERANCES[(L, dtype)]
    assert rel < rel_tol, rel
    assert gerr < grad_tol, gerr
