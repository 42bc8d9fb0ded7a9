"""CTC forward vs a NumPy DP oracle and optax.ctc_loss (SURVEY §4 item 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax

from asr_chinese_e2e.ops.ctc import ctc_loss, extend_labels


def numpy_ctc_oracle(log_probs, labels, blank=0):
    """Brute DP in probability space for one short utterance."""
    T, C = log_probs.shape
    probs = np.exp(log_probs)
    ext = [blank]
    for l in labels:
        ext += [l, blank]
    S = len(ext)
    alpha = np.zeros((T, S))
    alpha[0, 0] = probs[0, ext[0]]
    if S > 1:
        alpha[0, 1] = probs[0, ext[1]]
    for t in range(1, T):
        for s in range(S):
            a = alpha[t - 1, s]
            if s >= 1:
                a += alpha[t - 1, s - 1]
            if s >= 2 and ext[s] != blank and ext[s] != ext[s - 2]:
                a += alpha[t - 1, s - 2]
            alpha[t, s] = a * probs[t, ext[s]]
    p = alpha[T - 1, S - 1] + (alpha[T - 1, S - 2] if S > 1 else 0.0)
    return -np.log(p)


def test_extend_labels():
    ext = extend_labels(jnp.asarray([[5, 6, 0]]))
    np.testing.assert_array_equal(
        np.asarray(ext)[0], [0, 5, 0, 6, 0, 0, 0]
    )


def test_ctc_matches_numpy_oracle():
    rng = np.random.RandomState(0)
    T, C = 8, 6
    logits = rng.randn(1, T, C).astype(np.float32)
    labels = np.array([[2, 3, 2]])
    got = ctc_loss(
        jnp.asarray(logits), jnp.asarray([T]), jnp.asarray(labels), jnp.asarray([3])
    )
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits[0]), axis=-1))
    want = numpy_ctc_oracle(lp, [2, 3, 2])
    np.testing.assert_allclose(float(got[0]), want, rtol=1e-5)


def test_ctc_matches_optax_batched():
    rng = np.random.RandomState(1)
    B, T, L, C = 4, 20, 6, 10
    logits = rng.randn(B, T, C).astype(np.float32)
    logit_lens = np.array([20, 17, 12, 20])
    labels = rng.randint(1, C, size=(B, L))
    label_lens = np.array([6, 4, 3, 1])
    for b in range(B):
        labels[b, label_lens[b] :] = 0
    got = ctc_loss(
        jnp.asarray(logits),
        jnp.asarray(logit_lens),
        jnp.asarray(labels),
        jnp.asarray(label_lens),
    )
    logit_pad = (np.arange(T)[None] >= logit_lens[:, None]).astype(np.float32)
    label_pad = (np.arange(L)[None] >= label_lens[:, None]).astype(np.float32)
    want = optax.ctc_loss(
        jnp.asarray(logits), jnp.asarray(logit_pad), jnp.asarray(labels), jnp.asarray(label_pad)
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_ctc_grad_finite_and_matches_optax():
    rng = np.random.RandomState(2)
    B, T, L, C = 2, 12, 4, 8
    logits = rng.randn(B, T, C).astype(np.float32)
    logit_lens = jnp.asarray([12, 9])
    labels = jnp.asarray(rng.randint(1, C, size=(B, L)))
    label_lens = jnp.asarray([4, 2])

    def ours(x):
        return ctc_loss(x, logit_lens, labels, label_lens).sum()

    logit_pad = (np.arange(T)[None] >= np.asarray(logit_lens)[:, None]).astype(np.float32)
    label_pad = (np.arange(L)[None] >= np.asarray(label_lens)[:, None]).astype(np.float32)

    def theirs(x):
        return optax.ctc_loss(
            x, jnp.asarray(logit_pad), labels, jnp.asarray(label_pad)
        ).sum()

    g1 = jax.grad(ours)(jnp.asarray(logits))
    g2 = jax.grad(theirs)(jnp.asarray(logits))
    assert np.isfinite(np.asarray(g1)).all()
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-3, atol=1e-4)


def test_ctc_impossible_alignment_is_large():
    # more labels than frames -> probability ~0 -> huge loss
    logits = jnp.zeros((1, 3, 5))
    loss = ctc_loss(
        logits, jnp.asarray([3]), jnp.asarray([[1, 2, 3, 4]]), jnp.asarray([4])
    )
    assert float(loss[0]) > 1e5
