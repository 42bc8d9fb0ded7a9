"""Smoothed CE vs a hand-rolled torch-semantics oracle (SURVEY §4 item 1)."""

import jax.numpy as jnp
import numpy as np

from asr_chinese_e2e.losses import hybrid_loss, smoothed_cross_entropy


def oracle_ce(logits, gold, smoothing):
    """Reference formula (Predictor/Utils/loss.py:26-51) in NumPy."""
    n, c = logits.shape
    x = logits - logits.max(axis=1, keepdims=True)
    log_prb = x - np.log(np.exp(x).sum(axis=1, keepdims=True))
    mask = gold != 0
    if smoothing > 0:
        eps = smoothing
        one_hot = np.zeros_like(logits)
        safe = np.where(mask, gold, 0)
        one_hot[np.arange(n), safe] = 1.0
        one_hot = one_hot * (1 - eps) + (1 - one_hot) * eps / c
        loss = -(one_hot * log_prb).sum(axis=1)
        return loss[mask].sum() / mask.sum()
    nll = -log_prb[np.arange(n), np.where(mask, gold, 0)]
    return nll[mask].sum() / mask.sum()


def make_case(seed=0, B=3, T=5, C=7):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, T, C).astype(np.float32)
    gold = rng.randint(1, C, size=(B, T))
    gold[0, 3:] = 0  # PAD tail
    gold[1, 4:] = 0
    return logits, gold


def test_ce_no_smoothing_matches_oracle():
    logits, gold = make_case()
    loss, _ = smoothed_cross_entropy(jnp.asarray(logits), jnp.asarray(gold), 0.0)
    want = oracle_ce(logits.reshape(-1, 7), gold.reshape(-1), 0.0)
    np.testing.assert_allclose(float(loss), want, rtol=1e-5)


def test_ce_smoothing_matches_reference_formula():
    logits, gold = make_case(seed=1)
    loss, _ = smoothed_cross_entropy(jnp.asarray(logits), jnp.asarray(gold), 0.1)
    want = oracle_ce(logits.reshape(-1, 7), gold.reshape(-1), 0.1)
    np.testing.assert_allclose(float(loss), want, rtol=1e-5)


def test_n_correct_counts_non_pad_only():
    logits = np.full((1, 3, 4), -10.0, dtype=np.float32)
    logits[0, 0, 2] = 10.0  # predicts 2
    logits[0, 1, 1] = 10.0  # predicts 1
    logits[0, 2, 3] = 10.0  # predicts 3 but target is PAD
    gold = np.array([[2, 3, 0]])
    _, n_correct = smoothed_cross_entropy(jnp.asarray(logits), jnp.asarray(gold), 0.0)
    assert int(n_correct) == 1


def test_hybrid_loss_interpolates():
    logits, gold = make_case(seed=2)
    ctc_logits = np.random.RandomState(3).randn(3, 10, 7).astype(np.float32)
    labels = np.array([[2, 3, 0], [4, 0, 0], [5, 6, 1]])
    kwargs = dict(
        ce_logits=jnp.asarray(logits),
        ce_targets=jnp.asarray(gold),
        ctc_logits=jnp.asarray(ctc_logits),
        ctc_logit_lengths=jnp.asarray([10, 8, 10]),
        ctc_labels=jnp.asarray(labels),
        ctc_label_lengths=jnp.asarray([2, 1, 3]),
    )
    l0, m0 = hybrid_loss(ctc_weight=0.0, **kwargs)
    l3, m3 = hybrid_loss(ctc_weight=0.3, **kwargs)
    l1, m1 = hybrid_loss(ctc_weight=1.0, **kwargs)
    np.testing.assert_allclose(float(l0), float(m0["ce_loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(l1), float(m1["ctc_loss"]), rtol=1e-6)
    np.testing.assert_allclose(
        float(l3),
        0.3 * float(m3["ctc_loss"]) + 0.7 * float(m3["ce_loss"]),
        rtol=1e-6,
    )
