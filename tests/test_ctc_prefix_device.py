"""On-chip CTC prefix beam vs the exact host search."""

import jax
import jax.numpy as jnp
import numpy as np

from asr_chinese_e2e.decode.ctc_prefix import ctc_prefix_beam_search
from asr_chinese_e2e.decode.ctc_prefix_device import (
    ctc_prefix_beam_device,
    device_nbest_to_lists,
)
from asr_chinese_e2e.decode.greedy import ctc_greedy_decode


def peaky_log_probs(seed, B=3, T=25, C=12, sharpness=3.0):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, T, C).astype(np.float32) * sharpness
    return np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))


def test_device_matches_host_best_prefix():
    lp = peaky_log_probs(0)
    lengths = np.array([25, 20, 15])
    prefixes, plen, scores = ctc_prefix_beam_device(
        jnp.asarray(lp), jnp.asarray(lengths), beam_size=8, prune=16
    )
    nbest = device_nbest_to_lists(prefixes, plen, scores)
    for b in range(3):
        host = ctc_prefix_beam_search(lp[b], int(lengths[b]), beam_size=8)
        assert nbest[b][0][0] == host[0][0], (b, nbest[b][0], host[0])
        # with on-device duplicate merging the score matches the exact
        # search (host prunes slightly wider, so host >= device)
        assert nbest[b][0][1] <= host[0][1] + 1e-3
        np.testing.assert_allclose(nbest[b][0][1], host[0][1], rtol=1e-2)


def test_device_beats_or_matches_greedy():
    """Beam-search total prefix probability must be >= the greedy path's
    prefix probability (greedy collapse is one candidate in the space)."""
    lp = peaky_log_probs(1, sharpness=1.0)  # flatter -> beam matters
    lengths = np.array([25, 25, 25])
    prefixes, plen, scores = ctc_prefix_beam_device(
        jnp.asarray(lp), jnp.asarray(lengths), beam_size=8, prune=10
    )
    greedy = ctc_greedy_decode(jnp.asarray(lp), jnp.asarray(lengths))
    nbest = device_nbest_to_lists(prefixes, plen, scores)
    for b in range(3):
        host = ctc_prefix_beam_search(lp[b], int(lengths[b]), beam_size=8)
        host_scores = dict(host)
        g = tuple(greedy[b])
        if g in host_scores:
            assert nbest[b][0][1] >= host_scores[g] - 1e-3


def test_variable_lengths_freeze():
    lp = peaky_log_probs(2)
    full = ctc_prefix_beam_device(jnp.asarray(lp), jnp.asarray([25, 10, 25]))
    short = ctc_prefix_beam_device(
        jnp.asarray(lp[:, :10]), jnp.asarray([10, 10, 10])
    )
    # utterance 1 (length 10) must be unaffected by frames 10..25
    np.testing.assert_array_equal(
        np.asarray(full[0])[1], np.asarray(short[0])[1]
    )
    np.testing.assert_allclose(
        np.asarray(full[2])[1], np.asarray(short[2])[1], rtol=1e-5
    )


def test_rescore_integration():
    from asr_chinese_e2e.decode.ctc_prefix import attention_rescore
    from tests.test_decode import setup_attention_model

    model, params, enc_out, enc_lens = setup_attention_model()
    lp = model.apply(params, enc_out, method="ctc_log_probs")
    prefixes, plen, scores = ctc_prefix_beam_device(lp, enc_lens, beam_size=4)
    nbest = device_nbest_to_lists(prefixes, plen, scores)
    best = attention_rescore(model, params, enc_out, enc_lens, nbest, 0.3)
    assert len(best) == enc_out.shape[0]
