"""Decoding: CTC greedy, attention greedy, batched beam, CTC prefix beam,
attention rescoring."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np

from asr_chinese_e2e.data.vocab import BLANK_ID, BOS_ID, EOS_ID
from asr_chinese_e2e.decode.beam import beam_search
from asr_chinese_e2e.decode.ctc_prefix import (
    attention_rescore,
    ctc_prefix_beam_batch,
    ctc_prefix_beam_search,
)
from asr_chinese_e2e.decode.greedy import (
    attention_greedy_decode,
    ctc_greedy_decode,
    tokens_to_ids,
)
from asr_chinese_e2e.models.transformer import SpeechTransformer

from tests.test_transformer import VOCAB, init_model, make_batch, tiny_cfg


def test_ctc_greedy_collapse_and_blank_strip():
    # path: [5 5 blank 5 6 6 blank] -> [5, 5, 6]
    T, C = 7, 8
    lp = np.full((1, T, C), -10.0, np.float32)
    path = [5, 5, BLANK_ID, 5, 6, 6, BLANK_ID]
    for t, s in enumerate(path):
        lp[0, t, s] = 0.0
    ids = ctc_greedy_decode(jnp.asarray(lp), jnp.asarray([T]))
    assert ids == [[5, 5, 6]]
    # truncation by length
    ids = ctc_greedy_decode(jnp.asarray(lp), jnp.asarray([2]))
    assert ids == [[5]]


def oracle_ctc_total_prob(log_probs, prefix, T):
    """Sum path probabilities over all alignments mapping to prefix."""
    total = -np.inf
    C = log_probs.shape[1]
    for path in itertools.product(range(C), repeat=T):
        # collapse
        out = []
        prev = None
        for s in path:
            if s != prev and s != BLANK_ID:
                out.append(s)
            prev = s
        if tuple(out) == tuple(prefix):
            lp = sum(log_probs[t, s] for t, s in enumerate(path))
            total = np.logaddexp(total, lp)
    return total


def test_ctc_prefix_beam_matches_exhaustive_oracle():
    rng = np.random.RandomState(0)
    T, C = 4, 4
    logits = rng.randn(T, C)
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    hyps = ctc_prefix_beam_search(lp, T, beam_size=50)
    # every returned prefix's score must match the exhaustive sum
    for prefix, score in hyps[:5]:
        want = oracle_ctc_total_prob(lp, prefix, T)
        np.testing.assert_allclose(score, want, rtol=1e-6)
    # and the best prefix must be the true argmax over all prefixes
    best_prefix, best_score = hyps[0]
    for cand_len in range(0, 4):
        for cand in itertools.product(range(1, C), repeat=cand_len):
            assert oracle_ctc_total_prob(lp, cand, T) <= best_score + 1e-9


def setup_attention_model():
    cfg = tiny_cfg(dropout_rate=0.0, ctc_weight=0.3)
    model, params = init_model(cfg)
    feats, feat_lens, _, _ = make_batch()
    enc_out, enc_lens = model.apply(params, feats, feat_lens, method="encode")
    return model, params, enc_out, enc_lens


def test_attention_greedy_matches_beam1():
    model, params, enc_out, enc_lens = setup_attention_model()
    g_tokens, g_scores = attention_greedy_decode(model, params, enc_out, enc_lens, 6)
    result = beam_search(model, params, enc_out, enc_lens, beam_size=1, max_len=6)
    g_ids = tokens_to_ids(g_tokens)
    b_ids = result.nbest_ids(1)
    for b in range(enc_out.shape[0]):
        assert g_ids[b] == b_ids[b][0]


def test_beam_scores_sorted_and_finite():
    model, params, enc_out, enc_lens = setup_attention_model()
    result = beam_search(model, params, enc_out, enc_lens, beam_size=4, max_len=6)
    assert result.tokens.shape == (2, 4, 6)
    for b in range(2):
        s = result.scores[b]
        assert (np.diff(s) <= 1e-6).all()  # best-first
        assert np.isfinite(s[0])


def test_beam_score_equals_manual_prefix_score():
    """The best beam's score must equal the sum of stepwise log-probs of
    its token sequence under the uncached full forward (exactness of the
    device beam bookkeeping)."""
    model, params, enc_out, enc_lens = setup_attention_model()
    result = beam_search(model, params, enc_out, enc_lens, beam_size=3, max_len=6)
    for b in range(2):
        ids = result.nbest_ids(3)[b][0]
        seq = [BOS_ID] + ids + ([EOS_ID] if result.finished[b, 0] else [])
        ys_in = jnp.asarray([seq[:-1]])
        logits = model.apply(
            params,
            ys_in,
            jnp.asarray([len(seq) - 1]),
            enc_out[b : b + 1],
            enc_lens[b : b + 1],
            method="decode_logits",
        )
        lp = jax.nn.log_softmax(logits, axis=-1)
        want = float(
            sum(lp[0, i, tok] for i, tok in enumerate(seq[1:]))
        )
        np.testing.assert_allclose(result.scores[b, 0], want, rtol=1e-4, atol=1e-4)


def test_beam_lazy_reorder_matches_gather():
    """The lazy ancestry-map beam (no KV-cache gather) must produce
    exactly the same hypotheses and scores as the physical-gather beam."""
    model, params, enc_out, enc_lens = setup_attention_model()
    a = beam_search(model, params, enc_out, enc_lens, 4, 6, lazy=True)
    b = beam_search(model, params, enc_out, enc_lens, 4, 6, lazy=False)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.finished, b.finished)
    np.testing.assert_allclose(a.scores, b.scores, rtol=1e-5, atol=1e-5)


def test_ctc_prefix_and_rescore_pipeline():
    model, params, enc_out, enc_lens = setup_attention_model()
    ctc_lp = model.apply(params, enc_out, method="ctc_log_probs")
    nbest = ctc_prefix_beam_batch(np.asarray(ctc_lp), np.asarray(enc_lens), 4)
    assert len(nbest) == 2 and all(len(h) > 0 for h in nbest)
    best = attention_rescore(model, params, enc_out, enc_lens, nbest, 0.3)
    assert len(best) == 2
    for ids in best:
        assert all(0 <= t < VOCAB for t in ids)
