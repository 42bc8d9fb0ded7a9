"""One-pass joint CTC/attention decode: prefix-score oracle tests and
device/host equivalence."""

import itertools

import jax.numpy as jnp
import numpy as np

from asr_chinese_e2e.data.vocab import BLANK_ID, EOS_ID
from asr_chinese_e2e.decode.beam import beam_search
from asr_chinese_e2e.decode.joint import (
    LOG_ZERO,
    _ctc_candidate_scores,
    _ctc_selected_registers,
    ctc_prefix_scores_host,
    joint_beam_search,
)

from tests.test_decode import setup_attention_model


def enum_prefix_logprob(xs: np.ndarray, prefix: tuple) -> float:
    """Brute force: log Σ p(π) over ALL alignment paths π whose collapsed
    sequence STARTS WITH ``prefix``."""
    t_max, c = xs.shape
    total = -np.inf
    for path in itertools.product(range(c), repeat=t_max):
        seq = []
        prev = None
        for s in path:
            if s != prev and s != BLANK_ID:
                seq.append(s)
            prev = s
        if tuple(seq[: len(prefix)]) == tuple(prefix):
            total = np.logaddexp(total, sum(xs[t, s] for t, s in enumerate(path)))
    return total


def random_logprobs(t, c, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(t, c)
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def test_host_prefix_score_matches_enumeration():
    xs = random_logprobs(4, 4)
    # empty prefix, candidates = all non-blank
    psi, _, _, eos = ctc_prefix_scores_host(xs, [], [1, 2, 3])
    for i, cand in enumerate([1, 2, 3]):
        want = enum_prefix_logprob(xs, (cand,))
        np.testing.assert_allclose(psi[i], want, rtol=1e-6)
    # eos score of the EMPTY prefix = p(empty sequence) = all-blank path
    np.testing.assert_allclose(eos, xs[:, BLANK_ID].sum(), rtol=1e-6)

    # depth-2 prefixes, including a repeated symbol (needs the phi mask)
    psi2, _, _, eos2 = ctc_prefix_scores_host(xs, [2], [1, 2, 3])
    for i, cand in enumerate([1, 2, 3]):
        want = enum_prefix_logprob(xs, (2, cand))
        np.testing.assert_allclose(psi2[i], want, rtol=1e-6)
    # eos score of prefix [2] = p(exactly [2])
    want_complete = -np.inf
    for path in itertools.product(range(4), repeat=4):
        seq, prev = [], None
        for s in path:
            if s != prev and s != BLANK_ID:
                seq.append(s)
            prev = s
        if seq == [2]:
            want_complete = np.logaddexp(
                want_complete, sum(xs[t, s] for t, s in enumerate(path))
            )
    np.testing.assert_allclose(eos2, want_complete, rtol=1e-6)


def test_device_step_scores_match_host():
    """The batched device scorer (logsumexp, no scan) and the selected-
    token register recursion must reproduce the host scorer for empty and
    non-empty prefixes, incl. repeated-symbol candidates and a shorter
    valid length."""
    t_max, c = 6, 5
    xs = random_logprobs(t_max, c, seed=1)
    n_valid = 5
    xs_valid = xs[:n_valid]
    cands = [1, 2, 3, 4]

    ctc_lp_flat = jnp.asarray(xs.T)  # (B*C, T) with B=1
    frame_mask = jnp.asarray((np.arange(t_max) < n_valid)[None])

    # case 1: empty prefix (K=1) — candidate scores
    psi_h, r_nb_h, r_b_h, eos_h = ctc_prefix_scores_host(xs_valid, [], cands)
    r_nb0 = jnp.full((1, 1, t_max), LOG_ZERO)
    blank_cum = np.cumsum(xs[:, BLANK_ID] * (np.arange(t_max) < n_valid))
    r_b0 = jnp.asarray(blank_cum[None, None])
    psi_d, eos_d = _ctc_candidate_scores(
        ctc_lp_flat, frame_mask, r_nb0, r_b0,
        jnp.asarray([[cands]]), jnp.asarray([[-1]]), jnp.asarray([[True]]),
    )
    np.testing.assert_allclose(np.asarray(psi_d)[0, 0], psi_h, rtol=1e-5)
    np.testing.assert_allclose(eos_d[0, 0], eos_h, rtol=1e-5)

    # registers of the SELECTED extension (token 2) match the host rows
    sel = cands.index(2)
    r_nb_d, r_b_d = _ctc_selected_registers(
        ctc_lp_flat, frame_mask, r_nb0, r_b0,
        jnp.asarray([[2]]), jnp.asarray([[-1]]), jnp.asarray(True),
    )
    np.testing.assert_allclose(
        np.asarray(r_nb_d)[0, 0, :n_valid], r_nb_h[sel], rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(r_b_d)[0, 0, 1:n_valid], r_b_h[sel][1:], rtol=1e-5, atol=1e-5
    )

    # case 2: prefix [2] using the registers produced above
    psi_h2, _, _, eos_h2 = ctc_prefix_scores_host(xs_valid, [2], cands)
    psi_d2, eos_d2 = _ctc_candidate_scores(
        ctc_lp_flat, frame_mask, r_nb_d, r_b_d,
        jnp.asarray([[cands]]), jnp.asarray([[2]]), jnp.asarray([[False]]),
    )
    np.testing.assert_allclose(np.asarray(psi_d2)[0, 0], psi_h2, rtol=1e-5)
    np.testing.assert_allclose(eos_d2[0, 0], eos_h2, rtol=1e-5)


def test_joint_ctc0_matches_attention_beam():
    """With ctc_weight=0 and a wide-open prune, joint search must equal
    the plain attention beam (same hypotheses, same scores)."""
    model, params, enc_out, enc_lens = setup_attention_model()
    a = beam_search(model, params, enc_out, enc_lens, 3, 6)
    j = joint_beam_search(
        model, params, enc_out, enc_lens, 3, 6,
        ctc_weight=0.0, ctc_prune=20,  # vocab in tiny cfg = 20
    )
    np.testing.assert_array_equal(a.tokens, j.tokens)
    np.testing.assert_allclose(a.scores, j.scores, rtol=1e-4, atol=1e-4)


def test_joint_full_weight_finds_ctc_favoured_hyp():
    """Sanity: with ctc_weight=1 the returned best hypothesis must carry a
    CTC prefix score at least as good as any pure-attention beam result's
    (evaluated under the host scorer)."""
    model, params, enc_out, enc_lens = setup_attention_model()
    ctc_lp = np.asarray(
        model.apply(params, enc_out, method="ctc_log_probs"), np.float64
    )
    j = joint_beam_search(
        model, params, enc_out, enc_lens, 3, 5, ctc_weight=1.0, ctc_prune=20
    )
    a = beam_search(model, params, enc_out, enc_lens, 3, 5)

    def host_complete_score(b, ids):
        if len(ids) == 0:
            _, _, _, eos = ctc_prefix_scores_host(
                ctc_lp[b, : int(enc_lens[b])], [], [1]
            )
            return eos
        _, _, _, eos = ctc_prefix_scores_host(
            ctc_lp[b, : int(enc_lens[b])], list(ids), [1]
        )
        return eos

    for b in range(enc_out.shape[0]):
        jb = j.nbest_ids(1)[b][0]
        ab = a.nbest_ids(1)[b][0]
        assert host_complete_score(b, jb) >= host_complete_score(b, ab) - 1e-6
    # device scores for finished hyps must equal the host complete score
    for b in range(enc_out.shape[0]):
        if j.finished[b, 0]:
            want = host_complete_score(b, j.nbest_ids(1)[b][0])
            np.testing.assert_allclose(j.scores[b, 0], want, rtol=1e-4, atol=1e-4)


def _unique_rows(tokens_b):
    return {tuple(int(t) for t in row) for row in tokens_b}


def test_joint_beam_stays_diverse():
    """Regression: finished hypotheses must not duplicate across beam
    slots (a finished hyp's natural-EOS and forced-EOS candidate slots
    used to both survive top_k, collapsing the beam to copies), and at
    ctc_weight=1.0 the dead-slot sentinel must not vanish with the
    (1-lambda) scaling (the beam used to degenerate to one unique hyp)."""
    model, params, enc_out, enc_lens = setup_attention_model()
    for lam in (0.3, 1.0):
        res = joint_beam_search(
            model, params, enc_out, enc_lens, 4, 10,
            ctc_weight=lam, ctc_prune=8,
        )
        for b in range(enc_out.shape[0]):
            uniq = _unique_rows(res.tokens[b])
            assert len(uniq) > 1, (
                f"lam={lam} utt={b}: beam collapsed to one hypothesis"
            )
            assert len(uniq) == res.tokens.shape[1], (
                f"lam={lam} utt={b}: duplicate hypotheses in the beam: "
                f"{res.tokens[b]}"
            )
