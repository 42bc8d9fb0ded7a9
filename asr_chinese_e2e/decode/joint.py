"""One-pass joint CTC/attention beam search — all state on device.

The hybrid architecture's strongest decode mode (Watanabe et al. 2017,
"Hybrid CTC/Attention Architecture for End-to-End Speech Recognition"):
at every beam step the candidate score interpolates the attention
decoder's cumulative log-prob with the CTC *prefix probability*
``p(h, ...|X)`` — the mass of all complete CTC alignments whose decoded
sequence begins with hypothesis ``h``. This prunes attention hypotheses
that CTC considers unalignable (and vice versa) DURING the search, which
beats the two-stage CTC-prefix-beam + attention-rescoring pipeline
(``decode/ctc_prefix_device.py`` + ``recognize.py --mode rescore``).

The reference repo has no CTC at all (SURVEY §0); this is net-new
north-star capability, designed as device code:

- beam state is dense device arrays; one jitted program per
  (model, beam, max_len, ctc_weight) — ``lax.while_loop`` over steps;
- per step, CTC prefix scores are computed only for the top
  ``ctc_prune`` attention candidates (the standard pre-selection), via a
  ``lax.scan`` over frames carrying (r_nb, r_b) registers of shape
  (B, K, P) — fixed shapes, no Python;
- the per-hypothesis CTC forward registers r(t) live as (B, K, T)
  arrays gathered on reselection; the attention KV caches reorder with
  the same carry/static split as ``decode/beam.py``.

Scoring recursion (ESPnet-convention, log domain; xs = CTC log-probs):

    phi(t)      = r_b^g(t)  ⊕  [cand != last(g)] · r_nb^g(t)
    r_nb^h(t)   = (r_nb^h(t-1) ⊕ phi(t-1)) + xs(t, c)
    r_b^h(t)    = (r_b^h(t-1) ⊕ r_nb^h(t-1)) + xs(t, blank)
    psi (score) = ⊕_t  phi(t-1) + xs(t, c)          (prefix probability)
    eos         = r_nb^g(T-1) ⊕ r_b^g(T-1)           (complete-seq prob)

where ⊕ is logaddexp and h = g·c.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..data.vocab import BLANK_ID, BOS_ID, EOS_ID
from ..ops.masks import NEG_INF
from .beam import (
    _SPECIAL_SUPPRESS,
    BeamResult,
    init_decode_state,
    make_gather_carry,
)
from .jit_cache import ModelJitCache

LOG_ZERO = -1e30


def _lae(a, b):
    return jnp.logaddexp(a, b)


# ---------------------------------------------------------------------------
# host reference (oracle for the device implementation; also usable for
# small-scale decoding on the host)
# ---------------------------------------------------------------------------


def ctc_prefix_scores_host(
    xs: np.ndarray, prefix: list, cands: list, blank_id: int = BLANK_ID
) -> tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Reference CTC prefix scorer for ONE utterance.

    xs: (T, C) log-probs; prefix: token ids of g; cands: candidate ids.
    Returns (psi (P,), r_nb (P, T), r_b (P, T), eos_score) for h = g·c.
    Precondition: caller supplies r-registers implicitly by recomputing g's
    registers from scratch (host oracle — clarity over speed)."""
    t_max = xs.shape[0]

    def registers(g):
        # r_nb/r_b of prefix g over frames (log domain)
        r_nb = np.full(t_max, LOG_ZERO)
        r_b = np.zeros(t_max)
        if not g:
            acc = 0.0
            for t in range(t_max):
                acc += xs[t, blank_id]
                r_b[t] = acc
            return r_nb, r_b
        # run the recursion symbol by symbol
        pg_nb, pg_b = registers(g[:-1])
        c = g[-1]
        last_prev = g[-2] if len(g) > 1 else None
        r_nb = np.full(t_max, LOG_ZERO)
        r_b = np.full(t_max, LOG_ZERO)
        for t in range(t_max):
            if t == 0:
                r_nb[0] = xs[0, c] if len(g) == 1 else LOG_ZERO
                r_b[0] = LOG_ZERO
                continue
            phi = pg_b[t - 1]
            if c != last_prev:
                phi = np.logaddexp(phi, pg_nb[t - 1])
            r_nb[t] = np.logaddexp(r_nb[t - 1], phi) + xs[t, c]
            r_b[t] = np.logaddexp(r_b[t - 1], r_nb[t - 1]) + xs[t, blank_id]
        return r_nb, r_b

    g_nb, g_b = registers(list(prefix))
    last = prefix[-1] if prefix else None
    p = len(cands)
    psi = np.full(p, LOG_ZERO)
    r_nb_out = np.full((p, t_max), LOG_ZERO)
    r_b_out = np.full((p, t_max), LOG_ZERO)
    for i, c in enumerate(cands):
        r_nb = np.full(t_max, LOG_ZERO)
        r_b = np.full(t_max, LOG_ZERO)
        if not prefix:
            r_nb[0] = xs[0, c]
            acc_psi = r_nb[0]
        else:
            acc_psi = LOG_ZERO
        for t in range(1, t_max):
            phi = g_b[t - 1]
            if last is None or c != last:
                phi = np.logaddexp(phi, g_nb[t - 1])
            r_nb[t] = np.logaddexp(r_nb[t - 1], phi) + xs[t, c]
            r_b[t] = np.logaddexp(r_b[t - 1], r_nb[t - 1]) + xs[t, blank_id]
            acc_psi = np.logaddexp(acc_psi, phi + xs[t, c])
        psi[i] = acc_psi
        r_nb_out[i] = r_nb
        r_b_out[i] = r_b
    eos_score = np.logaddexp(g_nb[t_max - 1], g_b[t_max - 1])
    return psi, r_nb_out, r_b_out, float(eos_score)


# ---------------------------------------------------------------------------
# device implementation
# ---------------------------------------------------------------------------


def _parent_eos_score(frame_mask, r_nb_g, r_b_g):
    """Complete-sequence score of the PARENT (for the EOS candidate):
    registers at the last VALID frame. (B, K)."""
    idx = jnp.sum(frame_mask, axis=1) - 1  # (B,)
    r_nb_last = jnp.take_along_axis(r_nb_g, idx[:, None, None], axis=2)[..., 0]
    r_b_last = jnp.take_along_axis(r_b_g, idx[:, None, None], axis=2)[..., 0]
    return _lae(r_nb_last, r_b_last)


def _ctc_candidate_scores(ctc_lp_flat, frame_mask, r_nb_g, r_b_g, cand, last, is_empty):
    """Batched CTC prefix SCORES for candidate extensions — NO scan.

    The prefix probability psi = psi0 ⊕ (⊕_{t≥1} phi(t-1) + xs(t, c))
    depends only on the PARENT's registers (via phi), never on the
    candidate's own recursion — so scoring all K·P candidates is one
    masked logsumexp over frames, fully vectorised. (The per-frame
    register recursion is only needed for the K SELECTED extensions;
    see ``_ctc_selected_registers``. The previous all-candidates scan
    carried (B, K, P) registers over T-1 lax.scan trips, each doing
    strided minor-axis slices of two ~20 MB tensors — profiled as the
    bulk of joint decode's +4.7 ms/step over plain beam.)

    ctc_lp_flat: (B·C, T) CTC log-probs, class-major rows flattened so the
    candidate gather is a plain 2-D row gather (a (B, C, T) layout makes
    XLA re-copy the whole tensor inside the decode loop every step —
    profiled at 1.6 ms/step); frame_mask: (B, T) True for valid frames;
    r_nb_g / r_b_g: (B, K, T) parent registers; cand: (B, K, P) candidate
    ids; last: (B, K) last token of each parent (-1 if empty); is_empty:
    (B, K) parent-is-empty.

    Returns (psi (B,K,P), eos (B,K))."""
    b = frame_mask.shape[0]
    c = ctc_lp_flat.shape[0] // b

    # xs[b,k,p,t] = ctc_lp[b, t, cand[b,k,p]] — flat row gather
    rows = jnp.arange(b, dtype=cand.dtype)[:, None, None] * c + cand
    xs = ctc_lp_flat[rows]  # (B, K, P, T)

    # phi[b,k,p,t] = r_b_g[t] (+ r_nb_g[t] unless cand == last). Kept
    # materialised: logsumexp reads its input twice (max, then sum), so a
    # broadcast form would be recomputed instead of fused.
    same = cand == last[:, :, None]  # (B, K, P)
    phi = jnp.where(
        same[:, :, :, None],
        r_b_g[:, :, None, :],
        _lae(r_b_g[:, :, None, :], r_nb_g[:, :, None, :]),
    )  # (B, K, P, T)

    empty = is_empty[:, :, None]  # (B, K, 1)
    psi0 = jnp.where(empty, xs[..., 0], LOG_ZERO)

    grow = phi[..., :-1] + xs[..., 1:]  # (B, K, P, T-1), term at frame t
    valid = frame_mask[:, None, None, 1:]
    grow = jnp.where(valid, grow, LOG_ZERO)
    psi = _lae(psi0, jax.scipy.special.logsumexp(grow, axis=-1))
    return psi, _parent_eos_score(frame_mask, r_nb_g, r_b_g)


def _ctc_selected_registers(
    ctc_lp_flat, frame_mask, r_nb_g, r_b_g, token, last, is_empty
):
    """Per-frame CTC forward registers for ONE selected extension per beam
    slot (the next step's parent registers).

    r_nb_g / r_b_g: (B, K, T) registers of the SELECTED parents (already
    gathered by the parent map); token: (B, K) selected extension; last:
    (B, K) the selected parent's last token; is_empty: scalar/array bool.

    Returns (r_nb (B,K,T), r_b (B,K,T)). The scan carries only (B, K)
    registers — ~P× less work per trip than recursing all candidates."""
    b, k = token.shape
    t_max = ctc_lp_flat.shape[-1]
    c = ctc_lp_flat.shape[0] // b

    rows = jnp.arange(b, dtype=token.dtype)[:, None] * c + token
    xs = ctc_lp_flat[rows]  # (B, K, T)
    blank = ctc_lp_flat[jnp.arange(b) * c + BLANK_ID][:, None, :]  # (B, 1, T)
    # freeze the recursion on padded frames: emitting there is impossible
    # and blank is free, so registers keep their last valid value
    fm = frame_mask[:, None, :]  # (B, 1, T)
    xs = jnp.where(fm, xs, LOG_ZERO)
    blank = jnp.where(fm, blank, 0.0)

    same = token == last  # (B, K)
    phi = jnp.where(
        same[:, :, None], r_b_g, _lae(r_b_g, r_nb_g)
    )  # (B, K, T)

    r_nb0 = jnp.where(is_empty, xs[..., 0], LOG_ZERO)

    # T-major operands: scan trips slice the MAJOR axis (contiguous),
    # not the minor one
    xs_t = jnp.moveaxis(xs, -1, 0)  # (T, B, K)
    phi_t = jnp.moveaxis(phi, -1, 0)
    blank_t = jnp.moveaxis(jnp.broadcast_to(blank, (b, 1, t_max)), -1, 0)
    vm_t = frame_mask.T[:, :, None]  # (T, B, 1)

    def step(carry, xs_blk):
        r_nb_prev, r_b_prev = carry
        xs_c, phi_p, blank_c, vm = xs_blk
        grow = phi_p + xs_c
        r_nb = _lae(r_nb_prev + xs_c, grow)
        r_b = _lae(r_b_prev, r_nb_prev) + blank_c
        r_nb = jnp.where(vm, r_nb, r_nb_prev)
        r_b = jnp.where(vm, r_b, r_b_prev)
        return (r_nb, r_b), (r_nb, r_b)

    (_, _), (r_nb_seq, r_b_seq) = jax.lax.scan(
        step,
        (r_nb0, jnp.full((b, k), LOG_ZERO)),
        (xs_t[1:], phi_t[:-1], blank_t[1:], vm_t[1:]),
    )
    r_nb_all = jnp.concatenate([r_nb0[None], r_nb_seq], axis=0)
    r_b_all = jnp.concatenate(
        [jnp.full((1, b, k), LOG_ZERO), r_b_seq], axis=0
    )
    return jnp.moveaxis(r_nb_all, 0, -1), jnp.moveaxis(r_b_all, 0, -1)


def joint_beam_search(
    model,
    params,
    enc_out: jnp.ndarray,
    enc_lengths: jnp.ndarray,
    beam_size: int,
    max_len: int,
    ctc_weight: float = 0.3,
    ctc_prune: int = 30,
    ctc_log_probs: Optional[jnp.ndarray] = None,
) -> BeamResult:
    """One-pass joint decode: score = (1−λ)·attention + λ·CTC-prefix.

    ``ctc_prune``: CTC prefix scores are evaluated for the top-``P``
    attention candidates per hypothesis (plus EOS, always scored via the
    parent's complete-sequence probability). ``ctc_log_probs`` may be
    precomputed (B, T, C); otherwise taken from ``model.ctc_log_probs``.
    ``ctc_weight=0`` reduces to pure attention beam search over the
    pruned candidate set."""
    cache = _JIT_CACHE.scope(model)
    # cap the CTC register width at the batch-max VALID frame count
    # (rounded up to 32 to bound recompiles): frames beyond every
    # utterance's length contribute exactly nothing to the recursion, so
    # scores are unchanged while the frame scan and register traffic
    # shrink with the bucket occupancy
    t_valid = int(jnp.max(enc_lengths))
    t_cap = min(enc_out.shape[1], -(-t_valid // 32) * 32)
    vocab = (
        int(ctc_log_probs.shape[-1])
        if ctc_log_probs is not None
        else int(getattr(model, "vocab_size"))
    )
    ctc_prune = min(ctc_prune, vocab)
    if ctc_log_probs is not None and t_cap < ctc_log_probs.shape[1]:
        ctc_log_probs = ctc_log_probs[:, :t_cap]
    # lazy beam reorder (unpermuted KV caches + ancestry routing) when the
    # model supports it — skips the physical cache gather (see
    # decode/beam.py)
    lazy = hasattr(model, "decode_step_lazy")
    # when the caller didn't precompute ctc_log_probs, the CTC head runs
    # INSIDE the search program (t_cap static) — one device dispatch per
    # batch instead of two
    key = (beam_size, max_len, ctc_weight, ctc_prune, lazy,
           ctc_log_probs is None, t_cap)
    fn = cache.get(key)
    if fn is None:
        fn = jax.jit(
            functools.partial(
                _joint_impl,
                model,
                beam_size=beam_size,
                max_len=max_len,
                ctc_weight=ctc_weight,
                ctc_prune=ctc_prune,
                lazy=lazy,
                t_cap=t_cap,
            )
        )
        cache[key] = fn
    tokens, scores, finished = fn(params, enc_out, enc_lengths, ctc_log_probs)
    return BeamResult(tokens, scores, finished)  # device arrays; no sync


_JIT_CACHE = ModelJitCache()


def _joint_impl(
    model,
    params,
    enc_out,
    enc_lengths,
    ctc_lp,
    *,
    beam_size: int,
    max_len: int,
    ctc_weight: float,
    ctc_prune: int,
    lazy: bool = False,
    t_cap: int = 0,
):
    if ctc_lp is None:
        # CTC head + log_softmax fused into the search program, on the
        # frame-capped encoder slice
        ctc_lp = model.apply(
            params, enc_out[:, :t_cap], method="ctc_log_probs"
        )
    bsz, k = enc_out.shape[0], beam_size
    p = ctc_prune
    t_max = ctc_lp.shape[1]
    lam = float(ctc_weight)

    state = init_decode_state(model, params, enc_out, enc_lengths, max_len + 1, k)
    static = state["static"]
    carry_state0 = state["carry"]
    gather_carry = make_gather_carry(bsz, k)

    v = ctc_lp.shape[-1]
    # (B·C, T) class-major rows: candidate log-probs become a 2-D row
    # gather with no in-loop layout copies
    ctc_lp_flat = ctc_lp.transpose(0, 2, 1).reshape(bsz * v, t_max)
    frame_mask = jnp.arange(t_max)[None, :] < enc_lengths[:, None]

    tokens0 = jnp.zeros((bsz, k, max_len + 1), jnp.int32).at[:, :, 0].set(BOS_ID)
    att0 = jnp.zeros((bsz, k), jnp.float32)
    # CTC registers of the (empty) initial prefix: r_b = cumsum blank
    blank_cum = jnp.cumsum(
        jnp.where(frame_mask, ctc_lp[:, :, BLANK_ID], 0.0), axis=1
    )  # (B, T)
    r_nb0 = jnp.full((bsz, k, t_max), LOG_ZERO)
    r_b0 = jnp.tile(blank_cum[:, None, :], (1, k, 1))
    ctc0 = jnp.zeros((bsz, k), jnp.float32)  # cumulative CTC prefix score
    finished0 = jnp.zeros((bsz, k), bool)

    def cond(c):
        i, finished = c[0], c[4]
        return (i < max_len) & ~jnp.all(finished)

    def body(c):
        (i, tokens, att, ctc, finished, carry_state, r_nb, r_b, anc) = c
        last = tokens[:, :, i].reshape(bsz * k)
        state_in = {"carry": carry_state, "static": static}
        if lazy:
            # position i's KV is written by each slot itself
            anc = anc.at[:, :, i].set(jnp.arange(k, dtype=jnp.int32)[None])
            logp, st = model.apply(
                params, last, state_in, i, anc, method="decode_step_lazy"
            )
        else:
            logp, st = model.apply(params, last, state_in, i, method="decode_step")
        carry_new = st["carry"]
        logp = logp.reshape(bsz, k, v)
        # PAD/blank, UNK and BOS are never valid candidate extensions —
        # extending a CTC prefix with the blank id is meaningless, and a
        # weakly trained decoder can otherwise emit them into hypotheses
        logp = logp.at[:, :, :_SPECIAL_SUPPRESS].set(NEG_INF)

        # top-P attention candidates; EOS is forced into slot P-1 so the
        # hypothesis can always terminate. top_k runs on a 2-D view of the
        # (B·K, V) scores, in exact f32.
        att_top, cand = jax.lax.top_k(logp.reshape(bsz * k, v), p)
        att_top = att_top.reshape(bsz, k, p)
        cand = cand.reshape(bsz, k, p)
        cand = cand.at[:, :, p - 1].set(EOS_ID)
        att_top = att_top.at[:, :, p - 1].set(logp[:, :, EOS_ID])
        # a natural EOS in an earlier slot would duplicate the forced one
        dup_eos = (cand == EOS_ID).at[:, :, p - 1].set(False)

        last_tok = jnp.where(i == 0, -1, tokens[:, :, i])  # (B, K)
        is_empty = i == 0
        empty_k = jnp.full((bsz, k), is_empty)
        psi, eos_sc = _ctc_candidate_scores(
            ctc_lp_flat, frame_mask, r_nb, r_b, cand, last_tok, empty_k
        )
        is_eos = cand == EOS_ID
        ctc_cand = jnp.where(is_eos, eos_sc[:, :, None], psi)  # (B,K,P)

        att_cand = att[:, :, None] + att_top
        total = (1.0 - lam) * att_cand + lam * ctc_cand
        # finished hyps: only the forced-EOS slot stays live, score frozen
        frozen = (1.0 - lam) * att[:, :, None] + lam * ctc[:, :, None]
        total = jnp.where(
            finished[:, :, None],
            jnp.where(is_eos, frozen, NEG_INF),
            total,
        )
        # suppressions must be ADDITIVE sentinels on `total`, never scaled
        # by (1-lam) — at ctc_weight=1 a scaled mask vanishes and the beam
        # collapses to duplicates:
        # - duplicate-EOS slots
        # - at step 0 every parent slot but 0 (all hold the same BOS)
        dead0 = (i == 0) & (jnp.arange(k)[None, :, None] > 0)
        total = jnp.where(dup_eos | dead0, NEG_INF, total)

        top_scores, top_idx = jax.lax.top_k(total.reshape(bsz, k * p), k)
        parent = top_idx // p  # (B, K)
        slot = top_idx % p

        def sel2(x):  # (B, K, P) -> (B, K) at (parent, slot)
            xp = jnp.take_along_axis(x, parent[:, :, None], axis=1)
            return jnp.take_along_axis(xp, slot[:, :, None], axis=2)[..., 0]

        token = sel2(cand).astype(jnp.int32)
        was_finished = jnp.take_along_axis(finished, parent, axis=1)
        new_att = jnp.where(
            was_finished,
            jnp.take_along_axis(att, parent, axis=1),
            jnp.take_along_axis(att, parent, axis=1) + sel2(att_top),
        )
        new_ctc = jnp.where(
            was_finished,
            jnp.take_along_axis(ctc, parent, axis=1),
            sel2(ctc_cand),
        )
        # registers advance only for live non-EOS extensions, and are
        # recursed ONLY for the K selected tokens (not all K·P candidates)
        live_ext = ~was_finished & (token != EOS_ID)
        par_r_nb = jnp.take_along_axis(r_nb, parent[:, :, None], axis=1)
        par_r_b = jnp.take_along_axis(r_b, parent[:, :, None], axis=1)
        par_last = jnp.take_along_axis(last_tok, parent, axis=1)
        r_nb_sel, r_b_sel = _ctc_selected_registers(
            ctc_lp_flat, frame_mask, par_r_nb, par_r_b, token, par_last,
            is_empty,
        )
        r_nb = jnp.where(live_ext[:, :, None], r_nb_sel, par_r_nb)
        r_b = jnp.where(live_ext[:, :, None], r_b_sel, par_r_b)

        if lazy:
            # reorder ONLY the tiny ancestry map; caches stay in place
            anc = jnp.take_along_axis(anc, parent[:, :, None], axis=1)
            carry_state = carry_new
        else:
            carry_state = gather_carry(carry_new, parent)
        tokens = jnp.take_along_axis(
            tokens, parent[:, :, None], axis=1
        ).at[:, :, i + 1].set(token)
        finished = was_finished | (token == EOS_ID)
        return (
            i + 1, tokens, new_att, new_ctc, finished, carry_state, r_nb, r_b,
            anc,
        )

    carry = (
        jnp.asarray(0), tokens0, att0, ctc0, finished0,
        carry_state0, r_nb0, r_b0,
        jnp.zeros((bsz, k, max_len + 1), jnp.int32),
    )
    out = jax.lax.while_loop(cond, body, carry)
    _, tokens, att, ctc, finished = out[:5]
    scores = (1.0 - lam) * att + lam * ctc
    order = jnp.argsort(-scores, axis=1)
    scores = jnp.take_along_axis(scores, order, axis=1)
    tokens = jnp.take_along_axis(tokens[:, :, 1:], order[:, :, None], axis=1)
    finished = jnp.take_along_axis(finished, order, axis=1)
    return tokens, scores, finished
