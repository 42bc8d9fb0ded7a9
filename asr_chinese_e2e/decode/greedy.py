"""Greedy decoding: CTC best-path and autoregressive attention decode.

The reference's only non-teacher-forced decoding is an unwired
per-utterance Python beam (``transformer_official.py:331-434``); its greedy
path is teacher-forced argmax for metrics only (``:87-91``). Here:

- ``ctc_greedy_decode``: argmax over frames → collapse repeats → strip
  blanks, fully vectorised (host-side finalisation returns ragged id
  lists);
- ``attention_greedy_decode``: true autoregressive argmax with the KV-cached
  ``decode_step`` under ``lax.scan`` — fixed shapes, one compile.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..data.vocab import BLANK_ID, BOS_ID, EOS_ID


def ctc_greedy_decode(
    log_probs: jnp.ndarray, logit_lengths: jnp.ndarray
) -> List[List[int]]:
    """(B, T, C) log-probs -> per-utterance collapsed id sequences."""
    ids = np.asarray(jnp.argmax(log_probs, axis=-1))  # (B, T)
    lengths = np.asarray(logit_lengths)
    out: List[List[int]] = []
    for row, n in zip(ids, lengths):
        row = row[:n]
        keep = np.concatenate([[True], row[1:] != row[:-1]])  # collapse repeats
        collapsed = row[keep]
        out.append(collapsed[collapsed != BLANK_ID].tolist())
    return out


from .jit_cache import ModelJitCache

_JIT_CACHE = ModelJitCache()


def attention_greedy_decode(model, params, enc_out, enc_lengths, max_len: int):
    """Autoregressive argmax decode with the cached step path.

    Returns (tokens (B, max_len) int32 — EOS-terminated, PAD after; and
    scores (B,) summed log-probs). Jitted per (model, max_len) — repeat
    calls skip Python retracing."""
    cache = _JIT_CACHE.scope(model)
    fn = cache.get(max_len)
    if fn is None:
        import functools

        fn = jax.jit(
            functools.partial(_greedy_impl, model, max_len=max_len)
        )
        cache[max_len] = fn
    return fn(params, enc_out, enc_lengths)


def _greedy_impl(model, params, enc_out, enc_lengths, *, max_len: int):
    from .beam import _SPECIAL_SUPPRESS

    bsz = enc_out.shape[0]
    state = model.apply(
        params, enc_out, enc_lengths, max_len + 1, method="init_decode_state"
    )
    # static (cross K/V) closed over, not carried
    static = state["static"]
    carry_state0 = state["carry"]

    def body(carry, i):
        tokens, carry_state, score, finished = carry
        logp, state = model.apply(
            params, tokens[:, i], {"carry": carry_state, "static": static},
            i, method="decode_step",
        )
        carry_state = state["carry"]
        # PAD/blank, UNK and BOS are never valid emissions (same
        # convention as beam.py's candidate suppression)
        logp = logp.at[:, :_SPECIAL_SUPPRESS].set(-1e9)
        nxt = jnp.argmax(logp, axis=-1).astype(jnp.int32)
        step_lp = jnp.take_along_axis(logp, nxt[:, None], axis=-1)[:, 0]
        nxt = jnp.where(finished, EOS_ID, nxt)
        score = score + jnp.where(finished, 0.0, step_lp)
        tokens = tokens.at[:, i + 1].set(nxt)
        finished = finished | (nxt == EOS_ID)
        return (tokens, carry_state, score, finished), None

    tokens0 = jnp.zeros((bsz, max_len + 1), jnp.int32).at[:, 0].set(BOS_ID)
    carry = (
        tokens0,
        carry_state0,
        jnp.zeros((bsz,), jnp.float32),
        jnp.zeros((bsz,), bool),
    )
    (tokens, _, scores, _), _ = jax.lax.scan(
        body, carry, jnp.arange(max_len)
    )
    return tokens[:, 1:], scores


def tokens_to_ids(tokens: np.ndarray) -> List[List[int]]:
    """Truncate fixed-shape decode output at the first EOS (rows exclude
    the initial BOS position already)."""
    out = []
    for row in np.asarray(tokens):
        ids = []
        for t in row:
            if t == EOS_ID:
                break
            ids.append(int(t))
        out.append(ids)
    return out
