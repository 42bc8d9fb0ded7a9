"""Fixed-shape batched beam search with KV cache — all state on device.

Replaces the reference's per-utterance Python-object beam
(``transformer_official.py:331-434``; duplicated ``decoder.py:126-229``)
which re-forwards the full decoder prefix for every hypothesis at every
step with no KV cache (SURVEY §3.4 — O(L²) re-compute). Device-native design
(SURVEY §7 risk register "beam search as device code"):

- beam state is dense device arrays: tokens (B, K, L+1) int32, scores
  (B, K) f32, finished (B, K) bool;
- one cached ``decode_step`` per step over the flattened (B*K) batch;
- candidate expansion + pruning via ``jax.lax.top_k`` over (B, K*V);
- ended-hypothesis harvesting (``transformer_official.py:409-423``)
  becomes a finished mask + forced-EOS row (a finished hyp emits EOS with
  log-prob 0, so its score rides along unchanged);
- per-hypothesis cache reordering is a batched gather applied to every
  state leaf with a (B*K) leading dim — works unchanged for the
  Transformer KV cache and the LAS recurrent state;
- ``lax.while_loop`` with an all-finished early exit; maxlen force-EOS
  (``transformer_official.py:404-407``) falls out of the fixed loop bound.

n-best extraction and (optional) length-normalised sorting mirror
``transformer_official.py:429-434``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..data.vocab import BOS_ID, EOS_ID
from ..ops.masks import NEG_INF
from .jit_cache import ModelJitCache

# non-lexical ids (PAD/blank=0, UNK=1, BOS=2) are never valid mid-hypothesis
# emissions — extending a prefix with them is meaningless, and a weakly
# trained decoder can otherwise leak them into n-best output
_SPECIAL_SUPPRESS = BOS_ID + 1  # ids [0, BOS_ID] masked; EOS stays live


@dataclasses.dataclass
class BeamResult:
    """n-best per utterance: tokens (B, K, L) (BOS stripped), scores (B, K),
    finished (B, K) — True if the hyp emitted EOS before max_len; sorted
    best-first.

    The fields may hold DEVICE arrays: construction does not synchronise
    with the device, so a caller can dispatch the next batch's search
    before reading this one's results (double-buffered corpus decode).
    ``materialize()`` — called implicitly by ``nbest_ids`` — blocks once
    and converts everything to host numpy."""

    tokens: np.ndarray
    scores: np.ndarray
    finished: np.ndarray

    def materialize(self) -> "BeamResult":
        if not isinstance(self.tokens, np.ndarray):
            # Wait for the search program FIRST, then fetch all three
            # arrays in one batched device_get: one transfer instead of
            # three separate np.asarray round-trips.
            jax.block_until_ready(self.scores)
            self.tokens, self.scores, self.finished = jax.device_get(
                (self.tokens, self.scores, self.finished)
            )
        return self

    def nbest_ids(self, nbest: int = 1) -> List[List[List[int]]]:
        self.materialize()
        out = []
        for b in range(self.tokens.shape[0]):
            hyps = []
            for k in range(min(nbest, self.tokens.shape[1])):
                ids = []
                for t in self.tokens[b, k]:
                    if t == EOS_ID:
                        break
                    ids.append(int(t))
                hyps.append(ids)
            out.append(hyps)
        return out


def _expand_for_beams(x: jnp.ndarray, beam: int) -> jnp.ndarray:
    """(B, ...) -> (B*K, ...) by repeating each row K times."""
    return jnp.repeat(x, beam, axis=0)


def init_decode_state(model, params, enc_out, enc_lengths, max_len, beam):
    """Decode state for ``beam`` hypotheses per utterance.

    Models flagging ``FOLD_BEAM_CROSS`` keep cross K/V at one row per
    utterance (the beam folds into the query inside ``step_cross``);
    others get the encoder tensors expanded to B·K rows."""
    if getattr(model, "FOLD_BEAM_CROSS", False):
        return model.apply(
            params, enc_out, enc_lengths, max_len, beam,
            method="init_decode_state",
        )
    enc_out_x = _expand_for_beams(enc_out, beam)
    enc_len_x = _expand_for_beams(enc_lengths, beam)
    return model.apply(
        params, enc_out_x, enc_len_x, max_len, method="init_decode_state"
    )


def make_gather_carry(bsz: int, k: int):
    """Carry-reorder fn: gathers every (B·K)-leading leaf of the carry
    sub-tree by the (B, K) parent map. The static sub-tree must NOT go
    through this — it is beam-invariant."""

    def gather_carry(carry_state, parent):
        flat = (jnp.arange(bsz)[:, None] * k + parent).reshape(bsz * k)

        def g(x):
            if isinstance(x, jnp.ndarray) and x.ndim >= 1 and x.shape[0] == bsz * k:
                return x[flat]
            return x

        return jax.tree_util.tree_map(g, carry_state)

    return gather_carry


def beam_search(
    model,
    params,
    enc_out: jnp.ndarray,
    enc_lengths: jnp.ndarray,
    beam_size: int,
    max_len: int,
    length_penalty: float = 0.0,
    lazy: str | bool = "auto",
) -> BeamResult:
    """Batched attention beam search.

    ``length_penalty`` > 0 applies GNMT-style normalisation at the final
    sort (the reference sorts by raw score, ``transformer_official.py:429``;
    0.0 reproduces that). The whole search is one jitted program per
    (model instance, beam_size, max_len) — repeat calls skip Python
    retracing (which costs seconds per call through a deep decoder).

    ``lazy`` selects cache reordering on beam reselection: ``True`` keeps
    the self-KV caches unpermuted and routes via a (B, K, L) ancestry map
    inside attention (``decode_step_lazy`` — skips the HBM-bound cache
    gather); ``False`` physically gathers the carry sub-tree; ``"auto"``
    uses lazy when the model supports it. Both produce identical beams."""
    if lazy == "auto":
        lazy = hasattr(model, "decode_step_lazy")
    cache = _JIT_CACHE.scope(model)
    key = (beam_size, max_len, length_penalty, lazy)
    fn = cache.get(key)
    if fn is None:
        fn = jax.jit(
            functools.partial(
                _beam_search_impl,
                model,
                beam_size=beam_size,
                max_len=max_len,
                length_penalty=length_penalty,
                lazy=lazy,
            )
        )
        cache[key] = fn
    tokens, scores, finished = fn(params, enc_out, enc_lengths)
    return BeamResult(tokens, scores, finished)  # device arrays; no sync


_JIT_CACHE = ModelJitCache()


def _beam_search_impl(
    model,
    params,
    enc_out: jnp.ndarray,
    enc_lengths: jnp.ndarray,
    *,
    beam_size: int,
    max_len: int,
    length_penalty: float = 0.0,
    lazy: bool = False,
):
    bsz, k = enc_out.shape[0], beam_size
    state = init_decode_state(model, params, enc_out, enc_lengths, max_len + 1, k)

    tokens0 = jnp.zeros((bsz, k, max_len + 1), jnp.int32).at[:, :, 0].set(BOS_ID)
    # only beam slot 0 is live initially (all slots hold identical BOS)
    scores0 = jnp.tile(
        jnp.asarray([0.0] + [NEG_INF] * (k - 1), jnp.float32)[None], (bsz, 1)
    )
    finished0 = jnp.zeros((bsz, k), bool)
    lengths0 = jnp.zeros((bsz, k), jnp.int32)

    # the beam-invariant sub-tree (cross K/V, cross bias) is a CLOSURE
    # constant of the loop body, not part of the while carry — XLA hoists
    # it once instead of threading (and potentially double-buffering) it
    # through every iteration
    static = state["static"]
    carry_state0 = state["carry"]
    gather_carry = make_gather_carry(bsz, k)

    def cond(carry):
        i, _, _, finished, _, _, _ = carry
        return (i < max_len) & ~jnp.all(finished)

    def body(carry):
        i, tokens, scores, finished, lengths, carry_state, anc = carry
        last = tokens[:, :, i].reshape(bsz * k)
        state = {"carry": carry_state, "static": static}
        if lazy:
            # position i's KV is written by each slot itself
            anc = anc.at[:, :, i].set(jnp.arange(k, dtype=jnp.int32)[None])
            logp, state = model.apply(
                params, last, state, i, anc, method="decode_step_lazy"
            )
        else:
            logp, state = model.apply(params, last, state, i, method="decode_step")
        carry_state = state["carry"]
        v = logp.shape[-1]
        logp = logp.reshape(bsz, k, v)
        # PAD/blank, UNK and BOS are never valid emissions
        logp = logp.at[:, :, :_SPECIAL_SUPPRESS].set(NEG_INF)
        # finished hyps: only EOS allowed, at zero cost (score frozen)
        eos_row = jnp.full((v,), NEG_INF, jnp.float32).at[EOS_ID].set(0.0)
        logp = jnp.where(finished[:, :, None], eos_row[None, None, :], logp)

        cand = scores[:, :, None] + logp  # (B, K, V)
        top_scores, top_idx = jax.lax.top_k(cand.reshape(bsz, k * v), k)
        parent = top_idx // v  # (B, K)
        token = (top_idx % v).astype(jnp.int32)

        if lazy:
            # reorder ONLY the tiny ancestry map; caches stay in place
            anc = jnp.take_along_axis(anc, parent[:, :, None], axis=1)
        else:
            carry_state = gather_carry(carry_state, parent)
        tokens = jnp.take_along_axis(
            tokens, parent[:, :, None], axis=1
        ).at[:, :, i + 1].set(token)
        was_finished = jnp.take_along_axis(finished, parent, axis=1)
        lengths = jnp.take_along_axis(lengths, parent, axis=1)
        lengths = jnp.where(was_finished, lengths, lengths + 1)
        finished = was_finished | (token == EOS_ID)
        return (i + 1, tokens, top_scores, finished, lengths, carry_state, anc)

    anc0 = jnp.zeros((bsz, k, max_len + 1), jnp.int32)
    carry = (
        jnp.asarray(0), tokens0, scores0, finished0, lengths0, carry_state0, anc0
    )
    _, tokens, scores, finished, lengths, _, _ = jax.lax.while_loop(
        cond, body, carry
    )

    # force-EOS semantics at maxlen: unfinished hyps are truncated (their
    # raw scores already reflect max_len tokens)
    if length_penalty > 0.0:
        norm = ((5.0 + lengths.astype(jnp.float32)) / 6.0) ** length_penalty
        sort_scores = scores / norm
    else:
        sort_scores = scores
    order = jnp.argsort(-sort_scores, axis=1)
    scores = jnp.take_along_axis(sort_scores, order, axis=1)
    tokens = jnp.take_along_axis(tokens[:, :, 1:], order[:, :, None], axis=1)
    finished = jnp.take_along_axis(finished, order, axis=1)
    return tokens, scores, finished
