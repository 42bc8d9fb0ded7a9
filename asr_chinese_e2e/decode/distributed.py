"""Distributed decode: data-parallel beam search + cross-shard score
exchange via collectives.

North-star requirement (BASELINE.json: "beam-search scores exchanged via
collectives for distributed rescoring"; SURVEY §2.8 build table: "beam state
replicated per data shard; cross-host score exchange via all_gather of
(B_local, beam) score tiles for global n-best"). The reference has no
distributed anything (SURVEY §2.8).

Design: decoding is data-parallel — each device owns a batch shard's
encoder outputs and beam state and runs the FULL device beam locally
(``decode/beam.py``'s while-loop program under ``shard_map``); only the
finished hypothesis tiles cross the interconnect:

- ``distributed_beam_search``: the end-to-end pipeline — encoder outputs
  sharded over ``data``, one beam program per shard, then one tiled
  all_gather of the (B_local, K, L) token + (B_local, K) score tiles so
  every host holds the global n-best. Exposed via ``recognize.py
  --mesh_data`` and the Trainer's ``eval_decode`` under a mesh.

Second-pass rescoring exchanges only the (B_local, K) score tiles (a few
KB) over NVLink (NCCL), never the encoder states:

- ``exchange_scores``: all_gather per-shard score tiles along ``data`` so
  every device sees the global (B, K) score matrix (for global n-best
  selection / normalisation);
- ``distributed_rescore_scores``: fuses per-shard CTC scores with
  per-shard attention scores, all_gathers the fused tiles, and returns the
  globally-assembled (B, K) matrix with the argmax hypothesis index per
  utterance.

All functions run inside ``shard_map``/``pjit`` bodies with the mesh axis
name passed in; XLA lowers the all_gather to NCCL.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .beam import BeamResult, _beam_search_impl, beam_search
from .jit_cache import ModelJitCache

_JIT_CACHE = ModelJitCache()


def distributed_beam_search(
    model,
    params,
    enc_out: jnp.ndarray,
    enc_lengths: jnp.ndarray,
    beam_size: int,
    max_len: int,
    mesh,
    length_penalty: float = 0.0,
    data_axis: str = "data",
) -> BeamResult:
    """Data-parallel batched beam search over ``mesh``.

    Each ``data`` shard runs the complete fixed-shape device beam on its
    local encoder rows (beam rows are independent across utterances, so
    no mid-search communication is needed); the finished token/score/
    finished tiles are then all_gathered (tiled on the batch dim) so the
    returned global n-best is identical to the single-device
    ``beam_search`` on the same inputs — the property
    ``tests/test_distributed_decode.py`` asserts on the virtual mesh.

    Falls back to the unsharded beam when the batch does not divide the
    ``data`` axis. The reference's beam is a per-utterance Python loop
    with no distribution story (``transformer_official.py:331-434``)."""
    dp = mesh.shape.get(data_axis, 1)
    if dp == 1 or enc_out.shape[0] % dp:
        return beam_search(
            model, params, enc_out, enc_lengths, beam_size, max_len,
            length_penalty,
        )
    lazy = hasattr(model, "decode_step_lazy")
    cache = _JIT_CACHE.scope(model)
    key = ("dist", beam_size, max_len, length_penalty, lazy, mesh, data_axis)
    fn = cache.get(key)
    if fn is None:
        from jax.sharding import PartitionSpec as P

        impl = functools.partial(
            _beam_search_impl,
            model,
            beam_size=beam_size,
            max_len=max_len,
            length_penalty=length_penalty,
            lazy=lazy,
        )

        def shard_body(p, eo, el):
            tokens, scores, finished = impl(p, eo, el)
            ag = lambda x: jax.lax.all_gather(x, data_axis, axis=0, tiled=True)
            return ag(tokens), ag(scores), ag(finished)

        fn = jax.jit(
            jax.shard_map(
                shard_body,
                mesh=mesh,
                in_specs=(P(), P(data_axis), P(data_axis)),
                out_specs=(P(), P(), P()),
                check_vma=False,
            )
        )
        cache[key] = fn
    # place inputs on the mesh: params replicated, encoder rows sharded
    # over `data` (arrays committed to a single device would otherwise
    # conflict with the mesh's device set)
    from jax.sharding import NamedSharding, PartitionSpec

    params = jax.device_put(params, NamedSharding(mesh, PartitionSpec()))
    row_sh = NamedSharding(mesh, PartitionSpec(data_axis))
    enc_out = jax.device_put(enc_out, row_sh)
    enc_lengths = jax.device_put(enc_lengths, row_sh)
    tokens, scores, finished = fn(params, enc_out, enc_lengths)
    return BeamResult(tokens, scores, finished)  # device arrays; no sync


def exchange_scores(local_scores: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """(B_local, K) score tile -> (B_global, K) via all_gather along
    ``axis_name`` (tiled: shards concatenate on the batch dim)."""
    return jax.lax.all_gather(local_scores, axis_name, axis=0, tiled=True)


def distributed_rescore_scores(
    ctc_scores: jnp.ndarray,  # (B_local, K)
    att_scores: jnp.ndarray,  # (B_local, K)
    ctc_weight: float,
    axis_name: str,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Fuse λ·ctc + (1−λ)·att per shard, exchange tiles, return the global
    (B, K) fused scores and per-utterance argmax hypothesis index."""
    fused = ctc_weight * ctc_scores + (1.0 - ctc_weight) * att_scores
    global_fused = exchange_scores(fused, axis_name)
    best = jnp.argmax(global_fused, axis=-1)
    return global_fused, best


def make_sharded_rescorer(mesh, data_axis: str = "data"):
    """jit-compiled (ctc_scores, att_scores, λ) -> (global scores, best idx)
    with score tiles sharded over ``data_axis``."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def fn(ctc_scores, att_scores, ctc_weight):
        return distributed_rescore_scores(
            ctc_scores, att_scores, ctc_weight, data_axis
        )

    return jax.jit(
        shard_map(
            fn,
            mesh=mesh,
            in_specs=(P(data_axis), P(data_axis), P()),
            out_specs=(P(), P()),
            # all_gather output is value-identical across the data axis but
            # the static VMA analysis can't prove it — disable the check
            check_vma=False,
        )
    )
