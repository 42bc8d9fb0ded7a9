"""Micro-profile of the beam decode step on the GPU: times each component
(decode_step forward, top_k prune, bookkeeping gathers) separately to find
where the step time goes. Run: timeout 1200 python scripts/profile_decode.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def timeit(fn, *args, n=20, name=""):
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n * 1e3
    print(f"{name:45s} {dt:8.2f} ms")
    return out


def main(batch=64, beam=10, max_len=40, vocab_size=4233, seconds=8.0):
    import jax
    import jax.numpy as jnp

    from asr_chinese_e2e.data.features import FeatureConfig, parse_batch
    from asr_chinese_e2e.models.transformer import (
        SpeechTransformer,
        default_config,
    )

    feat_cfg = FeatureConfig()
    cfg = default_config().build(
        ctc_weight=0.3, dtype="bfloat16", input_dim=feat_cfg.feature_dim,
        dropout_rate=0.0,
    )
    model = SpeechTransformer(cfg, vocab_size)
    rng = np.random.RandomState(0)
    samples = int(seconds * feat_cfg.sample_rate)
    wave = jnp.asarray(rng.randn(batch, samples).astype(np.float32) * 0.1)
    wave_len = jnp.full((batch,), samples, np.int32)
    labels = jnp.asarray(rng.randint(4, vocab_size, size=(batch, 20)).astype(np.int32))
    label_lens = jnp.full((batch,), 20, np.int32)
    feats, feat_lens = parse_batch(wave, wave_len, feat_cfg)
    params = model.init(jax.random.PRNGKey(0), feats, feat_lens, labels, label_lens)
    enc_out, enc_lens = model.apply(params, feats, feat_lens, method="encode")
    jax.block_until_ready(enc_out)

    bk = batch * beam
    enc_out_x = jnp.repeat(enc_out, beam, axis=0)
    enc_len_x = jnp.repeat(enc_lens, beam, axis=0)

    init_state = jax.jit(
        lambda p, e, el: model.apply(
            p, e, el, max_len + 1, method="init_decode_state"
        )
    )
    state = timeit(init_state, params, enc_out_x, enc_len_x, n=5,
                   name="init_decode_state (cross kv)")

    tokens = jnp.full((bk,), 2, jnp.int32)
    anc = jnp.zeros((batch, beam, max_len + 1), jnp.int32)

    step_lazy = jax.jit(
        lambda p, t, s, a: model.apply(p, t, s, 5, a, method="decode_step_lazy")
    )
    logp, _ = timeit(step_lazy, params, tokens, state, anc, n=20,
                     name="decode_step_lazy (6L fwd, B*K=640)")

    step_plain = jax.jit(
        lambda p, t, s: model.apply(p, t, s, 5, method="decode_step")
    )
    timeit(step_plain, params, tokens, state, n=20,
           name="decode_step (6L fwd, B*K=640)")

    # beam bookkeeping: top_k over (B, K*V)
    scores = jnp.zeros((batch, beam), jnp.float32)
    cand = (scores[:, :, None] + logp.reshape(batch, beam, -1)).reshape(
        batch, beam * vocab_size
    )
    topk = jax.jit(lambda c: jax.lax.top_k(c, beam))
    timeit(topk, cand, n=20, name=f"lax.top_k (64, {beam * vocab_size})")

    # physical gather of self caches (the old reorder)
    flat_parent = jnp.arange(bk, dtype=jnp.int32)

    def gather(state, fp):
        return jax.tree_util.tree_map(lambda x: x[fp], state["carry"])

    timeit(jax.jit(gather), state, flat_parent, n=20,
           name="physical self-cache gather (B*K=640)")

    # cross-attention only: one layer's step_cross-equivalent einsum
    cc = state["static"]["cross"][0]
    q = jnp.zeros((bk, 1, 8, 64), jnp.bfloat16)

    def cross_once(q, k, v):
        s = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                       preferred_element_type=jnp.float32)
        w = jax.nn.softmax(s, -1).astype(jnp.bfloat16)
        return jnp.einsum("bhqk,bkhd->bqhd", w, v)

    timeit(jax.jit(cross_once), q, cc["k"], cc["v"], n=20,
           name="one cross-attn einsum (640, 267)")


if __name__ == "__main__":
    main()
