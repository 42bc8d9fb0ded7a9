#!/usr/bin/env python
"""Time each operation's candidate routes on the GPU at the flagship shapes
(B=64 utterances of 8 s: T=267 encoder frames, vocabulary 4233, 8 heads of
64). One process, one card; every line names the card and its power limit.

    python scripts/measure_routes.py

- ``ctc``: CTC loss forward+backward, Pallas kernel vs the ``lax.scan``
  recursion, at label lengths 20 and 64 (bf16 logits, as in training);
- ``step``: the whole flagship train step (``bench.main``) with each CTC
  route, in the order kernel, scan, scan, kernel;
- ``attention``: encoder self-attention forward+backward, XLA
  (``layers.attend``) vs the library Triton kernel
  (``jax.experimental.pallas.ops.gpu.attention.mha``, T padded to its
  block) and cuDNN through ``jax.nn.dot_product_attention``;
- ``frontend``: the on-device feature pipeline (fbank, CMVN, SpecAugment,
  LFR) alone, as a share of the train step;
- ``beam``: the B=64 beam-search device program (beam 10, 64 steps, random
  weights).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

B, T, C, H, D = 64, 267, 4233, 8, 64


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


CARD = None


def say(what: str, ms: float, extra: str = "") -> None:
    print(f"{what}: {ms:.3f} ms {extra}[{CARD}]", flush=True)


def timed(fn, *args, n=30) -> float:
    """Mean wall time (ms) per call after a compile+warm call; every call
    ends in block_until_ready."""
    jax.block_until_ready(fn(*args))
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3


def measure_ctc():
    from asr_chinese_e2e.ops.ctc import ctc_loss
    from asr_chinese_e2e.ops.ctc_pallas import ctc_loss_pallas

    rng = np.random.RandomState(0)
    logits = jnp.asarray(rng.randn(B, T, C) * 3, jnp.bfloat16)
    lens = jnp.asarray(rng.randint(200, T + 1, size=B), jnp.int32)
    for L in (20, 64):
        labels = jnp.asarray(rng.randint(4, C, size=(B, L)), jnp.int32)
        ll = jnp.full((B,), L, jnp.int32)
        for name, fn in (("kernel", ctc_loss_pallas), ("scan", ctc_loss)):
            g = jax.jit(jax.value_and_grad(
                lambda x, fn=fn: fn(x, lens, labels, ll).mean()
            ))
            say(f"ctc fwd+bwd L={L} {name}", timed(g, logits))


def measure_step():
    import bench

    results = {}
    for route in ("pallas", "scan", "scan", "pallas"):
        r = bench.main(ctc_impl=route, n_steps=40, _return_result=True)
        results.setdefault(route, []).append(1e3 / r["steps_per_s"])
        say(f"train step ctc={route}", 1e3 / r["steps_per_s"],
            f"({r['steps_per_s']} steps/s, MFU {r['mfu']}) ")
    return float(np.mean(results["pallas"]))


def measure_attention():
    from jax.experimental.pallas.ops.gpu import attention as lib

    from asr_chinese_e2e.models.layers import attend
    from asr_chinese_e2e.ops.masks import padding_bias

    rng = np.random.RandomState(1)
    mk = lambda: jnp.asarray(rng.randn(B, T, H, D), jnp.bfloat16)
    q, k, v = mk(), mk(), mk()
    lens = jnp.asarray(rng.randint(200, T + 1, size=B), jnp.int32)
    cot = jnp.asarray(rng.randn(B, T, H, D), jnp.bfloat16)

    def xla(q, k, v):
        return attend(q, k, v, padding_bias(lens, T), jnp.bfloat16)

    def fwd_bwd(f):
        return jax.jit(jax.grad(
            lambda q, k, v: jnp.sum(f(q, k, v).astype(jnp.float32) * cot),
            argnums=(0, 1, 2),
        ))

    say("attention fwd+bwd xla", timed(fwd_bwd(xla), q, k, v))
    for block, tp in ((128, 384), (64, 320)):
        sizes = lib.BlockSizes(
            block_q=block, block_k=block, block_q_dkv=32, block_kv_dkv=32,
            block_q_dq=32, block_kv_dq=32,
        )
        seg = (jnp.arange(tp)[None] < lens[:, None]).astype(jnp.int32)
        pad = lambda a: jnp.pad(a, ((0, 0), (0, tp - T), (0, 0), (0, 0)))

        def library(q, k, v, sizes=sizes, seg=seg, pad=pad):
            out = lib.mha(
                pad(q), pad(k), pad(v), seg, sm_scale=1.0 / np.sqrt(D),
                block_sizes=sizes,
            )
            return out[:, :T]

        say(f"attention fwd+bwd library triton mha (T padded to {tp})",
            timed(fwd_bwd(library), q, k, v))

    def cudnn(q, k, v):
        return jax.nn.dot_product_attention(
            q, k, v, key_value_seq_lengths=lens, implementation="cudnn"
        )

    try:
        say("attention fwd+bwd cudnn (no weight dropout)",
            timed(fwd_bwd(cudnn), q, k, v))
    except Exception as e:  # a measurement: report the route as unavailable
        print(f"attention cudnn: unavailable ({type(e).__name__}: "
              f"{str(e)[:200]})", flush=True)


def measure_frontend(step_ms: float):
    from asr_chinese_e2e.data.features import FeatureConfig, parse_batch

    cfg = FeatureConfig()
    n = 8 * cfg.sample_rate
    wave = jnp.asarray(np.random.RandomState(2).randn(B, n) * 0.1, jnp.float32)
    lens = jnp.full((B,), n, jnp.int32)
    key = jax.random.key(0, impl="rbg")
    f = jax.jit(lambda w, l, r: parse_batch(w, l, cfg, augment=True, rng=r))
    ms = timed(f, wave, lens, key)
    say("frontend (fbank+CMVN+SpecAugment+LFR) alone", ms,
        f"= {ms / step_ms:.1%} of the {step_ms:.3f} ms train step ")


def measure_beam():
    from asr_chinese_e2e.decode import beam as beam_mod
    from asr_chinese_e2e.models.transformer import SpeechTransformer, default_config

    cfg = default_config().build(ctc_weight=0.3, dtype="bfloat16", input_dim=320)
    rng = np.random.RandomState(3)
    feats = jnp.asarray(rng.randn(B, T, 320), jnp.float32)
    lens = jnp.full((B,), T, jnp.int32)
    labels = jnp.zeros((B, 4), jnp.int32)
    params = SpeechTransformer(cfg, C).init(
        jax.random.PRNGKey(0), feats, lens, labels, jnp.ones((B,), jnp.int32)
    )
    model = SpeechTransformer(cfg, C)
    enc, enc_lens = jax.jit(
        lambda p, f, l: model.apply(p, f, l, method="encode")
    )(params, feats, lens)
    run = lambda p, e, l: beam_mod.beam_search(model, p, e, l, 10, 64).scores
    say("beam search B=64 K=10 64 steps", timed(run, params, enc, enc_lens, n=5))


def main():
    global CARD
    if jax.default_backend() != "gpu":
        raise SystemExit(f"needs a GPU; JAX backend is {jax.default_backend()!r}")
    CARD = card()
    measure_ctc()
    step_ms = measure_step()
    measure_attention()
    measure_frontend(step_ms)
    measure_beam()


if __name__ == "__main__":
    main()
