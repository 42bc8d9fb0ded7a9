"""Streaming recognizer latency on the GPU (round-3 VERDICT #8).

Times the two dispatch paths of ``StreamingRecognizer`` at every duration
bucket, flagship model shapes (512d/8h/6+6L, vocab 4233, bf16):

- **partial**: encode(padded open prefix) + CTC head + greedy collapse +
  detok — the per-cadence cost of a live caption;
- **final**: the configured decode mode over the closed segment
  (ctc_greedy | beam | joint).

Latency does not depend on the weights, so an untrained model is used.
Run:  timeout 2400 python scripts/bench_stream.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(
    vocab_size: int = 4233,
    dtype: str = "bfloat16",
    beam: int = 10,
    max_len: int = 40,
    n_iters: int = 10,
    bucket_seconds: str = "2,4,8",
    modes: str = "ctc_greedy,beam,joint",
    cpu: bool = False,
    **model_overrides,
):
    import jax

    if cpu:  # tiny-shape smoke mode (pass e.g. --d_model=64 --num_heads=2)
        jax.config.update("jax_platforms", "cpu")

    from asr_chinese_e2e.data.features import FeatureConfig, parse_batch
    from asr_chinese_e2e.data.vocab import Vocab
    from asr_chinese_e2e.models.transformer import (
        SpeechTransformer,
        default_config,
    )
    from asr_chinese_e2e.stream import StreamingRecognizer
    from asr_chinese_e2e.utils.synth import (
        char_freqs,
        filler_chars,
        synth_wave,
        tone_chars,
    )

    feat_cfg = FeatureConfig()
    cfg = default_config().build(
        ctc_weight=0.3, dtype=dtype, input_dim=feat_cfg.feature_dim,
        dropout_rate=0.0, **model_overrides,
    )
    model = SpeechTransformer(cfg, vocab_size)

    # vocab over the tone chars (decode output content is irrelevant to
    # latency; a real vocab exercises the detok path)
    chars = tone_chars(40)
    v = Vocab()
    # fill to the head's vocab size so untrained argmax ids all detok
    v.consume_sentence_list([chars, filler_chars(40, vocab_size - 44)])
    vocab = v.build(max_vocab=vocab_size)

    rng = np.random.RandomState(0)
    sr = feat_cfg.sample_rate
    wave = rng.randn(2, sr).astype(np.float32) * 0.1
    feats, feat_lens = parse_batch(
        jax.numpy.asarray(wave), jax.numpy.full((2,), sr, np.int32), feat_cfg
    )
    labels = jax.numpy.ones((2, 8), np.int32) * 4
    params = model.init(
        jax.random.PRNGKey(0), feats, feat_lens, labels,
        jax.numpy.full((2,), 8, np.int32),
    )

    buckets = [float(s) for s in bucket_seconds.split(",")]
    freqs = char_freqs(40)
    rows = []
    for mode in modes.split(","):
        rec = StreamingRecognizer(
            model, params, vocab, feat_cfg, mode=mode,
            bucket_seconds=buckets, beam_size=beam, max_len=max_len,
        )
        for sec in buckets:
            n_char = max(1, int(sec / 0.3))
            text = "".join(chars[rng.randint(40)] for _ in range(n_char))
            seg = (synth_wave(text, chars, freqs, rng) * 32767).astype(np.int16)
            seg = seg[: int(sec * sr)]

            # partial path: encode + CTC greedy + detok over the prefix
            t0 = time.perf_counter()
            _, enc_lens, lp = rec._run_encode(seg)
            rec._ctc_text(lp, enc_lens)
            compile_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(n_iters):
                _, enc_lens, lp = rec._run_encode(seg)
                rec._ctc_text(lp, enc_lens)
            partial_ms = (time.perf_counter() - t0) / n_iters * 1e3

            # final path: the configured mode end-to-end
            t0 = time.perf_counter()
            rec._final_text(seg)
            final_compile_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(n_iters):
                rec._final_text(seg)
            final_ms = (time.perf_counter() - t0) / n_iters * 1e3

            rows.append((mode, sec, partial_ms, final_ms))
            print(
                f"[{mode} bucket={sec:g}s] partial {partial_ms:.1f} ms, "
                f"final {final_ms:.1f} ms "
                f"(compiles {compile_s:.0f}s/{final_compile_s:.0f}s)",
                flush=True,
            )

    print("\nmode | bucket | partial ms | final ms")
    for mode, sec, p, f in rows:
        print(f"{mode} | {sec:g}s | {p:.1f} | {f:.1f}")

    # ---- incremental (chunked causal-banded) arm ----------------------
    # Same params (causal_encoder/attention_band only change the attention
    # BIAS, not the parameter tree); fixed CMVN; partial cost is one chunk
    # program + host CTC collapse, independent of the prefix length.
    from asr_chinese_e2e.core.config import Config

    inc_cfg = Config(**dict(cfg.items())).build(
        causal_encoder=True, attention_band=50
    )
    inc_feat = FeatureConfig(cmvn_mode="fixed", cmvn_mean=-18.0, cmvn_std=6.0)
    inc_model = SpeechTransformer(inc_cfg, vocab_size)
    sec = buckets[-1]
    n_char = max(1, int(sec / 0.3))
    text = "".join(chars[rng.randint(40)] for _ in range(n_char))
    seg = (synth_wave(text, chars, freqs, rng) * 32767).astype(np.int16)
    seg = seg[: int(sec * sr)]
    cadence = int(1.0 * sr)
    for mode in modes.split(","):
        rec = StreamingRecognizer(
            inc_model, params, vocab, inc_feat, mode=mode,
            bucket_seconds=buckets, beam_size=beam, max_len=max_len,
            incremental="on",
        )
        # warm the chunk program + final path once
        for i in range(cadence, len(seg), cadence):
            rec._inc_advance(0, seg[:i], final=False)
            rec._inc_text()
        rec._inc_final_text(0, seg)
        lat = []
        final_s = 0.0
        for _ in range(n_iters):
            rec._inc_reset(-1)  # force fresh segment state
            for i in range(cadence, len(seg), cadence):
                t0 = time.perf_counter()
                rec._inc_advance(0, seg[:i], final=False)
                rec._inc_text()
                lat.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            rec._inc_final_text(0, seg)
            final_s += time.perf_counter() - t0
        lat_ms = np.asarray(lat) * 1e3
        print(
            f"[incremental {mode} seg={sec:g}s] partial cadence "
            f"mean {lat_ms.mean():.1f} ms / p95 "
            f"{np.percentile(lat_ms, 95):.1f} ms (prefix-independent), "
            f"final {final_s / n_iters * 1e3:.1f} ms",
            flush=True,
        )


if __name__ == "__main__":
    from asr_chinese_e2e.utils.cli import parse_kwargs

    _, kwargs = parse_kwargs(sys.argv[1:])
    main(**kwargs)
