"""Capture an xprof/perfetto trace of the beam search steady state and
print the top ops by total duration. Run: timeout 1200 python scripts/trace_decode.py"""
import glob
import gzip
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(batch=64, beam=10, max_len=40, vocab_size=4233, seconds=8.0,
         mode="lazy"):
    import jax
    import jax.numpy as jnp

    from asr_chinese_e2e.data.features import FeatureConfig, parse_batch
    from asr_chinese_e2e.decode.beam import beam_search
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

    if mode == "joint":
        from asr_chinese_e2e.decode.joint import joint_beam_search

        search = lambda: joint_beam_search(
            model, params, enc_out, enc_lens, beam, max_len, ctc_weight=0.3
        )
    else:
        search = lambda: beam_search(
            model, params, enc_out, enc_lens, beam, max_len,
            lazy=mode == "lazy",
        )
    r = search()

    trace_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache", "beam_trace")
    jax.profiler.start_trace(trace_dir, create_perfetto_trace=True)
    r = search()
    del r
    jax.profiler.stop_trace()

    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json.gz"),
                             recursive=True), key=os.path.getmtime)
    if not files:
        print("no perfetto trace found; files:",
              glob.glob(os.path.join(trace_dir, "**", "*"), recursive=True))
        return
    with gzip.open(files[-1], "rt") as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    # aggregate device-op durations by name
    agg = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        name = e.get("name", "?")
        args = e.get("args", {})
        if "device_duration_ps" not in args:
            continue  # host-side spans; we want device ops only
        rec = agg.setdefault(name, [0.0, 0, "", ""])
        rec[0] += e.get("dur", 0) / 1e3  # us -> ms
        rec[1] += 1
        rec[2] = args.get("long_name", "")[:160]
        rec[3] = args.get("source", "")
    top = sorted(agg.items(), key=lambda kv: -kv[1][0])[:35]
    total = sum(v[0] for v in agg.values())
    print(f"total device op-time {total:.1f} ms across {len(agg)} op names")
    for name, (ms, n, long_name, src) in top:
        print(f"{ms:9.2f} ms  x{n:5d}  {name[:40]}")
        print(f"            {long_name}")
        print(f"            {src}")


if __name__ == "__main__":
    from asr_chinese_e2e.utils.cli import parse_kwargs

    _, kwargs = parse_kwargs(sys.argv[1:])
    main(**kwargs)
