"""Capture a device trace of the flagship train step and print the top ops
by total duration. Run: timeout 1200 python scripts/trace_train.py
"""
import glob
import gzip
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(
    seconds=8.0, batch=64, vocab_size=4233, label_len=20, ctc_weight=0.3,
    dtype="bfloat16", attn_impl="xla", n_steps=3, **model_overrides
):
    import jax

    from asr_chinese_e2e.data.features import FeatureConfig
    from asr_chinese_e2e.models.transformer import (
        SpeechTransformer,
        default_config,
    )
    from asr_chinese_e2e.train.optimizer import (
        default_train_config,
        make_optimizer,
    )
    from asr_chinese_e2e.train.train_step import make_step_fns

    feat_cfg = FeatureConfig()
    cfg = default_config().build(
        ctc_weight=ctc_weight, dtype=dtype, input_dim=feat_cfg.feature_dim,
        attn_impl=attn_impl, **model_overrides,
    )
    tcfg = default_train_config().combine(cfg).build(spec_augment=True)
    model = SpeechTransformer(cfg, vocab_size)
    tx = make_optimizer(tcfg, cfg.d_model)
    init_fn, train_step, _ = make_step_fns(model, tx, feat_cfg, tcfg)

    rng = np.random.RandomState(0)
    samples = int(seconds * feat_cfg.sample_rate)
    batch_d = {
        "wave": np.asarray(rng.randn(batch, samples) * 0.1, np.float32),
        "wave_lengths": np.full((batch,), samples, np.int32),
        "labels": rng.randint(4, vocab_size, size=(batch, label_len)).astype(np.int32),
        "label_lengths": np.full((batch,), label_len, np.int32),
    }
    state = init_fn(jax.random.PRNGKey(0), batch_d)
    args = [
        jax.device_put(batch_d[k])
        for k in ("wave", "wave_lengths", "labels", "label_lengths")
    ]
    step_rng = jax.random.key(1, impl=tcfg.get("rng_impl", "rbg"))
    state, metrics = train_step(state, *args, step_rng)
    jax.block_until_ready(metrics["loss"])
    for _ in range(2):
        state, metrics = train_step(state, *args, step_rng)
    jax.block_until_ready(metrics["loss"])

    trace_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache", "train_trace")
    jax.profiler.start_trace(trace_dir, create_perfetto_trace=True)
    for _ in range(n_steps):
        state, metrics = train_step(state, *args, step_rng)
    jax.block_until_ready(metrics["loss"])
    jax.profiler.stop_trace()

    files = sorted(glob.glob(os.path.join(trace_dir, "**", "perfetto_trace.json.gz"),
                             recursive=True), key=os.path.getmtime)
    with gzip.open(files[-1], "rt") as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    agg = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        args_d = e.get("args", {})
        if "device_duration_ps" not in args_d:
            continue
        name = e.get("name", "?")
        rec = agg.setdefault(name, [0.0, 0, "", ""])
        rec[0] += e.get("dur", 0) / 1e3
        rec[1] += 1
        rec[2] = args_d.get("long_name", "")[:150]
        rec[3] = args_d.get("source", "")
    top = sorted(agg.items(), key=lambda kv: -kv[1][0])[:40]
    total = sum(v[0] for v in agg.values())
    print(f"total device op-time {total:.1f} ms over {n_steps} steps "
          f"({total / n_steps:.2f} ms/step) across {len(agg)} op names")
    for name, (ms, n, long_name, src) in top:
        print(f"{ms / n_steps:8.3f} ms/step  x{n:4d}  {name[:36]}")
        print(f"            {long_name}")
        print(f"            {src}")


if __name__ == "__main__":
    from asr_chinese_e2e.utils.cli import parse_kwargs

    _, kwargs = parse_kwargs(sys.argv[1:])
    main(**kwargs)
