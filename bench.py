#!/usr/bin/env python
"""Training-throughput benchmark on the flagship model.

Measures audio-seconds/s/chip (the BASELINE.json north-star metric) for the
full jitted training step — on-device fbank/CMVN/LFR + SpeechTransformer
(reference hyperparams 512d/8h/6+6L, ``transformer_official.py:112-124``)
+ hybrid CTC/CE loss + Noam/Adam — on synthetic 8-second utterances at the
reference batch size 64 (``main.py:103``).

Prints ONE JSON line:
    {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, ...}
echoing the platform, ``device_kind``, device count, resolved routes and
``XLA_FLAGS``. Device metrics (MFU) come only from a GPU listed in
``PEAK_BF16_FLOPS``; a CPU run is a rehearsal and reports none.

``vs_baseline`` is null: the reference publishes no benchmark numbers
(README "Under progress"; BASELINE.md — "published": {}).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# Published dense bf16 peak FLOP/s, keyed by exact ``device_kind``
# (NVIDIA H100 SXM data sheet, at its 700 W power limit).
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}
ROOT = os.path.dirname(os.path.abspath(__file__))


def peak_bf16_flops(device):
    """Published bf16 peak of ``device``: None on the CPU (a rehearsal has
    no device metric); a GPU missing from the table is an error — no peak
    is assumed for it."""
    if device.platform == "cpu":
        return None
    if device.device_kind not in PEAK_BF16_FLOPS:
        raise KeyError(
            f"no published peak for {device.device_kind!r}; add it to "
            "PEAK_BF16_FLOPS with its source"
        )
    return PEAK_BF16_FLOPS[device.device_kind]


def run_record(cfg, devices) -> dict:
    """Where and how a measurement ran: echoed in every JSON line."""
    from asr_chinese_e2e.train.train_step import resolved_routes

    return {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "routes": resolved_routes(cfg),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }


def mfu(flops_per_step, steps_per_s, devices):
    peak = peak_bf16_flops(devices[0])
    if peak is None:
        return None
    return round(flops_per_step * steps_per_s / peak / len(devices), 4)


def analytic_train_flops(
    cfg, feat_cfg, vocab_size: int, batch: int, n_samples: int, label_len: int
) -> float:
    """Analytic matmul FLOPs for ONE train step (fwd + bwd ≈ 3× fwd).

    Counts the matmuls only (projections, attention einsums,
    FFNs, vocab heads, DFT-as-matmul fbank); elementwise/softmax/norm work
    is bandwidth-, not FLOP-, bound and excluded — standard MFU accounting.
    """
    d = cfg.d_model
    ff = cfg.d_ff
    le, ld = cfg.num_encoder_layers, cfg.num_decoder_layers
    t_frames = feat_cfg.num_frames(n_samples)
    t = feat_cfg.num_lfr_frames(t_frames)
    feat_dim = feat_cfg.feature_dim
    l = label_len + 1  # decoder is BOS-prefixed
    v = vocab_size
    n_bins = feat_cfg.n_fft // 2 + 1
    win = feat_cfg.win_length

    fwd = 0.0
    # fbank: windowed DFT as matmul (re+im) + mel projection
    fwd += t_frames * win * (2 * n_bins) * 2
    fwd += t_frames * n_bins * feat_cfg.n_mels * 2
    # encoder
    fwd += t * feat_dim * d * 2  # input proj
    fwd += le * (4 * t * d * d * 2)  # QKVO
    fwd += le * (2 * t * t * d * 2)  # scores + context
    fwd += le * (2 * t * d * ff * 2)  # FFN
    # heads
    ctc_w = float(cfg.get("ctc_weight", 0.0))
    if ctc_w > 0:
        fwd += t * d * v * 2  # CTC head
    # decoder
    fwd += ld * (4 * l * d * d * 2)  # self QKVO
    fwd += ld * (2 * l * l * d * 2)  # self attn
    fwd += ld * (2 * l * d * d * 2)  # cross Q,O
    fwd += ld * (2 * t * d * d * 2)  # cross K,V
    fwd += ld * (2 * l * t * d * 2)  # cross attn
    fwd += ld * (2 * l * d * ff * 2)  # FFN
    fwd += l * d * v * 2  # output proj (tied embed)
    return 3.0 * fwd * batch


def via_trainer_main(
    seconds: float = 8.0,
    batch: int = 64,
    vocab_size: int = 4233,
    ctc_weight: float = 0.3,
    dtype: str = "bfloat16",
    n_batches: int = 120,
    attn_impl: str = "xla",
    steps_per_dispatch: int = 1,
    corpus_dir: str = os.path.join(ROOT, ".cache", "bench_corpus"),
    wire_dtype: str = "int16",
    log_every_iter: int = 50,
    **model_overrides,
):
    """Integrated-Trainer throughput: drive the REAL ``Trainer.train_epoch``
    — BucketedLoader (native IO + prefetch), ``_put_batch``, metrics drain,
    throughput meter — on a synthetic corpus at flagship shapes. Epoch 0
    compiles + warms; epoch 1 is measured wall-to-wall (round-2 VERDICT #1:
    the headline number must be the shipped recipe's number, at
    loader-real label shapes)."""
    import shutil
    import tempfile

    import jax

    from asr_chinese_e2e.data.batching import BucketedLoader
    from asr_chinese_e2e.data.features import FeatureConfig
    from asr_chinese_e2e.data.vocab import Vocab
    from asr_chinese_e2e.models.transformer import (
        SpeechTransformer,
        default_config,
    )
    from asr_chinese_e2e.train.optimizer import (
        default_train_config,
        make_optimizer,
    )
    from asr_chinese_e2e.train.trainer import Trainer
    from asr_chinese_e2e.utils.synth import make_synth_corpus

    # fixed-duration corpus (one bucket) for comparability with the raw-step
    # bench; tone 0.4 s -> 8 s = 20 chars, the raw bench's label_len.
    # Disk economy: a pool of unique wavs, manifest rows cycle through it
    # (the loader's IO path reads a real file per row either way).
    n_utts = n_batches * batch
    n_unique = min(n_utts, 640)
    paths = make_synth_corpus(
        corpus_dir, n_train=n_unique, n_dev=0, n_test=0,
        seconds_range=(seconds, seconds), tone_sec=seconds / 20.0,
    )
    if n_utts > n_unique:
        rows = open(paths["train"]).read().splitlines()
        expanded = os.path.join(corpus_dir, f"train_x{n_utts}.jsonl")
        with open(expanded, "w") as f:
            for i in range(n_utts):
                f.write(rows[i % n_unique] + "\n")
        paths["train"] = expanded
    vocab = Vocab.load(paths["vocab"])
    assert vocab.vocab_size == vocab_size

    feat_cfg = FeatureConfig()
    cfg = default_config().build(
        ctc_weight=ctc_weight, dtype=dtype, input_dim=feat_cfg.feature_dim,
        attn_impl=attn_impl, **model_overrides,
    )
    exp_root = tempfile.mkdtemp(prefix="bench_via_trainer_")
    tcfg = default_train_config().combine(cfg).build(
        spec_augment=True, exp_root=exp_root, exp_name="bench",
        log_every_iter=int(log_every_iter),
        eval_every_iter=1 << 30, save_every_iter=1 << 30,
        num_epoch=2, steps_per_dispatch=int(steps_per_dispatch),
        eval_decode="none",
    )
    model = SpeechTransformer(cfg, vocab.vocab_size)
    tx = make_optimizer(tcfg, cfg.d_model)
    loader = BucketedLoader(
        paths["train"], vocab, batch_size=batch,
        max_target_len=tcfg.get("max_target_len", 64),
        wire_dtype=wire_dtype,
    )
    log(f"loader: {len(loader)} batches/epoch, label boundaries "
        f"{loader.label_boundaries}")
    trainer = Trainer(model, tx, tcfg, feat_cfg, vocab, train_loader=loader)

    t0 = time.perf_counter()
    trainer._init_state()
    log(f"init: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    trainer.train_epoch(0)  # compile + warm
    jax.block_until_ready(trainer.state.step)
    log(f"epoch 0 (compile+warm): {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    trainer.train_epoch(1)
    jax.block_until_ready(trainer.state.step)
    wall = time.perf_counter() - t0
    n_steps_done = len(loader)
    audio_s = n_steps_done * batch * seconds
    n_chips = trainer.throughput.n_chips
    value = audio_s / wall / n_chips
    steps_per_s = n_steps_done / wall
    label_boundary = next(iter(loader.label_boundaries.values()))
    flops = analytic_train_flops(
        cfg, feat_cfg, vocab.vocab_size, batch, int(seconds * 16000),
        label_boundary,
    )
    devices = list(jax.devices()[:n_chips])
    util = mfu(flops, steps_per_s, devices)
    log(
        f"epoch 1: {n_steps_done} steps in {wall:.2f}s -> "
        f"{steps_per_s:.2f} steps/s, {value:.1f} audio-s/s/chip "
        f"(labels at L={label_boundary}, MFU {util}); meter: "
        f"{trainer.throughput.audio_seconds_per_sec_per_chip:.1f}"
    )
    shutil.rmtree(exp_root, ignore_errors=True)
    print(
        json.dumps(
            {
                "metric": "integrated_trainer_throughput_audio_seconds_per_sec_per_chip",
                "value": round(value, 2),
                "unit": "audio-s/s/chip",
                "vs_baseline": None,
                "steps_per_s": round(steps_per_s, 3),
                "label_boundary": label_boundary,
                "mfu": util,
                **run_record(tcfg, devices),
            }
        )
    )


def main(
    seconds: float = 8.0,
    batch: int = 64,
    vocab_size: int = 4233,  # AISHELL-1 char vocab scale
    label_len: int = 20,
    ctc_weight: float = 0.3,
    dtype: str = "bfloat16",
    n_steps: int = 40,
    sync_every: int = 0,  # host pacing: steps per block_until_ready;
    # 0 = drain once at the end
    attn_impl: str = "xla",  # "xla" | "ring" (sequence parallelism)
    dropout_impl: str = "hash",  # fusible index-hash dropout masks; the
    # library default stays "rng" for reference-faithful mask provenance
    steps_per_dispatch: int = 1,  # k train steps per jitted dispatch
    # (train_step.make_multi_step) — amortizes per-dispatch latency
    n_chips: int = 0,  # 0 = all visible devices; k = first k devices (the
    # scaling-sweep knob — see scaling_main)
    _return_result: bool = False,
    **model_overrides,
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

    bench_devices = jax.devices()[: n_chips or None]
    n_chips = len(bench_devices)
    log(f"devices ({n_chips}): {bench_devices}")

    feat_cfg = FeatureConfig()
    cfg = default_config().build(
        ctc_weight=ctc_weight, dtype=dtype, input_dim=feat_cfg.feature_dim,
        attn_impl=attn_impl, dropout_impl=dropout_impl, **model_overrides,
    )
    tcfg = default_train_config().combine(cfg).build(spec_augment=True)
    model = SpeechTransformer(cfg, vocab_size)
    tx = make_optimizer(tcfg, cfg.d_model)
    init_fn, train_step, _ = make_step_fns(model, tx, feat_cfg, tcfg)

    rng = np.random.RandomState(0)
    samples = int(seconds * feat_cfg.sample_rate)
    host_batch = {
        "wave": np.asarray(rng.randn(batch, samples) * 0.1, np.float32),
        "wave_lengths": np.full((batch,), samples, np.int32),
        "labels": rng.randint(4, vocab_size, size=(batch, label_len)).astype(
            np.int32
        ),
        "label_lengths": np.full((batch,), label_len, np.int32),
    }

    mesh = None
    if n_chips > 1:
        from asr_chinese_e2e.parallel.sharding import (
            batch_sharding,
            make_mesh,
            replicated,
        )

        mesh = make_mesh(data=n_chips, devices=bench_devices)
        # the CTC kernel shards over the mesh via shard_map; re-wrap the
        # step so tracing sees the mesh context
        from asr_chinese_e2e.parallel.context import active_mesh

        _raw_step = train_step

        def train_step(state, *a):
            with active_mesh(mesh):
                return _raw_step(state, *a)

    t0 = time.perf_counter()
    state = init_fn(jax.random.PRNGKey(0), host_batch)
    log(f"init: {time.perf_counter() - t0:.1f}s")

    if mesh is not None:
        state = jax.device_put(state, replicated(mesh))
        sh = batch_sharding(mesh)
        args = [
            jax.device_put(host_batch[k], sh)
            for k in ("wave", "wave_lengths", "labels", "label_lengths")
        ]
    else:
        args = [
            jax.device_put(host_batch[k])
            for k in ("wave", "wave_lengths", "labels", "label_lengths")
        ]
    step_rng = jax.random.key(1, impl=tcfg.get("rng_impl", "rbg"))

    spd = int(steps_per_dispatch)
    if spd > 1:
        from asr_chinese_e2e.train.train_step import make_multi_step

        multi = make_multi_step(train_step)
        stacked_host = {
            k: np.broadcast_to(np.asarray(host_batch[k]),
                               (spd,) + host_batch[k].shape).copy()
            for k in ("wave", "wave_lengths", "labels", "label_lengths")
        }
        if mesh is not None:
            # batch axis (axis 1) must shard over `data` like the trainer's
            # put_host_batch_stacked — plain device_put would commit the
            # stack to one device and clash with the replicated state
            from asr_chinese_e2e.parallel.sharding import (
                put_host_batch_stacked,
            )

            put = put_host_batch_stacked(mesh, stacked_host)
        else:
            put = {k: jax.device_put(v) for k, v in stacked_host.items()}
        stacked = [put[k] for k in (
            "wave", "wave_lengths", "labels", "label_lengths")]

        def train_step(state, *a):  # noqa: F811 — same call shape
            return multi(state, *stacked, a[-1])

    t0 = time.perf_counter()
    state, metrics = train_step(state, *args, step_rng)
    jax.block_until_ready(metrics["loss"])
    loss0 = float(np.asarray(metrics["loss"]).reshape(-1)[-1])
    log(f"compile+first step: {time.perf_counter() - t0:.1f}s loss={loss0:.3f}")

    # warmup
    for _ in range(2):
        state, metrics = train_step(state, *args, step_rng)
    jax.block_until_ready(metrics["loss"])

    # optional bounded dispatch queue: block_until_ready is a completion
    # wait (no data fetch) every ``sync_every`` steps
    sync_every = int(n_steps if sync_every <= 0 else sync_every)
    t0 = time.perf_counter()
    for i in range(n_steps):
        state, metrics = train_step(state, *args, step_rng)
        if (i + 1) % sync_every == 0:
            jax.block_until_ready(metrics["loss"])
    jax.block_until_ready(metrics["loss"])
    wall = time.perf_counter() - t0

    steps_per_s = n_steps * spd / wall
    audio_s_per_s_per_chip = steps_per_s * batch * seconds / n_chips
    loss_f = float(np.asarray(metrics["loss"]).reshape(-1)[-1])
    flops = analytic_train_flops(
        cfg, feat_cfg, vocab_size, batch, samples, label_len
    )
    util = mfu(flops, steps_per_s, bench_devices)
    log(
        f"{n_steps * spd} steps in {wall:.2f}s -> {steps_per_s:.2f} steps/s, "
        f"{audio_s_per_s_per_chip:.1f} audio-s/s/chip (loss={loss_f:.3f}, "
        f"{flops / 1e12:.2f} TFLOP/step, MFU {util})"
    )

    result = {
        "metric": "train_throughput_audio_seconds_per_sec_per_chip",
        "value": round(audio_s_per_s_per_chip, 2),
        "unit": "audio-s/s/chip",
        "vs_baseline": None,
        "steps_per_s": round(steps_per_s, 3),
        "flops_per_step": flops,
        "mfu": util,
        "n_chips": n_chips,
        **run_record(tcfg, bench_devices),
    }
    if _return_result:
        return result
    print(json.dumps(result))


def scaling_main(
    per_chip_batch: int = 64,
    chip_counts: str = "",
    n_steps: int = 20,
    **kw,
):
    """WEAK-scaling measurement (round-4 VERDICT #8): fixed per-chip batch,
    global batch = n × per_chip_batch, DP mesh over the first n devices.
    Reports audio-s/s/chip at each chip count and efficiency relative to
    the 1-chip run — the BASELINE.json ≥90%-at-16-chips target's harness,
    run it on a host of four GPUs.

        python bench.py --scaling true --per_chip_batch 64        # 4 GPUs
        JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
            python bench.py --scaling true --per_chip_batch 2 \
            --seconds 1 --d_model 64 ...                          # smoke

    ``chip_counts``: comma list (default: powers of two up to the device
    count). Smoke-tested on the virtual CPU mesh in
    tests/test_scaling_harness.py so the harness itself is known-good."""
    import jax

    n_dev = len(jax.devices())
    counts = [int(c) for c in str(chip_counts).split(",") if c] or [
        c for c in (1, 2, 4, 8, 16, 32, 64) if c <= n_dev
    ]
    rows = []
    for n in counts:
        r = main(
            batch=per_chip_batch * n, n_chips=n, n_steps=n_steps,
            _return_result=True, **kw,
        )
        rows.append({"n_chips": n, "audio_s_per_s_per_chip": r["value"],
                     "steps_per_s": r["steps_per_s"], "mfu": r["mfu"]})
        log(f"scaling: {n} chips -> {r['value']} audio-s/s/chip")
    base = rows[0]["audio_s_per_s_per_chip"]
    for r in rows:
        r["efficiency"] = round(r["audio_s_per_s_per_chip"] / base, 4)
    result = {
        "metric": "dp_weak_scaling_efficiency",
        "value": rows[-1]["efficiency"],
        "unit": f"per-chip efficiency at {rows[-1]['n_chips']} chips vs 1",
        "vs_baseline": None,
        "per_chip_batch": per_chip_batch,
        "table": rows,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    from asr_chinese_e2e.utils.cli import parse_kwargs

    _, kwargs = parse_kwargs(sys.argv[1:])
    if kwargs.pop("via_trainer", False):
        via_trainer_main(**kwargs)
    elif kwargs.pop("scaling", False):
        scaling_main(**kwargs)
    else:
        main(**kwargs)
