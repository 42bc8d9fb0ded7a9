"""Beam-search decode throughput on the flagship decoder (on the GPU).

Measures audio-seconds/s/chip for batched attention beam search (B=64,
beam 10, max_len 40 — AISHELL-scale) in both cache-reorder modes:
``lazy`` (ancestry-map routing inside attention, no KV gather) and
``gather`` (physical carry gather per step). Run:

    timeout 1200 python scripts/bench_decode.py [--batch=64 --beam=10 ...]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(
    seconds: float = 8.0,
    batch: int = 64,
    vocab_size: int = 4233,
    beam: int = 10,
    max_len: int = 40,
    dtype: str = "bfloat16",
    n_iters: int = 5,
    modes: str = "lazy,gather",
):
    import jax

    from asr_chinese_e2e.data.features import FeatureConfig, parse_batch
    from asr_chinese_e2e.decode.beam import beam_search
    from asr_chinese_e2e.models.transformer import (
        SpeechTransformer,
        default_config,
    )

    feat_cfg = FeatureConfig()
    cfg = default_config().build(
        ctc_weight=0.3, dtype=dtype, input_dim=feat_cfg.feature_dim,
        dropout_rate=0.0,
    )
    model = SpeechTransformer(cfg, vocab_size)

    rng = np.random.RandomState(0)
    samples = int(seconds * feat_cfg.sample_rate)
    wave = jax.numpy.asarray(rng.randn(batch, samples).astype(np.float32) * 0.1)
    wave_len = jax.numpy.full((batch,), samples, np.int32)
    labels = jax.numpy.asarray(
        rng.randint(4, vocab_size, size=(batch, 20)).astype(np.int32)
    )
    label_lens = jax.numpy.full((batch,), 20, np.int32)

    feats, feat_lens = parse_batch(wave, wave_len, feat_cfg)
    params = model.init(
        jax.random.PRNGKey(0), feats, feat_lens, labels, label_lens
    )
    enc_out, enc_lens = model.apply(params, feats, feat_lens, method="encode")
    jax.block_until_ready(enc_out)
    print(f"enc_out {enc_out.shape} {enc_out.dtype}", file=sys.stderr)

    from asr_chinese_e2e.decode.joint import joint_beam_search

    for mode in modes.split(","):
        if mode == "joint":
            search = lambda: joint_beam_search(
                model, params, enc_out, enc_lens, beam, max_len,
                ctc_weight=0.3,
            )
        else:
            lazy = mode == "lazy"
            search = lambda: beam_search(
                model, params, enc_out, enc_lens, beam, max_len, lazy=lazy
            )
        t0 = time.perf_counter()
        r = search()
        print(
            f"[{mode}] compile+first: {time.perf_counter() - t0:.1f}s",
            file=sys.stderr,
        )
        t0 = time.perf_counter()
        for _ in range(n_iters):
            r = search()
            r.materialize()  # BeamResult is lazy now; force per iteration
        wall = (time.perf_counter() - t0) / n_iters
        rate = batch * seconds / wall
        print(
            f"[{mode}] {wall * 1e3:.1f} ms/batch = {rate:.0f} audio-s/s/chip "
            f"(best score {r.scores[0, 0]:.2f})"
        )


def corpus(
    seconds: float = 8.0,
    batch: int = 64,
    beam: int = 10,
    max_len: int = 40,
    mode: str = "joint",
    n_batches: int = 12,
    pipeline_depth: int = 1,
    corpus_dir: str = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache", "asr_bench_corpus"),
    exp_dir: str = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache", "asr_bench_decode_exp"),
):
    """CORPUS-level decode wall throughput through the real ``recognize``
    path (manifest -> bucketed chunks -> wav IO -> encode -> search ->
    detok/JSON), with the double-buffered pipeline (round-2 VERDICT #5).
    Compare --pipeline_depth=0 (serial) vs 1 (default).

    Uses an untrained flagship checkpoint — throughput does not depend on
    the weights."""
    import jax

    from asr_chinese_e2e.data.features import FeatureConfig
    from asr_chinese_e2e.data.vocab import Vocab
    from asr_chinese_e2e.models.transformer import (
        SpeechTransformer,
        default_config,
    )
    from asr_chinese_e2e.train.checkpoint import CheckpointManager
    from asr_chinese_e2e.train.optimizer import (
        default_train_config,
        make_optimizer,
    )
    from asr_chinese_e2e.train.train_step import make_step_fns
    from asr_chinese_e2e.utils.synth import make_synth_corpus
    from recognize import recognize

    n_utts = n_batches * batch
    n_unique = min(n_utts, 640)
    paths = make_synth_corpus(
        corpus_dir, n_train=n_unique, n_dev=0, n_test=0,
        seconds_range=(seconds, seconds), tone_sec=seconds / 20.0,
    )
    manifest = paths["train"]
    if n_utts > n_unique:
        rows = open(manifest).read().splitlines()
        manifest = os.path.join(corpus_dir, f"decode_x{n_utts}.jsonl")
        with open(manifest, "w") as f:
            for i in range(n_utts):
                f.write(rows[i % n_unique] + "\n")

    # one-time: save an untrained flagship experiment for load_experiment
    cfg_path = os.path.join(exp_dir, "config.json")
    if not os.path.exists(cfg_path):
        vocab = Vocab.load(paths["vocab"])
        feat_cfg = FeatureConfig()
        cfg = default_config().build(
            ctc_weight=0.3, dtype="bfloat16", input_dim=feat_cfg.feature_dim,
            dropout_rate=0.0,
        )
        tcfg = default_train_config().combine(cfg)
        model = SpeechTransformer(cfg, vocab.vocab_size)
        tx = make_optimizer(tcfg, cfg.d_model)
        init_fn, _, _ = make_step_fns(model, tx, feat_cfg, tcfg)
        rng0 = np.random.RandomState(0)
        state = init_fn(
            jax.random.PRNGKey(0),
            {
                "wave": rng0.randn(2, 16000).astype(np.float32),
                "wave_lengths": np.full((2,), 16000, np.int32),
                "labels": np.ones((2, 8), np.int32) * 4,
                "label_lengths": np.full((2,), 8, np.int32),
            },
        )
        os.makedirs(exp_dir, exist_ok=True)
        # save the full (train+model) config: load_experiment rebuilds the
        # optimizer template from it
        tcfg.build(n_mels=feat_cfg.n_mels).save(cfg_path)
        mgr = CheckpointManager(os.path.join(exp_dir, "checkpoints"))
        mgr.save(state, epoch=0, config=cfg, metric=1.0)
        mgr.wait()

    # warm the compile caches with one tiny pass, then time the corpus
    t0 = time.perf_counter()
    recognize(
        exp=exp_dir, vocab=paths["vocab"], manifest=manifest, mode=mode,
        beam_size=beam, max_decode_len=max_len, batch_size=batch,
        max_seconds=seconds, pipeline_depth=pipeline_depth,
    )
    print(f"[corpus warmup incl. compiles] {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    t0 = time.perf_counter()
    recognize(
        exp=exp_dir, vocab=paths["vocab"], manifest=manifest, mode=mode,
        beam_size=beam, max_decode_len=max_len, batch_size=batch,
        max_seconds=seconds, pipeline_depth=pipeline_depth,
    )
    wall = time.perf_counter() - t0
    rate = n_utts * seconds / wall
    print(
        f"[corpus mode={mode} depth={pipeline_depth}] {n_utts} utts in "
        f"{wall:.2f}s = {rate:.0f} audio-s/s/chip wall "
        f"({wall / n_batches * 1e3:.0f} ms/batch)"
    )


def sweep(
    seconds: float = 8.0,
    batch: int = 64,
    beam: int = 10,
    max_len: int = 40,
    n_batches: int = 12,
    modes: str = "beam,joint",
    depths: str = "0,1",
):
    """The round-3 VERDICT #3 ladder in ONE process (jit caches shared
    across pipeline depths, so each mode compiles once): corpus decode
    wall throughput for each (mode, pipeline_depth) pair."""
    for mode in modes.split(","):
        for depth in (int(d) for d in depths.split(",")):
            corpus(
                seconds=seconds, batch=batch, beam=beam, max_len=max_len,
                mode=mode, n_batches=n_batches, pipeline_depth=depth,
            )


if __name__ == "__main__":
    from asr_chinese_e2e.utils.cli import parse_kwargs

    _, kwargs = parse_kwargs(sys.argv[1:])
    if kwargs.pop("corpus", False):
        corpus(**kwargs)
    elif kwargs.pop("sweep", False):
        sweep(**kwargs)
    else:
        main(**kwargs)
