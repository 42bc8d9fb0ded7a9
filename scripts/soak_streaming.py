#!/usr/bin/env python
"""Streaming flagship on TRAINED weights (round-4 VERDICT #3).

Round 4 proved incremental streaming's latency (untrained weights) and its
exactness (toy scale, CPU). This soak closes the remaining gap: train a
causal-banded streaming flagship on the synthetic corpus, then drive
``StreamingRecognizer`` in incremental mode over the dev set and show

  1. incremental finals == the prefix-re-encode (offline) recognizer's
     finals on every utterance,
  2. the decoded CER of those finals is low (the streaming model actually
     learned),
  3. the partial/final latency table with REAL weights.

Phases (the orchestration phase runs on CPU; each GPU phase is its own
subprocess — ONE GPU process at a time):

  python scripts/soak_streaming.py            # all: corpus→train→eval
  python scripts/soak_streaming.py eval       # GPU eval phase only

Model: flagship 512d/8h/6+6L bf16, causal_encoder + attention_band 50
(banded bias through XLA attention), fixed global CMVN (computed from the
corpus — the causal normalisation), pre-LN / dropout 0 / factor 0.25 (the
soak-A recipe, proved end-to-end).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
CORPUS = os.path.join(REPO, ".cache", "asr_soak_corpus10k")
EXP_ROOT = os.path.join(REPO, ".cache", "asr_stream_soak")
EXP_NAME = "stream_flagship"
BAND = 50
EPOCHS = int(os.environ.get("SOAK_EPOCHS", 16))


def log(*a):
    print("[stream-soak]", *a, flush=True)


def gen_corpus():
    from asr_chinese_e2e.utils.synth import make_synth_corpus

    return make_synth_corpus(
        CORPUS, n_train=10000, n_dev=128, n_test=128,
        n_tone_chars=40, vocab_size=4233,
        seconds_range=(4.0, 8.0), tone_sec=0.3, seed=7,
    )


def cmvn_stats(paths, n=64):
    """Global log-mel mean/std over a corpus sample — the FIXED CMVN the
    causal (streaming) featurization needs (per-utterance stats would
    require the whole utterance before the first frame)."""
    import jax.numpy as jnp
    import numpy as np

    from asr_chinese_e2e.data.batching import load_wav
    from asr_chinese_e2e.data.features import (
        FeatureConfig,
        log_mel_spectrogram,
    )

    cfg = FeatureConfig()
    rows = [json.loads(l) for l in open(paths["train"])][:n]
    vals = []
    for r in rows:
        w = load_wav(r["wave"]).astype(np.float32) / 32768.0
        feats = log_mel_spectrogram(jnp.asarray(w)[None], cfg)
        vals.append(np.asarray(feats[0]))
    allv = np.concatenate(vals, axis=0)
    return float(allv.mean()), float(allv.std())


def train(paths, mean, std):
    cmd = [
        sys.executable, os.path.join(REPO, "main.py"),
        "--train_manifest", paths["train"],
        "--dev_manifest", paths["dev"],
        "--test_manifest", paths["test"],
        "--vocab_path", paths["vocab"],
        "--exp_root", EXP_ROOT, "--exp_name", EXP_NAME,
        "--num_epoch", str(EPOCHS), "--batch_size", "64",
        "--ctc_weight", "0.3", "--dtype", "bfloat16",
        "--spec_augment", "false", "--dropout_rate", "0.0",
        "--norm_type", "pre", "--warm_up", "150", "--noam_factor", "0.25",
        "--causal_encoder", "true", "--attention_band", str(BAND),
        "--cmvn_mode", "fixed", "--cmvn_mean", f"{mean:.6f}",
        "--cmvn_std", f"{std:.6f}",
        "--log_every_iter", "20", "--eval_every_iter", "400",
        "--save_every_iter", "300",
        "--eval_decode", "joint", "--eval_beam_size", "10",
    ]
    log("train:", " ".join(cmd[-14:]))
    t0 = time.time()
    lp = os.path.join(EXP_ROOT, "train.log")
    with open(lp, "w") as out:
        proc = subprocess.run(
            cmd, cwd=REPO, stdout=out, stderr=subprocess.STDOUT, timeout=10800
        )
    log(f"train rc={proc.returncode} in {time.time()-t0:.0f}s (log {lp})")
    if proc.returncode != 0:
        print("\n".join(open(lp).read().splitlines()[-30:]))
        raise SystemExit("train failed")


def eval_phase(mode: str = "joint"):
    """GPU phase: incremental vs offline recognizer over the dev set with
    the TRAINED checkpoint + latency with real weights."""
    import numpy as np

    from asr_chinese_e2e.data.batching import load_wav
    from asr_chinese_e2e.decode.cer import corpus_cer
    from asr_chinese_e2e.stream import StreamingRecognizer
    from asr_chinese_e2e.utils.experiment import load_experiment

    exp = os.path.join(EXP_ROOT, EXP_NAME)
    model, params, cfg, feat_cfg, vocab = load_experiment(
        exp, os.path.join(CORPUS, "vocab.json"), which="best"
    )
    rows = [json.loads(l) for l in open(os.path.join(CORPUS, "dev.jsonl"))]
    log(f"eval: {len(rows)} dev utts, mode={mode}")

    def run(incremental):
        rec = StreamingRecognizer(
            model, params, vocab, feat_cfg, mode=mode,
            incremental=incremental, beam_size=10, max_len=40,
        )
        texts, partials, lat = [], 0, []
        for r in rows:
            # each dev wav is an independent stream (the corpus has no
            # inter-utterance silence for the gate to close on)
            rec.reset_stream()
            w = load_wav(r["wave"], dtype=np.int16)
            finals = []
            for i in range(0, len(w), 2000):
                t0 = time.perf_counter()
                evs = rec.feed(w[i : i + 2000])
                dt = time.perf_counter() - t0
                for e in evs:
                    if e.kind == "final":
                        finals.append(e.text)
                    else:
                        partials += 1
                        lat.append(dt)
            for e in rec.finish():
                if e.kind == "final":
                    finals.append(e.text)
            # Event.text is the recognizer's space-joined detok
            # (vocab.ids_to_str); CER runs on plain char strings
            texts.append("".join(finals).replace(" ", ""))
        return texts, partials, lat

    t0 = time.time()
    inc_texts, inc_partials, inc_lat = run("on")
    inc_wall = time.time() - t0
    t0 = time.time()
    off_texts, _, _ = run("off")
    off_wall = time.time() - t0

    refs = [r["tgt"] for r in rows]
    inc_cer = corpus_cer(inc_texts, refs)
    off_cer = corpus_cer(off_texts, refs)
    match = sum(a == b for a, b in zip(inc_texts, off_texts))
    lat_ms = np.asarray(inc_lat[3:]) * 1e3  # drop compile-bearing first fetches
    out = {
        "mode": mode,
        "dev_utts": len(rows),
        "incremental_cer": round(inc_cer, 3),
        "offline_recognizer_cer": round(off_cer, 3),
        "finals_match": f"{match}/{len(rows)}",
        "partials_emitted": inc_partials,
        "partial_ms_mean": round(float(lat_ms.mean()), 1) if len(lat_ms) else None,
        "partial_ms_p95": round(float(np.percentile(lat_ms, 95)), 1)
        if len(lat_ms)
        else None,
        "inc_wall_s": round(inc_wall, 1),
        "off_wall_s": round(off_wall, 1),
    }
    log("RESULT", json.dumps(out))
    with open(os.path.join(EXP_ROOT, f"eval_{mode}.json"), "w") as f:
        json.dump(out, f, indent=2)
    return out


def main():
    phase = sys.argv[1] if len(sys.argv) > 1 else "all"
    if phase == "eval":
        for mode in (sys.argv[2:] or ["joint", "ctc_greedy"]):
            eval_phase(mode)
        return
    # orchestration: stay OFF the GPU (subprocesses own it, one at a time)
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(EXP_ROOT, exist_ok=True)
    paths = gen_corpus()
    mean, std = cmvn_stats(paths)
    log(f"fixed CMVN: mean={mean:.3f} std={std:.3f}")
    train(paths, mean, std)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "eval"],
        cwd=REPO, timeout=7200,
    )
    raise SystemExit(proc.returncode)


if __name__ == "__main__":
    main()
