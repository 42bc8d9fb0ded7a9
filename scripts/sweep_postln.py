#!/usr/bin/env python
"""Post-LN flagship sweep (round-4 VERDICT #1): adequately-powered runs of
the reference's exact placement/regularisation at soak-A scale.

Round-4 soak B ran the post-LN recipe for only ~1k steps on a 3k corpus and
watched it settle into the uniform solution; this sweep re-runs it at soak
A's horizon (10k-utt corpus, ~2.5k steps) with the warmup STRETCHED so the
reference-scale peak (~6.7e-4) arrives near step 700 instead of 300, and
A/Bs the two cheapest stabilizing levers in the same pass:

  arm b1: post-LN, dropout 0.1, label_smoothing 0.1   (reference recipe +
          the standard smoothing lever, transformer_official.py:112-124)
  arm b2: post-LN, dropout 0.0, label_smoothing 0.1   (regularisation A/B)
  arm b3: post-LN, dropout 0.1, label_smoothing 0.1, deepnorm=true
          (DeepNet residual-scaling stabilizer — run if b1/b2 pin)

Each arm is one `main.py` invocation (fresh process; the persistent compile
cache makes repeat compiles a file read). Arms run SERIALLY — one GPU
process at a time; this parent never touches the card. Scalars land in
.cache/asr_postln_sweep/<arm>/scalars.jsonl and are summarized at the end.

Usage:  python scripts/sweep_postln.py b1 b2      (arm names as argv)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, ".cache", "asr_soak_corpus10k")
EXP_ROOT = os.path.join(REPO, ".cache", "asr_postln_sweep")
NUM_EPOCH = int(os.environ.get("SWEEP_EPOCHS", 16))
TIMEOUT_S = int(os.environ.get("SWEEP_TIMEOUT", 7200))

# (extra main.py args) per arm; all share the stretched schedule:
# peak LR = factor * 512^-0.5 * warmup^-0.5 = 0.4 * .0442 * .0378 = 6.7e-4
# reached at step 700 (~epoch 4.5 of 16 on the 10k corpus) — the
# reference-recipe peak (warmup-4000 at d=512 = 7e-4) on a warmup long
# enough that early steps are gentle, per round-4 VERDICT #1.
COMMON = [
    "--norm_type", "post", "--label_smoothing", "0.1",
    "--warm_up", "700", "--noam_factor", "0.4",
]
ARMS = {
    "b1": COMMON + ["--dropout_rate", "0.1"],
    "b2": COMMON + ["--dropout_rate", "0.0"],
    "b3": COMMON + ["--dropout_rate", "0.1", "--deepnorm", "true"],
    # b4: longer-horizon escalation (32 epochs ~ 5k steps)
    "b4": COMMON + ["--dropout_rate", "0.1", "--num_epoch", "32"],
}


def log(*a):
    print("[sweep]", *a, flush=True)


def gen_corpus():
    sys.path.insert(0, REPO)
    from asr_chinese_e2e.utils.synth import make_synth_corpus

    t0 = time.time()
    paths = make_synth_corpus(
        CORPUS, n_train=10000, n_dev=128, n_test=128,
        n_tone_chars=40, vocab_size=4233,
        seconds_range=(4.0, 8.0), tone_sec=0.3, seed=7,
    )
    log(f"corpus ready in {time.time() - t0:.0f}s")
    return paths


def run_arm(name: str, paths) -> dict:
    exp = os.path.join(EXP_ROOT, name)
    import shutil

    shutil.rmtree(exp, ignore_errors=True)
    cmd = [
        sys.executable, os.path.join(REPO, "main.py"),
        "--train_manifest", paths["train"],
        "--dev_manifest", paths["dev"],
        "--test_manifest", paths["test"],
        "--vocab_path", paths["vocab"],
        "--exp_root", EXP_ROOT, "--exp_name", name,
        "--num_epoch", str(NUM_EPOCH), "--batch_size", "64",
        "--ctc_weight", "0.3", "--dtype", "bfloat16",
        "--spec_augment", "false",
        "--log_every_iter", "20", "--eval_every_iter", "300",
        "--save_every_iter", "300",
        "--eval_decode", "joint", "--eval_beam_size", "10",
    ] + ARMS[name]
    log(f"arm {name}: {' '.join(ARMS[name])}")
    t0 = time.time()
    with open(os.path.join(EXP_ROOT, f"{name}.log"), "w") as out:
        proc = subprocess.run(
            cmd, cwd=REPO, stdout=out, stderr=subprocess.STDOUT,
            timeout=TIMEOUT_S,
        )
    log(f"arm {name} rc={proc.returncode} in {time.time()-t0:.0f}s")
    return summarize(name)


def summarize(name: str) -> dict:
    scalars = os.path.join(EXP_ROOT, name, "scalars.jsonl")
    rows = [json.loads(l) for l in open(scalars)]
    acc = [
        (r["step"], round(r["train/n_correct"] / max(r["train/n_word"], 1), 3))
        for r in rows
        if "train/n_word" in r
    ]
    ce = [(r["step"], round(r.get("train/ce", r.get("train/loss", 0.0)), 3))
          for r in rows if "train/loss" in r]
    dv = [(r["step"], r.get("dev/decoded_cer")) for r in rows if "dev/loss" in r]
    out = {
        "arm": name,
        "steps": acc[-1][0] if acc else 0,
        "tf_acc_curve": acc[:: max(1, len(acc) // 12)],
        "tf_acc_last": acc[-1][1] if acc else None,
        "ce_last": ce[-1][1] if ce else None,
        "dev_cer": dv,
    }
    log(json.dumps(out))
    return out


def main():
    os.makedirs(EXP_ROOT, exist_ok=True)
    arms = sys.argv[1:] or ["b1", "b2"]
    paths = gen_corpus()
    results = [run_arm(a, paths) for a in arms]
    with open(os.path.join(EXP_ROOT, "summary.json"), "w") as f:
        json.dump(results, f, indent=2)
    log("SWEEP DONE")
    for r in results:
        log(
            f"{r['arm']}: steps={r['steps']} tf_acc={r['tf_acc_last']} "
            f"ce={r['ce_last']} dev_cer_last={r['dev_cer'][-1] if r['dev_cer'] else None}"
        )


if __name__ == "__main__":
    main()
