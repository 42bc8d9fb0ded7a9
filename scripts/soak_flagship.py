#!/usr/bin/env python
"""Flagship-scale synthetic soak on the GPU (round-2 VERDICT #2).

Exercises the full pipeline end-to-end at flagship shapes — the strongest
"the recipe works" evidence available without the AISHELL corpus. NOTE:
the soak DEFAULTS deviate from the shipped recipe where the synthetic
corpus demands it (each knob documented at its definition below):
pre-LN instead of post-LN, dropout 0 instead of 0.1, SpecAugment off.
Set SOAK_NORM=post SOAK_DROPOUT=0.1 SOAK_SPECAUG=true for a
recipe-parity crash/resume run (slower to converge).

1. generate a ~3k-utterance synthetic tone corpus at AISHELL-like
   durations (4-8 s) and vocab scale (4233);
2. train the flagship config through ``main.py`` (bucketed loader, hybrid
   CTC/CE, SpecAugment, the CTC kernel, eval_decode=joint, periodic
   checkpoints) — KILLED mid-run with SIGKILL;
3. resume with ``--from_ckpt latest`` and train to completion;
4. decode the dev split with ``recognize.py --mode joint`` from the saved
   experiment;
5. print a summary: loss curve, resume continuity, decoded CER.

Run from the repo root:  python scripts/soak_flagship.py
Each phase is its own ``main.py`` / ``recognize.py`` process; this parent
never touches the card, so one process holds it at a time.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, ".cache", "asr_soak_corpus")
EXP_ROOT = os.path.join(REPO, ".cache", "asr_soak_exp")
EXP_NAME = "soak_flagship"
# Schedule notes (r3/r4 measured): warm_up must be short enough that the
# run spends most steps at real LR (the 12-epoch/warm_up-400 first attempt
# sat inside warmup and collapsed to the modal char), and the PEAK must be
# gentle enough for cross-attention alignment to form — warm_up 150 with
# factor 1.0 peaks at 3.6e-3 and pins TF accuracy at ~28% for 1500+ steps
# (r3 soak; reproduced at d=256 on CPU, BENCH_NOTES r4), while factor 0.25
# (peak 9e-4 ~= the reference's warmup-4000 peak of 7e-4) learns to >95%
# token accuracy in a few hundred steps.
NUM_EPOCH = int(os.environ.get("SOAK_EPOCHS", 40))
WARM_UP = int(os.environ.get("SOAK_WARMUP", 150))
# SpecAugment measurably slows learning on spectrally-sparse pure tones
# (each char is ONE mel peak; masks delete the whole evidence) -- off for
# the synthetic soak, on for real speech
SPEC_AUGMENT = os.environ.get("SOAK_SPECAUG", "false")
# Dropout 0.1 (the flagship recipe value) pins the flagship at the
# uniform-prediction plateau on this DETERMINISTIC corpus: measured r3,
# CE flat at ln(40)=3.69 for 900+ steps with decaying grad norm, while
# the same construction at toy scale learns with dropout 0
# (tests/test_learning*.py). Regularization against overfit is not what
# the soak tests -- crash/resume + full-recipe evidence is -- so default 0.
DROPOUT = os.environ.get("SOAK_DROPOUT", "0.0")
# The reference's post-LN placement needs its full-length schedule
# (warm_up 4000 over ~200 epochs, main_new.py defaults) to leave the
# uniform-prediction plateau; in a time-boxed ~1.8k-step soak it stays
# pinned at CE = ln(n_tone_chars) with decaying grad norm (measured r3,
# both dropout 0.1 and 0.0). Pre-LN — the framework's robust-optimization
# option (models/transformer.py norm_type) — trains reliably at this
# horizon (tests/test_learning*.py), so the soak defaults to it; the
# recipe-parity default elsewhere stays "post".
NORM_TYPE = os.environ.get("SOAK_NORM", "pre")
# mid-epoch dev-eval cadence (round-3 VERDICT #9). Epoch-end evals always
# run; at 45 steps/epoch on the 3k corpus those already give fine-grained
# curves, but larger corpora (SOAK_TRAIN_N) make epochs long enough that
# mid-epoch points matter.
EVAL_EVERY = int(os.environ.get("SOAK_EVAL_EVERY", 300))
TRAIN_N = int(os.environ.get("SOAK_TRAIN_N", 3000))
NOAM_FACTOR = os.environ.get("SOAK_FACTOR", "1.0")
# phase-2 wall budget: larger corpora (SOAK_TRAIN_N) need more than the
# default hour
TIMEOUT_S = int(os.environ.get("SOAK_TIMEOUT", 3600))


def log(*a):
    print("[soak]", *a, flush=True)


def gen_corpus():
    sys.path.insert(0, REPO)
    from asr_chinese_e2e.utils.synth import make_synth_corpus

    t0 = time.time()
    paths = make_synth_corpus(
        CORPUS, n_train=TRAIN_N, n_dev=128, n_test=128,
        n_tone_chars=40, vocab_size=4233,
        seconds_range=(4.0, 8.0), tone_sec=0.3, seed=7,
    )
    log(f"corpus ready in {time.time() - t0:.0f}s: {paths}")
    return paths


def train_cmd(paths, extra):
    return [
        sys.executable, os.path.join(REPO, "main.py"),
        "--train_manifest", paths["train"],
        "--dev_manifest", paths["dev"],
        "--test_manifest", paths["test"],
        "--vocab_path", paths["vocab"],
        "--exp_root", EXP_ROOT, "--exp_name", EXP_NAME,
        "--num_epoch", str(NUM_EPOCH), "--batch_size", "64",
        "--ctc_weight", "0.3", "--dtype", "bfloat16",
        "--spec_augment", SPEC_AUGMENT,
        "--dropout_rate", DROPOUT,
        "--norm_type", NORM_TYPE,
        "--warm_up", str(WARM_UP), "--noam_factor", NOAM_FACTOR,
        "--log_every_iter", "20", "--eval_every_iter", str(EVAL_EVERY),
        "--save_every_iter", "60",
        "--eval_decode", "joint", "--eval_beam_size", "10",
    ] + extra


def _tail(path, n=25):
    try:
        with open(path) as f:
            return "\n".join(f.read().splitlines()[-n:])
    except OSError as e:
        return f"<no log: {e}>"


def run_until_killed(cmd, kill_after_s):
    """Run cmd; SIGKILL it kill_after_s seconds after step logs appear
    (so the kill lands mid-training, past the compile phase).

    Poll-driven: the trainer writes scalars.jsonl but is quiet on stdout,
    so a read-stdout-lines loop would block forever and never deliver the
    kill — the timer must tick independently of child output."""
    log("launch (to be killed):", " ".join(cmd[1:3]), "...")
    os.makedirs(EXP_ROOT, exist_ok=True)
    log_path = os.path.join(EXP_ROOT, "soak_phase1.log")
    scalars = os.path.join(EXP_ROOT, EXP_NAME, "scalars.jsonl")
    armed_at = None
    killed = False
    with open(log_path, "w") as out:
        proc = subprocess.Popen(
            cmd, cwd=REPO, stdout=out, stderr=subprocess.STDOUT
        )
        try:
            while proc.poll() is None:
                time.sleep(5)
                if armed_at is None and os.path.exists(scalars) and os.path.getsize(scalars):
                    armed_at = time.time()
                    log(f"training observed; killing in {kill_after_s}s")
                if armed_at is not None and time.time() - armed_at > kill_after_s:
                    log("sending SIGKILL (simulated crash)")
                    proc.send_signal(signal.SIGKILL)
                    killed = True
                    break
            proc.wait()
        finally:
            if proc.poll() is None:
                proc.kill()
    log(f"phase-1 run exited with {proc.returncode} (killed={killed})")
    if not killed:
        # the child finished (or crashed) before the kill fired — phase 2
        # would "resume" a completed run and silently void the crash test
        print(_tail(log_path), flush=True)
        raise SystemExit(
            f"phase-1 exited rc={proc.returncode} before the SIGKILL — "
            f"raise SOAK_EPOCHS or lower kill_after_s (log: {log_path})"
        )


def run_to_completion(cmd, timeout_s=TIMEOUT_S):
    log("resume run:", " ".join(cmd[-2:]))
    proc = subprocess.run(
        cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=timeout_s,
    )
    tail = "\n".join(proc.stdout.splitlines()[-25:])
    print(tail, flush=True)
    if proc.returncode != 0:
        raise SystemExit(f"resume run failed rc={proc.returncode}")


def decode(paths, mode="joint"):
    out = os.path.join(EXP_ROOT, f"soak_decode_{mode}.json")
    idx = json.load(open(os.path.join(EXP_ROOT, EXP_NAME, "checkpoints", "index.json")))
    which = "best" if idx.get("best") else "latest"
    cmd = [
        sys.executable, os.path.join(REPO, "recognize.py"),
        "--exp", os.path.join(EXP_ROOT, EXP_NAME),
        "--vocab", paths["vocab"],
        "--manifest", paths["dev"],
        "--mode", mode, "--beam_size", "10", "--batch_size", "64",
        "--max_seconds", "8.0", "--which", which, "--out", out,
    ]
    log("decode:", " ".join(cmd[1:4]), f"mode={mode} ...")
    proc = subprocess.run(
        cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=3600,
    )
    print("\n".join(proc.stdout.splitlines()[-8:]), flush=True)
    if proc.returncode != 0:
        raise SystemExit(f"decode failed rc={proc.returncode}")
    with open(out) as f:
        return json.load(f).get("cer")


def summarize():
    scalars = os.path.join(EXP_ROOT, EXP_NAME, "scalars.jsonl")
    rows = [json.loads(l) for l in open(scalars)]
    tr = [(r["step"], r["train/loss"]) for r in rows if "train/loss" in r]
    # teacher-forced token accuracy — the round-3 VERDICT #1 "attention
    # branch actually trains" signal (was stuck at 28% under the r3 hot
    # schedule; the CPU A/B in BENCH_NOTES r4 pinned that on peak LR)
    acc = [(r["step"], round(r["train/n_correct"] / max(r["train/n_word"], 1), 3))
           for r in rows if "train/n_word" in r]
    if acc:
        log("train TF token accuracy (every ~10th log):", acc[::10], "last:", acc[-1])
    dv = [(r["step"], r.get("dev/loss"), r.get("dev/decoded_cer"))
          for r in rows if "dev/loss" in r]
    tp = [r["train/audio_s_per_s_per_chip"] for r in rows
          if "train/audio_s_per_s_per_chip" in r]
    log("train/loss curve:", [(s, round(v, 2)) for s, v in tr])
    log("dev evals (step, loss, decoded_cer):",
        [(s, round(l, 2) if l is not None else None,
          round(c, 2) if c is not None else None) for s, l, c in dv])
    if tp:
        log(f"integrated throughput (last): {tp[-1]:.0f} audio-s/s/chip")
    idx = json.load(open(os.path.join(EXP_ROOT, EXP_NAME, "checkpoints", "index.json")))
    log("checkpoints:", idx["latest"], "best:", idx["best"],
        "best_metric:", idx["best_metric"])
    return tr


def main():
    import shutil

    shutil.rmtree(os.path.join(EXP_ROOT, EXP_NAME), ignore_errors=True)
    paths = gen_corpus()
    # phase 1: train, crash mid-run (after ~4 min of real steps, so several
    # cadence saves at save_every_iter=60 have landed)
    run_until_killed(train_cmd(paths, []), kill_after_s=240)
    idx_path = os.path.join(EXP_ROOT, EXP_NAME, "checkpoints", "index.json")
    if not os.path.exists(idx_path):
        print(_tail(os.path.join(EXP_ROOT, "soak_phase1.log")), flush=True)
        raise SystemExit("no checkpoint landed before the kill (log tail above)")
    before = json.load(open(idx_path))["latest"]
    log("latest checkpoint at kill:", before)
    # phase 2: resume from latest, run to completion
    run_to_completion(train_cmd(paths, ["--from_ckpt", "latest"]))
    tr = summarize()
    # phase 3: decode dev from the saved experiment — JOINT (CTC-pruned)
    # and pure-attention BEAM. The beam mode exercises the attention
    # decoder alone (the reference's entire model,
    # transformer_official.py:34-458) — round-3 VERDICT #1 requires its
    # CER in the same band as joint, not rescued by the CTC branch.
    cer_joint = decode(paths, "joint")
    cer_beam = decode(paths, "beam")
    log(f"DONE: dev decoded CER joint={cer_joint} pure-attention-beam={cer_beam}")
    first, last = tr[0][1], tr[-1][1]
    assert last < first, f"loss did not decrease: {first} -> {last}"


if __name__ == "__main__":
    main()
