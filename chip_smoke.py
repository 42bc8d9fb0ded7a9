#!/usr/bin/env python
"""Smoke run of the training and decode path on NVIDIA GPUs.

    python chip_smoke.py             # one card: env, kernels, train, decode
    python chip_smoke.py --cards 4   # data-parallel training on four cards
                                     # against the same run on one card

Phases (one card):

- ``env``: requires JAX's GPU backend; prints the device, the card's name
  and power limit, package versions, which optional packages import, the
  compile-cache directory, ``XLA_FLAGS`` and whether the native wav reader
  built;
- ``kernels``: every hand-written kernel, compiled for the card, against
  its float64 reference at the flagship shapes (the ``gpu``-marked test
  cases), errors printed next to their tolerances;
- ``train``: ``main.train`` on the flagship ``TransformerOffical`` config
  (512d/8h/6+6L, bfloat16, CTC weight 0.3, SpecAugment, batch 64 of 8 s
  utterances, vocabulary 4233, random init from a seed) over a synthetic
  corpus: a few steps, checkpoints and dev evals;
- ``decode``: ``recognize.recognize`` in beam and joint CTC/attention mode
  on the dev split with that checkpoint.

The corpus, experiments and decode outputs go under ``.cache/smoke`` in
the checkout (git-ignored). Any failure exits nonzero. The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.metadata
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import main as train_cli  # noqa: E402
import recognize as recognize_cli  # noqa: E402
from asr_chinese_e2e.data import native  # noqa: E402
from asr_chinese_e2e.utils.synth import make_synth_corpus  # noqa: E402

WORK = os.path.join(ROOT, ".cache", "smoke")


def say(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def card_lines() -> list:
    """``name, power.limit`` of every card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return [line.strip() for line in out.strip().splitlines()]


def _version(dist: str) -> str:
    try:
        return importlib.metadata.version(dist)
    except importlib.metadata.PackageNotFoundError:
        return "absent"


def phase_env(cards: int) -> str:
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"[smoke] env: JAX backend is {backend!r}, not a GPU")
    devices = jax.devices()
    if len(devices) < cards:
        raise SystemExit(f"[smoke] env: {len(devices)} GPUs, {cards} needed")
    card = card_lines()[0]
    say(f"env: device_kind={devices[0].device_kind} count={len(devices)}")
    say(f"env: nvidia-smi name,power.limit: {card}")
    plugin = next(
        (
            f"{d}={_version(d)}"
            for d in ("jax-cuda12-plugin", "jax-cuda13-plugin")
            if _version(d) != "absent"
        ),
        "absent",
    )
    say(
        f"env: jax={jax.__version__} jaxlib={_version('jaxlib')} "
        f"cuda plugin {plugin}"
    )
    for mod in ("flax", "orbax.checkpoint", "tensorboardX", "Levenshtein"):
        try:
            importlib.import_module(mod)
            state = "imports"
        except ImportError:
            state = "absent"
        say(f"env: optional {mod}: {state}")
    say(f"env: compile cache dir: {jax.config.jax_compilation_cache_dir}")
    say(f"env: XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    say(f"env: native wav reader built: {native.available()}")
    return card


def phase_kernels() -> None:
    from tests.test_ctc_pallas import FLAGSHIP_TOLERANCES, flagship_errors

    for (label_len, dtype), (rel_tol, grad_tol) in sorted(
        FLAGSHIP_TOLERANCES.items()
    ):
        rel, gerr = flagship_errors(label_len, jnp.dtype(dtype))
        say(
            f"kernels: ctc_pallas B=64 T=267 C=4233 L={label_len} {dtype}: "
            f"loss rel err {rel:.3e} (tol {rel_tol:.0e}), "
            f"grad abs err {gerr:.3e} (tol {grad_tol:.0e}) vs float64 oracle"
        )
        if not (rel < rel_tol and gerr < grad_tol):
            raise SystemExit("[smoke] kernels: tolerance exceeded")


def make_corpus(n_train: int, n_dev: int) -> dict:
    return make_synth_corpus(
        os.path.join(WORK, f"corpus_{n_train}"),
        n_train=n_train, n_dev=n_dev, n_test=4, n_tone_chars=40,
        vocab_size=4233, seconds_range=(8.0, 8.0), seed=0,
    )


def flagship_kwargs(corpus: dict, exp_name: str, **overrides) -> dict:
    kw = dict(
        model_name="TransformerOffical",
        vocab_path=corpus["vocab"],
        train_manifest=corpus["train"],
        dev_manifest=corpus["dev"],
        test_manifest="",
        dtype="bfloat16",
        ctc_weight=0.3,
        spec_augment=True,
        batch_size=64,
        num_epoch=2,
        log_every_iter=1,
        eval_every_iter=0,
        save_every_iter=0,
        warmup=4000,
        seed=0,
        exp_root=os.path.join(WORK, "exp"),
        exp_name=exp_name,
        drop_exp=True,
    )
    kw.update(overrides)
    return kw


def scalars(exp_dir: str) -> list:
    with open(os.path.join(exp_dir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def train_losses(exp_dir: str) -> list:
    return [r["train/loss"] for r in scalars(exp_dir) if "train/loss" in r]


def phase_train(card: str) -> tuple:
    corpus = make_corpus(n_train=256, n_dev=16)
    t0 = time.perf_counter()
    trainer = train_cli.train(**flagship_kwargs(corpus, "flagship"))
    wall = time.perf_counter() - t0
    exp_dir = trainer.exp_dir
    with open(os.path.join(exp_dir, "config.json")) as f:
        routes = json.load(f)["routes"]
    say(f"train: resolved routes {routes}")
    if routes["ctc"] != "pallas":
        raise SystemExit(f"[smoke] train: CTC route {routes['ctc']!r}, not the GPU kernel")
    rows = scalars(exp_dir)
    losses = train_losses(exp_dir)
    say(f"train: {len(losses)} steps in {wall:.1f} s (compiles included); "
        f"losses {[round(x, 3) for x in losses]}")
    if not losses or not all(math.isfinite(x) for x in losses):
        raise SystemExit("[smoke] train: non-finite or missing loss")
    dev = [r for r in rows if "dev/loss" in r]
    if not dev:
        raise SystemExit("[smoke] train: no dev eval ran")
    say(f"train: dev evals {[(r['step'], round(r['dev/loss'], 3)) for r in dev]}")
    if trainer.ckpt.latest_name is None:
        raise SystemExit("[smoke] train: no checkpoint saved")
    say(f"train: checkpoint {trainer.ckpt.latest_name}")
    last = [r for r in rows if "train/steps_per_s" in r][-1]
    say(
        f"train: steady-state {last['train/steps_per_s']:.3f} steps/s, "
        f"{last['train/audio_s_per_s_per_chip']:.1f} audio-s/s on {card} "
        "(last epoch, metrics fetched every step)"
    )
    del trainer
    return corpus, exp_dir


def phase_decode(corpus: dict, exp_dir: str) -> None:
    with open(corpus["dev"]) as f:
        n_utts = sum(1 for _ in f)
    for mode in ("beam", "joint"):
        t0 = time.perf_counter()
        res = recognize_cli.recognize(
            exp=exp_dir, vocab=corpus["vocab"], manifest=corpus["dev"],
            mode=mode, which="latest", beam_size=10, batch_size=16,
            out=os.path.join(WORK, f"decode_{mode}.json"),
        )
        wall = time.perf_counter() - t0
        utts = res["utts"]
        got = [
            u for u in utts.values()
            if u["output"] and math.isfinite(u["output"][0]["score"])
        ]
        say(f"decode: {mode}: {len(got)}/{n_utts} utterances with a "
            f"hypothesis in {wall:.1f} s (compiles included)")
        if len(got) != n_utts:
            raise SystemExit(f"[smoke] decode: {mode} missed utterances")


def phase_dp(card: str) -> None:
    """Flagship DP training on four cards at global B=64 vs the same run on
    one card: same seed (same init), same batches, threefry dropout bits
    (sharding-invariant). Per-step losses must agree to ``DP_RTOL``."""
    dp_rtol = 2e-2  # bfloat16 matmuls over 16-row vs 64-row batches
    corpus = make_corpus(n_train=128, n_dev=16)
    common = dict(dev_manifest="", rng_impl="threefry2x32")
    four = train_cli.train(**flagship_kwargs(corpus, "dp4", mesh_data=-1, **common))
    mesh = four.mesh
    if mesh is None or mesh.shape["data"] != 4:
        raise SystemExit(f"[smoke] dp: expected a 4-way data mesh, got {mesh}")
    in_use = [d.memory_stats()["bytes_in_use"] for d in jax.devices()[:4]]
    peak4 = [d.memory_stats()["peak_bytes_in_use"] for d in jax.devices()[:4]]
    l4 = train_losses(four.exp_dir)
    del four
    one = train_cli.train(**flagship_kwargs(corpus, "dp1", mesh_data=0, **common))
    l1 = train_losses(one.exp_dir)
    peak1 = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    del one
    gib = lambda b: f"{b / 2**30:.2f}"
    say(f"dp: per-card bytes_in_use after the 4-card run (GiB): "
        f"{[gib(b) for b in in_use]}")
    say(f"dp: per-card peak_bytes_in_use, 4-card run (GiB): "
        f"{[gib(b) for b in peak4]}; card 0 after the 1-card run: {gib(peak1)}")
    rel = [abs(a - b) / abs(b) for a, b in zip(l4, l1)]
    say(f"dp: per-step loss 4 cards {[round(x, 4) for x in l4]}")
    say(f"dp: per-step loss 1 card  {[round(x, 4) for x in l1]}")
    say(f"dp: max relative difference {max(rel):.3e} (tol {dp_rtol:.0e}) on {card}")
    if len(l4) != len(l1) or not l4 or max(rel) > dp_rtol:
        raise SystemExit("[smoke] dp: losses disagree")
    if max(peak4) >= peak1:
        raise SystemExit("[smoke] dp: a card held the whole batch")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = ap.parse_args()
    shutil.rmtree(os.path.join(WORK, "exp"), ignore_errors=True)
    os.makedirs(WORK, exist_ok=True)
    card = phase_env(args.cards)
    if args.cards == 4:
        phase_dp(card)
    else:
        phase_kernels()
        corpus, exp_dir = phase_train(card)
        phase_decode(corpus, exp_dir)
    dev = jax.devices()[0]
    for line in card_lines():
        print(line, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
