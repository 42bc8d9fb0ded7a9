#!/usr/bin/env python
"""AISHELL-1 preprocessing CLI: extract archive, build manifests + vocab.

Parity with ``preprocess_aishell1.py:12-29`` (extract() + build()
pipeline), minus ``fire``:

    python preprocess.py pipeline --archive data_aishell.tgz --out data/
    python preprocess.py extract  --archive data_aishell.tgz --out data/
    python preprocess.py build    --root data/data_aishell --out data/
"""

from __future__ import annotations

import os
import sys

from asr_chinese_e2e.data.extract import extract_aishell1
from asr_chinese_e2e.data.manifest import AiShell1Collector
from asr_chinese_e2e.utils.cli import parse_kwargs


def extract(archive: str, out: str = "data/") -> str:
    root = extract_aishell1(archive, out)
    print(f"extracted to {root}")
    return root


def build(root: str, out: str = "data/", min_count: int = 1, max_vocab: int = 20000):
    collector = AiShell1Collector(root)
    for split, records in collector.items.items():
        print(f"{split}: {len(records)} utterances")
    vocab = collector.build_vocab(min_count=min_count, max_vocab=max_vocab)
    os.makedirs(out, exist_ok=True)
    vocab_path = os.path.join(out, "vocab.json")
    vocab.save(vocab_path)
    print(f"vocab: {vocab.vocab_size} tokens -> {vocab_path}")
    paths = collector.save(out)
    for split, path in paths.items():
        print(f"manifest[{split}] -> {path}")


def pipeline(archive: str, out: str = "data/", **kw):
    root = extract(archive, out)
    build(root, out, **kw)


def features(
    manifest: str,
    out: str,
    n_mels: int = 80,
    lfr_m: int = 4,
    lfr_n: int = 3,
    batch_size: int = 32,
    max_seconds: float = 15.0,
    **_,
):
    """Predump device-computed features to .npy + a cached-feature manifest
    (the reference's ``pre_dump_features`` analogue,
    ``data/data_loader/ai_shell_1.py:44-64`` — .npy instead of torch
    pickles). Output manifest rows: {"feature", "wave", "tgt", "frames"}."""
    import jax.numpy as jnp
    import numpy as np

    from asr_chinese_e2e.data.batching import load_wav
    from asr_chinese_e2e.data.features import FeatureConfig, parse_batch
    from asr_chinese_e2e.data.manifest import read_manifest, write_manifest

    cfg = FeatureConfig(n_mels=n_mels, lfr_m=lfr_m, lfr_n=lfr_n)
    records = read_manifest(manifest)
    os.makedirs(out, exist_ok=True)
    max_samples = int(max_seconds * cfg.sample_rate)
    new_records = []
    for start in range(0, len(records), batch_size):
        chunk = records[start : start + batch_size]
        waves = [load_wav(r["wave"])[:max_samples] for r in chunk]
        s = max(len(w) for w in waves)
        wave = np.zeros((len(chunk), s), np.float32)
        lengths = np.zeros((len(chunk),), np.int32)
        for j, w in enumerate(waves):
            wave[j, : len(w)] = w
            lengths[j] = len(w)
        feats, feat_lens = parse_batch(jnp.asarray(wave), jnp.asarray(lengths), cfg)
        feats, feat_lens = np.asarray(feats), np.asarray(feat_lens)
        for j, r in enumerate(chunk):
            utt = r["wave"].rsplit("/", 1)[-1].rsplit(".", 1)[0]
            path = os.path.join(out, utt + ".npy")
            np.save(path, feats[j, : feat_lens[j]])
            new_records.append(
                {"feature": path, "wave": r["wave"], "tgt": r["tgt"],
                 "frames": int(feat_lens[j])}
            )
        if (start // batch_size) % 50 == 0:
            print(f"{start + len(chunk)}/{len(records)}")
    out_manifest = os.path.join(out, "manifest.jsonl")
    write_manifest(out_manifest, new_records)
    print(f"wrote {len(new_records)} cached-feature rows -> {out_manifest}")


def main():
    if any(a in ("--help", "-h") for a in sys.argv[1:]):
        print(__doc__)
        return
    positional, kwargs = parse_kwargs(sys.argv[1:])
    cmd = positional[0] if positional else "pipeline"
    fn = {
        "extract": extract,
        "build": build,
        "pipeline": pipeline,
        "features": features,
    }.get(cmd)
    if fn is None:
        print(__doc__)
        sys.exit(1)
    fn(**kwargs)


if __name__ == "__main__":
    main()
