import json
import os
import wave as wavelib

import numpy as np

from asr_chinese_e2e.data.manifest import (
    AiShell1Collector,
    read_manifest,
)


def write_wav(path, n_samples=1600, sr=16000):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with wavelib.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(
            (np.sin(np.arange(n_samples)) * 1000).astype(np.int16).tobytes()
        )


def make_tree(root):
    utts = {
        ("train", "S0001", "BAC009S0001W0001"): "你 好 世 界",
        ("train", "S0001", "BAC009S0001W0002"): "今 天 天 气",
        ("dev", "S0002", "BAC009S0002W0001"): "你 好",
        ("test", "S0003", "BAC009S0003W0001"): "世 界",
    }
    lines = []
    for (split, spk, utt), text in utts.items():
        write_wav(os.path.join(root, "wav", split, spk, utt + ".wav"))
        lines.append(f"{utt} {text}")
    # one wav with no transcript -> must be dropped
    write_wav(os.path.join(root, "wav", "train", "S0001", "BAC009S0001W0099.wav"))
    os.makedirs(os.path.join(root, "transcript"), exist_ok=True)
    with open(
        os.path.join(root, "transcript", "aishell_transcript_v0.8.txt"),
        "w",
        encoding="utf-8",
    ) as f:
        f.write("\n".join(lines))
    return utts


def test_collector(tmp_path):
    root = str(tmp_path / "data_aishell")
    make_tree(root)
    c = AiShell1Collector(root)
    assert len(c.items["train"]) == 2  # untranscribed wav dropped
    assert len(c.items["dev"]) == 1
    assert len(c.items["test"]) == 1
    rec = c.items["train"][0]
    assert rec["tgt"] == "你好世界"  # inner spaces removed
    assert rec["frames"] == 1600  # duration from header for bucketing
    assert os.path.exists(rec["wave"])


def test_vocab_from_train_only(tmp_path):
    root = str(tmp_path / "data_aishell")
    make_tree(root)
    v = AiShell1Collector(root).build_vocab()
    # train chars present, 4 specials + 8 unique train chars
    assert v.vocab_size == 4 + len(set("你好世界今天天气"))


def test_manifest_jsonl_roundtrip(tmp_path):
    root = str(tmp_path / "data_aishell")
    make_tree(root)
    c = AiShell1Collector(root)
    paths = c.save(str(tmp_path / "manifests"))
    records = read_manifest(paths["train"])
    assert records == c.items["train"]
    # JSONL shape parity: one {"wave","tgt",...} object per line
    with open(paths["train"], encoding="utf-8") as f:
        first = json.loads(f.readline())
    assert set(first) >= {"wave", "tgt"}
