"""True multi-process distributed smoke test (round-3 VERDICT #6).

Launches TWO separate Python processes that form a real
``jax.distributed`` cluster over local TCP (CPU backend, 2 virtual
devices each — a 4-device global mesh), runs the actual Trainer on a
shared synthetic corpus, and checks the seams that single-process tests
can only fake:

- disjoint per-host manifest shards covering the corpus exactly;
- equal batch counts on every host (SPMD lockstep);
- ONE writer of ``index.json`` / ``meta.json`` / ``scalars.jsonl``
  (process-0 gating) on the shared filesystem;
- async save (process 0 writes) + restore on both processes.
"""

import json
import os
import socket
import subprocess
import sys
from collections import Counter

import pytest

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_train_resume(tmp_path):
    from asr_chinese_e2e.utils.synth import make_synth_corpus

    paths = make_synth_corpus(
        str(tmp_path / "corpus"), n_train=64, n_dev=8, n_test=8,
        n_tone_chars=8, vocab_size=40,
        seconds_range=(1.0, 1.4), tone_sec=0.25, seed=3,
    )
    port = _free_port()
    procs, outs = [], []
    for pid in range(2):
        out = tmp_path / f"result_{pid}.json"
        wcfg = {
            "repo": REPO,
            "coord": f"127.0.0.1:{port}",
            "num_processes": 2,
            "process_id": pid,
            "manifest": paths["train"],
            "vocab": paths["vocab"],
            "exp_root": str(tmp_path / "exp"),
            "out": str(out),
        }
        cfg_path = tmp_path / f"wcfg_{pid}.json"
        cfg_path.write_text(json.dumps(wcfg))
        env = {
            **os.environ,
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
        }
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "_mp_worker.py"),
             str(cfg_path)],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
        outs.append(out)

    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout)
    for p, lg in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{lg[-4000:]}"

    results = [json.loads(o.read_text()) for o in outs]
    r0, r1 = sorted(results, key=lambda r: r["pid"])

    # SPMD lockstep: same number of batches on both hosts
    assert r0["n_batches"] == r1["n_batches"] > 0
    assert r0["step_after_train"] == r1["step_after_train"]
    assert r0["step_after_resume"] == r1["step_after_resume"]
    assert r0["step_after_resume"] > r0["step_after_train"]

    # disjoint shards covering the corpus exactly: the two shard multisets
    # sum to the full manifest multiset (no overlap, no loss; 64 records
    # split 8-per-global-batch divides evenly so nothing is dropped)
    manifest_texts = Counter(
        json.loads(l)["tgt"] for l in open(paths["train"])
    )
    assert Counter(r0["shard_paths"]) + Counter(r1["shard_paths"]) \
        == manifest_texts

    # single-writer artifacts on the shared filesystem
    exp_dir = r0["exp_dir"]
    assert exp_dir == r1["exp_dir"]
    idx = json.load(open(os.path.join(exp_dir, "checkpoints", "index.json")))
    assert idx["latest"] is not None
    # every checkpoint dir has exactly one meta.json and a committed state
    for name in idx["all"]:
        d = os.path.join(exp_dir, "checkpoints", name)
        assert os.path.isfile(os.path.join(d, "meta.json"))
        assert os.path.isdir(os.path.join(d, "state"))
    # scalars.jsonl written by process 0 only: steps never duplicate for
    # the same key set (two writers would double every row)
    rows = [json.loads(l) for l in open(os.path.join(exp_dir, "scalars.jsonl"))]
    seen = Counter(
        (r["step"], tuple(sorted(k for k in r if k not in ("step", "time"))))
        for r in rows
    )
    dupes = {k: c for k, c in seen.items() if c > 1}
    assert not dupes, f"duplicated scalar rows (two writers?): {dupes}"
