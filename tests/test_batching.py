"""Bucketed loader: static shapes, drop_last, determinism, host sharding."""

import numpy as np

from asr_chinese_e2e.data.batching import BucketedLoader
from asr_chinese_e2e.data.manifest import write_manifest
from asr_chinese_e2e.data.vocab import Vocab

from tests.test_manifest import write_wav


def setup_data(tmp_path, n_short=10, n_long=7):
    records = []
    for i in range(n_short):
        p = str(tmp_path / f"s{i}.wav")
        write_wav(p, n_samples=16000)  # 1 s -> 2 s bucket
        records.append({"wave": p, "tgt": "你好", "frames": 16000})
    for i in range(n_long):
        p = str(tmp_path / f"l{i}.wav")
        write_wav(p, n_samples=48000)  # 3 s -> 4 s bucket
        records.append({"wave": p, "tgt": "世界你好", "frames": 48000})
    mpath = str(tmp_path / "train.jsonl")
    write_manifest(mpath, records)
    v = Vocab()
    v.consume_sentence_list(["你好世界"])
    return mpath, v.build()


def test_static_bucket_shapes_and_drop_last(tmp_path):
    mpath, vocab = setup_data(tmp_path)
    loader = BucketedLoader(mpath, vocab, batch_size=4, max_target_len=8, seed=1)
    batches = list(loader.epoch(0))
    # 10 short -> 2 full batches of 4 (2 dropped); 7 long -> 1 batch (3 dropped)
    assert len(batches) == 3 == len(loader)
    for b in batches:
        assert b.wave.shape[0] == 4
        assert b.wave.shape[1] == b.bucket  # padded to bucket boundary
        assert b.bucket in (32000, 64000)
        # labels pad to the bucket's label boundary (max target 2 or 4
        # tokens -> _round_label_pad -> 7), not the global max_target_len
        assert b.labels.shape == (4, 7)
        assert (b.wave_lengths <= b.bucket).all()


def test_label_bucketing_off_pads_to_max(tmp_path):
    mpath, vocab = setup_data(tmp_path)
    loader = BucketedLoader(
        mpath, vocab, batch_size=4, max_target_len=8, seed=1,
        label_bucketing=False,
    )
    for b in loader.epoch(0):
        assert b.labels.shape == (4, 8)


def test_label_boundary_caps_at_max_target_len(tmp_path):
    records = []
    long_tgt = "你好世界" * 5  # 20 tokens -> _round_label_pad 23 > cap 16
    for i in range(4):
        p = str(tmp_path / f"x{i}.wav")
        write_wav(p, n_samples=16000)
        records.append({"wave": p, "tgt": long_tgt[: 13 + i], "frames": 16000})
    mpath = str(tmp_path / "train.jsonl")
    write_manifest(mpath, records)
    v = Vocab()
    v.consume_sentence_list([long_tgt])
    vocab = v.build()
    loader = BucketedLoader(mpath, vocab, batch_size=4, max_target_len=16)
    b = next(iter(loader.epoch(0)))
    assert b.labels.shape == (4, 16)
    assert int(b.label_lengths.max()) == 16


def test_epoch_determinism_and_reshuffle(tmp_path):
    mpath, vocab = setup_data(tmp_path)
    loader = BucketedLoader(mpath, vocab, batch_size=2, max_target_len=8, seed=7)
    a = [b.texts for b in loader.epoch(3)]
    b = [b.texts for b in loader.epoch(3)]
    c = [b.texts for b in loader.epoch(4)]
    assert a == b  # same epoch -> identical stream
    assert a != c  # different epoch -> reshuffled


def test_host_sharding_disjoint_and_complete(tmp_path):
    mpath, vocab = setup_data(tmp_path, n_short=12, n_long=0)
    seen = []
    for host in range(2):
        loader = BucketedLoader(
            mpath, vocab, batch_size=2, max_target_len=8, seed=5,
            num_hosts=2, host_id=host, shuffle=True,
        )
        for batch in loader.epoch(0):
            seen.extend(batch.wave_lengths.tolist())
    # 12 utts split 6/6, all consumed exactly once across hosts
    assert len(seen) == 12


def test_multihost_lockstep_schedule(tmp_path):
    """SPMD safety: with skewed duration distributions, every host must emit
    the SAME number of batches with the SAME bucket sequence every epoch
    (round-2 VERDICT #3), while records stay disjoint and complete."""
    # skewed corpus: 29 short, 11 medium, 5 long (primes -> awkward splits)
    records = []
    p = str(tmp_path / "w.wav")
    write_wav(p, n_samples=16000)
    pm = str(tmp_path / "m.wav")
    write_wav(pm, n_samples=48000)
    pl = str(tmp_path / "l.wav")
    write_wav(pl, n_samples=80000)
    for i in range(29):
        records.append({"wave": p, "tgt": f"你好", "frames": 16000, "id": f"s{i}"})
    for i in range(11):
        records.append({"wave": pm, "tgt": "世界你好", "frames": 48000, "id": f"m{i}"})
    for i in range(5):
        records.append({"wave": pl, "tgt": "你好你好世界", "frames": 80000, "id": f"l{i}"})
    mpath = str(tmp_path / "train.jsonl")
    write_manifest(mpath, records)
    v = Vocab()
    v.consume_sentence_list(["你好世界"])
    vocab = v.build()

    for num_hosts in (2, 4, 8):
        for seed in (0, 3, 11):
            for epoch in (0, 1, 2):
                schedules, all_ids = [], []
                for host in range(num_hosts):
                    loader = BucketedLoader(
                        mpath, vocab, batch_size=2, seed=seed,
                        num_hosts=num_hosts, host_id=host, prefetch=0,
                    )
                    assert len(loader) == sum(1 for _ in loader.epoch(epoch))
                    sched = []
                    for b in loader.epoch(epoch):
                        sched.append((b.bucket, b.wave.shape, b.labels.shape))
                        all_ids.extend(b.wave_lengths.tolist())
                    schedules.append(sched)
                # identical batch count AND bucket/shape sequence on every host
                assert all(s == schedules[0] for s in schedules[1:]), (
                    num_hosts, seed, epoch, [len(s) for s in schedules])
                # disjoint + complete: total rows == num_global_batches * gsz
                gsz = 2 * num_hosts
                assert len(all_ids) == len(schedules[0]) * gsz


def test_multihost_records_disjoint_complete(tmp_path):
    """Each record appears on exactly one host per epoch."""
    records = []
    for i in range(16):
        p = str(tmp_path / f"u{i}.wav")
        write_wav(p, n_samples=16000 + i)  # unique length tags the record
        records.append({"wave": p, "tgt": "你好", "frames": 16000 + i})
    mpath = str(tmp_path / "train.jsonl")
    write_manifest(mpath, records)
    v = Vocab()
    v.consume_sentence_list(["你好"])
    vocab = v.build()
    seen = []
    for host in range(4):
        loader = BucketedLoader(
            mpath, vocab, batch_size=2, seed=5, num_hosts=4, host_id=host,
            prefetch=0,
        )
        for b in loader.epoch(0):
            seen.extend(b.wave_lengths.tolist())
    assert sorted(seen) == sorted(16000 + i for i in range(16))


def test_wave_normalised(tmp_path):
    mpath, vocab = setup_data(tmp_path)
    loader = BucketedLoader(mpath, vocab, batch_size=4, max_target_len=8)
    batch = next(iter(loader.epoch(0)))
    assert np.abs(batch.wave).max() <= 1.0
    assert batch.wave.dtype == np.float32


def test_label_ids_roundtrip(tmp_path):
    mpath, vocab = setup_data(tmp_path)
    loader = BucketedLoader(mpath, vocab, batch_size=4, max_target_len=8)
    batch = next(iter(loader.epoch(0)))
    for i, text in enumerate(batch.texts):
        ids = batch.labels[i, : batch.label_lengths[i]].tolist()
        assert vocab.ids_to_str(ids).replace(" ", "") == text


def test_drop_last_false_covers_every_record_across_buckets(tmp_path):
    """Eval-split regression (r4): a small corpus spread over buckets can
    fill NO bucket to batch_size — with drop_last=True every eval batch
    vanished and the dev eval ran on zero data. drop_last=False must emit
    the per-bucket tails so total coverage is exact."""
    mpath, vocab = setup_data(tmp_path, n_short=3, n_long=2)  # no full batch
    strict = BucketedLoader(mpath, vocab, batch_size=4, max_target_len=8, seed=1)
    assert list(strict.epoch(0)) == []  # the failure mode
    loader = BucketedLoader(
        mpath, vocab, batch_size=4, max_target_len=8, seed=1, drop_last=False,
    )
    batches = list(loader.epoch(0))
    assert sum(b.wave.shape[0] for b in batches) == 5
    texts = [t for b in batches for t in b.texts]
    assert sorted(texts) == sorted(["你好"] * 3 + ["世界你好"] * 2)
