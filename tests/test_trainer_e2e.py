"""Minimum end-to-end slice (north-star config #1): tiny BiLSTM+CTC train
on a synthetic manifest, CPU-runnable — exercises manifest → bucketed
loader → on-device fbank/CMVN/LFR → model → CTC loss → Noam/Adam →
checkpoint → eval → resume."""

import json
import os

import numpy as np
import pytest

from asr_chinese_e2e.data.batching import BucketedLoader
from asr_chinese_e2e.data.features import FeatureConfig
from asr_chinese_e2e.data.manifest import write_manifest
from asr_chinese_e2e.data.vocab import Vocab
from asr_chinese_e2e.models.rnn import BiLSTMCTC, default_ctc_config
from asr_chinese_e2e.train.optimizer import default_train_config, make_optimizer
from asr_chinese_e2e.train.trainer import Trainer

from tests.test_manifest import write_wav

SR = 16000


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("corpus")
    texts = ["你好", "世界", "你好世界", "好你"]
    records = []
    rng = np.random.RandomState(0)
    for i in range(24):
        p = str(tmp_path / f"u{i}.wav")
        n = SR // 2  # 0.5 s
        write_wav(p, n_samples=n)
        records.append({"wave": p, "tgt": texts[i % len(texts)], "frames": n})
    mpath = str(tmp_path / "train.jsonl")
    write_manifest(mpath, records)
    v = Vocab()
    v.consume_sentence_list(texts)
    v.build()
    return mpath, v, str(tmp_path)


def make_trainer(corpus, exp_root, num_epoch=2, **extra):
    mpath, vocab, _ = corpus
    feat_cfg = FeatureConfig(n_mels=20)
    mcfg = default_ctc_config().build(
        hidden_size=16,
        num_encoder_layers=1,
        input_dim=feat_cfg.feature_dim,
        dropout_rate=0.0,
    )
    tcfg = default_train_config().combine(mcfg)
    tcfg.build(
        batch_size=4,
        num_epoch=num_epoch,
        log_every_iter=2,
        eval_every_iter=4,
        save_every_iter=1000,
        lr_schedule="constant",
        lr=5e-3,
        exp_root=exp_root,
        exp_name="e2e",
        **extra,
    )
    loader = BucketedLoader(mpath, vocab, batch_size=4, max_target_len=8, seed=0)
    model = BiLSTMCTC(mcfg, vocab.vocab_size)
    tx = make_optimizer(tcfg, mcfg.hidden_size)
    return Trainer(
        model, tx, tcfg, feat_cfg, vocab,
        train_loader=loader, dev_loader=loader, test_loader=loader,
    ), tcfg


def test_e2e_train_eval_checkpoint(corpus, tmp_path):
    trainer, tcfg = make_trainer(corpus, str(tmp_path / "exp"))
    trainer.train()
    # scalars logged
    scalars_path = os.path.join(trainer.exp_dir, "scalars.jsonl")
    assert os.path.exists(scalars_path)
    rows = [json.loads(l) for l in open(scalars_path)]
    train_losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert len(train_losses) >= 4
    assert train_losses[-1] < train_losses[0]  # loss decreases
    # dev and test evals ran
    assert any("dev/loss" in r for r in rows)
    assert any("test/loss" in r for r in rows)
    # throughput metric present
    assert any("train/audio_s_per_s_per_chip" in r for r in rows)
    # checkpoints written with reference naming + config json saved
    assert trainer.ckpt.latest_name is not None
    assert os.path.exists(os.path.join(trainer.exp_dir, "config.json"))
    # 12 steps per epoch? 24 utts / bs 4 = 6 batches, 2 epochs = 12 steps
    assert int(trainer.state.step) == 12


@pytest.mark.slow
def test_e2e_resume(corpus, tmp_path):
    trainer, _ = make_trainer(corpus, str(tmp_path / "exp1"), num_epoch=1)
    trainer.train()
    step_before = int(trainer.state.step)

    trainer2, _ = make_trainer(corpus, str(tmp_path / "exp1"), num_epoch=2)
    trainer2.train(from_ckpt="latest")  # resumes at epoch 1, runs epoch 2
    assert int(trainer2.state.step) == step_before + 6

def test_best_checkpoint_follows_dev_not_test(corpus, tmp_path, monkeypatch):
    """The 'best' pointer must track the DEV metric; the epoch-end TEST
    eval is reporting only (selecting best on test is malpractice)."""
    trainer, tcfg = make_trainer(corpus, str(tmp_path / "expdev"), num_epoch=2)
    tcfg.build(eval_every_iter=10_000)  # keep mid-epoch dev evals out
    # dev improves at epoch 0 then worsens; test does the OPPOSITE —
    # if best followed test it would move to the epoch-1 checkpoint
    scripted = {"dev/": iter([1.0, 2.0]), "test/": iter([5.0, 0.1])}
    monkeypatch.setattr(
        Trainer, "evaluate", lambda self, loader, prefix="dev/": next(scripted[prefix])
    )
    trainer.train()
    assert trainer.ckpt.best_name == "e1_s6"  # saved at end of epoch 0
    assert trainer.ckpt.latest_name == "e2_s12"


@pytest.mark.slow
def test_steps_per_dispatch_matches_single_step(corpus, tmp_path):
    """steps_per_dispatch=2 (k same-bucket steps fused into one dispatch,
    train_step.make_multi_step) must log the SAME per-step loss stream as
    the plain per-step trainer — grouping changes dispatch, not math."""

    def losses(exp, **extra):
        trainer, _ = make_trainer(corpus, str(tmp_path / exp), num_epoch=1, **extra)
        trainer.train()
        rows = [json.loads(l) for l in open(
            os.path.join(trainer.exp_dir, "scalars.jsonl"))]
        return [(r["step"], r["train/loss"]) for r in rows if "train/loss" in r]

    base = losses("exp_spd1")
    fused = losses("exp_spd2", steps_per_dispatch=2)
    assert len(base) == len(fused) and len(base) >= 2
    for (s1, l1), (s2, l2) in zip(base, fused):
        assert s1 == s2
        np.testing.assert_allclose(l1, l2, rtol=1e-4)


def test_zero_cadences_disable_mid_epoch_eval_and_save(corpus, tmp_path):
    """eval_every_iter=0 / save_every_iter=0 mean "cadence disabled" —
    they used to ZeroDivisionError in the dispatch loop (r4). Epoch-end
    evals and the final save still run."""
    tr, _ = make_trainer(corpus, str(tmp_path), num_epoch=1)
    tr.cfg.build(eval_every_iter=0, save_every_iter=0)
    tr.train()
    rows = [json.loads(l) for l in open(os.path.join(tr.exp_dir, "scalars.jsonl"))]
    assert any("train/loss" in r for r in rows)
    assert any("dev/loss" in r for r in rows)  # epoch-end eval unaffected
