"""Decoded-CER eval path in the trainer (eval_decode=ctc_greedy)."""

import pytest
import json
import os

from tests.test_trainer_e2e import corpus, make_trainer  # noqa: F401


def test_eval_decode_ctc_greedy(corpus, tmp_path):  # noqa: F811
    # rebuild a trainer with eval_decode enabled (the knob is read at
    # construction time)
    trainer2, _ = make_trainer(corpus, str(tmp_path / "exp2"))
    trainer2.cfg.build(eval_decode="ctc_greedy")
    from asr_chinese_e2e.train.trainer import Trainer

    t = Trainer(
        trainer2.model, trainer2.tx,
        trainer2.cfg, trainer2.feat_cfg, trainer2.vocab,
        train_loader=trainer2.train_loader,
        dev_loader=trainer2.dev_loader,
        test_loader=trainer2.test_loader,
    )
    t.train()
    rows = [json.loads(l) for l in open(os.path.join(t.exp_dir, "scalars.jsonl"))]
    decoded = [r for r in rows if any("decoded_cer" in k for k in r)]
    assert decoded, "decoded_cer scalar missing from eval rows"
    val = [v for r in decoded for k, v in r.items() if "decoded_cer" in k][0]
    assert 0.0 <= val <= 400.0


@pytest.mark.slow
def test_eval_decode_beam_and_joint(corpus, tmp_path):  # noqa: F811
    """The trainer's decoded-CER eval also runs with the beam and joint
    one-pass CTC/attention modes (needs a hybrid encoder-decoder)."""
    from asr_chinese_e2e.data.batching import BucketedLoader
    from asr_chinese_e2e.data.features import FeatureConfig
    from asr_chinese_e2e.models.transformer import (
        SpeechTransformer,
        default_config,
    )
    from asr_chinese_e2e.train.optimizer import (
        default_train_config,
        make_optimizer,
    )
    from asr_chinese_e2e.train.trainer import Trainer

    mpath, vocab, _ = corpus
    feat_cfg = FeatureConfig(n_mels=20)
    for mode in ("beam", "joint"):
        mcfg = default_config().build(
            d_model=32, num_heads=2, head_dim=16, d_ff=32,
            num_encoder_layers=1, num_decoder_layers=1,
            input_dim=feat_cfg.feature_dim, dropout_rate=0.0,
            ctc_weight=0.3, max_target_len=8,
        )
        tcfg = default_train_config().combine(mcfg).build(
            batch_size=4, num_epoch=1, log_every_iter=2,
            eval_every_iter=1000, save_every_iter=1000,
            lr_schedule="constant", lr=1e-3,
            exp_root=str(tmp_path / f"exp_{mode}"), exp_name="e",
            eval_decode=mode, eval_beam_size=3,
        )
        loader = BucketedLoader(mpath, vocab, batch_size=4, max_target_len=8, seed=0)
        model = SpeechTransformer(mcfg, vocab.vocab_size)
        tx = make_optimizer(tcfg, mcfg.d_model)
        t = Trainer(
            model, tx, tcfg, feat_cfg, vocab,
            train_loader=loader, test_loader=loader,
        )
        t.train()
        rows = [
            json.loads(l) for l in open(os.path.join(t.exp_dir, "scalars.jsonl"))
        ]
        vals = [v for r in rows for k, v in r.items() if "decoded_cer" in k]
        assert vals and all(0.0 <= v <= 400.0 for v in vals), (mode, vals)
