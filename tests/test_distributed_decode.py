"""Distributed rescoring collectives on the 8-device virtual mesh."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from asr_chinese_e2e.decode.distributed import make_sharded_rescorer
from asr_chinese_e2e.parallel.sharding import make_mesh


def test_distributed_rescore_matches_local():
    mesh = make_mesh()  # 8-way data
    rng = np.random.RandomState(0)
    B, K = 16, 5
    ctc = jnp.asarray(rng.randn(B, K).astype(np.float32))
    att = jnp.asarray(rng.randn(B, K).astype(np.float32))
    lam = 0.3

    rescorer = make_sharded_rescorer(mesh)
    global_scores, best = rescorer(ctc, att, jnp.float32(lam))

    want = lam * np.asarray(ctc) + (1 - lam) * np.asarray(att)
    np.testing.assert_allclose(np.asarray(global_scores), want, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(best), want.argmax(-1))


def test_exchange_scores_assembles_global_tile():
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from asr_chinese_e2e.decode.distributed import exchange_scores

    mesh = make_mesh()
    B, K = 8, 3
    scores = jnp.arange(B * K, dtype=jnp.float32).reshape(B, K)

    fn = shard_map(
        lambda s: exchange_scores(s, "data"),
        mesh=mesh,
        in_specs=(P("data"),),
        out_specs=P(),  # replicated global result on every device
        check_vma=False,
    )
    out = fn(scores)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(scores))


def test_distributed_beam_matches_single_device():
    """End-to-end distributed decode (VERDICT r1 #4): encoder outputs
    sharded over `data`, per-shard device beams, all_gathered n-best —
    must be identical to the single-device beam on the same inputs."""
    from asr_chinese_e2e.decode.beam import beam_search
    from asr_chinese_e2e.decode.distributed import distributed_beam_search
    from tests.test_decode import setup_attention_model

    model, params, enc_out, enc_lens = setup_attention_model()
    # tile the 2-utt batch to 8 rows so every mesh shard owns one row
    enc_out8 = jnp.tile(enc_out, (4, 1, 1))
    enc_lens8 = jnp.tile(enc_lens, (4,))
    want = beam_search(model, params, enc_out8, enc_lens8, 4, 6)

    mesh = make_mesh()  # 8-way data
    got = distributed_beam_search(
        model, params, enc_out8, enc_lens8, 4, 6, mesh
    )
    np.testing.assert_array_equal(want.tokens, got.tokens)
    np.testing.assert_allclose(want.scores, got.scores, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(want.finished, got.finished)


def test_distributed_beam_indivisible_falls_back():
    from asr_chinese_e2e.decode.beam import beam_search
    from asr_chinese_e2e.decode.distributed import distributed_beam_search
    from tests.test_decode import setup_attention_model

    model, params, enc_out, enc_lens = setup_attention_model()
    enc3 = jnp.tile(enc_out, (3, 1, 1))[:3]
    lens3 = jnp.tile(enc_lens, (3,))[:3]
    mesh = make_mesh()  # 8 does not divide 3
    want = beam_search(model, params, enc3, lens3, 3, 5)
    got = distributed_beam_search(model, params, enc3, lens3, 3, 5, mesh)
    np.testing.assert_array_equal(want.tokens, got.tokens)


@pytest.mark.slow
def test_trainer_eval_decode_beam_under_mesh(tmp_path):
    """Trainer eval_decode='beam' must run the distributed pipeline when a
    data mesh is active and still produce a finite decoded CER."""
    import json
    import os

    from asr_chinese_e2e.data.batching import BucketedLoader
    from asr_chinese_e2e.data.features import FeatureConfig
    from asr_chinese_e2e.data.manifest import write_manifest
    from asr_chinese_e2e.data.vocab import Vocab
    from asr_chinese_e2e.models.transformer import SpeechTransformer
    from asr_chinese_e2e.train.optimizer import (
        default_train_config,
        make_optimizer,
    )
    from asr_chinese_e2e.train.trainer import Trainer
    from tests.test_manifest import write_wav
    from tests.test_transformer import tiny_cfg

    texts = ["你好", "世界", "你好世界", "好你"]
    records = []
    for i in range(8):
        p = str(tmp_path / f"u{i}.wav")
        write_wav(p, n_samples=8000)
        records.append({"wave": p, "tgt": texts[i % 4], "frames": 8000})
    mpath = str(tmp_path / "train.jsonl")
    write_manifest(mpath, records)
    vocab = Vocab()
    vocab.consume_sentence_list(texts)
    vocab.build()

    feat_cfg = FeatureConfig(n_mels=20)
    cfg = tiny_cfg(dropout_rate=0.0, input_dim=feat_cfg.feature_dim)
    tcfg = default_train_config().combine(cfg)
    tcfg.build(
        batch_size=4, num_epoch=1, log_every_iter=1, eval_every_iter=1000,
        save_every_iter=1000, lr_schedule="constant", lr=1e-3,
        exp_root=str(tmp_path), exp_name="distdec",
        eval_decode="beam", eval_beam_size=2, max_target_len=8,
    )
    loader = BucketedLoader(mpath, vocab, batch_size=4, max_target_len=8, seed=0)
    model = SpeechTransformer(cfg, vocab.vocab_size)
    tx = make_optimizer(tcfg, cfg.d_model)
    mesh = make_mesh(data=4, model=1)
    t = Trainer(
        model, tx, tcfg, feat_cfg, vocab,
        train_loader=loader, dev_loader=loader, mesh=mesh,
    )
    t.train()
    rows = [json.loads(l) for l in open(os.path.join(t.exp_dir, "scalars.jsonl"))]
    cers = [r["dev/decoded_cer"] for r in rows if "dev/decoded_cer" in r]
    assert cers and all(np.isfinite(c) for c in cers)
