"""Hybrid CTC/attention learning test: a tiny SpeechTransformer must learn
the synthetic tone language and decode it correctly with BOTH the
attention-greedy path and beam search — validating the decoder/beam stack
on learned (not random) weights."""

import pytest

pytestmark = pytest.mark.slow
import jax
import jax.numpy as jnp
import numpy as np

from asr_chinese_e2e.data.batching import BucketedLoader
from asr_chinese_e2e.data.features import FeatureConfig, parse_batch
from asr_chinese_e2e.decode.beam import beam_search
from asr_chinese_e2e.decode.cer import corpus_cer
from asr_chinese_e2e.decode.greedy import attention_greedy_decode, tokens_to_ids
from asr_chinese_e2e.models.transformer import SpeechTransformer, default_config
from asr_chinese_e2e.train.optimizer import default_train_config, make_optimizer
from asr_chinese_e2e.train.train_step import make_step_fns

from tests.test_learning import make_corpus


def test_hybrid_learns_and_beam_decodes(tmp_path):
    mpath, vocab = make_corpus(tmp_path, n=48, seed=1)
    feat_cfg = FeatureConfig(n_mels=40)
    mcfg = default_config().build(
        d_model=64, num_heads=2, head_dim=32, d_ff=128,
        num_encoder_layers=2, num_decoder_layers=2,
        input_dim=feat_cfg.feature_dim, dropout_rate=0.0,
        ctc_weight=0.3, norm_type="pre",
    )
    tcfg = default_train_config().combine(mcfg).build(
        lr_schedule="constant", lr=2e-3, rng_impl="threefry2x32",
    )
    model = SpeechTransformer(mcfg, vocab.vocab_size)
    tx = make_optimizer(tcfg, mcfg.d_model)
    init_fn, train_step, _ = make_step_fns(model, tx, feat_cfg, tcfg)

    loader = BucketedLoader(
        mpath, vocab, batch_size=16, max_target_len=8, seed=0,
        bucket_seconds=(1.5,), prefetch=0,
    )
    first = next(iter(loader.epoch(0)))
    state = init_fn(
        jax.random.PRNGKey(0),
        {"wave": first.wave, "wave_lengths": first.wave_lengths,
         "labels": first.labels, "label_lengths": first.label_lengths},
    )
    rng = jax.random.key(0, impl="threefry2x32")
    loss = None
    for epoch in range(150):
        for b in loader.epoch(epoch):
            state, m = train_step(
                state,
                jnp.asarray(b.wave), jnp.asarray(b.wave_lengths),
                jnp.asarray(b.labels), jnp.asarray(b.label_lengths),
                rng,
            )
        loss = float(m["loss"])
        if loss < 0.05:
            break
    assert loss is not None and loss < 1.0, f"hybrid loss did not converge: {loss}"

    from asr_chinese_e2e.decode.joint import joint_beam_search

    hyps_greedy, hyps_beam, hyps_joint, refs = [], [], [], []
    for b in loader.epoch(0):
        feats, feat_lens = parse_batch(
            jnp.asarray(b.wave), jnp.asarray(b.wave_lengths), feat_cfg
        )
        enc_out, enc_lens = model.apply(state.params, feats, feat_lens, method="encode")
        tokens, _ = attention_greedy_decode(model, state.params, enc_out, enc_lens, 8)
        for ids in tokens_to_ids(tokens):
            hyps_greedy.append("".join(vocab.ids_to_tokens(ids)))
        res = beam_search(model, state.params, enc_out, enc_lens, beam_size=4, max_len=8)
        for hyp in res.nbest_ids(1):
            hyps_beam.append("".join(vocab.ids_to_tokens(hyp[0])))
        jres = joint_beam_search(
            model, state.params, enc_out, enc_lens, 4, 8,
            ctc_weight=0.3, ctc_prune=8,
        )
        for hyp in jres.nbest_ids(1):
            hyps_joint.append("".join(vocab.ids_to_tokens(hyp[0])))
        refs.extend(b.texts)

    cer_g = corpus_cer(hyps_greedy, refs)
    cer_b = corpus_cer(hyps_beam, refs)
    cer_j = corpus_cer(hyps_joint, refs)
    assert cer_g < 15.0, f"attention-greedy CER {cer_g} (e.g. {hyps_greedy[:3]} vs {refs[:3]})"
    assert cer_b <= cer_g + 1e-6 or cer_b < 15.0, f"beam CER {cer_b}"
    # one-pass joint decoding on learned weights must be at least as good
    # as the pure attention beam on this easy corpus
    assert cer_j <= cer_b + 1e-6 or cer_j < 15.0, f"joint CER {cer_j} vs beam {cer_b}"


def test_deepnorm_postln_learns(tmp_path):
    """The DeepNorm stabilizer knob (r4 VERDICT #1) must not break
    learning: a post-LN + deepnorm tiny hybrid model converges through
    the full stack (the flagship-scale evidence lives in the r5 post-LN
    sweep, BENCH_NOTES)."""
    mpath, vocab = make_corpus(tmp_path, n=48, seed=2)
    feat_cfg = FeatureConfig(n_mels=40)
    mcfg = default_config().build(
        d_model=64, num_heads=2, head_dim=32, d_ff=128,
        num_encoder_layers=2, num_decoder_layers=2,
        input_dim=feat_cfg.feature_dim, dropout_rate=0.0,
        ctc_weight=0.3, norm_type="post", deepnorm=True,
    )
    tcfg = default_train_config().combine(mcfg).build(
        lr_schedule="constant", lr=1e-3, rng_impl="threefry2x32",
    )
    model = SpeechTransformer(mcfg, vocab.vocab_size)
    tx = make_optimizer(tcfg, mcfg.d_model)
    init_fn, train_step, _ = make_step_fns(model, tx, feat_cfg, tcfg)
    loader = BucketedLoader(
        mpath, vocab, batch_size=16, max_target_len=8, seed=0,
        bucket_seconds=(1.5,), prefetch=0,
    )
    first = next(iter(loader.epoch(0)))
    state = init_fn(
        jax.random.PRNGKey(0),
        {"wave": first.wave, "wave_lengths": first.wave_lengths,
         "labels": first.labels, "label_lengths": first.label_lengths},
    )
    rng = jax.random.key(0, impl="threefry2x32")
    first_loss, loss = None, None
    for epoch in range(80):
        for b in loader.epoch(epoch):
            state, m = train_step(
                state,
                jnp.asarray(b.wave), jnp.asarray(b.wave_lengths),
                jnp.asarray(b.labels), jnp.asarray(b.label_lengths),
                rng,
            )
        loss = float(m["loss"])
        if first_loss is None:
            first_loss = loss
        if loss < 0.1:
            break
    assert loss < min(1.0, first_loss / 3), (first_loss, loss)
