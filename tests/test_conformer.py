"""Conformer encoder family (net-new beyond the reference zoo).

Fast tier: forward shapes, pad-length invariance of the conv module /
full block, gradient flow, registry entry. Slow tier: the tone language
is learnable end-to-end through the conformer encoder with the standard
hybrid objective and both CTC-greedy and attention decode paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asr_chinese_e2e.core.config import Config
from asr_chinese_e2e.core.registry import get_model
from asr_chinese_e2e.data.features import FeatureConfig
from asr_chinese_e2e.models.layers import ConvModule
from asr_chinese_e2e.models.transformer import SpeechTransformer, default_config


def tiny_conformer_cfg(**kw) -> Config:
    base = dict(
        d_model=32, num_heads=2, head_dim=16, d_ff=64,
        num_encoder_layers=2, num_decoder_layers=1,
        input_dim=FeatureConfig(n_mels=20).feature_dim,
        dropout_rate=0.0, encoder_type="conformer", norm_type="pre",
        conv_kernel_size=7, ctc_weight=0.3,
    )
    base.update(kw)
    return default_config().build(**base)


def _batch(rng, b=2, t=30, dim=80, l=5, vocab=20):
    feats = jnp.asarray(rng.randn(b, t, dim).astype(np.float32))
    feat_lens = jnp.asarray([t, t - 9], np.int32)
    labels = jnp.asarray(rng.randint(4, vocab, size=(b, l)), np.int32)
    label_lens = jnp.asarray([l, l - 2], np.int32)
    return feats, feat_lens, labels, label_lens


def test_conv_module_pad_invariance():
    """Valid-frame outputs must not depend on how much padding follows:
    the module zero-masks before the depthwise conv."""
    rng = np.random.RandomState(0)
    x = rng.randn(1, 20, 16).astype(np.float32)
    lengths = jnp.asarray([14], np.int32)
    mod = ConvModule(d_model=16, kernel_size=5)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), lengths)
    short = mod.apply(params, jnp.asarray(x[:, :16]), lengths)
    full = mod.apply(params, jnp.asarray(x), lengths)
    np.testing.assert_allclose(
        np.asarray(short)[:, :14], np.asarray(full)[:, :14], atol=1e-6
    )


def test_conformer_forward_and_pad_invariance():
    cfg = tiny_conformer_cfg()
    model = SpeechTransformer(cfg, vocab_size=20)
    rng = np.random.RandomState(1)
    feats, feat_lens, labels, label_lens = _batch(rng, dim=cfg.input_dim)
    params = model.init(jax.random.PRNGKey(0), feats, feat_lens, labels, label_lens)
    out = model.apply(params, feats, feat_lens, labels, label_lens)
    assert out["logits"].shape == (2, labels.shape[1] + 1, 20)
    assert out["ctc_logits"].shape == (2, feats.shape[1], 20)

    # encoder output on valid frames is invariant to trailing pad length
    enc_full, _ = model.apply(params, feats, feat_lens, method="encode")
    more = jnp.pad(feats, ((0, 0), (0, 12), (0, 0)))
    enc_pad, _ = model.apply(params, more, feat_lens, method="encode")
    np.testing.assert_allclose(
        np.asarray(enc_full)[1, : int(feat_lens[1])],
        np.asarray(enc_pad)[1, : int(feat_lens[1])],
        atol=2e-5,
    )


def test_conformer_grads_flow():
    from asr_chinese_e2e.losses import model_loss

    cfg = tiny_conformer_cfg()
    model = SpeechTransformer(cfg, vocab_size=20)
    rng = np.random.RandomState(2)
    feats, feat_lens, labels, label_lens = _batch(rng, dim=cfg.input_dim)
    params = model.init(jax.random.PRNGKey(0), feats, feat_lens, labels, label_lens)

    def loss_fn(p):
        out = model.apply(p, feats, feat_lens, labels, label_lens)
        loss, _ = model_loss(out, labels, label_lens, 0.3, 0.0, "scan")
        return loss

    loss, grads = jax.value_and_grad(loss_fn)(params)
    assert np.isfinite(float(loss))
    leaves = jax.tree_util.tree_leaves(grads)
    assert all(np.all(np.isfinite(np.asarray(g))) for g in leaves)
    # every conformer submodule receives gradient (conv path included)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    conv_leaves = [
        np.abs(np.asarray(g)).sum()
        for path, g in flat
        if any("conv" in str(p) for p in path)
    ]
    assert conv_leaves and sum(conv_leaves) > 0


def test_conformer_registered():
    cls, cfg_fn = get_model("Conformer")
    cfg = cfg_fn()
    assert cls is SpeechTransformer
    assert cfg.encoder_type == "conformer"


@pytest.mark.slow
def test_conformer_learns_tone_language(tmp_path):
    from asr_chinese_e2e.data.batching import BucketedLoader
    from asr_chinese_e2e.data.features import parse_batch
    from asr_chinese_e2e.decode.cer import corpus_cer
    from asr_chinese_e2e.decode.greedy import (
        attention_greedy_decode,
        ctc_greedy_decode,
        tokens_to_ids,
    )
    from asr_chinese_e2e.train.optimizer import (
        default_train_config,
        make_optimizer,
    )
    from asr_chinese_e2e.train.train_step import make_step_fns
    from tests.test_learning import make_corpus

    mpath, vocab = make_corpus(tmp_path, n=48, seed=4)
    feat_cfg = FeatureConfig(n_mels=40)
    mcfg = tiny_conformer_cfg(
        d_model=64, num_heads=2, head_dim=32, d_ff=128,
        num_decoder_layers=2, input_dim=feat_cfg.feature_dim,
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
    assert loss is not None and loss < 1.0, f"conformer loss stuck at {loss}"

    hyps_ctc, hyps_att, refs = [], [], []
    for b in loader.epoch(0):
        feats, feat_lens = parse_batch(
            jnp.asarray(b.wave), jnp.asarray(b.wave_lengths), feat_cfg
        )
        enc_out, enc_lens = model.apply(state.params, feats, feat_lens, method="encode")
        lp = model.apply(state.params, enc_out, method="ctc_log_probs")
        for ids in ctc_greedy_decode(lp, enc_lens):
            hyps_ctc.append("".join(vocab.ids_to_tokens(ids)))
        tokens, _ = attention_greedy_decode(model, state.params, enc_out, enc_lens, 8)
        for ids in tokens_to_ids(tokens):
            hyps_att.append("".join(vocab.ids_to_tokens(ids)))
        refs.extend(b.texts)
    cer_ctc = corpus_cer(hyps_ctc, refs)
    cer_att = corpus_cer(hyps_att, refs)
    assert cer_ctc < 10.0, f"conformer CTC CER {cer_ctc}"
    assert cer_att < 15.0, f"conformer attention CER {cer_att}"
