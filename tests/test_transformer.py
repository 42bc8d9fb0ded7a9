"""Transformer model: shapes, target preprocessing, cached-decode parity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asr_chinese_e2e.core.config import Config
from asr_chinese_e2e.data.vocab import BOS_ID, EOS_ID
from asr_chinese_e2e.models.transformer import (
    SpeechTransformer,
    default_config,
    preprocess_targets,
)

VOCAB = 20


def tiny_cfg(**kw):
    cfg = default_config()
    cfg.build(
        d_model=32,
        num_heads=2,
        head_dim=16,
        d_ff=64,
        num_encoder_layers=2,
        num_decoder_layers=2,
        input_dim=12,
        ctc_weight=0.3,
    )
    cfg.build(**kw)
    return cfg


def make_batch(b=2, t=9, l=5, input_dim=12, seed=0):
    rng = np.random.RandomState(seed)
    feats = jnp.asarray(rng.randn(b, t, input_dim).astype(np.float32))
    feat_lens = jnp.asarray([t, t - 3][:b])
    labels = jnp.asarray(rng.randint(4, VOCAB, size=(b, l)))
    label_lens = jnp.asarray([l, l - 2][:b])
    labels = labels * (jnp.arange(l)[None, :] < label_lens[:, None])
    return feats, feat_lens, labels, label_lens


def init_model(cfg):
    model = SpeechTransformer(cfg, VOCAB)
    feats, feat_lens, labels, label_lens = make_batch(input_dim=cfg.input_dim)
    params = model.init(
        jax.random.PRNGKey(0), feats, feat_lens, labels, label_lens
    )
    return model, params


def test_preprocess_targets():
    labels = jnp.asarray([[5, 6, 7, 0], [8, 0, 0, 0]])
    ys_in, ys_out = preprocess_targets(labels, jnp.asarray([3, 1]))
    np.testing.assert_array_equal(
        np.asarray(ys_in), [[BOS_ID, 5, 6, 7, 0], [BOS_ID, 8, 0, 0, 0]]
    )
    np.testing.assert_array_equal(
        np.asarray(ys_out), [[5, 6, 7, EOS_ID, 0], [8, EOS_ID, 0, 0, 0]]
    )


@pytest.mark.parametrize("norm_type", ["post", "pre"])
def test_forward_shapes(norm_type):
    cfg = tiny_cfg(norm_type=norm_type)
    model, params = init_model(cfg)
    feats, feat_lens, labels, label_lens = make_batch()
    out = model.apply(params, feats, feat_lens, labels, label_lens)
    assert out["logits"].shape == (2, 6, VOCAB)  # L+1 positions
    assert out["gold"].shape == (2, 6)
    assert out["ctc_logits"].shape == (2, 9, VOCAB)
    assert np.isfinite(np.asarray(out["logits"])).all()


def test_padding_invariance():
    """Padded tail of the features must not change valid logits."""
    cfg = tiny_cfg(dropout_rate=0.0)
    model, params = init_model(cfg)
    feats, feat_lens, labels, label_lens = make_batch()
    out1 = model.apply(params, feats, feat_lens, labels, label_lens)
    # corrupt the padded region of utt 1 (frames beyond feat_lens[1]=6)
    feats2 = feats.at[1, 6:].set(99.0)
    out2 = model.apply(params, feats2, feat_lens, labels, label_lens)
    np.testing.assert_allclose(
        np.asarray(out1["logits"]), np.asarray(out2["logits"]), atol=1e-5
    )


def test_conv2d_frontend():
    cfg = tiny_cfg(frontend="conv2d", dropout_rate=0.0)
    model, params = init_model(cfg)
    feats, feat_lens, labels, label_lens = make_batch()
    out = model.apply(params, feats, feat_lens, labels, label_lens)
    assert out["enc_out"].shape[1] == 3  # ceil(9/4) subsampled frames
    assert np.asarray(out["enc_lengths"]).tolist() == [3, 2]


def test_cached_decode_matches_full_forward():
    """The KV-cached step path must reproduce the uncached full-prefix
    decoder logits (the reference re-forwards the prefix each step —
    transformer_official.py:359-380; our cache must be exact)."""
    cfg = tiny_cfg(dropout_rate=0.0)
    model, params = init_model(cfg)
    feats, feat_lens, _, _ = make_batch()
    enc_out, enc_lens = model.apply(params, feats, feat_lens, method="encode")

    ys = jnp.asarray([[BOS_ID, 5, 6, 7], [BOS_ID, 8, 9, 10]])
    full_logits = model.apply(
        params, ys, jnp.asarray([4, 4]), enc_out, enc_lens, method="decode_logits"
    )
    want = np.asarray(jax.nn.log_softmax(full_logits, axis=-1))

    state = model.apply(params, enc_out, enc_lens, 8, method="init_decode_state")
    for i in range(4):
        logp, state = model.apply(
            params, ys[:, i], state, jnp.asarray(i), method="decode_step"
        )
        np.testing.assert_allclose(
            np.asarray(logp), want[:, i], rtol=1e-4, atol=1e-5
        )


def test_bfloat16_compute():
    cfg = tiny_cfg(dtype="bfloat16")
    model, params = init_model(cfg)
    feats, feat_lens, labels, label_lens = make_batch()
    out = model.apply(params, feats, feat_lens, labels, label_lens)
    # logits are float32 for the loss; params stay float32
    assert out["logits"].dtype == jnp.float32
    leaf = jax.tree_util.tree_leaves(params)[0]
    assert leaf.dtype == jnp.float32
    assert np.isfinite(np.asarray(out["logits"])).all()


def test_unknown_attn_impl_raises():
    """Removed or misspelt routes fail loudly instead of silently taking
    the XLA path."""
    cfg = tiny_cfg(attn_impl="fused")
    feats, feat_lens, labels, label_lens = make_batch()
    with pytest.raises(ValueError, match="unknown attn_impl"):
        SpeechTransformer(cfg, VOCAB).init(
            jax.random.PRNGKey(0), feats, feat_lens, labels, label_lens
        )


def test_ring_impl_without_seq_axis_matches_xla():
    """attn_impl='ring' with no ``seq`` mesh axis takes the plain masked
    path: logits equal the XLA route's exactly."""
    cfg_x = tiny_cfg(dropout_rate=0.0, attn_impl="xla")
    cfg_r = tiny_cfg(dropout_rate=0.0, attn_impl="ring")
    feats, feat_lens, labels, label_lens = make_batch()
    params = SpeechTransformer(cfg_x, VOCAB).init(
        jax.random.PRNGKey(0), feats, feat_lens, labels, label_lens
    )
    out_x = SpeechTransformer(cfg_x, VOCAB).apply(params, feats, feat_lens, labels, label_lens)
    out_r = SpeechTransformer(cfg_r, VOCAB).apply(params, feats, feat_lens, labels, label_lens)
    np.testing.assert_array_equal(np.asarray(out_x["logits"]), np.asarray(out_r["logits"]))


def test_deepnorm_knob():
    """DeepNorm stabilizer (round-4 VERDICT #1): coeffs follow the DeepNet
    encoder-decoder prescription, v/out/FFN inits are scaled down, and the
    forward stays finite; pre-LN configs ignore the knob entirely."""
    from asr_chinese_e2e.models.transformer import deepnorm_coeffs

    cfg = tiny_cfg(norm_type="post", deepnorm=True)
    (ea, eb), (da, db) = deepnorm_coeffs(cfg)
    n, m = cfg.num_encoder_layers, cfg.num_decoder_layers
    assert ea == pytest.approx(0.81 * (n**4 * m) ** (1 / 16))
    assert da == pytest.approx((3 * m) ** 0.25)
    assert eb < 1.0 < ea and db < 1.0 < da
    # pre-LN: no-op
    assert deepnorm_coeffs(tiny_cfg(norm_type="pre", deepnorm=True)) == (
        (1.0, 1.0),
        (1.0, 1.0),
    )

    model = SpeechTransformer(cfg, VOCAB)
    feats, feat_lens, labels, label_lens = make_batch()
    params = model.init(jax.random.PRNGKey(0), feats, feat_lens, labels, label_lens)
    out = model.apply(params, feats, feat_lens, labels, label_lens)
    assert np.isfinite(np.asarray(out["logits"])).all()

    # beta actually shrinks the value-projection init vs the stock model
    stock = SpeechTransformer(tiny_cfg(norm_type="post"), VOCAB)
    sp = stock.init(jax.random.PRNGKey(0), feats, feat_lens, labels, label_lens)
    v_deep = np.asarray(
        params["params"]["encoder"]["layer0"]["attn"]["v"]["kernel"]
    )
    v_stock = np.asarray(
        sp["params"]["encoder"]["layer0"]["attn"]["v"]["kernel"]
    )
    assert v_deep.std() < 0.75 * v_stock.std()

    # and the residual alpha changes the forward (vs deepnorm init alone)
    plain = SpeechTransformer(tiny_cfg(norm_type="post"), VOCAB)
    out2 = plain.apply(params, feats, feat_lens, labels, label_lens)
    assert not np.allclose(
        np.asarray(out["logits"]), np.asarray(out2["logits"])
    )


def test_hash_dropout():
    """dropout_impl='hash' (VERDICT r4 #5): mask statistics ~ rate, scaling
    by 1/keep, deterministic under a fixed rng, identity at eval."""
    from asr_chinese_e2e.models.layers import ConfigurableDropout

    x = jnp.ones((64, 128), jnp.float32)
    drop = ConfigurableDropout(0.3, "hash")
    v = drop.init({"dropout": jax.random.PRNGKey(0)}, x, False)
    out = drop.apply(v, x, False, rngs={"dropout": jax.random.PRNGKey(1)})
    arr = np.asarray(out)
    kept = arr > 0
    assert abs(kept.mean() - 0.7) < 0.03
    np.testing.assert_allclose(arr[kept], 1.0 / 0.7, rtol=1e-6)
    out2 = drop.apply(v, x, False, rngs={"dropout": jax.random.PRNGKey(1)})
    np.testing.assert_array_equal(arr, np.asarray(out2))
    out3 = drop.apply(v, x, False, rngs={"dropout": jax.random.PRNGKey(2)})
    assert not np.array_equal(arr, np.asarray(out3))
    np.testing.assert_array_equal(np.asarray(drop.apply(v, x, True)), np.asarray(x))


def test_hash_dropout_model_trains_step():
    """A full train step with dropout_impl='hash' stays finite and the
    dropout actually perturbs the loss (mask active in training mode)."""
    cfg = tiny_cfg(dropout_rate=0.2, dropout_impl="hash")
    model = SpeechTransformer(cfg, VOCAB)
    feats, feat_lens, labels, label_lens = make_batch()
    params = model.init(jax.random.PRNGKey(0), feats, feat_lens, labels, label_lens)

    def loss_fn(p, rng):
        out = model.apply(
            p, feats, feat_lens, labels, label_lens, False,
            rngs={"dropout": rng},
        )
        return (out["logits"] ** 2).mean()

    l1 = float(loss_fn(params, jax.random.PRNGKey(1)))
    l2 = float(loss_fn(params, jax.random.PRNGKey(2)))
    assert np.isfinite(l1) and np.isfinite(l2) and l1 != l2
    g = jax.grad(loss_fn)(params, jax.random.PRNGKey(1))
    assert all(
        np.isfinite(np.asarray(x)).all() for x in jax.tree_util.tree_leaves(g)
    )
