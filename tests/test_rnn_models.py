"""BiLSTM/LAS model family: shapes, masking, decode-step consistency."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from asr_chinese_e2e.core.registry import available_models, get_model
from asr_chinese_e2e.models.rnn import (
    LAS,
    BiLSTMCTC,
    default_ctc_config,
    default_las_config,
)

VOCAB = 16


def make_batch(b=2, t=7, l=4, input_dim=10, seed=0):
    rng = np.random.RandomState(seed)
    feats = jnp.asarray(rng.randn(b, t, input_dim).astype(np.float32))
    feat_lens = jnp.asarray([t, t - 2][:b])
    labels = jnp.asarray(rng.randint(4, VOCAB, size=(b, l)))
    label_lens = jnp.asarray([l, l - 2][:b])
    labels = labels * (jnp.arange(l)[None, :] < label_lens[:, None])
    return feats, feat_lens, labels, label_lens


def test_bilstm_ctc_shapes_and_masking():
    cfg = default_ctc_config().build(hidden_size=12, input_dim=10, dropout_rate=0.0)
    model = BiLSTMCTC(cfg, VOCAB)
    feats, feat_lens, labels, label_lens = make_batch()
    params = model.init(jax.random.PRNGKey(0), feats, feat_lens, labels, label_lens)
    out = model.apply(params, feats, feat_lens, labels, label_lens)
    assert out["ctc_logits"].shape == (2, 7, VOCAB)
    # padded frames must not affect valid outputs
    feats2 = feats.at[1, 5:].set(50.0)
    out2 = model.apply(params, feats2, feat_lens, labels, label_lens)
    np.testing.assert_allclose(
        np.asarray(out["ctc_logits"])[1, :5],
        np.asarray(out2["ctc_logits"])[1, :5],
        atol=1e-5,
    )


def test_las_forward_and_step_consistency():
    cfg = default_las_config().build(
        hidden_size=16,
        embed_dim=12,
        attention_dim=12,
        input_dim=10,
        num_encoder_layers=1,
        dropout_rate=0.0,
        location_kernel=5,
    )
    model = LAS(cfg, VOCAB)
    feats, feat_lens, labels, label_lens = make_batch()
    params = model.init(jax.random.PRNGKey(0), feats, feat_lens, labels, label_lens)
    out = model.apply(params, feats, feat_lens, labels, label_lens)
    assert out["logits"].shape == (2, 5, VOCAB)
    assert out["ctc_logits"].shape == (2, 7, VOCAB)

    # step path reproduces teacher-forced logits given the same prefix
    enc_out, enc_lens = model.apply(params, feats, feat_lens, method="encode")
    state = model.apply(params, enc_out, enc_lens, method="init_decode_state")
    from asr_chinese_e2e.models.transformer import preprocess_targets

    ys_in, _ = preprocess_targets(labels, label_lens)
    want = np.asarray(jax.nn.log_softmax(out["logits"], axis=-1))
    for i in range(ys_in.shape[1]):
        logp, state = model.apply(params, ys_in[:, i], state, method="decode_step")
        np.testing.assert_allclose(np.asarray(logp), want[:, i], rtol=1e-4, atol=1e-5)


def test_registry_contract():
    names = available_models()
    for required in [
        "SpeechTransformer",
        "TransformerOffical",  # reference alias (main.py:103)
        "BiLSTMCTC",
        "LAS",
        "ExampleModel",
    ]:
        assert required in names
    cls, cfg_fn = get_model("BiLSTMCTC")
    assert cls is BiLSTMCTC and "hidden_size" in cfg_fn()


def test_example_model_runs():
    cls, cfg_fn = get_model("ExampleModel")
    cfg = cfg_fn().build(input_dim=10)
    model = cls(cfg, VOCAB)
    feats, feat_lens, labels, label_lens = make_batch()
    params = model.init(jax.random.PRNGKey(0), feats, feat_lens, labels, label_lens)
    out = model.apply(params, feats, feat_lens, labels, label_lens)
    assert out["logits"].shape == (2, 5, VOCAB)

@pytest.mark.slow
def test_las_scan_matches_unroll():
    """The lifted-scan teacher-forced decoder must produce the same params
    tree and bit-matching logits as the Python-unrolled oracle, and its
    lowered HLO must stay O(1) in target length (the unroll is O(L))."""
    from asr_chinese_e2e.models.rnn import LAS, default_las_config

    def build(unroll):
        cfg = default_las_config().build(
            hidden_size=16, embed_dim=12, attention_dim=12, input_dim=10,
            num_encoder_layers=1, dropout_rate=0.0, location_kernel=5,
            decoder_unroll=unroll,
        )
        return LAS(cfg, VOCAB)

    feats, feat_lens, labels, label_lens = make_batch()
    scan_model, unroll_model = build(False), build(True)
    params = scan_model.init(
        jax.random.PRNGKey(0), feats, feat_lens, labels, label_lens
    )
    # same param structure (checkpoint compatibility between the paths)
    p2 = unroll_model.init(
        jax.random.PRNGKey(0), feats, feat_lens, labels, label_lens
    )
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(p2)

    out_scan = scan_model.apply(params, feats, feat_lens, labels, label_lens)
    out_unroll = unroll_model.apply(params, feats, feat_lens, labels, label_lens)
    np.testing.assert_allclose(
        np.asarray(out_scan["logits"]), np.asarray(out_unroll["logits"]),
        rtol=1e-5, atol=1e-5,
    )

    # HLO-size sanity at L=128: the scan program must be far smaller than
    # the unrolled one (which repeats the step body 128 times)
    labels128 = np.zeros((2, 128), np.int32)
    lens128 = np.full((2,), 128, np.int32)

    def lower(model):
        fn = lambda p, f, fl, lb, ll: model.apply(p, f, fl, lb, ll)["logits"]
        return len(jax.jit(fn).lower(params, feats, feat_lens, labels128, lens128).as_text())

    assert lower(scan_model) * 5 < lower(unroll_model)
