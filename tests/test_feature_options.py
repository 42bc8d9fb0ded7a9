"""AudioParser2-style feature options: per-dim CMVN, deltas, banded attn."""

import jax
import jax.numpy as jnp
import numpy as np

from asr_chinese_e2e.data.features import (
    FeatureConfig,
    cmvn_per_dim,
    delta_features,
    parse_batch,
)


def test_cmvn_per_dim_matches_numpy():
    rng = np.random.RandomState(0)
    feats = rng.randn(2, 12, 5).astype(np.float32) * 2 + 3
    lengths = np.array([12, 9])
    feats[1, 9:] = 0
    got = np.asarray(cmvn_per_dim(jnp.asarray(feats), jnp.asarray(lengths)))
    for b, L in enumerate(lengths):
        x = feats[b, :L]
        want = (x - x.mean(axis=0)) / (x.std(axis=0) + 1e-16)
        np.testing.assert_allclose(got[b, :L], want, rtol=1e-4, atol=1e-5)


def test_delta_features_formula():
    # linear ramp -> constant delta (slope), interior points
    t = np.arange(10, dtype=np.float32)
    feats = np.tile(t[None, :, None], (1, 1, 3)) * 2.0  # slope 2
    d = np.asarray(delta_features(jnp.asarray(feats)))
    np.testing.assert_allclose(d[0, 2:-2], 2.0, rtol=1e-5)


def test_parse_batch_with_deltas_dim():
    cfg = FeatureConfig(n_mels=20, use_delta=True, use_delta_delta=True)
    assert cfg.feature_dim == 20 * 3 * 4
    wave = jnp.asarray(np.random.RandomState(0).randn(1, 8000).astype(np.float32))
    feats, lens = parse_batch(wave, jnp.asarray([8000]), cfg)
    assert feats.shape[2] == cfg.feature_dim


def test_banded_attention_restricts_context():
    from asr_chinese_e2e.models.transformer import SpeechTransformer
    from tests.test_transformer import init_model, make_batch, tiny_cfg

    cfg = tiny_cfg(dropout_rate=0.0, ctc_weight=0.3, attention_band=2)
    model, params = init_model(cfg)
    feats, feat_lens, labels, label_lens = make_batch()
    out1 = model.apply(params, feats, feat_lens, labels, label_lens)
    # perturb a frame far outside the band of frame 0 (distance 8 > 2x2 layers=4)
    feats2 = feats.at[0, 8].set(feats[0, 8] + 10.0)
    out2 = model.apply(params, feats2, feat_lens, labels, label_lens)
    # frame 0's encoder output can only see frames within 2 layers * band 2 = 4
    np.testing.assert_allclose(
        np.asarray(out1["enc_out"])[0, 0],
        np.asarray(out2["enc_out"])[0, 0],
        atol=1e-5,
    )
    # but a frame within the band does change
    assert not np.allclose(
        np.asarray(out1["enc_out"])[0, 7], np.asarray(out2["enc_out"])[0, 7]
    )


def test_dct_matrix_matches_scipy():
    """Oracle: the matmul DCT must equal scipy's DCT-II with ortho norm
    (the librosa MFCC convention, processor.py:119-139)."""
    from scipy.fft import dct as scipy_dct

    from asr_chinese_e2e.data.features import dct_matrix

    rng = np.random.RandomState(0)
    x = rng.randn(3, 7, 20).astype(np.float32)
    got = x @ dct_matrix(20, 13)
    want = scipy_dct(x, type=2, norm="ortho", axis=-1)[..., :13]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_parse_batch_mfcc_pipeline():
    """feature_type='mfcc' runs DCT over log-mel before Δ/CMVN/LFR and the
    advertised feature_dim matches the produced shape."""
    from scipy.fft import dct as scipy_dct

    from asr_chinese_e2e.data.features import log_mel_spectrogram

    cfg = FeatureConfig(n_mels=20, feature_type="mfcc", n_mfcc=13)
    assert cfg.feature_dim == 13 * 4
    wave = jnp.asarray(np.random.RandomState(1).randn(2, 8000).astype(np.float32))
    lens = jnp.asarray([8000, 6000])
    feats, out_lens = parse_batch(wave, lens, cfg)
    assert feats.shape[2] == cfg.feature_dim

    # the cepstra entering CMVN must be scipy's MFCC of our log-mel
    logmel = np.asarray(log_mel_spectrogram(wave, cfg))
    want_cep = scipy_dct(logmel, type=2, norm="ortho", axis=-1)[..., :13]
    from asr_chinese_e2e.data.features import cmvn, lfr_stack

    flens = cfg.num_frames(lens)
    want, want_lens = lfr_stack(cmvn(jnp.asarray(want_cep), flens), flens, cfg)
    np.testing.assert_allclose(np.asarray(feats), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(out_lens), np.asarray(want_lens))


def test_feature_config_from_roundtrips_every_knob():
    """Train and decode share ONE cfg->FeatureConfig mapping — dropping a
    knob here (r4 bug: decode rebuilt feat_cfg with only 4 of the fields)
    would decode MFCC / per-dim-CMVN / delta experiments with the wrong
    features."""
    import dataclasses

    from asr_chinese_e2e.core.config import Config
    from asr_chinese_e2e.utils.experiment import feature_config_from

    overrides = dict(
        sample_rate=8000, n_mels=24, lfr_m=3, lfr_n=2,
        feature_type="mfcc", n_mfcc=11, cmvn_mode="fixed",
        cmvn_mean=-7.5, cmvn_std=3.25, use_delta=True,
        use_delta_delta=True,
        freq_mask_param=10, time_mask_param=20, num_freq_masks=2,
        num_time_masks=3, num_time_warps=1, time_warp_param=9,
    )
    got = feature_config_from(Config(**overrides))
    for k, v in overrides.items():
        assert getattr(got, k) == v, k
    # every non-structural FeatureConfig field must be mapped (a new field
    # added without a mapping shows up here)
    mapped = set(overrides) | {"win_length", "hop_length", "f_min", "f_max",
                               "n_fft", "center"}
    missing = {f.name for f in dataclasses.fields(FeatureConfig)} - mapped
    assert not missing, f"feature_config_from does not map: {missing}"
