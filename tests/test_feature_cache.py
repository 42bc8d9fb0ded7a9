"""Feature predump cache: dump -> cached loader -> training parity."""

import os

import numpy as np

import preprocess
from asr_chinese_e2e.data.batching import BucketedLoader
from asr_chinese_e2e.data.features import FeatureConfig

from tests.test_batching import setup_data


def test_feature_predump_and_cached_loader(tmp_path):
    mpath, vocab = setup_data(tmp_path, n_short=6, n_long=0)
    out = str(tmp_path / "feats")
    preprocess.features(mpath, out, n_mels=20, batch_size=4)
    cached_manifest = os.path.join(out, "manifest.jsonl")
    assert os.path.exists(cached_manifest)

    feat_cfg = FeatureConfig(n_mels=20)
    loader = BucketedLoader(
        cached_manifest, vocab, batch_size=2, max_target_len=8,
        feat_cfg=feat_cfg, prefetch=0,
    )
    assert loader.cached_features
    batches = list(loader.epoch(0))
    assert len(batches) == 3
    b = batches[0]
    # features, not waveforms: (B, T_frames, D)
    assert b.wave.ndim == 3 and b.wave.shape[2] == feat_cfg.feature_dim
    # 1 s wav -> 101 frames -> ceil(101/3) = 34 LFR frames <= boundary
    assert (b.wave_lengths == 34).all()
    assert b.wave.shape[1] == loader.boundaries[0]

    # cached features equal on-the-fly features
    import jax.numpy as jnp

    from asr_chinese_e2e.data.batching import load_wav
    from asr_chinese_e2e.data.features import parse_batch
    from asr_chinese_e2e.data.manifest import read_manifest

    rec = read_manifest(cached_manifest)[0]
    wave = load_wav(rec["wave"])
    feats, lens = parse_batch(
        jnp.asarray(wave[None]), jnp.asarray([len(wave)]), feat_cfg
    )
    cached = np.load(rec["feature"])
    np.testing.assert_allclose(
        cached, np.asarray(feats)[0, : int(lens[0])], rtol=1e-5, atol=1e-6
    )
