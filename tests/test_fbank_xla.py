"""The XLA log-mel frontend against a float64 NumPy STFT oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from asr_chinese_e2e.data.features import (
    LOG_EPS,
    FeatureConfig,
    log_mel_spectrogram,
    mel_filterbank,
)


def oracle(wave, cfg):
    """Reflect-padded, periodic-Hann framed power spectrum through the mel
    filterbank, log(x + eps) — in float64 with numpy's rFFT."""
    x = np.asarray(wave, np.float64)
    if cfg.center:
        pad = cfg.n_fft // 2
        x = np.pad(x, ((0, 0), (pad, pad)), mode="reflect")
    n = (x.shape[1] - cfg.win_length) // cfg.hop_length + 1
    idx = np.arange(n)[:, None] * cfg.hop_length + np.arange(cfg.win_length)
    window = np.hanning(cfg.win_length + 1)[:-1]
    spec = np.fft.rfft(x[:, idx] * window, n=cfg.n_fft, axis=-1)
    power = np.abs(spec) ** 2
    mel = power @ mel_filterbank(cfg).astype(np.float64)
    return np.log(mel + LOG_EPS)


@pytest.mark.parametrize("n_samples", [16000, 12345, 4000])
def test_xla_fbank_matches_numpy_oracle(n_samples):
    cfg = FeatureConfig(n_mels=80)
    wave = np.random.RandomState(0).randn(2, n_samples).astype(np.float32)
    got = np.asarray(log_mel_spectrogram(jnp.asarray(wave), cfg))
    want = oracle(wave, cfg)
    assert got.shape == want.shape == (2, cfg.num_frames(n_samples), 80)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_xla_fbank_batch_consistency():
    cfg = FeatureConfig(n_mels=40)
    wave = jnp.asarray(np.random.RandomState(1).randn(3, 8000).astype(np.float32))
    full = np.asarray(log_mel_spectrogram(wave, cfg))
    single = np.asarray(log_mel_spectrogram(wave[1:2], cfg))
    np.testing.assert_allclose(full[1], single[0], rtol=1e-5, atol=1e-5)
