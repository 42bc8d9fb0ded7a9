"""Feature pipeline vs independent NumPy oracles (SURVEY §4 item 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asr_chinese_e2e.data.features import (
    FeatureConfig,
    cmvn,
    lfr_stack,
    log_mel_spectrogram,
    mel_filterbank,
    parse_batch,
    spec_augment,
)

CFG = FeatureConfig(n_mels=80)


# ---------------------------------------------------------------------------
# NumPy oracles (written independently from first principles)
# ---------------------------------------------------------------------------


def oracle_logmel(wave, cfg):
    """Center-padded STFT via np.fft.rfft + HTK mel + log."""
    pad = cfg.n_fft // 2
    x = np.pad(wave, (pad, pad), mode="reflect")
    n_frames = (len(x) - cfg.win_length) // cfg.hop_length + 1
    window = np.hanning(cfg.win_length + 1)[:-1]
    spec = np.empty((n_frames, cfg.n_fft // 2 + 1))
    for i in range(n_frames):
        fr = x[i * cfg.hop_length : i * cfg.hop_length + cfg.win_length] * window
        spec[i] = np.abs(np.fft.rfft(fr, n=cfg.n_fft)) ** 2
    mel = spec @ mel_filterbank(cfg)
    return np.log(mel + 1e-20)


def oracle_lfr(inputs, m, n):
    """Stack m frames every n; pad tail by repeating the last frame."""
    T = inputs.shape[0]
    out = []
    for i in range(int(np.ceil(T / n))):
        if m <= T - i * n:
            out.append(np.hstack(inputs[i * n : i * n + m]))
        else:
            frame = np.hstack(inputs[i * n :])
            for _ in range(m - (T - i * n)):
                frame = np.hstack((frame, inputs[-1]))
            out.append(frame)
    return np.vstack(out)


# ---------------------------------------------------------------------------


def test_logmel_matches_fft_oracle():
    rng = np.random.RandomState(0)
    wave = rng.randn(16000).astype(np.float32)
    got = np.asarray(log_mel_spectrogram(wave[None], CFG))[0]
    want = oracle_logmel(wave, CFG)
    assert got.shape == want.shape == (16000 // 160 + 1, 80)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_mel_filterbank_properties():
    fb = mel_filterbank(CFG)
    assert fb.shape == (201, 80)
    assert (fb >= 0).all()
    assert (fb.sum(axis=0) > 0).all()  # every mel bin gets energy


@pytest.mark.parametrize("t_valid", [10, 11, 12, 13])
def test_lfr_matches_reference_loop(t_valid):
    rng = np.random.RandomState(1)
    feats = rng.randn(1, t_valid, 8).astype(np.float32)
    got, got_len = lfr_stack(
        jnp.asarray(feats), jnp.asarray([t_valid]), FeatureConfig(n_mels=8)
    )
    want = oracle_lfr(feats[0], 4, 3)
    assert int(got_len[0]) == want.shape[0]
    np.testing.assert_allclose(np.asarray(got)[0, : want.shape[0]], want, rtol=1e-6)


def test_lfr_batched_matches_per_utt():
    rng = np.random.RandomState(2)
    lengths = [17, 23]
    t_max = 23
    feats = rng.randn(2, t_max, 8).astype(np.float32)
    for b, L in enumerate(lengths):
        feats[b, L:] = 0.0
    got, got_len = lfr_stack(
        jnp.asarray(feats), jnp.asarray(lengths), FeatureConfig(n_mels=8)
    )
    for b, L in enumerate(lengths):
        want = oracle_lfr(feats[b, :L], 4, 3)
        assert int(got_len[b]) == want.shape[0]
        np.testing.assert_allclose(
            np.asarray(got)[b, : want.shape[0]], want, rtol=1e-6
        )


def test_cmvn_matches_torch_semantics():
    # global per-utt (x - mean)/std with ddof=1, over valid frames only
    rng = np.random.RandomState(3)
    feats = rng.randn(2, 20, 8).astype(np.float32) * 3 + 1
    lengths = np.array([20, 15])
    feats[1, 15:] = 0.0
    got = np.asarray(cmvn(jnp.asarray(feats), jnp.asarray(lengths)))
    for b, L in enumerate(lengths):
        x = feats[b, :L]
        want = (x - x.mean()) / x.std(ddof=1)
        np.testing.assert_allclose(got[b, :L], want, rtol=1e-4, atol=1e-5)
    assert np.all(got[1, 15:] == 0)  # padding stays zero


def test_spec_augment_shapes_and_fill():
    rng = np.random.RandomState(4)
    feats = rng.randn(2, 50, 80).astype(np.float32)
    lengths = jnp.asarray([50, 40])
    out = spec_augment(jnp.asarray(feats), lengths, jax.random.PRNGKey(0), CFG)
    assert out.shape == feats.shape
    # masked values equal the utterance mean, so out stays within data range
    assert np.isfinite(np.asarray(out)).all()
    # padding region zeroed
    assert np.all(np.asarray(out)[1, 40:] == 0)


def test_spec_mask_draws_are_uniform():
    """The start/width draws must be exactly uniform (round-2 code used
    `randint(0, 1<<30) % hi`, which is modulo-biased)."""
    from asr_chinese_e2e.data.features import _spec_mask

    b, dim, param = 4096, 7, 2  # small dim so chi-square has power
    # param=2 -> cap in {0,1}; with cap=1, width in {0}, so masks are empty —
    # instead check the *start* distribution by reading it off single-column
    # masks with cap forced wide: use param = dim so starts cover the range.
    masks = np.asarray(_spec_mask(jax.random.PRNGKey(7), b, dim, dim))
    # rows with a non-empty mask: first masked column == start
    nz = masks.any(axis=1)
    starts = masks.argmax(axis=1)[nz]
    # chi-square against the exact mixture: cap ~ U{0..dim-1}; a row is
    # non-empty iff width >= 1, with P(width>=1 | cap=c) = (c-1)/c (width ~
    # U[0, max(c,1)) so caps 0 and 1 never mask); start | cap=c ~
    # U{0..dim-c-1}, independent of width. So
    #   P(start=s | nonempty) ∝ sum_{c>=2} ((c-1)/c) / (dim-c) · [s < dim-c]
    probs = np.zeros(dim)
    for c in range(2, dim):
        probs[: dim - c] += ((c - 1) / c) / (dim - c)
    probs /= probs.sum()
    counts = np.bincount(starts, minlength=dim).astype(float)
    expected = probs * counts.sum()
    chi2 = np.sum((counts - expected) ** 2 / np.maximum(expected, 1e-9))
    # dof = dim-1 = 6; 99.9th percentile of chi2(6) ~ 22.5
    assert chi2 < 22.5, (chi2, counts, expected)


def test_parse_batch_end_to_end():
    rng = np.random.RandomState(5)
    lengths = np.array([16000, 12800])
    wave = rng.randn(2, 16000).astype(np.float32)
    wave[1, 12800:] = 0.0
    feats, feat_len = parse_batch(jnp.asarray(wave), jnp.asarray(lengths), CFG)
    assert feats.shape[2] == 320  # n_mels * lfr_m = 80*4 (processor contract)
    t0 = CFG.num_frames(16000)
    assert int(feat_len[0]) == CFG.num_lfr_frames(t0)
    # utterance 0 matches the single-utterance oracle end-to-end
    lm = oracle_logmel(wave[0], CFG)
    normed = (lm - lm.mean()) / lm.std(ddof=1)
    want = oracle_lfr(normed, CFG.lfr_m, CFG.lfr_n)
    np.testing.assert_allclose(
        np.asarray(feats)[0, : want.shape[0]], want, rtol=2e-2, atol=2e-2
    )
