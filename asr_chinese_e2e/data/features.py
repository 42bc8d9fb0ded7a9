"""On-device feature pipeline: log-mel fbank → per-utterance CMVN →
SpecAugment → LFR frame stacking.

Functional parity with ``Predictor/data_handler/processor.py:17-100`` and
``Predictor/data_handler/augments.py:4-42``, re-designed for the device:

- the reference computes features per-utterance on the host with torchaudio
  (``processor.py:33-40``); here the whole pipeline is batched jnp running
  under jit on device, with the STFT expressed as two windowed-DFT matmuls so
  it lands on the tensor cores instead of an FFT;
- CMVN is the reference's *global* per-utterance ``(x - mean()) / std()``
  (``processor.py:42-46``, torch ``std`` ⇒ ddof=1), computed over valid
  frames only via the length mask;
- LFR stacks m=4 frames every n=3, padding the tail by repeating the last
  valid frame (``processor.py:74-100``) — implemented as a clipped gather,
  bit-exact vs the reference's loop;
- SpecAugment follows ``augments.py:4-42``: one freq mask (F=30) and one
  time mask (T=40), filled with the utterance mean (not zero), two-stage
  width draw (width ~ U[0, f) with f ~ U[0, F)).

All shapes are static; variable length is carried in ``lengths`` arrays
(frames) so XLA compiles one program per bucket shape.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

LOG_EPS = 1e-20  # processor.py:38


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Defaults follow the reference training setup (``data_config.py:12-17``,
    ``processor.py:19-27``)."""

    sample_rate: int = 16000
    n_mels: int = 80
    win_length: int = 400
    hop_length: int = 160
    f_min: float = 40.0
    f_max: float | None = None  # None -> sample_rate / 2
    n_fft: int = 400
    center: bool = True
    lfr_m: int = 4
    lfr_n: int = 3
    # SpecAugment (augments.py:4-42)
    freq_mask_param: int = 30
    time_mask_param: int = 40
    num_freq_masks: int = 1
    num_time_masks: int = 1
    # time-warp (augments.py:54-396 — dead code in the reference, OFF by
    # default there too; jnp polyharmonic sparse_image_warp, data/timewarp.py)
    num_time_warps: int = 0
    time_warp_param: int = 5
    # AudioParser2-style options (processor.py:106-152)
    # "global" (AudioParser) | "per_dim" (AudioParser2) | "fixed"
    # (corpus-level stats — pointwise per frame, hence causal: the mode the
    # streaming recognizer's incremental path requires, since per-utterance
    # stats would retroactively change already-encoded frames)
    cmvn_mode: str = "global"
    cmvn_mean: float = 0.0  # "fixed" mode stats
    cmvn_std: float = 1.0
    use_delta: bool = False  # append Δ features
    use_delta_delta: bool = False  # append ΔΔ features
    # AudioParser2's feature_type knob (processor.py:119-139): "mfcc" takes
    # an orthonormal DCT-II over the log-mel bands (librosa convention),
    # keeping the first n_mfcc coefficients
    feature_type: str = "fbank"  # "fbank" | "mfcc"
    n_mfcc: int = 40

    @property
    def base_dim(self) -> int:
        """Per-frame dim before Δ stacking and LFR."""
        return self.n_mfcc if self.feature_type == "mfcc" else self.n_mels

    @property
    def feature_dim(self) -> int:
        mult = 1 + int(self.use_delta) + int(self.use_delta_delta)
        return self.base_dim * mult * self.lfr_m

    def num_frames(self, num_samples) -> "int | jnp.ndarray":
        """STFT frame count for a waveform of ``num_samples`` samples."""
        if self.center:
            return num_samples // self.hop_length + 1
        return (num_samples - self.win_length) // self.hop_length + 1

    def num_lfr_frames(self, num_frames):
        """ceil(T / n) (``processor.py:90``)."""
        return -(-num_frames // self.lfr_n)


# ---------------------------------------------------------------------------
# Mel filterbank (HTK scale, torchaudio-style: triangular, unnormalised)
# ---------------------------------------------------------------------------


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(cfg: FeatureConfig) -> np.ndarray:
    """(n_freqs, n_mels) triangular mel filterbank, HTK scale."""
    f_max = cfg.f_max if cfg.f_max is not None else cfg.sample_rate / 2.0
    n_freqs = cfg.n_fft // 2 + 1
    all_freqs = np.linspace(0, cfg.sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(hz_to_mel(cfg.f_min), hz_to_mel(f_max), cfg.n_mels + 2)
    f_pts = mel_to_hz(mel_pts)  # (n_mels + 2,)
    f_diff = f_pts[1:] - f_pts[:-1]  # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


def dct_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) orthonormal DCT-II basis (scipy ``dct(type=2,
    norm='ortho')`` convention): y[k] = Σ_n x[n]·s_k·cos(π(n+½)k/N).

    Applied as a matmul over the mel axis — the matmul form of the
    reference's librosa MFCC (``processor.py:119-139``)."""
    n = np.arange(n_in)[:, None]
    k = np.arange(n_out)[None, :]
    basis = np.cos(np.pi * (n + 0.5) * k / n_in)
    scale = np.full((1, n_out), np.sqrt(2.0 / n_in))
    scale[0, 0] = np.sqrt(1.0 / n_in)
    return (basis * scale).astype(np.float32)


def dft_basis(cfg: FeatureConfig) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT bases: (win, n_freqs) cos and -sin matrices.

    frames @ cos_b -> real part, frames @ sin_b -> imag part of the rFFT of
    the hann-windowed frame. Two (win x n_freqs) matmuls per frame block —
    this is the matmul formulation of the STFT.
    """
    n_freqs = cfg.n_fft // 2 + 1
    window = np.hanning(cfg.win_length + 1)[:-1]  # periodic hann (torch default)
    k = np.arange(n_freqs)[None, :]
    t = np.arange(cfg.win_length)[:, None]
    ang = 2.0 * np.pi * t * k / cfg.n_fft
    cos_b = (window[:, None] * np.cos(ang)).astype(np.float32)
    sin_b = (-window[:, None] * np.sin(ang)).astype(np.float32)
    return cos_b, sin_b


# ---------------------------------------------------------------------------
# Core pipeline stages (batched jnp; all jit-safe, static shapes)
# ---------------------------------------------------------------------------


def frame_signal(wave: jnp.ndarray, cfg: FeatureConfig) -> jnp.ndarray:
    """(B, S) -> (B, T, win) overlapping frames.

    With ``center=True``, reflect-pads win//2 each side (torch.stft
    semantics) before slicing.
    """
    if cfg.center:
        pad = cfg.n_fft // 2
        wave = jnp.pad(wave, ((0, 0), (pad, pad)), mode="reflect")
    n_frames = (wave.shape[1] - cfg.win_length) // cfg.hop_length + 1
    idx = (
        np.arange(n_frames)[:, None] * cfg.hop_length + np.arange(cfg.win_length)
    )  # (T, win)
    return wave[:, idx]


def logmel_from_frames(frames: jnp.ndarray, cfg: FeatureConfig) -> jnp.ndarray:
    """(B, T, win) pre-framed audio -> (B, T, n_mels) log-mel.

    The framing-independent half of ``log_mel_spectrogram`` — the streaming
    chunk path frames its own already-padded sample slices (stream.py)."""
    cos_b, sin_b = dft_basis(cfg)
    re = jnp.einsum("btw,wf->btf", frames, jnp.asarray(cos_b))
    im = jnp.einsum("btw,wf->btf", frames, jnp.asarray(sin_b))
    power = re * re + im * im  # (B, T, n_freqs)
    mel = jnp.einsum("btf,fm->btm", power, jnp.asarray(mel_filterbank(cfg)))
    return jnp.log(mel + LOG_EPS)


def log_mel_spectrogram(wave: jnp.ndarray, cfg: FeatureConfig) -> jnp.ndarray:
    """(B, S) float32 -> (B, T, n_mels) log-mel features.

    power spectrum (power=2) -> mel -> log(x + 1e-20) (``processor.py:33-40``).
    """
    return logmel_from_frames(frame_signal(wave, cfg), cfg)


def cmvn(
    feats: jnp.ndarray, feat_lengths: jnp.ndarray, eps: float = 0.0
) -> jnp.ndarray:
    """Per-utterance global CMVN over valid frames (``processor.py:42-46``).

    torch ``Tensor.std()`` is the sample std (ddof=1); matched here.
    feats: (B, T, D), feat_lengths: (B,) valid frame counts.
    """
    mask = (jnp.arange(feats.shape[1])[None, :] < feat_lengths[:, None]).astype(
        feats.dtype
    )[..., None]
    n = feat_lengths.astype(feats.dtype)[:, None, None] * feats.shape[2]
    mean = jnp.sum(feats * mask, axis=(1, 2), keepdims=True) / n
    var = jnp.sum(jnp.square(feats - mean) * mask, axis=(1, 2), keepdims=True) / (
        n - 1.0
    )
    out = (feats - mean) / (jnp.sqrt(var) + eps)
    return out * mask


def cmvn_per_dim(
    feats: jnp.ndarray, feat_lengths: jnp.ndarray, eps: float = 1e-16
) -> jnp.ndarray:
    """Per-feature-dim CMVN over time (AudioParser2, ``processor.py:142``:
    ``(feat - mean(axis=time)) / (std(axis=time) + 1e-16)``, population
    std), masked to valid frames."""
    mask = (jnp.arange(feats.shape[1])[None, :] < feat_lengths[:, None]).astype(
        feats.dtype
    )[..., None]
    n = jnp.maximum(feat_lengths.astype(feats.dtype), 1.0)[:, None, None]
    mean = jnp.sum(feats * mask, axis=1, keepdims=True) / n
    var = jnp.sum(jnp.square(feats - mean) * mask, axis=1, keepdims=True) / n
    out = (feats - mean) / (jnp.sqrt(var) + eps)
    return out * mask


def delta_features(feats: jnp.ndarray, order_n: int = 2) -> jnp.ndarray:
    """HTK/Kaldi-style delta: d_t = Σ_n n·(x[t+n]-x[t-n]) / (2·Σ n²),
    edge-replicated (the AudioParser2 Δ/ΔΔ option, ``processor.py:135-139``)."""
    denom = 2.0 * sum(n * n for n in range(1, order_n + 1))
    t = feats.shape[1]
    out = jnp.zeros_like(feats)
    for n in range(1, order_n + 1):
        idx = jnp.arange(t)
        fwd = feats[:, jnp.minimum(idx + n, t - 1)]
        bwd = feats[:, jnp.maximum(idx - n, 0)]
        out = out + n * (fwd - bwd)
    return out / denom


def _spec_mask(key, b: int, dim: int, param: int, lengths=None):
    """One batch of SpecAugment masks via the reference's two-stage draw:
    width_cap ~ U[0, P), start ~ U[0, dim - width_cap), width ~ U[0,
    width_cap). Per-row bounded ``jax.random.randint`` draws (array bounds
    broadcast) — exactly uniform, unlike the former ``randint(0, 1<<30) %
    hi`` which was modulo-biased. Returns (B, dim) bool."""
    k1, k2, k3 = jax.random.split(key, 3)
    cap = jax.random.randint(k1, (b,), 0, param)
    max_dim = lengths if lengths is not None else jnp.full((b,), dim)
    hi = jnp.maximum(max_dim - cap, 1)
    start = jax.random.randint(k2, (b,), 0, hi)
    width = jax.random.randint(k3, (b,), 0, jnp.maximum(cap, 1))
    width = jnp.where(cap == 0, 0, width)
    pos = jnp.arange(dim)[None, :]
    return (pos >= start[:, None]) & (pos < (start + width)[:, None])


def spec_augment(
    feats: jnp.ndarray,
    feat_lengths: jnp.ndarray,
    rng: jax.Array,
    cfg: FeatureConfig,
) -> jnp.ndarray:
    """SpecAugment masks filled with the utterance mean (``augments.py:4-42``).

    Matches the reference's two-stage draw (see ``_spec_mask``). One freq and
    one time mask by default. Batched: independent masks per utterance.
    """
    b, t, d = feats.shape
    if cfg.num_time_warps > 0:
        from .timewarp import time_warp

        rng, wkey = jax.random.split(rng)
        for _ in range(cfg.num_time_warps):
            wkey, sub = jax.random.split(wkey)
            feats = time_warp(feats, feat_lengths, sub, cfg.time_warp_param)
    valid = (jnp.arange(t)[None, :] < feat_lengths[:, None]).astype(feats.dtype)
    n_valid = jnp.maximum(feat_lengths.astype(feats.dtype) * d, 1.0)
    fill = jnp.sum(feats * valid[..., None], axis=(1, 2)) / n_valid  # (B,)

    keys = jax.random.split(rng, cfg.num_freq_masks + cfg.num_time_masks)
    masked = feats
    for i in range(cfg.num_freq_masks):
        fm = _spec_mask(keys[i], b, d, cfg.freq_mask_param)  # (B, D)
        masked = jnp.where(fm[:, None, :], fill[:, None, None], masked)
    for i in range(cfg.num_time_masks):
        tm = _spec_mask(
            keys[cfg.num_freq_masks + i], b, t, cfg.time_mask_param, feat_lengths
        )  # (B, T)
        masked = jnp.where(tm[:, :, None], fill[:, None, None], masked)
    return masked * valid[..., None]


def lfr_stack(
    feats: jnp.ndarray, feat_lengths: jnp.ndarray, cfg: FeatureConfig
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Low-frame-rate stacking: stack m frames every n
    (``processor.py:74-100``), padding the tail by repeating the LAST valid
    frame — implemented as a clipped gather (bit-exact vs the reference loop).

    (B, T, D) -> (B, ceil(T/n), m*D); returns new lengths ceil(len/n).
    """
    b, t, d = feats.shape
    m, n = cfg.lfr_m, cfg.lfr_n
    t_lfr = -(-t // n)
    idx = np.arange(t_lfr)[:, None] * n + np.arange(m)[None, :]  # (T_lfr, m)
    idx = jnp.minimum(jnp.asarray(idx)[None], feat_lengths[:, None, None] - 1)
    stacked = feats[jnp.arange(b)[:, None, None], idx]  # (B, T_lfr, m, D)
    stacked = stacked.reshape(b, t_lfr, m * d)
    out_lengths = -(-feat_lengths // n)
    mask = (jnp.arange(t_lfr)[None, :] < out_lengths[:, None]).astype(feats.dtype)
    return stacked * mask[..., None], out_lengths


# ---------------------------------------------------------------------------
# Full parse (the device-side analogue of AudioParser.parse, processor.py:61-71)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("cfg", "augment"))
def parse_batch(
    wave: jnp.ndarray,
    wave_lengths: jnp.ndarray,
    cfg: FeatureConfig,
    augment: bool = False,
    rng: jax.Array | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(B, S) waveforms + sample lengths -> (B, T_lfr, feature_dim) features
    + frame lengths. Pipeline: fbank → log → [Δ/ΔΔ] → CMVN → [SpecAugment]
    → LFR.

    Integer waveforms (the int16 wire format — half the host->device
    bytes) are scaled to [-1, 1) here on device, bit-exact vs a host-side
    ``x / 32768`` for mono PCM16."""
    if jnp.issubdtype(wave.dtype, jnp.integer):
        wave = wave.astype(jnp.float32) * (1.0 / 32768.0)
    feats = log_mel_spectrogram(wave, cfg)
    feat_lengths = cfg.num_frames(wave_lengths)
    if cfg.feature_type == "mfcc":
        # AudioParser2 feature_type='mfcc' (processor.py:119-139): DCT-II
        # over the log-mel bands; Δ/CMVN/SpecAugment then act on cepstra
        feats = feats @ jnp.asarray(dct_matrix(cfg.n_mels, cfg.n_mfcc))
    if cfg.use_delta or cfg.use_delta_delta:
        parts = [feats]
        d1 = delta_features(feats)
        if cfg.use_delta:
            parts.append(d1)
        if cfg.use_delta_delta:
            parts.append(delta_features(d1))
        feats = jnp.concatenate(parts, axis=-1)
    if cfg.cmvn_mode == "per_dim":
        feats = cmvn_per_dim(feats, feat_lengths)
    elif cfg.cmvn_mode == "fixed":
        mask = (
            jnp.arange(feats.shape[1])[None, :] < feat_lengths[:, None]
        ).astype(feats.dtype)[..., None]
        feats = ((feats - cfg.cmvn_mean) / cfg.cmvn_std) * mask
    else:
        feats = cmvn(feats, feat_lengths)
    if augment:
        if rng is None:
            raise ValueError("augment=True requires rng")
        feats = spec_augment(feats, feat_lengths, rng, cfg)
    return lfr_stack(feats, feat_lengths, cfg)
