"""Native C++ wav IO vs the Python reader (bit-exactness, threading)."""

import numpy as np
import pytest

from asr_chinese_e2e.data import native
from asr_chinese_e2e.data.batching import BucketedLoader, load_wav

from tests.test_batching import setup_data
from tests.test_manifest import write_wav

needs_native = pytest.mark.skipif(
    not native.available(), reason="no C++ toolchain"
)


@needs_native
def test_single_read_matches_python(tmp_path):
    p = str(tmp_path / "x.wav")
    write_wav(p, n_samples=12345)
    want = load_wav(p)
    got = native.read_wav(p, 20000)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@needs_native
def test_batch_read_matches_and_pads(tmp_path):
    paths = []
    for i, n in enumerate([1000, 2500, 400]):
        p = str(tmp_path / f"b{i}.wav")
        write_wav(p, n_samples=n)
        paths.append(p)
    batch, lengths = native.read_wav_batch(paths, stride=3000, num_threads=4)
    assert batch.shape == (3, 3000)
    assert lengths.tolist() == [1000, 2500, 400]
    for i, p in enumerate(paths):
        want = load_wav(p)
        np.testing.assert_array_equal(batch[i, : lengths[i]], want)
        assert np.all(batch[i, lengths[i] :] == 0)


@needs_native
def test_truncation_at_stride(tmp_path):
    p = str(tmp_path / "long.wav")
    write_wav(p, n_samples=5000)
    batch, lengths = native.read_wav_batch([p], stride=2000)
    assert lengths[0] == 2000
    np.testing.assert_array_equal(batch[0], load_wav(p)[:2000])


@needs_native
def test_loader_native_path_matches_python_path(tmp_path):
    mpath, vocab = setup_data(tmp_path)
    a = BucketedLoader(
        mpath, vocab, batch_size=4, max_target_len=8, use_native_io=True,
        prefetch=0,
    )
    b = BucketedLoader(
        mpath, vocab, batch_size=4, max_target_len=8, use_native_io=False,
        prefetch=0,
    )
    assert a._native is not None
    for ba, bb in zip(a.epoch(0), b.epoch(0)):
        np.testing.assert_array_equal(ba.wave, bb.wave)
        np.testing.assert_array_equal(ba.wave_lengths, bb.wave_lengths)
        np.testing.assert_array_equal(ba.labels, bb.labels)


@needs_native
def test_prefetch_stream_equivalent(tmp_path):
    mpath, vocab = setup_data(tmp_path)
    a = BucketedLoader(mpath, vocab, batch_size=2, max_target_len=8, prefetch=2)
    b = BucketedLoader(mpath, vocab, batch_size=2, max_target_len=8, prefetch=0)
    la, lb = list(a.epoch(1)), list(b.epoch(1))
    assert len(la) == len(lb)
    for ba, bb in zip(la, lb):
        np.testing.assert_array_equal(ba.wave, bb.wave)
        assert ba.texts == bb.texts


def test_bad_wav_raises(tmp_path):
    if not native.available():
        pytest.skip("no C++ toolchain")
    p = str(tmp_path / "junk.wav")
    with open(p, "wb") as f:
        f.write(b"not a wav file at all")
    with pytest.raises(IOError):
        native.read_wav_batch([p], stride=100)


@needs_native
def test_int16_wire_matches_float_path(tmp_path):
    """int16 wire format: raw PCM16 rows; device-side /32768 must be
    bit-exact vs the float32 path for mono audio."""
    import jax.numpy as jnp

    from asr_chinese_e2e.data.features import FeatureConfig, parse_batch

    mpath, vocab = setup_data(tmp_path)
    f = BucketedLoader(
        mpath, vocab, batch_size=4, max_target_len=8, prefetch=0,
        wire_dtype="float32",
    )
    i = BucketedLoader(
        mpath, vocab, batch_size=4, max_target_len=8, prefetch=0,
        wire_dtype="int16",
    )
    cfg = FeatureConfig(n_mels=20)
    for bf, bi in zip(f.epoch(0), i.epoch(0)):
        assert bi.wave.dtype == np.int16
        np.testing.assert_array_equal(
            bi.wave.astype(np.float32) / 32768.0, bf.wave
        )
        ff, lf = parse_batch(jnp.asarray(bf.wave), jnp.asarray(bf.wave_lengths), cfg)
        fi, li = parse_batch(jnp.asarray(bi.wave), jnp.asarray(bi.wave_lengths), cfg)
        np.testing.assert_array_equal(np.asarray(ff), np.asarray(fi))
        np.testing.assert_array_equal(np.asarray(lf), np.asarray(li))


@needs_native
def test_int16_python_fallback_matches_native(tmp_path):
    mpath, vocab = setup_data(tmp_path)
    a = BucketedLoader(
        mpath, vocab, batch_size=4, max_target_len=8, prefetch=0,
        wire_dtype="int16", use_native_io=True,
    )
    b = BucketedLoader(
        mpath, vocab, batch_size=4, max_target_len=8, prefetch=0,
        wire_dtype="int16", use_native_io=False,
    )
    assert a._native is not None
    for ba, bb in zip(a.epoch(0), b.epoch(0)):
        assert ba.wave.dtype == bb.wave.dtype == np.int16
        np.testing.assert_array_equal(ba.wave, bb.wave)
        np.testing.assert_array_equal(ba.wave_lengths, bb.wave_lengths)
