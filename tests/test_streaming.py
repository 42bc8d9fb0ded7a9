"""Streaming recognition: energy gate segmentation + incremental decode.

The gate reproduces ``Predictor/recorder.py:7-73``'s LEVEL/COUNT_NUM/
SAVE_LENGTH semantics over chunked int16 PCM; the recognizer's finals must
match the offline decode of the same segment audio (same compiled
pipeline, so this is an exact-equivalence test, no training needed).
"""

import numpy as np
import pytest

from asr_chinese_e2e.data.features import FeatureConfig
from asr_chinese_e2e.data.vocab import Vocab
from asr_chinese_e2e.models.transformer import SpeechTransformer
from asr_chinese_e2e.stream import EnergyGate, Event, StreamingRecognizer

from tests.test_transformer import tiny_cfg

SR = 16000


def tone(seconds, freq=440.0, amp=0.5):
    t = np.arange(int(SR * seconds)) / SR
    return (np.sin(2 * np.pi * freq * t) * amp * 32767).astype(np.int16)


def silence(seconds):
    return np.zeros((int(SR * seconds),), np.int16)


def feed_chunked(gate_or_rec, x, chunk=1600):
    out = []
    for i in range(0, len(x), chunk):
        out.extend(gate_or_rec.feed(x[i : i + chunk]))
    out.extend(gate_or_rec.finish())
    return out


def test_energy_gate_segments_speech_runs():
    x = np.concatenate(
        [silence(0.5), tone(0.8), silence(2.0), tone(1.2), silence(1.5)]
    )
    segs = feed_chunked(EnergyGate(), x)
    assert len(segs) == 2
    (s0, a0), (s1, a1) = segs
    # segment bounds cover the tones (pre-roll + hangover padding allowed:
    # 1 chunk before, save_length=8 chunks ≈ 1 s after)
    assert s0 / SR <= 0.5 and (s0 + len(a0)) / SR >= 1.3
    assert s1 / SR <= 3.3 and (s1 + len(a1)) / SR >= 4.5
    assert len(a0) < len(a1)


def test_energy_gate_ignores_subthreshold_noise():
    rng = np.random.RandomState(0)
    x = (rng.randn(SR * 2) * 100).astype(np.int16)  # well under level=500
    assert feed_chunked(EnergyGate(), x) == []


def test_energy_gate_splits_at_max_segment():
    x = tone(4.0)
    segs = feed_chunked(EnergyGate(max_segment_samples=SR), x)
    assert len(segs) >= 3
    assert all(len(a) <= SR + 2000 for _, a in segs)


@pytest.fixture(scope="module")
def tiny_recognizer():
    import jax

    vocab = Vocab()
    vocab.consume_sentence("".join(chr(0x4E00 + i) for i in range(8)))
    vocab.build()
    feat_cfg = FeatureConfig(n_mels=20)
    cfg = tiny_cfg(dropout_rate=0.0, ctc_weight=0.3)
    cfg.build(input_dim=feat_cfg.feature_dim)
    model = SpeechTransformer(cfg, vocab.vocab_size)
    wave = np.zeros((1, SR), np.float32)
    from asr_chinese_e2e.data.features import parse_batch

    feats, feat_lens = parse_batch(wave, np.asarray([SR], np.int32), feat_cfg)
    params = model.init(
        jax.random.PRNGKey(0), feats, feat_lens,
        np.zeros((1, 4), np.int32), np.asarray([1], np.int32),
    )
    return model, params, vocab, feat_cfg


@pytest.mark.parametrize("mode", ["ctc_greedy", "joint"])
def test_streaming_finals_match_offline(tiny_recognizer, mode):
    model, params, vocab, feat_cfg = tiny_recognizer
    rec = StreamingRecognizer(
        model, params, vocab, feat_cfg, mode=mode,
        bucket_seconds=(1.0, 2.0), partial_every_s=0.4, beam_size=3,
        max_len=8,
    )
    x = np.concatenate(
        [silence(0.4), tone(0.9, 523.0), silence(1.6), tone(0.6, 880.0),
         silence(1.2)]
    )
    events = feed_chunked(rec, x)
    finals = [e for e in events if e.kind == "final"]
    partials = [e for e in events if e.kind == "partial"]
    assert len(finals) == 2
    assert partials, "expected partial hypotheses at 0.4 s cadence"
    assert all(isinstance(e, Event) for e in events)
    # offline equivalence: decode the exact gated segments through the
    # same pipeline
    segs = feed_chunked(
        EnergyGate(max_segment_samples=rec.buckets[-1]), x
    )
    assert len(segs) == 2
    for (start, seg), ev in zip(segs, finals):
        assert rec._final_text(seg) == ev.text
        assert abs(ev.t0 - start / SR) < 1e-6
    # partials precede their segment's final and stay within its bounds
    assert partials[0].t1 <= finals[0].t1 + 1e-6


def test_wav_chunks_roundtrip(tmp_path):
    from asr_chinese_e2e.stream import wav_chunks
    from asr_chinese_e2e.utils.synth import write_wav16

    x = tone(0.5, amp=0.3)
    p = str(tmp_path / "t.wav")
    write_wav16(p, x.astype(np.float32) / 32767)
    got = np.concatenate(list(wav_chunks(p, 1000)))
    assert got.dtype == np.int16 and len(got) == len(x)
    np.testing.assert_allclose(got, x, atol=2)


def test_reset_stream_isolates_streams(tiny_recognizer):
    """reset_stream: a reused recognizer must give the SAME result for a
    segment whether or not a previous (unrelated) stream went through it —
    without reset, the gate's pre-roll leaks the previous stream's tail
    into the next segment."""
    import numpy as np

    from asr_chinese_e2e.stream import StreamingRecognizer

    model, params, vocab, feat_cfg = tiny_recognizer
    sr = feat_cfg.sample_rate
    tt = np.arange(int(0.8 * sr)) / sr
    seg = (np.sin(2 * np.pi * 523.0 * tt) * 12000).astype(np.int16)
    other = (np.sin(2 * np.pi * 880.0 * tt) * 12000).astype(np.int16)

    def run_fresh(r, x):
        finals = []
        for i in range(0, len(x), 1600):
            finals += [e.text for e in r.feed(x[i : i + 1600]) if e.kind == "final"]
        finals += [e.text for e in r.finish() if e.kind == "final"]
        return finals

    rec = StreamingRecognizer(
        model, params, vocab, feat_cfg, mode="ctc_greedy",
        bucket_seconds=(1.0, 2.0),
    )
    want = run_fresh(rec, seg)
    run_fresh(rec, other)  # pollute gate state (ends mid-speech)
    rec.reset_stream()
    got = run_fresh(rec, seg)
    assert got == want
