"""End-to-end LEARNING test: a synthetic tone language (each character is
a distinct pure tone) must be learnable to ~zero decoded CER through the
full stack — wav -> device fbank/CMVN/LFR -> BiLSTM -> CTC -> greedy
decode. This is the strongest correctness signal available without the
AISHELL corpus (none in this environment)."""

import pytest

pytestmark = pytest.mark.slow
import os
import wave as wavelib

import jax
import jax.numpy as jnp
import numpy as np

from asr_chinese_e2e.data.batching import BucketedLoader
from asr_chinese_e2e.data.features import FeatureConfig, parse_batch
from asr_chinese_e2e.data.manifest import write_manifest
from asr_chinese_e2e.data.vocab import Vocab
from asr_chinese_e2e.decode.cer import corpus_cer
from asr_chinese_e2e.decode.greedy import ctc_greedy_decode
from asr_chinese_e2e.models.rnn import BiLSTMCTC, default_ctc_config
from asr_chinese_e2e.train.optimizer import default_train_config, make_optimizer
from asr_chinese_e2e.train.train_step import make_step_fns

SR = 16000
CHARS = "一二三四五六"
FREQS = [300, 500, 800, 1200, 1800, 2600]  # Hz per char
TONE_SEC = 0.2


def synth(text: str, rng) -> np.ndarray:
    parts = []
    for ch in text:
        f = FREQS[CHARS.index(ch)]
        t = np.arange(int(SR * TONE_SEC)) / SR
        tone = 0.4 * np.sin(2 * np.pi * f * t)
        parts.append(tone)
    x = np.concatenate(parts) + rng.randn(len(parts) * int(SR * TONE_SEC)) * 0.01
    return np.clip(x, -0.99, 0.99)


def write_wav16(path, x):
    with wavelib.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((x * 32767).astype(np.int16).tobytes())


def make_corpus(tmp_path, n=64, seed=0):
    rng = np.random.RandomState(seed)
    records = []
    for i in range(n):
        length = rng.randint(3, 6)
        text = "".join(CHARS[rng.randint(len(CHARS))] for _ in range(length))
        x = synth(text, rng)
        p = str(tmp_path / f"t{i}.wav")
        write_wav16(p, x)
        records.append({"wave": p, "tgt": text, "frames": len(x)})
    mpath = str(tmp_path / "train.jsonl")
    write_manifest(mpath, records)
    v = Vocab()
    v.consume_sentence_list([r["tgt"] for r in records])
    return mpath, v.build()


def test_tone_language_learned_to_low_cer(tmp_path):
    mpath, vocab = make_corpus(tmp_path)
    feat_cfg = FeatureConfig(n_mels=40)
    mcfg = default_ctc_config().build(
        hidden_size=64, num_encoder_layers=2,
        input_dim=feat_cfg.feature_dim, dropout_rate=0.0,
    )
    tcfg = default_train_config().combine(mcfg).build(
        lr_schedule="constant", lr=3e-3, rng_impl="threefry2x32",
    )
    model = BiLSTMCTC(mcfg, vocab.vocab_size)
    tx = make_optimizer(tcfg, mcfg.hidden_size)
    init_fn, train_step, _ = make_step_fns(model, tx, feat_cfg, tcfg)

    loader = BucketedLoader(
        mpath, vocab, batch_size=16, max_target_len=8, seed=0,
        bucket_seconds=(1.5,), prefetch=0,
    )
    batches = list(loader.epoch(0))
    first = batches[0]
    state = init_fn(
        jax.random.PRNGKey(0),
        {
            "wave": first.wave,
            "wave_lengths": first.wave_lengths,
            "labels": first.labels,
            "label_lengths": first.label_lengths,
        },
    )
    rng = jax.random.key(0, impl="threefry2x32")
    loss = None
    for epoch in range(60):
        for b in loader.epoch(epoch):
            state, m = train_step(
                state,
                jnp.asarray(b.wave), jnp.asarray(b.wave_lengths),
                jnp.asarray(b.labels), jnp.asarray(b.label_lengths),
                rng,
            )
        loss = float(m["loss"])
        if loss < 0.05:
            break
    assert loss is not None and loss < 0.5, f"CTC loss did not converge: {loss}"

    # decoded CER on the training corpus must be ~0
    hyps, refs = [], []
    for b in loader.epoch(0):
        feats, feat_lens = parse_batch(
            jnp.asarray(b.wave), jnp.asarray(b.wave_lengths), feat_cfg
        )
        enc_out, enc_lens = model.apply(state.params, feats, feat_lens, method="encode")
        lp = model.apply(state.params, enc_out, method="ctc_log_probs")
        for ids, text in zip(ctc_greedy_decode(lp, enc_lens), b.texts):
            hyps.append("".join(vocab.ids_to_tokens(ids)))
            refs.append(text)
    cer = corpus_cer(hyps, refs)
    assert cer < 10.0, f"decoded CER too high: {cer} (sample: {hyps[:3]} vs {refs[:3]})"
