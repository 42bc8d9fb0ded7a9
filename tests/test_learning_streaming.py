"""Streaming-family learning test: a tiny CAUSAL-banded SpeechTransformer
(the incremental-streaming model family: causal_encoder + attention_band +
fixed CMVN) must learn the synthetic tone language, and the incremental
streaming recognizer must produce the same finals as the offline decode on
the LEARNED weights — the end-to-end "a user can train and serve a
streaming model" proof."""

import pytest

pytestmark = pytest.mark.slow
import jax
import jax.numpy as jnp
import numpy as np

from asr_chinese_e2e.data.batching import BucketedLoader, load_wav
from asr_chinese_e2e.data.features import FeatureConfig, parse_batch
from asr_chinese_e2e.decode.cer import corpus_cer
from asr_chinese_e2e.decode.greedy import ctc_greedy_decode
from asr_chinese_e2e.models.transformer import SpeechTransformer, default_config
from asr_chinese_e2e.stream import StreamingRecognizer
from asr_chinese_e2e.train.optimizer import default_train_config, make_optimizer
from asr_chinese_e2e.train.train_step import make_step_fns

from tests.test_learning import make_corpus


def test_streaming_model_learns_and_streams(tmp_path):
    mpath, vocab = make_corpus(tmp_path, n=48, seed=2)
    feat_cfg = FeatureConfig(n_mels=40, cmvn_mode="fixed",
                             cmvn_mean=-18.0, cmvn_std=6.0)
    mcfg = default_config().build(
        d_model=64, num_heads=2, head_dim=32, d_ff=128,
        num_encoder_layers=2, num_decoder_layers=2,
        input_dim=feat_cfg.feature_dim, dropout_rate=0.0,
        ctc_weight=0.3, norm_type="pre",
        causal_encoder=True, attention_band=12,
    )
    tcfg = default_train_config().combine(mcfg).build(
        lr_schedule="constant", lr=3e-3, rng_impl="threefry2x32",
    )
    model = SpeechTransformer(mcfg, vocab.vocab_size)
    tx = make_optimizer(tcfg, mcfg.d_model)
    init_fn, train_step, _ = make_step_fns(model, tx, feat_cfg, tcfg)

    loader = BucketedLoader(
        mpath, vocab, batch_size=16, max_target_len=8, seed=0,
        bucket_seconds=(1.5,), prefetch=0, feat_cfg=feat_cfg,
    )
    first = next(iter(loader.epoch(0)))
    state = init_fn(
        jax.random.PRNGKey(0),
        {"wave": first.wave, "wave_lengths": first.wave_lengths,
         "labels": first.labels, "label_lengths": first.label_lengths},
    )
    rng = jax.random.key(0, impl="threefry2x32")
    ctc = None
    for epoch in range(250):
        for b in loader.epoch(epoch):
            state, m = train_step(
                state,
                jnp.asarray(b.wave), jnp.asarray(b.wave_lengths),
                jnp.asarray(b.labels), jnp.asarray(b.label_lengths),
                rng,
            )
        ctc = float(m["ctc_loss"])
        if ctc < 0.3:  # the decode below reads the CTC head
            break
    assert ctc is not None and ctc < 1.0, f"causal model did not converge: {ctc}"
    params = {"params": state.params["params"]} if "params" in state.params \
        else state.params

    # offline CTC decode CER over the corpus (causal encoders trade
    # accuracy for latency — the tone task should still be essentially
    # solved at band 12)
    import json

    records = [json.loads(l) for l in open(mpath)]
    hyps, refs = [], []
    for b in loader.epoch(0):
        feats, feat_lens = parse_batch(
            jnp.asarray(b.wave), jnp.asarray(b.wave_lengths), feat_cfg
        )
        enc, enc_lens = model.apply(state.params, feats, feat_lens,
                                    method="encode")
        lp = model.apply(state.params, enc, method="ctc_log_probs")
        for ids, ref in zip(ctc_greedy_decode(lp, enc_lens), b.texts):
            hyps.append("".join(vocab.ids_to_tokens(ids)))
            refs.append(ref)
    cer = corpus_cer(hyps, refs)
    assert cer < 10.0, f"offline CTC CER too high: {cer}"

    # incremental streaming finals on learned weights == offline text
    rec = StreamingRecognizer(
        model, state.params, vocab, feat_cfg, mode="ctc_greedy",
        bucket_seconds=(1.5,), incremental="on", chunk_frames=8,
        partial_every_s=0.25,
    )
    checked = 0
    for r in records[:6]:
        x = load_wav(r["wave"], dtype=np.int16)
        rec._inc_advance(0, x, final=True)
        got = rec._inc_text()
        rec._inc_start = None
        feats, feat_lens = parse_batch(
            jnp.asarray(x[None]).astype(jnp.float32) / 32768.0,
            jnp.asarray([len(x)], jnp.int32), feat_cfg,
        )
        enc, enc_lens = model.apply(state.params, feats, feat_lens,
                                    method="encode")
        lp = model.apply(state.params, enc, method="ctc_log_probs")
        want = vocab.ids_to_str(ctc_greedy_decode(lp, enc_lens)[0])
        assert got == want, (got, want, r["tgt"])
        checked += 1
    assert checked == 6
