"""CPU diagnostic: does the soak's hot Noam schedule explain the attention
plateau? Mid-scale SpeechTransformer on the tone corpus, hot vs gentle LR.

Arms (same data, same init seed):
  hot:    warm_up 150, factor 1.0  (the r3 soak schedule shape)
  gentle: warm_up 150, factor 0.25
Watch train CE + TF accuracy every 25 steps.
"""
import os, sys, time, json
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

from asr_chinese_e2e.data.batching import BucketedLoader
from asr_chinese_e2e.data.features import FeatureConfig
from asr_chinese_e2e.data.vocab import Vocab
from asr_chinese_e2e.models.transformer import SpeechTransformer, default_config
from asr_chinese_e2e.train.optimizer import default_train_config, make_optimizer
from asr_chinese_e2e.train.train_step import make_step_fns
from asr_chinese_e2e.utils.synth import make_synth_corpus

CORPUS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache", "lr_ab_corpus")
paths = make_synth_corpus(
    CORPUS, n_train=256, n_dev=32, n_test=32,
    n_tone_chars=40, vocab_size=200,
    seconds_range=(3.0, 5.0), tone_sec=0.3, seed=7,
)
vocab = Vocab.load(paths["vocab"])
feat_cfg = FeatureConfig()  # 80 mel, LFR 4/3 -> 320-dim, same as flagship

ARMS = {
    "hot": dict(warmup=150, factor=1.0),
    "gentle": dict(warmup=150, factor=0.25),
    # recipe-parity placement/regularisation (post-LN, dropout 0.1 —
    # transformer_official.py:112-124) under hot vs scaled peaks: the r3
    # soak saw post-LN pinned at the uniform plateau with BOTH dropouts at
    # factor 1.0 — these arms test whether the peak, not the placement,
    # was the cause (round-3 VERDICT #2)
    "post_hot": dict(warmup=300, factor=1.0, norm="post", dropout=0.1),
    "post_gentle": dict(warmup=300, factor=0.25, norm="post", dropout=0.1),
}
arm = sys.argv[1] if len(sys.argv) > 1 else "hot"
a = ARMS[arm]

mcfg = default_config().build(
    d_model=256, num_heads=4, head_dim=64, d_ff=512,
    num_encoder_layers=3, num_decoder_layers=3,
    input_dim=feat_cfg.feature_dim, dropout_rate=a.get("dropout", 0.0),
    ctc_weight=0.3, norm_type=a.get("norm", "pre"),
)
tcfg = default_train_config().combine(mcfg).build(
    lr_schedule="noam", warmup=a["warmup"], noam_factor=a["factor"],
    rng_impl="threefry2x32", ctc_weight=0.3,
)
model = SpeechTransformer(mcfg, vocab.vocab_size)
tx = make_optimizer(tcfg, mcfg.d_model)
init_fn, train_step, _ = make_step_fns(model, tx, feat_cfg, tcfg)

loader = BucketedLoader(
    paths["train"], vocab, batch_size=32, max_target_len=20, seed=0,
    bucket_seconds=(5.0,), prefetch=0,
)
first = next(iter(loader.epoch(0)))
state = init_fn(
    jax.random.PRNGKey(0),
    {"wave": first.wave, "wave_lengths": first.wave_lengths,
     "labels": first.labels, "label_lengths": first.label_lengths},
)
rng = jax.random.key(0, impl="threefry2x32")
t0 = time.time()
step = 0
print(f"=== arm {arm}: warmup {a['warmup']} factor {a['factor']} ===", flush=True)
for epoch in range(130):
    for b in loader.epoch(epoch):
        state, m = train_step(
            state, jnp.asarray(b.wave), jnp.asarray(b.wave_lengths),
            jnp.asarray(b.labels), jnp.asarray(b.label_lengths), rng,
        )
        step += 1
        if step % 25 == 0:
            acc = float(m["n_correct"]) / max(float(m["n_word"]), 1)
            print(json.dumps({
                "arm": arm, "step": step,
                "ce": round(float(m["ce_loss"]), 3),
                "ctc": round(float(m["ctc_loss"]), 3),
                "acc": round(acc, 3),
                "gnorm": round(float(m["grad_norm"]), 2),
                "t": round(time.time() - t0, 1),
            }), flush=True)
    if step >= 1000:
        break
print(f"=== arm {arm} done at step {step}, {time.time()-t0:.0f}s ===", flush=True)
# Measured 2026-08 (BENCH_NOTES r4): hot pinned at acc 0.28 / CE 2.58 by
# step 200; gentle reached acc 0.97 / CE 0.08 by step 350. Run:
#   python scripts/lr_ab_cpu.py hot ; python scripts/lr_ab_cpu.py gentle
# post_gentle measured: acc 0.75 @300, 0.97 @625 — post-LN + dropout 0.1
# trains once the peak is reference-scale (see BENCH_NOTES r4).
