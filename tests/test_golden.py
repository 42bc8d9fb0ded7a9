"""Golden parity test (SURVEY §4 item 4): fixed-seed tiny model, three
optimizer steps, loss trajectory compared against stored goldens — guards
silent numerical drift across refactors."""

import jax
import jax.numpy as jnp
import numpy as np

from asr_chinese_e2e.data.features import FeatureConfig
from asr_chinese_e2e.models.transformer import SpeechTransformer
from asr_chinese_e2e.train.optimizer import default_train_config, make_optimizer
from asr_chinese_e2e.train.train_step import make_step_fns

from tests.test_transformer import tiny_cfg

# generated on CPU, jax 0.9.0, threefry2x32 keys, seed 42, parameters
# initialised by models/nn.py (keys folded from each parameter's path)
GOLDEN_LOSSES = [7.137515544891357, 7.136683940887451, 7.135018825531006]


def test_golden_loss_trajectory():
    cfg = tiny_cfg(dropout_rate=0.0, ctc_weight=0.3)
    tcfg = default_train_config().combine(cfg).build(rng_impl="threefry2x32")
    model = SpeechTransformer(cfg, 20)
    tx = make_optimizer(tcfg, cfg.d_model)
    init_fn, train_step, _ = make_step_fns(
        model, tx, FeatureConfig(), tcfg, raw_features=True
    )
    rng = np.random.RandomState(42)
    batch = {
        "wave": rng.randn(2, 9, 12).astype(np.float32),
        "wave_lengths": np.array([9, 6], np.int32),
        "labels": np.array([[5, 6, 7, 0, 0], [8, 9, 0, 0, 0]], np.int32),
        "label_lengths": np.array([3, 2], np.int32),
    }
    state = init_fn(jax.random.PRNGKey(42), batch)
    args = [
        jnp.asarray(batch[k])
        for k in ("wave", "wave_lengths", "labels", "label_lengths")
    ]
    losses = []
    for _ in range(3):
        state, m = train_step(
            state, *args, jax.random.key(42, impl="threefry2x32")
        )
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, GOLDEN_LOSSES, rtol=2e-4)
