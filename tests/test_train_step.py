"""Train step: loss decreases, Noam schedule values, grad clip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asr_chinese_e2e.core.config import Config
from asr_chinese_e2e.data.features import FeatureConfig
from asr_chinese_e2e.models.rnn import BiLSTMCTC, default_ctc_config
from asr_chinese_e2e.models.transformer import SpeechTransformer
from asr_chinese_e2e.train.optimizer import (
    current_lr,
    default_train_config,
    make_optimizer,
    noam_schedule,
)
from asr_chinese_e2e.train.train_step import make_step_fns

from tests.test_transformer import tiny_cfg

VOCAB = 20
FEAT_CFG = FeatureConfig()


def reference_noam(step, model_size, factor, warmup):
    # Trainer/optimizer.py:24-28
    return factor * (model_size ** -0.5) * min(step ** -0.5, step * warmup ** -1.5)


def test_noam_schedule_matches_reference_values():
    sched = noam_schedule(512, 4000, factor=1.0)
    for step in [1, 10, 100, 4000, 10000, 100000]:
        got = float(sched(jnp.asarray(step - 1)))  # count = step - 1
        want = reference_noam(step, 512, 1.0, 4000)
        np.testing.assert_allclose(got, want, rtol=1e-6)


def make_raw_batch(b=4, t=12, l=5, d=12, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "wave": rng.randn(b, t, d).astype(np.float32),  # raw_features mode
        "wave_lengths": np.full((b,), t, np.int32),
        "labels": np.tile(rng.randint(4, VOCAB, size=(1, l)), (b, 1)).astype(np.int32),
        "label_lengths": np.full((b,), l, np.int32),
    }


def build(model_cfg, model_cls, train_overrides=None):
    tcfg = default_train_config().combine(model_cfg)
    tcfg.build(**(train_overrides or {}))
    model = model_cls(model_cfg, VOCAB)
    tx = make_optimizer(tcfg, tcfg.get("d_model", 64))
    return model, tx, tcfg


def run_steps(model, tx, tcfg, n_steps, batch):
    init_fn, train_step, eval_step = make_step_fns(
        model, tx, FEAT_CFG, tcfg, raw_features=True
    )
    state = init_fn(jax.random.PRNGKey(0), batch)
    args = [jnp.asarray(batch[k]) for k in ("wave", "wave_lengths", "labels", "label_lengths")]
    losses = []
    for _ in range(n_steps):
        state, metrics = train_step(state, *args, jax.random.PRNGKey(1))
        losses.append(float(metrics["loss"]))
    return state, losses, eval_step, args


def test_transformer_hybrid_loss_decreases():
    cfg = tiny_cfg(dropout_rate=0.0, ctc_weight=0.3)
    model, tx, tcfg = build(cfg, SpeechTransformer, {"warmup": 10, "noam_factor": 10.0})
    batch = make_raw_batch()
    state, losses, eval_step, args = run_steps(model, tx, tcfg, 30, batch)
    assert losses[-1] < losses[0] * 0.8, losses
    assert int(state.step) == 30
    m = eval_step(state.params, *args)
    assert "pred_ids" in m and np.isfinite(float(m["loss"]))


def test_ctc_only_loss_decreases():
    cfg = default_ctc_config().build(
        hidden_size=16, input_dim=12, dropout_rate=0.0
    )
    model, tx, tcfg = build(cfg, BiLSTMCTC, {"lr_schedule": "constant", "lr": 1e-2})
    batch = make_raw_batch(t=16, l=3)
    _, losses, eval_step, args = run_steps(model, tx, tcfg, 40, batch)
    assert losses[-1] < losses[0] * 0.7, losses


@pytest.mark.slow
def test_grad_accum_matches_full_batch():
    """grad_accum=N (microbatch scan) must reproduce the full-batch update
    exactly when microbatch losses are equal-weighted (uniform target
    lengths here make CE and CTC means exactly decomposable)."""
    cfg = tiny_cfg(dropout_rate=0.0, ctc_weight=0.3)
    batch = make_raw_batch(b=4)

    model, tx, tcfg = build(cfg, SpeechTransformer)
    state1, losses1, _, _ = run_steps(model, tx, tcfg, 2, batch)

    model2, tx2, tcfg2 = build(cfg, SpeechTransformer, {"grad_accum": 2})
    state2, losses2, _, _ = run_steps(model2, tx2, tcfg2, 2, batch)

    np.testing.assert_allclose(losses1, losses2, rtol=1e-5)
    for a, b in zip(
        jax.tree_util.tree_leaves(state1.params),
        jax.tree_util.tree_leaves(state2.params),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


@pytest.mark.slow
def test_remat_matches_no_remat():
    """remat=True (per-layer activation rematerialization) must not change
    the computation — identical loss and updated params."""
    batch = make_raw_batch(b=4)
    cfg = tiny_cfg(dropout_rate=0.0, ctc_weight=0.3)
    model, tx, tcfg = build(cfg, SpeechTransformer)
    state1, losses1, _, _ = run_steps(model, tx, tcfg, 2, batch)

    cfg_r = tiny_cfg(dropout_rate=0.0, ctc_weight=0.3, remat=True)
    model2, tx2, tcfg2 = build(cfg_r, SpeechTransformer)
    state2, losses2, _, _ = run_steps(model2, tx2, tcfg2, 2, batch)

    np.testing.assert_allclose(losses1, losses2, rtol=1e-5)
    for a, b in zip(
        jax.tree_util.tree_leaves(state1.params),
        jax.tree_util.tree_leaves(state2.params),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_grad_clip_bounds_grad_norm_effect():
    # with clip 5.0 the metrics expose pre-clip grad_norm; ensure updates
    # stay finite even with a huge learning rate spike
    cfg = tiny_cfg(dropout_rate=0.0, ctc_weight=0.0)
    model, tx, tcfg = build(cfg, SpeechTransformer, {"lr_schedule": "constant", "lr": 1.0})
    batch = make_raw_batch()
    state, losses, _, _ = run_steps(model, tx, tcfg, 3, batch)
    for leaf in jax.tree_util.tree_leaves(state.params):
        assert np.isfinite(np.asarray(leaf)).all()


def test_current_lr_readout():
    tcfg = default_train_config()
    lr = current_lr(tcfg, 512, 4000)
    np.testing.assert_allclose(lr, reference_noam(4001, 512, 1.0, 4000), rtol=1e-5)

def test_grad_accum_indivisible_batch_raises():
    """A batch size not divisible by grad_accum must fail loudly at trace
    time, not silently garble rows via reshape."""
    import pytest

    cfg = tiny_cfg(dropout_rate=0.0, ctc_weight=0.3)
    model, tx, tcfg = build(cfg, SpeechTransformer, {"grad_accum": 3})
    batch = make_raw_batch(b=4)  # 4 % 3 != 0
    with pytest.raises(ValueError, match="not divisible by grad_accum"):
        run_steps(model, tx, tcfg, 1, batch)


@pytest.mark.slow
def test_multi_step_matches_sequential_steps():
    """make_multi_step (k steps per dispatch) must reproduce k sequential
    train_step calls: same RNG streams (the step folds state.step into the
    key itself), same final params, per-step metrics stacked (k,)."""
    from asr_chinese_e2e.train.train_step import make_multi_step

    k = 3
    cfg = tiny_cfg(dropout_rate=0.1, ctc_weight=0.3)  # dropout ON: RNG parity
    batch = make_raw_batch(b=4)
    model, tx, tcfg = build(cfg, SpeechTransformer)

    # sequential
    state1, losses1, _, _ = run_steps(model, tx, tcfg, k, batch)

    # one multi-step dispatch over the same batch stacked k times
    init_fn, train_step, _ = make_step_fns(
        model, tx, FEAT_CFG, tcfg, raw_features=True
    )
    state2 = init_fn(jax.random.PRNGKey(0), batch)
    multi = make_multi_step(train_step)
    stacked = [
        jnp.asarray(np.broadcast_to(batch[key], (k,) + batch[key].shape))
        for key in ("wave", "wave_lengths", "labels", "label_lengths")
    ]
    state2, metrics = multi(state2, *stacked, jax.random.PRNGKey(1))

    assert metrics["loss"].shape == (k,)
    np.testing.assert_allclose(np.asarray(metrics["loss"]), losses1, rtol=1e-5)
    assert int(state2.step) == k
    for a, b in zip(
        jax.tree_util.tree_leaves(state1.params),
        jax.tree_util.tree_leaves(state2.params),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


@pytest.mark.slow
def test_flat_optimizer_matches_per_leaf_updates():
    """flat_optimizer=True (optax.flatten: clip+Adam over one flat vector)
    must produce the same losses and params as the per-leaf chain."""
    cfg = tiny_cfg(dropout_rate=0.0, ctc_weight=0.3)
    batch = make_raw_batch(b=4)

    model, tx, tcfg = build(cfg, SpeechTransformer)
    state1, losses1, _, _ = run_steps(model, tx, tcfg, 3, batch)

    model2, tx2, tcfg2 = build(cfg, SpeechTransformer, {"flat_optimizer": True})
    state2, losses2, _, _ = run_steps(model2, tx2, tcfg2, 3, batch)

    np.testing.assert_allclose(losses1, losses2, rtol=1e-5)
    for a, b in zip(
        jax.tree_util.tree_leaves(state1.params),
        jax.tree_util.tree_leaves(state2.params),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_metric_sums_accumulate_on_device():
    """``TrainState.metric_sums`` window diffs must equal the host-side
    MetricsAccumulator over per-step metric dicts (the fetch they replace),
    and the device key set must stay in sync with what ``model_loss`` +
    ``train_step`` actually emit (``_metric_keys`` mirrors that branch
    logic without running the losses)."""
    from asr_chinese_e2e.train.metrics import MetricsAccumulator

    cfg = tiny_cfg(dropout_rate=0.0, ctc_weight=0.3)
    model, tx, tcfg = build(cfg, SpeechTransformer)
    init_fn, train_step, _ = make_step_fns(
        model, tx, FEAT_CFG, tcfg, raw_features=True
    )
    batch = make_raw_batch(b=4)
    state = init_fn(jax.random.PRNGKey(0), batch)
    args = [
        jnp.asarray(batch[k])
        for k in ("wave", "wave_lengths", "labels", "label_lengths")
    ]
    assert all(float(v) == 0.0 for v in jax.device_get(state.metric_sums).values())

    acc = MetricsAccumulator()
    base = {k: 0.0 for k in state.metric_sums}
    for window in range(2):
        for _ in range(3):
            state, metrics = train_step(state, *args, jax.random.PRNGKey(1))
            acc.update(
                {k: float(v) for k, v in metrics.items()}, num_samples=4
            )
        # key-set sync: device sums == step metrics (plus the "_n" count)
        assert set(state.metric_sums) == set(metrics) | {"_n"}
        sums = {k: float(v) for k, v in jax.device_get(state.metric_sums).items()}
        n = sums["_n"] - base["_n"]
        assert n == 12.0  # 3 steps x B=4
        means = {k: (sums[k] - base[k]) / n for k in sums if k != "_n"}
        want = acc.means()
        for k, v in want.items():
            np.testing.assert_allclose(means[k], v, rtol=2e-5, err_msg=k)
        base = sums
        acc.reset()


def test_noam_peak_guardrail():
    """Hot compressed schedules (peak LR in the measured stall band,
    BENCH_NOTES r4) warn; the reference recipe and scaled-down compressed
    schedules don't."""
    import warnings

    from asr_chinese_e2e.train.optimizer import noam_peak_lr

    hot = default_train_config().build(warmup=150, noam_factor=1.0)
    with pytest.warns(UserWarning, match="Noam peak"):
        make_optimizer(hot, 512)

    for cfg, d in (
        (default_train_config(), 512),  # reference recipe: peak 7e-4
        (default_train_config().build(warmup=150, noam_factor=0.25), 512),
    ):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            make_optimizer(cfg, d)

    assert abs(noam_peak_lr(512, 4000) - 7e-4) < 1e-4
