"""Distributed-without-a-cluster tests (SURVEY §4 item 3): 8-device
virtual CPU mesh — DP numerical parity, TP sharding rules, collective
correctness, multi-chip dry run."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from asr_chinese_e2e.data.features import FeatureConfig
from asr_chinese_e2e.models.transformer import SpeechTransformer
from asr_chinese_e2e.parallel.sharding import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    make_mesh,
    param_shardings,
    param_spec,
    replicated,
)
from asr_chinese_e2e.train.optimizer import default_train_config, make_optimizer
from asr_chinese_e2e.train.train_step import make_step_fns

from tests.test_train_step import VOCAB, make_raw_batch
from tests.test_transformer import tiny_cfg


def test_mesh_shapes():
    mesh = make_mesh(data=-1, model=2)
    assert mesh.shape[DATA_AXIS] == 4 and mesh.shape[MODEL_AXIS] == 2
    mesh = make_mesh()
    assert mesh.shape[DATA_AXIS] == 8


def test_param_spec_rules():
    assert param_spec("encoder/layer0/attn/q/kernel", (64, 4, 16), 2) == P(
        None, MODEL_AXIS, None
    )
    assert param_spec("decoder/layer1/ffn/w1/kernel", (64, 128), 2) == P(
        None, MODEL_AXIS
    )
    assert param_spec("decoder/embed/embedding", (32, 64), 2) == P(MODEL_AXIS, None)
    # indivisible dim -> replicated
    assert param_spec("encoder/layer0/attn/q/kernel", (64, 3, 16), 2) == P()
    # TP off -> replicated
    assert param_spec("encoder/layer0/attn/q/kernel", (64, 4, 16), 1) == P()
    assert param_spec("encoder/input_norm/scale", (64,), 2) == P()


def _build(n_batch, mesh=None, model_axis=1):
    cfg = tiny_cfg(dropout_rate=0.0, ctc_weight=0.3)
    tcfg = default_train_config().combine(cfg)
    model = SpeechTransformer(cfg, VOCAB)
    tx = make_optimizer(tcfg, cfg.d_model)
    init_fn, train_step, eval_step = make_step_fns(
        model, tx, FeatureConfig(), tcfg, raw_features=True
    )
    batch = make_raw_batch(b=n_batch)
    state = init_fn(jax.random.PRNGKey(0), batch)
    return state, train_step, batch


def _args(batch, sharding=None):
    keys = ("wave", "wave_lengths", "labels", "label_lengths")
    if sharding is None:
        return [jnp.asarray(batch[k]) for k in keys]
    return [jax.device_put(batch[k], sharding) for k in keys]


@pytest.mark.slow
def test_dp_loss_matches_single_device():
    """Data-parallel over 8 devices must produce the same loss/params as
    unsharded execution (XLA inserts the gradient reduction)."""
    state1, train_step, batch = _build(8)
    s1, m1 = train_step(state1, *_args(batch), jax.random.PRNGKey(1))

    mesh = make_mesh()  # 8-way data
    state2, train_step2, _ = _build(8)
    state2 = jax.device_put(state2, replicated(mesh))
    args = _args(batch, batch_sharding(mesh))
    s2, m2 = train_step2(state2, *args, jax.random.PRNGKey(1))

    np.testing.assert_allclose(
        float(m1["loss"]), float(m2["loss"]), rtol=1e-5
    )
    for a, b in zip(
        jax.tree_util.tree_leaves(s1.params), jax.tree_util.tree_leaves(s2.params)
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


@pytest.mark.slow
def test_tp_forward_matches_replicated():
    """Tensor-parallel (model=2) sharded params must give the same loss."""
    state1, train_step, batch = _build(4)
    _, m1 = train_step(state1, *_args(batch), jax.random.PRNGKey(1))

    mesh = make_mesh(data=-1, model=2)  # 4 data x 2 model
    state2, train_step2, _ = _build(4)
    p_sh = param_shardings(mesh, state2.params)
    state2 = state2.replace(
        params=jax.device_put(state2.params, p_sh),
        opt_state=jax.device_put(state2.opt_state, replicated(mesh)),
        step=jax.device_put(state2.step, replicated(mesh)),
    )
    args = _args(batch, batch_sharding(mesh))
    s2, m2 = train_step2(state2, *args, jax.random.PRNGKey(1))
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    # sharded params remain sharded after the update
    q = s2.params["params"]["encoder"]["layer0"]["attn"]["q"]["kernel"]
    assert not q.sharding.is_fully_replicated


def test_psum_of_shard_losses_equals_global():
    """Collective correctness: mean of per-shard CE losses == global CE
    (equal shard sizes)."""
    from asr_chinese_e2e.losses import smoothed_cross_entropy
    from jax import shard_map

    mesh = make_mesh()
    rng = np.random.RandomState(0)
    logits = jnp.asarray(rng.randn(8, 4, 6).astype(np.float32))
    gold = jnp.asarray(rng.randint(1, 6, size=(8, 4)))

    global_loss, _ = smoothed_cross_entropy(logits, gold, 0.0)

    def shard_fn(lg, gd):
        loss, _ = smoothed_cross_entropy(lg, gd, 0.0)
        return jax.lax.pmean(loss, DATA_AXIS)[None]

    sharded = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(DATA_AXIS),
    )(logits, gold)
    np.testing.assert_allclose(
        float(global_loss), float(sharded[0]), rtol=1e-5
    )


def _ctc_kernel_step(mesh):
    """One train step with the CTC loss through the Pallas kernel (in the
    interpreter), unsharded or on ``mesh``'s data axis."""
    from asr_chinese_e2e.parallel.context import active_mesh

    cfg = tiny_cfg(dropout_rate=0.0, ctc_weight=0.5)
    tcfg = default_train_config().combine(cfg).build(ctc_impl="pallas_interpret")
    model = SpeechTransformer(cfg, VOCAB)
    init_fn, train_step, _ = make_step_fns(
        model, make_optimizer(tcfg, cfg.d_model), FeatureConfig(), tcfg,
        raw_features=True,
    )
    batch = make_raw_batch(b=4)
    state = init_fn(jax.random.PRNGKey(0), batch)
    args = _args(batch)
    if mesh is not None:
        state = jax.device_put(state, replicated(mesh))
        args = _args(batch, batch_sharding(mesh))
    with active_mesh(mesh):
        return train_step(state, *args, jax.random.PRNGKey(1))


def test_ctc_kernel_train_step_on_data_mesh_matches_unsharded():
    """Under a 4-way data mesh the CTC kernel runs per shard (shard_map
    over ``data``); the step's losses equal the unsharded step's."""
    _, m1 = _ctc_kernel_step(None)
    _, m2 = _ctc_kernel_step(make_mesh(data=4, devices=jax.devices()[:4]))
    for k in ("loss", "ctc_loss", "ce_loss"):
        np.testing.assert_allclose(float(m1[k]), float(m2[k]), rtol=1e-5)


def test_ctc_kernel_train_step_on_data_mesh_updates_match():
    s1, m1 = _ctc_kernel_step(None)
    s2, m2 = _ctc_kernel_step(make_mesh(data=4, devices=jax.devices()[:4]))
    np.testing.assert_allclose(
        float(m1["grad_norm"]), float(m2["grad_norm"]), rtol=1e-5
    )
    for a, b in zip(
        jax.tree_util.tree_leaves(s1.params), jax.tree_util.tree_leaves(s2.params)
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


@pytest.mark.slow
def test_graft_dryrun_multichip():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_state_shardings_mirror_adam_moments():
    """state_shardings must TP-shard params AND their Adam moments
    identically, replicating scalar counters."""
    from asr_chinese_e2e.parallel.sharding import state_shardings

    cfg = tiny_cfg(dropout_rate=0.0)
    tcfg = default_train_config().combine(cfg)
    model = SpeechTransformer(cfg, VOCAB)
    tx = make_optimizer(tcfg, cfg.d_model)
    init_fn, _, _ = make_step_fns(model, tx, FeatureConfig(), tcfg, raw_features=True)
    batch = make_raw_batch()
    state = init_fn(jax.random.PRNGKey(0), batch)

    mesh = make_mesh(data=-1, model=2)
    sh = state_shardings(mesh, state)
    p_flat = jax.tree_util.tree_flatten_with_path(sh.params)[0]
    sharded_paths = {
        jax.tree_util.keystr(p)
        for p, s in p_flat
        if s.spec != P()
    }
    assert sharded_paths, "no param got a TP rule"
    # every sharded param's mu and nu carry the SAME spec
    o_flat = jax.tree_util.tree_flatten_with_path(sh.opt_state)[0]
    mirrored = {}
    for path, s in o_flat:
        ks = jax.tree_util.keystr(path)
        for pks in sharded_paths:
            if ks.endswith(pks):
                mirrored.setdefault(pks, []).append(s.spec)
    for pks in sharded_paths:
        specs = mirrored.get(pks, [])
        assert len(specs) >= 2, f"{pks}: moments not found in opt_state"
        want = dict(p_flat)[next(iter([p for p, _ in p_flat if jax.tree_util.keystr(p) == pks]))]
        for s in specs:
            assert s == want.spec, (pks, s, want.spec)


@pytest.mark.slow
def test_trainer_tp_shards_params_and_matches_replicated():
    """--mesh_model 2 must actually TP-shard the Trainer's state (params
    and Adam moments over `model`) and reproduce the replicated run's loss
    trajectory."""
    import json
    import os
    import tempfile

    from asr_chinese_e2e.data.batching import BucketedLoader
    from asr_chinese_e2e.data.manifest import write_manifest
    from asr_chinese_e2e.data.vocab import Vocab
    from asr_chinese_e2e.train.trainer import Trainer
    from tests.test_manifest import write_wav

    tmp = tempfile.mkdtemp()
    texts = ["你好", "世界", "你好世界", "好你"]
    records = []
    for i in range(8):
        p = os.path.join(tmp, f"u{i}.wav")
        write_wav(p, n_samples=8000)
        records.append({"wave": p, "tgt": texts[i % 4], "frames": 8000})
    mpath = os.path.join(tmp, "train.jsonl")
    write_manifest(mpath, records)
    vocab = Vocab()
    vocab.consume_sentence_list(texts)
    vocab.build()

    feat_cfg = FeatureConfig(n_mels=20)
    cfg = tiny_cfg(dropout_rate=0.0, input_dim=feat_cfg.feature_dim)
    tcfg = default_train_config().combine(cfg)
    tcfg.build(
        batch_size=4, num_epoch=1, log_every_iter=1, eval_every_iter=1000,
        save_every_iter=1000, lr_schedule="constant", lr=1e-3,
        exp_root=tmp, spec_augment=False,
    )

    def run(mesh, name):
        loader = BucketedLoader(mpath, vocab, batch_size=4, max_target_len=8, seed=0)
        model = SpeechTransformer(cfg, vocab.vocab_size)
        tx = make_optimizer(tcfg, cfg.d_model)
        t = Trainer(
            model, tx, tcfg.build(exp_name=name), feat_cfg, vocab,
            train_loader=loader, mesh=mesh,
        )
        t.train()
        rows = [
            json.loads(l)
            for l in open(os.path.join(t.exp_dir, "scalars.jsonl"))
        ]
        losses = [r["train/loss"] for r in rows if "train/loss" in r]
        return t, losses

    t_rep, losses_rep = run(make_mesh(data=4, model=1), "tp_rep")
    t_tp, losses_tp = run(make_mesh(data=4, model=2), "tp_tp")

    # (a) params actually sharded over `model`
    sharded = [
        l
        for l in jax.tree_util.tree_leaves(t_tp.state.params)
        if hasattr(l, "sharding") and not l.sharding.is_fully_replicated
    ]
    assert sharded, "TP trainer left every param replicated"
    # ... and so are the Adam moments
    opt_sharded = [
        l
        for l in jax.tree_util.tree_leaves(t_tp.state.opt_state)
        if hasattr(l, "sharding") and not l.sharding.is_fully_replicated
    ]
    assert len(opt_sharded) >= 2 * len(sharded) - 2, "Adam moments replicated"
    # (b) loss trajectory matches the replicated run
    np.testing.assert_allclose(losses_rep, losses_tp, rtol=2e-3, atol=2e-3)
