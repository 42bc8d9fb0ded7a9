"""Checkpoint save→resume→bitwise-continue (SURVEY §4 item 2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asr_chinese_e2e.data.features import FeatureConfig
from asr_chinese_e2e.models.transformer import SpeechTransformer
from asr_chinese_e2e.train.checkpoint import CheckpointManager
from asr_chinese_e2e.train.optimizer import default_train_config, make_optimizer
from asr_chinese_e2e.train.train_step import make_step_fns

from tests.test_train_step import VOCAB, make_raw_batch
from tests.test_transformer import tiny_cfg


def setup(tmp_path):
    cfg = tiny_cfg(dropout_rate=0.0, ctc_weight=0.3)
    tcfg = default_train_config().combine(cfg)
    model = SpeechTransformer(cfg, VOCAB)
    tx = make_optimizer(tcfg, cfg.d_model)
    init_fn, train_step, _ = make_step_fns(
        model, tx, FeatureConfig(), tcfg, raw_features=True
    )
    batch = make_raw_batch()
    args = [
        jnp.asarray(batch[k])
        for k in ("wave", "wave_lengths", "labels", "label_lengths")
    ]
    state = init_fn(jax.random.PRNGKey(0), batch)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), reference="-loss")
    return mgr, train_step, state, args, cfg


def test_save_restore_bitwise_continue(tmp_path):
    mgr, train_step, state, args, cfg = setup(tmp_path)
    rng = jax.random.PRNGKey(7)
    for _ in range(2):
        state, _ = train_step(state, *args, rng)
    mgr.save(state, epoch=0, config=cfg, vocab_fingerprint="abc", metric=1.0)

    # branch A: continue in-process
    state_a = state
    for _ in range(3):
        state_a, _ = train_step(state_a, *args, rng)

    # branch B: restore from disk then continue
    state_b, meta = mgr.restore("latest", template=state)
    assert meta["vocab_fingerprint"] == "abc"
    assert meta["epoch"] == 0
    np.testing.assert_array_equal(int(state_b.step), 2)
    for _ in range(3):
        state_b, _ = train_step(state_b, *args, rng)

    for a, b in zip(
        jax.tree_util.tree_leaves(state_a.params),
        jax.tree_util.tree_leaves(state_b.params),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_best_pointer_lower_is_better(tmp_path):
    mgr, train_step, state, args, cfg = setup(tmp_path)
    rng = jax.random.PRNGKey(0)
    state, _ = train_step(state, *args, rng)
    mgr.save(state, epoch=0, metric=5.0)
    first = mgr.latest_name
    state, _ = train_step(state, *args, rng)
    mgr.save(state, epoch=0, metric=3.0)  # better
    second = mgr.latest_name
    state, _ = train_step(state, *args, rng)
    mgr.save(state, epoch=1, metric=4.0)  # worse
    assert mgr.best_name == second
    assert mgr.latest_name != second
    # restore best
    restored, meta = mgr.restore("best", template=state)
    assert int(restored.step) == 2
    assert meta["metric"] == 3.0


def test_checkpoint_name_parity(tmp_path):
    # file naming parity: e{epoch}_s{step} (trainer11.py:93-99)
    mgr, train_step, state, args, cfg = setup(tmp_path)
    state, _ = train_step(state, *args, jax.random.PRNGKey(0))
    path = mgr.save(state, epoch=3)
    assert path.endswith("e3_s1")


class _SlowCkptr:
    """Slow-filesystem mock: stages to host synchronously (the
    checkpointer's donation-safety contract), then commits through the real checkpointer
    on a background thread after ``delay`` seconds."""

    def __init__(self, inner, delay: float):
        import jax as _jax

        self.inner, self.delay = inner, delay
        self._jax = _jax
        self._thread = None

    def save(self, path, tree, force=True):
        import threading
        import time

        staged = self._jax.tree.map(np.asarray, tree)

        def commit():
            time.sleep(self.delay)
            self.inner.save(path, staged, force=force)
            self.inner.wait_until_finished()

        self._thread = threading.Thread(target=commit, daemon=True)
        self._thread.start()

    def wait_until_finished(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.inner.wait_until_finished()

    def restore(self, *a, **k):
        return self.inner.restore(*a, **k)


def test_async_save_overlaps_training(tmp_path):
    """Round-2 VERDICT #4: a train step must complete while a (slow-FS)
    save is in flight, the latest pointer must only publish after commit,
    and the restored state must be bitwise the state at save time."""
    import time

    mgr, train_step, state, args, cfg = setup(tmp_path)
    rng = jax.random.PRNGKey(1)
    state, _ = train_step(state, *args, rng)
    snapshot = jax.tree.map(np.asarray, state.params)  # host copy pre-save

    mgr._ckptr = _SlowCkptr(mgr._ckptr, delay=1.5)
    t0 = time.perf_counter()
    mgr.save(state, epoch=0, metric=1.0)
    assert time.perf_counter() - t0 < 1.0, "save() blocked on the slow commit"

    # hot loop continues while the commit is in flight
    for _ in range(2):
        state, m = train_step(state, *args, rng)
    assert np.isfinite(float(m["loss"]))
    assert mgr._ckptr._thread.is_alive(), "commit finished too fast to test overlap"

    # crash consistency: a fresh manager (simulated restart) must NOT see
    # the uncommitted checkpoint as latest
    fresh = CheckpointManager(str(tmp_path / "ckpt"))
    assert fresh._index["latest"] is None

    mgr.wait()
    assert mgr.latest_name == "e0_s1"
    restored, _ = mgr.restore("latest", template=state)
    assert int(restored.step) == 1
    for a, b in zip(
        jax.tree_util.tree_leaves(snapshot),
        jax.tree_util.tree_leaves(restored.params),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_meta_and_index_writes_gated_on_process_zero(tmp_path, monkeypatch):
    """Non-zero processes take part in staging but never write the state
    tree, meta.json or index.json (shared-FS race, round-2 VERDICT #4)."""
    import os

    from asr_chinese_e2e.train import checkpoint as ckpt_mod

    mgr, train_step, state, args, cfg = setup(tmp_path)
    monkeypatch.setattr(ckpt_mod, "_is_proc0", lambda: False)
    state, _ = train_step(state, *args, jax.random.PRNGKey(0))
    path = mgr.save(state, epoch=0, metric=2.0)
    mgr.wait()
    assert not os.path.exists(os.path.join(path, "state"))
    assert not os.path.exists(os.path.join(path, "meta.json"))
    assert not os.path.exists(str(tmp_path / "ckpt" / "index.json"))


def test_npz_checkpointer_roundtrips_dtypes_and_structure(tmp_path):
    """bfloat16 leaves (stored bit-cast, npz has no bfloat16) come back
    bit-exact; without a template the tree comes back as nested dicts."""
    from asr_chinese_e2e.train.checkpoint import NpzCheckpointer

    tree = {
        "w": jnp.asarray(np.random.RandomState(0).randn(3, 4), jnp.bfloat16),
        "inner": {"step": jnp.asarray(7, jnp.int32), "x": jnp.ones((2,))},
    }
    ck = NpzCheckpointer()
    path = str(tmp_path / "state")
    ck.save(path, tree)
    ck.wait_until_finished()
    back = ck.restore(path, tree)
    assert back["w"].dtype == jnp.bfloat16
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    raw = ck.restore(path)
    assert set(raw) == {"w", "inner"} and set(raw["inner"]) == {"step", "x"}
    assert int(raw["inner"]["step"]) == 7


def test_npz_checkpointer_commit_is_atomic_and_errors_surface(tmp_path):
    """The tree is written to ``state.tmp`` and renamed when complete; a
    failed background write is raised by the next wait."""
    from asr_chinese_e2e.train.checkpoint import NpzCheckpointer

    ck = NpzCheckpointer()
    path = str(tmp_path / "state")
    ck.save(path, {"a": jnp.zeros((2,))})
    ck.wait_until_finished()
    import os

    assert os.path.isdir(path) and not os.path.exists(path + ".tmp")
    (tmp_path / "blocker").write_text("")  # a file where a directory must go
    ck.save(str(tmp_path / "blocker" / "state"), {"a": jnp.zeros((2,))})
    with pytest.raises(OSError):
        ck.wait_until_finished()
