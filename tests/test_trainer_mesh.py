"""Trainer integration with a device mesh (8 virtual CPU devices)."""

import jax
import numpy as np

from asr_chinese_e2e.parallel.sharding import (
    initialize_distributed,
    make_mesh,
    put_host_batch,
)

from tests.test_trainer_e2e import corpus, make_trainer  # noqa: F401


def test_initialize_distributed_single_process():
    n, i = initialize_distributed()
    assert n == 1 and i == 0


def test_put_host_batch_shards_over_data():
    mesh = make_mesh()
    batch = {
        "wave": np.zeros((8, 100), np.float32),
        "labels": np.zeros((8, 4), np.int32),
    }
    out = put_host_batch(mesh, batch)
    assert not out["wave"].sharding.is_fully_replicated
    assert out["wave"].sharding.shard_shape((8, 100)) == (1, 100)


def test_trainer_trains_on_mesh(corpus, tmp_path):  # noqa: F811
    trainer2, _ = make_trainer(corpus, str(tmp_path / "exp_mesh"), num_epoch=1)
    from asr_chinese_e2e.train.trainer import Trainer

    mesh = make_mesh(data=4)  # batch_size 4 -> 1 utt per data shard
    t = Trainer(
        trainer2.model, trainer2.tx, trainer2.cfg, trainer2.feat_cfg,
        trainer2.vocab,
        train_loader=trainer2.train_loader,
        dev_loader=trainer2.dev_loader,
        test_loader=None,
        mesh=mesh,
    )
    t.train()
    assert int(t.state.step) == 6
    # params ended up replicated across the mesh and finite
    leaf = jax.tree_util.tree_leaves(t.state.params)[0]
    assert np.isfinite(np.asarray(leaf)).all()
