"""Subprocess worker for test_multiprocess: a REAL 2-process
``jax.distributed`` run on CPU (round-3 VERDICT #6).

Run as  python tests/_mp_worker.py <worker_config.json> ; writes a result
JSON with the shard contents + step counters for the parent test to check.
Not named test_* so pytest never collects it.
"""

import json
import os
import sys


def main() -> None:
    with open(sys.argv[1]) as f:
        wcfg = json.load(f)

    import jax

    jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, wcfg["repo"])
    from asr_chinese_e2e.data.batching import BucketedLoader
    from asr_chinese_e2e.data.features import FeatureConfig
    from asr_chinese_e2e.data.vocab import Vocab
    from asr_chinese_e2e.models.rnn import BiLSTMCTC, default_ctc_config
    from asr_chinese_e2e.parallel.sharding import (
        initialize_distributed,
        make_mesh,
    )
    from asr_chinese_e2e.train.optimizer import (
        default_train_config,
        make_optimizer,
    )
    from asr_chinese_e2e.train.trainer import Trainer

    nproc, pid = initialize_distributed(
        coordinator_address=wcfg["coord"],
        num_processes=wcfg["num_processes"],
        process_id=wcfg["process_id"],
    )
    assert nproc == wcfg["num_processes"], (nproc, wcfg)
    assert pid == wcfg["process_id"]
    assert jax.local_device_count() == 2, jax.local_devices()
    assert jax.device_count() == 2 * nproc

    vocab = Vocab.load(wcfg["vocab"])
    feat_cfg = FeatureConfig(n_mels=20)

    def make_loader():
        return BucketedLoader(
            wcfg["manifest"], vocab, batch_size=4, max_target_len=8,
            seed=0, bucket_seconds=(1.5,), prefetch=0,
            num_hosts=nproc, host_id=pid,
        )

    # record THIS host's shard of the epoch-0 schedule (texts identify
    # records: the synth corpus makes each transcript unique)
    shard_paths, n_batches = [], 0
    for b in make_loader().epoch(0):
        n_batches += 1
        shard_paths.extend(b.texts)

    mesh = make_mesh(data=-1)
    mcfg = default_ctc_config().build(
        hidden=16, num_layers=1, input_dim=feat_cfg.feature_dim,
    )
    tcfg = default_train_config().combine(mcfg).build(
        lr_schedule="constant", lr=5e-3, batch_size=4, num_epoch=2,
        log_every_iter=2, eval_every_iter=10_000, save_every_iter=10_000,
        exp_root=wcfg["exp_root"], exp_name="mp", rng_impl="threefry2x32",
        ctc_weight=1.0, ctc_impl="scan",
    )
    model = BiLSTMCTC(mcfg, vocab.vocab_size)
    tx = make_optimizer(tcfg, 16)
    tr = Trainer(model, tx, tcfg, feat_cfg, vocab, make_loader(), mesh=mesh)
    tr.train()
    step_after_train = tr.host_step

    # resume on BOTH processes from the epoch-end checkpoint
    tcfg2 = tcfg.build(num_epoch=3)
    tr2 = Trainer(model, tx, tcfg2, feat_cfg, vocab, make_loader(), mesh=mesh)
    tr2.train(from_ckpt="latest")

    with open(wcfg["out"], "w") as f:
        json.dump({
            "pid": pid,
            "shard_paths": shard_paths,
            "n_batches": n_batches,
            "step_after_train": step_after_train,
            "step_after_resume": tr2.host_step,
            "exp_dir": tr2.exp_dir,
        }, f)
    print(f"worker {pid} ok", flush=True)


if __name__ == "__main__":
    main()
