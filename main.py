#!/usr/bin/env python
"""Training CLI.

Parity with the reference entry point (``main.py:55-103``): three-stage
config merge (data/train defaults → model defaults → CLI kwargs, CLI wins,
unknown keys added), string model selection via the registry, then the
trainer. The reference's exact invocation style keeps working:

    python main.py --model_name TransformerOffical --lr 3e-4 \
        --batch_size 64 --warm_up 4000 --num_epoch 200

New (finishing main.py:28's TODO): ``--from_ckpt latest|best|e{E}_s{S}``
resumes. ``--mesh_data N --mesh_model M`` lay the device mesh.
"""

from __future__ import annotations

import os
import sys

from asr_chinese_e2e.core.config import Config, resolve_config
from asr_chinese_e2e.core.registry import get_model
from asr_chinese_e2e.data.batching import BucketedLoader
from asr_chinese_e2e.data.vocab import Vocab
from asr_chinese_e2e.train.optimizer import default_train_config, make_optimizer
from asr_chinese_e2e.train.trainer import Trainer
from asr_chinese_e2e.utils.cli import parse_kwargs


def data_config() -> Config:
    """Data-tier defaults (the ``DataConfigAiShell1`` analogue,
    ``Predictor/data_handler/data_config.py:6-19``)."""
    return Config(
        data_dir="data",
        vocab_path="data/vocab.json",
        train_manifest="data/train.jsonl",
        dev_manifest="data/dev.jsonl",
        test_manifest="data/test.jsonl",
        n_mels=80,
        lfr_m=4,
        lfr_n=3,
        sample_rate=16000,
        max_target_len=64,
        spec_augment=False,
        # raw PCM16 wire to device (half the transfer bytes; bit-exact for
        # mono audio — device scales by 1/32768 in parse_batch)
        wire_dtype="int16",
        model_name="TransformerOffical",
        from_ckpt=None,
        mesh_data=-1,
        mesh_model=1,
        mesh_seq=1,  # sequence parallelism (use with attn_impl="ring")
        num_hosts=1,
        host_id=0,
    )


def train(**cli_kwargs):
    # reference kwarg aliases
    if "warm_up" in cli_kwargs:
        cli_kwargs.setdefault("warmup", cli_kwargs.pop("warm_up"))

    # multi-host bootstrap first (before any device queries)
    if cli_kwargs.get("num_processes", 0) > 1:
        from asr_chinese_e2e.parallel.sharding import initialize_distributed

        n_hosts, host_id = initialize_distributed(
            cli_kwargs.pop("coordinator_address", None),
            cli_kwargs.pop("num_processes"),
            cli_kwargs.pop("process_id", None),
        )
        cli_kwargs.setdefault("num_hosts", n_hosts)
        cli_kwargs.setdefault("host_id", host_id)

    base = data_config().combine(default_train_config())
    model_name = cli_kwargs.get("model_name", base.model_name)
    model_cls, model_default = get_model(model_name)
    cfg = resolve_config(base, model_default(), cli_kwargs)

    # the ONE cfg→FeatureConfig mapping — shared with recognize.py's
    # load_experiment so train and decode can never disagree on features
    from asr_chinese_e2e.utils.experiment import feature_config_from

    feat_cfg = feature_config_from(cfg)
    if "input_dim" not in cli_kwargs and cfg.get("frontend", "linear") == "linear":
        cfg.build(input_dim=feat_cfg.feature_dim)

    vocab = Vocab.load(cfg.vocab_path)
    loaders = {}
    for split, manifest in (
        ("train", cfg.train_manifest),
        ("dev", cfg.dev_manifest),
        ("test", cfg.test_manifest),
    ):
        if manifest and os.path.exists(manifest):
            loaders[split] = BucketedLoader(
                manifest,
                vocab,
                batch_size=cfg.batch_size,
                max_target_len=cfg.max_target_len,
                sample_rate=cfg.sample_rate,
                shuffle=(split == "train"),
                seed=cfg.seed,
                num_hosts=cfg.num_hosts,
                host_id=cfg.host_id,
                wire_dtype=cfg.get("wire_dtype", "int16"),
                # train keeps the reference's drop_last=True (static-shape
                # discipline, ai_shell_1.py:103). Eval splits must NOT: a
                # small dev set spread over duration buckets may fill no
                # bucket to batch_size at all — an r4 soak ran every dev
                # eval on ZERO batches that way (each tail size costs one
                # extra one-time compile; coverage is worth it)
                drop_last=(split == "train"),
            )

    model = model_cls(cfg, vocab.vocab_size)
    tx = make_optimizer(cfg, cfg.get("d_model", cfg.get("hidden_size", 512)))

    mesh = None
    import jax

    n_dev = len(jax.devices())
    # mesh_data == 0 disables the mesh; -1 means "all remaining devices"
    mesh_seq = cfg.get("mesh_seq", 1)
    if cfg.mesh_data != 0 and (n_dev > 1 or cfg.mesh_model > 1 or mesh_seq > 1):
        data_size = (
            n_dev // (cfg.mesh_model * mesh_seq)
            if cfg.mesh_data == -1
            else cfg.mesh_data
        )
        if cfg.batch_size % max(data_size, 1):
            print(
                f"warning: batch_size {cfg.batch_size} not divisible by "
                f"data axis; running unsharded"
            )
        else:
            from asr_chinese_e2e.parallel.sharding import make_mesh

            mesh = make_mesh(
                data=cfg.mesh_data, model=cfg.mesh_model, seq=mesh_seq
            )

    trainer = Trainer(
        model, tx, cfg, feat_cfg, vocab,
        train_loader=loaders["train"],
        dev_loader=loaders.get("dev"),
        test_loader=loaders.get("test"),
        mesh=mesh,
    )
    trainer.train(from_ckpt=cfg.from_ckpt)
    return trainer


def main():
    _, kwargs = parse_kwargs(sys.argv[1:])
    if kwargs.pop("help", False):
        print(__doc__)
        return
    train(**kwargs)


if __name__ == "__main__":
    main()
