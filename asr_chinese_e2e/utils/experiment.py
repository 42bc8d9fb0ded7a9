"""Experiment loading: rebuild model + params from a saved experiment dir.

The reference's inference entry is an unfinished stub
(``Predictor/predictor.py:7-35`` — ``load_model`` returns None). This module
provides the real thing: config.json + checkpoint tree + vocab fingerprint
check (the content of the reference's richest checkpoint schema,
``transformer.py:86-117``).
"""

from __future__ import annotations

import os
from typing import Tuple

import jax
import numpy as np

from ..core.config import Config
from ..core.registry import get_model
from ..data.features import FeatureConfig
from ..data.vocab import Vocab
from ..train.checkpoint import CheckpointManager
from ..train.optimizer import make_optimizer
from ..train.train_step import make_step_fns


def feature_config_from(cfg: Config) -> FeatureConfig:
    """The ONE cfg→FeatureConfig mapping (training and decode must agree:
    dropping a knob here would decode with different features than the
    model was trained on — e.g. MFCC or per-dim CMVN experiments)."""
    return FeatureConfig(
        sample_rate=cfg.get("sample_rate", 16000),
        n_mels=cfg.get("n_mels", 80),
        lfr_m=cfg.get("lfr_m", 4),
        lfr_n=cfg.get("lfr_n", 3),
        feature_type=cfg.get("feature_type", "fbank"),
        n_mfcc=cfg.get("n_mfcc", 40),
        cmvn_mode=cfg.get("cmvn_mode", "global"),
        cmvn_mean=cfg.get("cmvn_mean", 0.0),
        cmvn_std=cfg.get("cmvn_std", 1.0),
        use_delta=cfg.get("use_delta", False),
        use_delta_delta=cfg.get("use_delta_delta", False),
        freq_mask_param=cfg.get("freq_mask_param", 30),
        time_mask_param=cfg.get("time_mask_param", 40),
        num_freq_masks=cfg.get("num_freq_masks", 1),
        num_time_masks=cfg.get("num_time_masks", 1),
        num_time_warps=cfg.get("num_time_warps", 0),
        time_warp_param=cfg.get("time_warp_param", 5),
    )


def load_experiment(
    exp_dir: str, vocab_path: str, which: str = "best"
) -> Tuple[object, dict, Config, FeatureConfig, Vocab]:
    """Returns (model, params, cfg, feat_cfg, vocab)."""
    cfg = Config.load(os.path.join(exp_dir, "config.json"))
    vocab = Vocab.load(vocab_path)
    model_cls, _ = get_model(cfg.get("model_name", "SpeechTransformer"))
    model = model_cls(cfg, vocab.vocab_size)
    feat_cfg = feature_config_from(cfg)

    tx = make_optimizer(cfg, cfg.get("d_model", cfg.get("hidden_size", 512)))
    init_fn, _, _ = make_step_fns(model, tx, feat_cfg, cfg)
    dummy = {
        "wave": np.zeros((1, feat_cfg.sample_rate), np.float32),
        "wave_lengths": np.asarray([feat_cfg.sample_rate], np.int32),
        "labels": np.zeros((1, 4), np.int32),
        "label_lengths": np.asarray([1], np.int32),
    }
    template = init_fn(jax.random.PRNGKey(0), dummy)

    mgr = CheckpointManager(os.path.join(exp_dir, "checkpoints"))
    try:
        state, meta = mgr.restore(which, template=template)
    except FileNotFoundError:
        if which == "best":  # fall back if no metric was ever recorded
            state, meta = mgr.restore("latest", template=template)
        else:
            raise
    fp = meta.get("vocab_fingerprint")
    if fp is not None and fp != vocab.fingerprint():
        raise ValueError(
            f"vocab fingerprint mismatch: checkpoint {fp} vs {vocab.fingerprint()}"
        )
    return model, state.params, cfg, feat_cfg, vocab
