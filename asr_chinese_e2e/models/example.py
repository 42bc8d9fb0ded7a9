"""Null model: exercises the full trainer loop with trivial compute.

Parity with ``Predictor/Models/example_model.py:9-66`` — a smoke-test
model whose forward is (almost) identity and whose loss is a simple
differentiable scalar, used to test the harness end-to-end without real
modelling."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.config import Config
from . import nn
from .transformer import preprocess_targets


def default_config() -> Config:
    return Config(
        embedding_size=100,  # example_model.py:44-51
        hidden_size=300,
        input_dim=320,
        ctc_weight=0.0,
        label_smoothing=0.0,
        max_target_len=128,
        dtype="float32",
    )


class ExampleModel(nn.Module):
    cfg: Config
    vocab_size: int

    def __call__(self, feats, feat_lengths, labels, label_lengths, deterministic=True):
        pooled = jnp.mean(feats, axis=1)  # (B, D)
        h = nn.Dense(self.cfg.hidden_size)(pooled)
        h = jax.nn.relu(h)
        ys_in, ys_out = preprocess_targets(labels, label_lengths)
        logits = nn.Dense(self.vocab_size)(h)[:, None, :]
        logits = jnp.broadcast_to(
            logits, (feats.shape[0], ys_out.shape[1], self.vocab_size)
        )
        return {"logits": logits, "gold": ys_out}
