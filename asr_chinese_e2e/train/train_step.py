"""The jitted train/eval steps — the framework's hot loop.

Replaces ``model.iterate`` (``transformer_official.py:96-104``) and the
per-batch device traffic of the reference hot loop (SURVEY §3.2) with a
device-first design:

- ONE jitted function per bucket shape does fbank → model → loss → grads →
  clip → Adam/Noam update; XLA fuses the whole thing and inserts the DP
  gradient reduction (batch sharded over mesh axis ``data``, params
  replicated);
- feature extraction (fbank/CMVN/LFR/SpecAugment) runs INSIDE the step on
  device — the host ships raw waveforms only;
- metrics come back as a handful of scalars; CER is computed on host only
  at eval cadence (the reference's per-step CER sync,
  ``transformer_official.py:87-91``, is a throughput bug SURVEY §3.2 flags
  — deliberately not replicated);
- nan-loss guard mirrors ``example_model.py:34-35`` but device-side: the
  trainer checks the returned loss.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import optax

from ..core.config import Config
from ..data.features import FeatureConfig, parse_batch
from ..losses import model_loss, resolve_ctc_impl


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Any
    opt_state: Any
    step: jnp.ndarray  # scalar int32
    # Cumulative per-metric sums (each value weighted by batch size) plus
    # the sample count under "_n" — accumulated ON DEVICE by train_step so
    # a log window costs ONE tiny fetch of ~8 scalars with host-side
    # diffs, instead of one fetch per step and metric (the reference
    # fetches per step, SURVEY §3.2). f32 drift is bounded by re-zeroing
    # each epoch (Trainer.train_epoch prologue).
    metric_sums: Any

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def resolved_routes(cfg: Config) -> dict:
    """The implementation each configurable operation resolves to on this
    backend — recorded in the trainer's config dump and in bench output."""
    return {
        "ctc": resolve_ctc_impl(cfg.get("ctc_impl", "auto")),
        "attention": cfg.get("attn_impl", "xla"),
    }


def make_step_fns(
    model,
    tx: optax.GradientTransformation,
    feat_cfg: FeatureConfig,
    cfg: Config,
    raw_features: bool = False,
):
    """Build (init_fn, train_step, eval_step).

    ``raw_features=True`` feeds precomputed features instead of waveforms
    (used by tests and feature-cached pipelines)."""

    ctc_weight = float(cfg.get("ctc_weight", 0.0))
    smoothing = float(cfg.get("label_smoothing", 0.0))
    use_specaug = bool(cfg.get("spec_augment", False))
    ctc_impl = resolve_ctc_impl(cfg.get("ctc_impl", "auto"))
    grad_accum = int(cfg.get("grad_accum", 1))

    def featurize(wave, wave_lengths, rng, augment):
        if raw_features:
            return wave, wave_lengths
        return parse_batch(
            wave, wave_lengths, feat_cfg, augment=augment, rng=rng
        )

    def _metric_keys(out: dict) -> tuple:
        """The key set ``model_loss`` + ``train_step`` will emit, WITHOUT
        running the losses (mirrors ``losses.model_loss``'s branch logic —
        ``test_train_step`` asserts the two stay in sync)."""
        keys = ["loss", "grad_norm"]
        if "logits" in out and ctc_weight < 1.0:
            keys += ["ce_loss", "n_correct", "n_word"]
        if "ctc_logits" in out and ctc_weight > 0.0:
            keys += ["ctc_loss"]
        return tuple(sorted(keys))

    def _acc_add(sums: dict, metrics: dict, n: float) -> dict:
        new = {"_n": sums["_n"] + n}
        for k in sums:
            if k != "_n":
                new[k] = sums[k] + jnp.asarray(metrics[k], jnp.float32) * n
        return new

    @jax.jit  # ONE device program instead of dozens of eager dispatches
    def init_fn(rng, batch) -> TrainState:
        feats, feat_lens = featurize(
            jnp.asarray(batch["wave"]), jnp.asarray(batch["wave_lengths"]), None, False
        )
        out, params = model.init_with_output(
            rng, feats, feat_lens, jnp.asarray(batch["labels"]),
            jnp.asarray(batch["label_lengths"]),
        )
        sums = {k: jnp.zeros((), jnp.float32) for k in _metric_keys(out)}
        sums["_n"] = jnp.zeros((), jnp.float32)
        return TrainState(
            params=params,
            opt_state=tx.init(params),
            step=jnp.zeros((), jnp.int32),
            metric_sums=sums,
        )

    def _grads(params, rng, wave, wave_lengths, labels, label_lengths):
        aug_rng, dropout_rng = jax.random.split(rng)
        feats, feat_lens = featurize(wave, wave_lengths, aug_rng, use_specaug)

        def loss_fn(params):
            out = model.apply(
                params,
                feats,
                feat_lens,
                labels,
                label_lengths,
                deterministic=False,
                rngs={"dropout": dropout_rng},
            )
            return model_loss(
                out, labels, label_lengths, ctc_weight, smoothing, ctc_impl
            )

        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return grads, metrics

    @functools.partial(jax.jit, donate_argnums=(0,))
    def train_step(state: TrainState, wave, wave_lengths, labels, label_lengths, rng):
        rng = jax.random.fold_in(rng, state.step)
        if grad_accum == 1:
            grads, metrics = _grads(
                state.params, rng, wave, wave_lengths, labels, label_lengths
            )
        else:
            # microbatch scan: grads averaged over ``grad_accum`` slices of
            # the batch (counting metrics summed, losses averaged). Trades
            # step time for activation memory — the deep-encoder /
            # long-utterance knob alongside ``remat``.
            #
            # Semantics: microbatches are EQUAL-weighted. When per-micro-
            # batch valid-token counts differ (CE ignore_index / CTC length
            # normalisation), this differs slightly from the full-batch
            # token-weighted mean — same convention as most DDP trainers.
            if wave.shape[0] % grad_accum:
                raise ValueError(
                    f"batch size {wave.shape[0]} is not divisible by "
                    f"grad_accum={grad_accum}"
                )
            mb = lambda x: x.reshape(
                (grad_accum, x.shape[0] // grad_accum) + x.shape[1:]
            )
            rngs = jax.random.split(rng, grad_accum)

            def micro(acc, xs):
                r, w, wl, lb, ll = xs
                g, m = _grads(state.params, r, w, wl, lb, ll)
                return jax.tree_util.tree_map(jnp.add, acc, g), m

            zero = jax.tree_util.tree_map(jnp.zeros_like, state.params)
            grads, mstack = jax.lax.scan(
                micro,
                zero,
                (rngs, mb(wave), mb(wave_lengths), mb(labels), mb(label_lengths)),
            )
            grads = jax.tree_util.tree_map(lambda g: g / grad_accum, grads)
            metrics = {
                k: (jnp.sum(v, 0) if k in ("n_correct", "n_word") else jnp.mean(v, 0))
                for k, v in mstack.items()
            }
        metrics["grad_norm"] = optax.global_norm(grads)
        updates, new_opt_state = tx.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        new_state = TrainState(
            params=new_params,
            opt_state=new_opt_state,
            step=state.step + 1,
            metric_sums=_acc_add(
                state.metric_sums, metrics, float(wave.shape[0])
            ),
        )
        return new_state, metrics

    @jax.jit
    def eval_step(params, wave, wave_lengths, labels, label_lengths):
        feats, feat_lens = featurize(wave, wave_lengths, None, False)
        out = model.apply(params, feats, feat_lens, labels, label_lengths)
        _, metrics = model_loss(
            out, labels, label_lengths, ctc_weight, smoothing, ctc_impl
        )
        if "logits" in out:
            # teacher-forced argmax ids for host-side CER at eval cadence
            # (metric parity: transformer_official.py:87-94)
            metrics["pred_ids"] = jnp.argmax(out["logits"], axis=-1)
            metrics["gold_ids"] = out["gold"]
        return metrics

    return init_fn, train_step, eval_step


def make_multi_step(train_step):
    """k train steps in ONE jitted dispatch (``steps_per_dispatch``).

    Takes batches stacked on a leading axis — ``wave: (k, B, samples)``
    etc. — scans ``train_step`` over them and returns ``(state, metrics)``
    with every metric stacked ``(k,)`` so per-step logging fidelity is
    preserved. Amortizes per-dispatch host/runtime latency. The
    per-step RNG streams are identical to k sequential ``train_step``
    calls: the step folds ``state.step`` into the key itself.
    """

    @functools.partial(jax.jit, donate_argnums=(0,))
    def multi_step(state, wave, wave_lengths, labels, label_lengths, rng):
        def body(st, xs):
            w, wl, lb, ll = xs
            return train_step(st, w, wl, lb, ll, rng)

        return jax.lax.scan(
            body, state, (wave, wave_lengths, labels, label_lengths)
        )

    return multi_step
