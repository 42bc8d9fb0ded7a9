"""Optimizer: Adam + Noam warmup schedule + global-norm clipping.

Parity with the reference training setup:
- Noam LR ``factor * d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)``
  (``Trainer/optimizer.py:24-28``; step counts from 1);
- Adam betas (0.9, 0.98), eps 1e-9 (``main.py:81-83``), warmup 4000
  (``main.py:103``);
- global-norm grad clip 5.0 (``transformer_official.py:102``) — folded into
  the optax chain instead of a separate call;
- AnnealingOpt (lr /= k stepper, ``Trainer/optimizer.py:49-60``) provided as
  the ``anneal`` schedule option.

The schedule step is part of optax's opt_state, so checkpoints restore the
LR trajectory exactly (the reference persists ``_step`` for the same reason,
``Trainer/optimizer.py:33-46``).
"""

from __future__ import annotations

import optax

from ..core.config import Config


def noam_schedule(d_model: int, warmup: int, factor: float = 1.0):
    def schedule(count):
        import jax.numpy as jnp

        step = (count + 1) * 1.0  # optax counts from 0; Noam from 1
        return (
            factor
            * (d_model ** -0.5)
            * jnp.minimum(step ** -0.5, step * (warmup ** -1.5))
        )

    return schedule


def anneal_schedule(lr: float, anneal: float, steps_per_anneal: int):
    """AnnealingOpt semantics: lr divided by ``anneal`` every interval."""

    def schedule(count):
        import jax.numpy as jnp

        k = count // steps_per_anneal
        return lr / jnp.power(anneal, k)

    return schedule


def default_train_config() -> Config:
    """Trainer/optimizer knobs with reference defaults (``main.py:15-35,103``)."""
    return Config(
        lr=3e-4,
        adam_b1=0.9,
        adam_b2=0.98,
        adam_eps=1e-9,
        warmup=4000,
        noam_factor=1.0,
        lr_schedule="noam",  # noam | anneal | constant
        anneal_factor=1.1,
        anneal_every=10000,
        grad_clip=5.0,
        batch_size=64,
        num_epoch=200,
        log_every_iter=100,
        eval_every_iter=5000,
        save_every_iter=5000,
        reference="-loss",  # best-checkpoint criterion (trainer11.py:26,43)
        seed=0,
        # PRNG for dropout/SpecAugment. "rbg" is XLA's RngBitGenerator
        # (cheaper mask generation than threefry at this model size);
        # "threefry2x32" for bit-exact reproducibility across platforms
        # and shardings.
        rng_impl="rbg",
        exp_root="ckpt",
        exp_name=None,
    )


def make_schedule(cfg: Config, d_model: int):
    if cfg.lr_schedule == "noam":
        return noam_schedule(d_model, cfg.warmup, cfg.noam_factor)
    if cfg.lr_schedule == "anneal":
        return anneal_schedule(cfg.lr, cfg.anneal_factor, cfg.anneal_every)
    return lambda count: cfg.lr


def noam_peak_lr(d_model: int, warmup: int, factor: float = 1.0) -> float:
    """The schedule's maximum (reached at step == warmup)."""
    return factor * d_model ** -0.5 * warmup ** -0.5


# Measured (CPU A/B runs + a flagship soak): Noam peaks much
# above the reference recipe's 7e-4 (warmup 4000, d 512) stall the
# attention decoder — TF accuracy pins at ~28% (pre-LN) or the uniform
# plateau (post-LN) while CTC still converges. Compressed-warmup runs
# must scale noam_factor down to keep the peak in the trainable band.
NOAM_PEAK_WARN = 2e-3


def make_optimizer(cfg: Config, d_model: int) -> optax.GradientTransformation:
    if cfg.get("lr_schedule") == "noam":
        peak = noam_peak_lr(d_model, cfg.warmup, cfg.noam_factor)
        if peak > NOAM_PEAK_WARN:
            import warnings

            warnings.warn(
                f"Noam peak LR {peak:.2e} (noam_factor/sqrt(d_model*warmup)) "
                f"exceeds {NOAM_PEAK_WARN:.0e} — measured to stall attention-"
                "decoder learning at flagship depth; lower "
                "noam_factor or raise warm_up so the peak lands near the "
                "reference recipe's 7e-4.",
                stacklevel=2,
            )
    schedule = make_schedule(cfg, d_model)
    tx = optax.chain(
        optax.clip_by_global_norm(cfg.grad_clip),
        optax.adam(
            learning_rate=schedule,
            b1=cfg.adam_b1,
            b2=cfg.adam_b2,
            eps=cfg.adam_eps,
        ),
    )
    if cfg.get("flat_optimizer", False):
        # run clip+Adam over ONE flat parameter vector instead of ~200
        # per-leaf fusions — fewer tiny device ops in the update tail.
        # Incompatible with tensor-parallel training: the flat moment
        # vector cannot mirror per-param shardings (state_shardings).
        tx = optax.flatten(tx)
    return tx


def current_lr(cfg: Config, d_model: int, step: int) -> float:
    """Host-side LR readout for logging (reference logs lr each iter,
    ``trainer11.py:58-59``)."""
    import jax.numpy as jnp

    return float(make_schedule(cfg, d_model)(jnp.asarray(step)))
