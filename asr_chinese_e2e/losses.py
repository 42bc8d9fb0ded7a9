"""Losses: label-smoothed cross-entropy and CTC, plus the hybrid joint.

CE parity with ``Predictor/Utils/loss.py:7-76``:
- smoothing == 0: mean CE over non-PAD targets (``loss.py:47-49``,
  ``F.cross_entropy(ignore_index=0)``);
- smoothing > 0: the reference's exact smoothing formula
  ``one_hot*(1-eps) + (1-one_hot)*eps/C`` (``loss.py:39`` — note eps/C, not
  the textbook eps/(C-1)), summed against log-softmax, masked by
  ``gold != IGNORE_ID`` and averaged over non-PAD count (``loss.py:42-45``).

CTC is net-new capability (the reference has none; BASELINE.json north star
requires the hybrid). Implemented in ``ops/ctc.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .data.vocab import IGNORE_ID
from .ops.ctc import ctc_loss


def smoothed_cross_entropy(
    logits: jnp.ndarray,
    targets: jnp.ndarray,
    smoothing: float = 0.0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """logits: (B, T, C) pre-softmax; targets: (B, T) with PAD==0 ignored.

    Returns (scalar loss, n_correct) — the (loss, n_correct) pair mirrors
    ``cal_performance`` (``loss.py:7-24``).
    """
    b, t, c = logits.shape
    logits = logits.reshape(b * t, c)
    gold = targets.reshape(b * t)
    mask = (gold != IGNORE_ID).astype(logits.dtype)
    n_word = jnp.maximum(mask.sum(), 1.0)

    log_probs = jax.nn.log_softmax(logits, axis=-1)
    gold_safe = jnp.where(gold == IGNORE_ID, 0, gold)
    nll = -jnp.take_along_axis(log_probs, gold_safe[:, None], axis=-1)[:, 0]

    if smoothing > 0.0:
        eps = smoothing
        # -(one_hot*(1-eps) + (1-one_hot)*eps/C) · log_probs, per position:
        #   (1-eps)*nll + eps/C * (-sum log_probs) - eps/C * nll_gold... expand:
        # one_hot*(1-eps - eps/C) + eps/C everywhere
        sum_lp = jnp.sum(log_probs, axis=-1)
        per_pos = (1.0 - eps - eps / c) * nll - (eps / c) * sum_lp
        loss = jnp.sum(per_pos * mask) / n_word
    else:
        loss = jnp.sum(nll * mask) / n_word

    pred = jnp.argmax(logits, axis=-1)
    n_correct = jnp.sum((pred == gold).astype(jnp.int32) * mask.astype(jnp.int32))
    return loss, n_correct


CTC_IMPLS = ("scan", "pallas", "pallas_interpret")


def resolve_ctc_impl(impl: str = "auto") -> str:
    """The CTC route a run uses: ``'auto'`` is the Pallas kernel on the GPU
    and the ``lax.scan`` recursion elsewhere; a named route is checked and
    kept (``'pallas'`` raises off the GPU; ``'pallas_interpret'`` runs the
    kernel in the Pallas interpreter, for tests)."""
    if impl == "auto":
        return "pallas" if jax.default_backend() == "gpu" else "scan"
    if impl not in CTC_IMPLS:
        raise ValueError(f"unknown ctc_impl {impl!r}: auto or one of {CTC_IMPLS}")
    if impl == "pallas" and jax.default_backend() != "gpu":
        raise ValueError(
            f"ctc_impl='pallas' needs a GPU; the backend is "
            f"{jax.default_backend()!r}"
        )
    return impl


def model_loss(
    out: dict,
    labels,
    label_lengths,
    ctc_weight: float,
    smoothing: float,
    ctc_impl: str = "scan",
):
    """Hybrid λ·CTC + (1−λ)·CE over whatever branches the model provides.

    λ==0 reduces to the reference's pure-CE objective
    (``transformer_official.py:86``); λ==1 is CTC-only (north-star #1).
    ``out``: model forward dict with optional keys ``logits``/``gold``
    (CE branch) and ``ctc_logits``/``enc_lengths`` (CTC branch)."""
    from .data.vocab import IGNORE_ID
    from .ops.ctc_pallas import ctc_loss_kernel

    metrics = {}
    loss = 0.0
    has_ce = "logits" in out and ctc_weight < 1.0
    has_ctc = "ctc_logits" in out and ctc_weight > 0.0
    if has_ce:
        ce, n_correct = smoothed_cross_entropy(out["logits"], out["gold"], smoothing)
        n_word = jnp.sum((out["gold"] != IGNORE_ID).astype(jnp.float32))
        metrics.update(ce_loss=ce, n_correct=n_correct, n_word=n_word)
        loss = loss + (1.0 - ctc_weight) * ce if has_ctc else ce
    if has_ctc:
        args = (out["ctc_logits"], out["enc_lengths"], labels, label_lengths)
        if ctc_impl == "scan":
            per_utt = ctc_loss(*args)
        else:
            per_utt = ctc_loss_kernel(
                *args, interpret=ctc_impl == "pallas_interpret"
            )
        ctc = jnp.mean(per_utt)
        metrics["ctc_loss"] = ctc
        loss = loss + ctc_weight * ctc if has_ce else ctc
    metrics["loss"] = loss
    return loss, metrics


def hybrid_loss(
    ce_logits: jnp.ndarray,
    ce_targets: jnp.ndarray,
    ctc_logits: jnp.ndarray | None,
    ctc_logit_lengths: jnp.ndarray | None,
    ctc_labels: jnp.ndarray | None,
    ctc_label_lengths: jnp.ndarray | None,
    ctc_weight: float = 0.0,
    smoothing: float = 0.0,
) -> tuple[jnp.ndarray, dict]:
    """Array-argument convenience wrapper over ``model_loss``."""
    out = {"logits": ce_logits, "gold": ce_targets}
    if ctc_logits is not None:
        out["ctc_logits"] = ctc_logits
        out["enc_lengths"] = ctc_logit_lengths
    return model_loss(
        out, ctc_labels, ctc_label_lengths, ctc_weight, smoothing, "scan"
    )
