"""CTC loss with the alpha/beta recursions as Pallas GPU kernels (Triton
route) and an exact fused backward (custom VJP).

The recursions are sequential in T with tiny per-step work on a (2L+1)
row. As a ``lax.scan`` (``ops/ctc.py``) each step is at least one kernel
launch and autodiff replays the scan backwards; here each recursion is
ONE kernel:

- one program per utterance; the time loop (``lax.fori_loop``) runs inside
  the kernel with the row held in registers;
- the row S = 2L+1 is padded to a power of two; the shifts by one and two
  lanes go through a per-utterance row in global memory (store, block
  barrier, reload at an offset), since Triton has no in-register shift;
- emission log-probs are gathered OUTSIDE the kernel by a one-hot matmul
  at HIGHEST precision, so the kernel streams (S,) rows instead of the
  (B, T, C) posterior table;
- each row is shifted by its max every step, so values stay near zero;
- the forward pass runs only the alpha kernel; the beta kernel runs in the
  backward pass, and the posterior ``gamma``, the (B, T, S) -> (B, T, C)
  scatter and the log-softmax chain rule are XLA einsums + elementwise.

``interpret=True`` runs the same kernels in the Pallas interpreter (the
CPU tests); without it the kernels need a GPU and raise elsewhere.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from jax.sharding import PartitionSpec as P

from ..parallel.context import get_active_mesh
from .ctc import BIG_NEG, extend_labels


def padded_width(s: int) -> int:
    """Power-of-two row width (at least one warp) for an S-wide row."""
    return max(32, 1 << (s - 1).bit_length())


def _lse(a, b):
    m = jnp.maximum(a, b)
    return m + jnp.log1p(jnp.exp(-jnp.abs(a - b)))


def _alpha_kernel(emit_ref, skip_ref, len_ref, alpha_ref, norm_ref, work_ref,
                  *, interpret):
    """emit_ref (B, T, Sp) -> alpha_ref (B, T, Sp), each row shifted by its
    max so it stays near zero; ``norm_ref`` (B,) gets the sum of those
    shifts over the utterance's frames (log alpha = row + norm at the last
    frame). ``work_ref`` (B, 2Sp) holds [-inf, -inf, alpha_{t-1}] so
    loads at offsets 1 and 0 read the row shifted right by one and two
    lanes."""
    b = pl.program_id(0)
    t_max, sp = emit_ref.shape[1], emit_ref.shape[2]
    sync = (lambda: None) if interpret else plt.debug_barrier
    s_idx = jax.lax.iota(jnp.int32, sp)
    skip = skip_ref[b, :] > 0
    n = len_ref[b]
    alpha = jnp.where(s_idx <= 1, emit_ref[b, 0, :], BIG_NEG)
    norm = jnp.max(alpha)
    alpha = alpha - norm
    work_ref[b, pl.ds(0, 2)] = jnp.full((2,), BIG_NEG, jnp.float32)
    work_ref[b, pl.ds(2, sp)] = alpha
    alpha_ref[b, 0, :] = alpha

    def step(t, carry):
        alpha, norm = carry
        sync()
        stay = _lse(alpha, work_ref[b, pl.ds(1, sp)])
        new = jnp.where(skip, _lse(stay, work_ref[b, pl.ds(0, sp)]), stay)
        new = new + emit_ref[b, t, :]
        m = jnp.max(new)
        live = t < n
        alpha = jnp.where(live, new - m, alpha)
        norm = norm + jnp.where(live, m, 0.0)
        sync()
        work_ref[b, pl.ds(2, sp)] = alpha
        alpha_ref[b, t, :] = alpha
        return alpha, norm

    _, norm = jax.lax.fori_loop(1, t_max, step, (alpha, norm))
    norm_ref[b] = norm


def _beta_kernel(emit_ref, skip2_ref, len_ref, last_ref, beta_ref, work_ref,
                 *, interpret):
    """Reverse recursion. beta' includes emit[t] (beta'[t] = beta[t] +
    emit[t]), folding the emission factor into the carried row, so
    gamma = alpha + beta' - emit. Live rows are shifted by their max like
    alpha's; rows past the utterance stay log-zero. ``work_ref`` (B, 2Sp)
    holds [beta'_{t+1}, -inf, ...] so loads at offsets 1 and 2 read the
    row shifted left; ``skip2_ref`` is the skip mask shifted left by two
    (the skip transition's target lane)."""
    b = pl.program_id(0)
    t_max, sp = emit_ref.shape[1], emit_ref.shape[2]
    sync = (lambda: None) if interpret else plt.debug_barrier
    s_idx = jax.lax.iota(jnp.int32, sp)
    skip2 = skip2_ref[b, :] > 0
    n = len_ref[b]
    last = last_ref[b]
    final = (s_idx == last) | (s_idx == jnp.maximum(last - 1, 0))
    beta = jnp.full((sp,), BIG_NEG, jnp.float32)
    work_ref[b, pl.ds(0, sp)] = beta
    work_ref[b, pl.ds(sp, sp)] = beta

    def step(r, beta):
        t = t_max - 1 - r
        emit = emit_ref[b, t, :]
        sync()
        stay = _lse(beta, work_ref[b, pl.ds(1, sp)])
        new = jnp.where(skip2, _lse(stay, work_ref[b, pl.ds(2, sp)]), stay)
        row = jnp.where(t == n - 1, jnp.where(final, emit, BIG_NEG), new + emit)
        beta = jnp.where(t < n, row - jnp.max(row), BIG_NEG)
        sync()
        work_ref[b, pl.ds(0, sp)] = beta
        beta_ref[b, t, :] = beta
        return beta

    jax.lax.fori_loop(0, t_max, step, beta)


def _num_warps(sp: int) -> int:
    return max(1, min(4, sp // 128))


def _recursion(kernel, emit, *rows, extra_out=(), interpret):
    """Run ``kernel`` with one program per utterance; returns its (B, T,
    Sp) rows plus ``extra_out`` outputs (the (B, 2Sp) work rows are
    dropped)."""
    bsz, t_max, sp = emit.shape
    f32 = jnp.float32
    outs = pl.pallas_call(
        functools.partial(kernel, interpret=interpret),
        grid=(bsz,),
        out_shape=(
            jax.ShapeDtypeStruct((bsz, t_max, sp), f32),
            *extra_out,
            jax.ShapeDtypeStruct((bsz, 2 * sp), f32),
        ),
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=_num_warps(sp), num_stages=1
        ),
        interpret=interpret,
        name=kernel.__name__.strip("_"),
    )(emit, *rows)
    return outs[:-1]


def _skip_mask(ext: jnp.ndarray, blank_id: int) -> jnp.ndarray:
    b = ext.shape[0]
    return jnp.concatenate(
        [
            jnp.zeros((b, 2), jnp.int32),
            ((ext[:, 2:] != blank_id) & (ext[:, 2:] != ext[:, :-2])).astype(
                jnp.int32
            ),
        ],
        axis=1,
    )


def _check_route(interpret: bool) -> None:
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the Pallas CTC kernel compiles for the GPU only; on "
            f"{jax.default_backend()!r} use ctc_impl='scan' (or "
            "interpret=True to run it in the Pallas interpreter)"
        )


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5))
def ctc_loss_pallas(
    logits, logit_lengths, labels, label_lengths, blank_id=0, interpret=False
):
    """Per-utterance CTC NLL — same contract as ``ops.ctc.ctc_loss`` but
    with kernel recursions and an exact fused backward."""
    loss, _ = _ctc_fwd(
        logits, logit_lengths, labels, label_lengths, blank_id, interpret
    )
    return loss


def _emissions(logits, labels, blank_id):
    """(B, T, Sp) label-indexed log-probs, log-zero in padded lanes; plus
    the per-frame logsumexp and the extended labels."""
    c = logits.shape[-1]
    logits32 = logits.astype(jnp.float32)
    # emit[b,t,s] = log_softmax(logits)[b,t,ext[b,s]] computed WITHOUT
    # materializing the (B, T, C) f32 log-prob tensor: the label gather is
    # a one-hot matmul (exact — each row sums one nonzero product) minus
    # the logsumexp
    lse = jax.scipy.special.logsumexp(logits32, axis=-1)  # (B, T)
    ext = extend_labels(labels, blank_id)  # (B, S)
    onehot = jax.nn.one_hot(ext, c, dtype=jnp.float32)  # (B, S, C)
    # HIGHEST precision: a default f32 matmul may round its inputs (TF32
    # on the GPU), which would shift the selected log-probs — the
    # selection must be exact for the alpha/beta recursions
    emit = (
        jnp.einsum(
            "btc,bsc->bts", logits32, onehot,
            precision=jax.lax.Precision.HIGHEST,
        )
        - lse[:, :, None]
    )
    s = ext.shape[1]
    emit = jnp.pad(
        emit, ((0, 0), (0, 0), (0, padded_width(s) - s)),
        constant_values=BIG_NEG,
    )
    return emit, lse, ext


def _pad_lanes(x, sp):
    return jnp.pad(x, ((0, 0), (0, sp - x.shape[1])))


def _ctc_fwd(logits, logit_lengths, labels, label_lengths, blank_id, interpret):
    _check_route(interpret)
    bsz = logits.shape[0]
    emit, lse, ext = _emissions(logits, labels, blank_id)
    sp = emit.shape[2]
    lengths = logit_lengths.astype(jnp.int32)
    last = (2 * label_lengths).astype(jnp.int32)
    skip = _pad_lanes(_skip_mask(ext, blank_id), sp)
    alpha, norm = _recursion(
        _alpha_kernel, emit, skip, lengths,
        extra_out=(jax.ShapeDtypeStruct((bsz,), jnp.float32),),
        interpret=interpret,
    )
    a_final = alpha[jnp.arange(bsz), jnp.maximum(lengths - 1, 0)]  # (B, Sp)
    a_last = jnp.take_along_axis(a_final, last[:, None], axis=1)[:, 0]
    prev = jnp.maximum(last - 1, 0)
    a_prev = jnp.take_along_axis(a_final, prev[:, None], axis=1)[:, 0]
    a_prev = jnp.where(last > 0, a_prev, BIG_NEG)
    loss = -(jnp.logaddexp(a_last, a_prev) + norm)
    residuals = (logits, lse, alpha, emit, ext, skip, lengths, last)
    return loss, residuals


def _ctc_bwd(blank_id, interpret, residuals, g):
    logits, lse, alpha, emit, ext, skip, lengths, last = residuals
    t_max, c = logits.shape[1], logits.shape[2]
    s = ext.shape[1]
    skip2 = jnp.pad(skip[:, 2:], ((0, 0), (0, 2)))
    (beta,) = _recursion(
        _beta_kernel, emit, skip2, lengths, last, interpret=interpret
    )
    # gamma = log(alpha * beta / emit) up to a per-frame constant (beta'
    # includes emit[t]; both rows are max-shifted). For every frame the
    # posteriors sum to one (sum_s alpha_t beta_t / y_t = p for all t), so
    # normalizing each frame over s recovers them exactly — no large
    # log-likelihood is added and cancelled, which keeps float32 error
    # small at any T.
    gamma = (alpha + beta - emit)[:, :, :s]  # (B, T, S)
    z = jax.nn.softmax(gamma, axis=-1)
    z = jnp.where(jnp.arange(t_max)[None, :, None] < lengths[:, None, None], z, 0.0)
    # scatter (B, T, S) -> (B, T, C): one-hot matmul
    onehot = jax.nn.one_hot(ext, c, dtype=z.dtype)  # (B, S, C)
    d_logp = -jnp.einsum(
        "bts,bsc->btc", z, onehot, precision=jax.lax.Precision.HIGHEST
    )
    # chain through log_softmax: d_logits = d_logp - softmax * sum_c d_logp
    # (softmax recomputed from logits + logsumexp — cheaper than carrying
    # the f32 log-prob tensor as a residual)
    softmax = jnp.exp(logits.astype(jnp.float32) - lse[:, :, None])
    d_logits = d_logp - softmax * jnp.sum(d_logp, axis=-1, keepdims=True)
    d_logits = d_logits * g[:, None, None]
    # cotangent dtype mirrors the primal: a bf16 model gets a bf16 (B, T, C)
    # grad, matching every other activation grad's precision
    return (d_logits.astype(logits.dtype), None, None, None)


ctc_loss_pallas.defvjp(_ctc_fwd, _ctc_bwd)


def ctc_loss_kernel(
    logits, logit_lengths, labels, label_lengths, blank_id=0, interpret=False
):
    """``ctc_loss_pallas`` with its batch split over the active mesh's
    ``data`` axis (``parallel/context.py``): each device runs the kernel
    on its own rows, where XLA alone would gather the whole batch onto
    every device around the opaque kernel call."""
    mesh = get_active_mesh()
    if mesh is None or mesh.shape.get("data", 1) == 1:
        return ctc_loss_pallas(
            logits, logit_lengths, labels, label_lengths, blank_id, interpret
        )
    spec = P("data")
    return jax.shard_map(
        lambda *a: ctc_loss_pallas(*a, blank_id, interpret),
        mesh=mesh,
        in_specs=(spec,) * 4,
        out_specs=spec,
        check_vma=False,
    )(logits, logit_lengths, labels, label_lengths)
