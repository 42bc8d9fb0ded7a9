"""Ring attention: context parallelism over the ``seq`` mesh axis.

The long-context scaling story (SURVEY §5.7): K/V blocks rotate around the
ring via ``lax.ppermute`` (point-to-point over NVLink, via NCCL) while every device
computes attention for its local Q block, combining partial results with
online-softmax corrections. After N-1 rotations each Q block has attended
to every K/V block; communication overlaps compute and totals one
all-gather's worth of bytes.

Provided as the CP primitive for utterances long enough to shard over
``seq`` (AISHELL audio is short — the mesh axis exists, this op is off by
default; the reference's only long-context mechanisms are LFR stacking and
a ±50-frame attention band, SURVEY §2.8).

Use inside ``shard_map`` with Q/K/V sharded over ``axis_name`` on their
sequence dims. Masking: pass per-device key-validity lengths; the block
bias is rebuilt each rotation from the source shard's global offset.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

NEG_INF = -1e9


def ring_attention(
    q: jnp.ndarray,  # (B, Tq_local, H, D)
    k: jnp.ndarray,  # (B, Tk_local, H, D)
    v: jnp.ndarray,  # (B, Tk_local, H, D)
    key_valid: jnp.ndarray,  # (B,) GLOBAL valid key count
    axis_name: str,
    scale: float | None = None,
) -> jnp.ndarray:
    """Length-masked ring attention. Returns (B, Tq_local, H, D)."""
    n = jax.lax.psum(1, axis_name)
    my_idx = jax.lax.axis_index(axis_name)
    tk = k.shape[1]
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)

    def block_bias(source_idx):
        # global positions of the current K/V block
        pos = source_idx * tk + jnp.arange(tk)  # (Tk,)
        valid = pos[None, :] < key_valid[:, None]  # (B, Tk)
        return jnp.where(valid, 0.0, NEG_INF)[:, None, None, :]  # (B,1,1,Tk)

    m = jnp.full(q.shape[:2] + (q.shape[2], 1), NEG_INF, jnp.float32)  # (B,Tq,H,1)
    l = jnp.zeros_like(m)
    acc = jnp.zeros(q.shape, jnp.float32)

    def step(carry, step_idx):
        m, l, acc, k_blk, v_blk = carry
        source = (my_idx - step_idx) % n
        s = (
            jnp.einsum(
                "bqhd,bkhd->bqhk", q, k_blk, preferred_element_type=jnp.float32
            )
            * scale
        )
        s = s + block_bias(source)  # (B,1,1,Tk) broadcasts over (B,Tq,H,Tk)
        m_curr = jnp.max(s, axis=-1, keepdims=True)
        m_next = jnp.maximum(m, m_curr)
        alpha = jnp.exp(m - m_next)
        p = jnp.exp(s - m_next)
        l_next = alpha * l + jnp.sum(p, axis=-1, keepdims=True)
        acc_next = alpha * acc + jnp.einsum(
            "bqhk,bkhd->bqhd", p.astype(v_blk.dtype), v_blk,
            preferred_element_type=jnp.float32,
        )
        perm = [(i, (i + 1) % n) for i in range(n)]
        k_blk = jax.lax.ppermute(k_blk, axis_name, perm)
        v_blk = jax.lax.ppermute(v_blk, axis_name, perm)
        return (m_next, l_next, acc_next, k_blk, v_blk), None

    (m, l, acc, _, _), _ = jax.lax.scan(
        step, (m, l, acc, k, v), jnp.arange(n)
    )
    l = jnp.where(l == 0.0, 1.0, l)
    return (acc / l).astype(q.dtype)
