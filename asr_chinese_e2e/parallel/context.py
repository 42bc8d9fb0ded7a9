"""Trace-time mesh context for custom kernels.

Pallas kernels are opaque to GSPMD: under a multi-device ``jit`` an
unannotated ``pallas_call`` forces XLA to gather its operands onto every
device. The fix is ``jax.shard_map`` — but the call sites live inside
models and losses that know nothing about devices. This module carries
the active mesh as trace-time context: the trainer / bench / dryrun set
it (``with active_mesh(mesh): ...``) around tracing, and the code that
needs it consults it: the CTC kernel (``ops/ctc_pallas.ctc_loss_kernel``)
shards its batch over ``data`` with zero communication, and ring
attention (``MultiHeadAttention.ring``) rotates K/V over ``seq``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

from jax.sharding import Mesh

_ACTIVE: list = []


@contextlib.contextmanager
def active_mesh(mesh: Optional[Mesh]):
    """Set the mesh custom kernels shard over (trace-time; nestable)."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def get_active_mesh() -> Optional[Mesh]:
    return _ACTIVE[-1] if _ACTIVE else None
