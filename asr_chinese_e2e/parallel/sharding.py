"""Mesh construction and sharding rules.

The reference's entire parallelism story is a commented-out
``torch.nn.DataParallel`` call (``main.py:80``, ``base_model.py:9-21``).
Here parallelism is first-class (SURVEY §2.8 build table):

- a ``jax.sharding.Mesh`` with axes ``(data, model, seq)``; XLA compiles
  collectives to NCCL over NVLink (the four cards of a host are joined
  all to all, so devices are laid out in order);
- batches are sharded over ``data`` (DP); gradient reduction is inserted by
  XLA because params are replicated while the batch is sharded;
- param partition rules for tensor parallelism over ``model`` (attention
  heads / FFN hidden) are provided for models that exceed one chip — off
  (axis size 1) by default for AISHELL-scale models;
- ``seq`` reserves the mesh axis for sequence/context parallelism (ring
  attention over ``lax.ppermute``) — API surface for long audio.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> tuple[int, int]:
    """Multi-host bootstrap (``jax.distributed.initialize``; SURVEY §5.8).

    Launch ONE process per host: it drives every card of that host. A JAX
    process reserves most of each card it opens, so two processes that
    both open all the cards of a host fail for want of memory; to run one
    process per card instead, give each ``local_device_ids=[its card]``.
    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` must be given: nothing tells JAX of the cluster.

    On single-process runs this is a no-op. Returns (process_count,
    process_index) — feed these to the BucketedLoader as
    (num_hosts, host_id) so each host reads a disjoint manifest shard."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    return jax.process_count(), jax.process_index()


def put_host_batch(mesh: Mesh, arrays: dict) -> dict:
    """Assemble a global batch from per-host shards.

    Single-process: plain sharded device_put. Multi-process: each host
    contributes its local batch rows via
    ``jax.make_array_from_process_local_data`` (the global batch dim is
    num_hosts x local_batch, split over ``data``)."""
    sh = batch_sharding(mesh)
    if jax.process_count() == 1:
        return {k: jax.device_put(v, sh) for k, v in arrays.items()}
    return {
        k: jax.make_array_from_process_local_data(sh, np.asarray(v))
        for k, v in arrays.items()
    }


def make_mesh(
    data: int = -1,
    model: int = 1,
    seq: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (data, model, seq) mesh. ``data=-1`` absorbs the remaining
    devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data == -1:
        assert n % (model * seq) == 0, (n, model, seq)
        data = n // (model * seq)
    want = data * model * seq
    assert want <= n, (data, model, seq, n)
    arr = np.asarray(devices[:want]).reshape(data, model, seq)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS, SEQ_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading batch dim split over ``data``."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def put_host_batch_stacked(mesh: Mesh, arrays: dict) -> dict:
    """Like ``put_host_batch`` for (k, B, ...) stacks of k batches
    (``steps_per_dispatch``): the BATCH dim (axis 1) splits over ``data``,
    the step dim stays whole on every shard."""
    sh = NamedSharding(mesh, P(None, DATA_AXIS))
    if jax.process_count() == 1:
        return {k: jax.device_put(v, sh) for k, v in arrays.items()}
    return {
        k: jax.make_array_from_process_local_data(sh, np.asarray(v))
        for k, v in arrays.items()
    }


# -- tensor-parallel param rules --------------------------------------------
# Matched against flax param path strings (joined with "/"). Attention
# q/k/v kernels are (d_model, heads, head_dim): shard heads; out kernel is
# (heads, head_dim, d_model): shard heads; FFN w1 (d_model, d_ff): shard
# d_ff; w2 (d_ff, d_model): shard d_ff. Embedding (vocab, d_model): shard
# vocab. Everything else replicated.
_TP_RULES = (
    (r".*(q|k|v)/kernel$", P(None, MODEL_AXIS, None)),
    (r".*(q|k|v)/bias$", P(MODEL_AXIS, None)),
    (r".*out/kernel$", P(MODEL_AXIS, None, None)),
    (r".*w1/kernel$", P(None, MODEL_AXIS)),
    (r".*w1/bias$", P(MODEL_AXIS)),
    (r".*w2/kernel$", P(MODEL_AXIS, None)),
    (r".*embed/embedding$", P(MODEL_AXIS, None)),
)


def param_spec(path: str, shape: tuple, model_axis_size: int) -> P:
    if model_axis_size > 1:
        for pattern, spec in _TP_RULES:
            if re.match(pattern, path):
                # only shard if the sharded dim divides evenly
                dims = [
                    (i, ax)
                    for i, ax in enumerate(spec)
                    if ax is not None and i < len(shape)
                ]
                if all(shape[i] % model_axis_size == 0 for i, _ in dims):
                    return spec
    return P()


def param_shardings(mesh: Mesh, params) -> "jax.tree_util.PyTreeDef":
    """NamedSharding tree for a param pytree (TP if mesh has model>1)."""
    msize = mesh.shape[MODEL_AXIS]
    flat = jax.tree_util.tree_flatten_with_path(params)[0]

    def path_str(path):
        return "/".join(
            getattr(p, "key", getattr(p, "name", str(p))) for p in path
        )

    specs = {
        jax.tree_util.keystr(path): NamedSharding(
            mesh, param_spec(path_str(path), leaf.shape, msize)
        )
        for path, leaf in flat
    }

    def lookup(path, leaf):
        return specs[jax.tree_util.keystr(path)]

    return jax.tree_util.tree_map_with_path(lookup, params)


def state_shardings(mesh: Mesh, state):
    """Sharding tree for a full TrainState.

    Params follow ``param_shardings`` (TP over ``model`` when the axis is
    >1, replicated otherwise). Optimizer slots that MIRROR the param tree
    (Adam mu/nu and any other per-param moments) are sharded exactly like
    their parameter — under real TP the moments must not stay replicated
    or TP's memory benefit is forfeited. Scalars (schedule/clip counters)
    and the step counter are replicated.

    Matching is structural: an optimizer leaf whose key-path SUFFIX equals
    a parameter's key-path and whose shape matches inherits that
    parameter's sharding (optax moment trees embed the param tree
    verbatim, so the param path is always a suffix of the moment path)."""
    p_sh_tree = param_shardings(mesh, state.params)
    flat_p = jax.tree_util.tree_flatten_with_path(state.params)[0]
    flat_sh = jax.tree_util.tree_flatten_with_path(p_sh_tree)[0]
    suffix_map = {
        jax.tree_util.keystr(path): (leaf.shape, sh)
        for (path, leaf), (_, sh) in zip(flat_p, flat_sh)
    }
    rep = replicated(mesh)

    def opt_leaf(path, leaf):
        ks = jax.tree_util.keystr(path)
        for pks, (shape, sh) in suffix_map.items():
            if ks.endswith(pks) and getattr(leaf, "shape", None) == shape:
                return sh
        return rep

    opt_sh = jax.tree_util.tree_map_with_path(opt_leaf, state.opt_state)
    return state.replace(
        params=p_sh_tree,
        opt_state=opt_sh,
        step=rep,
        metric_sums=jax.tree_util.tree_map(lambda _: rep, state.metric_sums),
    )


def shard_batch(mesh: Mesh, arrays: dict) -> dict:
    """device_put a host batch with the batch dim split over ``data``
    (the host->device boundary; replaces the reference's per-batch
    ``.cuda()``, ``ai_shell_1.py:85-86``)."""
    sh = batch_sharding(mesh)
    return {k: jax.device_put(v, sh) for k, v in arrays.items()}
