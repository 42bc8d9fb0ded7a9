"""Checkpoint / resume with best-pointer tracking (NumPy files, async).

The reference saves ``ckpt/<exp>/e{epoch}_s{step}.model`` + ``.opt`` pairs
(``Trainer/trainer11.py:93-99``) and can restore model+optimizer+counters
(``trainer11.py:82-91``) but the CLI plumbing was left TODO (``main.py:28``)
and best-ckpt logic is commented out (``trainer11.py:100-106``). This module
finishes that design as one checkpoint tree:

    {params, opt_state, step, epoch}  (``state/arrays.npz`` + key paths)
  + meta.json {config, vocab_fingerprint, feature config}  — the content of
    the reference's richest schema (``transformer.py:86-117`` serialize
    package: all hyperparams + LFR config + state + optim)

with ``latest`` / ``best`` tracking driven by ``reference='-loss'``
semantics (``trainer11.py:26,43``: '-' prefix means lower is better).

Production posture (SURVEY §5.4):

- **Async save**: ``save()`` copies device arrays to host synchronously (so
  the train step's donated buffers are safe to reuse immediately) and
  writes the files in a background thread — the hot loop never blocks on
  filesystem IO. The barrier moves to the *next* save / restore /
  explicit ``wait()``.
- **Crash consistency**: the tree is written to ``state.tmp`` and renamed
  to ``state`` when complete, and ``index.json`` (latest/best pointers) is
  only updated AFTER that commit (``_finalize_pending``), so a crash
  mid-save can never leave ``latest`` pointing at a torn checkpoint —
  restart-from-latest always restores the last *committed* state.
- **Multi-host safety**: every process takes part in staging (arrays that
  span processes are all-gathered, a collective), but only process 0
  writes ``state``, ``meta.json`` and ``index.json`` and deletes old
  checkpoints — no racing writers on a shared filesystem.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import multihost_utils

from ..core.config import Config
from .train_step import TrainState


def _metric_better(reference: str, new: float, old: Optional[float]) -> bool:
    if old is None:
        return True
    return new < old if reference.startswith("-") else new > old


def _is_proc0() -> bool:
    return jax.process_index() == 0


# drain in-flight async saves before interpreter teardown — otherwise the
# background writer races Python shutdown (and the last checkpoint of a
# run could be torn)
import atexit
import weakref

_LIVE_MANAGERS: "weakref.WeakSet[CheckpointManager]" = weakref.WeakSet()


@atexit.register
def _drain_live_managers() -> None:
    for mgr in list(_LIVE_MANAGERS):
        try:
            mgr.wait()
        except Exception:
            pass


def _to_host(x) -> np.ndarray:
    if not isinstance(x, jax.Array) or x.is_fully_addressable:
        return np.asarray(x)
    if x.is_fully_replicated:
        return np.asarray(x.addressable_data(0))
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def _key_name(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


class NpzCheckpointer:
    """Writes a pytree as ``<path>/arrays.npz`` plus ``<path>/tree.json``
    (each leaf's key path and dtype) on a background thread."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, tree, force: bool = True) -> None:
        self.wait_until_finished()
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        keys = [[_key_name(k) for k in p] for p, _ in flat]
        arrays = [_to_host(leaf) for _, leaf in flat]
        if not _is_proc0():
            return
        dtypes = [a.dtype.name for a in arrays]
        # npz has no bfloat16: store such leaves bit-cast to same-width ints
        stored = [
            a if a.dtype.isbuiltin else a.view(f"uint{8 * a.dtype.itemsize}")
            for a in arrays
        ]

        def commit():
            try:
                tmp = path + ".tmp"
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
                np.savez(
                    os.path.join(tmp, "arrays.npz"),
                    **{str(i): a for i, a in enumerate(stored)},
                )
                with open(os.path.join(tmp, "tree.json"), "w") as f:
                    json.dump({"keys": keys, "dtypes": dtypes}, f)
                if force:
                    shutil.rmtree(path, ignore_errors=True)
                os.replace(tmp, path)
            except BaseException as e:  # re-raised by wait_until_finished
                self._error = e

        self._thread = threading.Thread(target=commit, daemon=True)
        self._thread.start()

    def wait_until_finished(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, path: str, template=None):
        """The saved tree: shaped like ``template`` (leaves matched by key
        path, placed with the template leaf's sharding) when given, else
        as nested dicts."""
        with open(os.path.join(path, "tree.json")) as f:
            info = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = [
                z[str(i)].view(jnp.dtype(dt))
                for i, dt in enumerate(info["dtypes"])
            ]
        by_key = {tuple(k): a for k, a in zip(info["keys"], arrays)}
        if template is None:
            out: dict = {}
            for k, a in by_key.items():
                d = out
                for part in k[:-1]:
                    d = d.setdefault(part, {})
                d[k[-1]] = a
            return out

        def place(path, leaf):
            a = by_key[tuple(_key_name(k) for k in path)]
            if isinstance(leaf, jax.Array):
                a = a.astype(leaf.dtype)
                return jax.make_array_from_callback(
                    a.shape, leaf.sharding, lambda idx: a[idx]
                )
            return a

        return jax.tree_util.tree_map_with_path(place, template)


class CheckpointManager:
    def __init__(self, directory: str, reference: str = "-loss", max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.reference = reference
        self._ckptr = NpzCheckpointer()
        self._mgr_opts = max_to_keep
        self._index_path = os.path.join(self.directory, "index.json")
        self._index = self._load_index()
        self._pending: Optional[dict] = None  # save in flight, not yet indexed
        _LIVE_MANAGERS.add(self)

    def _load_index(self) -> dict:
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                return json.load(f)
        return {"latest": None, "best": None, "best_metric": None, "all": []}

    def _write_index(self) -> None:
        if not _is_proc0():
            return
        tmp = self._index_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._index, f, indent=2)
        os.replace(tmp, self._index_path)  # atomic pointer update

    def _step_dir(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def save(
        self,
        state: TrainState,
        epoch: int,
        config: Config | None = None,
        vocab_fingerprint: str | None = None,
        metric: float | None = None,
        step: int | None = None,
    ) -> str:
        """Start an async save; returns immediately after device→host
        staging. The previous save (if still in flight) is drained first —
        at most one outstanding save, which also finalizes its index entry.

        ``step``: host-tracked step count; pass it to avoid the
        ``int(state.step)`` device fetch, which waits for every step in
        flight."""
        self.wait()
        if step is None:
            step = int(state.step)
        # file naming parity: e{epoch}_s{step} (trainer11.py:93-99)
        name = f"e{epoch}_s{step}"
        path = self._step_dir(name)
        tree = {
            "params": state.params,
            "opt_state": state.opt_state,
            "step": state.step,
            "epoch": epoch,
            "metric_sums": state.metric_sums,
        }
        self._ckptr.save(os.path.join(path, "state"), tree, force=True)
        if _is_proc0():
            os.makedirs(path, exist_ok=True)  # `state` is committed later
            meta = {
                "epoch": epoch,
                "step": step,
                "vocab_fingerprint": vocab_fingerprint,
                "config": config.to_dict() if config is not None else None,
                "metric": metric,
            }
            with open(os.path.join(path, "meta.json"), "w") as f:
                json.dump(meta, f, indent=2, default=str)
        self._pending = {"name": name, "metric": metric}
        return path

    def wait(self) -> None:
        """Block until the in-flight save (if any) commits, then publish its
        index entry (latest/best pointers) and GC old checkpoints."""
        self._ckptr.wait_until_finished()
        if self._pending is not None:
            self._finalize_pending()

    def _finalize_pending(self) -> None:
        name, metric = self._pending["name"], self._pending["metric"]
        self._pending = None
        self._index["latest"] = name
        if name not in self._index["all"]:
            self._index["all"].append(name)
        if metric is not None and _metric_better(
            self.reference, metric, self._index["best_metric"]
        ):
            self._index["best"] = name
            self._index["best_metric"] = metric
        self._gc()
        self._write_index()

    def _gc(self) -> None:
        keep = set(
            n for n in (self._index["latest"], self._index["best"]) if n
        )
        extra = [n for n in self._index["all"] if n not in keep]
        while len(extra) + len(keep) > self._mgr_opts and extra:
            victim = extra.pop(0)
            self._index["all"].remove(victim)
            if _is_proc0():
                vdir = self._step_dir(victim)
                if os.path.isdir(vdir):
                    shutil.rmtree(vdir)

    def restore(
        self, which: str = "latest", template: TrainState | None = None
    ) -> tuple[TrainState, dict]:
        """Restore ('latest' | 'best' | explicit 'e{E}_s{S}' name).

        ``template`` (an abstract-or-concrete TrainState with the right
        structure) is required for sharded/typed restore."""
        self.wait()  # never read past a save still in flight
        if which in ("latest", "best"):
            # disk is the source of truth: a fresh manager on a non-zero
            # process may hold a stale in-memory index (only process 0
            # writes index.json). Multi-process, briefly poll for the
            # pointer — process 0 publishes it after its commit, so other
            # processes can arrive here first.
            deadline = time.time() + (30.0 if jax.process_count() > 1 else 0.0)
            while True:
                self._index = self._load_index()
                name = self._index.get(which)
                if name is not None or time.time() >= deadline:
                    break
                time.sleep(0.25)
        else:
            name = which
        if name is None:
            raise FileNotFoundError(f"no '{which}' checkpoint in {self.directory}")
        path = self._step_dir(name)
        target = None
        if template is not None:
            target = {
                "params": template.params,
                "opt_state": template.opt_state,
                "step": template.step,
                "epoch": 0,
                "metric_sums": template.metric_sums,
            }
        tree = self._ckptr.restore(os.path.join(path, "state"), target)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        sums = tree.get("metric_sums")
        state = TrainState(
            params=tree["params"],
            opt_state=tree["opt_state"],
            step=tree["step"],
            metric_sums=sums,
        )
        return state, meta

    @property
    def latest_name(self) -> Optional[str]:
        self.wait()
        return self._index["latest"]

    @property
    def best_name(self) -> Optional[str]:
        self.wait()
        return self._index["best"]
