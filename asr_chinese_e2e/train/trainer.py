"""Epoch-based trainer with the reference's cadence knobs.

Parity with ``Trainer/trainer11.py:13-133`` (the used trainer):
- epoch loop over ``num_epoch`` (``trainer11.py:47-49``);
- per-iter: train step → every ``log_every_iter`` summarize train metrics +
  lr → every ``eval_every_iter`` dev eval → every ``save_every_iter``
  checkpoint (``trainer11.py:56-69``);
- end of epoch: checkpoint + TEST-set eval (``trainer11.py:79-80``);
- best-checkpoint by ``reference='-loss'`` (``trainer11.py:26,43`` — the
  reference left this commented out, ``trainer11.py:100-106``; finished
  here);
- resume restores model, optimizer (incl. Noam step) and counters
  (``trainer11.py:82-91``), now wired through the config
  (``main.py:28`` left it TODO);
- nan-loss guard (``example_model.py:34-35``).

Deliberate non-parity: per-step CER (a device→host sync every iteration,
``transformer_official.py:87-91``) runs at eval/log cadence only; the
destructive ``drop_exp`` rm -rf default (``trainer11.py:34-37``) is opt-in.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import Config
from ..data.batching import Batch, BucketedLoader
from ..data.features import FeatureConfig
from ..decode.cer import batch_cer_from_ids
from .checkpoint import CheckpointManager
from .metrics import (
    MetricsAccumulator,
    NullScalarWriter,
    ScalarWriter,
    ThroughputMeter,
)
from .optimizer import current_lr
from .train_step import make_step_fns, resolved_routes


def default_exp_name() -> str:
    # timestamp default like get_time (trainer11.py:131-132), ISO format
    return datetime.datetime.now().strftime("%Y%m%d_%H%M%S")


class Trainer:
    def __init__(
        self,
        model,
        tx,
        cfg: Config,
        feat_cfg: FeatureConfig,
        vocab,
        train_loader: BucketedLoader,
        dev_loader: Optional[BucketedLoader] = None,
        test_loader: Optional[BucketedLoader] = None,
        mesh=None,
        raw_features: bool = False,
    ) -> None:
        self.model, self.tx, self.cfg = model, tx, cfg
        self.feat_cfg, self.vocab = feat_cfg, vocab
        if (
            cfg.get("flat_optimizer", False)
            and mesh is not None
            and dict(mesh.shape).get("model", 1) > 1
        ):
            raise ValueError(
                "flat_optimizer is incompatible with tensor parallelism "
                "(mesh model axis > 1): the flat Adam moment vector cannot "
                "mirror per-param shardings"
            )
        self.train_loader = train_loader
        self.dev_loader, self.test_loader = dev_loader, test_loader
        self.mesh = mesh
        exp_name = cfg.get("exp_name") or default_exp_name()
        self.exp_dir = os.path.join(cfg.get("exp_root", "ckpt"), exp_name)
        if cfg.get("drop_exp", False) and os.path.isdir(self.exp_dir):
            # opt-in (the reference rm -rf's by DEFAULT, trainer11.py:34-37
            # — a destructive default deliberately not replicated)
            import shutil

            shutil.rmtree(self.exp_dir)
        os.makedirs(self.exp_dir, exist_ok=True)
        # one writer per shared-filesystem artifact: config/scalars/TB come
        # from process 0 only (checkpoint index/meta are gated the same way
        # in CheckpointManager)
        if jax.process_index() == 0:
            dump = Config(**cfg.to_dict()).build(routes=resolved_routes(cfg))
            dump.save(os.path.join(self.exp_dir, "config.json"))
            self.writer = ScalarWriter(self.exp_dir)
        else:
            self.writer = NullScalarWriter()
        self.ckpt = CheckpointManager(
            os.path.join(self.exp_dir, "checkpoints"),
            reference=cfg.get("reference", "-loss"),
        )
        self.init_fn, self.train_step, self.eval_step = make_step_fns(
            model, tx, feat_cfg, cfg, raw_features=raw_features
        )
        if mesh is not None:
            # the CTC kernel and ring attention shard over the mesh via
            # shard_map; the active-mesh context tells them which
            # (trace-time only)
            from ..parallel.context import active_mesh

            def _with_mesh(fn):
                def wrapped(*a, **kw):
                    with active_mesh(mesh):
                        return fn(*a, **kw)

                return wrapped

            self.init_fn = _with_mesh(self.init_fn)
            self.train_step = _with_mesh(self.train_step)
            self.eval_step = _with_mesh(self.eval_step)
        self._multi_step = None
        if int(cfg.get("steps_per_dispatch", 1)) > 1:
            from .train_step import make_multi_step

            # k same-bucket train steps per dispatch (see train_epoch);
            # the mesh context (if any) re-enters via the wrapped step
            self._multi_step = make_multi_step(self.train_step)
        self._raw_features = raw_features
        # optional decoded-CER eval (the reference only ever evaluates
        # teacher-forced argmax CER — SURVEY §3.3); modes: none |
        # ctc_greedy | attention_greedy | beam | joint
        # (beam width via eval_beam_size, default 10)
        self._eval_decode = cfg.get("eval_decode", "none")
        self._encode_fn = None
        if self._eval_decode != "none":
            from ..data.features import parse_batch

            def encode(params, wave, wave_lengths):
                if raw_features:
                    feats, feat_lens = wave, wave_lengths
                else:
                    feats, feat_lens = parse_batch(wave, wave_lengths, feat_cfg)
                return model.apply(params, feats, feat_lens, method="encode")

            self._encode_fn = jax.jit(encode)
            self._ctc_lp_fn = jax.jit(
                lambda params, enc_out: model.apply(
                    params, enc_out, method="ctc_log_probs"
                )
            )
        self.rng = jax.random.key(
            cfg.get("seed", 0), impl=cfg.get("rng_impl", "rbg")
        )
        self.state = None
        self.epoch = 0
        self._d_model = cfg.get("d_model", cfg.get("hidden_size", 512))
        n_chips = 1 if mesh is None else mesh.devices.size
        self.throughput = ThroughputMeter(n_chips)
        self._pack_fns: dict = {}

    def _fetch_scalar_dicts(self, dicts: list) -> list:
        """[{k: device-scalar}, ...] -> [{k: float}, ...] with ONE device
        round-trip.

        Reading device scalars one ``float()`` at a time costs a full
        host<->device round-trip EACH. Used by ``evaluate`` for its
        per-batch scalar dicts. The TRAIN loop fetches no per-step dicts
        at all: metric sums accumulate on device inside the step
        (``TrainState.metric_sums``) and the log window does one
        ~8-scalar fetch + host diffs."""
        if not dicts:
            return []
        keys = tuple(sorted(dicts[0]))
        sig = (len(dicts), keys)
        fn = self._pack_fns.get(sig)
        if fn is None:
            fn = jax.jit(
                lambda ms: jax.numpy.stack(
                    [
                        jax.numpy.stack(
                            [jax.numpy.asarray(m[k], jax.numpy.float32) for k in keys]
                        )
                        for m in ms
                    ]
                )
            )
            self._pack_fns[sig] = fn
        mat = np.asarray(fn(dicts))
        return [dict(zip(keys, map(float, row))) for row in mat]

    # -- device placement ---------------------------------------------------
    def _put_batch(self, batch: Batch) -> dict:
        arrays = {
            "wave": batch.wave,
            "wave_lengths": batch.wave_lengths,
            "labels": batch.labels,
            "label_lengths": batch.label_lengths,
        }
        if self.mesh is not None:
            from ..parallel.sharding import put_host_batch

            return put_host_batch(self.mesh, arrays)
        return {k: jax.device_put(v) for k, v in arrays.items()}

    def _put_batch_stacked(self, group) -> dict:
        """Stack k same-shape batches to (k, B, ...) for multi-step
        dispatch; under a mesh the batch dim (axis 1) shards over
        ``data``."""
        arrays = {
            "wave": np.stack([b.wave for b in group]),
            "wave_lengths": np.stack([b.wave_lengths for b in group]),
            "labels": np.stack([b.labels for b in group]),
            "label_lengths": np.stack([b.label_lengths for b in group]),
        }
        if self.mesh is not None:
            from ..parallel.sharding import put_host_batch_stacked

            return put_host_batch_stacked(self.mesh, arrays)
        return {k: jax.device_put(v) for k, v in arrays.items()}

    def _init_state(self) -> None:
        first = next(iter(self.train_loader.epoch(0)))
        batch = self._put_batch(first)
        init_rng, self.rng = jax.random.split(self.rng)
        self.state = self.init_fn(init_rng, batch)
        self.host_step = 0  # host-tracked mirror of state.step (see below)
        if self.mesh is not None:
            # params tensor-parallel over ``model`` (replicated where no
            # rule matches / axis size 1); Adam moments mirror their
            # params — see parallel/sharding.py::state_shardings
            from ..parallel.sharding import state_shardings

            self.state = jax.device_put(
                self.state, state_shardings(self.mesh, self.state)
            )

    # -- public API ---------------------------------------------------------
    def train(self, from_ckpt: Optional[str] = None) -> None:
        """Full training run; ``from_ckpt`` in {'latest','best','e{E}_s{S}'}
        resumes (finishing main.py:28's TODO)."""
        self._init_state()
        if from_ckpt is not None:
            self.state, meta = self.ckpt.restore(from_ckpt, template=self.state)
            if self.mesh is not None:
                from ..parallel.sharding import state_shardings

                self.state = jax.device_put(
                    self.state, state_shardings(self.mesh, self.state)
                )
            self.epoch = int(meta["epoch"])
            self.host_step = int(meta["step"])
        # note: the reference's extra_eval_epochs knob (hardcoded dev evals
        # at epochs {10,50,80,100,200}, trainer11.py:76-77) is superseded —
        # dev now evaluates at EVERY epoch end to drive best-ckpt selection
        for epoch in range(self.epoch, self.cfg.num_epoch):
            self.epoch = epoch
            self.train_epoch(epoch)
            # best-checkpoint selection is driven by the DEV metric only
            # (selecting on test is evaluation malpractice); the epoch-end
            # TEST eval (trainer11.py:79-80) remains as reporting
            metric = None
            if self.dev_loader is not None:
                metric = self.evaluate(self.dev_loader, "dev/")
            if self.test_loader is not None:  # test eval at epoch end
                test_metric = self.evaluate(self.test_loader, "test/")
                if metric is None and self.dev_loader is None:
                    # no dev set at all: fall back to test rather than
                    # never tracking a best pointer
                    metric = test_metric
            # end-of-epoch checkpoints resume at the NEXT epoch; mid-epoch
            # cadence saves (in train_epoch) restart the current one
            self.save(metric, resume_epoch=epoch + 1)
        self.ckpt.wait()  # commit the final async save before returning

    def train_epoch(self, epoch: int) -> None:
        """One epoch of the hot loop.

        ``steps_per_dispatch`` (default 1) groups k consecutive SAME-BUCKET
        batches into one jitted dispatch (``train_step.make_multi_step``)
        — amortizes per-dispatch host/runtime latency. Per-step metrics
        come back stacked, so logging fidelity is unchanged; eval/save
        cadences round up to the dispatch boundary (≤ k−1 steps late).
        Partial groups (bucket change / epoch end) fall back to the
        single-step program, so at most two XLA programs exist per bucket.
        """
        cfg = self.cfg
        self.throughput.reset()
        sr = self.feat_cfg.sample_rate
        # optional xprof trace window (SURVEY §5.1: tracing/profiling)
        prof_from = cfg.get("profile_from_step", 0)
        prof_steps = cfg.get("profile_steps", 0)
        spd = max(1, int(cfg.get("steps_per_dispatch", 1)))
        profiling = False
        # Host pacing: the hot loop keeps a BOUNDED number of dispatched
        # steps in flight (max_in_flight, default 4). Data fetches (metric
        # values) still happen only at log cadence, batched into one
        # transfer — but completion WAITS (block_until_ready, no data
        # movement) are issued continuously so the dispatch queue stays
        # shallow and host-side batch buffers are not held without bound.
        # (The reference syncs every iteration for tqdm/CER — SURVEY §3.2.)
        # host-tracked step counter: state.step advances by exactly 1 per
        # train_step, so the host mirror stays exact without a device
        # fetch (an `int(self.state.step)` would wait for every step in
        # flight).
        step = self.host_step
        # re-zero the on-device metric sums so f32 accumulation error stays
        # bounded by one epoch's magnitude (~1e-4 relative at 10k steps)
        self.state = self.state.replace(
            metric_sums=jax.tree_util.tree_map(
                jnp.zeros_like, self.state.metric_sums
            )
        )
        sums_base = {k: 0.0 for k in self.state.metric_sums}
        max_in_flight = max(1, int(cfg.get("max_in_flight", 4)))
        in_flight: list = []

        def pace(handle):
            in_flight.append(handle)
            if len(in_flight) > max_in_flight:
                jax.block_until_ready(in_flight.pop(0))

        def after_step(metrics, n_samples, audio_s):
            nonlocal step, sums_base
            step += 1
            self.host_step = step  # keep mid-epoch save/eval in sync
            self.throughput.step(audio_s)
            pace(metrics.get("loss"))
            if step % cfg.log_every_iter == 0:
                # ONE ~8-scalar fetch; window means = cumulative-sum diffs.
                # (Under steps_per_dispatch>1 the sums are read at the
                # group-final state, ≤ k−1 steps ahead of `step` — same
                # dispatch-boundary rounding as the eval/save cadences.)
                sums = {
                    k: float(v)
                    for k, v in jax.device_get(self.state.metric_sums).items()
                }
                n = sums["_n"] - sums_base["_n"]
                means = {
                    k: (sums[k] - sums_base[k]) / max(n, 1.0)
                    for k in sums
                    if k != "_n"
                }
                sums_base = sums
                loss = means.get("loss", 0.0)
                if not math.isfinite(loss):
                    raise ValueError("nan loss encountered")  # example_model.py:34-35
                scalars = {f"train/{k}": v for k, v in means.items()}
                scalars["lr"] = current_lr(cfg, self._d_model, step)
                scalars["train/audio_s_per_s_per_chip"] = (
                    self.throughput.audio_seconds_per_sec_per_chip
                )
                scalars["train/steps_per_s"] = self.throughput.steps_per_sec
                self.writer.write(step, scalars)

        def dispatch(group):
            nonlocal profiling
            step_before = step
            # one-shot trace window [prof_from, prof_from + prof_steps)
            if (
                prof_steps
                and not profiling
                and prof_from <= step < prof_from + prof_steps
            ):

                jax.profiler.start_trace(os.path.join(self.exp_dir, "xprof"))
                profiling = True
            if len(group) == 1:
                batch = group[0]
                arrays = self._put_batch(batch)
                self.state, metrics = self.train_step(
                    self.state,
                    arrays["wave"],
                    arrays["wave_lengths"],
                    arrays["labels"],
                    arrays["label_lengths"],
                    self.rng,
                )
                after_step(
                    metrics,
                    len(batch.texts),
                    float(np.sum(batch.wave_lengths)) / sr,
                )
            else:
                arrays = self._put_batch_stacked(group)
                self.state, mstack = self._multi_step(
                    self.state,
                    arrays["wave"],
                    arrays["wave_lengths"],
                    arrays["labels"],
                    arrays["label_lengths"],
                    self.rng,
                )
                for i, batch in enumerate(group):
                    after_step(
                        {k: v[i] for k, v in mstack.items()},
                        len(batch.texts),
                        float(np.sum(batch.wave_lengths)) / sr,
                    )
            if profiling and step >= prof_from + prof_steps:

                jax.profiler.stop_trace()
                profiling = False
            # eval/save at most ONCE per dispatch group: with k steps per
            # dispatch, self.state only exists at the group end, so firing
            # on every mid-group cadence hit would re-evaluate the SAME
            # state k/eval_every times (ADVICE r2). Fire iff any step in
            # (step_before, step] crossed the cadence boundary.
            if (
                self.dev_loader is not None
                and cfg.eval_every_iter  # 0 = mid-epoch eval disabled
                and step // cfg.eval_every_iter > step_before // cfg.eval_every_iter
            ):
                self.evaluate(self.dev_loader, "dev/")
            if (
                cfg.save_every_iter  # 0 = cadence saves disabled
                and step // cfg.save_every_iter > step_before // cfg.save_every_iter
            ):
                self.save()

        group: list = []
        group_sig = None
        for batch in self.train_loader.epoch(epoch):
            if spd == 1:
                dispatch([batch])
                continue
            sig = (batch.wave.shape, batch.labels.shape)
            if group and sig != group_sig:
                # bucket changed: flush the partial group (single-step
                # program per batch — avoids one compile per group size)
                for b in group:
                    dispatch([b])
                group = []
            group.append(batch)
            group_sig = sig
            if len(group) == spd:
                dispatch(group)
                group = []
        for b in group:  # epoch-end leftovers
            dispatch([b])
        self.host_step = step
        if profiling:

            jax.profiler.stop_trace()

    def evaluate(self, loader: BucketedLoader, prefix: str = "dev/") -> float:
        """Weighted-mean metrics + teacher-forced CER over a loader
        (``trainer11.py:114-129``). Returns the reference metric value.

        Double-buffered (round-2 VERDICT #5): batch n+1's eval_step and
        decode programs are dispatched before batch n's results are read
        back, so the loop is device-time bound rather than paying host
        detok/Levenshtein + dispatch latency serially per batch."""
        import collections

        acc = MetricsAccumulator()

        def _dispatch(batch):
            arrays = self._put_batch(batch)
            metrics = self.eval_step(
                self.state.params,
                arrays["wave"],
                arrays["wave_lengths"],
                arrays["labels"],
                arrays["label_lengths"],
            )
            dec = None
            if self._eval_decode != "none":
                dec = self._dispatch_decode(arrays)
            return batch, metrics, dec

        def _drain(batch, metrics, dec):
            host = self._fetch_scalar_dicts(
                [{k: v for k, v in metrics.items()
                  if k not in ("pred_ids", "gold_ids")}]
            )[0]
            if "pred_ids" in metrics and getattr(
                metrics["pred_ids"], "is_fully_addressable", True
            ):
                # multi-process note: pred_ids is data-sharded across
                # hosts, so only the locally-addressable case computes TF
                # CER (each host would otherwise need an all-gather of id
                # tensors for a logging-only metric; scalar metrics above
                # are replicated and unaffected)
                host["cer"] = batch_cer_from_ids(
                    np.asarray(metrics["pred_ids"]),
                    np.asarray(metrics["gold_ids"]),
                    self.vocab,
                )
            if dec is not None:
                host["decoded_cer"] = self._drain_decoded_cer(batch, dec)
            acc.update(host, num_samples=len(batch.texts))

        pending: "collections.deque" = collections.deque()
        for batch in loader.epoch(0):
            pending.append(_dispatch(batch))
            while len(pending) > 1:
                _drain(*pending.popleft())
        while pending:
            _drain(*pending.popleft())
        means = acc.means()
        if not means:
            # zero batches (e.g. a loader whose buckets never fill): no
            # scalar row, and crucially NO metric — returning 0.0 here once
            # poisoned the best-pointer (0.0 is unbeatable under '-loss')
            import warnings

            warnings.warn(
                f"evaluate({prefix!r}) saw zero batches — eval loader "
                "produced nothing (check drop_last/bucket fill)",
                stacklevel=2,
            )
            return None
        step = getattr(self, "host_step", 0)
        self.writer.write(step, {prefix + k: v for k, v in means.items()})
        key = self.cfg.get("reference", "-loss").lstrip("+-")
        return means.get(key, means.get("loss", 0.0))

    def _dispatch_decode(self, arrays: dict):
        """Enqueue one eval batch's decode programs; no device sync."""
        from ..decode.greedy import attention_greedy_decode

        enc_out, enc_lens = self._encode_fn(
            self.state.params, arrays["wave"], arrays["wave_lengths"]
        )
        max_len = self.cfg.get("max_target_len", 64)
        if self._eval_decode == "ctc_greedy":
            lp = self._ctc_lp_fn(self.state.params, enc_out)
            return (lp, enc_lens)
        if self._eval_decode == "beam":
            if self.mesh is not None and self.mesh.shape.get("data", 1) > 1:
                # data-parallel eval decode: per-shard device beam +
                # all_gather of the n-best tiles (decode/distributed.py)
                from ..decode.distributed import distributed_beam_search

                return distributed_beam_search(
                    self.model, self.state.params, enc_out, enc_lens,
                    self.cfg.get("eval_beam_size", 10), max_len, self.mesh,
                )
            from ..decode.beam import beam_search

            return beam_search(
                self.model, self.state.params, enc_out, enc_lens,
                self.cfg.get("eval_beam_size", 10), max_len,
            )
        if self._eval_decode == "joint":
            from ..decode.joint import joint_beam_search

            # the configured weight is honored as-is: joint with weight 0
            # reduces to the attention beam over the pruned candidate set
            # (see joint.py docstring)
            return joint_beam_search(
                self.model, self.state.params, enc_out, enc_lens,
                self.cfg.get("eval_beam_size", 10), max_len,
                ctc_weight=float(self.cfg.get("ctc_weight", 0.3)),
            )
        # attention_greedy
        return attention_greedy_decode(
            self.model, self.state.params, enc_out, enc_lens, max_len
        )

    def _drain_decoded_cer(self, batch: Batch, pending) -> float:
        """Read one batch's decode back: host detok + Levenshtein CER."""
        from ..decode.cer import corpus_cer
        from ..decode.greedy import ctc_greedy_decode, tokens_to_ids

        if self._eval_decode == "ctc_greedy":
            lp, enc_lens = pending
            hyp_ids = ctc_greedy_decode(lp, enc_lens)
        elif self._eval_decode in ("beam", "joint"):
            hyp_ids = [h[0] for h in pending.nbest_ids(1)]
        else:  # attention_greedy
            tokens, _ = pending
            hyp_ids = tokens_to_ids(tokens)
        hyps = ["".join(self.vocab.ids_to_tokens(ids)) for ids in hyp_ids]
        return corpus_cer(hyps, batch.texts)

    def save(self, metric: Optional[float] = None, resume_epoch: Optional[int] = None) -> str:
        return self.ckpt.save(
            self.state,
            self.epoch if resume_epoch is None else resume_epoch,
            config=self.cfg,
            vocab_fingerprint=self.vocab.fingerprint() if self.vocab else None,
            metric=metric,
            step=getattr(self, "host_step", None),
        )
