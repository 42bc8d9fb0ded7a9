#!/usr/bin/env python
"""Inference CLI: decode wavs / a manifest with a trained experiment.

The real implementation of what the reference left as a stub
(``Predictor/predictor.py:7-35``). Output n-best JSON follows the
kaldi-style assembly of ``Predictor/Models/utils.py:34-94``
(``add_results_to_json``): {"utts": {id: {"output": [{"rec_text",
"rec_token", "score", "text"?}]}}}.

    python recognize.py --exp ckpt/<name> --vocab data/vocab.json \
        --manifest data/test.jsonl --mode beam --beam_size 10 \
        --out results.json

Modes: ctc_greedy | attention_greedy | beam | rescore | joint
(``rescore`` = CTC-prefix beam + attention rescoring, north-star #4;
``joint`` = one-pass joint CTC/attention beam — score interpolation at
every step, the hybrid architecture's strongest decode).
"""

from __future__ import annotations

import json
import os
import time
import sys
import wave as wavelib

import jax
import jax.numpy as jnp
import numpy as np

from asr_chinese_e2e.data.batching import DEFAULT_BUCKET_SECONDS, load_wav
from asr_chinese_e2e.data.features import parse_batch
from asr_chinese_e2e.data.manifest import read_manifest
from asr_chinese_e2e.decode.beam import beam_search
from asr_chinese_e2e.decode.cer import corpus_cer
from asr_chinese_e2e.decode.ctc_prefix import (
    attention_rescore,
    ctc_prefix_beam_batch,
)
from asr_chinese_e2e.decode.greedy import (
    attention_greedy_decode,
    ctc_greedy_decode,
    tokens_to_ids,
)
from asr_chinese_e2e.decode.jit_cache import ModelJitCache
from asr_chinese_e2e.utils.cli import parse_kwargs
from asr_chinese_e2e.utils.experiment import load_experiment

_JIT_CACHE = ModelJitCache()


def _jitted(model, name, fn):
    """One jitted program per (model, name); jax's own shape cache then
    gives one compile per bucket shape."""
    cache = _JIT_CACHE.scope(model)
    if name not in cache:
        cache[name] = jax.jit(fn)
    return cache[name]


def _num_samples(record) -> int:
    """Utterance length in samples: manifest ``frames`` if present, else a
    header read (no decode)."""
    if "frames" in record:
        return int(record["frames"])
    with wavelib.open(record["wave"], "rb") as w:
        return w.getnframes()


def batched(
    records,
    batch_size,
    max_samples,
    sample_rate: int = 16000,
    bucket_seconds=DEFAULT_BUCKET_SECONDS,
):
    """Duration-bucketed decode batches with FULLY static shapes.

    Every chunk is padded to its bucket's fixed sample boundary AND to a
    full ``batch_size`` of rows (short final chunks repeat row 0 as
    padding), so the decode path compiles at most ONE XLA program per
    bucket. Padding each chunk to its own max would recompile for every
    new shape, which makes corpus-scale decoding compile-bound (the
    training loader solved this the same way, ``data/batching.py``).

    Yields (chunk_records, wave (batch_size, boundary), lengths); rows
    beyond ``len(chunk_records)`` are padding and must be dropped.
    """
    boundaries = sorted(
        {min(int(s * sample_rate), max_samples) for s in bucket_seconds}
    )
    if boundaries[-1] < max_samples:
        boundaries.append(max_samples)
    groups: dict[int, list] = {}
    for r in records:
        n = min(_num_samples(r), max_samples)
        b = next(x for x in boundaries if n <= x)
        groups.setdefault(b, []).append(r)
    for b in sorted(groups):
        rs = groups[b]
        for i in range(0, len(rs), batch_size):
            chunk = rs[i : i + batch_size]
            # int16 PCM wire (bit-exact for mono: parse_batch scales by
            # 1/32768 on device) — HALF the host->device bytes of f32,
            # same as training (wire_dtype=int16)
            wave = np.zeros((batch_size, b), np.int16)
            lengths = np.zeros((batch_size,), np.int32)
            for j, r in enumerate(chunk):
                w = load_wav(r["wave"], dtype=np.int16)[:b]
                wave[j, : len(w)] = w
                lengths[j] = len(w)
            # pad rows duplicate row 0 (valid audio, so no NaN-producing
            # zero-length stats anywhere downstream); dropped on output
            for j in range(len(chunk), batch_size):
                wave[j] = wave[0]
                lengths[j] = lengths[0]
            yield chunk, wave, lengths


_EXP_CACHE: dict = {}


def _load_experiment_cached(exp, vocab, which):
    """Memoized load_experiment: repeat recognize() calls in one process
    (REPL serving, the bench's warmup+timed passes) reuse the SAME model
    instance, so the per-model jit caches (beam/joint whole-search
    programs, encode) hit instead of re-tracing — and the checkpoint is
    restored once. Keyed on the checkpoint index mtime so a new save
    invalidates."""
    idx = os.path.join(exp, "checkpoints", "index.json")
    mtime = os.path.getmtime(idx) if os.path.exists(idx) else 0.0
    key = (os.path.abspath(exp), os.path.abspath(vocab), which, mtime)
    if key not in _EXP_CACHE:
        _EXP_CACHE[key] = load_experiment(exp, vocab, which)
    return _EXP_CACHE[key]


def recognize(
    exp: str,
    vocab: str,
    manifest: str = None,
    wav: str = None,
    mode: str = "beam",
    which: str = "best",
    beam_size: int = 10,
    nbest: int = 1,
    max_decode_len: int = 64,
    batch_size: int = 8,
    max_seconds: float = 15.0,
    ctc_weight: float = 0.3,
    length_penalty: float = 0.0,
    ctc_beam_impl: str = "device",  # on-chip prefix beam (host = exact ref)
    ctc_prune: int = 30,  # joint mode: CTC-scored candidates per hyp
    mesh_data: int = 0,  # >0 or -1: data-parallel decode over a device mesh
    pipeline_depth: int = 1,  # batches in flight beyond the one draining
    out: str = None,
    **_,
):
    model, params, cfg, feat_cfg, voc = _load_experiment_cached(exp, vocab, which)
    mesh = None
    if mesh_data:
        # data-parallel decode: each shard runs the full device beam on
        # its batch rows; one tiled all_gather returns the global n-best
        # (decode/distributed.py). batch_size must divide the data axis.
        from asr_chinese_e2e.parallel.sharding import make_mesh

        mesh = make_mesh(data=mesh_data)
        if batch_size % mesh.shape["data"]:
            raise SystemExit(
                f"batch_size {batch_size} not divisible by mesh_data "
                f"{mesh.shape['data']}"
            )
    if manifest:
        records = read_manifest(manifest)
    elif wav:
        records = [{"wave": w} for w in wav.split(",")]
    else:
        raise SystemExit("need --manifest or --wav")

    results = {"utts": {}}
    hyps_all, refs_all = [], []
    max_samples = int(max_seconds * feat_cfg.sample_rate)
    # jitted feature+encoder front half: one compile per bucket shape
    # (eager model.apply dispatches op-by-op — seconds per chunk)
    encode_fn = _jitted(model, "encode", lambda p, w, wl: model.apply(
        p, *parse_batch(w, wl, feat_cfg), method="encode"
    ))
    ctc_lp_fn = _jitted(model, "ctc_lp", lambda p, eo: model.apply(
        p, eo, method="ctc_log_probs"
    ))

    def dispatch(chunk, wave, lengths):
        """Enqueue the full device program(s) for one chunk WITHOUT reading
        any result back — returns a pending handle of device arrays."""
        t0 = time.perf_counter()
        wave_d = jnp.asarray(wave)
        lengths_d = jnp.asarray(lengths)
        tacc["d_put"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        enc_out, enc_lens = encode_fn(params, wave_d, lengths_d)
        tacc["d_enc"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            return _dispatch_search(chunk, enc_out, enc_lens)
        finally:
            tacc["d_search"] += time.perf_counter() - t0

    def _dispatch_search(chunk, enc_out, enc_lens):
        if mode == "ctc_greedy":
            return chunk, (ctc_lp_fn(params, enc_out), enc_lens)
        if mode == "attention_greedy":
            return chunk, attention_greedy_decode(
                model, params, enc_out, enc_lens, max_decode_len
            )
        if mode == "beam":
            if mesh is not None:
                from asr_chinese_e2e.decode.distributed import (
                    distributed_beam_search,
                )

                res = distributed_beam_search(
                    model, params, enc_out, enc_lens, beam_size,
                    max_decode_len, mesh, length_penalty,
                )
            else:
                res = beam_search(
                    model, params, enc_out, enc_lens, beam_size,
                    max_decode_len, length_penalty,
                )
            return chunk, res
        if mode == "joint":
            # one-pass joint CTC/attention beam (strongest hybrid decode)
            from asr_chinese_e2e.decode.joint import joint_beam_search

            res = joint_beam_search(
                model, params, enc_out, enc_lens, beam_size, max_decode_len,
                ctc_weight=ctc_weight, ctc_prune=ctc_prune,
            )
            return chunk, res
        if mode == "rescore":
            # host/device ping-pong (the host n-best feeds the rescore
            # forward), so this mode drains inside dispatch — the pipeline
            # still overlaps its wav IO with device compute
            lp = ctc_lp_fn(params, enc_out)
            if ctc_beam_impl == "device":
                from asr_chinese_e2e.decode.ctc_prefix_device import (
                    ctc_prefix_beam_device,
                    device_nbest_to_lists,
                )

                pref, plen, sc = ctc_prefix_beam_device(
                    lp, enc_lens, beam_size=beam_size
                )
                ctc_nbest = device_nbest_to_lists(pref, plen, sc)
            else:
                ctc_nbest = ctc_prefix_beam_batch(
                    np.asarray(lp), np.asarray(enc_lens), beam_size
                )
            best = attention_rescore(
                model, params, enc_out, enc_lens, ctc_nbest, ctc_weight
            )
            return chunk, [[(ids, 0.0)] for ids in best]
        raise SystemExit(f"unknown mode {mode}")

    def drain(chunk, pending):
        """Read one chunk's results back (the only device sync)."""
        nbest_out = []  # per utt: [(ids, score)]
        if mode == "ctc_greedy":
            lp, enc_lens = pending
            for ids in ctc_greedy_decode(lp, enc_lens):
                nbest_out.append([(ids, 0.0)])
        elif mode == "attention_greedy":
            tokens, scores = pending
            for ids, s in zip(tokens_to_ids(tokens), np.asarray(scores)):
                nbest_out.append([(ids, float(s))])
        elif mode in ("beam", "joint"):
            res = pending
            ids_nb = res.nbest_ids(nbest)
            for b in range(len(chunk)):
                nbest_out.append(
                    [(ids_nb[b][k], float(res.scores[b, k]))
                     for k in range(len(ids_nb[b]))]
                )
        else:  # rescore drained in dispatch
            nbest_out = pending
        return nbest_out

    def consume(chunk, nbest_out):
        for record, hyps in zip(chunk, nbest_out):
            utt_id = record["wave"].rsplit("/", 1)[-1].rsplit(".", 1)[0]
            outputs = []
            for rank, (ids, score) in enumerate(hyps, 1):
                toks = voc.ids_to_tokens(ids)
                entry = {
                    "rec_text": "".join(toks),
                    "rec_token": " ".join(toks),
                    "score": score,
                }
                if "tgt" in record:
                    entry["text"] = record["tgt"]
                outputs.append(entry)
            results["utts"][utt_id] = {"output": outputs}
            best_text = outputs[0]["rec_text"]
            print(f"{utt_id}\t{best_text}")
            if "tgt" in record:
                hyps_all.append(best_text)
                refs_all.append(record["tgt"])

    # Double-buffered corpus decode (round-2 VERDICT #5): the host preps
    # batch n+1 (wav IO on a prefetch thread) and dispatches its device
    # programs BEFORE draining batch n's results, so corpus wall throughput
    # tracks device time instead of paying host-prep + dispatch latency
    # serially per batch — the same latency steps_per_dispatch amortizes in
    # training. pipeline_depth=0 restores the serial behavior.
    import collections

    from asr_chinese_e2e.data.batching import _prefetched

    timing = os.environ.get("ASR_DECODE_TIMING") == "1"
    tacc = {"fetch_batch": 0.0, "dispatch": 0.0, "drain": 0.0, "consume": 0.0,
            "d_put": 0.0, "d_enc": 0.0, "d_search": 0.0}

    def _timed(key, fn, *a):
        if not timing:
            return fn(*a)
        t0 = time.perf_counter()
        r = fn(*a)
        tacc[key] += time.perf_counter() - t0
        return r

    chunks = batched(records, batch_size, max_samples, feat_cfg.sample_rate)
    if pipeline_depth > 0:
        chunks = _prefetched(chunks, depth=max(2, pipeline_depth + 1))
    pending_q: "collections.deque" = collections.deque()
    chunks = iter(chunks)
    n_chunks = 0
    while True:
        item = _timed("fetch_batch", lambda: next(chunks, None))
        if item is None:
            break
        n_chunks += 1
        pending_q.append(_timed("dispatch", dispatch, *item))
        while len(pending_q) > pipeline_depth:
            c, p = pending_q.popleft()
            r = _timed("drain", drain, c, p)
            _timed("consume", consume, c, r)
    while pending_q:
        c, p = pending_q.popleft()
        r = _timed("drain", drain, c, p)
        _timed("consume", consume, c, r)
    if timing and n_chunks:
        parts = " ".join(
            f"{k}={v / n_chunks * 1e3:.0f}ms" for k, v in tacc.items()
        )
        print(f"# timing per batch ({n_chunks} batches): {parts}",
              file=sys.stderr)

    if refs_all:
        cer = corpus_cer(hyps_all, refs_all)
        print(f"# CER: {cer:.2f}% over {len(refs_all)} utts", file=sys.stderr)
        results["cer"] = cer
    if out:
        with open(out, "w", encoding="utf-8") as f:
            json.dump(results, f, ensure_ascii=False, indent=2)
        print(f"# wrote {out}", file=sys.stderr)
    return results


def main():
    _, kwargs = parse_kwargs(sys.argv[1:])
    if kwargs.pop("help", False) or not kwargs:
        print(__doc__)
        return
    recognize(**kwargs)


if __name__ == "__main__":
    main()
