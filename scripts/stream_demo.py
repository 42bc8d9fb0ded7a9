#!/usr/bin/env python
"""Streaming-recognition demo: chunk a wav file through the energy-gated
StreamingRecognizer (the live-capture path of ``Predictor/recorder.py``,
with a file standing in for the microphone).

  python scripts/stream_demo.py --exp <exp_dir> --vocab <vocab.json> \
      --wav <audio.wav> [--mode joint] [--chunk_ms 125]
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv):
    from asr_chinese_e2e.utils.cli import parse_kwargs

    _, kw = parse_kwargs(argv)
    exp, vocab_path, wav = kw["exp"], kw["vocab"], kw["wav"]
    mode = kw.get("mode", "ctc_greedy")
    chunk_ms = float(kw.get("chunk_ms", 125))

    from asr_chinese_e2e.stream import StreamingRecognizer, wav_chunks
    from asr_chinese_e2e.utils.experiment import load_experiment

    model, params, cfg, feat_cfg, vocab = load_experiment(
        exp, vocab_path, which=kw.get("which", "best")
    )
    rec = StreamingRecognizer(
        model, params, vocab, feat_cfg, mode=mode,
        beam_size=int(kw.get("beam_size", 10)),
        incremental=kw.get("incremental", "auto"),
    )
    print(
        "# encode path:",
        "incremental (O(chunk) partials)" if rec.incremental
        else "prefix re-encode (train with --causal_encoder true "
             "--attention_band N --cmvn_mode fixed for incremental)",
        flush=True,
    )
    chunk = int(feat_cfg.sample_rate * chunk_ms / 1000)
    t = 0.0
    for c in wav_chunks(wav, chunk):
        for ev in rec.feed(c):
            print(f"[{ev.kind:7s} {ev.t0:6.2f}-{ev.t1:6.2f}s] {ev.text}",
                  flush=True)
        t += chunk_ms / 1000
    for ev in rec.finish():
        print(f"[{ev.kind:7s} {ev.t0:6.2f}-{ev.t1:6.2f}s] {ev.text}",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
