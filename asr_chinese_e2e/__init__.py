"""asr_chinese_e2e — a Mandarin end-to-end ASR framework in JAX/XLA/Pallas,
run on NVIDIA GPUs.

Built from scratch with the capabilities of the reference repo
``zqs01/ASR_chinese_e2e`` (see SURVEY.md), redesigned device-first:

- host data pipeline feeding static-shape, length-bucketed batches;
- log-mel fbank / CMVN / LFR / SpecAugment computed on device (jnp);
- Transformer, Conformer & BiLSTM encoders, attention decoder, CTC head,
  as modules over plain parameter pytrees (``models/nn.py``);
- hybrid CTC / label-smoothed-CE training with Noam-Adam, grad clip; the
  CTC recursions as a Pallas (Triton) GPU kernel;
- jitted train step sharded over a ``jax.sharding.Mesh`` (data / model
  / seq axes), collectives compiled by XLA onto NCCL over NVLink;
- fixed-shape batched beam search with KV cache on device.
"""

__version__ = "0.1.0"

# Persistent XLA compilation cache (opt-out: ASR_COMPILE_CACHE=0). Where
# JAX_COMPILATION_CACHE_DIR is set, JAX already caches there and nothing
# is set here. Otherwise compiled programs go to ``<checkout>/.jax_cache``
# (git-ignored): a fixed path, since the path is part of what makes a
# later process find an entry again.
import os as _os

if _os.environ.get("ASR_COMPILE_CACHE", "1") != "0" and not _os.environ.get(
    "JAX_COMPILATION_CACHE_DIR"
):
    import jax as _jax

    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache",
        ),
    )
