"""Speech-Transformer encoder/decoder with optional CTC head — the flagship
model family.

Capability parity with ``Predictor/Models/transformer_official.py:34-458``
(the variant the reference actually trains, ``main.py:103``):

- Encoder: Dense(input_dim→d_model) + LayerNorm + sinusoidal PE + dropout
  (``transformer_official.py:147-177``), then N×(MHA + FFN) layers;
- Decoder: tied input embedding / output projection
  (``transformer_official.py:253-258``), sos/eos re-derivation from labels
  (``preprocess``, ``transformer_official.py:260-275``), causal self-attn +
  cross-attn + FFN layers;
- default hyperparams d_model=512, 8 heads, d_k=64, d_ff=1024, dropout 0.1,
  6+6 layers (``transformer_official.py:112-124``).

Deliberate deltas from the reference (SURVEY §7):
- additive-bias masks built once per batch from lengths;
- KV-cached ``decode_step`` so beam search is a fixed-shape device loop, not
  a per-hypothesis Python re-forward (``transformer_official.py:359-380``);
- optional CTC head on encoder outputs (hybrid objective — net-new);
- optional Conv2d subsampling front-end (the ``CNNs/cnns.py:4-9`` intent);
- bfloat16 compute / float32 params; pre- or post-norm.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import Config
from ..data.vocab import BOS_ID, EOS_ID, PAD_ID
from ..ops.masks import NEG_INF, causal_padding_bias, padding_bias
from . import nn
from .layers import (
    ConfigurableDropout,
    ConvModule,
    ConvSubsampler,
    MultiHeadAttention,
    PositionalEncoding,
    PositionwiseFFN,
    SubLayer,
    sinusoid_table,
)


def default_config() -> Config:
    """TransformerOffical defaults (``transformer_official.py:112-124``)."""
    return Config(
        d_model=512,
        num_heads=8,
        head_dim=64,
        d_ff=1024,
        num_encoder_layers=6,
        num_decoder_layers=6,
        dropout_rate=0.1,
        norm_type="post",  # reference placement; "pre" available
        input_dim=320,  # n_mels * lfr_m (transformer_official.py:42)
        frontend="linear",  # or "conv2d" subsampling
        attention_band=0,  # >0: banded encoder self-attn ±band frames
        # (TransformerNew's ±50 local attention, transformer_new.py:53)
        causal_encoder=False,  # strictly-left-context encoder attention
        # (with attention_band: a bounded [i-band, i] window) — the
        # streaming-encoder mode; enables exact chunked incremental
        # encoding via Encoder.encode_chunk (see stream.py)
        encoder_type="transformer",  # or "conformer" (conv-augmented
        # blocks — net-new family beyond the attention-only reference)
        conv_kernel_size=15,  # conformer depthwise conv width
        attn_impl="xla",  # encoder self-attn: "xla" | "ring" (sequence
        # parallelism over the `seq` mesh axis)
        attn_weight_dropout=True,  # reference parity; False saves big masks
        dropout_impl="rng",  # "rng" (nn.Dropout, rbg/threefry bits)
        # | "hash" (index-keyed hash mask, fuses into producers — no rng
        # tensor in HBM; see layers.ConfigurableDropout)
        deepnorm=False,  # DeepNet post-LN stabilizer: residual
        # up-scaling alpha + v/out/FFN init down-scaling beta — the
        # round-4 VERDICT #1 stabilizer knob for post-LN at depth (no-op
        # under norm_type='pre')
        ctc_weight=0.0,  # 0 == reference's pure-CE objective
        label_smoothing=0.0,  # invoked at 0.0 in the reference
        max_target_len=128,
        dtype="float32",
    )


def deepnorm_coeffs(cfg):
    """DeepNorm (alpha, beta) for the encoder and decoder stacks (DeepNet,
    Wang et al. 2022, Fig. 2 encoder-decoder prescription): residual
    branches are up-weighted by alpha inside post-LN (SubLayer.alpha) and
    FFN/value/output-projection inits scaled down by beta (scaled_init).
    Returns ((enc_alpha, enc_beta), (dec_alpha, dec_beta)); all 1.0 when
    the ``deepnorm`` knob is off or the placement is pre-LN (DeepNorm is a
    post-LN construction)."""
    if not cfg.get("deepnorm", False) or cfg.get("norm_type", "post") != "post":
        return (1.0, 1.0), (1.0, 1.0)
    n = cfg.num_encoder_layers
    m = cfg.get("num_decoder_layers", 0)
    if m == 0:  # encoder-only prescription
        return ((2.0 * n) ** 0.25, (8.0 * n) ** -0.25), (1.0, 1.0)
    enc = (0.81 * (n**4 * m) ** (1.0 / 16), 0.87 * (n**4 * m) ** (-1.0 / 16))
    dec = ((3.0 * m) ** 0.25, (12.0 * m) ** -0.25)
    return enc, dec


def _encoder_self_attention(cfg, attn, x, bias, deterministic, lengths):
    """Shared encoder self-attention dispatch (EncoderLayer and
    ConformerBlock). ``attn_impl='ring'`` shards the sequence over the
    ``seq`` mesh axis; it has no banded-mask support, so banded / causal
    patterns always take the XLA bias path."""
    impl = cfg.get("attn_impl", "xla")
    if impl not in ("xla", "ring"):
        raise ValueError(f"unknown attn_impl {impl!r}: 'xla' or 'ring'")
    patterned = cfg.get("attention_band", 0) or cfg.get("causal_encoder", False)
    if impl == "ring" and lengths is not None and not patterned:
        return attn.ring(x, lengths, deterministic)
    return attn(x, x, bias, deterministic)


class EncoderLayer(nn.Module):
    cfg: Config
    dtype: Any

    def setup(self):
        c = self.cfg
        (alpha, beta), _ = deepnorm_coeffs(c)
        di = c.get("dropout_impl", "rng")
        self.attn = MultiHeadAttention(
            c.num_heads, c.d_model, c.head_dim, c.dropout_rate, self.dtype,
            weight_dropout=c.get("attn_weight_dropout", True),
            init_scale=beta, dropout_impl=di,
        )
        self.ffn = PositionwiseFFN(
            c.d_model, c.d_ff, c.dropout_rate, self.dtype, init_scale=beta,
            dropout_impl=di,
        )
        self.sub1 = SubLayer(c.norm_type, self.dtype, alpha=alpha)
        self.sub2 = SubLayer(c.norm_type, self.dtype, alpha=alpha)

    def __call__(self, x, bias, deterministic=True, lengths=None):
        x = self.sub1(
            x,
            lambda y: _encoder_self_attention(
                self.cfg, self.attn, y, bias, deterministic, lengths
            ),
        )
        return self.sub2(x, lambda y: self.ffn(y, deterministic))

    def chunk_step(self, x, tail, bias):
        """Incremental encode step for the streaming (causal-banded) mode.

        ``x``: (B, F, D) the new chunk's layer input; ``tail``: (B, w, D)
        this layer's input for the previous ``w`` frames (the full causal
        receptive field at band w); ``bias``: (1, 1, F, w+F) additive mask
        built by ``Encoder.encode_chunk``. Exact: queries are the F new
        frames, keys/values the tail + new frames — identical math to the
        offline causal-banded pass restricted to the new rows."""
        if self.cfg.norm_type == "pre":
            qn = self.sub1.norm(x)
            kv = jnp.concatenate([self.sub1.norm(tail), qn], axis=1)
            x = x + self.attn(qn, kv, bias, True)
            x = x + self.ffn(self.sub2.norm(x), True)
        else:
            kv = jnp.concatenate([tail, x], axis=1)
            a1, a2 = self.sub1.alpha, self.sub2.alpha
            x = self.sub1.norm(a1 * x + self.attn(x, kv, bias, True))
            x = self.sub2.norm(a2 * x + self.ffn(x, True))
        return x


class ConformerBlock(nn.Module):
    """Conformer block (Gulati et al. 2020): macaron half-step FFNs
    sandwiching self-attention and a convolution module, final LayerNorm.

    Net-new encoder family — the reference's model zoo is attention-only
    (SURVEY §2.4); selected with ``encoder_type='conformer'``. Reuses this
    framework's MultiHeadAttention, so every ``attn_impl`` (xla / ring
    sequence-parallel) works unchanged, as do
    the decoder, CTC head and every decode mode. The block is inherently
    pre-norm (its own LN placement); ``norm_type`` still governs the
    decoder."""

    cfg: Config
    dtype: Any

    def setup(self):
        c = self.cfg
        di = c.get("dropout_impl", "rng")
        self.ffn1 = PositionwiseFFN(
            c.d_model, c.d_ff, c.dropout_rate, self.dtype, dropout_impl=di
        )
        self.ffn2 = PositionwiseFFN(
            c.d_model, c.d_ff, c.dropout_rate, self.dtype, dropout_impl=di
        )
        self.attn = MultiHeadAttention(
            c.num_heads, c.d_model, c.head_dim, c.dropout_rate, self.dtype,
            weight_dropout=c.get("attn_weight_dropout", True), dropout_impl=di,
        )
        self.conv = ConvModule(
            c.d_model, c.get("conv_kernel_size", 15), c.dropout_rate, self.dtype,
            # under causal_encoder the depthwise conv must not read future
            # frames (a centered SAME kernel would silently leak them past
            # the causal attention bias — r4 ADVICE #2)
            causal=c.get("causal_encoder", False), dropout_impl=di,
        )
        self.ln_ffn1 = nn.LayerNorm(dtype=self.dtype)
        self.ln_attn = nn.LayerNorm(dtype=self.dtype)
        self.ln_conv = nn.LayerNorm(dtype=self.dtype)
        self.ln_ffn2 = nn.LayerNorm(dtype=self.dtype)
        self.ln_final = nn.LayerNorm(dtype=self.dtype)

    def __call__(self, x, bias, deterministic=True, lengths=None):
        x = x + 0.5 * self.ffn1(self.ln_ffn1(x), deterministic)
        a = _encoder_self_attention(
            self.cfg, self.attn, self.ln_attn(x), bias, deterministic, lengths
        )
        x = x + a
        x = x + self.conv(self.ln_conv(x), lengths, deterministic)
        x = x + 0.5 * self.ffn2(self.ln_ffn2(x), deterministic)
        return self.ln_final(x)

    def chunk_step(self, x, tail, conv_carry, bias, carry_mask):
        """Incremental encode step for the streaming conformer (round-4
        VERDICT #6). Exact chunked evaluation needs TWO carries per layer:

        - ``tail`` (B, w, D): previous ``w`` frames of the BLOCK INPUT (the
          attention receptive field at band w). Their post-ffn1 values are
          recomputed here — ffn1 is pointwise per frame, so this is exact.
        - ``conv_carry`` (B, k-1, D): previous k-1 frames of the conv-module
          input (post-attention residual stream). The causal depthwise conv
          at new frame t reads [t-k+1, t]; pw1/GLU are pointwise, so
          recomputing them on the carried frames is exact.

        ``carry_mask`` (1, k-1): 1.0 where the carry row's GLOBAL frame
        index is >= 0 — at stream start the offline causal conv reads its
        zero LEFT padding in GLU space, so the zero-initialised carry
        (which is zero in residual-stream space, NOT GLU space) must be
        masked after pw1/GLU. Returns (out (B, F, D), new_conv_carry)."""
        kc = conv_carry.shape[1]
        tail1 = tail + 0.5 * self.ffn1(self.ln_ffn1(tail), True)
        x1 = x + 0.5 * self.ffn1(self.ln_ffn1(x), True)
        kv = jnp.concatenate([self.ln_attn(tail1), self.ln_attn(x1)], axis=1)
        x2 = x1 + self.attn(self.ln_attn(x1), kv, bias, True)
        conv_in = jnp.concatenate([conv_carry, x2], axis=1)
        fmask = jnp.concatenate(
            [
                jnp.broadcast_to(carry_mask, (x.shape[0], kc)),
                jnp.ones((x.shape[0], x.shape[1]), carry_mask.dtype),
            ],
            axis=1,
        )
        y = self.conv(self.ln_conv(conv_in), None, True, frame_mask=fmask)
        x3 = x2 + y[:, kc:]
        x4 = x3 + 0.5 * self.ffn2(self.ln_ffn2(x3), True)
        return self.ln_final(x4), conv_in[:, -kc:]


def init_chunk_state(cfg, batch: int):
    """Zero left-context carries for ``Encoder.encode_chunk``, one pytree
    per layer. Plain transformer: a (B, band, d) input tail (zeros are
    never attended — encode_chunk masks keys with negative global index).
    Conformer: additionally a (B, k-1, d) causal-conv input carry (zero
    rows are masked post-GLU to match the offline conv's zero padding).
    Module-free so host code (stream.py) can build state without a model
    apply."""
    w = cfg.attention_band
    dt = jnp.bfloat16 if cfg.get("dtype") == "bfloat16" else jnp.float32
    tail = lambda: jnp.zeros((batch, w, cfg.d_model), dt)
    if cfg.get("encoder_type", "transformer") == "conformer":
        kc = cfg.get("conv_kernel_size", 15) - 1
        return [
            {"tail": tail(), "conv": jnp.zeros((batch, kc, cfg.d_model), dt)}
            for _ in range(cfg.num_encoder_layers)
        ]
    return [tail() for _ in range(cfg.num_encoder_layers)]


class Encoder(nn.Module):
    cfg: Config
    dtype: Any

    def setup(self):
        c = self.cfg
        if c.frontend == "conv2d":
            self.frontend_mod = ConvSubsampler(c.d_model, self.dtype)
        else:
            self.input_proj = nn.Dense(c.d_model, dtype=self.dtype)
            self.input_norm = nn.LayerNorm(dtype=self.dtype)
        self.pe = PositionalEncoding(c.d_model)
        self.dropout = ConfigurableDropout(
            c.dropout_rate, c.get("dropout_impl", "rng")
        )
        layer_cls = (
            ConformerBlock
            if c.get("encoder_type", "transformer") == "conformer"
            else EncoderLayer
        )
        if c.get("remat", False):
            # rematerialize layer activations in backward (jax.checkpoint):
            # trades ~30% more encoder FLOPs for O(layers) less activation
            # memory — the deep-encoder / long-utterance / big-batch knob
            layer_cls = nn.remat(layer_cls)
        self.layers = [
            layer_cls(c, self.dtype, name=f"layer{i}")
            for i in range(c.num_encoder_layers)
        ]
        # conformer blocks carry their own final LN; the extra pre-norm
        # output LN applies to the plain transformer stack only
        self.final_norm = (
            nn.LayerNorm(dtype=self.dtype)
            if c.norm_type == "pre"
            and c.get("encoder_type", "transformer") != "conformer"
            else None
        )

    def __call__(self, feats, feat_lengths, deterministic=True):
        c = self.cfg
        if c.frontend == "conv2d":
            x, feat_lengths = self.frontend_mod(feats.astype(self.dtype), feat_lengths)
        else:
            x = self.input_norm(self.input_proj(feats.astype(self.dtype)))
        x = self.pe(x)
        x = self.dropout(x, deterministic=deterministic)
        bias = padding_bias(feat_lengths, x.shape[1])
        if c.get("causal_encoder", False):
            from ..ops.masks import causal_banded_bias, causal_bias

            band = c.get("attention_band", 0)
            bias = bias + (
                causal_banded_bias(x.shape[1], band)
                if band
                else causal_bias(x.shape[1])
            )
        elif c.get("attention_band", 0):
            from ..ops.masks import banded_bias

            bias = bias + banded_bias(x.shape[1], c.attention_band)
        for layer in self.layers:
            x = layer(x, bias, deterministic, feat_lengths)
        if self.final_norm is not None:
            x = self.final_norm(x)
        return x, feat_lengths

    # -- streaming: exact chunked incremental encoding ----------------------
    def init_chunk_tails(self, batch: int):
        """Zero left-context carries (see ``init_chunk_state``)."""
        return init_chunk_state(self.cfg, batch)

    def encode_chunk(self, feats_chunk, tails, offset):
        """Encode F new frames given per-layer left-context carries — EXACT
        chunked evaluation of the causal-banded encoder: concatenating the
        outputs over chunks equals one full-sequence pass (tested in
        tests/test_streaming_encoder.py).

        Requires ``causal_encoder=True`` + ``attention_band`` w > 0 (the
        causal attention receptive field of one layer is then w frames, so
        a (B, w, d) input tail per layer is sufficient attention state)
        and the linear frontend. Both encoder families stream: the plain
        transformer carries one input tail per layer; the conformer
        additionally carries k-1 frames of causal-depthwise-conv input
        (``ConformerBlock.chunk_step`` — round-4 VERDICT #6).

        feats_chunk: (B, F, input_dim); tails: per-layer carry pytree from
        ``init_chunk_tails``; offset: int32 global frame index of the
        chunk's first frame (traced — one compiled program serves every
        chunk). Returns (enc_chunk (B, F, d), new_tails). All F frames are
        treated as real: feed only full chunks mid-stream and pad the
        final flush chunk, ignoring outputs past its valid count
        (causality keeps padded FUTURE frames out of every valid row)."""
        c = self.cfg
        assert c.get("causal_encoder", False) and c.get("attention_band", 0), (
            "encode_chunk requires causal_encoder=True and attention_band>0"
        )
        assert c.frontend == "linear", "encode_chunk: linear frontend only"
        conformer = c.get("encoder_type", "transformer") == "conformer"
        w = c.attention_band
        x = self.input_norm(self.input_proj(feats_chunk.astype(self.dtype)))
        f = x.shape[1]
        table = jnp.asarray(sinusoid_table(self.pe.max_len, c.d_model))
        pe = jax.lax.dynamic_slice_in_dim(table, offset, f, axis=0)
        x = x + pe[None].astype(x.dtype)
        # (1, 1, F, w+F) bias: query i sits at global offset+i, key j at
        # global offset-w+j; allow 0 <= (global q - global k) <= w and
        # global k >= 0 (stream start: the zero carry is never attended)
        qi = jnp.arange(f)[:, None]
        kj = jnp.arange(w + f)[None, :]
        rel = (qi + w) - kj
        gk = offset - w + kj
        allow = (rel >= 0) & (rel <= w) & (gk >= 0)
        bias = jnp.where(allow, 0.0, NEG_INF)[None, None]
        if conformer:
            kc = c.get("conv_kernel_size", 15) - 1
            # conv-carry row r holds global frame offset-kc+r; rows with a
            # negative global index stand in for the conv's zero left
            # padding (masked post-GLU in chunk_step)
            carry_mask = ((offset - kc + jnp.arange(kc)) >= 0).astype(
                self.dtype
            )[None]
        new_tails = []
        for layer, st in zip(self.layers, tails):
            if conformer:
                new_tail = jnp.concatenate([st["tail"], x], axis=1)[:, -w:]
                x, new_conv = layer.chunk_step(
                    x, st["tail"], st["conv"], bias, carry_mask
                )
                new_tails.append({"tail": new_tail, "conv": new_conv})
            else:
                new_tails.append(jnp.concatenate([st, x], axis=1)[:, -w:])
                x = layer.chunk_step(x, st, bias)
        if self.final_norm is not None:
            x = self.final_norm(x)
        return x, new_tails


class DecoderLayer(nn.Module):
    cfg: Config
    dtype: Any

    def setup(self):
        c = self.cfg
        wd = c.get("attn_weight_dropout", True)
        _, (alpha, beta) = deepnorm_coeffs(c)
        di = c.get("dropout_impl", "rng")
        self.self_attn = MultiHeadAttention(
            c.num_heads, c.d_model, c.head_dim, c.dropout_rate, self.dtype,
            weight_dropout=wd, init_scale=beta, dropout_impl=di,
        )
        self.cross_attn = MultiHeadAttention(
            c.num_heads, c.d_model, c.head_dim, c.dropout_rate, self.dtype,
            weight_dropout=wd, init_scale=beta, dropout_impl=di,
        )
        self.ffn = PositionwiseFFN(
            c.d_model, c.d_ff, c.dropout_rate, self.dtype, init_scale=beta,
            dropout_impl=di,
        )
        self.sub1 = SubLayer(c.norm_type, self.dtype, alpha=alpha)
        self.sub2 = SubLayer(c.norm_type, self.dtype, alpha=alpha)
        self.sub3 = SubLayer(c.norm_type, self.dtype, alpha=alpha)

    def __call__(self, x, enc_out, self_bias, cross_bias, deterministic=True):
        x = self.sub1(x, lambda y: self.self_attn(y, y, self_bias, deterministic))
        x = self.sub2(
            x, lambda y: self.cross_attn(y, enc_out, cross_bias, deterministic)
        )
        return self.sub3(x, lambda y: self.ffn(y, deterministic))

    def step(self, x, self_cache, cross_cache, index, self_bias, cross_bias):
        """Cached single-token decode step. x: (B, 1, D)."""
        x, new_self = self.sub1(
            x,
            lambda y: self.self_attn.step_self(y, self_cache, index, self_bias),
            has_aux=True,
        )
        x = self.sub2(x, lambda y: self.cross_attn.step_cross(y, cross_cache, cross_bias))
        x = self.sub3(x, lambda y: self.ffn(y, True))
        return x, new_self

    def step_lazy(self, x, self_cache, cross_cache, index, anc, self_bias, cross_bias):
        """Like ``step`` but with lazy beam reorder: the self-attn cache is
        left unpermuted and ``anc`` routes each hypothesis to its ancestor's
        cache rows (see ``MultiHeadAttention.step_self_lazy``)."""
        x, new_self = self.sub1(
            x,
            lambda y: self.self_attn.step_self_lazy(
                y, self_cache, index, anc, self_bias
            ),
            has_aux=True,
        )
        x = self.sub2(x, lambda y: self.cross_attn.step_cross(y, cross_cache, cross_bias))
        x = self.sub3(x, lambda y: self.ffn(y, True))
        return x, new_self

    def make_cross_cache(self, enc_out):
        k, v = self.cross_attn.kv(enc_out)
        return {"k": k, "v": v}


class Decoder(nn.Module):
    cfg: Config
    vocab_size: int
    dtype: Any

    def setup(self):
        c = self.cfg
        self.embed = nn.Embed(self.vocab_size, c.d_model, dtype=self.dtype)
        self.pe = PositionalEncoding(c.d_model)
        self.dropout = ConfigurableDropout(
            c.dropout_rate, c.get("dropout_impl", "rng")
        )
        layer_cls = DecoderLayer
        if c.get("remat", False):
            layer_cls = nn.remat(DecoderLayer)
        self.layers = [
            layer_cls(c, self.dtype, name=f"layer{i}")
            for i in range(c.num_decoder_layers)
        ]
        self.final_norm = (
            nn.LayerNorm(dtype=self.dtype) if c.norm_type == "pre" else None
        )

    def _embed_scaled(self, ys):
        return self.embed(ys) * np.float32(np.sqrt(self.cfg.d_model))

    def _project(self, x):
        # tied output projection (transformer_official.py:253-258)
        return self.embed.attend(x.astype(self.dtype)).astype(jnp.float32)

    def __call__(self, ys_in, ys_in_lengths, enc_out, enc_lengths, deterministic=True):
        t = ys_in.shape[1]
        x = self._embed_scaled(ys_in)
        x = self.pe(x)
        x = self.dropout(x, deterministic=deterministic)
        self_bias = causal_padding_bias(ys_in_lengths, t)
        cross_bias = padding_bias(enc_lengths, enc_out.shape[1])
        for layer in self.layers:
            x = layer(x, enc_out, self_bias, cross_bias, deterministic)
        if self.final_norm is not None:
            x = self.final_norm(x)
        return self._project(x)

    # -- cached autoregressive decoding -------------------------------------
    def init_state(self, enc_out, enc_lengths, batch: int, max_len: int):
        """Build decode state: {"carry": per-hypothesis state the beam must
        GATHER when reordering (self-attn k/v), "static": beam-invariant
        tensors (cross k/v, cross bias) the beam must NOT gather — they are
        identical across a utterance's hypotheses and re-gathering them
        costs GBs of HBM traffic per step. ``batch`` may be B*beam."""
        self_caches = [
            l.self_attn.make_cache(batch, max_len) for l in self.layers
        ]
        cross_caches = [l.make_cross_cache(enc_out) for l in self.layers]
        cross_bias = padding_bias(enc_lengths, enc_out.shape[1])
        return {
            "carry": {"self": self_caches},
            "static": {"cross": cross_caches, "cross_bias": cross_bias},
        }

    def step(self, tokens, state, index):
        """One decode step. tokens: (B,) int32 token at position ``index``.
        Returns (log-probs over vocab (B, V), new state)."""
        x = self._embed_scaled(tokens[:, None])
        table = jnp.asarray(sinusoid_table(self.pe.max_len, self.cfg.d_model))
        x = x + table[index][None, None].astype(x.dtype)
        # self-attn bias over cache positions: allow j <= index
        self_caches = state["carry"]["self"]
        max_len = self_caches[0]["k"].shape[2]  # static cache length (B, H, T, d)
        pos = jnp.arange(max_len)[None, None, None, :]
        self_bias = jnp.where(pos <= index, 0.0, NEG_INF)
        new_self = []
        cross_bias = state["static"]["cross_bias"]
        for layer, sc, cc in zip(self.layers, self_caches, state["static"]["cross"]):
            x, nsc = layer.step(x, sc, cc, index, self_bias, cross_bias)
            new_self.append(nsc)
        if self.final_norm is not None:
            x = self.final_norm(x)
        logits = self._project(x)[:, 0]
        new_state = {"carry": {"self": new_self}, "static": state["static"]}
        return jax.nn.log_softmax(logits, axis=-1), new_state

    def step_lazy(self, tokens, state, index, anc):
        """One decode step with lazy beam reorder. tokens: (B·K,) int32;
        anc: (B, K, Lmax) ancestry map (see ``step_self_lazy``). The beam
        loop never gathers the self caches — it only permutes ``anc``."""
        x = self._embed_scaled(tokens[:, None])
        table = jnp.asarray(sinusoid_table(self.pe.max_len, self.cfg.d_model))
        x = x + table[index][None, None].astype(x.dtype)
        self_caches = state["carry"]["self"]
        max_len = self_caches[0]["k"].shape[2]
        pos = jnp.arange(max_len)[None, None, None, :]
        self_bias = jnp.where(pos <= index, 0.0, NEG_INF)
        new_self = []
        cross_bias = state["static"]["cross_bias"]
        for layer, sc, cc in zip(self.layers, self_caches, state["static"]["cross"]):
            x, nsc = layer.step_lazy(x, sc, cc, index, anc, self_bias, cross_bias)
            new_self.append(nsc)
        if self.final_norm is not None:
            x = self.final_norm(x)
        logits = self._project(x)[:, 0]
        new_state = {"carry": {"self": new_self}, "static": state["static"]}
        return jax.nn.log_softmax(logits, axis=-1), new_state


def preprocess_targets(labels: jnp.ndarray, label_lengths: jnp.ndarray):
    """labels (B, L) PAD-padded -> (ys_in (B, L+1), ys_out (B, L+1)).

    Mirrors ``Decoder.preprocess`` (``transformer_official.py:260-275``):
    ys_in = [sos, labels...], ys_out = [labels..., eos], PAD elsewhere
    (PAD == IGNORE_ID so CE skips it)."""
    b, l = labels.shape
    bos = jnp.full((b, 1), BOS_ID, dtype=labels.dtype)
    ys_in = jnp.concatenate([bos, labels], axis=1)
    pad_col = jnp.full((b, 1), PAD_ID, dtype=labels.dtype)
    base = jnp.concatenate([labels, pad_col], axis=1)
    eos_onehot = (
        jnp.arange(l + 1)[None, :] == label_lengths[:, None]
    ).astype(labels.dtype)
    ys_out = base + EOS_ID * eos_onehot
    return ys_in, ys_out


class SpeechTransformer(nn.Module):
    """Hybrid CTC/attention Speech-Transformer (flagship model)."""

    cfg: Config
    vocab_size: int

    @property
    def dtype(self):
        return jnp.bfloat16 if self.cfg.dtype == "bfloat16" else jnp.float32

    def setup(self):
        self.encoder = Encoder(self.cfg, self.dtype)
        self.decoder = Decoder(self.cfg, self.vocab_size, self.dtype)
        if self.cfg.ctc_weight > 0.0:
            self.ctc_head = nn.Dense(self.vocab_size, dtype=self.dtype)

    def __call__(self, feats, feat_lengths, labels, label_lengths, deterministic=True):
        """Teacher-forced forward. Returns dict with ce logits + gold and
        (if enabled) ctc logits (mirrors forward -> (pred, gold),
        ``transformer_official.py:68-81``)."""
        enc_out, enc_lengths = self.encoder(feats, feat_lengths, deterministic)
        ys_in, ys_out = preprocess_targets(labels, label_lengths)
        logits = self.decoder(
            ys_in, label_lengths + 1, enc_out, enc_lengths, deterministic
        )
        out = {
            "logits": logits,
            "gold": ys_out,
            "enc_out": enc_out,
            "enc_lengths": enc_lengths,
        }
        if self.cfg.ctc_weight > 0.0:
            # kept in model dtype: the CTC loss upcasts internally
            # (exact f32 selection/logsumexp) — materializing the
            # (B, T, vocab) tensor in f32 here doubled its HBM traffic
            out["ctc_logits"] = self.ctc_head(enc_out)
        return out

    # -- decoding entry points (see decode/) --------------------------------
    def encode(self, feats, feat_lengths):
        return self.encoder(feats, feat_lengths, deterministic=True)

    # -- streaming entry points (see stream.py) -----------------------------
    def init_chunk_tails(self, batch: int):
        return self.encoder.init_chunk_tails(batch)

    def encode_chunk(self, feats_chunk, tails, offset):
        """Incremental encode of F new frames (+ CTC log-probs when the
        head exists). Exact w.r.t. the offline causal-banded encode."""
        enc, new_tails = self.encoder.encode_chunk(feats_chunk, tails, offset)
        lp = None
        if self.cfg.ctc_weight > 0.0:
            lp = jax.nn.log_softmax(
                self.ctc_head(enc).astype(jnp.float32), -1
            )
        return enc, new_tails, lp

    def decode_logits(self, ys_in, ys_in_lengths, enc_out, enc_lengths):
        """Uncached full-prefix decoder forward (used by rescoring and as a
        correctness oracle for the cached path)."""
        return self.decoder(ys_in, ys_in_lengths, enc_out, enc_lengths, True)

    # beam search may keep cross K/V at one row per utterance and fold the
    # beam dim into queries (see MultiHeadAttention.step_cross)
    FOLD_BEAM_CROSS = True

    def init_decode_state(self, enc_out, enc_lengths, max_len: int, beam: int = 1):
        """Decode state for ``enc_out.shape[0] * beam`` hypothesis rows.
        Cross K/V stay un-expanded (beam-invariant); self caches are per
        hypothesis."""
        return self.decoder.init_state(
            enc_out, enc_lengths, enc_out.shape[0] * beam, max_len
        )

    def decode_step(self, tokens, state, index):
        return self.decoder.step(tokens, state, index)

    def decode_step_lazy(self, tokens, state, index, anc):
        return self.decoder.step_lazy(tokens, state, index, anc)

    def ctc_log_probs(self, enc_out):
        return jax.nn.log_softmax(self.ctc_head(enc_out).astype(jnp.float32), -1)
