"""RNN model family: BiLSTM encoder + location-aware-attention LSTM decoder.

Net-new capability relative to the reference (which is attention-only —
SURVEY §0: zero grep hits for lstm/gru/rnn); required by the BASELINE.json
north-star configs:
  #1  tiny 2-layer BiLSTM encoder + CTC-only loss (CPU-runnable slice);
  #2  BiLSTM encoder-decoder with location-aware attention + joint CTC/CE.

Design: the recurrence runs under ``lax.scan`` so the whole sequence
compiles to one loop; the per-step matmuls are batched (B, 4H) products.
Variable length is handled by freezing each row's carry past its length,
and the backward direction reverses each row within its own length.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from ..core.config import Config
from ..ops.masks import NEG_INF, length_mask
from . import nn
from .transformer import preprocess_targets


def default_ctc_config() -> Config:
    """North-star config #1: tiny BiLSTM + CTC."""
    return Config(
        hidden_size=128,
        num_encoder_layers=2,
        dropout_rate=0.1,
        input_dim=320,
        ctc_weight=1.0,
        label_smoothing=0.0,
        max_target_len=128,
        dtype="float32",
    )


def default_las_config() -> Config:
    """North-star config #2: BiLSTM enc-dec, location-aware attention,
    joint CTC/CE."""
    cfg = default_ctc_config()
    cfg.build(
        num_encoder_layers=3,
        hidden_size=256,
        embed_dim=256,
        attention_dim=256,
        location_filters=10,
        location_kernel=31,
        num_decoder_layers=1,
        ctc_weight=0.3,
    )
    return cfg


class LSTMCell(nn.Module):
    """LSTM cell: gates (i, f, g, o) from one input and one recurrent
    projection; carry (c, h)."""

    features: int

    def __call__(self, carry, x):
        c, h = carry
        z = nn.Dense(4 * self.features, use_bias=False, name="x")(x) + nn.Dense(
            4 * self.features,
            kernel_init=jax.nn.initializers.orthogonal(),
            name="h",
        )(h)
        i, f, g, o = jnp.split(z, 4, axis=-1)
        c = jax.nn.sigmoid(f) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
        h = jax.nn.sigmoid(o) * jnp.tanh(c)
        return (c, h), h

    def initialize_carry(self, batch: int):
        z = jnp.zeros((batch, self.features), jnp.float32)
        return z, z


def _reverse_within_lengths(x, lengths):
    """Reverse each row's first ``lengths[b]`` steps; padding stays put."""
    t = jnp.arange(x.shape[1])[None, :]
    idx = jnp.where(t < lengths[:, None], lengths[:, None] - 1 - t, t)
    return jnp.take_along_axis(x, idx[..., None], axis=1)


def scan_steps(module, step, carry, xs):
    """``lax.scan`` over axis 0 of ``xs`` for a step that calls submodules.
    Under ``init`` the step runs once outside the scan first, so its
    parameters are created as plain arrays rather than scan tracers."""
    if module.is_initializing():
        step(carry, jax.tree_util.tree_map(lambda a: a[0], xs))
    return jax.lax.scan(step, carry, xs)


def run_lstm(cell, x, lengths, reverse=False):
    """Run ``cell`` over (B, T, F) ``x``; each row's carry freezes past its
    length. ``reverse`` runs every row backwards within its length."""
    if reverse:
        x = _reverse_within_lengths(x, lengths)

    def step(carry, inp):
        x_t, t = inp
        new, h = cell(carry, x_t)
        live = (t < lengths)[:, None]
        carry = jax.tree_util.tree_map(
            lambda n, o: jnp.where(live, n, o), new, carry
        )
        return carry, h

    carry = cell.initialize_carry(x.shape[0])
    _, hs = scan_steps(
        cell, step, carry, (x.swapaxes(0, 1), jnp.arange(x.shape[1]))
    )
    hs = hs.swapaxes(0, 1)
    return _reverse_within_lengths(hs, lengths) if reverse else hs


class BiLSTMEncoder(nn.Module):
    """Stacked bidirectional LSTM over ``lax.scan``."""

    cfg: Config
    dtype: Any = jnp.float32

    def __call__(self, feats, feat_lengths, deterministic=True):
        x = feats.astype(self.dtype)
        h = self.cfg.hidden_size
        for i in range(self.cfg.num_encoder_layers):
            fwd = run_lstm(LSTMCell(h, name=f"fwd{i}"), x, feat_lengths)
            bwd = run_lstm(
                LSTMCell(h, name=f"bwd{i}"), x, feat_lengths, reverse=True
            )
            x = jnp.concatenate([fwd, bwd], axis=-1).astype(self.dtype)
            x = nn.Dropout(self.cfg.dropout_rate)(x, deterministic=deterministic)
        mask = length_mask(feat_lengths, x.shape[1]).astype(x.dtype)
        return x * mask[..., None], feat_lengths


class LocationAwareAttention(nn.Module):
    """Additive attention with convolutional location features.

    score(s, h_j) = w·tanh(W s + V h_j + U f_j + b), f = conv1d(prev_align)
    (Chorowski et al. 2015). Keeps a (B, T) alignment vector as decode
    state; masked positions get NEG_INF before the softmax.
    """

    cfg: Config
    dtype: Any = jnp.float32

    def setup(self):
        a = self.cfg.attention_dim
        self.query_proj = nn.Dense(a, use_bias=True, dtype=self.dtype)
        self.location_conv = nn.Conv(
            self.cfg.location_filters,
            (self.cfg.location_kernel,),
            padding="SAME",
            use_bias=False,
            dtype=self.dtype,
        )
        self.location_proj = nn.Dense(a, use_bias=False, dtype=self.dtype)
        self.score_proj = nn.Dense(1, use_bias=False, dtype=self.dtype)
        self.enc_proj_dense = nn.Dense(a, use_bias=False, dtype=self.dtype)

    def __call__(self, query, enc_proj, enc_out, prev_align, enc_mask_bias):
        """query: (B, D_dec); enc_proj: (B, T, A) = V·enc_out precomputed;
        prev_align: (B, T); enc_mask_bias: (B, T) additive.
        Returns (context (B, D_enc), align (B, T))."""
        q = self.query_proj(query)
        f = self.location_conv(prev_align[..., None].astype(self.dtype))
        f = self.location_proj(f)
        e = self.score_proj(jnp.tanh(q[:, None, :] + enc_proj + f))[..., 0]
        e = e.astype(jnp.float32) + enc_mask_bias
        align = jax.nn.softmax(e, axis=-1)
        context = jnp.einsum("bt,btd->bd", align.astype(self.dtype), enc_out)
        return context, align

    def project_encoder(self, enc_out):
        return self.enc_proj_dense(enc_out)


class LASDecoder(nn.Module):
    """Unidirectional LSTM decoder with location-aware attention.

    Teacher-forced path scans over target positions; ``step`` provides the
    cached single-token path for greedy/beam decoding."""

    cfg: Config
    vocab_size: int
    dtype: Any = jnp.float32

    def setup(self):
        c = self.cfg
        self.embed = nn.Embed(self.vocab_size, c.embed_dim, dtype=self.dtype)
        self.cell = LSTMCell(c.hidden_size)
        self.attention = LocationAwareAttention(c, self.dtype)
        self.out_proj = nn.Dense(self.vocab_size, dtype=self.dtype)
        self.dropout = nn.Dropout(c.dropout_rate)

    def _init_carry(self, batch, enc_out):
        carry = self.cell.initialize_carry(batch)
        align = jnp.zeros((batch, enc_out.shape[1]), jnp.float32)
        context = jnp.zeros((batch, enc_out.shape[-1]), self.dtype)
        return carry, align, context

    def _one_step(self, token_emb, carry, align, context, enc_proj, enc_out, bias):
        inp = jnp.concatenate([token_emb, context], axis=-1)
        carry, s = self.cell(carry, inp)
        context, align = self.attention(s, enc_proj, enc_out, align, bias)
        logits = self.out_proj(jnp.concatenate([s, context], axis=-1))
        return carry, align, context, logits.astype(jnp.float32)

    def __call__(self, ys_in, enc_out, enc_lengths, deterministic=True):
        """Teacher-forced forward over target positions.

        The recurrence runs under ``lax.scan`` (parameters closed over,
        shared by every step) so the compiled program is ONE loop body — a
        Python unroll at max_target_len=128 produces a 128-step unrolled
        HLO graph with minutes-long compiles (see
        ``tests/test_rnn_models.py::test_las_scan_matches_unroll``)."""
        b, l = ys_in.shape
        enc_proj = self.attention.project_encoder(enc_out)
        bias = jnp.where(
            length_mask(enc_lengths, enc_out.shape[1]), 0.0, NEG_INF
        ).astype(jnp.float32)
        emb = self.dropout(self.embed(ys_in), deterministic=deterministic)
        carry0 = self._init_carry(b, enc_out)

        if self.cfg.get("decoder_unroll", False):  # oracle/debug path
            carry, align, context = carry0
            all_logits = []
            for t in range(l):
                carry, align, context, logits = self._one_step(
                    emb[:, t], carry, align, context, enc_proj, enc_out, bias
                )
                all_logits.append(logits)
            return jnp.stack(all_logits, axis=1)

        def body(c, x_t):
            carry, align, context = c
            carry, align, context, logits = self._one_step(
                x_t, carry, align, context, enc_proj, enc_out, bias
            )
            return (carry, align, context), logits

        _, logits = scan_steps(self, body, carry0, emb.swapaxes(0, 1))
        return logits.swapaxes(0, 1)

    # -- cached decode ------------------------------------------------------
    def init_state(self, enc_out, enc_lengths):
        """{"carry": per-hypothesis recurrent state (gathered on beam
        reorder), "static": beam-invariant encoder tensors (never
        gathered)}."""
        b = enc_out.shape[0]
        enc_proj = self.attention.project_encoder(enc_out)
        bias = jnp.where(
            length_mask(enc_lengths, enc_out.shape[1]), 0.0, NEG_INF
        ).astype(jnp.float32)
        carry, align, context = self._init_carry(b, enc_out)
        return {
            "carry": {"cell": carry, "align": align, "context": context},
            "static": {"enc_proj": enc_proj, "enc_out": enc_out, "bias": bias},
        }

    def step(self, tokens, state, index=None):
        del index  # RNN state carries position implicitly
        emb = self.embed(tokens)
        carry, align, context, logits = self._one_step(
            emb,
            state["carry"]["cell"],
            state["carry"]["align"],
            state["carry"]["context"],
            state["static"]["enc_proj"],
            state["static"]["enc_out"],
            state["static"]["bias"],
        )
        new_state = {
            "carry": {"cell": carry, "align": align, "context": context},
            "static": state["static"],
        }
        return jax.nn.log_softmax(logits, axis=-1), new_state


class BiLSTMCTC(nn.Module):
    """North-star config #1: BiLSTM encoder + CTC head only."""

    cfg: Config
    vocab_size: int

    @property
    def dtype(self):
        return jnp.bfloat16 if self.cfg.dtype == "bfloat16" else jnp.float32

    def setup(self):
        self.encoder = BiLSTMEncoder(self.cfg, self.dtype)
        self.ctc_head = nn.Dense(self.vocab_size, dtype=self.dtype)

    def __call__(self, feats, feat_lengths, labels, label_lengths, deterministic=True):
        enc_out, enc_lengths = self.encoder(feats, feat_lengths, deterministic)
        return {
            # model dtype: the CTC loss upcasts internally (exact f32
            # selection/logsumexp)
            "ctc_logits": self.ctc_head(enc_out),
            "enc_out": enc_out,
            "enc_lengths": enc_lengths,
        }

    def encode(self, feats, feat_lengths):
        return self.encoder(feats, feat_lengths, deterministic=True)

    def ctc_log_probs(self, enc_out):
        return jax.nn.log_softmax(self.ctc_head(enc_out).astype(jnp.float32), -1)


class LAS(nn.Module):
    """North-star config #2: BiLSTM enc + location-aware-attention dec,
    joint CTC/CE."""

    cfg: Config
    vocab_size: int

    @property
    def dtype(self):
        return jnp.bfloat16 if self.cfg.dtype == "bfloat16" else jnp.float32

    def setup(self):
        self.encoder = BiLSTMEncoder(self.cfg, self.dtype)
        self.decoder = LASDecoder(self.cfg, self.vocab_size, self.dtype)
        if self.cfg.ctc_weight > 0.0:
            self.ctc_head = nn.Dense(self.vocab_size, dtype=self.dtype)

    def __call__(self, feats, feat_lengths, labels, label_lengths, deterministic=True):
        enc_out, enc_lengths = self.encoder(feats, feat_lengths, deterministic)
        ys_in, ys_out = preprocess_targets(labels, label_lengths)
        logits = self.decoder(ys_in, enc_out, enc_lengths, deterministic)
        out = {
            "logits": logits,
            "gold": ys_out,
            "enc_out": enc_out,
            "enc_lengths": enc_lengths,
        }
        if self.cfg.ctc_weight > 0.0:
            out["ctc_logits"] = self.ctc_head(enc_out)
        return out

    def encode(self, feats, feat_lengths):
        return self.encoder(feats, feat_lengths, deterministic=True)

    def init_decode_state(self, enc_out, enc_lengths, max_len: int = 0):
        del max_len
        return self.decoder.init_state(enc_out, enc_lengths)

    def decode_step(self, tokens, state, index=None):
        return self.decoder.step(tokens, state, index)

    def ctc_log_probs(self, enc_out):
        return jax.nn.log_softmax(self.ctc_head(enc_out).astype(jnp.float32), -1)
