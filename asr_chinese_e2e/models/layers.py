"""Shared layers: sinusoidal PE, multi-head attention (with functional
KV cache for decoding), position-wise FFN, conv subsampling front-end.

Capability parity with ``Predictor/Models/attention.py:6-87`` and
``Predictor/Models/module.py:8-75`` (Speech-Transformer style: scaled
dot-product with temperature √d_k, attention dropout, residual + LayerNorm
around each sublayer), redesigned for a compiled accelerator:

- masks are additive biases fused into the logits (see ``ops/masks.py``),
  not ``masked_fill`` on boolean tensors;
- attention math runs in a configurable compute dtype (bfloat16 on the GPU) with
  float32 softmax;
- the KV cache is an explicit pytree argument (cache in → cache out), so
  autoregressive decoding runs under ``lax.while_loop`` / ``lax.scan`` with
  fixed shapes instead of the reference's per-hypothesis Python re-forward
  (``transformer_official.py:359-380``).
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import nn


def sinusoid_table(max_len: int, d_model: int) -> np.ndarray:
    """Sinusoidal positional encodings (``module.py:8-25``): sin on even
    dims, cos on odd dims, angle = pos / 10000^(2i/d)."""
    pos = np.arange(max_len)[:, None].astype(np.float64)
    i = np.arange(d_model)[None, :]
    angle = pos / np.power(10000.0, 2 * (i // 2) / d_model)
    table = np.zeros((max_len, d_model))
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)


def hash_keep_mask(seed, shape, rate: float, dtype):
    """Inverted-dropout mask: 1/(1-rate) where a murmur-style hash of
    (flat element index, ``seed``) clears the rate threshold, else 0.
    ``seed``: uint32 scalar."""
    i = jax.lax.iota(jnp.uint32, int(np.prod(shape))).reshape(shape)
    h = i * jnp.uint32(0x9E3779B9) ^ (seed * jnp.uint32(0xC2B2AE35))
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    threshold = jnp.uint32(min(int(rate * (1 << 32)), (1 << 32) - 1))
    return (h >= threshold).astype(dtype) / np.asarray(1.0 - rate, dtype)


def attend(q, k, v, bias, dtype, drop_weights=None):
    """Scaled dot-product attention over (B, T, H, d) inputs:
    softmax(q·kᵀ/√d + bias)·v with the scores accumulated and normalised
    in float32, the weights cast to ``dtype``. ``bias``: additive,
    broadcastable to (B, H, Tq, Tk), or None. ``drop_weights``: optional
    function applied to the (B, H, Tq, Tk) weights (attention dropout)."""
    scale = 1.0 / np.sqrt(q.shape[-1])  # attention.py:16 temperature
    logits = (
        jnp.einsum("bqhd,bkhd->bhqk", q, k, preferred_element_type=jnp.float32)
        * scale
    )
    if bias is not None:
        logits = logits + bias
    weights = jax.nn.softmax(logits, axis=-1).astype(dtype)
    if drop_weights is not None:
        weights = drop_weights(weights)
    return jnp.einsum("bhqk,bkhd->bqhd", weights, v)


def scaled_init(scale: float):
    """Xavier-normal init scaled by ``scale`` — DeepNorm's beta init
    (DeepNet Eq. 14: FFN / value / output projections initialized with
    gain beta < 1 so early residual updates stay small in post-LN
    stacks)."""
    base = jax.nn.initializers.xavier_normal()

    def init(key, shape, dtype=jnp.float32):
        return base(key, shape, dtype) * scale

    return init


class ConfigurableDropout(nn.Module):
    """Dropout with a selectable mask generator.

    ``impl='rng'``: ``nn.Dropout`` (a Bernoulli mask from the ``dropout``
    rng's bit stream — the reference-faithful default). ``impl='hash'``:
    keep an element when a murmur-style hash of (flat element index,
    per-call seed) clears the rate threshold. The hash mask is pure
    elementwise math over an iota, so XLA fuses it into the producer and
    consumer ops: no random-bit tensor is written to device memory, and
    the backward pass can recompute the mask instead of saving it."""

    rate: float
    impl: str = "rng"

    def __call__(self, x: jnp.ndarray, deterministic: bool = True):
        if self.impl != "hash":
            return nn.Dropout(self.rate, name="drop")(
                x, deterministic=deterministic
            )
        if deterministic or self.rate == 0.0:
            return x
        seed = jax.random.randint(
            self.make_rng("dropout"), (), 0, 2**31 - 1, dtype=jnp.int32
        ).astype(jnp.uint32)
        return x * hash_keep_mask(seed, x.shape, self.rate, x.dtype)


class PositionalEncoding(nn.Module):
    d_model: int
    max_len: int = 5000

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        table = jnp.asarray(sinusoid_table(self.max_len, self.d_model))
        return x + table[None, : x.shape[1]].astype(x.dtype)


class MultiHeadAttention(nn.Module):
    """Scaled dot-product MHA with additive-bias masking and explicit cache.

    Parity target: ``attention.py:6-60`` (n_head, d_k, d_v, temperature
    √d_k, attention dropout, output projection + dropout; residual+LN is
    handled by the caller so pre/post-norm stay configurable).
    """

    num_heads: int
    d_model: int
    head_dim: int
    dropout_rate: float = 0.1
    dtype: Any = jnp.float32
    # dropout ON the attention weights (reference behavior,
    # attention.py:17). False drops only the output — saves generating
    # and storing (B, H, Tq, Tk) masks every step.
    weight_dropout: bool = True
    # DeepNorm beta: scales the v/out projection INIT down (DeepNet,
    # Wang et al. 2022) — the residual-stabilizing half of the post-LN
    # ``deepnorm`` knob (SubLayer.alpha is the other half). 1.0 = stock.
    init_scale: float = 1.0
    dropout_impl: str = "rng"  # see ConfigurableDropout

    def setup(self):
        h, dk = self.num_heads, self.head_dim
        dg = lambda name, init=None: nn.DenseGeneral(
            features=(h, dk), axis=-1, name=name, dtype=self.dtype,
            **({"kernel_init": init} if init is not None else {}),
        )
        vo_init = (
            scaled_init(self.init_scale) if self.init_scale != 1.0 else None
        )
        self.q_proj, self.k_proj = dg("q"), dg("k")
        self.v_proj = dg("v", vo_init)
        self.out_proj = nn.DenseGeneral(
            features=self.d_model, axis=(-2, -1), name="out", dtype=self.dtype,
            **({"kernel_init": vo_init} if vo_init is not None else {}),
        )
        self.attn_drop = ConfigurableDropout(
            self.dropout_rate, self.dropout_impl, name="attn_drop"
        )
        self.out_drop = ConfigurableDropout(
            self.dropout_rate, self.dropout_impl, name="out_drop"
        )

    def kv(self, kv_in: jnp.ndarray):
        """Project keys/values once (used to precompute cross-attn caches)."""
        return self.k_proj(kv_in), self.v_proj(kv_in)

    def _attend(self, q, k, v, bias, deterministic):
        drop = None
        if self.weight_dropout:
            drop = lambda w: self.attn_drop(w, deterministic=deterministic)
        out = attend(q, k, v, bias, self.dtype, drop)
        return self.out_drop(self.out_proj(out), deterministic=deterministic)

    def __call__(
        self,
        q_in: jnp.ndarray,  # (B, Tq, D)
        kv_in: jnp.ndarray,  # (B, Tk, D)
        bias: Optional[jnp.ndarray],  # additive, broadcastable (B,H,Tq,Tk)
        deterministic: bool = True,
    ) -> jnp.ndarray:
        q = self.q_proj(q_in)
        k, v = self.kv(kv_in)
        return self._attend(q, k, v, bias, deterministic)

    def ring(self, x, lengths, deterministic: bool = True):
        """Self-attention via ring attention over the ``seq`` mesh axis
        (``ops/ring_attention``) — sequence/context parallelism for
        utterances long enough to shard over ``seq``. K/V blocks rotate
        over ``lax.ppermute`` (NVLink point-to-point) while each device keeps
        its local Q block; enable with ``attn_impl='ring'`` + a mesh with
        ``seq > 1`` (``main.py --mesh_seq``). Generalises the reference's
        ±50 local band (``transformer_new.py:53``) to exact global
        attention over sharded sequences.

        Attention-WEIGHT dropout is not applied on this path (output
        dropout still is). Falls back to the
        plain masked path when no mesh/seq axis is active. T is padded to
        a multiple of the axis size (padded keys are masked by length)."""
        from jax.sharding import PartitionSpec as P

        from ..ops.ring_attention import ring_attention
        from ..parallel.context import get_active_mesh

        mesh = get_active_mesh()
        sp = 1 if mesh is None else mesh.shape.get("seq", 1)
        if sp == 1:
            from ..ops.masks import padding_bias

            bias = padding_bias(lengths, x.shape[1])
            q = self.q_proj(x)
            k, v = self.kv(x)
            return self._attend(q, k, v, bias, deterministic)
        q = self.q_proj(x)
        k, v = self.kv(x)
        t = x.shape[1]
        t_pad = ((t + sp - 1) // sp) * sp
        if t_pad != t:
            pad = [(0, 0), (0, t_pad - t), (0, 0), (0, 0)]
            q, k, v = jnp.pad(q, pad), jnp.pad(k, pad), jnp.pad(v, pad)

        def body(qs, ks, vs, ls):
            return ring_attention(
                qs, ks, vs, ls, axis_name="seq",
                scale=1.0 / float(np.sqrt(self.head_dim)),
            )

        spec = P("data", "seq", None, None)  # (B, T, H, d)
        out = jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(spec, spec, spec, P("data")),
            out_specs=spec,
            check_vma=False,
        )(q, k, v, lengths)
        out = out[:, :t].astype(self.dtype)
        return self.out_drop(self.out_proj(out), deterministic=deterministic)

    def step_self(self, x, cache: dict, index, bias):
        """Cached self-attention decode step. x: (B, 1, D); cache holds
        HEADS-MAJOR (B, H, Tmax, dk) key/value buffers; index is the write
        position. Heads-major matters: the attention einsums consume the
        cache directly, so the decode loop performs no per-step layout
        copies (profiled at ~60%% of beam-search step time in the
        time-major layout)."""
        q = self.q_proj(x)  # (B, 1, H, d)
        k_new, v_new = self.kv(x)
        kc = cache["k"].at[:, :, index].set(k_new[:, 0])
        vc = cache["v"].at[:, :, index].set(v_new[:, 0])
        scale = 1.0 / np.sqrt(self.head_dim)
        s = (
            jnp.einsum(
                "bqhd,bhtd->bhqt", q, kc, preferred_element_type=jnp.float32
            )
            * scale
        )
        if bias is not None:
            s = s + bias
        w = jax.nn.softmax(s, axis=-1).astype(self.dtype)
        out = jnp.einsum("bhqt,bhtd->bqhd", w, vc)
        out = self.out_drop(self.out_proj(out), deterministic=True)
        return out, {"k": kc, "v": vc}

    def step_self_lazy(self, x, cache: dict, index, anc, bias):
        """Lazy-beam-reorder cached self-attention step.

        Beam search must re-associate each hypothesis with its ancestor's
        KV history after every top-k reselection. Physically gathering the
        (B·K, L, H, d) cache per layer per step is bound by device-memory
        traffic. Instead the cache stays UNPERMUTED —
        each slot holds whatever hypothesis occupied it when position t
        was written — and ``anc`` (B, K, L) int32 records, for the
        hypothesis now in slot k, which slot's cache holds its position-t
        entry. Attention computes scores against ALL K slots' caches
        (K× more matmul FLOPs, which are cheap) and selects the ancestor's row
        with a one-hot einsum, so the only reorder cost is a (B, K, L)
        int gather in the beam loop.

        x: (B·K, 1, D) in beam-slot order; bias: additive, broadcastable
        to (B, H, K, L) (e.g. the (1,1,1,L) causal position bias).
        """
        b, k_beam, l = anc.shape
        q = self.q_proj(x)  # (B·K, 1, H, d)
        k_new, v_new = self.kv(x)
        kc = cache["k"].at[:, :, index].set(k_new[:, 0])  # (B·K, H, L, d)
        vc = cache["v"].at[:, :, index].set(v_new[:, 0])
        h, dk = self.num_heads, self.head_dim
        qb = q.reshape(b, k_beam, h, dk)
        kb = kc.reshape(b, k_beam, h, l, dk)
        vb = vc.reshape(b, k_beam, h, l, dk)
        scale = 1.0 / np.sqrt(self.head_dim)
        # scores of every hypothesis i against every slot j's cache
        s_all = (
            jnp.einsum(
                "bihd,bjhtd->bhijt", qb, kb,
                preferred_element_type=jnp.float32,
            )
            * scale
        )  # (B, H, K, K, L)
        sel = jax.nn.one_hot(anc, k_beam, dtype=s_all.dtype)  # (B, K, L, K)
        s = jnp.einsum("bhijt,bitj->bhit", s_all, sel) + bias  # (B, H, K, L)
        w = jax.nn.softmax(s, axis=-1)
        # route each weight back to its ancestor slot's V row
        wsel = (
            w[:, :, :, None, :] * sel.transpose(0, 1, 3, 2)[:, None]
        ).astype(self.dtype)  # (B, H, K, K, L)
        out = jnp.einsum("bhijt,bjhtd->bihd", wsel, vb)
        out = out.reshape(b * k_beam, 1, h, dk)
        out = self.out_drop(self.out_proj(out), deterministic=True)
        return out, {"k": kc, "v": vc}

    def step_cross(self, x, cache: dict, bias):
        """Cross-attention decode step against precomputed enc k/v.

        Beam-folded: the cache may hold ONE row per utterance (B, T, H, d)
        while queries arrive per hypothesis (B·K, 1, D) — the K/V rows are
        identical across a utterance's beam slots, so replicating them ×K
        (and re-reading ~2 GB of HBM per flagship decode step) is pure
        waste. When the row counts differ, the beam dim folds into the
        query: (B, K) queries attend shared (B, T) keys."""
        q = self.q_proj(x)  # (B*K, 1, H, d)
        kc, vc = cache["k"], cache["v"]
        k_beam = q.shape[0] // kc.shape[0]
        if k_beam == 1:
            return self._attend(q, kc, vc, bias, True)
        b = kc.shape[0]
        h, dk = self.num_heads, self.head_dim
        qb = q.reshape(b, k_beam, h, dk)
        scale = 1.0 / np.sqrt(self.head_dim)
        s = (
            jnp.einsum(
                "bkhd,bthd->bhkt", qb, kc, preferred_element_type=jnp.float32
            )
            * scale
        )
        if bias is not None:
            s = s + bias  # (B, 1, 1, T) broadcasts over (B, H, K, T)
        w = jax.nn.softmax(s, axis=-1).astype(self.dtype)
        out = jnp.einsum("bhkt,bthd->bkhd", w, vc)
        out = out.reshape(b * k_beam, 1, h, dk)
        return self.out_drop(self.out_proj(out), deterministic=True)

    def make_cache(self, batch: int, max_len: int):
        # heads-major (B, H, T, d): the layout the decode einsums consume,
        # so the while-loop carry needs no per-step layout copies
        shape = (batch, self.num_heads, max_len, self.head_dim)
        return {
            "k": jnp.zeros(shape, self.dtype),
            "v": jnp.zeros(shape, self.dtype),
        }


class PositionwiseFFN(nn.Module):
    """d_model -> d_ff -> d_model with ReLU; the 1x1-conv variant the
    reference uses (``module.py:51-75``) is algebraically this Dense pair."""

    d_model: int
    d_ff: int
    dropout_rate: float = 0.1
    dtype: Any = jnp.float32
    init_scale: float = 1.0  # DeepNorm beta on w1/w2 init (see MHA)
    dropout_impl: str = "rng"

    def __call__(self, x: jnp.ndarray, deterministic: bool = True) -> jnp.ndarray:
        kw = (
            {"kernel_init": scaled_init(self.init_scale)}
            if self.init_scale != 1.0
            else {}
        )
        y = nn.Dense(self.d_ff, dtype=self.dtype, name="w1", **kw)(x)
        y = jax.nn.relu(y)
        y = nn.Dense(self.d_model, dtype=self.dtype, name="w2", **kw)(y)
        return ConfigurableDropout(
            self.dropout_rate, self.dropout_impl, name="drop"
        )(y, deterministic=deterministic)


class SubLayer(nn.Module):
    """Residual + LayerNorm wrapper with configurable placement.

    ``post`` reproduces the reference (LN after residual add,
    ``attention.py:84``, ``module.py:33``); ``pre`` is the stability-
    friendly variant for deep stacks. ``has_aux`` supports wrapped
    functions that thread a cache through.

    ``alpha`` up-weights the residual branch in POST mode —
    ``norm(alpha·x + f(x))`` — the DeepNorm residual scaling (DeepNet,
    Wang et al. 2022) that stabilizes post-LN stacks at depth; 1.0 is
    the plain reference placement. Ignored in pre mode."""

    norm_type: str
    dtype: Any
    alpha: float = 1.0

    def setup(self):
        # name pinned to the inline auto-name this module originally
        # used, so existing checkpoints/param trees are unaffected; exposed
        # as an attribute because the streaming chunk path must apply the
        # SAME norm to cached left-context frames (EncoderLayer.chunk_step)
        self.norm = nn.LayerNorm(dtype=self.dtype, name="LayerNorm_0")

    def __call__(self, x, fn, has_aux: bool = False):
        norm = self.norm
        if self.norm_type == "pre":
            if has_aux:
                y, aux = fn(norm(x))
                return x + y, aux
            return x + fn(norm(x))
        a = self.alpha
        if has_aux:
            y, aux = fn(x)
            return norm(a * x + y), aux
        return norm(a * x + fn(x))


class ConvModule(nn.Module):
    """Conformer convolution module (Gulati et al. 2020 §2.2):
    pointwise(2d)+GLU → depthwise(k) → LayerNorm → swish → pointwise(d) →
    dropout.

    Net-new capability beyond the reference (whose encoders are
    attention-only, SURVEY §2.4). The depthwise conv lowers to a grouped
    conv at static shapes; activations are
    zero-masked at padded frames BEFORE the conv so padding cannot leak
    into valid frames (output at frame t then depends only on in-range
    frames — pad-length invariance is tested). LayerNorm replaces the
    paper's BatchNorm: batch statistics would couple utterances and break
    the fixed-shape bucket discipline (padded-frame counts vary per
    batch), and LN-based Conformers are standard practice."""

    d_model: int
    kernel_size: int = 15
    dropout_rate: float = 0.1
    dtype: Any = jnp.float32
    # causal=True pads the depthwise conv LEFT-only (k-1 zeros), so output
    # frame t depends on inputs [t-k+1, t] — required when the block runs
    # under causal_encoder (a centered SAME kernel would leak future
    # frames past the causal attention mask) and for the streaming
    # conv-carry in ConformerBlock.chunk_step
    causal: bool = False
    dropout_impl: str = "rng"

    def __call__(
        self,
        x: jnp.ndarray,
        lengths: "jnp.ndarray | None",
        deterministic: bool = True,
        frame_mask: "jnp.ndarray | None" = None,
    ) -> jnp.ndarray:
        t = x.shape[1]
        if frame_mask is None and lengths is not None:
            frame_mask = jnp.arange(t)[None, :] < lengths[:, None]
        y = nn.Dense(2 * self.d_model, dtype=self.dtype, name="pw1")(x)
        y = jax.nn.glu(y, axis=-1)
        if frame_mask is not None:
            # zero pads so the conv window reads zeros
            y = y * frame_mask.astype(x.dtype)[..., None]
        y = nn.Conv(
            self.d_model,
            (self.kernel_size,),
            feature_group_count=self.d_model,
            padding=[(self.kernel_size - 1, 0)] if self.causal else "SAME",
            dtype=self.dtype,
            name="dw",
        )(y)
        y = nn.LayerNorm(dtype=self.dtype, name="norm")(y)
        y = jax.nn.swish(y)
        y = nn.Dense(self.d_model, dtype=self.dtype, name="pw2")(y)
        return ConfigurableDropout(
            self.dropout_rate, self.dropout_impl, name="drop"
        )(y, deterministic=deterministic)


class ConvSubsampler(nn.Module):
    """Conv2d front-end: two stride-2 3x3 convs -> 4x time reduction.

    The reference only gestures at this (``Predictor/Models/CNNs/cnns.py:4-9``
    stub); provided as the alternative to LFR stacking for feature-rate
    reduction.
    """

    d_model: int
    dtype: Any = jnp.float32

    def __call__(self, x: jnp.ndarray, lengths: jnp.ndarray):
        # x: (B, T, F) -> (B, T, F, 1) image
        y = x[..., None].astype(self.dtype)
        for i in range(2):
            y = nn.Conv(
                self.d_model // 8, (3, 3), strides=(2, 2), dtype=self.dtype,
                name=f"conv{i}",
            )(y)
            y = jax.nn.relu(y)
        b, t, f, c = y.shape
        y = nn.Dense(self.d_model, dtype=self.dtype, name="proj")(
            y.reshape(b, t, f * c)
        )
        out_lengths = lengths
        for _ in range(2):
            out_lengths = (out_lengths + 1) // 2  # SAME padding, stride 2
        return y, out_lengths
