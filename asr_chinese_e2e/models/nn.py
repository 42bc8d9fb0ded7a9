"""A small module system whose parameters are a plain nested-dict pytree.

A module is a dataclass of hyperparameters. Its parameters are built
lazily, the first time a method runs under ``init``, and read back from
the tree given to ``apply``. Children are declared in one of two ways:

- ``setup()`` assigns them to attributes; a child is named after its
  attribute (``{attr}_{i}`` inside a list) unless given ``name=``;
- any other method creates them inline; a child is named ``{Class}_{n}``
  in creation order within that call unless given ``name=``, so calling
  the method again reaches the same parameters.

A child's parameters sit under its name in its parent's subtree, so the
tree's paths (``encoder/layer0/attn/q/kernel``) are the module paths.
``make_rng(kind)`` derives a fresh key for every call from the key passed
for ``kind``, the module's path and a per-path call counter, so results
do not depend on the order in which siblings run.

The layers the models need (``Dense``, ``DenseGeneral``, ``LayerNorm``,
``Embed``, ``Conv``, ``Dropout``) and ``remat`` follow below.
"""

from __future__ import annotations

import dataclasses
import threading
import zlib
from types import FunctionType
from typing import Any, Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

_local = threading.local()


def _stack() -> list:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def _hash(s: str) -> int:
    return zlib.crc32(s.encode()) & 0x7FFFFFFF


class _Frame:
    """State shared by every module of one ``init`` / ``apply`` call."""

    def __init__(self, params: dict, rngs: dict, initializing: bool):
        self.params = params
        self.rngs = rngs
        self.initializing = initializing
        self.rng_counts: dict = {}

    def subtree(self, path: tuple) -> dict:
        d = self.params
        for k in path:
            d = d.setdefault(k, {}) if self.initializing else d.get(k, {})
        return d


def _wrap(fn: Callable) -> Callable:
    def wrapped(self, *args, **kwargs):
        self._bind()
        self._ensure_setup()
        st = _stack()
        st.append(self)
        self._depth += 1
        if self._depth == 1:
            self._autonames.clear()
        try:
            return fn(self, *args, **kwargs)
        finally:
            self._depth -= 1
            st.pop()

    wrapped.__name__ = fn.__name__
    wrapped.__qualname__ = fn.__qualname__
    wrapped.__doc__ = fn.__doc__
    wrapped.__wrapped__ = fn
    return wrapped


@dataclasses.dataclass(eq=False)
class Module:
    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fields = vars(cls).get("__annotations__", {})
        for attr, fn in list(vars(cls).items()):
            if attr in fields or attr == "setup":
                continue
            if attr.startswith("__") and attr != "__call__":
                continue
            if isinstance(fn, FunctionType):
                setattr(cls, attr, _wrap(fn))
        dataclasses.dataclass(cls, eq=False)

    def __post_init__(self):
        st = _stack()
        parent = st[-1] if st else None
        object.__setattr__(self, "_parent", parent)
        object.__setattr__(self, "_frame", None)
        object.__setattr__(self, "_path", ())
        object.__setattr__(self, "_setup_done", False)
        object.__setattr__(self, "_in_setup", False)
        object.__setattr__(self, "_depth", 0)
        object.__setattr__(self, "_autonames", {})
        if parent is not None and self.name is None and not parent._in_setup:
            kind = type(self).__name__
            n = parent._autonames.get(kind, 0)
            parent._autonames[kind] = n + 1
            object.__setattr__(self, "name", f"{kind}_{n}")

    def __setattr__(self, attr, value):
        if getattr(self, "_in_setup", False):
            children = value if isinstance(value, (list, tuple)) else [value]
            for i, child in enumerate(children):
                if (
                    isinstance(child, Module)
                    and child._parent is self
                    and child.name is None
                ):
                    sub = attr if child is value else f"{attr}_{i}"
                    object.__setattr__(child, "name", sub)
        object.__setattr__(self, attr, value)

    def __getattr__(self, attr):
        # only reached for attributes not yet set: children made in setup
        d = self.__dict__
        if (
            attr.startswith("_")
            or d.get("_setup_done", True)
            or (d["_frame"] is None and d["_parent"] is None)
        ):
            raise AttributeError(attr)
        self._bind()
        self._ensure_setup()
        return object.__getattribute__(self, attr)

    # -- binding --------------------------------------------------------------
    def _bind(self) -> None:
        if self._frame is not None:
            return
        parent = self._parent
        if parent is None:
            raise RuntimeError(
                f"{type(self).__name__} is not bound: call it through "
                "init() or apply()"
            )
        parent._bind()
        if self.name is None:
            raise RuntimeError(f"unnamed child {type(self).__name__}")
        object.__setattr__(self, "_frame", parent._frame)
        object.__setattr__(self, "_path", parent._path + (self.name,))

    def _ensure_setup(self) -> None:
        if self._setup_done:
            return
        object.__setattr__(self, "_setup_done", True)
        object.__setattr__(self, "_in_setup", True)
        st = _stack()
        st.append(self)
        try:
            self.setup()
        finally:
            st.pop()
            object.__setattr__(self, "_in_setup", False)

    def setup(self) -> None:
        pass

    # -- parameters and randomness --------------------------------------------
    def is_initializing(self) -> bool:
        self._bind()
        return self._frame.initializing

    def param(self, pname: str, init_fn: Callable, *args):
        self._bind()
        frame = self._frame
        d = frame.subtree(self._path)
        if pname in d:
            return d[pname]
        full = "/".join(self._path + (pname,))
        if not frame.initializing:
            raise KeyError(f"parameter {full} is missing from the tree")
        key = jax.random.fold_in(frame.rngs["params"], _hash(full))
        d[pname] = init_fn(key, *args)
        return d[pname]

    def make_rng(self, kind: str):
        self._bind()
        frame = self._frame
        if kind not in frame.rngs:
            raise KeyError(f"no '{kind}' rng given to init/apply")
        slot = (self._path, kind)
        n = frame.rng_counts.get(slot, 0)
        frame.rng_counts[slot] = n + 1
        key = jax.random.fold_in(frame.rngs[kind], _hash("/".join(self._path)))
        return jax.random.fold_in(key, n)

    # -- entry points -----------------------------------------------------------
    def _run(self, params, rngs, initializing, method, args, kwargs):
        root = dataclasses.replace(self)
        object.__setattr__(root, "_parent", None)
        object.__setattr__(root, "_frame", _Frame(params, rngs, initializing))
        fn = type(root).__call__ if method is None else method
        if isinstance(fn, str):
            fn = getattr(type(root), fn)
        return fn(root, *args, **kwargs)

    def init_with_output(self, rngs, *args, method=None, **kwargs):
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        params: dict = {}
        out = self._run(params, rngs, True, method, args, kwargs)
        return out, {"params": params}

    def init(self, rngs, *args, method=None, **kwargs):
        return self.init_with_output(rngs, *args, method=method, **kwargs)[1]

    def apply(self, variables, *args, rngs=None, method=None, **kwargs):
        return self._run(
            variables.get("params", {}), dict(rngs or {}), False, method,
            args, kwargs,
        )


def remat(cls):
    """``cls`` whose ``__call__`` recomputes its activations in the
    backward pass (``jax.checkpoint``). Array arguments are traced; all
    others (flags, ``None``) are closed over as constants."""
    base_call = cls.__call__

    class Remat(cls):
        def __call__(self, *args):
            if self.is_initializing():
                return base_call(self, *args)
            dyn = [i for i, a in enumerate(args) if isinstance(a, jax.Array)]

            def fn(*dyn_args):
                full = list(args)
                for i, a in zip(dyn, dyn_args):
                    full[i] = a
                return base_call(self, *full)

            return jax.checkpoint(fn)(*[args[i] for i in dyn])

    Remat.__name__ = Remat.__qualname__ = f"Remat{cls.__name__}"
    return Remat


# -- layers -----------------------------------------------------------------------
lecun_normal = jax.nn.initializers.lecun_normal
zeros = jax.nn.initializers.zeros
ones = jax.nn.initializers.ones


def _promote(dtype, *xs):
    dt = dtype if dtype is not None else jnp.result_type(
        *[x for x in xs if x is not None]
    )
    return [None if x is None else jnp.asarray(x, dt) for x in xs]


class Dense(Module):
    features: int
    use_bias: bool = True
    dtype: Any = None
    kernel_init: Callable = lecun_normal()
    bias_init: Callable = zeros

    def __call__(self, x):
        kernel = self.param(
            "kernel", self.kernel_init, (x.shape[-1], self.features), jnp.float32
        )
        bias = (
            self.param("bias", self.bias_init, (self.features,), jnp.float32)
            if self.use_bias
            else None
        )
        x, kernel, bias = _promote(self.dtype, x, kernel, bias)
        y = jax.lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
        return y if bias is None else y + bias


class DenseGeneral(Module):
    """Dense over the trailing ``axis`` dims of ``x`` into ``features``
    (an int or a tuple of output dims). The kernel is laid out
    ``(*in_dims, *features)`` and initialised as the flat
    ``(prod(in), prod(out))`` matrix."""

    features: Any
    axis: Any = -1
    dtype: Any = None
    kernel_init: Callable = lecun_normal()
    bias_init: Callable = zeros

    def __call__(self, x):
        feats = (
            tuple(self.features)
            if isinstance(self.features, Sequence)
            else (self.features,)
        )
        axes = self.axis if isinstance(self.axis, Sequence) else (self.axis,)
        axes = tuple(sorted(a % x.ndim for a in axes))
        in_dims = tuple(x.shape[a] for a in axes)
        flat = (int(np.prod(in_dims)), int(np.prod(feats)))
        kernel = self.param(
            "kernel",
            lambda k, s, d: self.kernel_init(k, flat, d).reshape(s),
            in_dims + feats,
            jnp.float32,
        )
        bias = self.param("bias", self.bias_init, feats, jnp.float32)
        x, kernel, bias = _promote(self.dtype, x, kernel, bias)
        y = jax.lax.dot_general(
            x, kernel, ((axes, tuple(range(len(axes)))), ((), ()))
        )
        return y + bias


class LayerNorm(Module):
    """Normalise the last dim; statistics and arithmetic in float32."""

    epsilon: float = 1e-6
    dtype: Any = None

    def __call__(self, x):
        d = x.shape[-1]
        scale = self.param("scale", ones, (d,), jnp.float32)
        bias = self.param("bias", zeros, (d,), jnp.float32)
        x32 = x.astype(jnp.promote_types(x.dtype, jnp.float32))
        mean = jnp.mean(x32, axis=-1, keepdims=True)
        var = jnp.mean(jnp.square(x32 - mean), axis=-1, keepdims=True)
        y = (x32 - mean) * (jax.lax.rsqrt(var + self.epsilon) * scale) + bias
        return y.astype(self.dtype if self.dtype is not None else x.dtype)


class Embed(Module):
    num_embeddings: int
    features: int
    dtype: Any = None

    def _table(self):
        init = jax.nn.initializers.normal(stddev=1.0 / np.sqrt(self.features))
        table = self.param(
            "embedding", init, (self.num_embeddings, self.features), jnp.float32
        )
        return table if self.dtype is None else table.astype(self.dtype)

    def __call__(self, ids):
        return jnp.take(self._table(), ids, axis=0)

    def attend(self, query):
        """Scores of ``query`` against every embedding (tied output)."""
        query, table = _promote(self.dtype, query, self._table())
        return jnp.dot(query, table.T)


class Conv(Module):
    """N-d convolution over channels-last input ``(B, *spatial, C)``."""

    features: int
    kernel_size: Sequence[int]
    strides: Optional[Sequence[int]] = None
    padding: Any = "SAME"
    feature_group_count: int = 1
    use_bias: bool = True
    dtype: Any = None

    def __call__(self, x):
        nd = len(self.kernel_size)
        in_ch = x.shape[-1]
        kernel = self.param(
            "kernel",
            lecun_normal(),
            tuple(self.kernel_size)
            + (in_ch // self.feature_group_count, self.features),
            jnp.float32,
        )
        bias = (
            self.param("bias", zeros, (self.features,), jnp.float32)
            if self.use_bias
            else None
        )
        x, kernel, bias = _promote(self.dtype, x, kernel, bias)
        spatial = "".join("HWD"[i] for i in range(nd))
        y = jax.lax.conv_general_dilated(
            x,
            kernel,
            window_strides=tuple(self.strides or (1,) * nd),
            padding=self.padding,
            dimension_numbers=(f"N{spatial}C", f"{spatial}IO", f"N{spatial}C"),
            feature_group_count=self.feature_group_count,
        )
        return y if bias is None else y + bias


class Dropout(Module):
    """Inverted dropout with a Bernoulli mask from the ``dropout`` rng."""

    rate: float

    def __call__(self, x, deterministic: bool = True):
        if deterministic or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return jnp.zeros_like(x)
        keep_prob = 1.0 - self.rate
        keep = jax.random.bernoulli(self.make_rng("dropout"), keep_prob, x.shape)
        return jax.lax.select(
            keep, x / jnp.asarray(keep_prob, x.dtype), jnp.zeros_like(x)
        )
