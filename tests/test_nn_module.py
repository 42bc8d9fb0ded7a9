"""The module system (``models/nn.py``): naming, parameter trees, rngs,
remat and the layers, against NumPy formulas."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asr_chinese_e2e.models import nn


class Block(nn.Module):
    width: int

    def setup(self):
        self.inp = nn.Dense(self.width)
        self.stack = [nn.Dense(self.width) for _ in range(2)]
        self.norm = nn.LayerNorm(name="ln")

    def __call__(self, x):
        x = self.inp(x)
        for layer in self.stack:
            x = layer(x)
        return self.norm(x)

    def project(self, x):
        return self.inp(x)


class Inline(nn.Module):
    def __call__(self, x, deterministic=True):
        x = nn.Dense(4)(x)
        x = nn.Dense(3, use_bias=False)(x)
        x = nn.Dense(3, name="named")(x)
        return nn.Dropout(0.5)(x, deterministic=deterministic)


def shapes(tree):
    return jax.tree_util.tree_map(lambda a: a.shape, tree)


def test_setup_children_named_by_attribute():
    params = Block(5).init(jax.random.PRNGKey(0), jnp.ones((2, 3)))["params"]
    assert shapes(params) == {
        "inp": {"kernel": (3, 5), "bias": (5,)},
        "stack_0": {"kernel": (5, 5), "bias": (5,)},
        "stack_1": {"kernel": (5, 5), "bias": (5,)},
        "ln": {"scale": (5,), "bias": (5,)},
    }


def test_inline_children_autonamed_and_stable_across_calls():
    m = Inline()
    variables = m.init(jax.random.PRNGKey(0), jnp.ones((2, 6)))
    assert shapes(variables["params"]) == {
        "Dense_0": {"kernel": (6, 4), "bias": (4,)},
        "Dense_1": {"kernel": (4, 3)},
        "named": {"kernel": (3, 3), "bias": (3,)},
    }
    a = m.apply(variables, jnp.ones((2, 6)))
    b = m.apply(variables, jnp.ones((2, 6)))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_apply_matches_numpy_and_method_by_name():
    m = Block(4)
    x = jnp.asarray(np.random.RandomState(0).randn(2, 3).astype(np.float32))
    variables = m.init(jax.random.PRNGKey(1), x)
    p = jax.tree_util.tree_map(np.asarray, variables["params"])
    h = x @ p["inp"]["kernel"] + p["inp"]["bias"]
    for name in ("stack_0", "stack_1"):
        h = h @ p[name]["kernel"] + p[name]["bias"]
    mu, var = h.mean(-1, keepdims=True), h.var(-1, keepdims=True)
    want = (h - mu) / np.sqrt(var + 1e-6) * p["ln"]["scale"] + p["ln"]["bias"]
    np.testing.assert_allclose(np.asarray(m.apply(variables, x)), want, rtol=1e-5, atol=1e-5)
    proj = m.apply(variables, x, method="project")
    np.testing.assert_allclose(
        np.asarray(proj), x @ p["inp"]["kernel"] + p["inp"]["bias"], rtol=1e-6
    )


def test_init_is_deterministic_and_keyed():
    x = jnp.ones((1, 3))
    a = Block(4).init(jax.random.PRNGKey(0), x)
    b = Block(4).init(jax.random.PRNGKey(0), x)
    c = Block(4).init(jax.random.PRNGKey(1), x)
    for u, v in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
    ka, kc = a["params"]["inp"]["kernel"], c["params"]["inp"]["kernel"]
    assert not np.allclose(np.asarray(ka), np.asarray(kc))
    # sibling layers get distinct draws
    assert not np.allclose(
        np.asarray(a["params"]["stack_0"]["kernel"]),
        np.asarray(a["params"]["stack_1"]["kernel"]),
    )


def test_missing_param_and_unbound_use_raise():
    m = Block(4)
    variables = m.init(jax.random.PRNGKey(0), jnp.ones((1, 3)))
    del variables["params"]["ln"]
    with pytest.raises(KeyError, match="ln/scale"):
        m.apply(variables, jnp.ones((1, 3)))
    with pytest.raises(RuntimeError, match="not bound"):
        m(jnp.ones((1, 3)))
    assert not hasattr(m, "inp")  # setup children exist only when bound


def test_dropout_rng_per_call_and_rate():
    m = Inline()
    x = jnp.ones((64, 6))
    variables = m.init(jax.random.PRNGKey(0), x)
    det = m.apply(variables, x)
    k = jax.random.PRNGKey(3)
    d1 = m.apply(variables, x, deterministic=False, rngs={"dropout": k})
    d2 = m.apply(variables, x, deterministic=False, rngs={"dropout": k})
    d3 = m.apply(
        variables, x, deterministic=False, rngs={"dropout": jax.random.PRNGKey(4)}
    )
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
    assert not np.array_equal(np.asarray(d1), np.asarray(d3))
    kept = np.asarray(d1) != 0
    np.testing.assert_allclose(np.asarray(d1)[kept], 2 * np.asarray(det)[kept], rtol=1e-6)
    assert 0.35 < kept.mean() < 0.65
    with pytest.raises(KeyError, match="dropout"):
        m.apply(variables, x, deterministic=False)


def test_make_rng_advances_per_call():
    class TwoDraws(nn.Module):
        def __call__(self):
            return self.make_rng("dropout"), self.make_rng("dropout")

    a, b = TwoDraws().apply({}, rngs={"dropout": jax.random.PRNGKey(0)})
    assert not np.array_equal(np.asarray(a), np.asarray(b))


def test_remat_matches_plain_values_and_grads():
    plain, checkpointed = Block, nn.remat(Block)
    x = jnp.asarray(np.random.RandomState(2).randn(3, 3).astype(np.float32))
    variables = plain(4).init(jax.random.PRNGKey(0), x)
    assert shapes(checkpointed(4).init(jax.random.PRNGKey(0), x)) == shapes(variables)

    def loss(cls, v):
        return jnp.sum(cls(4).apply(v, x) ** 2)

    g1 = jax.grad(lambda v: loss(plain, v))(variables)
    g2 = jax.grad(lambda v: loss(checkpointed, v))(variables)
    for u, w in zip(jax.tree_util.tree_leaves(g1), jax.tree_util.tree_leaves(g2)):
        np.testing.assert_allclose(np.asarray(u), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_dense_general_matches_einsum():
    class Heads(nn.Module):
        def __call__(self, x):
            y = nn.DenseGeneral((2, 3), name="split")(x)  # (B, T, 2, 3)
            return nn.DenseGeneral(5, axis=(-2, -1), name="merge")(y), y

    x = jnp.asarray(np.random.RandomState(3).randn(2, 4, 6).astype(np.float32))
    variables = Heads().init(jax.random.PRNGKey(0), x)
    p = variables["params"]
    assert p["split"]["kernel"].shape == (6, 2, 3)
    assert p["merge"]["kernel"].shape == (2, 3, 5)
    out, y = Heads().apply(variables, x)
    want_y = np.einsum("btd,dhk->bthk", x, p["split"]["kernel"]) + p["split"]["bias"]
    want = np.einsum("bthk,hkd->btd", want_y, p["merge"]["kernel"]) + p["merge"]["bias"]
    np.testing.assert_allclose(np.asarray(y), want_y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-5, atol=1e-5)


def test_embed_lookup_and_tied_attend():
    class Tied(nn.Module):
        def setup(self):
            self.embed = nn.Embed(7, 4)

        def __call__(self, ids):
            return self.embed.attend(self.embed(ids))

    ids = jnp.asarray([[1, 5, 0]])
    variables = Tied().init(jax.random.PRNGKey(0), ids)
    table = np.asarray(variables["params"]["embed"]["embedding"])
    assert table.shape == (7, 4)
    want = table[np.asarray(ids)] @ table.T
    np.testing.assert_allclose(
        np.asarray(Tied().apply(variables, ids)), want, rtol=1e-5, atol=1e-6
    )


@pytest.mark.parametrize("padding", ["SAME", [(2, 0)]])
def test_depthwise_conv1d_matches_numpy(padding):
    class DW(nn.Module):
        def __call__(self, x):
            return nn.Conv(4, (3,), padding=padding, feature_group_count=4)(x)

    x = np.random.RandomState(4).randn(2, 6, 4).astype(np.float32)
    variables = DW().init(jax.random.PRNGKey(0), jnp.asarray(x))
    k = np.asarray(variables["params"]["Conv_0"]["kernel"])  # (3, 1, 4)
    b = np.asarray(variables["params"]["Conv_0"]["bias"])
    left = 1 if padding == "SAME" else 2
    xp = np.pad(x, ((0, 0), (left, 2 - left), (0, 0)))
    want = sum(xp[:, i : i + 6] * k[i, 0] for i in range(3)) + b
    got = DW().apply(variables, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


def test_layernorm_bf16_output_f32_stats():
    x = jnp.asarray(np.random.RandomState(5).randn(3, 8) * 100 + 1000, jnp.bfloat16)
    ln = nn.LayerNorm(dtype=jnp.bfloat16)
    variables = ln.init(jax.random.PRNGKey(0), x)
    y = ln.apply(variables, x)
    assert y.dtype == jnp.bfloat16
    x64 = np.asarray(x, np.float64)
    want = (x64 - x64.mean(-1, keepdims=True)) / np.sqrt(x64.var(-1, keepdims=True) + 1e-6)
    np.testing.assert_allclose(np.asarray(y, np.float32), want, atol=3e-2)
