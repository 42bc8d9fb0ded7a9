"""Ring attention vs plain attention on the virtual mesh (SURVEY §5.7)."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from asr_chinese_e2e.ops.ring_attention import ring_attention
from asr_chinese_e2e.parallel.sharding import make_mesh


def reference_attention(q, k, v, key_valid):
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = jnp.einsum("bqhd,bkhd->bqhk", q, k) * scale
    valid = jnp.arange(k.shape[1])[None, :] < key_valid[:, None]
    s = s + jnp.where(valid, 0.0, -1e9)[:, None, None, :]
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bqhk,bkhd->bqhd", p, v)


def run_ring(q, k, v, key_valid, n_seq):
    mesh = make_mesh(data=-1, seq=n_seq)
    fn = shard_map(
        lambda q_, k_, v_, kv: ring_attention(q_, k_, v_, kv, "seq"),
        mesh=mesh,
        in_specs=(P(None, "seq"), P(None, "seq"), P(None, "seq"), P()),
        out_specs=P(None, "seq"),
        check_vma=False,
    )
    return fn(q, k, v, key_valid)


def make_qkv(seed=0, B=2, T=16, H=2, D=8):
    rng = np.random.RandomState(seed)
    mk = lambda: jnp.asarray(rng.randn(B, T, H, D).astype(np.float32))
    return mk(), mk(), mk()


def test_ring_matches_full_attention():
    q, k, v = make_qkv()
    key_valid = jnp.asarray([16, 16])
    want = reference_attention(q, k, v, key_valid)
    got = run_ring(q, k, v, key_valid, n_seq=4)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_ring_with_variable_lengths():
    q, k, v = make_qkv(seed=1)
    key_valid = jnp.asarray([11, 5])  # masks cross shard boundaries (T/4=4)
    want = reference_attention(q, k, v, key_valid)
    got = run_ring(q, k, v, key_valid, n_seq=4)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_ring_degenerate_single_shard():
    q, k, v = make_qkv(seed=2)
    key_valid = jnp.asarray([16, 9])
    want = reference_attention(q, k, v, key_valid)
    got = run_ring(q, k, v, key_valid, n_seq=1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_encoder_ring_matches_xla():
    """attn_impl='ring' (VERDICT r1 #3): the SpeechTransformer encoder
    under a seq=2 mesh must reproduce the unsharded XLA encoder bit-near,
    including with T not divisible by the seq axis and variable lengths."""
    from asr_chinese_e2e.models.transformer import SpeechTransformer
    from asr_chinese_e2e.parallel.context import active_mesh
    from tests.test_transformer import make_batch, tiny_cfg

    feats, feat_lens, labels, label_lens = make_batch(b=2, t=9)
    cfg_x = tiny_cfg(dropout_rate=0.0, attn_impl="xla")
    cfg_r = tiny_cfg(dropout_rate=0.0, attn_impl="ring")
    m_x = SpeechTransformer(cfg_x, 20)
    m_r = SpeechTransformer(cfg_r, 20)
    params = m_x.init(jax.random.PRNGKey(0), feats, feat_lens, labels, label_lens)

    want, want_lens = m_x.apply(params, feats, feat_lens, method="encode")
    mesh = make_mesh(data=2, model=1, seq=2)
    with mesh, active_mesh(mesh):
        got, got_lens = jax.jit(
            lambda p, f, fl: m_r.apply(p, f, fl, method="encode")
        )(params, feats, feat_lens)
    np.testing.assert_array_equal(np.asarray(want_lens), np.asarray(got_lens))
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-5
    )


@pytest.mark.slow
def test_encoder_ring_trains():
    """Ring attention must be differentiable end-to-end: one train step on
    a (data=2, model=2, seq=2) mesh produces finite loss and grads (the
    full dryrun path, tiny)."""
    import __graft_entry__ as ge

    r = ge._dryrun_step(jax.devices()[:8], 2, 2, 2, "ring")
    assert np.isfinite(r["loss"])
    assert r["mesh"] == {"data": 2, "model": 2, "seq": 2}
