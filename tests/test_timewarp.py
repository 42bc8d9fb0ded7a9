"""Time-warp SpecAugment: jnp polyharmonic sparse_image_warp vs a scipy
thin-plate-spline oracle, plus behavioral checks (identity, shift, padding
invariance). Capability parity with the reference's dead code
(``Predictor/data_handler/augments.py:54-396``)."""

import jax
import jax.numpy as jnp
import numpy as np

from asr_chinese_e2e.data.features import FeatureConfig, spec_augment
from asr_chinese_e2e.data.timewarp import (
    dense_image_warp,
    interpolate_spline,
    sparse_image_warp,
    time_warp,
)


def test_interpolate_spline_matches_scipy_thin_plate():
    from scipy.interpolate import RBFInterpolator

    rng = np.random.RandomState(0)
    train = rng.rand(9, 2).astype(np.float64) * 10
    vals = rng.randn(9, 2)
    query = rng.rand(30, 2) * 10
    got = np.asarray(
        interpolate_spline(
            jnp.asarray(train), jnp.asarray(vals), jnp.asarray(query)
        )
    )
    # scipy's thin_plate_spline kernel is r^2 log r — the same order-2
    # polyharmonic basis with the same linear-polynomial tail
    want = RBFInterpolator(train, vals, kernel="thin_plate_spline")(query)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_interpolate_spline_exact_at_controls():
    rng = np.random.RandomState(1)
    train = rng.rand(7, 2) * 5
    vals = rng.randn(7, 3)
    got = np.asarray(
        interpolate_spline(jnp.asarray(train), jnp.asarray(vals), jnp.asarray(train))
    )
    np.testing.assert_allclose(got, vals, atol=1e-4)


def test_dense_warp_zero_flow_is_identity():
    rng = np.random.RandomState(2)
    img = rng.randn(20, 8).astype(np.float32)
    out = np.asarray(dense_image_warp(jnp.asarray(img), jnp.zeros((20, 8, 2))))
    np.testing.assert_allclose(out, img, atol=1e-6)


def test_dense_warp_integer_shift():
    rng = np.random.RandomState(3)
    img = rng.randn(20, 8).astype(np.float32)
    flow = np.zeros((20, 8, 2), np.float32)
    flow[..., 0] = 2.0  # sample from t-2: out[t] = img[t-2]
    out = np.asarray(dense_image_warp(jnp.asarray(img), jnp.asarray(flow)))
    np.testing.assert_allclose(out[2:], img[:-2], atol=1e-6)


def test_sparse_warp_identity_when_src_eq_dst():
    rng = np.random.RandomState(4)
    img = rng.randn(30, 10).astype(np.float32)
    pts = jnp.asarray([[15.0, 4.5]])
    out = np.asarray(sparse_image_warp(jnp.asarray(img), pts, pts))
    np.testing.assert_allclose(out, img, atol=1e-4)


def test_sparse_warp_moves_content_toward_dest():
    # an impulse at t=10 moved to t=14: the warped image's energy center
    # along time shifts right
    img = np.zeros((32, 8), np.float32)
    img[10, :] = 1.0
    src = jnp.asarray([[10.0, 3.5]])
    dst = jnp.asarray([[14.0, 3.5]])
    out = np.asarray(sparse_image_warp(jnp.asarray(img), src, dst, 2))
    # exact at the control: content from (10, 3.5) lands at (14, 3.5)
    # (edge columns are pinned by the boundary anchors and stay put)
    assert out[14, 3] > 0.8 and out[14, 4] > 0.8, out[:, 3]
    assert out[14, 3] > out[10, 3]


def test_time_warp_batched_preserves_padding_and_shape():
    rng = np.random.RandomState(5)
    feats = rng.randn(3, 40, 16).astype(np.float32)
    lengths = jnp.asarray([40, 30, 25])
    out = np.asarray(
        time_warp(jnp.asarray(feats), lengths, jax.random.PRNGKey(0), 5)
    )
    assert out.shape == feats.shape
    # padding region untouched
    np.testing.assert_array_equal(out[1, 30:], feats[1, 30:])
    np.testing.assert_array_equal(out[2, 25:], feats[2, 25:])
    # warp actually changed the valid region somewhere
    assert np.abs(out[0] - feats[0]).max() > 1e-4


def test_spec_augment_with_warp_enabled():
    cfg = FeatureConfig(n_mels=16, num_time_warps=1, time_warp_param=4)
    rng = np.random.RandomState(6)
    feats = rng.randn(2, 50, 16).astype(np.float32)
    lengths = jnp.asarray([50, 40])
    out = spec_augment(jnp.asarray(feats), lengths, jax.random.PRNGKey(1), cfg)
    assert out.shape == feats.shape
    assert np.isfinite(np.asarray(out)).all()
    assert np.all(np.asarray(out)[1, 40:] == 0)


def test_time_warp_zero_param_is_noop():
    rng = np.random.RandomState(7)
    feats = jnp.asarray(rng.randn(2, 20, 8).astype(np.float32))
    out = time_warp(feats, jnp.asarray([20, 20]), jax.random.PRNGKey(0), 0)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(feats))
