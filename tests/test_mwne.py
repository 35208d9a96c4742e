"""MWNE property tests: additivity, normalizer guards, timestamp/geo shapes.

Mirrors the reference's embedded property validation (models/mwne.py:66-89,
441-501) as real pytest tests (SURVEY.md §4e).
"""

import jax
import jax.numpy as jnp
import numpy as np

from unirec.configs import MWNEConfig
from unirec.models.mwne import (
    GeoCoordinateEncoder,
    MathematicalEncoder,
    NormalizedMathematicalEncoder,
    TimestampEncoder,
    geo_to_cartesian,
    sinusoidal_position_encoding,
    timestamp_features,
)
from unirec.train.mwne import MWNETrainer, spearman_distance_correlation

CFG = MWNEConfig(embedding_dim=64, num_frequencies=16)


def test_encoder_output_shape_and_dims():
    enc = MathematicalEncoder(CFG)
    params = enc.init(jax.random.PRNGKey(0), jnp.zeros((4,)))
    out = enc.apply(params, jnp.array([1.0, -2.0, 3.5]))
    assert out.shape == (3, 64)
    # fourier(32) + raw(2) + extra(30)
    assert CFG.fourier_dim == 32 and CFG.raw_dim == 2 and CFG.extra_dim == 30


def test_raw_component_additivity():
    """The raw-value column is exactly additive by construction."""
    enc = MathematicalEncoder(CFG)
    params = enc.init(jax.random.PRNGKey(0), jnp.zeros((1,)))
    a, b = jnp.array([1.5]), jnp.array([2.25])
    ea = enc.apply(params, a)
    eb = enc.apply(params, b)
    es = enc.apply(params, a + b)
    # raw value sits at index fourier_dim (scaled by raw_scale[0]=1 at init)
    i = CFG.fourier_dim
    np.testing.assert_allclose(
        float(ea[0, i] + eb[0, i]), float(es[0, i]), rtol=1e-6
    )
    # extra linear component is additive too (linear, no bias)
    np.testing.assert_allclose(
        np.asarray(ea[0, CFG.fourier_dim + 2 :] + eb[0, CFG.fourier_dim + 2 :]),
        np.asarray(es[0, CFG.fourier_dim + 2 :]),
        atol=1e-5,
    )


def test_normalizer_running_stats_update_and_clamp():
    enc = NormalizedMathematicalEncoder(CFG)
    rng = jax.random.PRNGKey(0)
    nums = jax.random.normal(rng, (128,)) * 5
    variables = enc.init(rng, nums, train=False)
    out, state = enc.apply(
        variables, nums, train=True, mutable=["batch_stats"]
    )
    stats = state["batch_stats"]
    assert int(stats["num_batches_tracked"]) == 1
    assert out.shape == (128, 64)
    # stds are clamped to >= min_std
    assert float(jnp.min(stats["running_std"])) >= CFG.min_std - 1e-6
    # eval mode uses stored stats deterministically
    v2 = {"params": variables["params"], "batch_stats": stats}
    o1 = enc.apply(v2, nums, train=False)
    o2 = enc.apply(v2, nums, train=False)
    np.testing.assert_allclose(np.asarray(o1), np.asarray(o2))


def test_timestamp_encoder_periodicity():
    feats1 = timestamp_features(jnp.array([1672531200.0]))
    feats2 = timestamp_features(jnp.array([1672531200.0 + 86400 * 7]))
    # day-of-week sin/cos identical one week apart
    np.testing.assert_allclose(
        np.asarray(feats1[0, 3:5]), np.asarray(feats2[0, 3:5]), atol=1e-4
    )
    enc = TimestampEncoder(32)
    params = enc.init(jax.random.PRNGKey(0), jnp.zeros((2,)))
    out = enc.apply(params, jnp.array([1672531200.0, 1672617600.0]))
    assert out.shape == (2, 32)


def test_geo_encoder_unit_sphere():
    coords = jnp.array([[40.7128, -74.0060], [90.0, 0.0], [-90.0, 13.0]])
    xyz = geo_to_cartesian(coords)
    np.testing.assert_allclose(
        np.asarray(jnp.linalg.norm(xyz, axis=-1)), np.ones(3), atol=1e-6
    )
    # poles map to +/- z regardless of longitude
    np.testing.assert_allclose(np.asarray(xyz[1]), [0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(np.asarray(xyz[2]), [0, 0, -1], atol=1e-6)
    enc = GeoCoordinateEncoder(16)
    params = enc.init(jax.random.PRNGKey(0), coords)
    assert enc.apply(params, coords).shape == (3, 16)


def test_sinusoidal_pe_matches_reference_formula():
    pe = np.asarray(sinusoidal_position_encoding(10, 8))
    assert pe.shape == (10, 8)
    np.testing.assert_allclose(pe[0], [0, 1, 0, 1, 0, 1, 0, 1], atol=1e-6)
    np.testing.assert_allclose(pe[3, 0], np.sin(3.0), atol=1e-6)


def test_mwne_training_improves_additivity():
    trainer = MWNETrainer(MWNEConfig(embedding_dim=48, num_frequencies=8), lr=1e-3)
    test_numbers = np.array([0.5, 1.0, 2.0, 5.0, 10.0, -3.0, 42.0], np.float32)
    before = trainer.evaluate(test_numbers)
    trainer.train(num_steps=100)
    after = trainer.evaluate(test_numbers)
    assert np.isfinite(after["additivity_mse"])
    # distance-rank correlation should be meaningfully positive after training
    assert after["distance_rank_correlation"] > 0.2
    # training must not blow up additivity (it is heavily weighted)
    assert after["additivity_mse"] <= before["additivity_mse"] * 5 + 1.0


def test_spearman_correlation_perfect_case():
    nums = np.array([1.0, 2.0, 4.0, 8.0])
    emb = nums[:, None] * np.ones((1, 3))
    assert spearman_distance_correlation(nums, emb) > 0.999
