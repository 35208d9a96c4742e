"""MWNE: math-aware encoders for numbers, timestamps, and geo-coordinates.

JAX rebuild of reference models/mwne.py:

* ``MathematicalEncoder`` — Fourier features over log-spaced frequencies +
  raw value & sign + a learned linear remainder
  (reference: models/mwne.py:91-183);
* ``MathNormalizer`` — running-std rescaling with a 50 %-change guard and
  [0.1, 10] scaling clamp, preserving additivity
  (reference: models/mwne.py:9-64).  Running stats live in the Flax
  ``batch_stats`` collection and update functionally under jit;
* ``TimestampEncoder`` — 9 secular+cyclical features -> MLP
  (reference: models/mwne.py:504-566);
* ``GeoCoordinateEncoder`` — lat/lon -> 3-D unit sphere -> MLP
  (reference: models/mwne.py:569-610);
* ``sinusoidal_position_encoding`` — the user-sequence PE
  (reference: models/user_sequence_encoder.py:12-33).

The self-supervised property trainer lives in unirec/train/mwne.py.
"""

from __future__ import annotations

import math
from typing import Any

from unirec import nn
import jax
import jax.numpy as jnp

from unirec.configs import MWNEConfig

Dtype = Any


class MathematicalEncoder(nn.Module):
    """Fourier + raw + linear number encoder; additive-friendly by design."""

    config: MWNEConfig
    dtype: Dtype = jnp.float32

    def setup(self):
        cfg = self.config
        # Fixed log-spaced frequencies 10^-2 .. max_frequency
        # (reference: models/mwne.py:111).
        self.frequencies = jnp.logspace(
            -2, math.log10(cfg.max_frequency), cfg.num_frequencies
        ).astype(self.dtype)
        self.fourier_weight = self.param(
            "fourier_weight", nn.initializers.ones, (cfg.fourier_dim,)
        )
        if cfg.include_raw:
            self.raw_scale = self.param(
                "raw_scale", nn.initializers.ones, (2,)
            )
        if cfg.extra_dim > 0:
            # Linear(1 -> extra_dim, bias=False) (reference: models/mwne.py:125).
            self.extra_proj = nn.Dense(
                cfg.extra_dim,
                use_bias=False,
                kernel_init=nn.initializers.lecun_normal(),
                name="extra_proj",
                dtype=self.dtype,
            )

    def __call__(self, numbers: jax.Array) -> jax.Array:
        cfg = self.config
        shape = numbers.shape
        x = numbers.reshape(-1, 1).astype(self.dtype)

        # Fourier component: interleaved (cos, sin) per frequency
        # (reference: models/mwne.py:162-175).
        phases = x * self.frequencies[None, :]  # [N, nf]
        four = jnp.stack([jnp.cos(phases), jnp.sin(phases)], axis=-1)
        four = four.reshape(x.shape[0], -1) * self.fourier_weight[None, :]
        components = [four]

        if cfg.include_raw:
            raw = jnp.concatenate([x, jnp.sign(x)], axis=-1)
            components.append(raw * self.raw_scale[None, :])

        if cfg.extra_dim > 0:
            components.append(self.extra_proj(x))

        emb = jnp.concatenate(components, axis=-1)
        return emb.reshape(*shape, cfg.embedding_dim)


class NormalizedMathematicalEncoder(nn.Module):
    """MathematicalEncoder + running-std normalizer.

    Running statistics live in the ``batch_stats`` collection; call with
    ``mutable=["batch_stats"]`` and ``train=True`` to update them (the
    functional analog of the reference's in-place buffers,
    models/mwne.py:29-64).
    """

    config: MWNEConfig
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, numbers: jax.Array, train: bool = False) -> jax.Array:
        cfg = self.config
        embeddings = MathematicalEncoder(cfg, name="base", dtype=self.dtype)(numbers)
        flat = embeddings.reshape(-1, cfg.embedding_dim)

        running_std = self.variable(
            "batch_stats",
            "running_std",
            lambda: jnp.ones((cfg.embedding_dim,), self.dtype),
        )
        num_tracked = self.variable(
            "batch_stats", "num_batches_tracked", lambda: jnp.zeros((), jnp.int32)
        )

        if train:
            batch_std = jnp.std(flat, axis=0)
            prev = running_std.value
            # 50%-change guard: only momentum-update dims whose std moved
            # by less than half of the running value
            # (reference: models/mwne.py:36-47).
            change = jnp.abs(batch_std - prev)
            valid = change < prev * 0.5
            updated = jnp.where(
                valid, cfg.momentum * prev + (1 - cfg.momentum) * batch_std, prev
            )
            first = num_tracked.value == 0
            new_std = jnp.where(first, batch_std, updated)
            new_std = jnp.maximum(new_std, cfg.min_std)
            running_std.value = new_std
            num_tracked.value = num_tracked.value + 1
            std = new_std
        else:
            std = running_std.value

        scaling = cfg.target_std / (std[None, :] + 1e-8)
        scaling = jnp.clip(scaling, 0.1, 10.0)  # reference: models/mwne.py:60
        scaled = flat * scaling
        return scaled.reshape(embeddings.shape)


class MWNEDecoder(nn.Module):
    """Invertibility decoder MLP (reference: models/mwne.py:237-243)."""

    embedding_dim: int
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, emb: jax.Array) -> jax.Array:
        d = self.embedding_dim
        h = nn.Dense(d // 2, name="fc1", dtype=self.dtype)(emb)
        h = nn.gelu(h, approximate=False)
        h = nn.Dense(d // 4, name="fc2", dtype=self.dtype)(h)
        h = nn.gelu(h, approximate=False)
        return nn.Dense(1, name="fc3", dtype=self.dtype)(h)[..., 0]


SECONDS_IN_DAY = 24 * 60 * 60
SECONDS_IN_WEEK = 7 * SECONDS_IN_DAY
SECONDS_IN_YEAR = 365.25 * SECONDS_IN_DAY


def timestamp_features(timestamps: jax.Array) -> jax.Array:
    """Unix seconds -> 9 features: secular trend + day/week/year/month sin-cos
    (reference: models/mwne.py:532-565)."""
    x = timestamps.astype(jnp.float32).reshape(-1, 1)
    two_pi = 2 * math.pi
    secular = x / SECONDS_IN_YEAR
    day_phase = (x % SECONDS_IN_DAY) / SECONDS_IN_DAY
    week_phase = ((x / SECONDS_IN_DAY) + 4) / 7  # epoch was a Thursday
    year_phase = (x % SECONDS_IN_YEAR) / SECONDS_IN_YEAR
    month_phase = year_phase * 12
    feats = [
        secular,
        jnp.sin(two_pi * day_phase), jnp.cos(two_pi * day_phase),
        jnp.sin(two_pi * week_phase), jnp.cos(two_pi * week_phase),
        jnp.sin(two_pi * year_phase), jnp.cos(two_pi * year_phase),
        jnp.sin(two_pi * month_phase), jnp.cos(two_pi * month_phase),
    ]
    return jnp.concatenate(feats, axis=-1)


class TimestampEncoder(nn.Module):
    """9 temporal features -> Linear -> GELU -> Linear(embedding_dim)."""

    embedding_dim: int
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, timestamps: jax.Array) -> jax.Array:
        feats = timestamp_features(timestamps).astype(self.dtype)
        h = nn.Dense(self.embedding_dim * 2, name="fc1", dtype=self.dtype)(feats)
        h = nn.gelu(h, approximate=False)
        return nn.Dense(self.embedding_dim, name="fc2", dtype=self.dtype)(h)


def geo_to_cartesian(coordinates: jax.Array) -> jax.Array:
    """[N, 2] (lat, lon) degrees -> [N, 3] unit-sphere cartesian
    (reference: models/mwne.py:596-608)."""
    lat = jnp.deg2rad(coordinates[:, 0])
    lon = jnp.deg2rad(coordinates[:, 1])
    return jnp.stack(
        [
            jnp.cos(lat) * jnp.cos(lon),
            jnp.cos(lat) * jnp.sin(lon),
            jnp.sin(lat),
        ],
        axis=-1,
    )


class GeoCoordinateEncoder(nn.Module):
    embedding_dim: int
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, coordinates: jax.Array) -> jax.Array:
        if coordinates.ndim != 2 or coordinates.shape[1] != 2:
            raise ValueError("coordinates must be [batch, 2] (lat, lon)")
        xyz = geo_to_cartesian(coordinates).astype(self.dtype)
        h = nn.Dense(self.embedding_dim * 2, name="fc1", dtype=self.dtype)(xyz)
        h = nn.gelu(h, approximate=False)
        return nn.Dense(self.embedding_dim, name="fc2", dtype=self.dtype)(h)


def sinusoidal_position_encoding(
    length: int, d_model: int, dtype=jnp.float32
) -> jax.Array:
    """Standard sinusoidal PE table [length, d_model]
    (reference: models/user_sequence_encoder.py:20-25)."""
    position = jnp.arange(length)[:, None].astype(jnp.float32)
    div_term = jnp.exp(
        jnp.arange(0, d_model, 2).astype(jnp.float32)
        * (-math.log(10000.0) / d_model)
    )
    pe = jnp.zeros((length, d_model), jnp.float32)
    pe = pe.at[:, 0::2].set(jnp.sin(position * div_term))
    pe = pe.at[:, 1::2].set(jnp.cos(position * div_term))
    return pe.astype(dtype)
