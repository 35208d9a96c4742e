"""Int8 catalog quantization + quantized retrieval.

A serving-scale feature beyond the reference (which ranks 100-candidate pools
in fp32): the item catalog is stored as int8 rows with per-row scales — 4x
less device memory and 4x less catalog traffic per retrieval, which is
where its time goes (the scan is memory-bound: the whole catalog is read
per call while the score matmul is small).  Scores are computed against the
catalog cast to fp32; cosine ranking is scale-invariant per user, so
per-row dequantization reduces to one multiply on the [B, N] scores.
Round-to-nearest, deterministic.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from unirec.ops.losses import l2_normalize


def quantize_rows(
    x: jax.Array, axis: int = -1
) -> Tuple[jax.Array, jax.Array]:
    """Symmetric per-row int8 quantization: returns (values int8, scales).

    x is L2-normalized first (catalog rows are compared by cosine), so scales
    stay well-conditioned.
    """
    x = l2_normalize(x, axis=axis).astype(jnp.float32)
    absmax = jnp.max(jnp.abs(x), axis=axis, keepdims=True)
    scale = jnp.maximum(absmax, 1e-12) / 127.0
    q = jnp.clip(jnp.round(x / scale), -127, 127).astype(jnp.int8)
    return q, scale[..., 0]


def dequantize_rows(q: jax.Array, scales: jax.Array) -> jax.Array:
    return q.astype(jnp.float32) * scales[..., None]


def quantized_scores(
    user_emb: jax.Array,  # [B, D] (any float dtype)
    catalog_q: jax.Array,  # [N, D] int8
    catalog_scales: jax.Array,  # [N]
) -> jax.Array:
    """[B, N] cosine scores against an int8 catalog (XLA path)."""
    u = l2_normalize(user_emb).astype(jnp.float32)
    s = jnp.einsum(
        "bd,nd->bn", u, catalog_q.astype(jnp.float32),
        preferred_element_type=jnp.float32,
    )
    return s * catalog_scales[None, :]


def quantized_top_k(
    user_emb: jax.Array,
    catalog_q: jax.Array,
    catalog_scales: jax.Array,
    k: int = 10,
) -> Tuple[jax.Array, jax.Array]:
    scores = quantized_scores(user_emb, catalog_q, catalog_scales)
    return jax.lax.top_k(scores, k)
