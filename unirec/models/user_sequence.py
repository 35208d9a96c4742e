"""User sequence encoding: item query tokens + time/geo context + positions.

JAX rebuild of UserSequenceEncoder
(reference: models/user_sequence_encoder.py:36-142).  The reference re-encodes
every item's fields through Qwen3/CLIP/MWNE *inside the dataloader collate*
for every batch (reference: training/user_qformer_training.py:138-163 — the
pipeline's worst bottleneck, SURVEY.md §3.4).  Here item query tokens come
from the precomputed field-embedding cache through one jitted Item Q-Former
pass, and sequence assembly is a pure batched jnp function:

  contextual = item_tokens + (time_emb + geo_emb)[:, :, None, :]
  flat       = reshape to [B, S*K, D] + sinusoidal PE
  flat_mask  = seq mask broadcast over K

All shapes fixed (max_seq_len) for one jit trace.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from unirec import nn
import jax
import jax.numpy as jnp

from unirec.models.mwne import (
    GeoCoordinateEncoder,
    TimestampEncoder,
    sinusoidal_position_encoding,
)

Dtype = Any


class SequenceContextEncoder(nn.Module):
    """Timestamp + geo MLP encoders producing the per-event context vector
    (reference: models/user_sequence_encoder.py:49-52, 124-131)."""

    embedding_dim: int
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self, timestamps: jax.Array, coordinates: jax.Array
    ) -> jax.Array:
        """[B, S] timestamps + [B, S, 2] coords -> [B, S, D] context."""
        b, s = timestamps.shape
        time_emb = TimestampEncoder(self.embedding_dim, name="timestamp",
                                    dtype=self.dtype)(timestamps.reshape(-1))
        geo_emb = GeoCoordinateEncoder(self.embedding_dim, name="geo",
                                       dtype=self.dtype)(
            coordinates.reshape(-1, 2)
        )
        return (time_emb + geo_emb).reshape(b, s, self.embedding_dim)


def assemble_user_sequence(
    item_tokens: jax.Array,  # [B, S, K, D]
    context: jax.Array,  # [B, S, D]
    seq_mask: Optional[jax.Array] = None,  # [B, S]
    add_positional: bool = True,
) -> Tuple[jax.Array, jax.Array]:
    """Fuse context into item tokens, flatten, add sinusoidal PE.

    Returns (flat_tokens [B, S*K, D], flat_mask [B, S*K]).  Matches the
    reference semantics: context broadcast over the K query tokens
    (:130-131), flatten (:133-136), PE over flattened positions (:138-140).
    """
    b, s, k, d = item_tokens.shape
    fused = item_tokens + context[:, :, None, :]
    flat = fused.reshape(b, s * k, d)
    if add_positional:
        pe = sinusoidal_position_encoding(s * k, d, dtype=flat.dtype)
        flat = flat + pe[None]
    if seq_mask is None:
        flat_mask = jnp.ones((b, s * k), flat.dtype)
    else:
        flat_mask = jnp.repeat(seq_mask.astype(flat.dtype), k, axis=1)
    return flat, flat_mask


class UserSequenceModel(nn.Module):
    """Context encoders + assembly in one module (item tokens supplied by the
    frozen Item Q-Former outside)."""

    embedding_dim: int
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        item_tokens: jax.Array,  # [B, S, K, D]
        timestamps: jax.Array,  # [B, S]
        coordinates: jax.Array,  # [B, S, 2]
        seq_mask: Optional[jax.Array] = None,
    ) -> Tuple[jax.Array, jax.Array]:
        context = SequenceContextEncoder(
            self.embedding_dim, name="context", dtype=self.dtype
        )(timestamps, coordinates)
        return assemble_user_sequence(item_tokens, context, seq_mask)
