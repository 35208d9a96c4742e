"""Attention primitives for the Q-Former stacks.

The reference computes attention as unfused torch matmuls with an additive
``-10000`` mask (reference: models/qformer.py:204-264, 793-801).  Here
``attention`` is the same computation as einsums that XLA fuses around the
library matmuls, for self- and cross-attention alike: the item Q-Former's
memory is ~14 fields, and the user Q-Former's (seq_len * K query tokens,
reference: models/user_sequence_encoder.py:133-136) fits in device memory
as a whole [B, H, Lq, Lkv] score matrix.

Layout: per-head ``[B, H, L, head_dim]`` with an additive bias broadcastable
to ``[B, H, Lq, Lkv]``.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

# Large negative for masked logits.  exp(-1e9) == 0.0 in fp32, numerically
# identical to the reference's additive -10000 (models/qformer.py:801).
NEG_INF = -1e9


def make_additive_mask(mask: jax.Array, dtype=jnp.float32) -> jax.Array:
    """[B, Lk] 0/1 validity mask -> additive bias [B, 1, 1, Lk].

    Mirrors ``(1.0 - mask) * -10000`` (reference: models/qformer.py:798-801).
    """
    return ((1.0 - mask.astype(dtype)) * NEG_INF)[:, None, None, :]


def make_causal_mask(
    attention_mask: jax.Array,
    seq_length: int,
    query_length: int = 0,
    dtype=jnp.float32,
) -> jax.Array:
    """Causal (+ optional UniLM query-prefix) additive mask.

    Reproduces BertModel.get_extended_attention_mask for the decoder path
    (reference: models/qformer.py:743-783): text tokens attend causally, the
    ``query_length`` prefix attends bidirectionally among itself, and all rows
    may attend to the full prefix.

    Args:
      attention_mask: [B, L_total] padding mask over the full sequence
        (queries + text).
      seq_length: length of the causal (text) part.
      query_length: length of the bidirectional prefix.
    Returns:
      additive bias [B, 1, L_total, L_total].
    """
    total = query_length + seq_length
    i = jnp.arange(total)[:, None]
    j = jnp.arange(total)[None, :]
    # Text rows: causal within text, full access to prefix.
    causal = (j <= i) | (j < query_length)
    # Query-prefix rows (UniLM): attend only within the prefix.
    prefix_rows = i < query_length
    allowed = jnp.where(prefix_rows, j < query_length, causal)
    combined = allowed[None, :, :].astype(dtype) * attention_mask[:, None, :].astype(dtype)
    return ((1.0 - combined) * NEG_INF)[:, None, :, :]


def split_heads(x: jax.Array, num_heads: int) -> jax.Array:
    """[B, L, D] -> [B, H, L, D//H] (reference: models/qformer.py:161-167)."""
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(0, 2, 1, 3)


def merge_heads(x: jax.Array) -> jax.Array:
    """[B, H, L, hd] -> [B, L, H*hd] (reference: models/qformer.py:266-268)."""
    b, h, l, hd = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b, l, h * hd)


def attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    bias: Optional[jax.Array] = None,
    *,
    dropout_rate: float = 0.0,
    dropout_rng: Optional[jax.Array] = None,
    deterministic: bool = True,
    fast: bool = False,
    return_probs: bool = False,
) -> jax.Array:
    """XLA attention.  q,k,v: [B, H, L, hd]; bias broadcastable to scores.

    ``return_probs=True`` (introspection; forces the fp32 path) returns
    ``(out, probs)`` with the post-dropout [B, H, Lq, Lkv] probabilities —
    the functional stand-in for the reference's save_attention hooks
    (reference: models/qformer.py:147-159).

    Default: softmax in fp32 regardless of input dtype (the reference runs
    fp32 throughout; under bf16 this preserves the normalizer).
    Attention-prob dropout drops whole key positions, matching nn.Dropout on
    probs (reference: models/qformer.py:256-258).

    ``fast=True`` (inference-only): bf16 scores with the exp in fp32 after a
    bf16 max-subtract, for small-L attention; relative error vs the fp32
    path is ~1e-2, comparable to the reference's own fp16 training
    precision (train_item_individual_token_joint.py:762).
    """
    in_dtype = q.dtype
    if (
        fast and not return_probs
        and (deterministic or dropout_rate == 0.0)
        and in_dtype == jnp.bfloat16
    ):
        scale = jnp.bfloat16(1.0 / float(q.shape[-1]) ** 0.5)
        s = jnp.einsum(
            "bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.bfloat16
        ) * scale
        if bias is not None:
            s = s + bias.astype(jnp.bfloat16)
        m = jnp.max(s, axis=-1, keepdims=True)
        e = jnp.exp((s - m).astype(jnp.float32)).astype(jnp.bfloat16)
        probs = e / jnp.sum(e, axis=-1, keepdims=True).astype(jnp.bfloat16)
        return jnp.einsum(
            "bhqk,bhkd->bhqd", probs, v, preferred_element_type=jnp.bfloat16
        )
    scale = 1.0 / jnp.sqrt(jnp.asarray(q.shape[-1], jnp.float32))
    scores = jnp.einsum("bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32)
    scores = scores * scale
    if bias is not None:
        scores = scores + bias.astype(jnp.float32)
    probs = jax.nn.softmax(scores, axis=-1)
    if dropout_rate > 0.0 and not deterministic:
        if dropout_rng is None:
            raise ValueError("dropout_rng required when applying attention dropout")
        keep = jax.random.bernoulli(dropout_rng, 1.0 - dropout_rate, probs.shape)
        probs = jnp.where(keep, probs / (1.0 - dropout_rate), 0.0)
    out = jnp.einsum(
        "bhqk,bhkd->bhqd", probs.astype(in_dtype), v, preferred_element_type=jnp.float32
    )
    if return_probs:
        return out.astype(in_dtype), probs
    return out.astype(in_dtype)
