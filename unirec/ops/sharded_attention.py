"""Sequence-parallel cross-attention: memory sharded across the mesh.

The reference avoids long sequences architecturally (items compress to K<=32
query tokens, histories truncate — SURVEY.md §5 "long-context").  This op
removes the ceiling: the cross-attention *memory* axis (user-history tokens,
up to seq_len * K vectors) is sharded over a mesh axis; each device computes
attention against its local memory shard and partial softmax statistics are
combined with the standard log-sum-exp trick with collectives
(pmax + psum) under ``shard_map``.

With this, user-history length scales with the mesh: 8 devices hold 8x the
history at the same per-device memory, and the combine is two small
collectives — no ring required at Q-Former scales (queries are tiny).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


def _local_partial_attention(q, k, v, bias):
    """Per-shard partial softmax stats.

    q: [B, H, Lq, hd]; k,v: [B, H, Lkv_local, hd]; bias: [B, 1, 1, Lkv_local].
    Returns (acc [B,H,Lq,hd], l [B,H,Lq,1], m [B,H,Lq,1]) — unnormalized
    context, partial normalizer, local max.
    """
    scale = 1.0 / jnp.sqrt(jnp.asarray(q.shape[-1], jnp.float32))
    s = jnp.einsum(
        "bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32
    ) * scale
    if bias is not None:
        s = s + bias.astype(jnp.float32)
    m = jnp.max(s, axis=-1, keepdims=True)  # [B,H,Lq,1]
    e = jnp.exp(s - m)
    l = jnp.sum(e, axis=-1, keepdims=True)
    acc = jnp.einsum(
        "bhqk,bhkd->bhqd", e.astype(v.dtype), v,
        preferred_element_type=jnp.float32,
    )
    return acc, l, m


def sequence_parallel_cross_attention(
    q: jax.Array,  # [B, H, Lq, hd] (replicated)
    k: jax.Array,  # [B, H, Lkv, hd] (sharded on axis over Lkv)
    v: jax.Array,
    bias: Optional[jax.Array] = None,  # [B, 1, 1, Lkv]
    *,
    mesh: Mesh,
    axis: str = "tp",
) -> jax.Array:
    """Cross-attention with the memory axis sharded over ``mesh[axis]``.

    Exact (not approximate): partial max/normalizer/context per shard, then
    log-sum-exp combine with pmax/psum.  Lkv must be divisible by
    the axis size.
    """
    n_shards = mesh.shape[axis]
    lkv = k.shape[2]
    if lkv % n_shards != 0:
        raise ValueError(f"memory length {lkv} not divisible by {n_shards}")

    def inner(q, k, v, bias):
        acc, l, m = _local_partial_attention(q, k, v, bias)
        # softmax is shift-invariant, so the max subtraction contributes
        # zero gradient mathematically — stop_gradient makes that explicit
        # and keeps the op differentiable (lax.pmax has no transpose rule;
        # the trainer's sp mode differentiates through this op, with
        # shard_map inserting the psum for the replicated q's cotangent)
        m_global = jax.lax.pmax(jax.lax.stop_gradient(m), axis)
        correction = jnp.exp(m - m_global)
        l_global = jax.lax.psum(l * correction, axis)
        acc_global = jax.lax.psum(acc * correction.astype(acc.dtype), axis)
        safe_l = jnp.where(l_global == 0.0, 1.0, l_global)
        return (acc_global / safe_l).astype(q.dtype)

    rep = P()
    kv_spec = P(None, None, axis, None)
    bias_spec = P(None, None, None, axis)
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    if bias is None:
        fn = shard_map(
            lambda q, k, v: inner(q, k, v, None),
            mesh=mesh,
            in_specs=(rep, kv_spec, kv_spec),
            out_specs=rep,
        )
        return fn(q, k, v)
    fn = shard_map(
        inner,
        mesh=mesh,
        in_specs=(rep, kv_spec, kv_spec, bias_spec),
        out_specs=rep,
    )
    return fn(q, k, v, bias)
