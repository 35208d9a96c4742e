"""Candidate-pool ranking: one on-device matmul + top-K, plus ranking metrics.

Replaces the reference's per-sample python ranking loop
(reference: training/train_item_individual_token_joint.py:392-419, which
argsorts 100 candidates per sample on GPU one at a time) with a single
vectorized computation, and extends it with Recall@K / NDCG@K (the north-star
parity metrics BASELINE.json names; the reference computes MRR only).

Also provides full-catalog retrieval (``top_k_items``): one users x items
cosine matmul followed by ``lax.top_k``.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from unirec.ops.losses import l2_normalize


def rank_of_positive(
    user_emb: jax.Array,  # [B, D]
    positive_emb: jax.Array,  # [B, D]
    negative_emb: jax.Array,  # [B, N, D]
    negative_mask: Optional[jax.Array] = None,  # [B, N]
) -> jax.Array:
    """1-based rank of the positive among [positive] + negatives by cosine
    similarity (reference semantics: similarities -> argsort descending ->
    position of index 0, train_item_individual_token_joint.py:408-418).

    Computed without argsort: rank = 1 + #negatives with sim > pos_sim
    (ties resolved in the positive's favor, matching the reference where the
    positive at index 0 wins ties under stable argsort).
    """
    u = l2_normalize(user_emb)
    p = l2_normalize(positive_emb)
    n = l2_normalize(negative_emb)
    pos_sim = jnp.sum(u * p, axis=-1)  # [B]
    neg_sim = jnp.einsum("bd,bnd->bn", u, n)  # [B, N]
    if negative_mask is not None:
        neg_sim = jnp.where(negative_mask.astype(bool), neg_sim, -jnp.inf)
    return 1 + jnp.sum(neg_sim > pos_sim[:, None], axis=-1)


def ranking_metrics(
    user_emb: jax.Array,
    positive_emb: jax.Array,
    negative_emb: jax.Array,
    negative_mask: Optional[jax.Array] = None,
    ks: Tuple[int, ...] = (1, 5, 10),
) -> Dict[str, jax.Array]:
    """MRR + Recall@K + NDCG@K for a single relevant item per user.

    With one relevant item, Recall@K = hit@K and
    NDCG@K = 1/log2(rank+1) if rank <= K else 0.
    """
    ranks = rank_of_positive(user_emb, positive_emb, negative_emb, negative_mask)
    out: Dict[str, jax.Array] = {"mrr": jnp.mean(1.0 / ranks)}
    for k in ks:
        hit = ranks <= k
        out[f"recall@{k}"] = jnp.mean(hit.astype(jnp.float32))
        out[f"ndcg@{k}"] = jnp.mean(
            jnp.where(hit, 1.0 / jnp.log2(ranks.astype(jnp.float32) + 1.0), 0.0)
        )
    return out


@functools.partial(jax.jit, static_argnames=("k", "normalize"))
def top_k_items(
    user_emb: jax.Array,  # [B, D]
    catalog_emb: jax.Array,  # [N, D]
    k: int = 10,
    normalize: bool = True,
) -> Tuple[jax.Array, jax.Array]:
    """Full-catalog retrieval: cosine scores + top-K indices, one matmul."""
    u = l2_normalize(user_emb) if normalize else user_emb
    c = l2_normalize(catalog_emb) if normalize else catalog_emb
    scores = jnp.einsum("bd,nd->bn", u, c, preferred_element_type=jnp.float32)
    return jax.lax.top_k(scores, k)
