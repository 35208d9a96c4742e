"""User Q-Former evaluation: next-item prediction quality.

The reference trains the user stage with best-by-*train*-loss checkpointing
and no validation at all (reference: training/user_qformer_training.py:219-229
"can be expanded with a validation set").  This module provides the missing
evaluation:

* token MSE and mean cosine between predicted and true next-item query tokens
  on held-out samples;
* retrieval accuracy: rank the true next item among the whole catalog by
  similarity between predicted tokens and every item's precomputed tokens
  (mean over the K token cosines) -> hit@K / MRR.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from unirec.data.cache import FieldEmbeddingCache
from unirec.ops.losses import l2_normalize


def token_metrics(pred: jax.Array, target: jax.Array) -> Dict[str, float]:
    """[N, K, D] predicted vs true tokens -> mse + mean per-token cosine."""
    mse = jnp.mean((pred - target) ** 2)
    p = l2_normalize(pred)
    t = l2_normalize(target)
    cos = jnp.sum(p * t, axis=-1).mean()
    return {"token_mse": float(mse), "token_cosine": float(cos)}


@jax.jit
def _token_similarity(pred: jax.Array, catalog_tokens: jax.Array) -> jax.Array:
    """[N, K, D] x [M, K, D] -> [N, M] mean-over-K cosine similarity."""
    p = l2_normalize(pred)  # [N, K, D]
    c = l2_normalize(catalog_tokens)  # [M, K, D]
    return jnp.einsum("nkd,mkd->nm", p, c) / pred.shape[1]


def retrieval_metrics(
    pred_tokens: np.ndarray,  # [N, K, D]
    target_rows: np.ndarray,  # [N] row index of the true next item
    catalog_tokens: np.ndarray,  # [M, K, D]
    ks: Tuple[int, ...] = (1, 5, 10),
) -> Dict[str, float]:
    sims = np.asarray(
        _token_similarity(jnp.asarray(pred_tokens), jnp.asarray(catalog_tokens))
    )
    true_sim = sims[np.arange(len(sims)), target_rows]
    ranks = 1 + (sims > true_sim[:, None]).sum(axis=1)
    out = {"retrieval_mrr": float(np.mean(1.0 / ranks))}
    for k in ks:
        out[f"retrieval_hit@{k}"] = float(np.mean(ranks <= k))
    return out


def evaluate_user_qformer(
    trainer,  # UserQFormerTrainer
    state,
    samples: Sequence[Tuple[List[str], str]],
    item_tokens: np.ndarray,
    cache: FieldEmbeddingCache,
    timestamp_map: Dict[str, int],
    batch_size: int = 64,
) -> Dict[str, float]:
    """Full user-stage evaluation over held-out sliding-window samples."""
    user_model, seq_model = trainer.user_model, trainer.seq_model

    @jax.jit
    def fwd(params, batch):
        flat, flat_mask = seq_model.apply(
            {"params": params["sequence"]},
            batch["item_tokens"], batch["timestamps"],
            batch["coordinates"], batch["seq_mask"],
        )
        return user_model.apply({"params": params["user"]}, flat, flat_mask)

    preds, targets, target_rows = [], [], []
    for i in range(0, len(samples), batch_size):
        idx = list(range(i, min(i + batch_size, len(samples))))
        batch = trainer.make_batch(samples, idx, item_tokens, cache,
                                   timestamp_map)
        p = np.asarray(fwd(state.params, batch), np.float32)
        preds.append(p)
        targets.append(batch["target_tokens"])
        target_rows.extend(
            cache.rows_for([samples[j][1] for j in idx]).tolist()
        )
    pred = np.concatenate(preds)
    target = np.concatenate(targets)
    rows = np.asarray(target_rows)
    valid = rows >= 0
    metrics = token_metrics(jnp.asarray(pred), jnp.asarray(target))
    if valid.any():
        metrics.update(
            retrieval_metrics(pred[valid], rows[valid], item_tokens)
        )
    return metrics
