"""Item Q-Former reconstruction-quality evaluation.

Rebuild of reference evaluation/evaluate_item_qformer.py: batched forward over
cached validation field embeddings, masked reconstruction MSE + mean cosine
similarity over valid fields (reference :41-104).  The per-field python loops
(:79-93) are one vectorized masked reduction; runs on CPU or GPU (this is the
designated CPU-parity config).
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from unirec.data.cache import FieldEmbeddingCache
from unirec.models.item_qformer import ItemQFormer
from unirec.ops.losses import masked_reconstruction_mse


def evaluate_reconstruction_quality(
    model: ItemQFormer,
    params,
    cache: FieldEmbeddingCache,
    rows: Optional[np.ndarray] = None,
    batch_size: int = 256,
) -> Dict[str, float]:
    @jax.jit
    def step(emb, mask):
        out = model.apply(params, emb, mask)
        recon = out["reconstructed_fields"]
        mse = masked_reconstruction_mse(recon, emb, mask)
        o = emb / jnp.maximum(jnp.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
        r = recon / jnp.maximum(
            jnp.linalg.norm(recon, axis=-1, keepdims=True), 1e-12
        )
        cos = jnp.sum(o * r, axis=-1)
        return mse, jnp.sum(cos * mask), jnp.sum(mask)

    rows = np.arange(len(cache)) if rows is None else rows
    total_mse, total_cos, total_valid, batches = 0.0, 0.0, 0.0, 0
    for i in range(0, len(rows), batch_size):
        r = rows[i : i + batch_size]
        mse, cos_sum, n_valid = step(
            jnp.asarray(cache.embeddings[r]), jnp.asarray(cache.masks[r])
        )
        total_mse += float(mse)
        total_cos += float(cos_sum)
        total_valid += float(n_valid)
        batches += 1
    return {
        "val_recon_loss": total_mse / max(batches, 1),
        "avg_cosine_similarity": total_cos / max(total_valid, 1.0),
        "num_samples": int(len(rows)),
        "num_valid_fields": int(total_valid),
    }
