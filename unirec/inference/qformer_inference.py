"""Batch item-query-token generation — the throughput-critical path.

Provides the ``QFormerInference`` interface that the reference CLI imports but
never ships (reference: data_processing/generate_all_item_embeddings.py:50
imports QFormerInference from qformer_inference.py where it does not exist —
SURVEY.md §7.1.1).  Here it is real, and the hot loop collapses to one
jit-compiled forward over cached field embeddings (SURVEY.md §3.2).

Null-value semantics mirror process_item_for_inference
(reference: data_processing/qformer_inference.py:57-110): a field is masked
out when missing or a null-ish string, and failed encodes degrade to zero
embeddings rather than crashing.
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from unirec.configs import ItemQFormerConfig
from unirec.data.cache import FieldEmbeddingCache
from unirec.models.item_qformer import ItemQFormer

NULL_STRINGS = {
    "", "null", "NULL", "Null", "none", "NONE", "None", "nan", "NaN", "NAN",
}


def is_null_value(value) -> bool:
    """reference: data_processing/qformer_inference.py:74-79."""
    if value is None:
        return True
    if isinstance(value, str):
        return value.strip() in NULL_STRINGS
    return False


class QFormerInference:
    """Checkpointed Item Q-Former + batched jit forward.

    Interface expected by the batch CLI (SURVEY.md C21): ``device``,
    ``generate_query_tokens_by_id(item_id, data_path)``,
    ``generate_query_tokens_batch_by_ids(item_ids, data_path)``.
    """

    def __init__(
        self,
        checkpoint_path: Optional[str] = None,
        device: Optional[str] = None,
        *,
        config: Optional[ItemQFormerConfig] = None,
        params=None,
        field_names: Optional[List[str]] = None,
        item_encoder=None,
        batch_size: int = 512,
        mesh=None,
    ):
        """Runs the bf16 model; ``config.fast_attention`` picks the bf16
        softmax, as the config says, on every platform."""
        if checkpoint_path is not None:
            config, params, field_names = self._load_checkpoint(checkpoint_path)
        if config is None or params is None or field_names is None:
            raise ValueError(
                "provide checkpoint_path or (config, params, field_names)"
            )
        self.config = config
        self.params = params
        self.field_names = list(field_names)
        self.item_encoder = item_encoder
        self.device = device or jax.default_backend()
        self.batch_size = batch_size
        self.model = ItemQFormer(config, dtype=jnp.bfloat16)

        def apply_fn(p, emb, mask):
            return self.model.apply(p, emb, mask)["query_outputs"]

        self.mesh = mesh
        if mesh is not None:
            # dp-sharded catalog sweep: params replicated, batch split over
            # every mesh device; the forward runs fully data-parallel with
            # zero collectives.
            from unirec.parallel.mesh import (
                batch_sharding,
                replicate,
                replicated,
            )

            self.dp_size = mesh.shape["dp"]
            if self.batch_size % self.dp_size:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by mesh size "
                    f"{self.dp_size}"
                )
            self.params = replicate(mesh, self.params)
            self._forward = jax.jit(
                apply_fn,
                in_shardings=(
                    replicated(mesh),
                    batch_sharding(mesh),
                    batch_sharding(mesh),
                ),
                out_shardings=batch_sharding(mesh),
            )
        else:
            self.dp_size = 1
            self._forward = jax.jit(apply_fn)
        self._data_cache: Dict[str, Dict] = {}

    @staticmethod
    def _load_checkpoint(path: str):
        """Load either a checkpoint directory (this framework) or a reference
        ``.pth`` torch checkpoint (compat via utils/torch_convert)."""
        if os.path.isdir(path):
            from unirec.configs import ItemQFormerConfig
            from unirec.utils.checkpoint import load_checkpoint, restore_config

            tree, meta = load_checkpoint(path)
            cfg = restore_config(meta, ItemQFormerConfig)
            return cfg, {"params": tree["params"]}, meta.get("field_names")
        from unirec.utils.torch_convert import (
            load_reference_item_qformer_checkpoint,
        )

        cfg, params, field_names = load_reference_item_qformer_checkpoint(path)
        return cfg, params, field_names

    # ------------------------------------------------------------------
    # Core batched path: cached field embeddings -> query tokens
    # ------------------------------------------------------------------

    def query_tokens_from_embeddings(
        self, field_embeddings: np.ndarray, masks: np.ndarray
    ) -> np.ndarray:
        """[N, F, D] + [N, F] -> [N, K, hidden]; batched jit forward.

        Full chunks run at the fixed jit shape ``batch_size``; a lone
        undersized call runs at its natural shape (padded up to the dp mesh
        size when sharded) so small catalogs don't compile the full-batch
        HLO; a tail after full chunks is padded to ``batch_size`` — one
        compiled shape per regime, never a per-tail retrace.
        """
        n = field_embeddings.shape[0]
        outs = []
        bs = self.batch_size
        for i in range(0, n, bs):
            emb = np.asarray(field_embeddings[i : i + bs], np.float32)
            mask = np.asarray(masks[i : i + bs], np.float32)
            take = emb.shape[0]
            # single undersized call: pad only to the dp multiple
            target = (
                -(-take // self.dp_size) * self.dp_size if i == 0 and n <= bs
                else bs
            )
            pad = target - take
            if pad > 0:
                emb = np.pad(emb, ((0, pad), (0, 0), (0, 0)))
                mask = np.pad(mask, ((0, pad), (0, 0)))
            # numpy in, jit places per in_shardings (split over dp if meshed)
            out = self._forward(self.params, emb, mask)[:take]
            outs.append(np.asarray(out, np.float32))
        return np.concatenate(outs, axis=0)

    def query_tokens_from_cache(
        self, cache: FieldEmbeddingCache, item_ids: Optional[Sequence[str]] = None
    ) -> Dict[str, np.ndarray]:
        ids = list(item_ids) if item_ids is not None else cache.item_ids
        emb, mask = cache.gather(ids)
        tokens = self.query_tokens_from_embeddings(emb, mask)
        return {iid: tokens[i] for i, iid in enumerate(ids)}

    # ------------------------------------------------------------------
    # Raw-item path (encodes fields on the fly via the ItemEncoder)
    # ------------------------------------------------------------------

    def _load_data(self, data_path: str) -> Dict[str, Dict]:
        if data_path not in self._data_cache:
            with open(data_path) as f:
                data = json.load(f)
            for item_id, item in data.items():
                if isinstance(item, dict):
                    item.setdefault("item_id", item_id)
            self._data_cache[data_path] = data
        return self._data_cache[data_path]

    def encode_items(self, items: Sequence[Dict]) -> tuple:
        """Items -> ([N, F, D] embeddings, [N, F] masks) with null-aware
        masking and zero-embedding degradation."""
        if self.item_encoder is None:
            raise ValueError("item_encoder required for raw-item encoding")
        by_field = self.item_encoder.encode_batch_by_field(
            list(items), self.field_names
        )
        n = len(items)
        dim = self.item_encoder.embedding_dim
        emb = np.zeros((n, len(self.field_names), dim), np.float32)
        mask = np.zeros((n, len(self.field_names)), np.float32)
        for fi, f in enumerate(self.field_names):
            emb[:, fi] = by_field[f]
            for j, item in enumerate(items):
                mask[j, fi] = 0.0 if is_null_value(item.get(f)) else 1.0
        # failed encodes produce zero vectors -> masked out as well
        mask *= (np.abs(emb).sum(axis=-1) > 0).astype(np.float32)
        return emb, mask

    def generate_query_tokens_by_id(self, item_id: str, data_path: str):
        data = self._load_data(data_path)
        item = data.get(str(item_id))
        if item is None:
            return None
        emb, mask = self.encode_items([item])
        return self.query_tokens_from_embeddings(emb, mask)[0]

    def generate_query_tokens_batch_by_ids(
        self, item_ids: Sequence[str], data_path: str
    ) -> Dict[str, np.ndarray]:
        data = self._load_data(data_path)
        items, kept = [], []
        for iid in item_ids:
            item = data.get(str(iid))
            if item is not None:
                items.append(item)
                kept.append(str(iid))
        if not items:
            return {}
        emb, mask = self.encode_items(items)
        tokens = self.query_tokens_from_embeddings(emb, mask)
        return {iid: tokens[i] for i, iid in enumerate(kept)}


def run_inference(
    inference: QFormerInference,
    cache: FieldEmbeddingCache,
    output_path: str,
    item_ids: Optional[Sequence[str]] = None,
    log_fn=print,
) -> Dict[str, np.ndarray]:
    """Cache -> {item_id: [K, hidden]} pickle
    (reference: data_processing/qformer_inference.py:112-176)."""
    t0 = time.time()
    tokens = inference.query_tokens_from_cache(cache, item_ids)
    dt = time.time() - t0
    n = len(tokens)
    log_fn(f"generated query tokens for {n} items in {dt:.2f}s "
           f"({n / max(dt, 1e-9):.0f} items/s)")
    if output_path:
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        with open(output_path, "wb") as f:
            pickle.dump(tokens, f)
        log_fn(f"saved to {output_path}")
    return tokens
