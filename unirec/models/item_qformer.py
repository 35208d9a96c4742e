"""Item Q-Former: compresses an item's per-field embeddings into K query tokens.

JAX equivalent of QFormerForItemRepresentation
(reference: models/qformer_utils.py:16-60; the near-duplicate
models/qformer_model.py:8 differs only in default K and is unified here with
K as config, SURVEY.md §7.1.4).

Forward contract (shapes fixed for jit):
  field_embeddings: [B, F, field_dim]   (F = num_fields)
  attention_mask:   [B, F]   1 = field present, 0 = missing
returns dict:
  query_outputs:        [B, K, hidden]
  item_representation:  [B, field_dim]   Linear(mean over queries)
  reconstructed_fields: [B, F, field_dim]
      = field_projection over the K axis of recon_head(query_outputs)
        (the Linear(K->F)-on-transpose trick, reference:
        models/qformer_utils.py:52-54)
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from unirec import nn
import jax
import jax.numpy as jnp

from unirec.configs import ItemQFormerConfig
from unirec.models.qformer import QFormerModel, bert_init

Dtype = Any


class ItemQFormer(nn.Module):
    config: ItemQFormerConfig
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        field_embeddings: jax.Array,
        attention_mask: Optional[jax.Array] = None,
        deterministic: bool = True,
        modality_ids: Optional[jax.Array] = None,  # [F] schema modality ids
    ) -> Dict[str, jax.Array]:
        cfg = self.config
        batch = field_embeddings.shape[0]

        # Learned query tokens, standard-normal init like nn.Parameter(randn)
        # (reference: models/qformer_utils.py:30).
        query_embeddings = self.param(
            "query_embeddings",
            nn.initializers.normal(stddev=1.0),
            (1, cfg.num_query_tokens, cfg.hidden_size),
        )
        query_embeds = jnp.broadcast_to(
            query_embeddings, (batch, cfg.num_query_tokens, cfg.hidden_size)
        )

        if attention_mask is None:
            attention_mask = jnp.ones(field_embeddings.shape[:2], jnp.float32)

        if cfg.use_field_type_embeddings:
            # field-id + modality-id embeddings summed onto value embeddings
            # ("triplet" conditioning; salvages the reference's dead sketch,
            # models/item_encoder_triplet.py:160-183).
            field_table = self.param(
                "field_id_embeddings",
                nn.initializers.normal(stddev=0.02),
                (cfg.num_fields, cfg.field_embedding_dim),
            )
            field_embeddings = field_embeddings + field_table[None, :, :]
            if modality_ids is not None:
                modality_table = self.param(
                    "modality_id_embeddings",
                    nn.initializers.normal(stddev=0.02),
                    (cfg.num_modalities, cfg.field_embedding_dim),
                )
                field_embeddings = (
                    field_embeddings + modality_table[modality_ids][None, :, :]
                )

        # Queries are never masked (reference: models/qformer_utils.py:43).
        query_attention_mask = jnp.ones((batch, cfg.num_query_tokens), jnp.float32)

        query_outputs = QFormerModel(cfg.qformer(), name="qformer", dtype=self.dtype)(
            query_embeds=query_embeds,
            attention_mask=query_attention_mask,
            encoder_hidden_states=field_embeddings.astype(self.dtype),
            encoder_attention_mask=attention_mask,
            deterministic=deterministic,
        )

        init = bert_init(0.02)
        item_representation = nn.Dense(
            cfg.field_embedding_dim,
            kernel_init=init,
            name="item_representation_head",
            dtype=self.dtype,
        )(query_outputs.mean(axis=1))

        recon = nn.Dense(
            cfg.field_embedding_dim,
            kernel_init=init,
            name="reconstruction_head",
            dtype=self.dtype,
        )(query_outputs)  # [B, K, field_dim]
        # Linear over the query axis: [B, K, D] -> [B, F, D]
        # (reference transposes, applies Linear(K->F), transposes back,
        # models/qformer_utils.py:54).
        reconstructed = nn.DenseGeneral(
            features=cfg.num_fields,
            axis=1,
            kernel_init=init,
            name="field_projection",
            dtype=self.dtype,
        )(recon)  # [B, field_dim, F]... DenseGeneral contracts axis 1 -> appends F
        reconstructed = jnp.moveaxis(reconstructed, -1, 1)  # [B, F, field_dim]

        return {
            "query_outputs": query_outputs,
            "item_representation": item_representation,
            "reconstructed_fields": reconstructed,
        }
