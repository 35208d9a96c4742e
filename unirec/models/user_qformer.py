"""User Q-Former: fixed-length user representation over a token sequence.

JAX equivalent of UserQFormer
(reference: training/user_qformer_training.py:17-68): a 4-layer Q-Former with
64 query tokens cross-attending at *every* layer into the flattened user event
sequence, mean-pooled into a user vector, then an MLP prediction head emitting
the next item's K query tokens.
"""

from __future__ import annotations

from typing import Any, Optional

from unirec import nn
import jax
import jax.numpy as jnp

from unirec.configs import UserQFormerConfig
from unirec.models.qformer import QFormerModel, bert_init

Dtype = Any


class UserQFormer(nn.Module):
    config: UserQFormerConfig
    dtype: Dtype = jnp.float32
    # sequence-parallel mesh (config.sequence_parallel mode): the history
    # memory axis shards over mesh['sp'] inside every cross-attention
    # (ops/sharded_attention.py); static metadata, set by the trainer.
    sp_mesh: Optional[Any] = None

    @nn.compact
    def __call__(
        self,
        user_sequence_tokens: jax.Array,  # [B, L, input_dim]
        attention_mask: Optional[jax.Array] = None,  # [B, L]
        deterministic: bool = True,
        return_user_representation: bool = False,
    ):
        cfg = self.config
        batch = user_sequence_tokens.shape[0]

        query_embeddings = self.param(
            "query_embeddings",
            nn.initializers.normal(stddev=1.0),
            (1, cfg.num_query_tokens, cfg.hidden_size),
        )
        query_embeds = jnp.broadcast_to(
            query_embeddings, (batch, cfg.num_query_tokens, cfg.hidden_size)
        )
        query_attention_mask = jnp.ones((batch, cfg.num_query_tokens), jnp.float32)

        outputs = QFormerModel(
            cfg.qformer(), name="qformer", dtype=self.dtype,
            sp_mesh=self.sp_mesh,
        )(
            query_embeds=query_embeds,
            attention_mask=query_attention_mask,
            encoder_hidden_states=user_sequence_tokens.astype(self.dtype),
            encoder_attention_mask=attention_mask,
            deterministic=deterministic,
        )
        # Mean over query outputs -> user vector
        # (reference: training/user_qformer_training.py:60).
        user_representation = outputs.mean(axis=1)

        # Prediction head: Linear -> GELU -> LayerNorm -> Linear(K*D)
        # (reference: training/user_qformer_training.py:38-43).
        init = bert_init(0.02)
        h = nn.Dense(
            cfg.hidden_size, kernel_init=init, name="head_dense1", dtype=self.dtype
        )(user_representation)
        h = nn.gelu(h, approximate=False)
        # torch nn.LayerNorm default eps 1e-5 (reference prediction head,
        # user_qformer_training.py:38-43) — flax defaults to 1e-6
        h = nn.LayerNorm(epsilon=1e-5, name="head_norm", dtype=self.dtype)(h)
        flat = nn.Dense(
            cfg.num_item_tokens_to_predict * cfg.input_embedding_dim,
            kernel_init=init,
            name="head_dense2",
            dtype=self.dtype,
        )(h)
        predicted = flat.reshape(
            batch, cfg.num_item_tokens_to_predict, cfg.input_embedding_dim
        )
        if return_user_representation:
            return predicted, user_representation
        return predicted
