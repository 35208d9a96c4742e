"""Joint multimodal Qwen3 embedding model (the flagship, stage 5).

JAX rebuild of ``MultiModalQwenEmbedding``
(reference: training/train_item_individual_token_joint.py:88-212): the Item
Q-Former runs *inside* the joint forward on the history items' field
embeddings, its query tokens overwrite the text-embedding rows at reserved
special-token positions, and the Qwen3 decoder (with LoRA) produces a pooled
user embedding trained against frozen candidate-item embeddings with InfoNCE.

Design differences:

* the reference scatters query tokens with a python loop over
  10 items x 2 tokens x batch (:160-171 — a known CPU-side hot spot,
  SURVEY.md §3.3); here injection is one vectorized gather/where over the
  whole [B, L] grid;
* special tokens occupy ids ``[vocab_size, vocab_size + 20)`` — the resized
  rows of the embedding table (reference resizes the HF tokenizer/table,
  :112-119; conversion keeps base weights intact and appends rows);
* everything (Q-Former fwd + injection + 28-layer decoder + pooling) is one
  jit graph with fixed shapes (F, history=10, seq=512).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from unirec import nn
import jax
import jax.numpy as jnp

from unirec.configs import (
    ItemQFormerConfig,
    JointModelConfig,
    LoRAConfig,
    Qwen3Config,
)
from unirec.models.item_qformer import ItemQFormer
from unirec.models.qwen3 import Qwen3Model, last_token_pool, mean_pool

Dtype = Any


def history_token_strings(num_items: int, tokens_per_item: int):
    """The reserved special-token strings
    (reference: train_item_individual_token_joint.py:112-115)."""
    return [
        f"<|history_item_{i}_query_{j}|>"
        for i in range(num_items)
        for j in range(tokens_per_item)
    ]


class MultiModalQwenEmbedding(nn.Module):
    """Qwen3 + LoRA + trainable Item Q-Former with query-token injection."""

    qwen_config: Qwen3Config
    qformer_config: ItemQFormerConfig
    joint_config: JointModelConfig = JointModelConfig()
    lora: Optional[LoRAConfig] = None
    dtype: Dtype = jnp.float32
    remat: bool = False
    remat_policy: Any = None

    @property
    def num_special_tokens(self) -> int:
        jc = self.joint_config
        return jc.num_history_items * jc.num_query_tokens_per_item

    @property
    def first_special_id(self) -> int:
        return self.qwen_config.vocab_size

    @nn.compact
    def __call__(
        self,
        input_ids: jax.Array,  # [B, L]
        attention_mask: Optional[jax.Array] = None,  # [B, L]
        history_field_embeddings: Optional[jax.Array] = None,  # [B, H, F, D]
        history_attention_mask: Optional[jax.Array] = None,  # [B, H, F]
        deterministic: bool = True,
    ) -> jax.Array:
        if self.qformer_config.hidden_size != self.qwen_config.hidden_size:
            raise ValueError(
                "query-token injection requires Q-Former hidden_size "
                f"({self.qformer_config.hidden_size}) == LLM hidden_size "
                f"({self.qwen_config.hidden_size}); the reference uses 1024 "
                "for both (train_item_individual_token_joint.py:107-109)"
            )
        jc = self.joint_config
        n_special = self.num_special_tokens

        qwen = Qwen3Model(
            self.qwen_config,
            lora=self.lora,
            n_extra_tokens=n_special,
            name="base_model",
            dtype=self.dtype,
            remat=self.remat,
            remat_policy=self.remat_policy,
        )
        text_embeds = qwen(input_ids=input_ids, method_embed_only=True)
        b, l, d = text_embeds.shape

        if history_field_embeddings is not None:
            if history_attention_mask is None:
                raise ValueError("history_attention_mask required with history")
            bh, num_hist, num_fields, field_dim = history_field_embeddings.shape
            # Q-Former inside the joint forward
            # (reference: train_item_individual_token_joint.py:146-158).
            qformer = ItemQFormer(
                self.qformer_config, name="qformer", dtype=self.dtype
            )
            flat_fields = history_field_embeddings.reshape(
                bh * num_hist, num_fields, field_dim
            )
            flat_mask = history_attention_mask.reshape(bh * num_hist, num_fields)
            q_out = qformer(
                flat_fields, flat_mask, deterministic=deterministic
            )["query_outputs"]
            k_per_item = jc.num_query_tokens_per_item
            # Use the first k_per_item query tokens of each item.
            tokens = q_out[:, :k_per_item, :].reshape(
                bh, num_hist * k_per_item, -1
            )  # [B, n_special, D]

            # Vectorized injection: offset of each position into the special
            # block; gather the matching query token; where() it in.
            offset = input_ids - self.first_special_id  # [B, L]
            valid = (offset >= 0) & (offset < n_special)
            safe = jnp.clip(offset, 0, n_special - 1)
            gathered = jnp.take_along_axis(
                tokens.astype(text_embeds.dtype), safe[..., None], axis=1
            )  # [B, L, D]
            text_embeds = jnp.where(valid[..., None], gathered, text_embeds)

        hidden = qwen(
            inputs_embeds=text_embeds,
            attention_mask=attention_mask,
            deterministic=deterministic,
        )

        pool = jc.pool
        if pool == "mean":
            # Reference pools the mean over ALL positions including padding
            # (train_item_individual_token_joint.py:180).
            return mean_pool(hidden)
        if pool == "masked_mean":
            return mean_pool(hidden, attention_mask, masked=True)
        if pool == "last_token":
            return last_token_pool(hidden, attention_mask)
        raise ValueError(f"unknown pool {pool}")


def construct_input_text(
    history_ids,
    item_dict: Dict[str, dict],
    num_history_items: int = 10,
    num_query_tokens_per_item: int = 2,
) -> str:
    """Prompt template (reference:
    train_item_individual_token_joint.py:579-592): numbered titles (truncated
    to 80 chars) each followed by that item's query-token placeholders."""
    parts = []
    for i in range(num_history_items):
        token_part = "".join(
            f" <|history_item_{i}_query_{j}|>"
            for j in range(num_query_tokens_per_item)
        )
        if i < len(history_ids):
            item_id = history_ids[i]
            title = item_dict.get(item_id, {}).get("title", f"Item {item_id}")
            if len(title) > 80:
                title = title[:77] + "..."
            parts.append(f"{i + 1}. {title}{token_part}")
        else:
            parts.append(token_part.strip())
    return "I have bought these items in the past: " + ", ".join(parts)
