"""Q-Former: BERT encoder with learned query tokens + cross-attention.

Re-designs the BLIP-2 Salesforce BERT fork (reference: models/qformer.py) as a
functional module stack (unirec/nn.py):

* a block of learned *query tokens* is (optionally) prepended to text tokens
  (reference: models/qformer.py:101-104);
* every layer self-attends over the full [queries + text] sequence; layers with
  ``layer_num % cross_attention_freq == 0`` additionally cross-attend the query
  slice into an external memory of width ``encoder_width``
  (reference: models/qformer.py:386-395, 429-447);
* queries and text tokens go through *separate* FFNs
  (``intermediate_query``/``output_query`` vs ``intermediate``/``output``,
  reference: models/qformer.py:449-462);
* masks are additive ("-10000" semantics, reference: models/qformer.py:798-801);
  the decoder path applies a causal + UniLM-prefix mask
  (reference: models/qformer.py:743-783).

Differences from the reference, by design:

* fixed shapes, no data-dependent control flow — jit traces once;
* attention is plain ``jnp`` einsums (unirec/ops/attention.py) that XLA
  fuses around the library matmuls;
* gradient checkpointing via ``nn.remat`` (``jax.checkpoint``) instead of
  torch.utils.checkpoint (reference: models/qformer.py:525-548).
"""

from __future__ import annotations

from typing import Any, Optional

from unirec import nn
import jax
import jax.numpy as jnp

from unirec.configs import QFormerConfig
from unirec.ops.attention import (
    attention,
    make_additive_mask,
    make_causal_mask,
    merge_heads,
    split_heads,
)

Dtype = Any

# torch's nn.GELU / BERT "gelu" is the exact erf form; jax.nn.gelu defaults
# to the tanh approximation, so pin approximate=False for numerical parity.
ACT2FN = {
    "gelu": lambda x: nn.gelu(x, approximate=False),
    "relu": nn.relu,
    "silu": nn.silu,
    "gelu_new": lambda x: nn.gelu(x, approximate=True),
}


def bert_init(stddev: float):
    return nn.initializers.normal(stddev=stddev)


class QFormerEmbeddings(nn.Module):
    """Word + absolute position embeddings; queries are prepended *before* the
    shared LayerNorm/dropout (reference: models/qformer.py:95-107)."""

    config: QFormerConfig
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        input_ids: Optional[jax.Array] = None,
        query_embeds: Optional[jax.Array] = None,
        position_ids: Optional[jax.Array] = None,
        past_length: int = 0,
        deterministic: bool = True,
    ) -> jax.Array:
        cfg = self.config
        if input_ids is not None:
            word_emb = nn.Embed(
                cfg.vocab_size,
                cfg.hidden_size,
                embedding_init=bert_init(cfg.initializer_range),
                name="word_embeddings",
                dtype=self.dtype,
            )(input_ids)
            embeddings = word_emb
            if cfg.position_embedding_type == "absolute":
                # relative variants skip the absolute position table
                # (reference: models/qformer.py:96-99)
                seq_len = input_ids.shape[1]
                if position_ids is None:
                    position_ids = jnp.arange(
                        past_length, past_length + seq_len
                    )[None, :]
                pos_emb = nn.Embed(
                    cfg.max_position_embeddings,
                    cfg.hidden_size,
                    embedding_init=bert_init(cfg.initializer_range),
                    name="position_embeddings",
                    dtype=self.dtype,
                )(position_ids)
                embeddings = word_emb + pos_emb
            if query_embeds is not None:
                embeddings = jnp.concatenate(
                    [query_embeds.astype(embeddings.dtype), embeddings], axis=1
                )
        else:
            if query_embeds is None:
                raise ValueError("need input_ids or query_embeds")
            embeddings = query_embeds.astype(self.dtype)

        embeddings = nn.LayerNorm(
            epsilon=cfg.layer_norm_eps, name="LayerNorm", dtype=self.dtype
        )(embeddings)
        embeddings = nn.Dropout(cfg.hidden_dropout_prob)(
            embeddings, deterministic=deterministic
        )
        return embeddings


class QFormerAttention(nn.Module):
    """Self- or cross-attention block: projections + attention + residual
    output (dense -> dropout -> LayerNorm(x + residual)),
    reference: models/qformer.py:111-346."""

    config: QFormerConfig
    is_cross: bool = False
    dtype: Dtype = jnp.float32
    # sequence-parallel mesh: when set (and its 'sp' axis > 1), cross-
    # attention memory is sharded over the mesh and combined exactly via
    # log-sum-exp collectives (ops/sharded_attention.py) — the user stage's
    # `--sp N` long-history mode.  Static module metadata, not a param.
    sp_mesh: Optional[Any] = None

    @nn.compact
    def __call__(
        self,
        hidden_states: jax.Array,
        bias: Optional[jax.Array] = None,
        kv_states: Optional[jax.Array] = None,
        deterministic: bool = True,
    ) -> jax.Array:
        cfg = self.config
        heads = cfg.num_attention_heads
        init = bert_init(cfg.initializer_range)
        dense = lambda name: nn.Dense(
            cfg.hidden_size, kernel_init=init, name=name, dtype=self.dtype
        )

        src = kv_states if self.is_cross else hidden_states
        q = split_heads(dense("query")(hidden_states), heads)

        drop_rate = cfg.attention_probs_dropout_prob
        rng = (
            self.make_rng("dropout")
            if (drop_rate > 0.0 and not deterministic)
            else None
        )
        # Introspection (utils.debug.capture_attention_maps): force the
        # plain XLA prob-materializing paths and sow the probs — the
        # functional equivalent of the reference's save_attention hooks
        # (reference: models/qformer.py:147-159, 252-254).
        capture = cfg.capture_attention_probs
        fast = cfg.fast_attention and deterministic and not capture
        if (
            self.is_cross
            and not capture
            and self.sp_mesh is not None
            and self.sp_mesh.shape.get("sp", 1) > 1
            and not fast
        ):
            # sequence-parallel cross-attention: K/V project under GSPMD
            # (XLA shards the [B, Lkv, D] memory over 'sp' via the trainer's
            # sharding constraint), then exact log-sum-exp combine by
            # collectives (ops/sharded_attention.py).  Requires deterministic
            # attention probs (the config zeroes prob dropout);
            # grads flow through shard_map (replicated q's cotangent is
            # psum'd at the boundary automatically).
            if rng is not None:
                raise ValueError(
                    "sequence-parallel cross-attention requires "
                    "attention-prob dropout off (set sequence_parallel "
                    "on the config so qformer() zeroes it)"
                )
            from unirec.ops.sharded_attention import (
                sequence_parallel_cross_attention,
            )

            k = split_heads(dense("key")(src), heads)
            v = split_heads(dense("value")(src), heads)
            ctx = sequence_parallel_cross_attention(
                q, k, v, bias, mesh=self.sp_mesh, axis="sp"
            )
        elif (
            not self.is_cross
            and cfg.position_embedding_type != "absolute"
        ):
            # BERT relative-position scoring (reference:
            # models/qformer.py:207-242): distance embeddings contribute
            # q·pe (and k·pe for relative_key_query) to the RAW scores,
            # and the sum is scaled by 1/sqrt(hd) afterwards — faithfully
            # reproduced, including the fp32 softmax.  Self-attention only:
            # the reference einsum assumes Lq == Lkv, which never holds for
            # cross-attention.
            k = split_heads(dense("key")(src), heads)
            v = split_heads(dense("value")(src), heads)
            length = hidden_states.shape[1]
            hd = cfg.head_dim
            positions = jnp.arange(length)
            distance = positions[:, None] - positions[None, :]
            pe = nn.Embed(
                2 * cfg.max_position_embeddings - 1,
                hd,
                embedding_init=bert_init(cfg.initializer_range),
                name="distance_embedding",
                dtype=self.dtype,
            )(distance + cfg.max_position_embeddings - 1)  # [L, L, hd]
            scores = jnp.einsum(
                "bhld,bhrd->bhlr", q, k, preferred_element_type=jnp.float32
            )
            scores += jnp.einsum(
                "bhld,lrd->bhlr", q, pe, preferred_element_type=jnp.float32
            )
            if cfg.position_embedding_type == "relative_key_query":
                scores += jnp.einsum(
                    "bhrd,lrd->bhlr", k, pe,
                    preferred_element_type=jnp.float32,
                )
            scores = scores / jnp.sqrt(jnp.asarray(hd, jnp.float32))
            if bias is not None:
                scores = scores + bias.astype(jnp.float32)
            probs = jax.nn.softmax(scores, axis=-1)
            if rng is not None:
                keep = jax.random.bernoulli(rng, 1.0 - drop_rate, probs.shape)
                probs = jnp.where(keep, probs / (1.0 - drop_rate), 0.0)
            if capture:
                self.sow("intermediates", "attention_probs", probs)
            ctx = jnp.einsum(
                "bhlr,bhrd->bhld", probs.astype(q.dtype), v,
                preferred_element_type=jnp.float32,
            ).astype(q.dtype)
        else:
            # cross-attention K/V project from encoder_width
            # (reference: models/qformer.py:128-133)
            k = split_heads(dense("key")(src), heads)
            v = split_heads(dense("value")(src), heads)
            if capture:
                ctx, probs = attention(
                    q, k, v, bias,
                    dropout_rate=drop_rate, dropout_rng=rng,
                    deterministic=deterministic, return_probs=True,
                )
                self.sow("intermediates", "attention_probs", probs)
            else:
                ctx = attention(
                    q,
                    k,
                    v,
                    bias,
                    dropout_rate=drop_rate,
                    dropout_rng=rng,
                    deterministic=deterministic,
                    fast=fast,
                )
        out_pre = nn.Dense(
            cfg.hidden_size, kernel_init=init, name="output_dense",
            dtype=self.dtype,
        )(merge_heads(ctx))
        out = nn.Dropout(cfg.hidden_dropout_prob)(
            out_pre, deterministic=deterministic
        )
        out = nn.LayerNorm(
            epsilon=cfg.layer_norm_eps, name="output_LayerNorm", dtype=self.dtype
        )(out + hidden_states)
        return out


class QFormerFFN(nn.Module):
    """intermediate -> act -> output dense -> dropout -> LN(x + residual),
    reference: models/qformer.py:349-375."""

    config: QFormerConfig
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array, deterministic: bool = True) -> jax.Array:
        cfg = self.config
        init = bert_init(cfg.initializer_range)
        h = nn.Dense(
            cfg.intermediate_size, kernel_init=init, name="intermediate_dense",
            dtype=self.dtype,
        )(x)
        h = ACT2FN[cfg.hidden_act](h)
        h = nn.Dense(
            cfg.hidden_size, kernel_init=init, name="output_dense", dtype=self.dtype
        )(h)
        h = nn.Dropout(cfg.hidden_dropout_prob)(h, deterministic=deterministic)
        return nn.LayerNorm(
            epsilon=cfg.layer_norm_eps, name="output_LayerNorm", dtype=self.dtype
        )(h + x)


class QFormerLayer(nn.Module):
    """One transformer layer with optional query cross-attention and split
    query/text FFN (reference: models/qformer.py:378-484)."""

    config: QFormerConfig
    has_cross_attention: bool
    dtype: Dtype = jnp.float32
    sp_mesh: Optional[Any] = None

    @nn.compact
    def __call__(
        self,
        hidden_states: jax.Array,
        self_bias: Optional[jax.Array],
        encoder_hidden_states: Optional[jax.Array],
        encoder_bias: Optional[jax.Array],
        query_length: int,
        deterministic: bool = True,
    ) -> jax.Array:
        cfg = self.config
        attn_out = QFormerAttention(cfg, name="attention", dtype=self.dtype)(
            hidden_states, self_bias, deterministic=deterministic
        )

        if query_length > 0:
            query_part = attn_out[:, :query_length]
            if self.has_cross_attention:
                if encoder_hidden_states is None:
                    raise ValueError(
                        "encoder_hidden_states required for cross-attention layers"
                    )
                query_part = QFormerAttention(
                    cfg, is_cross=True, name="crossattention",
                    dtype=self.dtype, sp_mesh=self.sp_mesh,
                )(
                    query_part,
                    encoder_bias,
                    kv_states=encoder_hidden_states,
                    deterministic=deterministic,
                )
            query_out = QFormerFFN(cfg, name="ffn_query", dtype=self.dtype)(
                query_part, deterministic=deterministic
            )
            if attn_out.shape[1] > query_length:
                text_out = QFormerFFN(cfg, name="ffn", dtype=self.dtype)(
                    attn_out[:, query_length:], deterministic=deterministic
                )
                return jnp.concatenate([query_out, text_out], axis=1)
            return query_out

        return QFormerFFN(cfg, name="ffn", dtype=self.dtype)(
            attn_out, deterministic=deterministic
        )


class QFormerEncoder(nn.Module):
    """Layer stack; cross-attention on layers where
    ``i % cross_attention_freq == 0`` (reference: models/qformer.py:386-389)."""

    config: QFormerConfig
    dtype: Dtype = jnp.float32
    sp_mesh: Optional[Any] = None

    @nn.compact
    def __call__(
        self,
        hidden_states: jax.Array,
        self_bias: Optional[jax.Array],
        encoder_hidden_states: Optional[jax.Array],
        encoder_bias: Optional[jax.Array],
        query_length: int,
        deterministic: bool = True,
    ) -> jax.Array:
        cfg = self.config
        layer_cls = QFormerLayer
        if cfg.gradient_checkpointing:
            layer_cls = nn.remat(QFormerLayer, static_argnums=(5, 6))
        for i in range(cfg.num_hidden_layers):
            has_cross = (
                cfg.add_cross_attention and i % cfg.cross_attention_freq == 0
            )
            hidden_states = layer_cls(
                cfg, has_cross, name=f"layer_{i}", dtype=self.dtype,
                sp_mesh=self.sp_mesh,
            )(
                hidden_states,
                self_bias,
                encoder_hidden_states,
                encoder_bias,
                query_length,
                deterministic,
            )
        return hidden_states


class QFormerPooler(nn.Module):
    """dense+tanh over the first token (reference: models/qformer.py:592-604).

    Unused by every UniRec pipeline (the reference constructs BertModel with
    ``add_pooling_layer=False`` everywhere); provided for backbone parity.
    """

    config: QFormerConfig
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, hidden_states: jax.Array) -> jax.Array:
        first = hidden_states[:, 0]
        h = nn.Dense(
            self.config.hidden_size,
            kernel_init=bert_init(self.config.initializer_range),
            name="dense",
            dtype=self.dtype,
        )(first)
        return jnp.tanh(h)


class QFormerModel(nn.Module):
    """Functional equivalent of BertModel (reference: models/qformer.py:677-972).

    Returns the last hidden state ``[B, query_length + text_length, hidden]``
    (plus the tanh-pooled first token when ``add_pooling_layer=True``,
    reference: models/qformer.py:691-694).
    """

    config: QFormerConfig
    dtype: Dtype = jnp.float32
    add_pooling_layer: bool = False
    sp_mesh: Optional[Any] = None

    @nn.compact
    def __call__(
        self,
        input_ids: Optional[jax.Array] = None,
        attention_mask: Optional[jax.Array] = None,
        query_embeds: Optional[jax.Array] = None,
        encoder_hidden_states: Optional[jax.Array] = None,
        encoder_attention_mask: Optional[jax.Array] = None,
        position_ids: Optional[jax.Array] = None,
        is_decoder: bool = False,
        deterministic: bool = True,
    ) -> jax.Array:
        cfg = self.config
        query_length = query_embeds.shape[1] if query_embeds is not None else 0

        hidden = QFormerEmbeddings(cfg, name="embeddings", dtype=self.dtype)(
            input_ids=input_ids,
            query_embeds=query_embeds,
            position_ids=position_ids,
            deterministic=deterministic,
        )
        batch, total_len = hidden.shape[:2]

        if attention_mask is None:
            attention_mask = jnp.ones((batch, total_len), dtype=jnp.float32)

        if is_decoder:
            text_len = total_len - query_length
            self_bias = make_causal_mask(
                attention_mask, text_len, query_length=query_length
            )
        else:
            self_bias = make_additive_mask(attention_mask)

        encoder_bias = None
        if encoder_hidden_states is not None:
            if encoder_attention_mask is None:
                encoder_attention_mask = jnp.ones(
                    encoder_hidden_states.shape[:2], dtype=jnp.float32
                )
            encoder_bias = make_additive_mask(encoder_attention_mask)

        sequence_output = QFormerEncoder(
            cfg, name="encoder", dtype=self.dtype, sp_mesh=self.sp_mesh
        )(
            hidden,
            self_bias,
            encoder_hidden_states,
            encoder_bias,
            query_length,
            deterministic=deterministic,
        )
        if self.add_pooling_layer:
            pooled = QFormerPooler(cfg, name="pooler", dtype=self.dtype)(
                sequence_output
            )
            return sequence_output, pooled
        return sequence_output


class QFormerLMPredictionHead(nn.Module):
    """transform(dense->act->LN) -> decoder vocab projection
    (reference: models/qformer.py:607-641)."""

    config: QFormerConfig
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, hidden_states: jax.Array) -> jax.Array:
        cfg = self.config
        init = bert_init(cfg.initializer_range)
        h = nn.Dense(
            cfg.hidden_size, kernel_init=init, name="transform_dense",
            dtype=self.dtype,
        )(hidden_states)
        h = ACT2FN[cfg.hidden_act](h)
        h = nn.LayerNorm(
            epsilon=cfg.layer_norm_eps, name="transform_LayerNorm", dtype=self.dtype
        )(h)
        return nn.Dense(
            cfg.vocab_size, kernel_init=init, name="decoder", dtype=self.dtype
        )(h)


def causal_lm_loss(
    logits: jax.Array,
    labels: jax.Array,
    label_smoothing: float = 0.1,
    ignore_index: int = -100,
) -> jax.Array:
    """Shifted causal LM loss with label smoothing 0.1
    (reference: models/qformer.py:1077-1086)."""
    logits = logits[:, :-1]
    labels = labels[:, 1:]
    valid = labels != ignore_index
    labels_safe = jnp.where(valid, labels, 0)
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    vocab = logits.shape[-1]
    nll = -jnp.take_along_axis(logp, labels_safe[..., None], axis=-1)[..., 0]
    smooth = -jnp.mean(logp, axis=-1)
    loss = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    loss = jnp.where(valid, loss, 0.0)
    return loss.sum() / jnp.maximum(valid.sum(), 1)


class QFormerLMHeadModel(nn.Module):
    """Causal/UniLM LM over [queries + text]
    (reference: models/qformer.py:975-1135).

    Query positions are excluded from the LM logits (the reference drops
    ``sequence_output[:, query_length:]``, models/qformer.py:1061-1063).
    """

    config: QFormerConfig
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        input_ids: jax.Array,
        attention_mask: Optional[jax.Array] = None,
        query_embeds: Optional[jax.Array] = None,
        encoder_hidden_states: Optional[jax.Array] = None,
        encoder_attention_mask: Optional[jax.Array] = None,
        labels: Optional[jax.Array] = None,
        deterministic: bool = True,
    ):
        query_length = query_embeds.shape[1] if query_embeds is not None else 0
        hidden = QFormerModel(self.config, name="bert", dtype=self.dtype)(
            input_ids=input_ids,
            attention_mask=attention_mask,
            query_embeds=query_embeds,
            encoder_hidden_states=encoder_hidden_states,
            encoder_attention_mask=encoder_attention_mask,
            is_decoder=True,
            deterministic=deterministic,
        )
        text_hidden = hidden[:, query_length:]
        logits = QFormerLMPredictionHead(
            self.config, name="cls", dtype=self.dtype
        )(text_hidden)
        if labels is not None:
            return logits, causal_lm_loss(logits, labels)
        return logits


def greedy_generate(
    model: "QFormerLMHeadModel",
    params,
    query_embeds: jax.Array,
    encoder_hidden_states: Optional[jax.Array] = None,
    encoder_attention_mask: Optional[jax.Array] = None,
    bos_token_id: int = 30522 - 1,
    eos_token_id: int = 102,
    pad_token_id: int = 0,
    max_new_tokens: int = 32,
) -> jax.Array:
    """Greedy decoding with the UniLM decoder mask (functional equivalent of
    the reference's HF-generate helpers, models/qformer.py:1104-1135).

    Fixed-shape: the text buffer is padded to ``max_new_tokens`` and positions
    after EOS are frozen to ``pad_token_id``; each step re-runs the forward at
    full length (no KV cache — generation is not a UniRec hot path; the hot
    paths are the encoder forwards).
    """
    batch = query_embeds.shape[0]
    k = query_embeds.shape[1]
    ids = jnp.full((batch, max_new_tokens), pad_token_id, jnp.int32)
    ids = ids.at[:, 0].set(bos_token_id)
    finished = jnp.zeros((batch,), bool)

    def fwd(ids, length_mask):
        full_mask = jnp.concatenate(
            [jnp.ones((batch, k), jnp.float32), length_mask], axis=1
        )
        return model.apply(
            params,
            input_ids=ids,
            attention_mask=full_mask,
            query_embeds=query_embeds,
            encoder_hidden_states=encoder_hidden_states,
            encoder_attention_mask=encoder_attention_mask,
        )

    def body(carry, step):
        ids, finished = carry
        length_mask = (
            jnp.arange(max_new_tokens)[None, :] <= step
        ).astype(jnp.float32).repeat(batch, axis=0)
        logits = fwd(ids, length_mask)  # [B, T, V]
        next_tok = jnp.argmax(logits[:, step], axis=-1).astype(jnp.int32)
        next_tok = jnp.where(finished, pad_token_id, next_tok)
        write = jnp.minimum(step + 1, max_new_tokens - 1)
        ids = ids.at[:, write].set(
            jnp.where(step + 1 < max_new_tokens, next_tok, ids[:, write])
        )
        finished = finished | (next_tok == eos_token_id)
        return (ids, finished), None

    (ids, _), _ = jax.lax.scan(
        body, (ids, finished), jnp.arange(max_new_tokens - 1)
    )
    return ids


class QFormerForMaskedLM(nn.Module):
    """Masked-LM head over text positions
    (reference: models/qformer.py:1138-1223; the reference's MLM path crashes
    when query_embeds is None, SURVEY.md §7.1.6 — fixed here)."""

    config: QFormerConfig
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        input_ids: jax.Array,
        attention_mask: Optional[jax.Array] = None,
        query_embeds: Optional[jax.Array] = None,
        encoder_hidden_states: Optional[jax.Array] = None,
        encoder_attention_mask: Optional[jax.Array] = None,
        labels: Optional[jax.Array] = None,
        deterministic: bool = True,
    ):
        query_length = query_embeds.shape[1] if query_embeds is not None else 0
        hidden = QFormerModel(self.config, name="bert", dtype=self.dtype)(
            input_ids=input_ids,
            attention_mask=attention_mask,
            query_embeds=query_embeds,
            encoder_hidden_states=encoder_hidden_states,
            encoder_attention_mask=encoder_attention_mask,
            is_decoder=False,
            deterministic=deterministic,
        )
        text_hidden = hidden[:, query_length:]
        logits = QFormerLMPredictionHead(
            self.config, name="cls", dtype=self.dtype
        )(text_hidden)
        if labels is not None:
            valid = labels != -100
            labels_safe = jnp.where(valid, labels, 0)
            logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
            nll = -jnp.take_along_axis(logp, labels_safe[..., None], axis=-1)[..., 0]
            loss = jnp.where(valid, nll, 0.0).sum() / jnp.maximum(valid.sum(), 1)
            return logits, loss
        return logits
