"""KV-cached greedy decoding for QFormerLMHeadModel.

The reference LM head generates via HF ``generate`` with ``past_key_values``
(reference: models/qformer.py:1015-1035, 1104-1135).  ``greedy_generate``
(models/qformer.py) re-runs the full forward per step — O(T²).  This module
is the O(T) equivalent: a functional decoder over the model's own parameter
pytree with a ``lax.scan``-carried per-layer KV cache.

Decoder structure (models/qformer.py QFormerLayer):
* the query prefix attends only within itself (UniLM mask) and never to
  text, so its hidden states — and therefore its per-layer K/V — are
  text-independent and computed once at prefill (with cross-attention into
  the encoder memory on ``cross_attention_freq`` layers, and the query FFN);
* each text token self-attends over [prefix + generated-so-far] causally,
  skips cross-attention, and runs the *text* FFN ("ffn" params) — so the
  decode step only appends one K/V column per layer and re-uses the cache.

All shapes static under jit: cache is [B, H, K + T, hd] per layer, masked by
step index.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from unirec.configs import QFormerConfig
from unirec.ops.attention import NEG_INF, merge_heads, split_heads


def _ln(x, p, eps):
    x32 = x.astype(jnp.float32)
    mu = jnp.mean(x32, axis=-1, keepdims=True)
    xc = x32 - mu
    var = jnp.mean(xc * xc, axis=-1, keepdims=True)
    y = xc * jax.lax.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.astype(x.dtype)


def _dense(x, p):
    return x @ p["kernel"] + p["bias"]


def _gelu(x):
    return jax.nn.gelu(x.astype(jnp.float32), approximate=False).astype(
        x.dtype
    )


def _attend(q, k, v, bias=None):
    """q,k,v: [B, H, L, hd]; fp32 softmax (parity with ops.attention)."""
    scale = 1.0 / jnp.sqrt(jnp.asarray(q.shape[-1], jnp.float32))
    s = jnp.einsum(
        "bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32
    ) * scale
    if bias is not None:
        s = s + bias.astype(jnp.float32)
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum(
        "bhqk,bhkd->bhqd", p.astype(q.dtype), v,
        preferred_element_type=jnp.float32,
    ).astype(q.dtype)


def _attention_block(h, p, heads, eps, kv_states=None, bias=None,
                     return_kv=False):
    """projections + attention + output residual LN
    (reference: models/qformer.py:111-346)."""
    src = h if kv_states is None else kv_states
    q = split_heads(_dense(h, p["query"]), heads)
    k = split_heads(_dense(src, p["key"]), heads)
    v = split_heads(_dense(src, p["value"]), heads)
    ctx = merge_heads(_attend(q, k, v, bias))
    out = _ln(_dense(ctx, p["output_dense"]) + h, p["output_LayerNorm"], eps)
    if return_kv:
        return out, (k, v)
    return out


def _ffn(h, p, eps):
    y = _dense(_gelu(_dense(h, p["intermediate_dense"])), p["output_dense"])
    return _ln(y + h, p["output_LayerNorm"], eps)


def _prefill(params, cfg: QFormerConfig, query_embeds,
             encoder_hidden_states, encoder_attention_mask):
    """Query-prefix forward; returns per-layer prefix K/V stacks.

    The prefix self-attends bidirectionally within itself
    (make_causal_mask's UniLM rows, ops/attention.py) with no padding mask
    (queries are never masked), so bias=None.
    """
    bert = params["params"]["bert"]
    eps = cfg.layer_norm_eps
    heads = cfg.num_attention_heads

    h = _ln(query_embeds, bert["embeddings"]["LayerNorm"], eps)
    enc_bias = None
    if encoder_hidden_states is not None:
        if encoder_attention_mask is None:
            encoder_attention_mask = jnp.ones(
                encoder_hidden_states.shape[:2], jnp.float32
            )
        enc_bias = (
            (1.0 - encoder_attention_mask.astype(jnp.float32)) * NEG_INF
        )[:, None, None, :]

    ks, vs = [], []
    for i in range(cfg.num_hidden_layers):
        lp = bert["encoder"][f"layer_{i}"]
        h, (k, v) = _attention_block(
            h, lp["attention"], heads, eps, return_kv=True
        )
        ks.append(k)
        vs.append(v)
        if "crossattention" in lp and encoder_hidden_states is not None:
            h = _attention_block(
                h, lp["crossattention"], heads, eps,
                kv_states=encoder_hidden_states.astype(h.dtype),
                bias=enc_bias,
            )
        h = _ffn(h, lp["ffn_query"], eps)
    return jnp.stack(ks), jnp.stack(vs)  # [L, B, H, K, hd]


def _lm_logits(h, cls, eps):
    t = _gelu(_dense(h, cls["transform_dense"]))
    t = _ln(t, cls["transform_LayerNorm"], eps)
    return _dense(t, cls["decoder"])


def kv_cached_greedy_generate(
    params,
    cfg: QFormerConfig,
    query_embeds: jax.Array,             # [B, K, D]
    encoder_hidden_states: Optional[jax.Array] = None,
    encoder_attention_mask: Optional[jax.Array] = None,
    *,
    bos_token_id: int,
    eos_token_id: int,
    pad_token_id: int = 0,
    max_new_tokens: int = 32,
) -> jax.Array:
    """O(T) greedy decoding; token-for-token equal to ``greedy_generate``.

    Matches the reference's past_key_values generation capability
    (reference: models/qformer.py:1015-1035).
    """
    bert = params["params"]["bert"]
    cls = params["params"]["cls"]
    eps = cfg.layer_norm_eps
    heads = cfg.num_attention_heads
    b, n_q, d = query_embeds.shape
    total = n_q + max_new_tokens

    pk, pv = _prefill(
        params, cfg, query_embeds, encoder_hidden_states,
        encoder_attention_mask,
    )  # [L, B, H, K, hd]
    hd = pk.shape[-1]
    zeros = jnp.zeros(
        (cfg.num_hidden_layers, b, heads, max_new_tokens, hd), pk.dtype
    )
    k_cache = jnp.concatenate([pk, zeros], axis=3)  # [L, B, H, K+T, hd]
    v_cache = jnp.concatenate([pv, zeros], axis=3)

    word = bert["embeddings"]["word_embeddings"]["embedding"]
    pos = bert["embeddings"]["position_embeddings"]["embedding"]
    key_pos = jnp.arange(total)  # cache column -> validity vs current step

    ids = jnp.full((b, max_new_tokens), pad_token_id, jnp.int32)
    ids = ids.at[:, 0].set(bos_token_id)
    finished = jnp.zeros((b,), bool)

    def step(carry, t):
        ids, finished, k_cache, v_cache = carry
        tok = jnp.take_along_axis(ids, t[None].repeat(b)[:, None], axis=1)
        h = _ln(
            word[tok[:, 0]][:, None, :] + pos[t][None, None, :],
            bert["embeddings"]["LayerNorm"],
            eps,
        )  # [B, 1, D]

        # prefix always visible; text column j visible iff j - n_q <= t
        visible = key_pos[None, None, None, :] <= (n_q + t)
        bias = jnp.where(visible, 0.0, NEG_INF).astype(jnp.float32)

        h, k_cache, v_cache = _decode_step(
            bert, cfg, h, k_cache, v_cache, bias, t, n_q
        )

        logits = _lm_logits(h, cls, eps)[:, 0]  # [B, V]
        next_tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        next_tok = jnp.where(finished, pad_token_id, next_tok)
        write = jnp.minimum(t + 1, max_new_tokens - 1)
        ids = jax.lax.dynamic_update_slice(
            ids,
            jnp.where(
                t + 1 < max_new_tokens,
                next_tok[:, None],
                jax.lax.dynamic_slice(ids, (0, write), (b, 1)),
            ),
            (0, write),
        )
        finished = finished | (next_tok == eos_token_id)
        return (ids, finished, k_cache, v_cache), None

    (ids, _, _, _), _ = jax.lax.scan(
        step, (ids, finished, k_cache, v_cache),
        jnp.arange(max_new_tokens - 1),
    )
    return ids


def _decode_step(bert, cfg, h, k_cache, v_cache, bias, t, n_q):
    """One cached decoder step for a [N, 1, D] token batch; returns
    (hidden, new_k_cache, new_v_cache)."""
    eps = cfg.layer_norm_eps
    heads = cfg.num_attention_heads
    new_k, new_v = [], []
    for i in range(cfg.num_hidden_layers):
        lp = bert["encoder"][f"layer_{i}"]
        att = lp["attention"]
        q = split_heads(_dense(h, att["query"]), heads)
        k = split_heads(_dense(h, att["key"]), heads)
        v = split_heads(_dense(h, att["value"]), heads)
        kc = jax.lax.dynamic_update_slice(k_cache[i], k, (0, 0, n_q + t, 0))
        vc = jax.lax.dynamic_update_slice(v_cache[i], v, (0, 0, n_q + t, 0))
        new_k.append(kc)
        new_v.append(vc)
        ctx = merge_heads(_attend(q, kc, vc, bias))
        h = _ln(
            _dense(ctx, att["output_dense"]) + h,
            att["output_LayerNorm"], eps,
        )
        h = _ffn(h, lp["ffn"], eps)
    return h, jnp.stack(new_k), jnp.stack(new_v)


def kv_cached_beam_generate(
    params,
    cfg: QFormerConfig,
    query_embeds: jax.Array,             # [B, K, D]
    encoder_hidden_states: Optional[jax.Array] = None,
    encoder_attention_mask: Optional[jax.Array] = None,
    *,
    bos_token_id: int,
    eos_token_id: int,
    pad_token_id: int = 0,
    max_new_tokens: int = 32,
    num_beams: int = 4,
    length_penalty: float = 1.0,
):
    """KV-cached beam search (the reference rides HF ``generate`` with beam
    cache reordering, models/qformer.py:1104-1135; this is the functional
    JAX equivalent — fixed shapes, one ``lax.scan``, cache reorder as a
    batched gather).

    Returns ``(ids [B, T], score [B])`` — the best beam per batch row under
    HF's length-penalized score ``logprob / len(generated)**length_penalty``.
    ``num_beams=1`` reduces exactly to greedy decoding.
    """
    bert = params["params"]["bert"]
    cls = params["params"]["cls"]
    eps = cfg.layer_norm_eps
    b, n_q, d = query_embeds.shape
    n = num_beams
    total = n_q + max_new_tokens

    pk, pv = _prefill(
        params, cfg, query_embeds, encoder_hidden_states,
        encoder_attention_mask,
    )  # [L, B, H, K, hd]
    # expand to beams: row b -> rows [b*n, b*n + n)
    pk = jnp.repeat(pk, n, axis=1)
    pv = jnp.repeat(pv, n, axis=1)
    hd = pk.shape[-1]
    zeros = jnp.zeros(
        (cfg.num_hidden_layers, b * n, cfg.num_attention_heads,
         max_new_tokens, hd), pk.dtype
    )
    k_cache = jnp.concatenate([pk, zeros], axis=3)
    v_cache = jnp.concatenate([pv, zeros], axis=3)

    word = bert["embeddings"]["word_embeddings"]["embedding"]
    pos = bert["embeddings"]["position_embeddings"]["embedding"]
    key_pos = jnp.arange(total)

    neg_inf = jnp.asarray(NEG_INF, jnp.float32)
    ids = jnp.full((b, n, max_new_tokens), pad_token_id, jnp.int32)
    ids = ids.at[:, :, 0].set(bos_token_id)
    # only beam 0 is live at t=0 (all beams hold identical BOS prefixes)
    scores = jnp.tile(
        jnp.concatenate([jnp.zeros((1,)), jnp.full((n - 1,), neg_inf)])[None],
        (b, 1),
    )
    finished = jnp.zeros((b, n), bool)
    lengths = jnp.full((b, n), max_new_tokens, jnp.int32)

    vocab = word.shape[0]
    batch_offsets = (jnp.arange(b) * n)[:, None]  # [B, 1]

    def step(carry, t):
        ids, scores, finished, lengths, k_cache, v_cache = carry
        tok = jax.lax.dynamic_slice(
            ids.reshape(b * n, max_new_tokens), (0, t), (b * n, 1)
        )  # [B*n, 1]
        h = _ln(
            word[tok[:, 0]][:, None, :] + pos[t][None, None, :],
            bert["embeddings"]["LayerNorm"],
            eps,
        )
        visible = key_pos[None, None, None, :] <= (n_q + t)
        bias = jnp.where(visible, 0.0, NEG_INF).astype(jnp.float32)
        h, k_cache, v_cache = _decode_step(
            bert, cfg, h, k_cache, v_cache, bias, t, n_q
        )
        logits = _lm_logits(h, cls, eps)[:, 0].reshape(b, n, vocab)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        # finished beams: freeze score, emit pad only
        pad_onehot = jnp.where(
            jnp.arange(vocab)[None, None, :] == pad_token_id, 0.0, neg_inf
        )
        logp = jnp.where(finished[..., None], pad_onehot, logp)

        cand = (scores[..., None] + logp).reshape(b, n * vocab)
        top_scores, top_idx = jax.lax.top_k(cand, n)  # [B, n]
        parent = top_idx // vocab  # [B, n]
        token = (top_idx % vocab).astype(jnp.int32)

        # reorder beam state by parent
        ids = jnp.take_along_axis(ids, parent[..., None], axis=1)
        finished = jnp.take_along_axis(finished, parent, axis=1)
        lengths = jnp.take_along_axis(lengths, parent, axis=1)
        flat_parent = (batch_offsets + parent).reshape(-1)  # [B*n]
        k_cache = jnp.take(k_cache, flat_parent, axis=1)
        v_cache = jnp.take(v_cache, flat_parent, axis=1)

        token = jnp.where(finished, pad_token_id, token)
        write = jnp.minimum(t + 1, max_new_tokens - 1)
        prev = jax.lax.dynamic_slice_in_dim(ids, write, 1, axis=2)[..., 0]
        ids = jax.lax.dynamic_update_slice_in_dim(
            ids,
            jnp.where(t + 1 < max_new_tokens, token, prev)[..., None],
            write,
            axis=2,
        )
        just_finished = (~finished) & (token == eos_token_id)
        # generated length incl. BOS + EOS when finishing at t+1
        lengths = jnp.where(just_finished, t + 2, lengths)
        finished = finished | just_finished
        scores = top_scores
        return (ids, scores, finished, lengths, k_cache, v_cache), None

    (ids, scores, finished, lengths, _, _), _ = jax.lax.scan(
        step, (ids, scores, finished, lengths, k_cache, v_cache),
        jnp.arange(max_new_tokens - 1),
    )
    final = scores / (lengths.astype(jnp.float32) ** length_penalty)
    best = jnp.argmax(final, axis=1)  # [B]
    best_ids = jnp.take_along_axis(
        ids, best[:, None, None], axis=1
    )[:, 0]  # [B, T]
    best_score = jnp.take_along_axis(final, best[:, None], axis=1)[:, 0]
    return best_ids, best_score
