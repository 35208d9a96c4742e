"""Unit tests for the Flax Q-Former core: shapes, masking semantics, LM heads."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unirec.configs import ItemQFormerConfig, QFormerConfig, UserQFormerConfig
from unirec.models.item_qformer import ItemQFormer
from unirec.models.qformer import (
    QFormerLMHeadModel,
    QFormerModel,
    causal_lm_loss,
)
from unirec.models.user_qformer import UserQFormer

TINY = QFormerConfig(
    hidden_size=64,
    num_hidden_layers=4,
    num_attention_heads=4,
    intermediate_size=128,
    encoder_width=48,
    query_length=8,
    vocab_size=100,
    max_position_embeddings=32,
    hidden_dropout_prob=0.1,
    attention_probs_dropout_prob=0.1,
)

# Text-only variant: like the reference, cross-attention layers require an
# encoder memory (models/qformer.py:433-435), so text-only tests disable it.
TINY_NOCROSS = QFormerConfig(**{**TINY.__dict__, "add_cross_attention": False})


def test_query_only_forward_shape():
    model = QFormerModel(TINY)
    rng = jax.random.PRNGKey(0)
    q = jax.random.normal(rng, (2, 8, 64))
    mem = jax.random.normal(rng, (2, 5, 48))
    params = model.init(rng, query_embeds=q, encoder_hidden_states=mem)
    out = model.apply(params, query_embeds=q, encoder_hidden_states=mem)
    assert out.shape == (2, 8, 64)
    assert np.isfinite(np.asarray(out)).all()


def test_query_plus_text_forward_shape():
    model = QFormerModel(TINY)
    rng = jax.random.PRNGKey(0)
    q = jax.random.normal(rng, (2, 8, 64))
    ids = jnp.ones((2, 6), jnp.int32)
    mask = jnp.ones((2, 14))
    mem = jax.random.normal(rng, (2, 5, 48))
    params = model.init(
        rng, input_ids=ids, attention_mask=mask, query_embeds=q,
        encoder_hidden_states=mem,
    )
    out = model.apply(
        params, input_ids=ids, attention_mask=mask, query_embeds=q,
        encoder_hidden_states=mem,
    )
    assert out.shape == (2, 14, 64)


def test_encoder_mask_blocks_fields():
    """A masked field must not influence query outputs."""
    model = QFormerModel(TINY)
    rng = jax.random.PRNGKey(1)
    q = jax.random.normal(rng, (1, 8, 64))
    mem = jax.random.normal(rng, (1, 5, 48))
    mask = jnp.array([[1.0, 1.0, 0.0, 1.0, 1.0]])
    params = model.init(rng, query_embeds=q, encoder_hidden_states=mem)
    out1 = model.apply(
        params, query_embeds=q, encoder_hidden_states=mem,
        encoder_attention_mask=mask,
    )
    mem2 = mem.at[0, 2].set(jnp.full((48,), 1e3))
    out2 = model.apply(
        params, query_embeds=q, encoder_hidden_states=mem2,
        encoder_attention_mask=mask,
    )
    np.testing.assert_allclose(np.asarray(out1), np.asarray(out2), atol=1e-5)


def test_self_attention_padding_mask():
    """Padded text tokens must not influence query outputs."""
    model = QFormerModel(TINY_NOCROSS)
    rng = jax.random.PRNGKey(2)
    q = jax.random.normal(rng, (1, 8, 64))
    ids1 = jnp.array([[5, 6, 7, 0]])
    ids2 = jnp.array([[5, 6, 7, 99]])
    mask = jnp.concatenate([jnp.ones((1, 8)), jnp.array([[1, 1, 1, 0.0]])], axis=1)
    params = model.init(rng, input_ids=ids1, attention_mask=mask, query_embeds=q)
    o1 = model.apply(params, input_ids=ids1, attention_mask=mask, query_embeds=q)
    o2 = model.apply(params, input_ids=ids2, attention_mask=mask, query_embeds=q)
    np.testing.assert_allclose(
        np.asarray(o1[:, :8]), np.asarray(o2[:, :8]), atol=1e-5
    )


def test_decoder_causal_mask():
    """In decoder mode a text position must not see future text tokens."""
    model = QFormerModel(TINY_NOCROSS)
    rng = jax.random.PRNGKey(3)
    q = jax.random.normal(rng, (1, 8, 64))
    ids1 = jnp.array([[5, 6, 7, 8]])
    ids2 = jnp.array([[5, 6, 7, 42]])  # change only last token
    params = model.init(rng, input_ids=ids1, query_embeds=q, is_decoder=True)
    o1 = model.apply(params, input_ids=ids1, query_embeds=q, is_decoder=True)
    o2 = model.apply(params, input_ids=ids2, query_embeds=q, is_decoder=True)
    # positions before the last text token unchanged
    np.testing.assert_allclose(
        np.asarray(o1[:, :-1]), np.asarray(o2[:, :-1]), atol=1e-5
    )
    # the last position does change
    assert np.abs(np.asarray(o1[:, -1]) - np.asarray(o2[:, -1])).max() > 1e-4


def test_dropout_rngs_change_output():
    model = QFormerModel(TINY)
    rng = jax.random.PRNGKey(4)
    q = jax.random.normal(rng, (2, 8, 64))
    mem = jax.random.normal(rng, (2, 5, 48))
    params = model.init(rng, query_embeds=q, encoder_hidden_states=mem)
    o1 = model.apply(
        params, query_embeds=q, encoder_hidden_states=mem,
        deterministic=False, rngs={"dropout": jax.random.PRNGKey(10)},
    )
    o2 = model.apply(
        params, query_embeds=q, encoder_hidden_states=mem,
        deterministic=False, rngs={"dropout": jax.random.PRNGKey(11)},
    )
    assert np.abs(np.asarray(o1) - np.asarray(o2)).max() > 1e-5


def test_lm_head_model_loss():
    model = QFormerLMHeadModel(TINY_NOCROSS)
    rng = jax.random.PRNGKey(5)
    ids = jnp.array([[5, 6, 7, 8], [9, 10, 11, 0]])
    labels = jnp.array([[5, 6, 7, 8], [9, 10, 11, -100]])
    q = jax.random.normal(rng, (2, 8, 64))
    params = model.init(rng, input_ids=ids, query_embeds=q)
    logits, loss = model.apply(params, input_ids=ids, query_embeds=q, labels=labels)
    assert logits.shape == (2, 4, 100)
    assert np.isfinite(float(loss))


def test_causal_lm_loss_label_smoothing():
    logits = jnp.zeros((1, 3, 10))
    labels = jnp.array([[1, 2, 3]])
    loss = causal_lm_loss(logits, labels, label_smoothing=0.1)
    # uniform logits: loss == log(10) regardless of smoothing
    np.testing.assert_allclose(float(loss), np.log(10.0), rtol=1e-5)


def test_item_qformer_output_contract():
    cfg = ItemQFormerConfig(
        hidden_size=64,
        num_hidden_layers=2,
        num_attention_heads=4,
        intermediate_size=128,
        num_query_tokens=8,
        field_embedding_dim=32,
        num_fields=5,
        dropout=0.0,
    )
    model = ItemQFormer(cfg)
    rng = jax.random.PRNGKey(0)
    fields = jax.random.normal(rng, (3, 5, 32))
    mask = jnp.ones((3, 5))
    params = model.init(rng, fields, mask)
    out = model.apply(params, fields, mask)
    assert out["query_outputs"].shape == (3, 8, 64)
    assert out["item_representation"].shape == (3, 32)
    assert out["reconstructed_fields"].shape == (3, 5, 32)


def test_item_qformer_jit_and_grad():
    cfg = ItemQFormerConfig(
        hidden_size=32,
        num_hidden_layers=2,
        num_attention_heads=2,
        intermediate_size=64,
        num_query_tokens=4,
        field_embedding_dim=32,
        num_fields=5,
        dropout=0.0,
    )
    model = ItemQFormer(cfg)
    rng = jax.random.PRNGKey(0)
    fields = jax.random.normal(rng, (2, 5, 32))
    mask = jnp.ones((2, 5))
    params = model.init(rng, fields, mask)

    @jax.jit
    def loss_fn(p):
        out = model.apply(p, fields, mask)
        return jnp.mean((out["reconstructed_fields"] - fields) ** 2)

    g = jax.grad(loss_fn)(params)
    leaves = jax.tree_util.tree_leaves(g)
    assert all(np.isfinite(np.asarray(l)).all() for l in leaves)
    assert any(np.abs(np.asarray(l)).max() > 0 for l in leaves)


def test_user_qformer_shapes():
    cfg = UserQFormerConfig(
        hidden_size=64,
        num_hidden_layers=2,
        num_attention_heads=4,
        intermediate_size=128,
        num_query_tokens=16,
        input_embedding_dim=64,
        num_item_tokens_to_predict=8,
        dropout=0.0,
    )
    model = UserQFormer(cfg)
    rng = jax.random.PRNGKey(0)
    seq = jax.random.normal(rng, (2, 40, 64))
    mask = jnp.ones((2, 40))
    params = model.init(rng, seq, mask)
    pred = model.apply(params, seq, mask)
    assert pred.shape == (2, 8, 64)
    pred2, user_rep = model.apply(
        params, seq, mask, return_user_representation=True
    )
    assert user_rep.shape == (2, 64)
    np.testing.assert_allclose(np.asarray(pred), np.asarray(pred2))


def test_gradient_checkpointing_matches():
    cfg = TINY
    cfg_remat = QFormerConfig(
        **{**cfg.__dict__, "gradient_checkpointing": True}
    )
    rng = jax.random.PRNGKey(0)
    q = jax.random.normal(rng, (2, 8, 64))
    mem = jax.random.normal(rng, (2, 5, 48))
    m1, m2 = QFormerModel(cfg), QFormerModel(cfg_remat)
    params = m1.init(rng, query_embeds=q, encoder_hidden_states=mem)
    o1 = m1.apply(params, query_embeds=q, encoder_hidden_states=mem)
    o2 = m2.apply(params, query_embeds=q, encoder_hidden_states=mem)
    np.testing.assert_allclose(np.asarray(o1), np.asarray(o2), atol=1e-6)
