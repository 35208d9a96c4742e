"""User stage: sequence assembly semantics + user Q-Former training."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unirec.configs import (
    ItemQFormerConfig,
    MeshConfig,
    OptimizerConfig,
    TrainConfig,
    UserQFormerConfig,
)
from unirec.data.cache import FieldEmbeddingCache
from unirec.models.item_qformer import ItemQFormer
from unirec.models.mwne import sinusoidal_position_encoding
from unirec.models.user_sequence import (
    UserSequenceModel,
    assemble_user_sequence,
)
from unirec.train.user_qformer import (
    UserQFormerTrainer,
    build_sliding_window_samples,
    build_timestamp_map,
    precompute_item_tokens,
    train_user_qformer,
)

D = 32


def test_assemble_shapes_and_context_broadcast():
    b, s, k = 2, 3, 4
    tokens = jnp.zeros((b, s, k, D))
    context = jnp.asarray(np.random.RandomState(0).randn(b, s, D), jnp.float32)
    flat, mask = assemble_user_sequence(tokens, context, add_positional=False)
    assert flat.shape == (b, s * k, D)
    # context broadcast: every one of the K tokens of event (b,s) equals context
    np.testing.assert_allclose(
        np.asarray(flat[0, 0]), np.asarray(context[0, 0]), atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(flat[0, k - 1]), np.asarray(context[0, 0]), atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(flat[0, k]), np.asarray(context[0, 1]), atol=1e-6
    )


def test_assemble_positional_encoding_added():
    b, s, k = 1, 2, 2
    tokens = jnp.zeros((b, s, k, D))
    context = jnp.zeros((b, s, D))
    flat, _ = assemble_user_sequence(tokens, context, add_positional=True)
    pe = sinusoidal_position_encoding(s * k, D)
    np.testing.assert_allclose(np.asarray(flat[0]), np.asarray(pe), atol=1e-6)


def test_assemble_seq_mask_repeat():
    tokens = jnp.zeros((1, 3, 2, D))
    context = jnp.zeros((1, 3, D))
    seq_mask = jnp.asarray([[1.0, 1.0, 0.0]])
    _, mask = assemble_user_sequence(tokens, context, seq_mask)
    np.testing.assert_array_equal(np.asarray(mask[0]), [1, 1, 1, 1, 0, 0])


def test_sliding_window_samples():
    hist = [{"history": ["a", "b", "c", "d"]}, {"history": ["x", "y"]}]
    samples = build_sliding_window_samples(hist, min_seq_len=3)
    # for abcd: (a->b), (ab->c); last item never a target (reference loop
    # stops at len-1)
    assert samples == [(["a"], "b"), (["a", "b"], "c")]
    assert build_timestamp_map({"a": [{"unixReviewTime": 5}], "b": []}) == {"a": 5}


@pytest.fixture(scope="module")
def user_setup():
    rng = np.random.RandomState(0)
    n = 24
    cache = FieldEmbeddingCache(
        embeddings=rng.randn(n, 4, D).astype(np.float32),
        masks=np.ones((n, 4), np.float32),
        fields=["a", "b", "c", "d"],
        item_ids=[f"i{j}" for j in range(n)],
    )
    iq_cfg = ItemQFormerConfig(
        hidden_size=D, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, num_query_tokens=4, field_embedding_dim=D,
        num_fields=4, dropout=0.0,
    )
    iq = ItemQFormer(iq_cfg)
    iq_params = iq.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, D)), jnp.ones((1, 4))
    )
    histories = [
        {"history": [f"i{(u + j) % n}" for j in range(6)]} for u in range(8)
    ]
    reviews = {f"i{j}": [{"unixReviewTime": 1000 + j}] for j in range(n)}
    return cache, iq, iq_params, histories, reviews


def test_precompute_item_tokens(user_setup):
    cache, iq, iq_params, _, _ = user_setup
    toks = precompute_item_tokens(iq, iq_params, cache, batch_size=10)
    assert toks.shape == (24, 4, D)
    # matches direct forward
    direct = iq.apply(
        iq_params, jnp.asarray(cache.embeddings[:3]), jnp.asarray(cache.masks[:3])
    )["query_outputs"]
    np.testing.assert_allclose(toks[:3], np.asarray(direct), atol=1e-5)


def test_user_training_decreases_loss(user_setup, eight_devices):
    cache, iq, iq_params, histories, reviews = user_setup
    uc = UserQFormerConfig(
        hidden_size=D, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, num_query_tokens=8, input_embedding_dim=D,
        num_item_tokens_to_predict=4, dropout=0.0,
    )
    tc = TrainConfig(
        batch_size=16, num_epochs=1,
        optimizer=OptimizerConfig(learning_rate=3e-3), mesh=MeshConfig(dp=8),
    )
    trainer = UserQFormerTrainer(uc, tc, max_seq_len=8)
    from unirec.train.user_qformer import (
        build_sliding_window_samples as bs,
        build_timestamp_map as bt,
    )

    samples = bs(histories, max_seq_len=8)
    ts_map = bt(reviews)
    toks = precompute_item_tokens(iq, iq_params, cache)
    state = trainer.init_state()
    rng = np.random.default_rng(0)
    state, m0 = trainer.train_epoch(state, samples, toks, cache, ts_map, rng)
    for _ in range(8):
        state, m1 = trainer.train_epoch(state, samples, toks, cache, ts_map, rng)
    assert m1["loss"] < m0["loss"]


def test_full_user_driver(user_setup, tmp_path):
    cache, iq, iq_params, histories, reviews = user_setup
    uc = UserQFormerConfig(
        hidden_size=D, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=64, num_query_tokens=4, input_embedding_dim=D,
        num_item_tokens_to_predict=4, dropout=0.0,
    )
    tc = TrainConfig(
        batch_size=16, num_epochs=2,
        optimizer=OptimizerConfig(learning_rate=1e-3), mesh=MeshConfig(),
    )
    state, metrics = train_user_qformer(
        cache, histories, reviews, iq, iq_params,
        user_config=uc, train_config=tc, max_seq_len=8,
        checkpoint_dir=str(tmp_path / "uq"),
        log_fn=lambda *a: None,
    )
    assert np.isfinite(metrics["loss"])
    from unirec.utils.checkpoint import load_checkpoint, restore_config

    tree, meta = load_checkpoint(str(tmp_path / "uq"))
    cfg = restore_config(meta, UserQFormerConfig)
    assert cfg.num_item_tokens_to_predict == 4
    assert "loss" in meta


def test_user_eval_metrics(user_setup, eight_devices):
    from unirec.eval.user_eval import (
        evaluate_user_qformer,
        retrieval_metrics,
        token_metrics,
    )
    from unirec.train.user_qformer import (
        build_sliding_window_samples,
        build_timestamp_map,
    )

    cache, iq, iq_params, histories, reviews = user_setup
    toks = precompute_item_tokens(iq, iq_params, cache)

    # perfect predictions -> cosine 1, retrieval hit@1 == 1
    rows = np.array([0, 3, 7])
    perfect = toks[rows]
    tm = token_metrics(jnp.asarray(perfect), jnp.asarray(perfect))
    assert tm["token_cosine"] > 0.999 and tm["token_mse"] < 1e-10
    rm = retrieval_metrics(perfect, rows, toks)
    assert rm["retrieval_hit@1"] == 1.0 and rm["retrieval_mrr"] == 1.0

    # full evaluation through a trainer
    uc = UserQFormerConfig(
        hidden_size=D, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=64, num_query_tokens=4, input_embedding_dim=D,
        num_item_tokens_to_predict=4, dropout=0.0,
    )
    tc = TrainConfig(batch_size=16,
                     optimizer=OptimizerConfig(learning_rate=1e-3),
                     mesh=MeshConfig(dp=8))
    trainer = UserQFormerTrainer(uc, tc, max_seq_len=8)
    state = trainer.init_state()
    samples = build_sliding_window_samples(histories, max_seq_len=8)
    ts_map = build_timestamp_map(reviews)
    m = evaluate_user_qformer(trainer, state, samples, toks, cache, ts_map)
    assert set(m) >= {"token_mse", "token_cosine", "retrieval_mrr",
                      "retrieval_hit@1"}
    assert np.isfinite(m["token_mse"]) and 0 <= m["retrieval_mrr"] <= 1


def test_user_trainer_bf16_mode():
    """--bf16 plumbing: bf16 activations, fp32 params, finite decreasing loss."""
    import numpy as np

    from unirec.configs import (
        MeshConfig,
        OptimizerConfig,
        TrainConfig,
        UserQFormerConfig,
    )
    from unirec.train.user_qformer import UserQFormerTrainer

    uc = UserQFormerConfig(
        hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=64, num_query_tokens=4, input_embedding_dim=32,
        num_item_tokens_to_predict=2, dropout=0.0,
    )
    tr = UserQFormerTrainer(
        uc,
        TrainConfig(batch_size=4, optimizer=OptimizerConfig(learning_rate=1e-3),
                    mesh=MeshConfig(dp=1, tp=1)),
        max_seq_len=4, dtype="bfloat16",
    )
    state = tr.init_state()
    assert all(
        x.dtype == jnp.float32
        for x in jax.tree_util.tree_leaves(state.params)
    )  # master params stay fp32
    rng = np.random.RandomState(0)
    batch = {
        "item_tokens": jnp.asarray(rng.randn(4, 4, 2, 32).astype(np.float32)),
        "timestamps": jnp.asarray(rng.rand(4, 4).astype(np.float32)),
        "coordinates": jnp.zeros((4, 4, 2), jnp.float32),
        "seq_mask": jnp.ones((4, 4), jnp.float32),
        "target_tokens": jnp.asarray(rng.randn(4, 2, 32).astype(np.float32)),
    }
    losses = []
    for _ in range(8):
        state, m = tr._train_step(state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
