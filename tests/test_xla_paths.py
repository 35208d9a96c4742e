"""Properties of the XLA attention and inference paths, each against a
float32 (or float64 numpy) reference: masked fields and keys, empty items,
padding of odd batches, and data-parallel runs against one device."""

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
    tiny_qwen3_config,
)
from unirec.inference.qformer_inference import QFormerInference
from unirec.models.item_qformer import ItemQFormer
from unirec.ops.attention import attention, make_additive_mask

CFG = ItemQFormerConfig(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=64, num_query_tokens=4, field_embedding_dim=16,
    num_fields=5, dropout=0.0,
)


@pytest.fixture(scope="module")
def item_setup():
    rng = np.random.RandomState(0)
    n = 12
    emb = rng.randn(n, CFG.num_fields, CFG.field_embedding_dim)
    mask = (rng.rand(n, CFG.num_fields) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    emb = emb.astype(np.float32)
    params = ItemQFormer(CFG).init(
        jax.random.PRNGKey(0), jnp.asarray(emb[:2]), jnp.asarray(mask[:2]))
    return emb, mask, params


def _reference_tokens(params, emb, mask):
    with jax.default_matmul_precision("highest"):
        return np.asarray(ItemQFormer(CFG).apply(
            params, jnp.asarray(emb), jnp.asarray(mask))["query_outputs"])


def _inference(params, fast, batch_size=4):
    import dataclasses

    return QFormerInference(
        config=dataclasses.replace(CFG, fast_attention=fast), params=params,
        field_names=[f"f{i}" for i in range(CFG.num_fields)],
        batch_size=batch_size)


def _cos_min(a, b):
    a = a.reshape(-1, a.shape[-1]).astype(np.float64)
    b = b.reshape(-1, b.shape[-1]).astype(np.float64)
    return ((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                               * np.linalg.norm(b, axis=-1))).min()


@pytest.mark.parametrize("fast", [False, True])
def test_inference_close_to_float32_reference(item_setup, fast):
    emb, mask, params = item_setup
    got = _inference(params, fast).query_tokens_from_embeddings(emb, mask)
    assert _cos_min(got, _reference_tokens(params, emb, mask)) >= 0.999


@pytest.mark.parametrize("fast", [False, True])
def test_masked_field_invariance(item_setup, fast):
    """A masked-out field's values must not influence the tokens."""
    emb, mask, params = item_setup
    inf = _inference(params, fast)
    noisy = np.where(mask[..., None] > 0, emb,
                     np.random.RandomState(9).randn(*emb.shape) * 50.0
                     ).astype(np.float32)
    a = inf.query_tokens_from_embeddings(emb, mask)
    b = inf.query_tokens_from_embeddings(noisy, mask)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fast", [False, True])
def test_all_masked_item_is_finite_and_matches_reference(item_setup, fast):
    """An item with ZERO valid fields attends uniformly over its (masked)
    fields, as the reference's additive mask does, and stays finite."""
    emb, mask, params = item_setup
    mask0 = mask.copy()
    mask0[3] = 0.0
    got = _inference(params, fast).query_tokens_from_embeddings(emb, mask0)
    assert np.isfinite(got).all()
    ref = _reference_tokens(params, emb, mask0)
    assert _cos_min(got[3:4], ref[3:4]) >= 0.999


@pytest.mark.parametrize("n", [1, 5, 9])
def test_odd_batch_padding(item_setup, n):
    """Batches that do not fill the compiled shape are padded internally
    and trimmed; the tokens equal an unpadded forward."""
    emb, mask, params = item_setup
    got = _inference(params, False).query_tokens_from_embeddings(
        emb[:n], mask[:n])
    assert got.shape == (n, CFG.num_query_tokens, CFG.hidden_size)
    want = np.asarray(ItemQFormer(CFG, dtype=jnp.bfloat16).apply(
        params, jnp.asarray(emb[:n]), jnp.asarray(mask[:n])
    )["query_outputs"], np.float32)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def _attn_inputs(dtype, lq=4, lkv=9, b=2, h=2, hd=8):
    rng = np.random.RandomState(1)
    q, k, v = (jnp.asarray(rng.randn(b, h, n, hd), dtype)
               for n in (lq, lkv, lkv))
    mask = np.ones((b, lkv), np.float32)
    mask[0, 5:] = 0.0
    mask[1, :] = 0.0  # fully masked row
    return q, k, v, mask


def _numpy_attention(q, k, v, mask):
    q, k, v = (np.asarray(x, np.float64) for x in (q, k, v))
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    # the mask is added in float32, as the reference does: on a fully
    # masked row every logit rounds to -1e9 and the softmax is uniform
    s = (s.astype(np.float32) + ((1.0 - mask) * -1e9).astype(np.float32)
         [:, None, None, :]).astype(np.float64)
    s = s - s.max(-1, keepdims=True)
    p = np.exp(s)
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", p, v)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_fully_masked_row_finite_and_uniform(dtype):
    """All keys masked: the softmax over uniform -1e9 logits is uniform —
    the average of the values — and finite."""
    q, k, v, mask = _attn_inputs(dtype)
    out = np.asarray(attention(q, k, v, make_additive_mask(jnp.asarray(mask))),
                     np.float64)
    assert np.isfinite(out).all()
    tol = 5e-2 if dtype == jnp.bfloat16 else 1e-5
    np.testing.assert_allclose(out, _numpy_attention(q, k, v, mask),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(
        out[1], np.broadcast_to(np.asarray(v, np.float64)[1].mean(1,
                                keepdims=True), out[1].shape), atol=tol)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_masked_keys_get_zero_grad(dtype):
    """Keys and values at masked positions receive exactly zero gradient."""
    q, k, v, mask = _attn_inputs(dtype)
    bias = make_additive_mask(jnp.asarray(mask))
    g = jnp.asarray(np.random.RandomState(2).randn(*q.shape), jnp.float32)

    def loss(k, v):
        return jnp.sum(attention(q, k, v, bias).astype(jnp.float32) * g)

    dk, dv = jax.grad(loss, argnums=(0, 1))(k, v)
    dk, dv = np.asarray(dk, np.float32), np.asarray(dv, np.float32)
    assert (dk[0, :, 5:] == 0).all() and (dv[0, :, 5:] == 0).all()
    assert np.abs(dk[0, :, :5]).max() > 0 and np.abs(dv[0, :, :5]).max() > 0


def test_long_memory_cross_attention_matches_numpy():
    """The user stage's long memory (seq * K keys) runs the same XLA path;
    with a few thousand keys it still equals the float64 reference."""
    q, k, v, mask = _attn_inputs(jnp.float32, lq=8, lkv=3000, b=2, h=2, hd=16)
    mask[1, :1000] = 1.0
    with jax.default_matmul_precision("highest"):
        out = np.asarray(attention(q, k, v,
                                   make_additive_mask(jnp.asarray(mask))))
    np.testing.assert_allclose(out, _numpy_attention(q, k, v, mask),
                               atol=1e-5, rtol=1e-4)


def test_causal_attention_future_and_pad_keys_get_zero_grad():
    """Decoder self-attention: a query's output has zero gradient wrt later
    positions and wrt padded keys; GQA kv heads collect every q head."""
    from unirec.models.qwen3 import Qwen3Model

    cfg = tiny_qwen3_config(num_hidden_layers=1)
    model = Qwen3Model(cfg)
    ids = jnp.asarray(np.random.RandomState(0).randint(1, 500, (2, 10)))
    mask = jnp.asarray(np.r_[np.ones(10), np.r_[np.ones(7), np.zeros(3)]]
                       .reshape(2, 10), jnp.float32)
    params = model.init(jax.random.PRNGKey(0), ids, mask)
    emb = model.apply(params, ids, method_embed_only=True)

    def out_at(e, row, pos):
        h = model.apply(params, inputs_embeds=e, attention_mask=mask)
        return jnp.sum(h[row, pos])

    g = np.asarray(jax.grad(out_at)(emb, 0, 4))
    assert np.abs(g[0, 5:]).max() == 0 and np.abs(g[0, :5]).max() > 0
    g = np.asarray(jax.grad(out_at)(emb, 1, 9))
    assert np.abs(g[1, 7:9]).max() == 0  # padded keys, not the query itself
    assert np.abs(g[1, :7]).max() > 0


@pytest.mark.parametrize("dp", [2, 4])
def test_user_trainer_dp_matches_single_device(eight_devices, dp):
    """One dp-sharded user-stage step equals the single-device step (prob
    dropout off, hidden dropout 0)."""
    from unirec.train.user_qformer import UserQFormerTrainer

    def make(dp):
        return UserQFormerTrainer(
            UserQFormerConfig(
                hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=64, num_query_tokens=4,
                input_embedding_dim=32, num_item_tokens_to_predict=2,
                dropout=0.0),
            TrainConfig(batch_size=8,
                        optimizer=OptimizerConfig(learning_rate=1e-3),
                        mesh=MeshConfig(dp=dp, tp=1)),
            max_seq_len=6,
        )

    r = np.random.RandomState(0)
    batch = {
        "item_tokens": jnp.asarray(r.randn(8, 6, 2, 32), jnp.float32),
        "timestamps": jnp.asarray(r.rand(8, 6), jnp.float32),
        "coordinates": jnp.asarray(r.randn(8, 6, 2), jnp.float32),
        "seq_mask": jnp.asarray((r.rand(8, 6) > 0.3), jnp.float32),
        "target_tokens": jnp.asarray(r.randn(8, 2, 32), jnp.float32),
    }
    t1, tdp = make(1), make(dp)
    _, m1 = t1._train_step(t1.init_state(seed=0), batch)
    _, mdp = tdp._train_step(tdp.init_state(seed=0), batch)
    np.testing.assert_allclose(float(mdp["loss"]), float(m1["loss"]),
                               rtol=2e-5)


def test_item_step_under_dp_shard_map_matches_single_device(eight_devices):
    """The item step with ``axis_name`` under parallel/mesh.dp_shard_map_jit
    (explicit dp split, pmean-count loss normalization) equals the jit
    step on one device."""
    from unirec.parallel.mesh import data_parallel_jit, dp_shard_map_jit, \
        make_mesh, replicate
    from unirec.train.common import TrainState, make_optimizer
    from unirec.train.item_qformer import make_train_step

    model = ItemQFormer(CFG)
    rng = np.random.RandomState(3)

    def arr(*s):
        return jnp.asarray(rng.randn(*s), jnp.float32)

    masks = jnp.asarray(rng.rand(8, CFG.num_fields) > 0.4, jnp.float32)
    batch = {
        "anchor_emb": arr(8, CFG.num_fields, CFG.field_embedding_dim),
        "anchor_mask": masks, "pos_mask": masks, "neg_mask": masks,
        "pos_emb": arr(8, CFG.num_fields, CFG.field_embedding_dim),
        "neg_emb": arr(8, CFG.num_fields, CFG.field_embedding_dim),
    }
    params = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), batch["anchor_emb"][:2], masks[:2])["params"])

    def state():
        return TrainState.create(apply_fn=model.apply, params=params,
                                 tx=make_optimizer(OptimizerConfig()))

    mesh1 = make_mesh(MeshConfig(dp=1, tp=1))
    mesh4 = make_mesh(MeshConfig(dp=4, tp=1))
    _, m1 = data_parallel_jit(make_train_step(model), mesh1)(
        replicate(mesh1, state()), batch)
    _, m4 = dp_shard_map_jit(make_train_step(model, axis_name="dp"), mesh4)(
        replicate(mesh4, state()), batch)
    for key in ("loss", "recon", "contrastive"):
        np.testing.assert_allclose(float(m4[key]), float(m1[key]),
                                   rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("lkv", [14, 64])
def test_fast_attention_close_to_fp32(lkv):
    """The opt-in bf16 softmax (inference only) stays within bf16 noise of
    the fp32 path."""
    rng = np.random.RandomState(4)
    q, k, v = (jnp.asarray(rng.randn(2, 4, n, 16), jnp.bfloat16)
               for n in (32, lkv, lkv))
    mask = np.ones((2, lkv), np.float32)
    mask[0, lkv // 2:] = 0.0
    bias = make_additive_mask(jnp.asarray(mask))
    fast = np.asarray(attention(q, k, v, bias, fast=True), np.float32)
    exact = _numpy_attention(q, k, v, mask)
    np.testing.assert_allclose(fast, exact, atol=5e-2, rtol=5e-2)
