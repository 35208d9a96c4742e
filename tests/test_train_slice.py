"""End-to-end slice: cache -> item Q-Former training on the 8-device mesh ->
reconstruction eval -> batch query-token generation -> checkpoint resume.

This is the hermetic integration test SURVEY.md §4c calls for (the JAX analog
of BASELINE.json configs 1-2).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unirec.configs import ItemQFormerConfig, MeshConfig, OptimizerConfig, TrainConfig
from unirec.data.cache import FieldEmbeddingCache, analyze_fields, build_cache
from unirec.eval.reconstruction import evaluate_reconstruction_quality
from unirec.inference.qformer_inference import QFormerInference, is_null_value
from unirec.models.item_qformer import ItemQFormer
from unirec.train.item_qformer import (
    ItemQFormerTrainer,
    build_triplet_pairs,
    sample_negatives,
    train_item_qformer,
)

NUM_ITEMS, F, D = 64, 5, 32

TINY_CFG = ItemQFormerConfig(
    hidden_size=32,
    num_hidden_layers=2,
    num_attention_heads=2,
    intermediate_size=64,
    num_query_tokens=4,
    field_embedding_dim=D,
    num_fields=F,
    dropout=0.0,
)


class FakeEncoder:
    """Deterministic hash-based field encoder for tests (no model weights)."""

    embedding_dim = D

    def encode_batch_by_field(self, samples, fields):
        out = {}
        for f in fields:
            rows = []
            for s in samples:
                v = s.get(f)
                if v is None:
                    rows.append(np.zeros(D, np.float32))
                else:
                    seed = abs(hash((f, str(v)))) % (2**32)
                    rows.append(
                        np.random.RandomState(seed).randn(D).astype(np.float32)
                    )
            out[f] = np.stack(rows)
        return out


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    rng = np.random.RandomState(0)
    samples = []
    for i in range(NUM_ITEMS):
        s = {"item_id": f"it{i}", "title": f"t{i}", "price": float(i)}
        if i % 3 == 0:
            s["brand"] = f"b{i % 7}"
        if i % 4 == 0:
            s["color"] = "red"
        s["store"] = f"s{i % 5}"
        samples.append(s)
    cdir = str(tmp_path_factory.mktemp("cache"))
    c = build_cache(samples, FakeEncoder(), cache_dir=cdir, batch_size=16)
    assert c.embeddings.shape == (NUM_ITEMS, F, D)
    return c


def test_cache_roundtrip_and_validation(cache, tmp_path):
    d = str(tmp_path / "c2")
    cache.save(d)
    c2 = FieldEmbeddingCache.load(d, expected_fields=cache.fields)
    np.testing.assert_array_equal(np.asarray(c2.embeddings), cache.embeddings)
    with pytest.raises(ValueError):
        FieldEmbeddingCache.load(d, expected_fields=["wrong"])
    # unknown ids degrade to zeros
    emb, mask = c2.gather(["it0", "missing"])
    assert mask[1].sum() == 0 and np.abs(emb[1]).sum() == 0


def test_mask_matches_null_semantics(cache):
    # price=0.0 for item 0 is a valid number -> depends on embedding nonzero
    assert cache.masks.shape == (NUM_ITEMS, F)
    # fields absent in sample -> zero embedding -> mask 0
    row = cache.id_to_row["it1"]  # no brand, no color
    fi_brand = cache.fields.index("brand")
    assert cache.masks[row, fi_brand] == 0


def test_triplet_pair_building(cache):
    seqs = [["it0", "it1", "it2"], ["it3", "missing", "it4"], ["it5"]]
    pairs = build_triplet_pairs(seqs, cache.id_to_row)
    assert len(pairs) == 2  # (0,1), (1,2); missing breaks the chain pairs
    rng = np.random.default_rng(0)
    neg = sample_negatives(rng, pairs, NUM_ITEMS)
    assert ((neg != pairs[:, 0]) & (neg != pairs[:, 1])).all()


def test_training_decreases_loss_on_mesh(cache, eight_devices):
    tc = TrainConfig(
        batch_size=32,
        num_epochs=1,
        # lr 3e-3 x 20 epochs only moved recon ~6% — right at fp-noise scale,
        # which made this test flaky (order-/load-dependent).  1e-2 x 40
        # epochs reaches ratio ~0.64: signal far above noise.
        optimizer=OptimizerConfig(learning_rate=1e-2),
        mesh=MeshConfig(dp=8, tp=1),
    )
    trainer = ItemQFormerTrainer(TINY_CFG, tc)
    state = trainer.init_state()
    seqs = [[f"it{i}", f"it{i+1}", f"it{i+2}"] for i in range(0, 60, 3)]
    pairs = build_triplet_pairs(seqs, cache.id_to_row)
    rng = np.random.default_rng(0)
    state, m0 = trainer.train_epoch(state, cache, pairs, rng)
    best = float("inf")
    for _ in range(40):
        state, m1 = trainer.train_epoch(state, cache, pairs, rng)
        best = min(best, m1["recon"])
    # reconstruction (the dominant term) must clearly improve; compare the
    # BEST epoch, not the last — the last can spike on an unlucky shuffle
    assert best < m0["recon"] * 0.8, (best, m0["recon"])
    val = trainer.evaluate(state, cache)
    assert np.isfinite(val["val_recon_loss"])
    assert -1.0 <= val["avg_cosine_similarity"] <= 1.0


def test_full_driver_and_checkpoint(cache, tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    tc = TrainConfig(
        batch_size=32,
        num_epochs=2,
        eval_every_epochs=2,
        optimizer=OptimizerConfig(learning_rate=1e-3),
        mesh=MeshConfig(),  # all 8 virtual devices
    )
    seqs = [[f"it{i}", f"it{i+1}"] for i in range(0, 40, 2)]
    state, metrics = train_item_qformer(
        cache,
        seqs,
        model_config=TINY_CFG,
        train_config=tc,
        checkpoint_dir=ckpt_dir,
        log_fn=lambda *a: None,
    )
    assert "val_recon_loss" in metrics
    # restore through the inference entry point
    inf = QFormerInference(ckpt_dir, batch_size=16)
    assert inf.field_names == list(cache.fields)
    tokens = inf.query_tokens_from_cache(cache, ["it0", "it3"])
    assert tokens["it0"].shape == (4, 32)
    # must match a direct forward with the trained params
    model = ItemQFormer(TINY_CFG)
    emb, mask = cache.gather(["it0"])
    direct = model.apply(
        {"params": jax.tree_util.tree_map(np.asarray, state.params)},
        jnp.asarray(emb), jnp.asarray(mask),
    )["query_outputs"]
    np.testing.assert_allclose(
        tokens["it0"], np.asarray(direct[0]), atol=5e-2, rtol=0.1
    )  # bf16 inference vs fp32 train forward


def test_reconstruction_eval_runs(cache):
    model = ItemQFormer(TINY_CFG)
    params = model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, F, D)),
        jnp.ones((1, F)),
    )
    res = evaluate_reconstruction_quality(model, params, cache, batch_size=32)
    assert set(res) >= {"val_recon_loss", "avg_cosine_similarity"}
    assert res["num_samples"] == NUM_ITEMS


def test_null_value_semantics():
    assert is_null_value(None)
    assert is_null_value("  null ")
    assert is_null_value("NaN")
    assert not is_null_value(0)
    assert not is_null_value(0.0)
    assert not is_null_value("0")


def test_inference_raw_item_path(cache):
    inf = QFormerInference(
        config=TINY_CFG,
        params=ItemQFormer(TINY_CFG).init(
            jax.random.PRNGKey(0), jnp.zeros((1, F, D)), jnp.ones((1, F))
        ),
        field_names=cache.fields,
        item_encoder=FakeEncoder(),
        batch_size=8,
    )
    import json

    items = {"a": {"title": "x", "price": 1.0}, "b": {"title": None}}
    path = os.path.join(os.path.dirname(__file__), "_tmp_items.json")
    with open(path, "w") as f:
        json.dump(items, f)
    try:
        tok = inf.generate_query_tokens_by_id("a", path)
        assert tok.shape == (4, 32)
        batch = inf.generate_query_tokens_batch_by_ids(["a", "b", "zz"], path)
        assert set(batch) == {"a", "b"}
    finally:
        os.remove(path)


def test_dp_sharded_inference_matches_single_device(cache, eight_devices):
    """The dp-sharded catalog sweep must match the
    single-device jit forward bit-for-bit on the same platform."""
    from jax.sharding import Mesh

    params = ItemQFormer(TINY_CFG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, F, D)), jnp.ones((1, F))
    )
    mesh = Mesh(np.asarray(eight_devices).reshape(8, 1), ("dp", "tp"))
    sharded = QFormerInference(
        config=TINY_CFG, params=params, field_names=cache.fields,
        batch_size=16, mesh=mesh,
    )
    single = QFormerInference(
        config=TINY_CFG, params=params, field_names=cache.fields,
        batch_size=16,
    )
    # n=NUM_ITEMS=64: four full chunks; plus odd sizes exercising the
    # dp-pad (n<bs, not divisible by 8) and the tail-pad (n>bs) regimes
    for n in (NUM_ITEMS, 5, 19):
        emb, mask = cache.embeddings[:n], cache.masks[:n]
        out_s = sharded.query_tokens_from_embeddings(emb, mask)
        out_1 = single.query_tokens_from_embeddings(emb, mask)
        assert out_s.shape == (n, TINY_CFG.num_query_tokens, 32)
        np.testing.assert_allclose(out_s, out_1, atol=1e-6)

    # sharded batch_size must divide by the dp axis
    with pytest.raises(ValueError):
        QFormerInference(
            config=TINY_CFG, params=params, field_names=cache.fields,
            batch_size=12, mesh=mesh,
        )


@pytest.mark.parametrize("dp", [2, 8])
def test_dp_item_training_matches_single_device(cache, eight_devices, dp):
    """A dp-sharded item-trainer epoch must track the single-device epoch
    on the same batches: dropout bits differ by partition, so losses agree
    to dropout noise and the recon term tightly."""
    def make(dp):
        return ItemQFormerTrainer(TINY_CFG, TrainConfig(
            batch_size=16,
            optimizer=OptimizerConfig(learning_rate=1e-3),
            mesh=MeshConfig(dp=dp, tp=1),
        ))

    pairs = np.asarray([[i, (i + 1) % NUM_ITEMS] for i in range(32)], np.int32)
    t_1, t_dp = make(1), make(dp)
    s_1, s_dp = t_1.init_state(), t_dp.init_state()
    s_1, m_1 = t_1.train_epoch(s_1, cache, pairs, np.random.default_rng(0))
    s_dp, m_dp = t_dp.train_epoch(s_dp, cache, pairs,
                                  np.random.default_rng(0))
    assert np.isfinite(m_dp["loss"])
    assert abs(m_dp["loss"] - m_1["loss"]) < 0.05 * max(m_1["loss"], 1.0)
    assert abs(m_dp["recon"] - m_1["recon"]) < 1e-2


def test_gradient_accumulation_matches_big_batch(cache):
    """``OptimizerConfig.gradient_accumulation_steps`` (= the reference's HF
    TrainingArguments knob, train_item_individual_token_joint.py:758): two
    half-batch micro-steps at k=2 must (a) leave params untouched after the
    first micro-step (zero update) and (b) land on the k=1 full-batch step's
    params after the second.  Exactness needs fp32, dropout 0, equal micro
    sizes, and all-valid masks (per-batch mean reductions then compose)."""
    rng = np.random.RandomState(3)
    B = 8
    ones = np.ones((B, F), np.float32)
    batch = {
        "anchor_emb": rng.randn(B, F, D).astype(np.float32),
        "anchor_mask": ones,
        "pos_emb": rng.randn(B, F, D).astype(np.float32),
        "pos_mask": ones,
        "neg_emb": rng.randn(B, F, D).astype(np.float32),
        "neg_mask": ones,
    }

    def make(k, bs):
        tc = TrainConfig(
            batch_size=bs,
            optimizer=OptimizerConfig(learning_rate=1e-3,
                                      gradient_accumulation_steps=k),
            mesh=MeshConfig(dp=1, tp=1),
        )
        tr = ItemQFormerTrainer(TINY_CFG, tc, dtype="float32")
        return tr, tr.init_state(seed=0)

    tr1, s1 = make(1, B)
    s1, _ = tr1._train_step(
        s1, {k: jnp.asarray(v) for k, v in batch.items()}
    )

    tr2, s2 = make(2, B // 2)
    p0 = jax.tree_util.tree_map(np.asarray, s2.params)
    first = {k: jnp.asarray(v[: B // 2]) for k, v in batch.items()}
    second = {k: jnp.asarray(v[B // 2 :]) for k, v in batch.items()}
    s2, _ = tr2._train_step(s2, first)
    for a, b in zip(
        jax.tree_util.tree_leaves(p0), jax.tree_util.tree_leaves(s2.params)
    ):
        np.testing.assert_array_equal(a, np.asarray(b))  # mid-accum: frozen
    s2, _ = tr2._train_step(s2, second)

    for a, b in zip(
        jax.tree_util.tree_leaves(s1.params),
        jax.tree_util.tree_leaves(s2.params),
    ):
        # fp32 noise between mean-of-halves and the union-batch gradient can
        # reach ~1e-5 through AdamW's g/(sqrt(v)+eps) near-zero leaves; the
        # update scale itself is lr=1e-3
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)
