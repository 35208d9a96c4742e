"""Extras: field/modality-id conditioning, greedy generation, profiling."""

import jax
import jax.numpy as jnp
import numpy as np

from unirec.configs import ItemQFormerConfig, QFormerConfig
from unirec.models.item_qformer import ItemQFormer
from unirec.models.qformer import QFormerLMHeadModel, greedy_generate
from unirec.utils.profiling import ProgressWriter, ThroughputMeter


def test_field_type_embeddings_option():
    cfg = ItemQFormerConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, num_query_tokens=4, field_embedding_dim=32,
        num_fields=5, dropout=0.0, use_field_type_embeddings=True,
    )
    model = ItemQFormer(cfg)
    rng = jax.random.PRNGKey(0)
    fields = jax.random.normal(rng, (2, 5, 32))
    mask = jnp.ones((2, 5))
    modality_ids = jnp.asarray([0, 0, 1, 2, 3])
    params = model.init(rng, fields, mask, modality_ids=modality_ids)
    assert "field_id_embeddings" in params["params"]
    assert "modality_id_embeddings" in params["params"]
    out = model.apply(params, fields, mask, modality_ids=modality_ids)
    assert out["query_outputs"].shape == (2, 4, 32)
    # swapping two fields' positions changes the output (position-conditioned)
    fields2 = fields[:, [1, 0, 2, 3, 4]]
    out2 = model.apply(params, fields2, mask, modality_ids=modality_ids)
    # small at init (id embeddings have std 0.02) but strictly nonzero —
    # without the id embeddings the Q-Former is field-permutation-invariant
    assert np.abs(
        np.asarray(out["query_outputs"]) - np.asarray(out2["query_outputs"])
    ).max() > 1e-6


def test_greedy_generate_shapes_and_determinism():
    cfg = QFormerConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, encoder_width=24, query_length=4,
        vocab_size=50, max_position_embeddings=32,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
    )
    model = QFormerLMHeadModel(cfg)
    rng = jax.random.PRNGKey(0)
    q = jax.random.normal(rng, (2, 4, 32))
    mem = jax.random.normal(rng, (2, 3, 24))
    ids = jnp.ones((2, 8), jnp.int32)
    params = model.init(
        rng, input_ids=ids, query_embeds=q, encoder_hidden_states=mem
    )
    out = greedy_generate(
        model, params, q, mem, bos_token_id=1, eos_token_id=2,
        max_new_tokens=8,
    )
    assert out.shape == (2, 8)
    assert (np.asarray(out[:, 0]) == 1).all()
    out2 = greedy_generate(
        model, params, q, mem, bos_token_id=1, eos_token_id=2,
        max_new_tokens=8,
    )
    np.testing.assert_array_equal(np.asarray(out), np.asarray(out2))


def test_throughput_meter_and_progress(tmp_path):
    m = ThroughputMeter(total_items=100)
    for _ in range(3):
        m.start_batch()
        m.end_batch(10)
    s = m.stats()
    assert s["items_done"] == 30 and s["items_per_sec"] > 0
    assert m.eta_seconds() >= 0

    p = str(tmp_path / "prog.json")
    w = ProgressWriter(p, every_batches=2)
    w.update({"done": 1})
    import os

    assert not os.path.exists(p)  # below cadence
    w.update({"done": 2})
    assert os.path.exists(p)
    w.finish({"done": 3})
    import json

    with open(p) as f:
        assert json.load(f)["done"] == 3


def test_prefetch_to_device():
    from unirec.train.common import prefetch_to_device

    batches = [{"x": np.full((2, 2), i, np.float32)} for i in range(5)]
    out = list(prefetch_to_device(iter(batches), size=2))
    assert len(out) == 5
    for i, b in enumerate(out):
        np.testing.assert_array_equal(np.asarray(b["x"]), batches[i]["x"])
        assert hasattr(b["x"], "devices")  # on device


def test_nan_checks_context():
    from unirec.utils.debug import nan_checks

    with nan_checks():
        with np.testing.assert_raises(Exception):
            jax.jit(lambda x: x / 0.0)(jnp.ones(4)).block_until_ready()
    # restored afterwards: no raise
    jax.jit(lambda x: x / 0.0)(jnp.ones(4)).block_until_ready()


def test_drive_steps_uses_prefetcher_and_overlaps(monkeypatch):
    """The epoch driver must route batches through prefetch_to_device
    (the prefetcher must be on the training path, not just
    importable) and keep at most max_in_flight un-synced steps."""
    from unirec.train import common

    seen = {"prefetch_calls": 0}
    orig = common.prefetch_to_device

    def spy(it, size=2, sharding=None):
        seen["prefetch_calls"] += 1
        return orig(it, size, sharding=sharding)

    monkeypatch.setattr(common, "prefetch_to_device", spy)

    def fake_step(state, batch):
        return state + 1, {"loss": jnp.asarray(float(state))}

    batches = ({"x": np.full((2,), i, np.float32)} for i in range(6))
    state, mean, last = common.drive_steps(fake_step, 0, batches)
    assert seen["prefetch_calls"] == 1
    assert state == 6
    assert mean["loss"] == np.mean([0, 1, 2, 3, 4, 5])
    assert last["loss"] == 5.0

    # step_hook path: hooks observe per-step metrics and may replace state
    hooks = []
    batches = ({"x": np.full((2,), i, np.float32)} for i in range(3))
    state, mean, last = common.drive_steps(
        fake_step, 0, batches,
        step_hook=lambda i, st, m: hooks.append((i, m["loss"])) or st,
    )
    assert hooks == [(0, 0.0), (1, 1.0), (2, 2.0)]


def test_trainer_epoch_goes_through_prefetcher(monkeypatch):
    """End-to-end: ItemQFormerTrainer.train_epoch drives batches through the
    device prefetcher."""
    from unirec.configs import MeshConfig, OptimizerConfig, TrainConfig
    from unirec.data.cache import FieldEmbeddingCache
    from unirec.train import common
    from unirec.train.item_qformer import ItemQFormerTrainer

    calls = []
    orig = common.prefetch_to_device
    monkeypatch.setattr(
        common, "prefetch_to_device",
        lambda it, size=2, sharding=None: calls.append(1)
        or orig(it, size, sharding=sharding),
    )
    cfg = ItemQFormerConfig(
        hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=32, num_query_tokens=4, field_embedding_dim=16,
        num_fields=3, dropout=0.0,
    )
    tr = ItemQFormerTrainer(
        cfg,
        TrainConfig(batch_size=4, optimizer=OptimizerConfig(learning_rate=1e-3),
                    mesh=MeshConfig(dp=2, tp=1)),
    )
    state = tr.init_state()
    rng = np.random.RandomState(0)
    cache = FieldEmbeddingCache(
        embeddings=rng.randn(12, 3, 16).astype(np.float32),
        masks=np.ones((12, 3), np.float32),
        fields=["a", "b", "c"],
        item_ids=[f"i{k}" for k in range(12)],
    )
    pairs = np.asarray([[i, (i + 1) % 12] for i in range(12)], np.int32)
    state, metrics = tr.train_epoch(
        state, cache, pairs, np.random.default_rng(0)
    )
    assert calls, "train_epoch did not go through prefetch_to_device"
    assert np.isfinite(metrics["loss"])


def test_kv_cached_generate_matches_full_forward():
    """O(T) KV-cached decode must match the O(T^2) full-forward greedy
    decode token-for-token (reference capability:
    models/qformer.py:1015-1035 past_key_values generation)."""
    from unirec.models.qformer_decode import kv_cached_greedy_generate

    cfg = QFormerConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, encoder_width=24, query_length=4,
        vocab_size=50, max_position_embeddings=32,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
    )
    model = QFormerLMHeadModel(cfg)
    rng = jax.random.PRNGKey(0)
    q = jax.random.normal(rng, (2, 4, 32))
    mem = jax.random.normal(jax.random.PRNGKey(1), (2, 3, 24))
    ids = jnp.ones((2, 8), jnp.int32)
    params = model.init(
        rng, input_ids=ids, query_embeds=q, encoder_hidden_states=mem
    )
    full = greedy_generate(
        model, params, q, mem, bos_token_id=1, eos_token_id=2,
        max_new_tokens=8,
    )
    cached = kv_cached_greedy_generate(
        params, cfg, q, mem, bos_token_id=1, eos_token_id=2,
        max_new_tokens=8,
    )
    np.testing.assert_array_equal(np.asarray(full), np.asarray(cached))

    # masked encoder memory must behave identically too
    emask = jnp.asarray([[1.0, 1.0, 0.0], [1.0, 0.0, 0.0]])
    full_m = greedy_generate(
        model, params, q, mem, emask, bos_token_id=1, eos_token_id=2,
        max_new_tokens=6,
    )
    cached_m = kv_cached_greedy_generate(
        params, cfg, q, mem, emask, bos_token_id=1, eos_token_id=2,
        max_new_tokens=6,
    )
    np.testing.assert_array_equal(np.asarray(full_m), np.asarray(cached_m))


def test_kv_cached_beam_generate():
    """Beam search over the KV cache (reference surface: HF generate with
    beam cache reordering, models/qformer.py:1104-1135).  num_beams=1 must
    equal greedy token-for-token; wider beams must never score below the
    greedy sequence under the same model."""
    from unirec.models.qformer_decode import (
        kv_cached_beam_generate,
        kv_cached_greedy_generate,
    )

    cfg = QFormerConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, encoder_width=24, query_length=4,
        vocab_size=50, max_position_embeddings=32,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
    )
    model = QFormerLMHeadModel(cfg)
    rng = jax.random.PRNGKey(3)
    q = jax.random.normal(rng, (2, 4, 32))
    mem = jax.random.normal(jax.random.PRNGKey(4), (2, 3, 24))
    ids = jnp.ones((2, 8), jnp.int32)
    params = model.init(
        rng, input_ids=ids, query_embeds=q, encoder_hidden_states=mem
    )

    greedy = kv_cached_greedy_generate(
        params, cfg, q, mem, bos_token_id=1, eos_token_id=2,
        max_new_tokens=8,
    )
    beam1, score1 = jax.jit(
        lambda p: kv_cached_beam_generate(
            p, cfg, q, mem, bos_token_id=1, eos_token_id=2,
            max_new_tokens=8, num_beams=1,
        )
    )(params)
    np.testing.assert_array_equal(np.asarray(greedy), np.asarray(beam1))

    def seq_logprob(seq):
        """length-normalized logprob of a generated sequence under the
        teacher-forced model (penalty 1.0 to match the beam score)."""
        seq = np.asarray(seq)
        b = seq.shape[0]
        full_mask = jnp.ones((b, 4 + seq.shape[1]), jnp.float32)
        logits = model.apply(
            params, input_ids=jnp.asarray(seq), attention_mask=full_mask,
            query_embeds=q, encoder_hidden_states=mem,
        )
        logp = jax.nn.log_softmax(np.asarray(logits, np.float32), axis=-1)
        out = np.zeros(b)
        for row in range(b):
            t = 0
            while t + 1 < seq.shape[1]:
                tok = seq[row, t + 1]
                out[row] += logp[row, t, tok]
                t += 1
                if tok == 2:  # EOS
                    break
            out[row] /= (t + 1)
        return out

    beam4, score4 = jax.jit(
        lambda p: kv_cached_beam_generate(
            p, cfg, q, mem, bos_token_id=1, eos_token_id=2,
            max_new_tokens=8, num_beams=4,
        )
    )(params)
    g_lp = seq_logprob(greedy)
    b_lp = seq_logprob(beam4)
    assert (b_lp >= g_lp - 1e-5).all(), (b_lp, g_lp)
    # the beam's reported score must equal the teacher-forced re-scoring
    np.testing.assert_allclose(np.asarray(score4), b_lp, atol=1e-4)


def test_kernel_flags_warn_when_zeroing_prob_dropout():
    """sequence_parallel silently changes attention-prob dropout semantics —
    the config must say so out loud, and only when a nonzero rate is
    actually zeroed."""
    import warnings

    import pytest

    from unirec.configs import ItemQFormerConfig, UserQFormerConfig

    with pytest.warns(UserWarning, match="zeroes attention-prob dropout"):
        qc = UserQFormerConfig(dropout=0.1, sequence_parallel=True).qformer()
    assert qc.attention_probs_dropout_prob == 0.0
    assert qc.hidden_dropout_prob == 0.1
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # nothing zeroed: no warning
        UserQFormerConfig(dropout=0.0, sequence_parallel=True).qformer()
        assert UserQFormerConfig(dropout=0.1).qformer(
        ).attention_probs_dropout_prob == 0.1
        ItemQFormerConfig(
            hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
            intermediate_size=64, num_query_tokens=4, field_embedding_dim=16,
            num_fields=3, dropout=0.1,
        ).qformer()
