"""Checkpoint/resume: full TrainState roundtrip including optimizer state —
the capability the reference lacks entirely (SURVEY.md §5: "No optimizer
state, no step resume anywhere")."""

import jax
import jax.numpy as jnp
import numpy as np

from unirec.configs import (
    ItemQFormerConfig,
    MeshConfig,
    OptimizerConfig,
    TrainConfig,
)
from unirec.data.cache import FieldEmbeddingCache
from unirec.train.common import TrainState, make_optimizer
from unirec.train.item_qformer import ItemQFormerTrainer, build_triplet_pairs
from unirec.utils.checkpoint import (
    load_checkpoint,
    restore_config,
    save_checkpoint,
)

CFG = ItemQFormerConfig(
    hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
    intermediate_size=64, num_query_tokens=4, field_embedding_dim=16,
    num_fields=3, dropout=0.0,
)


def _setup():
    rng = np.random.RandomState(0)
    n = 16
    cache = FieldEmbeddingCache(
        embeddings=rng.randn(n, 3, 16).astype(np.float32),
        masks=np.ones((n, 3), np.float32),
        fields=["a", "b", "c"],
        item_ids=[f"i{j}" for j in range(n)],
    )
    tc = TrainConfig(
        batch_size=8, optimizer=OptimizerConfig(learning_rate=1e-3),
        mesh=MeshConfig(),
    )
    trainer = ItemQFormerTrainer(CFG, tc)
    pairs = build_triplet_pairs(
        [[f"i{j}", f"i{j+1}"] for j in range(15)], cache.id_to_row
    )
    return trainer, cache, pairs


def test_resume_reproduces_training(tmp_path):
    """Save at step S, keep training; reload and re-train: identical result."""
    trainer, cache, pairs = _setup()
    state = trainer.init_state()
    rng = np.random.default_rng(0)
    state, _ = trainer.train_epoch(state, cache, pairs, rng)

    ckpt = str(tmp_path / "ck")
    save_checkpoint(ckpt, state, config=CFG, extra={"field_names": cache.fields})
    step_at_save = int(state.step)

    # continue training (branch A) — donates `state`'s buffers
    rng_a = np.random.default_rng(7)
    state_a, ma = trainer.train_epoch(state, cache, pairs, rng_a)

    # reload and continue identically (branch B): fresh trainer + state
    # template, then structural restore
    from unirec.utils.checkpoint import restore_train_state

    trainer_b, _, _ = _setup()
    template = trainer_b.init_state()
    restored, meta = restore_train_state(ckpt, template)
    cfg2 = restore_config(meta, ItemQFormerConfig)
    assert cfg2 == CFG
    assert meta["field_names"] == ["a", "b", "c"]
    assert int(restored.step) == step_at_save
    rng_b = np.random.default_rng(7)
    state_b, mb = trainer.train_epoch(restored, cache, pairs, rng_b)

    np.testing.assert_allclose(ma["loss"], mb["loss"], rtol=1e-6)
    la = jax.tree_util.tree_leaves(state_a.params)
    lb = jax.tree_util.tree_leaves(state_b.params)
    for a, b in zip(la, lb):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_opt_state_restored_structurally(tmp_path):
    trainer, cache, pairs = _setup()
    state = trainer.init_state()
    state, _ = trainer.train_epoch(state, cache, pairs, np.random.default_rng(0))
    ckpt = str(tmp_path / "ck2")
    save_checkpoint(ckpt, state)
    tree, _ = load_checkpoint(ckpt)
    # adam mu/nu present and nonzero after a step
    flat = jax.tree_util.tree_leaves(tree["opt_state"])
    assert any(np.abs(np.asarray(x)).max() > 0 for x in flat if hasattr(x, "shape"))


def test_resume_grad_accum_mismatch_fails_fast(tmp_path):
    """A checkpoint saved under --grad-accum k refuses to resume into a run
    with a different accumulation: MultiSteps changes the opt_state pytree,
    so without the recorded meta the orbax restore fails opaquely (or, for
    two values both >1, silently mis-restores the accumulation counters)."""
    import pytest

    from unirec.utils.checkpoint import (
        check_grad_accum,
        read_meta,
        resume_train_state,
    )

    trainer, cache, pairs = _setup()
    state = trainer.init_state()
    ckpt = str(tmp_path / "ga")
    save_checkpoint(ckpt, state, extra={"grad_accum": 2})

    assert read_meta(ckpt)["grad_accum"] == 2
    check_grad_accum(read_meta(ckpt), 2)  # matching value passes
    with pytest.raises(ValueError, match="grad-accum"):
        resume_train_state(ckpt, state, expect_grad_accum=1)
    # legacy checkpoints without the field default to 1
    save_checkpoint(ckpt, state, extra={})
    check_grad_accum(read_meta(ckpt), 1)
    with pytest.raises(ValueError, match="grad-accum"):
        check_grad_accum(read_meta(ckpt), 4)
