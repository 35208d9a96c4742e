"""Sequence-parallel cross-attention == unsharded attention, on the mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unirec.configs import MeshConfig
from unirec.ops.attention import attention, make_additive_mask
from unirec.ops.sharded_attention import sequence_parallel_cross_attention
from unirec.parallel.mesh import make_mesh


@pytest.mark.parametrize("tp", [2, 4])
def test_matches_unsharded(eight_devices, tp):
    mesh = make_mesh(MeshConfig(dp=8 // tp, tp=tp))
    rng = np.random.RandomState(0)
    b, h, lq, lkv, hd = 2, 4, 8, 64, 16
    q = jnp.asarray(rng.randn(b, h, lq, hd).astype(np.float32))
    k = jnp.asarray(rng.randn(b, h, lkv, hd).astype(np.float32))
    v = jnp.asarray(rng.randn(b, h, lkv, hd).astype(np.float32))
    mask = jnp.asarray((rng.rand(b, lkv) > 0.3).astype(np.float32))
    bias = make_additive_mask(mask)

    ref = attention(q, k, v, bias)
    out = sequence_parallel_cross_attention(q, k, v, bias, mesh=mesh, axis="tp")
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-5)


def test_all_masked_shard(eight_devices):
    """A shard whose keys are entirely masked must not produce NaNs."""
    mesh = make_mesh(MeshConfig(dp=4, tp=2))
    rng = np.random.RandomState(1)
    b, h, lq, lkv, hd = 1, 2, 4, 16, 8
    q = jnp.asarray(rng.randn(b, h, lq, hd).astype(np.float32))
    k = jnp.asarray(rng.randn(b, h, lkv, hd).astype(np.float32))
    v = jnp.asarray(rng.randn(b, h, lkv, hd).astype(np.float32))
    mask = np.ones((b, lkv), np.float32)
    mask[:, lkv // 2 :] = 0.0  # second shard fully masked
    bias = make_additive_mask(jnp.asarray(mask))
    ref = attention(q, k, v, bias)
    out = sequence_parallel_cross_attention(q, k, v, bias, mesh=mesh, axis="tp")
    assert np.isfinite(np.asarray(out)).all()
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-5)


def test_indivisible_length_raises(eight_devices):
    mesh = make_mesh(MeshConfig(dp=4, tp=2))
    q = jnp.zeros((1, 2, 4, 8))
    k = jnp.zeros((1, 2, 15, 8))
    with pytest.raises(ValueError, match="not divisible"):
        sequence_parallel_cross_attention(q, k, k, mesh=mesh, axis="tp")


def test_user_trainer_sp_step_matches_single_device(eight_devices):
    """`train user --sp N` end-to-end: a dp=2 x sp=4 sequence-parallel train
    step produces the same losses and parameter trajectory as the plain
    single-device trainer (memory axis sharded over 'sp', exact LSE combine
    + shard_map AD: the op is a consumed training path, not an orphan)."""
    from unirec.configs import (
        MeshConfig,
        OptimizerConfig,
        TrainConfig,
        UserQFormerConfig,
    )
    from unirec.train.user_qformer import UserQFormerTrainer

    def make(mesh_cfg, sp):
        uc = UserQFormerConfig(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, num_query_tokens=4, input_embedding_dim=32,
            num_item_tokens_to_predict=2, dropout=0.0, sequence_parallel=sp,
        )
        return UserQFormerTrainer(
            uc,
            TrainConfig(batch_size=4,
                        optimizer=OptimizerConfig(learning_rate=1e-3),
                        mesh=mesh_cfg),
            max_seq_len=8,
        )

    base = make(MeshConfig(dp=1, tp=1), False)
    spt = make(MeshConfig(dp=2, tp=1, sp=4), True)
    assert spt.sp_size == 4
    state_b = base.init_state(seed=0)
    state_s = spt.init_state(seed=0)

    rng = np.random.RandomState(7)
    batch = {
        "item_tokens": jnp.asarray(
            rng.randn(4, 8, 2, 32).astype(np.float32)),  # S*K=16, /4 ok
        "timestamps": jnp.asarray(rng.rand(4, 8).astype(np.float32)),
        "coordinates": jnp.asarray(rng.randn(4, 8, 2).astype(np.float32)),
        "seq_mask": jnp.asarray(
            (rng.rand(4, 8) > 0.2).astype(np.float32)),
        "target_tokens": jnp.asarray(rng.randn(4, 2, 32).astype(np.float32)),
    }
    for _ in range(3):
        state_b, mb = base._train_step(state_b, batch)
        state_s, ms = spt._train_step(state_s, batch)
        np.testing.assert_allclose(
            float(mb["loss"]), float(ms["loss"]), rtol=2e-5)
    for a, b in zip(jax.tree_util.tree_leaves(state_b.params),
                    jax.tree_util.tree_leaves(state_s.params)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=3e-5, rtol=1e-4)


def test_user_trainer_sp_requires_axis(eight_devices):
    from unirec.configs import (
        MeshConfig,
        TrainConfig,
        UserQFormerConfig,
    )
    from unirec.train.user_qformer import UserQFormerTrainer

    uc = UserQFormerConfig(
        hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=64, num_query_tokens=4, input_embedding_dim=32,
        num_item_tokens_to_predict=2, dropout=0.0, sequence_parallel=True,
    )
    with pytest.raises(ValueError, match="sp"):
        UserQFormerTrainer(
            uc, TrainConfig(batch_size=4, mesh=MeshConfig(dp=1, tp=1)),
            max_seq_len=4,
        )
