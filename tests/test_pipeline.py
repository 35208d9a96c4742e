"""Pipeline parallelism (pp): pipelined Qwen3 == single-device Qwen3.

The pipelined decoder (parallel/pipeline.py) must be numerically identical to
models/qwen3.Qwen3Model — same layers, different schedule — in both the
forward and the gradients, on a dp x pp virtual mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unirec.configs import LoRAConfig, tiny_qwen3_config
from unirec.models.qwen3 import Qwen3Model, mean_pool
from unirec.parallel.pipeline import (
    PipelinedQwen3,
    make_pp_mesh,
    merge_layer_params,
    pp_shardings,
    split_layer_params,
)


def _setup(pp, dp, layers=4, lora=None, batch=8, seq=16):
    cfg = tiny_qwen3_config(
        num_hidden_layers=layers
    )
    model = Qwen3Model(cfg, lora=lora)
    rng = np.random.RandomState(0)
    ids = jnp.asarray(rng.randint(0, cfg.vocab_size, (batch, seq)), jnp.int32)
    mask = np.ones((batch, seq), np.float32)
    mask[:, seq - 3 :] = 0.0  # right padding exercises the bias path
    mask = jnp.asarray(mask)
    params = model.init(jax.random.PRNGKey(0), ids, mask)
    mesh = make_pp_mesh(pp=pp, dp=dp)
    return cfg, model, params, ids, mask, mesh


@pytest.mark.parametrize("pp,dp,m", [(4, 2, 2), (2, 4, 1), (8, 1, 4)])
def test_forward_matches_single_device(eight_devices, pp, dp, m):
    cfg, model, params, ids, mask, mesh = _setup(pp, dp, layers=8)
    ref = model.apply(params, ids, mask, deterministic=True)

    pipe = PipelinedQwen3(cfg, mesh, num_microbatches=m)
    stacked, rest = split_layer_params(params)
    st_sh, rp_sh = pp_shardings(stacked, rest, mesh)
    stacked = jax.tree_util.tree_map(jax.device_put, stacked, st_sh)
    rest = jax.tree_util.tree_map(jax.device_put, rest, rp_sh)

    out = jax.jit(
        lambda st, rs, i, a: pipe(st, rs, i, a, deterministic=True)
    )(stacked, rest, ids, mask)
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(ref), atol=2e-5, rtol=2e-5
    )


def test_split_merge_roundtrip():
    cfg = tiny_qwen3_config(num_hidden_layers=4)
    model = Qwen3Model(cfg)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = model.init(jax.random.PRNGKey(1), ids, jnp.ones((1, 8)))
    stacked, rest = split_layer_params(params)
    merged = merge_layer_params(stacked, rest)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
        params,
        merged,
    )


def test_grads_match_single_device(eight_devices):
    cfg, model, params, ids, mask, mesh = _setup(pp=4, dp=2)
    pipe = PipelinedQwen3(cfg, mesh, num_microbatches=2)
    stacked, rest = split_layer_params(params)

    def ref_loss(p):
        h = model.apply(p, ids, mask, deterministic=True)
        return jnp.mean(jnp.square(mean_pool(h, mask, masked=True)))

    def pp_loss(st, rs):
        h = pipe(st, rs, ids, mask, deterministic=True)
        return jnp.mean(jnp.square(mean_pool(h, mask, masked=True)))

    ref_grads = jax.grad(ref_loss)(params)
    ref_stacked, ref_rest = split_layer_params(ref_grads)
    got_stacked, got_rest = jax.jit(jax.grad(pp_loss, argnums=(0, 1)))(
        stacked, rest
    )
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=1e-5, rtol=1e-4
        ),
        (ref_stacked, ref_rest),
        (got_stacked, got_rest),
    )


def test_train_step_with_lora_dropout(eight_devices):
    """A pp train step with LoRA dropout: runs, finite, updates only LoRA."""
    import optax

    lora = LoRAConfig(r=2, dropout=0.2)
    cfg, model, params, ids, mask, mesh = _setup(pp=2, dp=4, lora=lora)
    pipe = PipelinedQwen3(cfg, mesh, num_microbatches=2, lora=lora)
    stacked, rest = split_layer_params(params)
    st_sh, rp_sh = pp_shardings(stacked, rest, mesh)
    stacked = jax.tree_util.tree_map(jax.device_put, stacked, st_sh)
    rest = jax.tree_util.tree_map(jax.device_put, rest, rp_sh)

    tx = optax.adamw(1e-3)
    opt_state = tx.init(stacked)

    def loss_fn(st, rs, key):
        h = pipe(st, rs, ids, mask, deterministic=False, dropout_rng=key)
        return jnp.mean(jnp.square(mean_pool(h, mask, masked=True)))

    @jax.jit
    def step(st, rs, opt_state, key):
        loss, grads = jax.value_and_grad(loss_fn)(st, rs, key)
        updates, opt_state = tx.update(grads, opt_state, st)
        return optax.apply_updates(st, updates), opt_state, loss

    key = jax.random.key(0)
    losses = []
    for i in range(2):
        stacked, opt_state, loss = step(
            stacked, rest, opt_state, jax.random.fold_in(key, i)
        )
        losses.append(float(loss))
    assert all(np.isfinite(losses)), losses


def test_rejects_bad_layer_split(eight_devices):
    cfg = tiny_qwen3_config(num_hidden_layers=6)
    mesh = make_pp_mesh(pp=4, dp=2)
    with pytest.raises(ValueError, match="not divisible"):
        PipelinedQwen3(cfg, mesh)


# -- flagship composition: joint model with a pipelined backbone ------------


def _joint_setup(pp=4, dp=2, batch=8):
    from unirec.configs import ItemQFormerConfig, JointModelConfig
    from unirec.models.joint import MultiModalQwenEmbedding

    qcfg = tiny_qwen3_config(num_hidden_layers=4)
    qf = ItemQFormerConfig(
        hidden_size=qcfg.hidden_size, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64, num_query_tokens=2,
        field_embedding_dim=16, num_fields=3, dropout=0.1,
    )
    jc = JointModelConfig(
        num_history_items=2, num_query_tokens_per_item=2, max_length=16
    )
    lora = LoRAConfig(r=2, dropout=0.1)
    model = MultiModalQwenEmbedding(qcfg, qf, jc, lora=lora)

    rng = np.random.RandomState(1)
    n_special = jc.num_history_items * jc.num_query_tokens_per_item
    ids = rng.randint(0, qcfg.vocab_size, (batch, jc.max_length))
    for i in range(batch):  # place the reserved special tokens
        pos = rng.choice(jc.max_length, n_special, replace=False)
        ids[i, pos] = qcfg.vocab_size + np.arange(n_special)
    ids = jnp.asarray(ids, jnp.int32)
    mask = jnp.ones((batch, jc.max_length), jnp.float32)
    hist = jnp.asarray(
        rng.randn(batch, jc.num_history_items, 3, 16), jnp.float32
    )
    hmask = jnp.ones((batch, jc.num_history_items, 3), jnp.float32)
    params = model.init(jax.random.PRNGKey(0), ids, mask, hist, hmask)
    mesh = make_pp_mesh(pp=pp, dp=dp)
    pipe = PipelinedQwen3(qcfg, mesh, num_microbatches=2, lora=lora)
    return model, pipe, params, ids, mask, hist, hmask


def test_joint_pp_forward_matches_joint_model(eight_devices):
    from unirec.parallel.pipeline import (
        joint_pp_forward,
        merge_joint_params,
        split_joint_params,
    )

    model, pipe, params, ids, mask, hist, hmask = _joint_setup()
    ref = model.apply(params, ids, mask, hist, hmask, deterministic=True)
    stacked, rest, qf_params = split_joint_params(params)
    out = jax.jit(
        lambda st, rs, qp: joint_pp_forward(
            model, pipe, st, rs, qp, ids, mask, hist, hmask,
            deterministic=True,
        )
    )(stacked, rest, qf_params)
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(ref), atol=2e-5, rtol=2e-5
    )
    # param interchange roundtrip
    merged = merge_joint_params(stacked, rest, qf_params)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b)
        ),
        params,
        merged,
    )


def test_joint_pp_infonce_train_step(eight_devices):
    """Full flagship training semantics (InfoNCE + dropout) through the
    pipeline: loss finite and decreasing over a few steps."""
    import optax

    from unirec.ops.losses import info_nce_loss
    from unirec.parallel.pipeline import (
        joint_pp_forward,
        split_joint_params,
    )

    model, pipe, params, ids, mask, hist, hmask = _joint_setup(pp=2, dp=4)
    stacked, rest, qf_params = split_joint_params(params)
    rng = np.random.RandomState(2)
    d = model.qwen_config.hidden_size
    pos = jnp.asarray(rng.randn(ids.shape[0], d), jnp.float32)
    neg = jnp.asarray(rng.randn(ids.shape[0], 4, d), jnp.float32)

    tx = optax.adam(3e-3)
    trainable = (stacked, rest, qf_params)
    opt_state = tx.init(trainable)

    def loss_fn(tr, key):
        st, rs, qp = tr
        user = joint_pp_forward(
            model, pipe, st, rs, qp, ids, mask, hist, hmask,
            deterministic=False, dropout_rng=key,
        )
        return info_nce_loss(user, pos, neg)

    @jax.jit
    def step(tr, opt_state, key):
        loss, grads = jax.value_and_grad(loss_fn)(tr, key)
        updates, opt_state = tx.update(grads, opt_state, tr)
        return optax.apply_updates(tr, updates), opt_state, loss

    key = jax.random.key(7)
    losses = []
    for i in range(4):
        trainable, opt_state, loss = step(
            trainable, opt_state, jax.random.fold_in(key, i)
        )
        losses.append(float(loss))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
