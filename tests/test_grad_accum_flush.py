"""End-of-training grad-accumulation tail flush (train/common.flush_grad_accum).

HF Trainer parity: the HF Trainer (the reference joint stage's driver,
train_item_individual_token_joint.py:755-773) never drops the tail of the
last accumulation window — optax.MultiSteps does, unless the pending
average is force-applied when training ends.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax

from unirec.configs import OptimizerConfig
from unirec.train.common import TrainState, flush_grad_accum, make_optimizer

CFG = OptimizerConfig(
    learning_rate=1e-2, gradient_accumulation_steps=4,
    warmup_steps=0, max_grad_norm=0.0,
)


def _state(cfg):
    params = {"w": jnp.ones((4,), jnp.float32), "b": jnp.zeros((2,))}
    return TrainState.create(
        apply_fn=lambda *a: None, params=params, tx=make_optimizer(cfg)
    )


def test_flush_applies_pending_micro_grads():
    state = _state(CFG)
    g1 = {"w": jnp.full((4,), 1.0), "b": jnp.full((2,), -1.0)}
    g2 = {"w": jnp.full((4,), 3.0), "b": jnp.full((2,), -3.0)}
    state = state.apply_gradients(grads=g1)
    state = state.apply_gradients(grads=g2)
    # 2 of 4 micro-steps: MultiSteps has emitted zero updates so far
    np.testing.assert_array_equal(np.asarray(state.params["w"]), 1.0)
    assert int(state.opt_state.mini_step) == 2
    assert int(state.opt_state.gradient_step) == 0

    flushed = flush_grad_accum(state, CFG)

    # equals ONE inner-AdamW apply on the mean of the received micro-grads
    ref = _state(dataclasses.replace(CFG, gradient_accumulation_steps=1))
    ref = ref.apply_gradients(
        grads={"w": jnp.full((4,), 2.0), "b": jnp.full((2,), -2.0)}
    )
    for k in ("w", "b"):
        np.testing.assert_allclose(
            np.asarray(flushed.params[k]), np.asarray(ref.params[k]),
            rtol=1e-6,
        )
    # counters reset: the flush consumed the accumulator
    assert int(flushed.opt_state.mini_step) == 0
    assert int(flushed.opt_state.gradient_step) == 1
    assert all(
        float(jnp.abs(g).max()) == 0.0
        for g in jax.tree_util.tree_leaves(flushed.opt_state.acc_grads)
    )
    # step counts micro-batches consumed; the flush consumes none
    assert int(flushed.step) == int(state.step)


def test_flush_noop_when_accumulator_empty():
    state = _state(CFG)
    g = {"w": jnp.ones((4,)), "b": jnp.ones((2,))}
    for _ in range(4):  # exactly one full window -> mini_step wraps to 0
        state = state.apply_gradients(grads=g)
    assert int(state.opt_state.mini_step) == 0
    flushed = flush_grad_accum(state, CFG)
    assert flushed is state


def test_flush_noop_without_accumulation():
    cfg = dataclasses.replace(CFG, gradient_accumulation_steps=1)
    state = _state(cfg)
    state = state.apply_gradients(grads={"w": jnp.ones((4,)), "b": jnp.ones((2,))})
    assert not isinstance(state.opt_state, optax.MultiStepsState)
    assert flush_grad_accum(state, cfg) is state


def test_flush_respects_warmup_and_clip_chain():
    # inner chain = clip + warmup-scheduled AdamW: the flush must run the
    # SAME chain (inner_opt_state layouts must line up)
    cfg = dataclasses.replace(CFG, warmup_steps=10, max_grad_norm=1.0)
    state = _state(cfg)
    state = state.apply_gradients(
        grads={"w": jnp.full((4,), 100.0), "b": jnp.full((2,), 100.0)}
    )
    flushed = flush_grad_accum(state, cfg)
    ref = _state(dataclasses.replace(cfg, gradient_accumulation_steps=1))
    ref = ref.apply_gradients(
        grads={"w": jnp.full((4,), 100.0), "b": jnp.full((2,), 100.0)}
    )
    for k in ("w", "b"):
        np.testing.assert_allclose(
            np.asarray(flushed.params[k]), np.asarray(ref.params[k]),
            rtol=1e-6,
        )
