"""Grouped LoRA overlay (LoRAConfig.grouped).

The grouped path replaces per-projection lora_a matmuls + dropout draws
with one shared draw and one concatenated matmul per input-sharing group
(q/k/v; gate/up).  Contracts:

- param tree identical to the per-projection layout (checkpoints/PEFT
  export unchanged)
- dropout=0: forward AND grads numerically equal to the ungrouped path
- dropout>0: runs, and grads reach every lora_a/lora_b (the grouped
  branch reads lora_a through .variables after a DCE'd binding call —
  this test is the guard that gradient flow through that read works)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unirec.configs import LoRAConfig, tiny_qwen3_config
from unirec.models.qwen3 import Qwen3Model


def _make(grouped, dropout):
    cfg = tiny_qwen3_config()
    lora = LoRAConfig(r=4, dropout=dropout, grouped=grouped)
    return Qwen3Model(cfg, lora=lora, n_extra_tokens=0, dtype=jnp.float32), cfg


def _data(cfg, b=2, l=8):
    rng = np.random.RandomState(0)
    embeds = jnp.asarray(rng.randn(b, l, cfg.hidden_size).astype(np.float32)
                         * 0.1)
    mask = jnp.ones((b, l), jnp.float32)
    return embeds, mask


def test_param_tree_identical():
    m0, cfg = _make(False, 0.1)
    m1, _ = _make(True, 0.1)
    embeds, mask = _data(cfg)
    p0 = m0.init(jax.random.PRNGKey(0), inputs_embeds=embeds,
                 attention_mask=mask)["params"]
    p1 = m1.init(jax.random.PRNGKey(0), inputs_embeds=embeds,
                 attention_mask=mask)["params"]
    f0 = jax.tree_util.tree_flatten_with_path(p0)[0]
    f1 = jax.tree_util.tree_flatten_with_path(p1)[0]
    assert [(p, x.shape) for p, x in f0] == [(p, x.shape) for p, x in f1]
    for (_, a), (_, b) in zip(f0, f1):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("deterministic", [True, False])
def test_nodrop_matches_ungrouped(deterministic):
    m0, cfg = _make(False, 0.0)
    m1, _ = _make(True, 0.0)
    embeds, mask = _data(cfg)
    params = m0.init(jax.random.PRNGKey(0), inputs_embeds=embeds,
                     attention_mask=mask)["params"]
    kw = {}
    if not deterministic:
        kw["rngs"] = {"dropout": jax.random.PRNGKey(1)}

    def loss(m, p):
        out = m.apply({"params": p}, inputs_embeds=embeds,
                      attention_mask=mask, deterministic=deterministic, **kw)
        return (out.astype(jnp.float32) ** 2).mean()

    l0, g0 = jax.value_and_grad(lambda p: loss(m0, p))(params)
    l1, g1 = jax.value_and_grad(lambda p: loss(m1, p))(params)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
    for (path, a), (_, b) in zip(
        jax.tree_util.tree_flatten_with_path(g0)[0],
        jax.tree_util.tree_flatten_with_path(g1)[0],
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=5e-5, atol=1e-6,
            err_msg=str(path))


def test_dropout_grads_reach_all_lora_params():
    m1, cfg = _make(True, 0.5)
    embeds, mask = _data(cfg, b=4, l=16)
    params = m1.init(jax.random.PRNGKey(0), inputs_embeds=embeds,
                     attention_mask=mask)["params"]
    # lora_b inits to zeros -> give it signal so lora_a grads are nonzero
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.ones_like(x) * 0.1
        if any("lora_b" in str(k) for k in p) else x, params)

    def loss(p):
        out = m1.apply({"params": p}, inputs_embeds=embeds,
                       attention_mask=mask, deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(3)})
        return (out.astype(jnp.float32) ** 2).mean()

    grads = jax.grad(loss)(params)
    n_lora = 0
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        name = "/".join(str(k) for k in path)
        if "lora_a" in name or "lora_b" in name:
            n_lora += 1
            assert float(jnp.abs(g).max()) > 0, f"zero grad at {name}"
    # 7 targets x 2 lora mats x 2 layers
    assert n_lora == 28


def test_grouped_differs_only_in_dropout_bits():
    # with dropout>0 the grouped path is a DIFFERENT (correlated) draw --
    # outputs must differ from ungrouped under the same rng, but agree
    # in expectation scale (sanity: same mean magnitude within 10x)
    m0, cfg = _make(False, 0.5)
    m1, _ = _make(True, 0.5)
    embeds, mask = _data(cfg, b=4, l=16)
    params = m0.init(jax.random.PRNGKey(0), inputs_embeds=embeds,
                     attention_mask=mask)["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.ones_like(x) * 0.1
        if any("lora_b" in str(k) for k in p) else x, params)

    def run(m):
        return m.apply({"params": params}, inputs_embeds=embeds,
                       attention_mask=mask, deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(3)})

    o0, o1 = run(m0), run(m1)
    assert not np.allclose(np.asarray(o0), np.asarray(o1))
    assert 0.1 < float(jnp.abs(o1).mean() / jnp.abs(o0).mean()) < 10.0
