"""Qwen3 decoder: parity vs HF transformers, LoRA semantics, TP sharding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unirec.configs import LoRAConfig, tiny_qwen3_config
from unirec.models.qwen3 import (
    Qwen3Model,
    last_token_pool,
    mean_pool,
    tp_shardings,
)
from unirec.utils.params import (
    count_params,
    lora_trainable_mask,
    merge_params,
)

CFG = tiny_qwen3_config(max_position_embeddings=128)


def _random_inputs(b=2, l=10, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, CFG.vocab_size, (b, l)).astype(np.int32)
    mask = np.ones((b, l), np.float32)
    if b > 1:
        mask[1, l - 3 :] = 0.0
    return ids, mask


def test_parity_vs_hf_transformers():
    torch = pytest.importorskip("torch")
    from transformers import Qwen3Config as HFConfig, Qwen3Model as HFModel

    from unirec.utils.torch_convert import convert_qwen3

    hf_cfg = HFConfig(
        vocab_size=CFG.vocab_size,
        hidden_size=CFG.hidden_size,
        intermediate_size=CFG.intermediate_size,
        num_hidden_layers=CFG.num_hidden_layers,
        num_attention_heads=CFG.num_attention_heads,
        num_key_value_heads=CFG.num_key_value_heads,
        head_dim=CFG.head_dim,
        rms_norm_eps=CFG.rms_norm_eps,
        rope_theta=CFG.rope_theta,
        max_position_embeddings=CFG.max_position_embeddings,
        attention_bias=False,
        attn_implementation="eager",
    )
    torch.manual_seed(0)
    hf = HFModel(hf_cfg).eval()

    ids, mask = _random_inputs()
    with torch.no_grad():
        t_out = hf(
            input_ids=torch.tensor(ids, dtype=torch.long),
            attention_mask=torch.tensor(mask),
        ).last_hidden_state.numpy()

    model = Qwen3Model(CFG)
    params = convert_qwen3(hf.state_dict(), CFG.num_hidden_layers)
    f_out = np.asarray(
        model.apply(
            {"params": params},
            input_ids=jnp.asarray(ids),
            attention_mask=jnp.asarray(mask),
        )
    )
    # padded positions may differ (HF masks them too); compare valid positions
    valid = mask.astype(bool)
    np.testing.assert_allclose(
        f_out[valid], t_out[valid], atol=2e-4, rtol=1e-3
    )


def test_lora_zero_init_is_identity():
    ids, mask = _random_inputs()
    base = Qwen3Model(CFG)
    params = base.init(jax.random.PRNGKey(0), input_ids=jnp.asarray(ids))["params"]
    out_base = base.apply({"params": params}, input_ids=jnp.asarray(ids),
                          attention_mask=jnp.asarray(mask))

    lora_model = Qwen3Model(CFG, lora=LoRAConfig(r=4))
    lora_params = lora_model.init(
        jax.random.PRNGKey(1), input_ids=jnp.asarray(ids)
    )["params"]
    merged = merge_params(lora_params, params)
    out_lora = lora_model.apply(
        {"params": merged}, input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(mask),
    )
    np.testing.assert_allclose(
        np.asarray(out_lora), np.asarray(out_base), atol=1e-6
    )
    # perturbing lora_b changes the output
    merged2 = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.1
        if any(getattr(q, "key", "") == "lora_b" for q in p)
        else x,
        merged,
    )
    out2 = lora_model.apply(
        {"params": merged2}, input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(mask),
    )
    assert np.abs(np.asarray(out2) - np.asarray(out_lora)).max() > 1e-4


def test_lora_trainable_mask_counts():
    ids, _ = _random_inputs()
    model = Qwen3Model(CFG, lora=LoRAConfig(r=4), n_extra_tokens=20)
    params = model.init(jax.random.PRNGKey(0), input_ids=jnp.asarray(ids))["params"]
    mask = lora_trainable_mask(params)
    leaves = jax.tree_util.tree_leaves_with_path(mask)
    trainable = [p for p, v in leaves if v]
    frozen = [p for p, v in leaves if not v]
    assert trainable and frozen
    names = ["/".join(str(getattr(q, "key", q)) for q in p) for p in trainable]
    assert all(
        ("lora_a" in n or "lora_b" in n or "extra_embed_tokens" in n)
        for n in names
    )


def test_causal_masking():
    ids, _ = _random_inputs(b=1, l=6)
    model = Qwen3Model(CFG)
    params = model.init(jax.random.PRNGKey(0), input_ids=jnp.asarray(ids))
    o1 = model.apply(params, input_ids=jnp.asarray(ids))
    ids2 = ids.copy()
    ids2[0, -1] = (ids2[0, -1] + 1) % CFG.vocab_size
    o2 = model.apply(params, input_ids=jnp.asarray(ids2))
    np.testing.assert_allclose(
        np.asarray(o1[0, :-1]), np.asarray(o2[0, :-1]), atol=1e-5
    )
    assert np.abs(np.asarray(o1[0, -1]) - np.asarray(o2[0, -1])).max() > 1e-4


def test_inputs_embeds_path_matches_ids():
    ids, mask = _random_inputs()
    model = Qwen3Model(CFG)
    params = model.init(jax.random.PRNGKey(0), input_ids=jnp.asarray(ids))
    embeds = model.apply(params, input_ids=jnp.asarray(ids), method_embed_only=True)
    o1 = model.apply(params, input_ids=jnp.asarray(ids),
                     attention_mask=jnp.asarray(mask))
    o2 = model.apply(params, inputs_embeds=embeds,
                     attention_mask=jnp.asarray(mask))
    np.testing.assert_allclose(np.asarray(o1), np.asarray(o2), atol=1e-6)


def test_extra_tokens_resize():
    model = Qwen3Model(CFG, n_extra_tokens=20)
    ids = np.array([[1, CFG.vocab_size, CFG.vocab_size + 19]], np.int32)
    params = model.init(jax.random.PRNGKey(0), input_ids=jnp.asarray(ids))
    out = model.apply(params, input_ids=jnp.asarray(ids))
    assert np.isfinite(np.asarray(out)).all()


def test_pooling_functions():
    hidden = jnp.asarray(np.arange(24, dtype=np.float32).reshape(2, 3, 4))
    mask = jnp.asarray([[1, 1, 0], [1, 1, 1]], jnp.float32)
    mp = mean_pool(hidden)
    np.testing.assert_allclose(np.asarray(mp[0]), hidden[0].mean(axis=0))
    mm = mean_pool(hidden, mask, masked=True)
    np.testing.assert_allclose(np.asarray(mm[0]), np.asarray(hidden[0, :2].mean(axis=0)))
    lt = last_token_pool(hidden, mask)
    np.testing.assert_allclose(np.asarray(lt[0]), np.asarray(hidden[0, 1]))
    np.testing.assert_allclose(np.asarray(lt[1]), np.asarray(hidden[1, 2]))


def test_tp_sharding_forward(eight_devices):
    """dp=4 x tp=2 mesh: forward under jit with GSPMD-propagated shardings."""
    from unirec.configs import MeshConfig
    from unirec.parallel.mesh import make_mesh

    mesh = make_mesh(MeshConfig(dp=4, tp=2))
    model = Qwen3Model(CFG)
    ids, mask = _random_inputs(b=8, l=8)
    params = model.init(jax.random.PRNGKey(0), input_ids=jnp.asarray(ids))["params"]
    out_ref = model.apply({"params": params}, input_ids=jnp.asarray(ids),
                          attention_mask=jnp.asarray(mask))

    shardings = tp_shardings(params, mesh)
    sharded_params = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, s), params, shardings
    )
    from jax.sharding import NamedSharding, PartitionSpec as P

    data_sh = NamedSharding(mesh, P("dp"))
    fwd = jax.jit(
        lambda p, i, m: model.apply({"params": p}, input_ids=i, attention_mask=m),
        in_shardings=(shardings, data_sh, data_sh),
        out_shardings=data_sh,
    )
    out = fwd(
        sharded_params,
        jax.device_put(jnp.asarray(ids), data_sh),
        jax.device_put(jnp.asarray(mask), data_sh),
    )
    np.testing.assert_allclose(np.asarray(out), np.asarray(out_ref), atol=2e-5)


def test_param_count_full_size():
    """Production config matches Qwen3-0.6B's ~0.6B params (sanity)."""
    from unirec.configs import Qwen3Config

    cfg = Qwen3Config()
    # analytic count: embed + layers*(qkvo + qknorm + mlp + 2 ln) + final norm
    d, dff = cfg.hidden_size, cfg.intermediate_size
    attn = d * cfg.q_size + d * cfg.kv_size * 2 + cfg.q_size * d + 2 * cfg.head_dim
    mlp = 3 * d * dff
    per_layer = attn + mlp + 2 * d
    total = cfg.vocab_size * d + cfg.num_hidden_layers * per_layer + d
    assert 0.55e9 < total < 0.65e9
