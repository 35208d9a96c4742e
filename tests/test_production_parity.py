"""Conversion parity at the PRODUCTION configs.

Every other parity oracle runs at toy scale; these tests instantiate the
real shapes — Qwen3-Embedding-0.6B (28 layers, GQA 16/8, head_dim 128 !=
hidden/heads, vocab 151669 + 20 resized specials; reference:
train_item_individual_token_joint.py:97-119) and CLIP ViT-L/14 (the item
image tower, reference: models/item_encoder_pure_value.py CLIP usage) —
random-init on CPU (zero-egress host), convert, and compare activations.
This is exactly where head_dim/rope/qk-norm/resize conversion bugs hide.

Heavy (0.6B fp32 x 2 frameworks): batch 1, short seq, skipped when the
host lacks the memory.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def _available_gb() -> float:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable"):
                    return int(line.split()[1]) / 1e6
    except OSError:  # pragma: no cover
        pass
    return 0.0


needs_ram = pytest.mark.skipif(
    _available_gb() < 12.0,
    reason="production-config parity needs ~12 GB free host RAM",
)


@needs_ram
def test_qwen3_0p6b_production_conversion_parity():
    """HF Qwen3 at the EXACT 0.6B config — including the +20-token embedding
    resize the joint trainer performs — converts to activations matching HF
    (batch 1, seq 8, fp32)."""
    from transformers import Qwen3Config as HFConfig, Qwen3Model as HFModel

    from unirec.configs import Qwen3Config
    from unirec.models.qwen3 import Qwen3Model
    from unirec.utils.torch_convert import convert_qwen3

    base_cfg = Qwen3Config()  # production defaults
    assert base_cfg.vocab_size == 151669 and base_cfg.num_hidden_layers == 28
    assert base_cfg.head_dim == 128  # != hidden/heads = 64: the trap

    hf_cfg = HFConfig(
        vocab_size=base_cfg.vocab_size,
        hidden_size=base_cfg.hidden_size,
        intermediate_size=base_cfg.intermediate_size,
        num_hidden_layers=base_cfg.num_hidden_layers,
        num_attention_heads=base_cfg.num_attention_heads,
        num_key_value_heads=base_cfg.num_key_value_heads,
        head_dim=base_cfg.head_dim,
        rms_norm_eps=base_cfg.rms_norm_eps,
        rope_theta=base_cfg.rope_theta,
        max_position_embeddings=base_cfg.max_position_embeddings,
        attention_bias=False,
        attn_implementation="eager",
        tie_word_embeddings=True,
    )
    torch.manual_seed(0)
    hf = HFModel(hf_cfg).eval()
    hf.resize_token_embeddings(base_cfg.vocab_size + 20)  # the 20 specials

    rng = np.random.RandomState(0)
    ids = rng.randint(0, base_cfg.vocab_size + 20, (1, 8)).astype(np.int64)
    ids[0, -3:] = base_cfg.vocab_size + np.arange(3)  # resized rows used
    mask = np.ones((1, 8), np.float32)
    with torch.no_grad():
        t_out = hf(
            input_ids=torch.tensor(ids),
            attention_mask=torch.tensor(mask),
        ).last_hidden_state.numpy()

    params = convert_qwen3(hf.state_dict(), base_cfg.num_hidden_layers)
    assert params["embed_tokens"].shape[0] == base_cfg.vocab_size + 20
    import dataclasses

    cfg = dataclasses.replace(base_cfg, vocab_size=base_cfg.vocab_size + 20)
    model = Qwen3Model(cfg)
    f_out = np.asarray(
        model.apply({"params": params}, jnp.asarray(ids.astype(np.int32)),
                    jnp.asarray(mask), deterministic=True)
    )
    assert f_out.shape == t_out.shape == (1, 8, 1024)
    # 28 fp32 layers accumulate platform noise; correlation must be ~1
    np.testing.assert_allclose(f_out, t_out, atol=5e-4, rtol=1e-3)
    c = np.corrcoef(f_out.ravel(), t_out.ravel())[0, 1]
    assert c > 0.99999

    del hf, params


@needs_ram
def test_clip_vit_l14_production_conversion_parity():
    """HF CLIP ViT-L/14 at the production config (image 224, patch 14,
    24 layers, hidden 1024) converts to matching image features."""
    from transformers import CLIPVisionConfig as HFVisionConfig
    from transformers import CLIPVisionModelWithProjection

    from unirec.models.clip import (
        CLIPVisionConfig,
        CLIPVisionTower,
        convert_clip_vision,
    )

    vc = CLIPVisionConfig()  # ViT-L/14 production defaults
    assert vc.image_size == 224 and vc.patch_size == 14
    hf_cfg = HFVisionConfig(
        hidden_size=vc.hidden_size,
        intermediate_size=vc.intermediate_size,
        num_hidden_layers=vc.num_hidden_layers,
        num_attention_heads=vc.num_attention_heads,
        image_size=vc.image_size,
        patch_size=vc.patch_size,
        projection_dim=vc.projection_dim,
    )
    torch.manual_seed(1)
    hf = CLIPVisionModelWithProjection(hf_cfg).eval()

    rng = np.random.RandomState(1)
    pix = rng.randn(1, 3, 224, 224).astype(np.float32)
    with torch.no_grad():
        t_emb = hf(pixel_values=torch.tensor(pix)).image_embeds.numpy()

    model = CLIPVisionTower(vc)
    params = {"params": convert_clip_vision(hf.state_dict(), vc)}
    f_emb = np.asarray(
        model.apply(params, jnp.asarray(pix.transpose(0, 2, 3, 1))))
    assert f_emb.shape == t_emb.shape == (1, vc.projection_dim)
    np.testing.assert_allclose(f_emb, t_emb, atol=2e-4, rtol=1e-3)
