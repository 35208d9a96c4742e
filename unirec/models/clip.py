"""CLIP vision + text towers in Flax.

JAX replacement for the HF ``openai/clip-vit-large-patch14`` image
encoder the reference loads for image fields
(reference: models/item_encoder_pure_value.py:53-61) and the ViT-base CLIP
used by the candidate-embedding stage
(reference: data_processing/item_embedding_clip.py:56-58).

Architecture (OpenAI CLIP): pre-LN transformer, quick-GELU activation,
class-token vision pooling, causal text attention pooled at the EOT token,
linear projections without bias into the shared space.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

from unirec import nn
import jax
import jax.numpy as jnp
import numpy as np

Dtype = Any


@dataclass(frozen=True)
class CLIPVisionConfig:
    """Defaults: ViT-L/14 (the item-encoder tower)."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5
    # HF pools at the first eos_token_id position; eos_token_id=None falls
    # back to the original OpenAI argmax-of-ids convention.
    eos_token_id: Optional[int] = 49407


def quick_gelu(x: jax.Array) -> jax.Array:
    return x * jax.nn.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    hidden_size: int
    num_heads: int
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array, bias: Optional[jax.Array] = None) -> jax.Array:
        h = self.num_heads
        hd = self.hidden_size // h
        b, l, _ = x.shape
        q = nn.Dense(self.hidden_size, name="q_proj", dtype=self.dtype)(x)
        k = nn.Dense(self.hidden_size, name="k_proj", dtype=self.dtype)(x)
        v = nn.Dense(self.hidden_size, name="v_proj", dtype=self.dtype)(x)
        q = q.reshape(b, l, h, hd).transpose(0, 2, 1, 3)
        k = k.reshape(b, l, h, hd).transpose(0, 2, 1, 3)
        v = v.reshape(b, l, h, hd).transpose(0, 2, 1, 3)
        scores = jnp.einsum(
            "bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32
        ) / np.sqrt(hd)
        if bias is not None:
            scores = scores + bias.astype(jnp.float32)
        probs = jax.nn.softmax(scores, axis=-1).astype(self.dtype)
        ctx = jnp.einsum("bhqk,bhkd->bhqd", probs, v,
                         preferred_element_type=jnp.float32).astype(self.dtype)
        ctx = ctx.transpose(0, 2, 1, 3).reshape(b, l, self.hidden_size)
        return nn.Dense(self.hidden_size, name="out_proj", dtype=self.dtype)(ctx)


class CLIPEncoderLayer(nn.Module):
    hidden_size: int
    intermediate_size: int
    num_heads: int
    eps: float
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array, bias: Optional[jax.Array] = None) -> jax.Array:
        h = nn.LayerNorm(epsilon=self.eps, name="layer_norm1", dtype=self.dtype)(x)
        x = x + CLIPAttention(
            self.hidden_size, self.num_heads, name="self_attn", dtype=self.dtype
        )(h, bias)
        h = nn.LayerNorm(epsilon=self.eps, name="layer_norm2", dtype=self.dtype)(x)
        h = nn.Dense(self.intermediate_size, name="fc1", dtype=self.dtype)(h)
        h = quick_gelu(h)
        h = nn.Dense(self.hidden_size, name="fc2", dtype=self.dtype)(h)
        return x + h


class CLIPVisionTower(nn.Module):
    """pixel_values [B, H, W, 3] -> projected image embeddings
    [B, projection_dim] (matches HF ``get_image_features``)."""

    config: CLIPVisionConfig
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, pixel_values: jax.Array) -> jax.Array:
        cfg = self.config
        b = pixel_values.shape[0]
        patches = nn.Conv(
            cfg.hidden_size,
            kernel_size=(cfg.patch_size, cfg.patch_size),
            strides=(cfg.patch_size, cfg.patch_size),
            use_bias=False,
            name="patch_embedding",
            dtype=self.dtype,
        )(pixel_values.astype(self.dtype))
        patches = patches.reshape(b, -1, cfg.hidden_size)

        class_embedding = self.param(
            "class_embedding", nn.initializers.normal(0.02), (cfg.hidden_size,)
        )
        cls = jnp.broadcast_to(
            class_embedding.astype(self.dtype), (b, 1, cfg.hidden_size)
        )
        x = jnp.concatenate([cls, patches], axis=1)

        pos = self.param(
            "position_embedding",
            nn.initializers.normal(0.02),
            (cfg.num_patches + 1, cfg.hidden_size),
        )
        x = x + pos[None].astype(self.dtype)
        x = nn.LayerNorm(epsilon=cfg.layer_norm_eps, name="pre_layrnorm",
                         dtype=self.dtype)(x)
        for i in range(cfg.num_hidden_layers):
            x = CLIPEncoderLayer(
                cfg.hidden_size, cfg.intermediate_size, cfg.num_attention_heads,
                cfg.layer_norm_eps, name=f"layer_{i}", dtype=self.dtype,
            )(x)
        pooled = nn.LayerNorm(
            epsilon=cfg.layer_norm_eps, name="post_layernorm", dtype=self.dtype
        )(x[:, 0])
        return nn.Dense(
            cfg.projection_dim, use_bias=False, name="visual_projection",
            dtype=self.dtype,
        )(pooled)


class CLIPTextTower(nn.Module):
    """input_ids [B, L] -> projected text embeddings [B, projection_dim]
    (causal attention, pooled at each sequence's EOT = argmax token id)."""

    config: CLIPTextConfig
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self, input_ids: jax.Array, attention_mask: Optional[jax.Array] = None
    ) -> jax.Array:
        cfg = self.config
        b, l = input_ids.shape
        tok = nn.Embed(cfg.vocab_size, cfg.hidden_size, name="token_embedding",
                       dtype=self.dtype)(input_ids)
        pos = self.param(
            "position_embedding",
            nn.initializers.normal(0.02),
            (cfg.max_position_embeddings, cfg.hidden_size),
        )
        x = tok + pos[None, :l].astype(self.dtype)

        causal = jnp.tril(jnp.ones((l, l), jnp.float32))[None, None]
        if attention_mask is not None:
            causal = causal * attention_mask.astype(jnp.float32)[:, None, None, :]
        bias = (1.0 - causal) * -1e9

        for i in range(cfg.num_hidden_layers):
            x = CLIPEncoderLayer(
                cfg.hidden_size, cfg.intermediate_size, cfg.num_attention_heads,
                cfg.layer_norm_eps, name=f"layer_{i}", dtype=self.dtype,
            )(x, bias)
        x = nn.LayerNorm(epsilon=cfg.layer_norm_eps, name="final_layer_norm",
                         dtype=self.dtype)(x)
        if cfg.eos_token_id is not None:
            # first eos position (HF convention)
            eot = jnp.argmax(
                (input_ids == cfg.eos_token_id).astype(jnp.int32), axis=-1
            )
        else:
            # highest token id position (original OpenAI convention)
            eot = jnp.argmax(input_ids, axis=-1)
        pooled = x[jnp.arange(b), eot]
        return nn.Dense(
            cfg.projection_dim, use_bias=False, name="text_projection",
            dtype=self.dtype,
        )(pooled)


# ---------------------------------------------------------------------------
# Image preprocessing (host-side; CLIPProcessor equivalent)
# ---------------------------------------------------------------------------

CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_image(image, image_size: int = 224) -> np.ndarray:
    """PIL image -> [H, W, 3] float32 (resize shortest side, center crop,
    CLIP normalize)."""
    from PIL import Image

    w, h = image.size
    scale = image_size / min(w, h)
    image = image.resize(
        (max(1, round(w * scale)), max(1, round(h * scale))), Image.BICUBIC
    )
    w, h = image.size
    left = (w - image_size) // 2
    top = (h - image_size) // 2
    image = image.crop((left, top, left + image_size, top + image_size))
    arr = np.asarray(image.convert("RGB"), np.float32) / 255.0
    return (arr - CLIP_IMAGE_MEAN) / CLIP_IMAGE_STD


# ---------------------------------------------------------------------------
# HF weight conversion
# ---------------------------------------------------------------------------


def _np(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def convert_clip_vision(sd: Mapping[str, Any], config: CLIPVisionConfig) -> Dict:
    """HF CLIPModel (or CLIPVisionModelWithProjection) state_dict -> params."""
    def get(k: str):
        for prefix in ("vision_model.", "clip.vision_model.", ""):
            kk = prefix + k
            if kk in sd:
                return _np(sd[kk])
        raise KeyError(k)

    def lin(prefix: str) -> Dict:
        out = {"kernel": get(prefix + ".weight").T}
        try:
            out["bias"] = get(prefix + ".bias")
        except KeyError:
            pass
        return out

    def ln(prefix: str) -> Dict:
        return {"scale": get(prefix + ".weight"), "bias": get(prefix + ".bias")}

    params: Dict[str, Any] = {
        # HF conv weight [out, in, kh, kw] -> flax [kh, kw, in, out]
        "patch_embedding": {
            "kernel": get("embeddings.patch_embedding.weight").transpose(2, 3, 1, 0)
        },
        "class_embedding": get("embeddings.class_embedding"),
        "position_embedding": get("embeddings.position_embedding.weight"),
        "pre_layrnorm": ln("pre_layrnorm"),
        "post_layernorm": ln("post_layernorm"),
    }
    if "visual_projection.weight" in sd:
        params["visual_projection"] = {
            "kernel": _np(sd["visual_projection.weight"]).T
        }
    for i in range(config.num_hidden_layers):
        lp = f"encoder.layers.{i}"
        params[f"layer_{i}"] = {
            "self_attn": {
                "q_proj": lin(f"{lp}.self_attn.q_proj"),
                "k_proj": lin(f"{lp}.self_attn.k_proj"),
                "v_proj": lin(f"{lp}.self_attn.v_proj"),
                "out_proj": lin(f"{lp}.self_attn.out_proj"),
            },
            "layer_norm1": ln(f"{lp}.layer_norm1"),
            "layer_norm2": ln(f"{lp}.layer_norm2"),
            "fc1": lin(f"{lp}.mlp.fc1"),
            "fc2": lin(f"{lp}.mlp.fc2"),
        }
    return params


def convert_clip_text(sd: Mapping[str, Any], config: CLIPTextConfig) -> Dict:
    def get(k: str):
        for prefix in ("text_model.", ""):
            kk = prefix + k
            if kk in sd:
                return _np(sd[kk])
        raise KeyError(k)

    def lin(prefix: str) -> Dict:
        out = {"kernel": get(prefix + ".weight").T}
        try:
            out["bias"] = get(prefix + ".bias")
        except KeyError:
            pass
        return out

    def ln(prefix: str) -> Dict:
        return {"scale": get(prefix + ".weight"), "bias": get(prefix + ".bias")}

    params: Dict[str, Any] = {
        "token_embedding": {"embedding": get("embeddings.token_embedding.weight")},
        "position_embedding": get("embeddings.position_embedding.weight"),
        "final_layer_norm": ln("final_layer_norm"),
    }
    if "text_projection.weight" in sd:
        params["text_projection"] = {"kernel": _np(sd["text_projection.weight"]).T}
    for i in range(config.num_hidden_layers):
        lp = f"encoder.layers.{i}"
        params[f"layer_{i}"] = {
            "self_attn": {
                "q_proj": lin(f"{lp}.self_attn.q_proj"),
                "k_proj": lin(f"{lp}.self_attn.k_proj"),
                "v_proj": lin(f"{lp}.self_attn.v_proj"),
                "out_proj": lin(f"{lp}.self_attn.out_proj"),
            },
            "layer_norm1": ln(f"{lp}.layer_norm1"),
            "layer_norm2": ln(f"{lp}.layer_norm2"),
            "fc1": lin(f"{lp}.mlp.fc1"),
            "fc2": lin(f"{lp}.mlp.fc2"),
        }
    return params
