"""Qwen3 dense decoder (embedding backbone) in Flax, with LoRA overlays.

JAX replacement for the HF ``AutoModel("Qwen/Qwen3-Embedding-0.6B")``
backbone of the joint model (reference:
training/train_item_individual_token_joint.py:97-103).  Architecture per the
Qwen3 family: pre-RMSNorm, grouped-query attention with per-head q/k RMSNorm,
rotary embeddings (theta 1e6), SwiGLU MLP, tied word embeddings.

Design choices:

* accepts ``inputs_embeds`` directly — the joint model injects Q-Former query
  tokens into the embedding table output before the decoder stack
  (reference :173-177) — and everything is fixed-shape for one jit trace;
* LoRA lives in the same param tree as ``lora_a``/``lora_b`` leaves wrapping
  the frozen base kernels (reference LoRA config r=16, alpha=32, on
  q/k/v/o/gate/up/down — :721-731); trainability is decided at the optimizer
  by path filtering (utils/params.lora_trainable_mask);
* tensor parallelism is applied from outside via ``tp_shardings`` — a
  PartitionSpec tree matched by parameter path (attention heads and MLP
  hidden sharded over the ``tp`` mesh axis); under jit, GSPMD propagates the
  shardings and inserts the all-reduces.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from unirec import nn
import jax
import jax.numpy as jnp
import numpy as np

from unirec.configs import LoRAConfig, Qwen3Config

Dtype = Any


class RMSNorm(nn.Module):
    dim: int
    eps: float = 1e-6
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        scale = self.param("scale", nn.initializers.ones, (self.dim,))
        var = jnp.mean(jnp.square(x.astype(jnp.float32)), axis=-1, keepdims=True)
        y = x.astype(jnp.float32) * jax.lax.rsqrt(var + self.eps)
        return (y * scale).astype(self.dtype)


def rotary_embedding(
    positions: jax.Array, head_dim: int, theta: float, dtype=jnp.float32
):
    """[B, L] positions -> (cos, sin) each [B, L, head_dim]."""
    inv_freq = 1.0 / (
        theta ** (jnp.arange(0, head_dim, 2, dtype=jnp.float32) / head_dim)
    )
    freqs = positions.astype(jnp.float32)[..., None] * inv_freq[None, None, :]
    emb = jnp.concatenate([freqs, freqs], axis=-1)
    return jnp.cos(emb).astype(dtype), jnp.sin(emb).astype(dtype)


def apply_rope(x: jax.Array, cos: jax.Array, sin: jax.Array) -> jax.Array:
    """x: [B, L, H, hd]; cos/sin: [B, L, hd] (HF rotate-half convention)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = jnp.concatenate([-x2, x1], axis=-1)
    return x * cos[:, :, None, :] + rotated * sin[:, :, None, :]


class LoRADense(nn.Module):
    """Dense with optional LoRA overlay: y = x W + (x A) B * (alpha/r).

    The base ``kernel`` follows HF layout after conversion; ``lora_a``/``b``
    initialize to (normal, zeros) so the overlay starts as identity.
    """

    features: int
    use_bias: bool = False
    lora: Optional[LoRAConfig] = None
    lora_enabled: bool = False
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        x: jax.Array,
        deterministic: bool = True,
        lora_mid: Optional[jax.Array] = None,
    ) -> jax.Array:
        in_dim = x.shape[-1]
        kernel = self.param(
            "kernel",
            nn.initializers.normal(stddev=0.02),
            (in_dim, self.features),
        )
        if self.has_variable("qweights", "kernel_q"):
            # int8 W8A8 path (serving opt-in): pre-quantized int8 weights,
            # activations quantized per row at trace time, an int8 x int8
            # -> int32 dot.  Provide the collection via
            # quantize_qwen3_weights + apply({"params": p, "qweights": qw}).
            # The custom-VJP STE backward makes the quantized base
            # trainable-around (QLoRA-style --int8-base joint training).
            kq = self.get_variable("qweights", "kernel_q")
            ks = self.get_variable("qweights", "kernel_scale")  # [features]
            from unirec.ops.int8_ste import int8_linear_ste

            y = int8_linear_ste(
                x.astype(self.dtype), kq, ks.reshape(-1)
            ).astype(self.dtype)
        else:
            y = jnp.dot(x, kernel.astype(self.dtype))
        if self.use_bias:
            bias = self.param("bias", nn.initializers.zeros, (self.features,))
            y = y + bias.astype(self.dtype)
        if self.lora_enabled and self.lora is not None:
            r = self.lora.r
            lora_a = self.param(
                "lora_a", nn.initializers.normal(stddev=1.0 / r), (in_dim, r)
            )
            lora_b = self.param("lora_b", nn.initializers.zeros, (r, self.features))
            if lora_mid is not None:
                # Grouped overlay (LoRAConfig.grouped): the parent already
                # computed drop(h) @ [lora_a of the whole group] in one
                # matmul and passes this module's [.., r] slice; lora_a
                # above is the SAME traced leaf the parent read via
                # .variables, so its gradient flows through the parent's
                # concat — this branch must not touch x at all.
                y = y + jnp.dot(lora_mid, lora_b.astype(self.dtype)
                                ) * self.lora.scaling
            else:
                h = x
                if self.lora.dropout > 0.0 and not deterministic:
                    h = nn.Dropout(self.lora.dropout)(h, deterministic=False)
                y = y + jnp.dot(jnp.dot(h, lora_a.astype(self.dtype)),
                                lora_b.astype(self.dtype)) * self.lora.scaling
        return y


class Qwen3Attention(nn.Module):
    config: Qwen3Config
    lora: Optional[LoRAConfig] = None
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        hidden: jax.Array,  # [B, L, D]
        bias: Optional[jax.Array],  # additive [B, 1, L, L]
        cos: jax.Array,
        sin: jax.Array,
        deterministic: bool = True,
    ) -> jax.Array:
        cfg = self.config
        lora_on = lambda name: self.lora is not None and name in (
            self.lora.target_modules
        )
        b, l, _ = hidden.shape
        hq, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

        q_mod = LoRADense(cfg.q_size, use_bias=cfg.attention_bias,
                          lora=self.lora, lora_enabled=lora_on("q_proj"),
                          name="q_proj", dtype=self.dtype)
        k_mod = LoRADense(cfg.kv_size, use_bias=cfg.attention_bias,
                          lora=self.lora, lora_enabled=lora_on("k_proj"),
                          name="k_proj", dtype=self.dtype)
        v_mod = LoRADense(cfg.kv_size, use_bias=cfg.attention_bias,
                          lora=self.lora, lora_enabled=lora_on("v_proj"),
                          name="v_proj", dtype=self.dtype)

        q_mid = k_mid = v_mid = None
        if (
            self.lora is not None and self.lora.grouped
            and lora_on("q_proj") and lora_on("k_proj")
            and lora_on("v_proj")
        ):
            # Grouped overlay (LoRAConfig.grouped): q/k/v share their
            # input, so ONE dropout draw and ONE [D, 3r] lora_a matmul
            # replace three of each — hidden is read once per group fwd
            # and once for dW_a bwd.  Params are bound by DCE'd 1-token
            # calls; the concat reads the modules' own lora_a leaves, so
            # grads flow unchanged.
            for m in (q_mod, k_mod, v_mod):
                m(hidden[:, :1, :], True)  # bind params; DCE'd
            a_cat = jnp.concatenate(
                [m.variables["params"]["lora_a"]
                 for m in (q_mod, k_mod, v_mod)], axis=1)
            h = hidden
            if self.lora.dropout > 0.0 and not deterministic:
                h = nn.Dropout(self.lora.dropout)(h, deterministic=False)
            mid = jnp.dot(h, a_cat.astype(self.dtype))
            r = self.lora.r
            q_mid, k_mid, v_mid = (
                mid[..., :r], mid[..., r:2 * r], mid[..., 2 * r:])
        q = q_mod(hidden, deterministic, lora_mid=q_mid)
        k = k_mod(hidden, deterministic, lora_mid=k_mid)
        v = v_mod(hidden, deterministic, lora_mid=v_mid)

        q = q.reshape(b, l, hq, hd)
        k = k.reshape(b, l, hkv, hd)
        v = v.reshape(b, l, hkv, hd)

        # Qwen3 per-head q/k RMSNorm (over head_dim)
        q = RMSNorm(hd, cfg.rms_norm_eps, name="q_norm", dtype=self.dtype)(q)
        k = RMSNorm(hd, cfg.rms_norm_eps, name="k_norm", dtype=self.dtype)(k)

        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        # GQA: repeat kv heads
        groups = hq // hkv
        k = jnp.repeat(k, groups, axis=2)
        v = jnp.repeat(v, groups, axis=2)

        q = q.transpose(0, 2, 1, 3)  # [B, H, L, hd]
        k = k.transpose(0, 2, 1, 3)
        v = v.transpose(0, 2, 1, 3)

        scale = 1.0 / jnp.sqrt(jnp.asarray(hd, jnp.float32))
        scores = jnp.einsum(
            "bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32
        ) * scale
        if bias is not None:
            scores = scores + bias.astype(jnp.float32)
        probs = jax.nn.softmax(scores, axis=-1).astype(self.dtype)
        ctx = jnp.einsum(
            "bhqk,bhkd->bhqd", probs, v, preferred_element_type=jnp.float32
        ).astype(self.dtype)
        ctx = ctx.transpose(0, 2, 1, 3).reshape(b, l, hq * hd)

        return LoRADense(cfg.hidden_size, lora=self.lora,
                         lora_enabled=lora_on("o_proj"), name="o_proj",
                         dtype=self.dtype)(ctx, deterministic)


class Qwen3MLP(nn.Module):
    config: Qwen3Config
    lora: Optional[LoRAConfig] = None
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array, deterministic: bool = True) -> jax.Array:
        cfg = self.config
        lora_on = lambda name: self.lora is not None and name in (
            self.lora.target_modules
        )
        gate_mod = LoRADense(cfg.intermediate_size, lora=self.lora,
                             lora_enabled=lora_on("gate_proj"),
                             name="gate_proj", dtype=self.dtype)
        up_mod = LoRADense(cfg.intermediate_size, lora=self.lora,
                           lora_enabled=lora_on("up_proj"), name="up_proj",
                           dtype=self.dtype)
        down_mod = LoRADense(cfg.hidden_size, lora=self.lora,
                             lora_enabled=lora_on("down_proj"),
                             name="down_proj", dtype=self.dtype)

        g_mid = u_mid = None
        if (
            self.lora is not None and self.lora.grouped
            and lora_on("gate_proj") and lora_on("up_proj")
        ):
            # Grouped overlay: gate/up share x — one dropout draw, one
            # [D, 2r] lora_a matmul (see Qwen3Attention's q/k/v group).
            for m in (gate_mod, up_mod):
                m(x[:, :1, :], True)  # bind params; DCE'd
            a_cat = jnp.concatenate(
                [m.variables["params"]["lora_a"]
                 for m in (gate_mod, up_mod)], axis=1)
            hdrop = x
            if self.lora.dropout > 0.0 and not deterministic:
                hdrop = nn.Dropout(self.lora.dropout)(
                    hdrop, deterministic=False)
            mid = jnp.dot(hdrop, a_cat.astype(self.dtype))
            r = self.lora.r
            g_mid, u_mid = mid[..., :r], mid[..., r:]
        gate = gate_mod(x, deterministic, lora_mid=g_mid)
        up = up_mod(x, deterministic, lora_mid=u_mid)
        h = nn.silu(gate) * up
        return down_mod(h, deterministic)


def causal_bias(attention_mask: Optional[jax.Array], length: int) -> jax.Array:
    """Causal + key-padding additive bias [B or 1, 1, L, L]."""
    allowed = jnp.tril(jnp.ones((length, length), jnp.float32))[None, None]
    if attention_mask is not None:
        allowed = allowed * attention_mask.astype(jnp.float32)[:, None, None, :]
    return (1.0 - allowed) * -1e9


class Qwen3Layer(nn.Module):
    config: Qwen3Config
    lora: Optional[LoRAConfig] = None
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, hidden, bias, cos, sin, deterministic=True):
        cfg = self.config
        h = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                    name="input_layernorm", dtype=self.dtype)(hidden)
        hidden = hidden + Qwen3Attention(
            cfg, self.lora, name="self_attn", dtype=self.dtype
        )(h, bias, cos, sin, deterministic)
        h = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                    name="post_attention_layernorm", dtype=self.dtype)(hidden)
        hidden = hidden + Qwen3MLP(cfg, self.lora, name="mlp", dtype=self.dtype)(
            h, deterministic
        )
        return hidden


class Qwen3Model(nn.Module):
    """Decoder stack -> final-norm hidden states [B, L, D].

    Supports extended vocabularies: ``extra_embeddings`` adds ``n_extra`` rows
    appended after the base vocab (the reference resizes the embedding table
    for 20 history special tokens, train_item_individual_token_joint.py:118-119).
    """

    config: Qwen3Config
    lora: Optional[LoRAConfig] = None
    n_extra_tokens: int = 0
    dtype: Dtype = jnp.float32
    remat: bool = False
    # optional jax.checkpoint policy (e.g. dots_with_no_batch_dims_saveable:
    # keep GEMM outputs, recompute only elementwise — much cheaper backward)
    remat_policy: Any = None

    @nn.compact
    def __call__(
        self,
        input_ids: Optional[jax.Array] = None,
        attention_mask: Optional[jax.Array] = None,
        inputs_embeds: Optional[jax.Array] = None,
        position_ids: Optional[jax.Array] = None,
        deterministic: bool = True,
        method_embed_only: bool = False,
    ) -> jax.Array:
        cfg = self.config

        embed_table = self.param(
            "embed_tokens",
            nn.initializers.normal(stddev=0.02),
            (cfg.vocab_size, cfg.hidden_size),
        )
        if self.n_extra_tokens > 0:
            extra = self.param(
                "extra_embed_tokens",
                nn.initializers.normal(stddev=0.02),
                (self.n_extra_tokens, cfg.hidden_size),
            )
            full_table = jnp.concatenate(
                [embed_table.astype(self.dtype), extra.astype(self.dtype)], axis=0
            )
        else:
            full_table = embed_table.astype(self.dtype)

        if inputs_embeds is None:
            if input_ids is None:
                raise ValueError("need input_ids or inputs_embeds")
            inputs_embeds = jnp.take(full_table, input_ids, axis=0)

        if method_embed_only:
            return inputs_embeds

        b, l, _ = inputs_embeds.shape
        if position_ids is None:
            position_ids = jnp.arange(l)[None, :].repeat(b, axis=0)
        cos, sin = rotary_embedding(
            position_ids, cfg.head_dim, cfg.rope_theta, dtype=self.dtype
        )

        bias = causal_bias(attention_mask, l)

        hidden = inputs_embeds.astype(self.dtype)
        layer_cls = Qwen3Layer
        if self.remat:
            layer_cls = nn.remat(
                Qwen3Layer, static_argnums=(5,), policy=self.remat_policy
            )
        for i in range(cfg.num_hidden_layers):
            hidden = layer_cls(
                cfg, self.lora, name=f"layers_{i}", dtype=self.dtype
            )(hidden, bias, cos, sin, deterministic)

        return RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, name="norm",
                       dtype=self.dtype)(hidden)


# ---------------------------------------------------------------------------
# Pooling (reference: train_item_individual_token_joint.py:37-44, 179-181)
# ---------------------------------------------------------------------------


def mean_pool(hidden: jax.Array, attention_mask: Optional[jax.Array] = None,
              masked: bool = False) -> jax.Array:
    """Reference joint model pools the unmasked mean over ALL positions
    (:180); masked=True gives the (flagged-but-better) masked mean
    (SURVEY.md §7.1.5)."""
    if masked and attention_mask is not None:
        m = attention_mask.astype(hidden.dtype)[..., None]
        return (hidden * m).sum(axis=1) / jnp.maximum(m.sum(axis=1), 1.0)
    return hidden.mean(axis=1)


def last_token_pool(hidden: jax.Array, attention_mask: jax.Array) -> jax.Array:
    """Last non-padding position (reference :37-44, right-padding branch)."""
    lengths = attention_mask.sum(axis=1).astype(jnp.int32) - 1
    return hidden[jnp.arange(hidden.shape[0]), lengths]


# ---------------------------------------------------------------------------
# Tensor-parallel sharding rules (megatron-style column/row split)
# ---------------------------------------------------------------------------


def tp_spec_for_path(names, ndim: int):
    """Megatron-style PartitionSpec for a Qwen3 parameter path.

    Column-parallel (shard output dim over 'tp'): q/k/v/gate/up kernels and
    their lora_b.  Row-parallel (shard input dim): o/down kernels and their
    lora_a.  Everything else replicated.  Works on any path that embeds the
    module names — params, optimizer mu/nu, etc.
    """
    from jax.sharding import PartitionSpec as P

    names = [getattr(p, "key", getattr(p, "name", str(p))) for p in names]
    joined = "/".join(str(n) for n in names)
    leaf = str(names[-1]) if names else ""
    if ndim != 2:
        return P()
    col = any(m in joined for m in ("q_proj", "k_proj", "v_proj",
                                     "gate_proj", "up_proj"))
    row = any(m in joined for m in ("o_proj", "down_proj"))
    if leaf == "kernel":
        if col:
            return P(None, "tp")
        if row:
            return P("tp", None)
    if leaf == "lora_b" and col:
        return P(None, "tp")
    if leaf == "lora_a" and row:
        return P("tp", None)
    return P()


def tp_shardings(params: Dict, mesh) -> Dict:
    """NamedSharding tree for Qwen3 params: attention heads + MLP hidden
    sharded over the 'tp' axis; everything else replicated.  Apply with
    jax.device_put / jit in_shardings; GSPMD inserts the all-reduces."""
    from jax.sharding import NamedSharding

    return jax.tree_util.tree_map_with_path(
        lambda path, x: NamedSharding(
            mesh, tp_spec_for_path(path, np.ndim(x))
        ),
        params,
    )


# int8 (W8A8) serving path ---------------------------------------------------

_INT8_DENSE_NAMES = frozenset(
    {"q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
     "down_proj"}
)


def quantize_qwen3_weights(params: Dict) -> Dict:
    """Param tree -> ``qweights`` collection for int8 inference.

    Quantizes every Qwen3 projection kernel (q/k/v/o/gate/up/down — the
    FLOP-dominant GEMMs) per output channel to int8; LoRA overlays, norms,
    and embeddings stay at full precision.  Pass the result as a second
    collection: ``model.apply({"params": p, "qweights": qw}, ...)`` —
    LoRADense detects it and runs the int8 matmul.  The frozen base gets
    straight-through gradients only (ops/int8_ste.py).
    """
    def walk(tree: Dict) -> Dict:
        out = {}
        for k, v in tree.items():
            if not isinstance(v, dict):
                continue
            if (
                k in _INT8_DENSE_NAMES
                and "kernel" in v
                and np.ndim(v["kernel"]) == 2
            ):
                w = jnp.asarray(v["kernel"], jnp.float32)
                cmax = jnp.maximum(jnp.max(jnp.abs(w), axis=0), 1e-8)
                scale = cmax / 127.0
                q = jnp.clip(jnp.round(w / scale), -127, 127).astype(jnp.int8)
                out[k] = {"kernel_q": q, "kernel_scale": scale}
            else:
                sub = walk(v)
                if sub:
                    out[k] = sub
        return out

    return walk(params.get("params", params))
