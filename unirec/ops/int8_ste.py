"""Differentiable W8A8 linear for FROZEN weights (QLoRA-style training).

The serving int8 path (``models/qwen3.LoRADense``) quantizes activations
with round/clip — zero gradient almost everywhere,
so it could never sit in a training graph.  This op makes the quantized
matmul trainable the standard QAT way: the forward runs the EXACT int8
math (per-row activation absmax quant, int8 x int8 dot with int32
accumulation, per-row x per-column dequant — identical numerics to the
inference path), and the backward applies the straight-through estimator:

    dx = g @ (kq * ks)^T

i.e. the gradient of the linear map through the DEQUANTIZED weight
matrix, treating quantize∘dequantize of the activation as identity.  The
weights are frozen (LoRA adapts around them — the QLoRA recipe at W8A8
instead of nf4), so no dW is produced.

Used by the joint trainer's ``--int8-base`` mode: the frozen Qwen3-0.6B
base runs its seven projections per layer as int8 dots while LoRA/Q-Former
stay bf16/fp32 exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _fwd_math(x: jax.Array, kq: jax.Array, ks: jax.Array) -> jax.Array:
    """The inference int8 formula (same as LoRADense's qweights path)."""
    x32 = x.astype(jnp.float32)
    absmax = jnp.maximum(jnp.max(jnp.abs(x32), axis=-1, keepdims=True), 1e-6)
    rs = absmax / 127.0
    xq = jnp.clip(jnp.round(x32 / rs), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(
        xq, kq, (((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return (
        acc.astype(jnp.float32) * rs * ks.reshape(1, -1).astype(jnp.float32)
    ).astype(x.dtype)


@jax.custom_vjp
def int8_linear_ste(x: jax.Array, kq: jax.Array, ks: jax.Array) -> jax.Array:
    """y = dequant(quant(x) @ kq) — differentiable in x via STE."""
    return _fwd_math(x, kq, ks)


def _ste_fwd(x, kq, ks):
    return _fwd_math(x, kq, ks), (kq, ks)


def _ste_bwd(res, g):
    kq, ks = res
    # dx through the dequantized weight: W_eff[k, n] = kq[k, n] * ks[n];
    # contract g's feature axis with W_eff's — XLA fuses the cast+scale
    # into the matmul epilogue
    w_eff = kq.astype(g.dtype) * ks.reshape(1, -1).astype(g.dtype)
    dx = jax.lax.dot_general(
        g, w_eff, (((g.ndim - 1,), (1,)), ((), ())),
    )
    return (
        dx,
        np.zeros(kq.shape, dtype=jax.dtypes.float0),  # int8: no tangent
        jnp.zeros_like(ks),
    )


int8_linear_ste.defvjp(_ste_fwd, _ste_bwd)
