"""Int8 catalog quantization + quantized retrieval correctness."""

import jax.numpy as jnp
import numpy as np

import pytest

from unirec.ops.quantization import (
    dequantize_rows,
    quantize_rows,
    quantized_top_k,
)
from unirec.ops.ranking import top_k_items


def test_quantize_roundtrip_error():
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(50, 64).astype(np.float32))
    q, scales = quantize_rows(x)
    assert q.dtype == jnp.int8 and scales.shape == (50,)
    deq = dequantize_rows(q, scales)
    xn = np.asarray(x) / np.linalg.norm(x, axis=1, keepdims=True)
    err = np.abs(np.asarray(deq) - xn).max()
    assert err < 1.0 / 127.0  # one quantization step


def test_quantized_ranking_matches_fp32():
    rng = np.random.RandomState(1)
    users = jnp.asarray(rng.randn(8, 64).astype(np.float32))
    catalog = jnp.asarray(rng.randn(400, 64).astype(np.float32))
    s_ref, i_ref = top_k_items(users, catalog, k=10)
    q, scales = quantize_rows(catalog)
    s_q, i_q = quantized_top_k(users, q, scales, k=10)
    # top-1 must agree; top-10 sets nearly identical
    np.testing.assert_array_equal(np.asarray(i_q[:, 0]), np.asarray(i_ref[:, 0]))
    overlap = np.mean(
        [
            len(set(np.asarray(i_q[u]).tolist())
                & set(np.asarray(i_ref[u]).tolist())) / 10.0
            for u in range(8)
        ]
    )
    assert overlap >= 0.9
    np.testing.assert_allclose(
        np.asarray(s_q), np.asarray(s_ref), atol=2e-2
    )


@pytest.mark.parametrize("k", [1, 7, 32])
def test_quantized_top_k_matches_numpy_reference(k):
    """Scores and order equal a float64 numpy scan of the dequantized
    catalog against the normalized users."""
    rng = np.random.RandomState(2)
    users = rng.randn(10, 32).astype(np.float32)
    catalog = jnp.asarray(rng.randn(300, 32).astype(np.float32))
    q, scales = quantize_rows(catalog)
    s_q, i_q = quantized_top_k(jnp.asarray(users), q, scales, k=k)
    deq = np.asarray(q, np.float64) * np.asarray(scales, np.float64)[:, None]
    un = users / np.linalg.norm(users, axis=1, keepdims=True)
    want = un @ deq.T
    order = np.argsort(-want, axis=1, kind="stable")[:, :k]
    np.testing.assert_allclose(
        np.asarray(s_q), np.take_along_axis(want, order, 1), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(i_q), order)


@pytest.mark.parametrize("m,k,n", [(512, 256, 512), (7, 64, 33)])
def test_int8_linear_matches_numpy_oracle(m, k, n):
    """The W8A8 projection (ops/int8_ste, an int8 x int8 -> int32 XLA dot)
    computes the quantized matmul of a float64 numpy oracle."""
    from unirec.ops.int8_ste import int8_linear_ste

    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(m, k).astype(np.float32) * 3.0)
    w = rng.randn(k, n).astype(np.float32) * 0.05
    col = np.maximum(np.abs(w).max(axis=0, keepdims=True), 1e-8)
    ks = (col / 127.0).astype(np.float32)
    kq = np.clip(np.round(w / ks), -127, 127).astype(np.int8)

    got = int8_linear_ste(x, jnp.asarray(kq), jnp.asarray(ks.reshape(-1)))

    x32 = np.asarray(x, np.float64)
    absmax = np.maximum(np.abs(x32).max(axis=-1, keepdims=True), 1e-6)
    rs = absmax / 127.0
    xq = np.clip(np.round(x32 / rs), -127, 127).astype(np.int32)
    want = (xq @ kq.astype(np.int32)) * rs * ks
    # quantization-bucket ties can flip one int8 level between float32 and
    # the oracle's float64 divide; bound by one level per term
    level = rs * ks  # per (row, col) magnitude of one int8 step
    err = np.abs(np.asarray(got, np.float64) - want)
    assert (err <= 130 * level + 1e-6).all()
    c = np.corrcoef(np.asarray(got).ravel(), want.ravel())[0, 1]
    assert c > 0.9999


def test_int8_ste_forward_and_gradient():
    """ops/int8_ste.int8_linear_ste: forward equals the inference int8
    formula exactly; backward is the straight-through gradient through the
    dequantized weight (dx = g @ (kq*ks)^T), with no weight tangent."""
    import jax
    import jax.numpy as jnp

    from unirec.ops.int8_ste import _fwd_math, int8_linear_ste

    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(4, 8).astype(np.float32))
    w = rng.randn(8, 6).astype(np.float32) * 0.1
    col = np.maximum(np.abs(w).max(axis=0), 1e-8)
    ks = jnp.asarray((col / 127.0).astype(np.float32))
    kq = jnp.asarray(
        np.clip(np.round(w / (col / 127.0)), -127, 127).astype(np.int8))

    y = int8_linear_ste(x, kq, ks)
    np.testing.assert_array_equal(np.asarray(y),
                                  np.asarray(_fwd_math(x, kq, ks)))

    g = jnp.asarray(rng.randn(4, 6).astype(np.float32))
    dx = jax.grad(lambda x: (int8_linear_ste(x, kq, ks) * g).sum())(x)
    w_eff = np.asarray(kq, np.float32) * np.asarray(ks)[None, :]
    np.testing.assert_allclose(
        np.asarray(dx), np.asarray(g) @ w_eff.T, atol=1e-6)
