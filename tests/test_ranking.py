"""Ranking ops: rank computation, metrics, full-catalog retrieval."""

import jax.numpy as jnp
import numpy as np
import pytest

from unirec.ops.losses import info_nce_loss
from unirec.ops.ranking import (
    rank_of_positive,
    ranking_metrics,
    top_k_items,
)


def _embed(vals):
    return jnp.asarray(np.array(vals, np.float32))


def test_rank_of_positive_exact():
    user = _embed([[1.0, 0.0]])
    pos = _embed([[1.0, 0.0]])  # sim 1.0
    negs = _embed([[[0.9, 0.1], [0.0, 1.0], [-1.0, 0.0]]])  # sims < 1
    ranks = rank_of_positive(user, pos, negs)
    assert int(ranks[0]) == 1

    pos2 = _embed([[0.0, 1.0]])  # sim 0; neg sims ~ [0.995, 0, -1]
    # only the 0.995 neg strictly beats it; the sim-0 neg ties and the
    # positive wins ties -> rank 2
    ranks2 = rank_of_positive(user, pos2, negs)
    assert int(ranks2[0]) == 2


def test_rank_with_negative_mask():
    user = _embed([[1.0, 0.0]])
    pos = _embed([[0.0, 1.0]])
    negs = _embed([[[1.0, 0.0], [1.0, 0.0]]])
    # unmasked: both negs beat pos -> rank 3; masked: rank 1
    assert int(rank_of_positive(user, pos, negs)[0]) == 3
    mask = jnp.asarray([[0.0, 0.0]])
    assert int(rank_of_positive(user, pos, negs, mask)[0]) == 1


def test_ranking_metrics_values():
    # 2 users: one ranks 1, one ranks 3 (of 1+3 candidates)
    user = _embed([[1.0, 0.0], [1.0, 0.0]])
    pos = _embed([[1.0, 0.0], [0.05, 1.0]])
    negs = _embed(
        [
            [[0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]],
            [[0.9, 0.1], [0.8, 0.2], [-1.0, 0.0]],
        ]
    )
    m = ranking_metrics(user, pos, negs, ks=(1, 2, 10))
    ranks = rank_of_positive(user, pos, negs)
    np.testing.assert_array_equal(np.asarray(ranks), [1, 3])
    np.testing.assert_allclose(float(m["mrr"]), (1.0 + 1.0 / 3) / 2, rtol=1e-6)
    np.testing.assert_allclose(float(m["recall@1"]), 0.5)
    np.testing.assert_allclose(float(m["recall@10"]), 1.0)
    np.testing.assert_allclose(
        float(m["ndcg@10"]), (1.0 + 1.0 / np.log2(4)) / 2, rtol=1e-6
    )


def test_top_k_items_xla():
    rng = np.random.RandomState(0)
    users = _embed(rng.randn(4, 16))
    catalog = _embed(rng.randn(50, 16))
    scores, idx = top_k_items(users, catalog, k=5)
    assert scores.shape == (4, 5) and idx.shape == (4, 5)
    # brute force check
    u = np.asarray(users) / np.linalg.norm(users, axis=1, keepdims=True)
    c = np.asarray(catalog) / np.linalg.norm(catalog, axis=1, keepdims=True)
    full = u @ c.T
    np.testing.assert_array_equal(
        np.asarray(idx), np.argsort(-full, axis=1)[:, :5]
    )


@pytest.mark.parametrize("k", [1, 7, 32])
def test_top_k_items_matches_numpy(k):
    """Full-catalog retrieval == a float64 numpy cosine scan + argsort."""
    rng = np.random.RandomState(1)
    users = rng.randn(10, 32)
    catalog = rng.randn(300, 32)
    s, i = top_k_items(_embed(users), _embed(catalog), k=k)
    un = users / np.linalg.norm(users, axis=1, keepdims=True)
    cn = catalog / np.linalg.norm(catalog, axis=1, keepdims=True)
    full = un @ cn.T
    order = np.argsort(-full, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(np.asarray(i), order)
    np.testing.assert_allclose(np.asarray(s),
                               np.take_along_axis(full, order, 1), atol=1e-5)


def test_info_nce_matches_manual():
    rng = np.random.RandomState(2)
    u = rng.randn(3, 8).astype(np.float32)
    p = rng.randn(3, 8).astype(np.float32)
    n = rng.randn(3, 5, 8).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]], np.float32)

    loss = float(info_nce_loss(jnp.asarray(u), jnp.asarray(p), jnp.asarray(n),
                               jnp.asarray(mask)))

    # manual per-sample computation mirroring the reference loop
    def norm(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    un, pn, nn = norm(u), norm(p), norm(n)
    t = 0.07
    losses = []
    for i in range(3):
        pos = float(un[i] @ pn[i]) / t
        negs = (nn[i] @ un[i]) / t
        valid = negs[mask[i] > 0]
        allv = np.concatenate([[pos], valid])
        m = allv.max()
        lse = m + np.log(np.exp(allv - m).sum())
        losses.append(-pos + lse)
    np.testing.assert_allclose(loss, np.mean(losses), rtol=1e-5)


def test_top_k_items_all_negative_scores():
    """Items whose similarity is negative everywhere still rank by score
    (no zero-score filler may take their place)."""
    rng = np.random.RandomState(0)
    n = 1030
    base = rng.randn(1024).astype(np.float32)
    # catalog anti-aligned with the user -> ALL similarities negative
    catalog = -np.abs(rng.rand(n, 1)).astype(np.float32) * base[None, :]
    catalog += rng.randn(n, 1024).astype(np.float32) * 1e-3
    users = np.tile(base, (4, 1)).astype(np.float32)

    s, i = top_k_items(jnp.asarray(users), jnp.asarray(catalog), k=10)
    s = np.asarray(s)
    assert np.isfinite(s).all() and (s < 0).all()
    cn = catalog / np.linalg.norm(catalog, axis=1, keepdims=True)
    full = (users / np.linalg.norm(users, axis=1, keepdims=True)) @ cn.T
    np.testing.assert_array_equal(
        np.asarray(i), np.argsort(-full, axis=1, kind="stable")[:, :10])
