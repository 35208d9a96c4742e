"""Self-supervised MWNE property training (additivity / invertibility /
distance-rank), rebuilt from reference models/mwne.py:226-501 as one jitted
train step over synthetic number batches.

Losses (reference weights models/mwne.py:246-248):
  * additivity (w=10): MSE(E(a)+E(b), E(a+b)) over consecutive + random pairs;
  * invertibility (w=1): mean relative error of an MLP decoder;
  * distance-rank (w=1): margin ranking loss on triplets so embedding
    distances order like numeric distances.

Evaluation mirrors models/mwne.py:441-501: fixed additivity pairs,
invertibility stats, and Spearman distance-rank correlation.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
import optax

from unirec.configs import MWNEConfig
from unirec.models.mwne import MathematicalEncoder, MWNEDecoder

ADDITIVITY_WEIGHT = 10.0
INVERTIBILITY_WEIGHT = 1.0
DISTANCE_WEIGHT = 1.0


def generate_training_batch(rng: jax.Array, batch_size: int) -> jax.Array:
    """Balanced synthetic numbers (reference: models/mwne.py:416-439):
    small positives, medium, small negatives, decimals, gaussian mix."""
    n_each = batch_size // 5
    r = jax.random.split(rng, 5)
    parts = [
        jax.random.uniform(r[0], (n_each,)) * 10.0,
        jax.random.uniform(r[1], (n_each,)) * 100.0 + 10.0,
        -jax.random.uniform(r[2], (n_each,)) * 10.0,
        jax.random.uniform(r[3], (n_each,)),
        jax.random.normal(r[4], (batch_size - 4 * n_each,)) * 5.0,
    ]
    return jnp.concatenate(parts)


def _additivity_loss(encode, numbers: jax.Array, rng: jax.Array) -> jax.Array:
    n = numbers.shape[0]
    n_pairs = min(n // 2, 32)
    # Strategy 1: consecutive pairs (reference: models/mwne.py:294-298).
    a1, b1 = numbers[:n_pairs], numbers[n_pairs : 2 * n_pairs]
    l1 = jnp.mean((encode(a1) + encode(b1) - encode(a1 + b1)) ** 2)
    # Strategy 2: random pairs with replacement (:302-308).
    ra, rb = jax.random.split(rng)
    ia = jax.random.randint(ra, (n_pairs,), 0, n)
    ib = jax.random.randint(rb, (n_pairs,), 0, n)
    a2, b2 = numbers[ia], numbers[ib]
    l2 = jnp.mean((encode(a2) + encode(b2) - encode(a2 + b2)) ** 2)
    return (l1 + l2) / 2.0


def _invertibility_loss(emb, decoded, numbers: jax.Array) -> jax.Array:
    rel = jnp.abs(decoded - numbers) / (jnp.abs(numbers) + 1e-6)
    return rel.mean()


def _distance_loss(
    numbers: jax.Array, emb: jax.Array, rng: jax.Array, n_triplets: int = 10
) -> jax.Array:
    """Margin 0.1 ranking loss on random triplets
    (reference: models/mwne.py:335-369)."""
    n = numbers.shape[0]

    def one(r):
        idx = jax.random.choice(r, n, (3,), replace=False)
        a, b, c = numbers[idx[0]], numbers[idx[1]], numbers[idx[2]]
        ea, eb, ec = emb[idx[0]], emb[idx[1]], emb[idx[2]]
        d_ab, d_ac = jnp.abs(a - b), jnp.abs(a - c)
        ed_ab = jnp.linalg.norm(ea - eb)
        ed_ac = jnp.linalg.norm(ea - ec)
        loss_ab = jnp.maximum(ed_ab - ed_ac + 0.1, 0.0)  # d_ab < d_ac
        loss_ac = jnp.maximum(ed_ac - ed_ab + 0.1, 0.0)
        return jnp.where(d_ab < d_ac, loss_ab, jnp.where(d_ac < d_ab, loss_ac, 0.0))

    rngs = jax.random.split(rng, n_triplets)
    return jax.vmap(one)(rngs).mean()


class MWNETrainer:
    """Functional trainer; one jit-compiled step, AdamW + grad clip 0.5
    (reference: models/mwne.py:374-392)."""

    def __init__(self, config: MWNEConfig, lr: float = 1e-3, seed: int = 0):
        self.config = config
        self.encoder = MathematicalEncoder(config)
        self.decoder = MWNEDecoder(config.embedding_dim)
        rng = jax.random.PRNGKey(seed)
        dummy = jnp.zeros((4,))
        enc_params = self.encoder.init(rng, dummy)["params"]
        dec_params = self.decoder.init(
            rng, jnp.zeros((4, config.embedding_dim))
        )["params"]
        self.params = {"encoder": enc_params, "decoder": dec_params}
        self.tx = optax.chain(
            optax.clip_by_global_norm(0.5),
            optax.adamw(lr, weight_decay=1e-6),
        )
        self.opt_state = self.tx.init(self.params)
        self._step = jax.jit(self._make_step())

    def _make_step(self):
        encoder, decoder, tx = self.encoder, self.decoder, self.tx

        def loss_fn(params, numbers, rng):
            encode = lambda x: encoder.apply({"params": params["encoder"]}, x)
            r_add, r_dist = jax.random.split(rng)
            emb = encode(numbers)
            decoded = decoder.apply({"params": params["decoder"]}, emb)
            add = _additivity_loss(encode, numbers, r_add)
            inv = _invertibility_loss(emb, decoded, numbers)
            dist = _distance_loss(numbers, emb, r_dist)
            total = (
                ADDITIVITY_WEIGHT * add
                + INVERTIBILITY_WEIGHT * inv
                + DISTANCE_WEIGHT * dist
            )
            return total, {"additivity": add, "invertibility": inv, "distance": dist}

        def step(params, opt_state, rng):
            r_batch, r_loss = jax.random.split(rng)
            numbers = generate_training_batch(r_batch, 64)
            (total, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, numbers, r_loss
            )
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            metrics["total"] = total
            return params, opt_state, metrics

        return step

    def train(self, num_steps: int = 200, seed: int = 0) -> Dict[str, float]:
        rng = jax.random.PRNGKey(seed)
        metrics = {}
        for i in range(num_steps):
            rng, r = jax.random.split(rng)
            self.params, self.opt_state, metrics = self._step(
                self.params, self.opt_state, r
            )
        return {k: float(v) for k, v in metrics.items()}

    # -- evaluation (reference: models/mwne.py:441-501) --

    def evaluate(self, test_numbers: np.ndarray) -> Dict[str, float]:
        encode = lambda x: self.encoder.apply(
            {"params": self.params["encoder"]}, jnp.asarray(x)
        )
        results: Dict[str, float] = {}

        pairs = [(1.0, 2.0), (3.0, 5.0), (0.1, 0.9), (-2.0, 4.0), (10.0, 0.01)]
        errs = []
        for a, b in pairs:
            ea = encode(jnp.array([a]))
            eb = encode(jnp.array([b]))
            es = encode(jnp.array([a + b]))
            errs.append(float(jnp.mean((ea + eb - es) ** 2)))
        results["additivity_mse"] = float(np.mean(errs))
        results["additivity_max"] = float(np.max(errs))

        x = jnp.asarray(test_numbers)
        emb = encode(x)
        decoded = self.decoder.apply({"params": self.params["decoder"]}, emb)
        inv_err = jnp.abs(decoded - x)
        results["invertibility_mean"] = float(inv_err.mean())
        results["invertibility_max"] = float(inv_err.max())

        if len(test_numbers) >= 5:
            results["distance_rank_correlation"] = spearman_distance_correlation(
                np.asarray(test_numbers), np.asarray(emb)
            )
        return results


def spearman_distance_correlation(numbers: np.ndarray, emb: np.ndarray) -> float:
    """Spearman rank correlation between pairwise numeric and embedding
    distances (reference: models/mwne.py:480-490)."""
    n = len(numbers)
    iu = np.triu_indices(n, k=1)
    num_d = np.abs(numbers[:, None] - numbers[None, :])[iu]
    emb_d = np.linalg.norm(emb[:, None, :] - emb[None, :, :], axis=-1)[iu]
    if len(num_d) < 2:
        return float("nan")
    nr = np.argsort(np.argsort(num_d)).astype(np.float64)
    er = np.argsort(np.argsort(emb_d)).astype(np.float64)
    c = np.corrcoef(nr, er)[0, 1]
    return float(c)
