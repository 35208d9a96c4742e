"""Item Q-Former training: masked reconstruction + triplet contrastive.

JAX rebuild of reference training/item_qformer_training.py:

* triplets = (anchor, positive=next-in-sequence, random negative) from user
  histories (reference :23-39);
* anchor forward carries gradients; positive/negative forwards are
  stop-gradient (the reference runs them under no_grad, :123-125);
* loss = recon_w * masked-recon-MSE + cont_w * TripletMargin(0.5)
  (reference :41-56, production weights 1.0/0.25 :200);
* validation every N epochs: masked MSE + mean per-valid-field cosine
  (reference :139-169 — the reference's python double loop over fields is one
  vectorized masked reduction here);
* best-by-val-loss checkpointing keeping the {config, field_names} contract
  (reference :171-187), plus optimizer state for true step resume
  (the reference has none, SURVEY.md §5).

The whole step — 3 forwards + backward + AdamW — is one jit over a dp mesh;
negatives are sampled on the fly per epoch like the reference's __getitem__.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from unirec.configs import ItemQFormerConfig, TrainConfig
from unirec.data.cache import FieldEmbeddingCache
from unirec.models.item_qformer import ItemQFormer
from unirec.ops.losses import item_qformer_loss, masked_reconstruction_mse
from unirec.parallel.mesh import (
    data_parallel_jit,
    make_mesh,
    pad_batch,
    replicate,
)
from unirec.train.common import (
    TrainState,
    drive_steps,
    epoch_batches,
    make_optimizer,
)


def build_triplet_pairs(
    item_sequences: Sequence[Sequence[str]], id_to_row: Dict[str, int]
) -> np.ndarray:
    """(anchor_row, positive_row) for consecutive items in user histories
    (reference: training/item_qformer_training.py:27-28)."""
    pairs = [
        (id_to_row[seq[i]], id_to_row[seq[i + 1]])
        for seq in item_sequences
        for i in range(len(seq) - 1)
        if seq[i] in id_to_row and seq[i + 1] in id_to_row
    ]
    return np.asarray(pairs, np.int32).reshape(-1, 2)


def sample_negatives(
    rng: np.random.Generator, pairs: np.ndarray, num_items: int
) -> np.ndarray:
    """Random negative != anchor and != positive
    (reference: training/item_qformer_training.py:32-34)."""
    if num_items <= 2:
        # every item is the anchor or the positive of some pair —
        # rejection sampling would loop forever; fall back to any
        # different item (or the anchor itself when there is only one)
        return ((pairs[:, 0] + 1) % max(num_items, 1)).astype(np.int32)
    neg = rng.integers(0, num_items, size=len(pairs)).astype(np.int32)
    bad = (neg == pairs[:, 0]) | (neg == pairs[:, 1])
    while bad.any():
        neg[bad] = rng.integers(0, num_items, size=int(bad.sum()))
        bad = (neg == pairs[:, 0]) | (neg == pairs[:, 1])
    return neg


def make_train_step(
    model: ItemQFormer,
    reconstruction_weight: float = 1.0,
    contrastive_weight: float = 0.25,
    margin: float = 0.5,
    return_grads: bool = False,
    seed: int = 0,
    axis_name: Optional[str] = None,
):
    """One jitted step.  ``axis_name``: set when the step runs INSIDE
    ``jax.shard_map`` over a dp axis (``parallel/mesh.dp_shard_map_jit``);
    losses use pmean-count normalization so pmean of per-shard
    (loss, grads) is exactly the full-batch step."""

    def step(state: TrainState, batch):
        # rbg dropout bits (see train/joint.py; same seed+fold_in
        # determinism); the configured seed feeds the key so different-seed
        # runs draw different dropout masks
        rng = jax.random.fold_in(
            jax.random.key(seed, impl="rbg"), state.step
        )
        if axis_name is not None:
            # per-shard independent dropout bits (same determinism
            # contract: seed + step + shard index)
            rng = jax.random.fold_in(rng, jax.lax.axis_index(axis_name))

        def loss_fn(params):
            anc = model.apply(
                {"params": params},
                batch["anchor_emb"],
                batch["anchor_mask"],
                deterministic=False,
                rngs={"dropout": rng},
            )
            # positive/negative: inference mode, no gradient
            # (reference: training/item_qformer_training.py:123-125)
            pos = model.apply(
                {"params": jax.lax.stop_gradient(params)},
                batch["pos_emb"],
                batch["pos_mask"],
            )
            neg = model.apply(
                {"params": jax.lax.stop_gradient(params)},
                batch["neg_emb"],
                batch["neg_mask"],
            )
            total, recon, cont = item_qformer_loss(
                anc,
                batch["anchor_emb"],
                batch["anchor_mask"],
                jax.lax.stop_gradient(pos["item_representation"]),
                jax.lax.stop_gradient(neg["item_representation"]),
                reconstruction_weight,
                contrastive_weight,
                margin,
                axis_name=axis_name,
            )
            return total, (recon, cont)

        (total, (recon, cont)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(state.params)
        if axis_name is not None:
            total = jax.lax.pmean(total, axis_name)
            recon = jax.lax.pmean(recon, axis_name)
            cont = jax.lax.pmean(cont, axis_name)
            grads = jax.lax.pmean(grads, axis_name)
        state = state.apply_gradients(grads=grads)
        metrics = {"loss": total, "recon": recon, "contrastive": cont}
        if return_grads:  # parity-test instrumentation
            metrics["grads"] = grads
        return state, metrics

    return step


def make_eval_step(model: ItemQFormer):
    """Masked recon MSE + mean cosine over valid fields, fully vectorized
    (replaces the reference's per-field python loop,
    item_qformer_training.py:156-164)."""

    @jax.jit
    def step(params, field_emb, mask):
        out = model.apply({"params": params}, field_emb, mask)
        recon = out["reconstructed_fields"]
        mse = masked_reconstruction_mse(recon, field_emb, mask)
        o = field_emb / jnp.maximum(
            jnp.linalg.norm(field_emb, axis=-1, keepdims=True), 1e-12
        )
        r = recon / jnp.maximum(
            jnp.linalg.norm(recon, axis=-1, keepdims=True), 1e-12
        )
        cos = jnp.sum(o * r, axis=-1)  # [B, F]
        cos_sum = jnp.sum(cos * mask)
        return mse, cos_sum, jnp.sum(mask)

    return step


@dataclasses.dataclass
class ItemQFormerTrainer:
    """End-to-end trainer over a FieldEmbeddingCache."""

    model_config: ItemQFormerConfig
    train_config: TrainConfig
    reconstruction_weight: float = 1.0
    contrastive_weight: float = 0.25
    # "float32" (strict reference parity) or "bfloat16" (mixed precision:
    # bf16 activations, fp32 params/optimizer)
    dtype: str = "float32"

    def __post_init__(self):
        compute_dtype = (
            jnp.bfloat16 if self.dtype == "bfloat16" else jnp.float32
        )
        self.model = ItemQFormer(self.model_config, dtype=compute_dtype)
        self.mesh = make_mesh(self.train_config.mesh)
        step = make_train_step(
            self.model, self.reconstruction_weight, self.contrastive_weight,
            seed=self.train_config.seed,
        )
        self._train_step = data_parallel_jit(step, self.mesh)
        self._eval_step = make_eval_step(self.model)
        self.dp_size = self.mesh.shape["dp"]

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        seed = self.train_config.seed if seed is None else seed
        cfg = self.model_config
        dummy_emb = jnp.zeros((2, cfg.num_fields, cfg.field_embedding_dim))
        dummy_mask = jnp.ones((2, cfg.num_fields))
        params = self.model.init(
            jax.random.PRNGKey(seed), dummy_emb, dummy_mask
        )["params"]
        tx = make_optimizer(self.train_config.optimizer)
        state = TrainState.create(
            apply_fn=self.model.apply, params=params, tx=tx
        )
        return replicate(self.mesh, state)

    def _gather_batch(
        self, cache: FieldEmbeddingCache, pairs: np.ndarray, neg: np.ndarray
    ) -> Dict[str, np.ndarray]:
        a, p = pairs[:, 0], pairs[:, 1]
        return {
            "anchor_emb": cache.embeddings[a],
            "anchor_mask": cache.masks[a],
            "pos_emb": cache.embeddings[p],
            "pos_mask": cache.masks[p],
            "neg_emb": cache.embeddings[neg],
            "neg_mask": cache.masks[neg],
        }

    def train_epoch(
        self,
        state: TrainState,
        cache: FieldEmbeddingCache,
        pairs: np.ndarray,
        rng: np.random.Generator,
        batch_size: Optional[int] = None,
    ) -> Tuple[TrainState, Dict[str, float]]:
        batch_size = batch_size or self.train_config.batch_size

        def stream():
            for idx in epoch_batches(rng, len(pairs), batch_size):
                bp = pairs[idx]
                neg = sample_negatives(rng, bp, len(cache))
                batch, _ = pad_batch(
                    self._gather_batch(cache, bp, neg), self.dp_size
                )
                yield batch

        from unirec.parallel.mesh import batch_sharding

        state, mean, _ = drive_steps(
            self._train_step, state, stream(), sharding=batch_sharding(self.mesh)
        )
        return state, mean

    def evaluate(
        self,
        state: TrainState,
        cache: FieldEmbeddingCache,
        rows: Optional[np.ndarray] = None,
        batch_size: int = 512,
    ) -> Dict[str, float]:
        rows = np.arange(len(cache)) if rows is None else rows
        total_mse, total_cos, total_fields, n_batches = 0.0, 0.0, 0.0, 0
        for i in range(0, len(rows), batch_size):
            r = rows[i : i + batch_size]
            emb, mask = cache.embeddings[r], cache.masks[r]
            if len(r) < batch_size:
                # pad the tail to the compiled shape with ZERO masks (the
                # metrics are mask-normalized, so pad rows contribute
                # nothing) — a ragged final batch would retrace
                pad = batch_size - len(r)
                emb = np.concatenate(
                    [emb, np.zeros_like(emb[:1]).repeat(pad, 0)]
                )
                mask = np.concatenate(
                    [mask, np.zeros_like(mask[:1]).repeat(pad, 0)]
                )
            mse, cos_sum, n_valid = self._eval_step(
                state.params, jnp.asarray(emb), jnp.asarray(mask)
            )
            total_mse += float(mse)
            total_cos += float(cos_sum)
            total_fields += float(n_valid)
            n_batches += 1
        return {
            "val_recon_loss": total_mse / max(n_batches, 1),
            "avg_cosine_similarity": total_cos / max(total_fields, 1.0),
        }


def train_item_qformer(
    cache: FieldEmbeddingCache,
    item_sequences: Sequence[Sequence[str]],
    model_config: Optional[ItemQFormerConfig] = None,
    train_config: Optional[TrainConfig] = None,
    val_rows: Optional[np.ndarray] = None,
    checkpoint_dir: Optional[str] = None,
    contrastive_weight: float = 0.25,
    dtype: str = "float32",
    resume: bool = False,
    metrics_logger=None,
    log_fn=print,
) -> Tuple[TrainState, Dict[str, float]]:
    """Full training driver (reference: train_qformer,
    item_qformer_training.py:70-187).  ``resume=True`` restores params +
    optimizer state + step from ``checkpoint_dir`` (the epoch counter
    restarts; the optimizer step and best-val watermark continue)."""
    model_config = model_config or ItemQFormerConfig(
        num_fields=cache.num_fields, field_embedding_dim=cache.embedding_dim
    )
    train_config = train_config or TrainConfig()
    trainer = ItemQFormerTrainer(
        model_config, train_config, contrastive_weight=contrastive_weight,
        dtype=dtype,
    )
    state = trainer.init_state()
    pairs = build_triplet_pairs(item_sequences, cache.id_to_row)
    rng = np.random.default_rng(train_config.seed)

    best_val = float("inf")
    if resume:
        from unirec.utils.checkpoint import resume_train_state

        state, meta = resume_train_state(
            checkpoint_dir, state, log_fn,
            expect_grad_accum=train_config.optimizer
            .gradient_accumulation_steps,
        )
        best_val = float(meta.get("val_recon_loss", float("inf")))
    last_metrics: Dict[str, float] = {}
    for epoch in range(train_config.num_epochs):
        state, train_metrics = trainer.train_epoch(state, cache, pairs, rng)
        log_fn(f"epoch {epoch + 1}: {train_metrics}")
        if metrics_logger:
            metrics_logger.log(dict(train_metrics), step=int(state.step))
        if (epoch + 1) % train_config.eval_every_epochs == 0:
            val = trainer.evaluate(state, cache, val_rows)
            log_fn(f"epoch {epoch + 1} val: {val}")
            if metrics_logger:
                metrics_logger.log(dict(val), step=int(state.step))
            last_metrics = {**train_metrics, **val}
            if val["val_recon_loss"] < best_val and checkpoint_dir:
                best_val = val["val_recon_loss"]
                from unirec.utils.checkpoint import save_checkpoint

                save_checkpoint(
                    checkpoint_dir,
                    state,
                    config=model_config,
                    extra={"field_names": list(cache.fields),
                           "val_recon_loss": best_val,
                           "grad_accum": train_config.optimizer
                           .gradient_accumulation_steps},
                )
        else:
            last_metrics = train_metrics
    from unirec.train.common import flush_grad_accum

    state = flush_grad_accum(state, train_config.optimizer)
    return state, last_metrics
