"""User Q-Former training: predict the next item's query tokens.

JAX rebuild of reference training/user_qformer_training.py:

* sliding-window samples from user histories (input = history[:i], target =
  history[i]; reference :96-112), timestamps proxied by each item's first
  review time (:87-94), coordinates placeholder [0, 0] (:126-133);
* the reference's fatal bottleneck — running the full Qwen3+CLIP+MWNE item
  pipeline inside the dataloader collate for every batch (:138-163) — is
  replaced by ONE precomputed pass: item query tokens for the whole catalog
  are generated once from the field-embedding cache with the frozen Item
  Q-Former, then training gathers rows (SURVEY.md §7.2.4);
* loss = MSE(predicted tokens, target item tokens) (:193, 209), AdamW, one
  jitted dp step; best-by-train-loss checkpointing kept.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from unirec.configs import (
    OptimizerConfig,
    TrainConfig,
    UserQFormerConfig,
)
from unirec.data.cache import FieldEmbeddingCache
from unirec.models.item_qformer import ItemQFormer
from unirec.models.user_qformer import UserQFormer
from unirec.models.user_sequence import UserSequenceModel
from unirec.ops.losses import mse_loss
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


def build_sliding_window_samples(
    user_histories: Sequence[Dict],
    min_seq_len: int = 3,
    max_seq_len: int = 50,
) -> List[Tuple[List[str], str]]:
    """(input_history_ids, target_id) samples
    (reference: user_qformer_training.py:96-112)."""
    samples: List[Tuple[List[str], str]] = []
    for user in user_histories:
        history = user.get("history", [])
        if len(history) < min_seq_len:
            continue
        history = history[-max_seq_len:]
        for i in range(1, len(history) - 1):
            samples.append((list(history[:i]), history[i]))
    return samples


def build_timestamp_map(review_data: Dict[str, list]) -> Dict[str, int]:
    """item -> earliest review unix time (reference :87-94)."""
    ts = {}
    for item_id, reviews in review_data.items():
        if reviews:
            ts[item_id] = reviews[0].get("unixReviewTime", 0)
    return ts


def precompute_item_tokens(
    item_qformer: ItemQFormer,
    qformer_params,
    cache: FieldEmbeddingCache,
    batch_size: int = 1024,
) -> np.ndarray:
    """One pass: whole catalog -> [N, K, hidden] query tokens (frozen)."""
    fwd = jax.jit(
        lambda emb, mask: item_qformer.apply(
            qformer_params, emb, mask
        )["query_outputs"]
    )
    outs = []
    n = len(cache)
    for i in range(0, n, batch_size):
        emb = cache.embeddings[i : i + batch_size]
        mask = cache.masks[i : i + batch_size]
        got = len(emb)
        if got < batch_size:
            # pad the tail to the compiled shape: a ragged final batch
            # would retrace and pay a fresh minutes-long remote compile
            # (CLAUDE.md eval-pad invariant)
            pad = batch_size - got
            emb = np.concatenate([emb, np.zeros_like(emb[:1]).repeat(pad, 0)])
            mask = np.concatenate(
                [mask, np.zeros_like(mask[:1]).repeat(pad, 0)]
            )
        outs.append(
            np.asarray(fwd(jnp.asarray(emb), jnp.asarray(mask)),
                       np.float32)[:got]
        )
    return np.concatenate(outs, axis=0)


@dataclasses.dataclass
class UserQFormerTrainer:
    user_config: UserQFormerConfig
    train_config: TrainConfig
    max_seq_len: int = 50
    # "float32" (strict parity) or "bfloat16" (mixed precision: bf16
    # activations, fp32 params/optimizer)
    dtype: str = "float32"
    # True (default) jointly trains the timestamp/geo context encoders —
    # an extension over the reference, which encodes context with FROZEN
    # MWNE-style encoders inside the dataloader collate and optimizes only
    # the UserQFormer (user_qformer_training.py:191-194, detached inputs).
    # False reproduces the reference semantics exactly (used by the
    # training-step parity suite).
    train_context: bool = True

    def __post_init__(self):
        compute_dtype = (
            jnp.bfloat16 if self.dtype == "bfloat16" else jnp.float32
        )
        self.mesh = make_mesh(self.train_config.mesh)
        self.dp_size = self.mesh.shape["dp"]
        self.sp_size = dict(self.mesh.shape).get("sp", 1)
        if self.user_config.sequence_parallel and self.sp_size <= 1:
            raise ValueError(
                "sequence_parallel requires an 'sp' mesh axis > 1 "
                "(TrainConfig.mesh.sp / `train user --sp N`)"
            )
        sp_mesh = self.mesh if (
            self.user_config.sequence_parallel and self.sp_size > 1
        ) else None
        self.user_model = UserQFormer(
            self.user_config, dtype=compute_dtype, sp_mesh=sp_mesh
        )
        self.seq_model = UserSequenceModel(
            self.user_config.input_embedding_dim, dtype=compute_dtype
        )
        self._train_step = data_parallel_jit(self._make_step(), self.mesh)

    def _make_step(self, return_grads: bool = False,
                   axis_name: Optional[str] = None):
        user_model, seq_model = self.user_model, self.seq_model
        train_context = self.train_context
        seq_apply = seq_model.apply
        if self.user_config.gradient_checkpointing:
            # long-history mode: the sequence assembly holds several
            # [B, seq*K, D] intermediates (flatten/PE/context broadcast) —
            # remat them alongside the Q-Former layers
            seq_apply = jax.checkpoint(seq_model.apply)

        seed = self.train_config.seed

        sp_flat_sh = sp_mask_sh = None
        if self.user_model.sp_mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            # memory tokens sharded over 'sp' (batch stays over 'dp'):
            # GSPMD shards the sequence assembly + K/V projections along
            # the token axis; the cross-attention op combines exactly over
            # collectives (ops/sharded_attention.py)
            sp_flat_sh = NamedSharding(self.mesh, P("dp", "sp", None))
            sp_mask_sh = NamedSharding(self.mesh, P("dp", "sp"))

        def step(state: TrainState, batch):
            # hardware-rng dropout bits (see train/joint.py); the
            # configured seed feeds the key
            rng = jax.random.fold_in(
                jax.random.key(seed, impl="rbg"), state.step
            )
            if axis_name is not None:
                # distinct dropout bits per shard (inside shard_map the
                # same key would repeat across devices)
                rng = jax.random.fold_in(
                    rng, jax.lax.axis_index(axis_name)
                )

            def loss_fn(params):
                seq_params = params["sequence"]
                if not train_context:
                    seq_params = jax.lax.stop_gradient(seq_params)
                flat, flat_mask = seq_apply(
                    {"params": seq_params},
                    batch["item_tokens"],
                    batch["timestamps"],
                    batch["coordinates"],
                    batch["seq_mask"],
                )
                if sp_flat_sh is not None:
                    flat = jax.lax.with_sharding_constraint(flat, sp_flat_sh)
                    flat_mask = jax.lax.with_sharding_constraint(
                        flat_mask, sp_mask_sh)
                pred = user_model.apply(
                    {"params": params["user"]},
                    flat,
                    flat_mask,
                    deterministic=False,
                    rngs={"dropout": rng},
                )
                w = batch.get("sample_weight")
                if w is None:  # static: decided by the batch's pytree keys
                    # equal shard sizes (pad_batch) → pmean of per-shard
                    # means IS the full-batch mean
                    return mse_loss(pred, batch["target_tokens"])
                per = jnp.mean(
                    (pred - batch["target_tokens"]) ** 2, axis=(1, 2)
                )
                wsum = jnp.sum(w)
                if axis_name is None:
                    return jnp.sum(per * w) / jnp.maximum(wsum, 1.0)
                # inside shard_map: normalize by the GLOBAL weight sum so
                # pmean of per-shard losses equals the full-batch loss
                # (clamp max(W,1)/S = max(W/S, 1/S); see ops/losses.py)
                n_shards = jax.lax.psum(1, axis_name)
                wsum = jax.lax.pmean(wsum, axis_name)
                return jnp.sum(per * w) / jnp.maximum(wsum, 1.0 / n_shards)

            loss, grads = jax.value_and_grad(loss_fn)(state.params)
            if axis_name is not None:
                loss = jax.lax.pmean(loss, axis_name)
                grads = jax.lax.pmean(grads, axis_name)
            state = state.apply_gradients(grads=grads)
            metrics = {"loss": loss}
            if return_grads:  # parity-test instrumentation
                metrics["grads"] = grads
            return state, metrics

        return step

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        seed = self.train_config.seed if seed is None else seed
        uc = self.user_config
        k = uc.num_item_tokens_to_predict
        d = uc.input_embedding_dim
        s = 4
        rng = jax.random.PRNGKey(seed)
        seq_params = self.seq_model.init(
            rng,
            jnp.zeros((2, s, k, d)),
            jnp.zeros((2, s)),
            jnp.zeros((2, s, 2)),
            jnp.ones((2, s)),
        )["params"]
        user_params = self.user_model.init(
            rng, jnp.zeros((2, s * k, d)), jnp.ones((2, s * k))
        )["params"]
        params = {"sequence": seq_params, "user": user_params}
        tx = make_optimizer(self.train_config.optimizer)
        if not self.train_context:
            # frozen context encoders must not even receive weight decay
            # (reference: only UserQFormer params reach AdamW,
            # user_qformer_training.py:194)
            import optax

            labels = {
                "sequence": jax.tree_util.tree_map(lambda _: "freeze", seq_params),
                "user": jax.tree_util.tree_map(lambda _: "train", user_params),
            }
            tx = optax.multi_transform(
                {"train": tx, "freeze": optax.set_to_zero()}, labels
            )
        state = TrainState.create(
            apply_fn=self.user_model.apply, params=params, tx=tx
        )
        return replicate(self.mesh, state)

    def make_batch(
        self,
        samples: Sequence[Tuple[List[str], str]],
        indices: Sequence[int],
        item_tokens: np.ndarray,  # [N, K, D] precomputed catalog tokens
        cache: FieldEmbeddingCache,
        timestamp_map: Dict[str, int],
        max_seq_len: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        s_max = max_seq_len or self.max_seq_len
        k, d = item_tokens.shape[1], item_tokens.shape[2]
        n = len(indices)
        toks = np.zeros((n, s_max, k, d), np.float32)
        ts = np.zeros((n, s_max), np.float32)
        coords = np.zeros((n, s_max, 2), np.float32)
        seq_mask = np.zeros((n, s_max), np.float32)
        targets = np.zeros((n, k, d), np.float32)
        weights = np.ones((n,), np.float32)
        for bi, si in enumerate(indices):
            hist, target = samples[si]
            hist = hist[-s_max:]
            rows = cache.rows_for(hist)
            valid = rows >= 0
            toks[bi, : len(hist)][valid] = item_tokens[rows[valid]]
            ts[bi, : len(hist)] = [timestamp_map.get(h, 0) for h in hist]
            # history items missing from the cache stay masked out — a
            # seq_mask of 1 would make the model attend a zero embedding
            # as if it were a real event
            seq_mask[bi, : len(hist)] = valid.astype(np.float32)
            trow = cache.rows_for([target])[0]
            if trow >= 0:
                targets[bi] = item_tokens[trow]
            else:
                # target item not in the cache: MSE against an all-zero
                # target would actively pull predictions to the zero
                # vector — zero-weight the sample out of the loss instead
                # of corrupting the objective
                weights[bi] = 0.0
        return {
            "item_tokens": toks,
            "timestamps": ts,
            "coordinates": coords,
            "seq_mask": seq_mask,
            "target_tokens": targets,
            "sample_weight": weights,
        }

    def train_epoch(
        self,
        state: TrainState,
        samples,
        item_tokens: np.ndarray,
        cache: FieldEmbeddingCache,
        timestamp_map: Dict[str, int],
        rng: np.random.Generator,
        batch_size: Optional[int] = None,
    ) -> Tuple[TrainState, Dict[str, float]]:
        batch_size = batch_size or self.train_config.batch_size

        def stream():
            for idx in epoch_batches(rng, len(samples), batch_size):
                batch = self.make_batch(
                    samples, idx, item_tokens, cache, timestamp_map
                )
                batch, _ = pad_batch(batch, self.dp_size)
                yield batch

        from unirec.parallel.mesh import batch_sharding

        state, mean, _ = drive_steps(
            self._train_step, state, stream(), sharding=batch_sharding(self.mesh)
        )
        return state, mean


def train_user_qformer(
    cache: FieldEmbeddingCache,
    user_histories: Sequence[Dict],
    review_data: Dict[str, list],
    item_qformer: ItemQFormer,
    item_qformer_params,
    user_config: Optional[UserQFormerConfig] = None,
    train_config: Optional[TrainConfig] = None,
    max_seq_len: int = 50,
    checkpoint_dir: Optional[str] = None,
    dtype: str = "float32",
    resume: bool = False,
    metrics_logger=None,
    log_fn=print,
) -> Tuple[TrainState, Dict[str, float]]:
    """Full driver (reference: train_user_qformer,
    user_qformer_training.py:166-229).  ``resume=True`` restores params +
    optimizer state + step + best-loss watermark from ``checkpoint_dir``."""
    user_config = user_config or UserQFormerConfig(
        num_item_tokens_to_predict=item_qformer.config.num_query_tokens,
        # item tokens live in the item Q-Former's hidden space — derive the
        # input width from the checkpoint instead of assuming production 1024
        input_embedding_dim=item_qformer.config.hidden_size,
    )
    train_config = train_config or TrainConfig(
        batch_size=64, num_epochs=50,
        optimizer=OptimizerConfig(learning_rate=5e-5),
    )
    trainer = UserQFormerTrainer(user_config, train_config, max_seq_len,
                                 dtype=dtype)
    samples = build_sliding_window_samples(user_histories, max_seq_len=max_seq_len)
    ts_map = build_timestamp_map(review_data)
    item_tokens = precompute_item_tokens(item_qformer, item_qformer_params, cache)

    # 90/10 held-out split for real validation (the reference checkpoints by
    # train loss only and has no val set, user_qformer_training.py:219-229).
    rng = np.random.default_rng(train_config.seed)
    perm = rng.permutation(len(samples))
    split = max(int(0.9 * len(samples)), 1)
    train_samples = [samples[i] for i in perm[:split]]
    val_samples = [samples[i] for i in perm[split:]]

    state = trainer.init_state()
    best_loss = float("inf")
    if resume:
        from unirec.utils.checkpoint import resume_train_state

        state, meta = resume_train_state(
            checkpoint_dir, state, log_fn,
            expect_grad_accum=train_config.optimizer
            .gradient_accumulation_steps,
        )
        best_loss = float(meta.get("loss", float("inf")))
    metrics: Dict[str, float] = {}
    for epoch in range(train_config.num_epochs):
        state, metrics = trainer.train_epoch(
            state, train_samples, item_tokens, cache, ts_map, rng
        )
        log_fn(f"epoch {epoch + 1}: {metrics}")
        if metrics_logger:
            metrics_logger.log(dict(metrics), step=int(state.step))
        if metrics["loss"] < best_loss:
            best_loss = metrics["loss"]
            if checkpoint_dir:
                from unirec.utils.checkpoint import save_checkpoint

                save_checkpoint(
                    checkpoint_dir, state, config=user_config,
                    extra={"epoch": epoch, "loss": best_loss,
                           "grad_accum": train_config.optimizer
                           .gradient_accumulation_steps},
                )
    from unirec.train.common import flush_grad_accum

    state = flush_grad_accum(state, train_config.optimizer)
    if val_samples:
        from unirec.eval.user_eval import evaluate_user_qformer

        val = evaluate_user_qformer(
            trainer, state, val_samples, item_tokens, cache, ts_map
        )
        log_fn(f"validation: {val}")
        if metrics_logger:
            metrics_logger.log(dict(val), step=int(state.step))
        metrics = {**metrics, **val}
    return state, metrics
