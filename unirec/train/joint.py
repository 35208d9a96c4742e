"""Joint training: Qwen3 + LoRA + Item Q-Former with InfoNCE ranking loss.

JAX rebuild of the flagship trainer
(reference: training/train_item_individual_token_joint.py):

* dataset assembly mirrors AmazonBeautyTrain/ValDataset (:595-680): history
  field embeddings pulled from the shared cache, candidate embeddings from a
  precomputed item-embedding dict, prompt built by construct_input_text;
* the collator pads negatives to ``max_negatives`` with masks (:290-323);
* one jit step: Q-Former fwd -> token injection -> 28-layer Qwen3 fwd ->
  pooling -> InfoNCE -> backward through LoRA + extra token embeddings + the
  whole Q-Former (base Qwen3 weights frozen via optax.multi_transform,
  matching PEFT's behavior, :121-132);
* evaluation computes MRR and Recall@K/NDCG@K over the 100-candidate pool in
  one vectorized pass (:355-419 computes MRR only, per-sample).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from unirec.configs import (
    ItemQFormerConfig,
    JointModelConfig,
    LoRAConfig,
    OptimizerConfig,
    Qwen3Config,
    TrainConfig,
)
from unirec.data.cache import FieldEmbeddingCache
from unirec.data.tokenizer import BaseTokenizer
from unirec.models.joint import MultiModalQwenEmbedding, construct_input_text
from unirec.ops.losses import info_nce_loss
from unirec.parallel.mesh import (
    DP_AXIS,
    batch_sharding,
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
from unirec.utils.params import lora_trainable_mask


class JointDataset:
    """Assembles fixed-shape joint batches from rec samples.

    ``data``: list of {history, candidate, ground_truth} samples
    (reference sample schema, process_rec_old_user.py:74-79).
    """

    def __init__(
        self,
        data: Sequence[Dict],
        item_emb_dict: Dict[str, Sequence[float]],
        tokenizer: BaseTokenizer,
        item_dict: Dict[str, Dict],
        field_cache: FieldEmbeddingCache,
        joint_config: JointModelConfig = JointModelConfig(),
        max_negatives: int = 10,
        item_emb_dim: int = 1024,
    ):
        self.data = list(data)
        self._item_emb_dict = item_emb_dict
        self.tokenizer = tokenizer
        self.item_dict = item_dict
        self.cache = field_cache
        self.jc = joint_config
        self.max_negatives = max_negatives
        self._item_emb_dim = item_emb_dim
        self._build_index_tables()

    def __len__(self) -> int:
        return len(self.data)

    # candidate-embedding inputs may be swapped after construction (e.g. a
    # re-generated embedding dict); rebuild the gather tables lazily
    @property
    def item_emb_dict(self):
        return self._item_emb_dict

    @item_emb_dict.setter
    def item_emb_dict(self, value):
        self._item_emb_dict = value
        self._tables_dirty = True

    @property
    def item_emb_dim(self) -> int:
        return self._item_emb_dim

    @item_emb_dim.setter
    def item_emb_dim(self, value: int):
        self._item_emb_dim = int(value)
        self._tables_dirty = True

    def _build_index_tables(self) -> None:
        """Precompute per-sample gather indices so ``batch`` is pure numpy
        fancy-indexing (the per-sample Python loop serialized with the device
        step; reference analog is the DataLoader collate,
        train_item_individual_token_joint.py:290-323).

        * ``_hist_rows``: [N, H] rows into the field cache (-1 = missing);
        * ``_emb_matrix``: candidate item embeddings with row 0 = zeros, so
          unknown ids degrade to zero embeddings
          (reference: train_item_individual_token_joint.py:609-618);
        * ``_pos_rows`` / ``_neg_rows`` / ``_neg_valid``: candidate pools,
          negatives padded to the dataset-wide maximum;
        * tokenization is memoized per sample on first use (prompts are
          sample-static across epochs).
        """
        n = len(self.data)
        jc = self.jc
        h = jc.num_history_items

        self._hist_rows = np.full((n, h), -1, np.int32)
        for i, sample in enumerate(self.data):
            hist = [str(x) for x in sample["history"]][:h]
            if hist:
                self._hist_rows[i, : len(hist)] = self.cache.rows_for(hist)

        ids = list(self.item_emb_dict)
        self._emb_matrix = np.zeros((len(ids) + 1, self.item_emb_dim), np.float32)
        emb_row = {}
        for j, key in enumerate(ids):
            self._emb_matrix[j + 1] = np.asarray(
                self.item_emb_dict[key], np.float32
            )
            emb_row[str(key)] = j + 1

        cmax = max((len(s["candidate"]) - 1 for s in self.data), default=0)
        cmax = max(cmax, 1)
        self._pos_rows = np.zeros(n, np.int32)
        self._neg_rows = np.zeros((n, cmax), np.int32)
        self._neg_valid = np.zeros((n, cmax), np.float32)
        for i, sample in enumerate(self.data):
            candidates = sample["candidate"]
            gt_idx = candidates.index(sample["ground_truth"])
            self._pos_rows[i] = emb_row.get(str(candidates[gt_idx]), 0)
            neg_ids = [c for j, c in enumerate(candidates) if j != gt_idx]
            for j, c in enumerate(neg_ids):
                self._neg_rows[i, j] = emb_row.get(str(c), 0)
            self._neg_valid[i, : len(neg_ids)] = 1.0

        # the tokenization memo depends only on (data, item_dict, tokenizer,
        # max_length) — none of which the emb setters change — so a rebuild
        # triggered by swapping candidate embeddings keeps it (re-tokenizing
        # the whole dataset is the expensive part)
        if not hasattr(self, "_tok_ids") or len(self._tok_done) != n:
            self._tok_ids = np.zeros((n, jc.max_length), np.int32)
            self._tok_mask = np.zeros((n, jc.max_length), np.float32)
            self._tok_done = np.zeros(n, bool)
        self._tables_dirty = False

    def _tokenize_rows(self, idx: np.ndarray) -> None:
        todo = idx[~self._tok_done[idx]]
        jc = self.jc
        for si in todo:
            sample = self.data[si]
            history = [str(x) for x in sample["history"]][: jc.num_history_items]
            text = construct_input_text(
                history,
                self.item_dict,
                jc.num_history_items,
                jc.num_query_tokens_per_item,
            )
            ids, mask = self.tokenizer.encode(text, jc.max_length)
            self._tok_ids[si], self._tok_mask[si] = ids, mask
            self._tok_done[si] = True

    def batch(self, indices: Sequence[int], max_negatives: Optional[int] = None
              ) -> Dict[str, np.ndarray]:
        if self._tables_dirty:
            self._build_index_tables()
        max_neg = max_negatives or self.max_negatives
        idx = np.asarray(indices, np.int64)
        n = len(idx)

        self._tokenize_rows(idx)

        rows = self._hist_rows[idx]  # [B, H]
        valid = rows >= 0
        clipped = np.clip(rows, 0, None)
        hist_emb = np.where(
            valid[..., None, None], self.cache.embeddings[clipped], 0.0
        ).astype(np.float32)
        hist_mask = np.where(
            valid[..., None], self.cache.masks[clipped], 0.0
        ).astype(np.float32)

        k = min(max_neg, self._neg_rows.shape[1])
        negs = np.zeros((n, max_neg, self.item_emb_dim), np.float32)
        neg_mask = np.zeros((n, max_neg), np.float32)
        negs[:, :k] = self._emb_matrix[self._neg_rows[idx, :k]]
        neg_mask[:, :k] = self._neg_valid[idx, :k]

        return {
            "input_ids": self._tok_ids[idx],
            "attention_mask": self._tok_mask[idx],
            "history_field_embeddings": hist_emb,
            "history_attention_mask": hist_mask,
            "positive_item_embeddings": self._emb_matrix[self._pos_rows[idx]],
            "negative_item_embeddings": negs,
            "negative_masks": neg_mask,
        }


def make_joint_train_step(
    model: MultiModalQwenEmbedding,
    temperature: float = 0.07,
    return_grads: bool = False,
    seed: int = 1,
    axis_name: Optional[str] = None,
    with_qweights: bool = False,
):
    """Build the (state, batch) -> (state, metrics) step.

    ``axis_name``: set when the step runs INSIDE ``jax.shard_map`` over a
    dp axis (``parallel/mesh.dp_shard_map_jit``: the dp split is explicit).
    The loss is a per-sample mean over
    per-sample candidate pools, so ``pmean`` of per-shard (loss, grads)
    is exactly the full-batch step.

    ``with_qweights``: the step takes a third arg — the frozen base's int8
    ``qweights`` collection — and the forward runs the base's projections
    W8A8 with an STE backward (``ops/int8_ste``): QLoRA-style training
    (`--int8-base`).  LoRA/Q-Former stay full precision and exact.
    """

    def step(state: TrainState, batch, qweights=None):
        # rbg dropout bits: cheaper to generate than threefry2x32 for the
        # 28 layers of [B, L, *] dropout masks.  Same determinism contract
        # (configured seed + fold_in(step)), different (equally valid) bits.
        rng = jax.random.fold_in(
            jax.random.key(seed, impl="rbg"), state.step
        )
        if axis_name is not None:
            # per-shard independent dropout bits (same contract: seed +
            # step + shard index — deterministic across runs)
            rng = jax.random.fold_in(rng, jax.lax.axis_index(axis_name))

        def loss_fn(params):
            # stop_gradient on the frozen base subtree: XLA prunes the dW
            # matmuls for all 0.6B frozen params from the backward (the
            # optimizer-side multi_transform freeze alone still pays to
            # COMPUTE those grads before zeroing them; PEFT's
            # requires_grad=False equivalent is pruning them here).
            mask = lora_trainable_mask(params)
            params = jax.tree_util.tree_map(
                lambda p, t: p if t else jax.lax.stop_gradient(p),
                params, mask,
            )
            variables = {"params": params}
            if with_qweights:
                variables["qweights"] = qweights
            user_emb = model.apply(
                variables,
                batch["input_ids"],
                batch["attention_mask"],
                batch["history_field_embeddings"],
                batch["history_attention_mask"],
                deterministic=False,
                rngs={"dropout": rng},
            )
            return info_nce_loss(
                user_emb,
                batch["positive_item_embeddings"],
                batch["negative_item_embeddings"],
                batch["negative_masks"],
                temperature,
            )

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        if axis_name is not None:
            loss = jax.lax.pmean(loss, axis_name)
            grads = jax.lax.pmean(grads, axis_name)
        state = state.apply_gradients(grads=grads)
        metrics = {"loss": loss, "grad_norm": optax.global_norm(grads)}
        if return_grads:  # parity-test instrumentation
            metrics["grads"] = grads
        return state, metrics

    return step


@functools.lru_cache(maxsize=1)
def _jitted_rank_of_positive():
    """Module-cached jit of ops.ranking.rank_of_positive: evaluate() runs
    every N steps from the CLI hook, and a fresh jax.jit wrapper per call
    would re-trace (and re-lower) each evaluation."""
    from unirec.ops.ranking import rank_of_positive

    return jax.jit(rank_of_positive)


def make_joint_optimizer(
    params, opt_cfg: OptimizerConfig
) -> optax.GradientTransformation:
    """AdamW on LoRA + extra token embeddings + Q-Former; base Qwen3 frozen
    (PEFT-equivalent, reference: train_item_individual_token_joint.py:121-132)."""
    mask = lora_trainable_mask(params)
    labels = jax.tree_util.tree_map(
        lambda t: "train" if t else "freeze", mask
    )
    return optax.multi_transform(
        {"train": make_optimizer(opt_cfg), "freeze": optax.set_to_zero()},
        labels,
    )


@dataclasses.dataclass
class JointTrainer:
    qwen_config: Qwen3Config
    qformer_config: ItemQFormerConfig
    joint_config: JointModelConfig = JointModelConfig()
    lora: LoRAConfig = LoRAConfig()
    train_config: TrainConfig = TrainConfig(batch_size=16)
    dtype: str = "float32"
    remat: bool = False
    remat_policy: Optional[str] = None  # e.g. "dots" (keep GEMM outputs)
    # store the frozen Qwen3 base in bf16 (utils/params.cast_frozen_to_bf16):
    # numerically free under dtype="bfloat16" (kernels are cast to bf16 at
    # use anyway), halves frozen-param memory so bigger batches fit.
    bf16_base: bool = False
    # QLoRA-style quantized-base training (`train joint --int8-base`): the
    # frozen Qwen3 projections run W8A8 in the TRAINING forward (int8
    # dots) with an STE backward (ops/int8_ste); LoRA adapts around
    # the quantized base exactly as QLoRA does around nf4.  LoRA/Q-Former
    # grads stay full-precision exact.  Changes training numerics (opt-in);
    # eval forwards stay full precision.
    int8_base: bool = False

    def __post_init__(self):
        if self.bf16_base and self.dtype != "bfloat16":
            # mirror the CLI guard: under an fp32 compute path a bf16 frozen
            # base would silently degrade the strict-parity numerics
            raise ValueError(
                "bf16_base requires dtype='bfloat16' (fp32 compute exists "
                "for strict parity; a bf16 frozen base would break it)"
            )
        policy = None
        if self.remat_policy == "dots":
            policy = jax.checkpoint_policies.dots_with_no_batch_dims_saveable
        elif self.remat_policy:
            policy = getattr(jax.checkpoint_policies, self.remat_policy)
        self.model = MultiModalQwenEmbedding(
            self.qwen_config,
            self.qformer_config,
            self.joint_config,
            lora=self.lora,
            dtype=jnp.bfloat16 if self.dtype == "bfloat16" else jnp.float32,
            remat=self.remat,
            remat_policy=policy,
        )
        self.mesh = make_mesh(self.train_config.mesh)
        self.dp_size = self.mesh.shape["dp"]
        self.tp_size = self.mesh.shape["tp"]
        # int8_base on a dp mesh splits the batch with an explicit
        # shard_map (parallel/mesh.dp_shard_map_jit, an XLA body); other
        # configurations partition under GSPMD.
        self._kernel_dp = self.int8_base and self.dp_size > 1
        if self.int8_base and self.tp_size > 1:
            raise ValueError(
                "int8_base is incompatible with tp>1 (the int8 qweights "
                "tree has no tp sharding rules); use dp-only meshes "
                "(see docs/ARCHITECTURE.md 'tp scope')"
            )
        self.qweights = None  # built in init_state when int8_base
        self._raw_step = make_joint_train_step(
            self.model, seed=self.train_config.seed,
            axis_name=DP_AXIS if self._kernel_dp else None,
            with_qweights=self.int8_base,
        )
        self._train_step = None  # jitted lazily once state shardings exist
        self._state_shardings = None
        # plain jit fallback; init_state replaces it with a mesh-sharded
        # version (batch over dp, params per the tp sharding tree)
        self._eval_fwd = jax.jit(
            lambda p, ids, m, he, hm: self.model.apply(
                {"params": p}, ids, m, he, hm
            )
        )

    def state_shardings(self, state: TrainState):
        """Sharding tree for the train state: Qwen3 kernels tensor-sharded
        over 'tp' (models/qwen3.tp_spec_for_path matches params AND the
        optimizer's mu/nu trees by path), everything else replicated."""
        from jax.sharding import NamedSharding

        from unirec.models.qwen3 import tp_spec_for_path

        if self.tp_size <= 1:
            from unirec.parallel.mesh import replicated

            sh = replicated(self.mesh)
            return jax.tree_util.tree_map(lambda _: sh, state)
        return jax.tree_util.tree_map_with_path(
            lambda path, x: NamedSharding(
                self.mesh, tp_spec_for_path(path, np.ndim(x))
            ),
            state,
        )

    def init_state(
        self, qformer_params=None, qwen_params=None, seed: Optional[int] = None
    ) -> TrainState:
        seed = self.train_config.seed if seed is None else seed
        jc = self.joint_config
        qc = self.qformer_config
        dummy = {
            "input_ids": jnp.zeros((2, jc.max_length), jnp.int32),
            "attention_mask": jnp.ones((2, jc.max_length)),
            "history_field_embeddings": jnp.zeros(
                (2, jc.num_history_items, qc.num_fields, qc.field_embedding_dim)
            ),
            "history_attention_mask": jnp.ones(
                (2, jc.num_history_items, qc.num_fields)
            ),
        }
        params = self.model.init(
            jax.random.PRNGKey(seed),
            dummy["input_ids"],
            dummy["attention_mask"],
            dummy["history_field_embeddings"],
            dummy["history_attention_mask"],
        )["params"]
        from unirec.utils.params import merge_params

        if qformer_params is not None:
            params = dict(params)
            params["qformer"] = merge_params(
                params["qformer"], qformer_params
            )
        if qwen_params is not None:
            params = dict(params)
            params["base_model"] = merge_params(
                params["base_model"], qwen_params
            )
        if self.bf16_base:
            from unirec.utils.params import cast_frozen_to_bf16

            params = cast_frozen_to_bf16(params)
        tx = make_joint_optimizer(params, self.train_config.optimizer)
        state = TrainState.create(
            apply_fn=self.model.apply, params=params, tx=tx
        )
        self._state_shardings = self.state_shardings(state)
        from unirec.parallel.mesh import (
            dp_shard_map_jit,
            mixed_parallel_jit,
            shard_like,
        )

        if self.int8_base:
            from unirec.models.qwen3 import quantize_qwen3_weights
            from unirec.parallel.mesh import replicate

            self.qweights = {
                "base_model": quantize_qwen3_weights(params["base_model"])
            }
            self.qweights = replicate(self.mesh, self.qweights)
            if self._kernel_dp:
                jitted = dp_shard_map_jit(
                    self._raw_step, self.mesh, n_extra_replicated=1)
            else:
                jitted = mixed_parallel_jit(
                    self._raw_step, self.mesh, self._state_shardings,
                    n_extra_replicated=1,
                )
            # qweights ride as a runtime jit ARG on every call (closure
            # capture would bake the int8 tree into the executable as
            # constants); the (state, batch) driver interface is preserved
            self._train_step = (
                lambda s, b: jitted(s, b, self.qweights)
            )
        else:
            self._train_step = mixed_parallel_jit(
                self._raw_step, self.mesh, self._state_shardings
            )
        # eval forward sharded like training: batch over dp, params over tp
        # (eval was effectively single-device)
        fwd = lambda p, ids, m, he, hm: self.model.apply(  # noqa: E731
            {"params": p}, ids, m, he, hm
        )
        if self.dp_size > 1 and self.tp_size == 1:
            # dp-only meshes split the batch explicitly via shard_map
            # (params replicated, batch leading axis over dp).
            from jax.sharding import PartitionSpec as _P

            self._eval_fwd = jax.jit(
                jax.shard_map(
                    fwd,
                    mesh=self.mesh,
                    in_specs=(
                        _P(), _P("dp"), _P("dp"), _P("dp"), _P("dp"),
                    ),
                    out_specs=_P("dp"),
                    check_vma=False,
                )
            )
        else:
            bsh = batch_sharding(self.mesh)
            self._eval_fwd = jax.jit(
                fwd,
                in_shardings=(
                    self._state_shardings.params, bsh, bsh, bsh, bsh,
                ),
                out_shardings=bsh,
            )
        return shard_like(state, self._state_shardings)

    def _batch_stream(
        self,
        dataset: JointDataset,
        rng: np.random.Generator,
        batch_size: int,
        num_steps: Optional[int] = None,
    ):
        """Yield padded host batches; runs inside the device prefetcher so
        assembly of batch N+1 overlaps the device step on batch N."""
        produced = 0
        while num_steps is None or produced < num_steps:
            for idx in epoch_batches(rng, len(dataset), batch_size):
                batch, _ = pad_batch(dataset.batch(idx), self.dp_size)
                yield batch
                produced += 1
                if num_steps is not None and produced >= num_steps:
                    return
            if num_steps is None:
                return

    def train_epoch(
        self,
        state: TrainState,
        dataset: JointDataset,
        rng: np.random.Generator,
        batch_size: Optional[int] = None,
    ) -> Tuple[TrainState, Dict[str, float]]:
        batch_size = batch_size or self.train_config.batch_size
        state, mean, _ = drive_steps(
            self._train_step,
            state,
            self._batch_stream(dataset, rng, batch_size),
            sharding=batch_sharding(self.mesh),
        )
        return state, mean

    def train_steps(
        self,
        state: TrainState,
        dataset: JointDataset,
        rng: np.random.Generator,
        num_steps: int,
        batch_size: Optional[int] = None,
        step_hook=None,
    ) -> Tuple[TrainState, Dict[str, float]]:
        """Step-driven training with an optional per-step hook
        (reference evaluates every N global steps via a Trainer callback,
        train_item_individual_token_joint.py:439-474)."""
        batch_size = batch_size or self.train_config.batch_size
        hook = None
        if step_hook is not None:
            hook = lambda i, st, m: step_hook(int(st.step), st, m)  # noqa: E731
        state, _, last = drive_steps(
            self._train_step,
            state,
            self._batch_stream(dataset, rng, batch_size, num_steps),
            sharding=batch_sharding(self.mesh),
            step_hook=hook,
        )
        return state, last

    def evaluate(
        self,
        state: TrainState,
        dataset: JointDataset,
        batch_size: int = 32,
        max_negatives: int = 99,
        ks: Tuple[int, ...] = (1, 5, 10),
    ) -> Dict[str, float]:
        """MRR + Recall@K + NDCG@K over the full candidate pool
        (reference MRREvaluator :355-419 + the metrics BASELINE.json adds).

        Tail batches are padded to ``batch_size`` so every step reuses one
        compiled shape; padded rows' ranks are trimmed before aggregation.
        """
        from unirec.train.common import pad_to_batch

        rank_fn = _jitted_rank_of_positive()
        ranks: List[np.ndarray] = []
        # the sharded eval forward splits the batch over dp
        batch_size = batch_size + (-batch_size) % self.dp_size
        for i in range(0, len(dataset), batch_size):
            idx = list(range(i, min(i + batch_size, len(dataset))))
            batch = dataset.batch(idx, max_negatives=max_negatives)
            batch, n = pad_to_batch(batch, batch_size)
            user = self._eval_fwd(
                state.params,
                jnp.asarray(batch["input_ids"]),
                jnp.asarray(batch["attention_mask"]),
                jnp.asarray(batch["history_field_embeddings"]),
                jnp.asarray(batch["history_attention_mask"]),
            )
            r = rank_fn(
                user,
                jnp.asarray(batch["positive_item_embeddings"]),
                jnp.asarray(batch["negative_item_embeddings"]),
                jnp.asarray(batch["negative_masks"]),
            )
            ranks.append(np.asarray(r)[:n])
        all_ranks = np.concatenate(ranks).astype(np.float64)
        out: Dict[str, float] = {"mrr": float(np.mean(1.0 / all_ranks))}
        for k in ks:
            hit = all_ranks <= k
            out[f"recall@{k}"] = float(hit.mean())
            out[f"ndcg@{k}"] = float(
                np.where(hit, 1.0 / np.log2(all_ranks + 1.0), 0.0).mean()
            )
        return out


@dataclasses.dataclass
class PipelinedJointTrainer:
    """GPipe-staged variant of the joint trainer (`parallel/pipeline.py`).

    For Qwen3 backbones deeper than one device's memory: the decoder stack's
    layer params shard over a ``pp`` mesh axis and microbatches stream
    through the stages (``lax.scan`` + ``ppermute``); the Q-Former +
    token injection stay plain GSPMD.  Semantics match ``JointTrainer``
    (same model modules, same InfoNCE + LoRA freeze + warmup/clip
    optimizer — tests/test_pipeline.py proves forward/grad parity); only
    the execution schedule differs.  ``trainer`` supplies model/config
    plumbing and the dp-sharded evaluator; tp>1 is refused.
    """

    trainer: JointTrainer
    pp: int
    num_microbatches: int = 1

    def __post_init__(self):
        from unirec.parallel.pipeline import PipelinedQwen3, make_pp_mesh

        t = self.trainer
        if t.tp_size > 1:
            raise ValueError("pipeline parallelism composes with dp only; "
                             "tp>1 is not supported (use --tp 1)")
        mesh_cfg = t.train_config.mesh
        dp = None if mesh_cfg.dp in (-1, 0) else mesh_cfg.dp
        self.mesh = make_pp_mesh(self.pp, dp=dp)
        self.dp_size = self.mesh.shape["dp"]
        self.pipe = PipelinedQwen3(
            t.qwen_config,
            self.mesh,
            num_microbatches=self.num_microbatches,
            lora=t.lora,
            dtype=jnp.bfloat16 if t.dtype == "bfloat16" else jnp.float32,
            remat=t.remat,
        )
        self._step = None

    # -- state ---------------------------------------------------------------

    def init_trainable(self, state: TrainState):
        """Split a JointTrainer state's params into the pp layout and lay
        them out on the mesh (stacked layers over pp, rest/qformer
        replicated).  Returns (trainable dict, opt_state, tx)."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        from unirec.parallel.pipeline import pp_shardings, split_joint_params

        stacked, rest, qf = split_joint_params(state.params)
        st_sh, rest_sh = pp_shardings(stacked, rest, self.mesh)
        stacked = jax.tree_util.tree_map(jax.device_put, stacked, st_sh)
        rest = jax.tree_util.tree_map(jax.device_put, rest, rest_sh)
        rep = NamedSharding(self.mesh, P())
        qf = jax.tree_util.tree_map(lambda x: jax.device_put(x, rep), qf)
        trainable = {"stacked": stacked, "rest": rest, "qformer": qf}
        # the same path-filtered freeze as JointTrainer: lora_a/lora_b/
        # extra_embed_tokens/qformer names survive layer stacking
        tx = make_joint_optimizer(trainable, self.trainer.train_config.optimizer)
        return trainable, tx.init(trainable), tx

    def merged_params(self, trainable, to_host: bool = False) -> Dict:
        """pp layout -> the regular joint param tree (checkpoint/eval).

        Stays on device by default (evals re-feed the tree straight into
        the jitted forward; a host round-trip would cost minutes at the
        GB-scale production tree).  ``to_host=True`` pulls to numpy for
        checkpoint writes."""
        from unirec.parallel.pipeline import merge_joint_params

        merged = merge_joint_params(
            trainable["stacked"], trainable["rest"], trainable["qformer"]
        )["params"]
        if to_host:
            merged = jax.tree_util.tree_map(np.asarray, merged)
        return merged

    # -- training ------------------------------------------------------------

    def _make_step(self, tx):
        from unirec.parallel.pipeline import joint_pp_forward

        model, pipe = self.trainer.model, self.pipe
        temperature = 0.07  # reference InfoNCE τ (:326-352)
        seed = self.trainer.train_config.seed

        def step(trainable, opt_state, n_step, batch):
            key = jax.random.fold_in(jax.random.key(seed, impl="rbg"), n_step)

            def loss_fn(tr):
                # same frozen-base grad pruning as make_joint_train_step:
                # stop_gradient lets XLA drop the 0.6B dW matmuls instead
                # of computing grads the optimizer would zero
                mask = lora_trainable_mask(tr)
                tr = jax.tree_util.tree_map(
                    lambda p, t: p if t else jax.lax.stop_gradient(p),
                    tr, mask,
                )
                user = joint_pp_forward(
                    model, pipe, tr["stacked"], tr["rest"], tr["qformer"],
                    batch["input_ids"], batch["attention_mask"],
                    batch["history_field_embeddings"],
                    batch["history_attention_mask"],
                    deterministic=False, dropout_rng=key,
                )
                return info_nce_loss(
                    user,
                    batch["positive_item_embeddings"],
                    batch["negative_item_embeddings"],
                    batch["negative_masks"],
                    temperature=temperature,
                )

            loss, grads = jax.value_and_grad(loss_fn)(trainable)
            updates, opt_state = tx.update(grads, opt_state, trainable)
            return optax.apply_updates(trainable, updates), opt_state, loss

        return jax.jit(step, donate_argnums=(0, 1))

    def train_steps(
        self,
        trainable,
        opt_state,
        tx,
        dataset: JointDataset,
        rng: np.random.Generator,
        num_steps: int,
        start_step: int = 0,
        step_hook=None,
    ):
        """Step-driven pp training mirroring JointTrainer.train_steps; the
        hook sees (global_step, merged-param getter, metrics)."""
        from unirec.parallel.mesh import shard_batch

        if self._step is None:
            self._step = self._make_step(tx)
        batch_size = self.trainer.train_config.batch_size
        loss = None
        stream = self.trainer._batch_stream(dataset, rng, batch_size, num_steps)
        for i, batch in enumerate(stream):
            batch = shard_batch(self.mesh, batch)
            trainable, opt_state, loss = self._step(
                trainable, opt_state, start_step + i, batch
            )
            if step_hook is not None:
                # the hook gets the DEVICE scalar — formatting/float() it
                # syncs, so hooks that only act every N steps (eval
                # cadence) stay sync-free in between (CLAUDE.md: no
                # per-step float() in train loops)
                step_hook(start_step + i + 1, trainable, {"loss": loss})
        last = {} if loss is None else {"loss": float(loss)}
        return trainable, opt_state, last

    def evaluate(self, trainable, dataset: JointDataset, **kw) -> Dict[str, float]:
        """Merge back to the regular tree and run JointTrainer's dp-sharded
        evaluator (identical metrics/padding semantics)."""
        import types

        shim = types.SimpleNamespace(params=self.merged_params(trainable))
        return self.trainer.evaluate(shim, dataset, **kw)
