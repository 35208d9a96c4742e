"""GPipe-style pipeline parallelism (``pp`` mesh axis) for the Qwen3 decoder.

The reference is strictly single-GPU (SURVEY.md §2.4: no parallelism of any
kind; the joint trainer pins device 0 at
training/train_item_individual_token_joint.py:33-34).  The rebuild already
scales via ``dp`` (batch) and ``tp`` (Megatron column/row splits,
models/qwen3.tp_shardings).  This module adds the third classic axis so
backbones DEEPER than one device's memory scale by layer count:

* the per-layer parameter subtrees (``layers_0..layers_{n-1}``) are stacked
  into leaves with a leading ``[num_layers, ...]`` axis and sharded over the
  ``pp`` mesh axis — each stage holds ``num_layers / pp_size`` consecutive
  layers and *only* those weights;
* the local batch is split into M microbatches that stream through the
  stages: each pipeline tick runs one stage forward (a ``lax.scan`` over the
  stage's local layers) and rotates activations to the next stage with
  ``lax.ppermute`` — the GPipe schedule, bubble fraction
  ``(S-1)/(M+S-1)``;
* the whole pipeline is a single differentiable jit program: the backward
  pipeline falls out of ``jax.vjp`` through ``scan`` + ``ppermute`` (whose
  transpose is the reverse rotation), so training works without a hand-written
  backward schedule.  ``remat=True`` checkpoints each layer application so
  the saved residuals stay O(microbatch), not O(ticks · layers).

Design notes:

* activations cross stages as merged ``[mb, L, D]`` tensors — one
  ppermute per tick, no host involvement;
* microbatch *inputs* are replicated over ``pp`` (only stage 0 reads them);
  this costs ``B_local·L·D`` device memory per stage but keeps the input feed a plain
  dp-sharded device_put.  Weights — the reason pp exists — are strictly
  partitioned;
* the final ``[M, mb, L, D]`` output buffer is valid on the last stage and
  broadcast with one ``psum`` over ``pp`` (zeros elsewhere), so callers see a
  replicated-over-pp, dp-sharded activation, composable with GSPMD ops
  downstream (pooling, losses).

Composable with ``dp`` in the same mesh (``make_pp_mesh``); ``tp``×``pp`` in
one program is out of scope for the 0.6B flagship (tp alone covers it — see
PARITY.md).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from unirec.configs import LoRAConfig, Qwen3Config
from unirec.models.qwen3 import (
    Qwen3Layer,
    RMSNorm,
    causal_bias,
    rotary_embedding,
)

try:  # jax >= 0.4.35 exports it at the top level
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

DP_AXIS = "dp"
PP_AXIS = "pp"

_LAYER_PREFIX = "layers_"


def make_pp_mesh(
    pp: int, dp: Optional[int] = None, devices=None
) -> Mesh:
    """A ``(dp, pp)`` mesh: batch over ``dp``, pipeline stages over ``pp``."""
    devices = list(devices if devices is not None else jax.devices())
    if dp is None:
        dp = len(devices) // pp
    need = dp * pp
    if need > len(devices):
        raise ValueError(f"mesh {dp}x{pp} needs {need} devices, "
                         f"have {len(devices)}")
    dev = np.asarray(devices[:need]).reshape(dp, pp)
    return Mesh(dev, (DP_AXIS, PP_AXIS))


def split_layer_params(params: Dict) -> Tuple[Dict, Dict]:
    """Qwen3Model params -> (stacked layer tree ``[L, ...]``, rest).

    ``stacked`` holds every ``layers_i`` leaf stacked on a new leading layer
    axis (the axis ``pp`` shards); ``rest`` is everything else (embeddings,
    final norm) verbatim.
    """
    inner = params["params"] if "params" in params else params
    keys = sorted(
        (k for k in inner if k.startswith(_LAYER_PREFIX)),
        key=lambda k: int(k[len(_LAYER_PREFIX):]),
    )
    if not keys:
        raise ValueError("no layers_* subtrees in params")
    stacked = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs, axis=0), *(inner[k] for k in keys)
    )
    rest = {k: v for k, v in inner.items() if not k.startswith(_LAYER_PREFIX)}
    return stacked, rest


def merge_layer_params(stacked: Dict, rest: Dict) -> Dict:
    """Inverse of split_layer_params (for checkpoint interchange)."""
    n = jax.tree_util.tree_leaves(stacked)[0].shape[0]
    out = dict(rest)
    for i in range(n):
        out[f"{_LAYER_PREFIX}{i}"] = jax.tree_util.tree_map(
            lambda x, i=i: x[i], stacked
        )
    return {"params": out}


def pp_shardings(stacked: Dict, rest: Dict, mesh: Mesh):
    """NamedSharding trees: stacked layers split over ``pp`` on the leading
    (layer) axis, rest replicated.  Use as jit in_shardings / device_put."""
    st = jax.tree_util.tree_map(
        lambda x: NamedSharding(
            mesh, P(PP_AXIS, *([None] * (jnp.ndim(x) - 1)))
        ),
        stacked,
    )
    rp = jax.tree_util.tree_map(lambda x: NamedSharding(mesh, P()), rest)
    return st, rp


@dataclasses.dataclass
class PipelinedQwen3:
    """Qwen3 decoder stack executed as a dp x pp pipeline.

    Numerically identical to ``models.qwen3.Qwen3Model`` (same ``Qwen3Layer``
    modules, same mask/rope semantics — parity-tested in
    tests/test_pipeline.py); only the execution schedule differs.

    ``num_microbatches`` (M) splits each dp-local batch: larger M shrinks the
    pipeline bubble ``(S-1)/(M+S-1)`` but shrinks the per-stage matmul rows —
    keep ``batch/(dp·M)`` big enough to fill the matmul units.
    """

    config: Qwen3Config
    mesh: Mesh
    num_microbatches: int = 1
    lora: Optional[LoRAConfig] = None
    n_extra_tokens: int = 0
    dtype: Any = jnp.float32
    remat: bool = True

    @property
    def num_stages(self) -> int:
        return self.mesh.shape[PP_AXIS]

    def __post_init__(self):
        s = self.num_stages
        if self.config.num_hidden_layers % s:
            raise ValueError(
                f"num_hidden_layers={self.config.num_hidden_layers} not "
                f"divisible by pp={s}"
            )

    # -- parameter helpers ---------------------------------------------------

    def init(self, rng, sample_len: int = 8):
        """Stacked init: returns (stacked, rest) already laid out for pp."""
        from unirec.models.qwen3 import Qwen3Model

        model = Qwen3Model(
            self.config, lora=self.lora, n_extra_tokens=self.n_extra_tokens,
            dtype=self.dtype,
        )
        params = model.init(
            rng, jnp.zeros((1, sample_len), jnp.int32),
            jnp.ones((1, sample_len), jnp.float32),
        )
        stacked, rest = split_layer_params(params)
        st_sh, rp_sh = pp_shardings(stacked, rest, self.mesh)
        return (
            jax.tree_util.tree_map(jax.device_put, stacked, st_sh),
            jax.tree_util.tree_map(jax.device_put, rest, rp_sh),
        )

    # -- forward ---------------------------------------------------------------

    def __call__(
        self,
        stacked: Dict,
        rest: Dict,
        input_ids: Optional[jax.Array] = None,
        attention_mask: Optional[jax.Array] = None,
        inputs_embeds: Optional[jax.Array] = None,
        position_ids: Optional[jax.Array] = None,
        deterministic: bool = True,
        dropout_rng: Optional[jax.Array] = None,
    ) -> jax.Array:
        """[B, L, D] final-norm hidden states (B = global batch).

        Call under ``jax.jit`` with ``pp_shardings`` on the params and the
        batch dp-sharded; the pipeline body is an explicit ``shard_map``.
        """
        cfg = self.config
        mesh = self.mesh
        S = self.num_stages
        M = self.num_microbatches
        dp = mesh.shape[DP_AXIS]
        lps = cfg.num_hidden_layers // S

        # ---- embedding (GSPMD; replicated over pp, batch over dp) ----
        if inputs_embeds is None:
            if input_ids is None:
                raise ValueError("need input_ids or inputs_embeds")
            table = rest["embed_tokens"].astype(self.dtype)
            if self.n_extra_tokens > 0:
                table = jnp.concatenate(
                    [table, rest["extra_embed_tokens"].astype(self.dtype)],
                    axis=0,
                )
            inputs_embeds = jnp.take(table, input_ids, axis=0)
        b, l, d = inputs_embeds.shape
        if b % (dp * M):
            raise ValueError(
                f"batch {b} must be a multiple of "
                f"dp*num_microbatches={dp * M}"
            )

        if position_ids is None:
            position_ids = jnp.arange(l)[None, :].repeat(b, axis=0)
        cos, sin = rotary_embedding(
            position_ids, cfg.head_dim, cfg.rope_theta, dtype=self.dtype
        )

        mask = (
            attention_mask.astype(jnp.float32)
            if attention_mask is not None
            else jnp.ones((b, l), jnp.float32)
        )
        bias = causal_bias(mask, l)

        use_dropout = (
            not deterministic
            and self.lora is not None
            and self.lora.dropout > 0.0
        )
        if use_dropout and dropout_rng is None:
            raise ValueError("dropout requires dropout_rng")

        layer_mod = Qwen3Layer(cfg, self.lora, dtype=self.dtype)

        def apply_layer(lp, h, bias_i, cos_i, sin_i, key):
            rngs = {"dropout": key} if use_dropout else None
            return layer_mod.apply(
                {"params": lp}, h, bias_i, cos_i, sin_i, deterministic,
                rngs=rngs,
            )

        if self.remat:
            apply_layer = jax.checkpoint(apply_layer)

        hidden = inputs_embeds.astype(self.dtype)

        def pipeline(local_layers, x, bias_x, cos_x, sin_x, key):
            # local shapes: x [b_local, L, D]; microbatch views [M, mb, ...]
            b_local = x.shape[0]
            mb = b_local // M
            x_mb = x.reshape(M, mb, l, d)
            cos_mb = cos_x.reshape(M, mb, *cos_x.shape[1:])
            sin_mb = sin_x.reshape(M, mb, *sin_x.shape[1:])
            bias_mb = bias_x.reshape(M, mb, *bias_x.shape[1:])
            stage = lax.axis_index(PP_AXIS)

            def run_stage(h, mb_idx):
                def body(h, xs):
                    lp, li = xs
                    k = None
                    if use_dropout:
                        # fold in (dp shard, layer, microbatch): without the
                        # dp index every shard would draw identical dropout
                        # masks for its local rows (key enters shard_map
                        # replicated), giving 1/dp the mask randomness of
                        # the GSPMD dp trainers
                        gidx = stage * lps + li
                        k = jax.random.fold_in(
                            jax.random.fold_in(
                                jax.random.fold_in(
                                    key, lax.axis_index(DP_AXIS)
                                ),
                                gidx,
                            ),
                            mb_idx,
                        )
                    h = apply_layer(
                        lp, h, bias_mb[mb_idx], cos_mb[mb_idx],
                        sin_mb[mb_idx], k,
                    )
                    return h, None

                h, _ = lax.scan(
                    body, h, (local_layers, jnp.arange(lps))
                )
                return h

            perm = [(i, (i + 1) % S) for i in range(S)]

            def tick(carry, t):
                recv, y = carry
                idx = t - stage  # microbatch this stage works on
                cidx = jnp.clip(idx, 0, M - 1)
                inp = jnp.where(
                    stage == 0,
                    lax.dynamic_index_in_dim(
                        x_mb, jnp.clip(t, 0, M - 1), 0, keepdims=False
                    ),
                    recv,
                )
                h = run_stage(inp, cidx)
                write = (idx >= 0) & (idx < M) & (stage == S - 1)
                cur = lax.dynamic_index_in_dim(y, cidx, 0, keepdims=False)
                y = lax.dynamic_update_index_in_dim(
                    y, jnp.where(write, h, cur), cidx, 0
                )
                recv = lax.ppermute(h, PP_AXIS, perm)
                return (recv, y), None

            y0 = jnp.zeros((M, mb, l, d), self.dtype)
            recv0 = jnp.zeros((mb, l, d), self.dtype)
            (_, y), _ = lax.scan(
                tick, (recv0, y0), jnp.arange(M + S - 1)
            )
            # output lives on the last stage; broadcast over pp
            y = lax.psum(jnp.where(stage == S - 1, y, 0.0), PP_AXIS)
            return y.reshape(b_local, l, d)

        batch_sp = P(DP_AXIS)
        layer_sp = jax.tree_util.tree_map(
            lambda x: P(PP_AXIS, *([None] * (jnp.ndim(x) - 1))), stacked
        )
        in_specs = (
            layer_sp, batch_sp, batch_sp, batch_sp, batch_sp,
            None if dropout_rng is None else P(),
        )
        fn = shard_map(
            pipeline, mesh=mesh, in_specs=in_specs, out_specs=batch_sp,
            check_vma=False,
        )
        out = fn(stacked, hidden, bias, cos, sin, dropout_rng)

        norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype=self.dtype)
        return norm.apply({"params": rest["norm"]}, out)


# ---------------------------------------------------------------------------
# Flagship composition: the joint model with a pipelined backbone
# ---------------------------------------------------------------------------


def split_joint_params(params: Dict) -> Tuple[Dict, Dict, Dict]:
    """MultiModalQwenEmbedding params -> (stacked backbone layers,
    backbone rest, qformer params) laid out for the pp pipeline."""
    inner = params["params"] if "params" in params else params
    stacked, rest = split_layer_params(inner["base_model"])
    return stacked, rest, inner.get("qformer", {})


def merge_joint_params(stacked: Dict, rest: Dict, qformer: Dict) -> Dict:
    """Inverse of split_joint_params (checkpoint interchange)."""
    base = merge_layer_params(stacked, rest)["params"]
    out = {"base_model": base}
    if qformer:
        out["qformer"] = qformer
    return {"params": out}


def joint_pp_forward(
    model,
    pipe: PipelinedQwen3,
    stacked: Dict,
    base_rest: Dict,
    qformer_params: Dict,
    input_ids: jax.Array,
    attention_mask: Optional[jax.Array] = None,
    history_field_embeddings: Optional[jax.Array] = None,
    history_attention_mask: Optional[jax.Array] = None,
    deterministic: bool = True,
    dropout_rng: Optional[jax.Array] = None,
) -> jax.Array:
    """The flagship joint forward with the Qwen3 backbone pipelined.

    Semantically identical to ``models.joint.MultiModalQwenEmbedding``
    (parity-tested, tests/test_pipeline.py): Q-Former over history fields +
    vectorized query-token injection run under plain GSPMD (dp-sharded batch,
    replicated over pp — they are ~2 layers of compute vs the 28-layer
    backbone), then the decoder stack streams through the pp stages.
    ``pipe`` must be built with the backbone's config/lora/dtype.
    """
    from unirec.models.item_qformer import ItemQFormer
    from unirec.models.qwen3 import last_token_pool, mean_pool

    jc = model.joint_config
    n_special = model.num_special_tokens

    table = base_rest["embed_tokens"].astype(pipe.dtype)
    if n_special > 0:
        table = jnp.concatenate(
            [table, base_rest["extra_embed_tokens"].astype(pipe.dtype)],
            axis=0,
        )
    text_embeds = jnp.take(table, input_ids, axis=0)

    if history_field_embeddings is not None:
        if history_attention_mask is None:
            raise ValueError("history_attention_mask required with history")
        b, num_hist, num_fields, field_dim = history_field_embeddings.shape
        qformer = ItemQFormer(model.qformer_config, dtype=pipe.dtype)
        rngs = None
        if not deterministic:
            if dropout_rng is None:
                raise ValueError("dropout requires dropout_rng")
            # decorrelate from the pipeline's (layer, microbatch) keys
            rngs = {"dropout": jax.random.fold_in(dropout_rng, 1 << 20)}
        q_out = qformer.apply(
            {"params": qformer_params},
            history_field_embeddings.reshape(
                b * num_hist, num_fields, field_dim
            ),
            history_attention_mask.reshape(b * num_hist, num_fields),
            deterministic=deterministic,
            rngs=rngs,
        )["query_outputs"]
        k_per_item = jc.num_query_tokens_per_item
        tokens = q_out[:, :k_per_item, :].reshape(
            b, num_hist * k_per_item, -1
        )
        # vectorized injection — identical math to models/joint.py
        offset = input_ids - model.first_special_id
        valid = (offset >= 0) & (offset < n_special)
        safe = jnp.clip(offset, 0, n_special - 1)
        gathered = jnp.take_along_axis(
            tokens.astype(text_embeds.dtype), safe[..., None], axis=1
        )
        text_embeds = jnp.where(valid[..., None], gathered, text_embeds)

    hidden = pipe(
        stacked, base_rest,
        inputs_embeds=text_embeds,
        attention_mask=attention_mask,
        deterministic=deterministic,
        dropout_rng=dropout_rng,
    )

    pool = jc.pool
    if pool == "mean":
        return mean_pool(hidden)
    if pool == "masked_mean":
        return mean_pool(hidden, attention_mask, masked=True)
    if pool == "last_token":
        return last_token_pool(hidden, attention_mask)
    raise ValueError(f"unknown pool {pool}")
