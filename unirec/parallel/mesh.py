"""Device mesh + sharding layer.

The reference has no parallelism at all (single pinned GPU,
reference: training/train_item_individual_token_joint.py:33-34; audit in
SURVEY.md §2.4).  The replacement is the idiomatic JAX stack:

* one ``jax.sharding.Mesh`` with axes ``("dp", "tp", "sp")`` — data,
  tensor, and sequence parallelism (sp shards the user stage's long-history
  memory axis, ops/sharded_attention.py);
* batches sharded over ``dp`` via NamedSharding, params replicated over ``dp``
  and (optionally) tensor-sharded over ``tp``;
* gradient reduction happens inside jit via XLA collectives — no
  explicit psum needed under the shard-in/shard-out jit style.

All five pipeline stages train data-parallel (the largest model is 0.6B params
and fits per chip); the joint Qwen3 model additionally supports ``tp`` via
logical axis rules (unirec/models/qwen3.py).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from unirec.configs import MeshConfig

DP_AXIS = "dp"
TP_AXIS = "tp"
SP_AXIS = "sp"


def make_mesh(
    config: MeshConfig = MeshConfig(), devices: Optional[Sequence[Any]] = None
) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    tp, sp = max(1, config.tp), max(1, config.sp)
    if config.dp > 0:
        # explicit sizes: use the first dp*tp*sp devices
        need = config.dp * tp * sp
        if need > len(devices):
            raise ValueError(f"mesh {config.dp}x{tp}x{sp} needs {need} "
                             f"devices, have {len(devices)}")
        devices = devices[:need]
        dp = config.dp
    else:
        dp, tp, sp = config.axis_sizes(len(devices))
    dev_array = np.asarray(devices).reshape(dp, tp, sp)
    return Mesh(dev_array, (DP_AXIS, TP_AXIS, SP_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading batch axis split over dp, replicated over tp."""
    return NamedSharding(mesh, P(DP_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """Device-put a pytree of host arrays with batch-dim sharding.

    Pads nothing: callers must make the global batch divisible by dp
    (pad_batch below helps).
    """
    sh = batch_sharding(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), batch)


def replicate(mesh: Mesh, tree: Any) -> Any:
    sh = replicated(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)


def pad_batch(batch: Any, multiple: int):
    """Pad the leading axis of every leaf up to a multiple; returns
    (padded_batch, original_size)."""
    sizes = {x.shape[0] for x in jax.tree_util.tree_leaves(batch)}
    assert len(sizes) == 1, f"inconsistent batch dims: {sizes}"
    n = sizes.pop()
    pad = (-n) % multiple
    if pad == 0:
        return batch, n
    padded = jax.tree_util.tree_map(
        lambda x: np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0),
        batch,
    )
    return padded, n


def data_parallel_jit(step_fn, mesh: Mesh, donate_state: bool = True):
    """jit a (state, batch, ...) -> (state, metrics) step with state replicated
    and batch sharded over dp.  XLA inserts the gradient all-reduce."""
    state_sh = replicated(mesh)
    batch_sh = batch_sharding(mesh)
    return jax.jit(
        step_fn,
        in_shardings=(state_sh, batch_sh),
        out_shardings=(state_sh, state_sh),
        donate_argnums=(0,) if donate_state else (),
    )


def mixed_parallel_jit(
    step_fn, mesh: Mesh, state_shardings, donate_state: bool = True,
    n_extra_replicated: int = 0,
):
    """Like data_parallel_jit but with an explicit sharding tree for the train
    state (e.g. Qwen3 kernels tensor-sharded over 'tp' via
    models/qwen3.tp_shardings, everything else replicated).  Under GSPMD the
    matching activation shardings and all-reduces are inferred.

    ``n_extra_replicated``: trailing replicated-pytree args after (state,
    batch) — e.g. the frozen int8 qweights tree, which must ride as a jit
    ARGUMENT (closure capture would bake it into the executable as
    constants — CLAUDE.md / serving/recommender.py)."""
    batch_sh = batch_sharding(mesh)
    metrics_sh = replicated(mesh)
    return jax.jit(
        step_fn,
        in_shardings=(state_shardings, batch_sh)
        + (metrics_sh,) * n_extra_replicated,
        out_shardings=(state_shardings, metrics_sh),
        donate_argnums=(0,) if donate_state else (),
    )


def dp_shard_map_jit(step_fn, mesh: Mesh, donate_state: bool = True,
                     n_extra_replicated: int = 0):
    """jit an explicitly dp-mapped (state, batch) -> (state, metrics) step.

    ``jax.shard_map`` splits the batch explicitly: params replicated, batch
    leading axis over dp, and the step itself pmeans (loss, grads) over the
    axis (``make_joint_train_step(axis_name="dp")``), so the post-update
    state stays replicated.  tp is unsupported here.
    """
    mapped = jax.shard_map(
        step_fn,
        mesh=mesh,
        in_specs=(P(), P(DP_AXIS)) + (P(),) * n_extra_replicated,
        out_specs=(P(), P()),
        check_vma=False,  # pmean-ed outputs are replicated; skip the proof
    )
    return jax.jit(mapped, donate_argnums=(0,) if donate_state else ())


def shard_like(tree: Any, shardings: Any) -> Any:
    """device_put every leaf with its sharding from a matching tree."""
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, s), tree, shardings
    )


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Multi-host initialization (jax.distributed).

    The replacement for a distributed-communication backend — the reference
    has none at all (SURVEY.md §2.4).  Pass the coordinator address, the
    process count and this process's id unless the cluster environment is
    autodetected.  Returns the process count.  Safe to call when already
    initialized or single-process.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError):
        pass  # already initialized or single-process environment
    return jax.process_count()
