"""Shared training utilities: train state, optimizer factory, batching."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax

from unirec.configs import OptimizerConfig


@dataclasses.dataclass(frozen=True)
class TrainState:
    """Step counter, params and optimizer state as one pytree; ``apply_fn``
    and ``tx`` ride along as static metadata."""

    step: Any
    apply_fn: Callable
    params: Any
    tx: optax.GradientTransformation
    opt_state: Any

    @classmethod
    def create(cls, *, apply_fn, params, tx, **kwargs) -> "TrainState":
        return cls(step=0, apply_fn=apply_fn, params=params, tx=tx,
                   opt_state=tx.init(params), **kwargs)

    def apply_gradients(self, *, grads, **kwargs) -> "TrainState":
        updates, opt_state = self.tx.update(grads, self.opt_state, self.params)
        return self.replace(step=self.step + 1,
                            params=optax.apply_updates(self.params, updates),
                            opt_state=opt_state, **kwargs)

    def replace(self, **updates) -> "TrainState":
        return dataclasses.replace(self, **updates)


jax.tree_util.register_dataclass(
    TrainState, data_fields=["step", "params", "opt_state"],
    meta_fields=["apply_fn", "tx"])


def make_optimizer(cfg: OptimizerConfig) -> optax.GradientTransformation:
    """AdamW with optional warmup + global-norm clipping.

    Mirrors the reference stacks: AdamW everywhere
    (item_qformer_training.py:107, user_qformer_training.py:194), warmup +
    clip 1.0 on the joint run (train_item_individual_token_joint.py:768-769).
    """
    if cfg.warmup_steps > 0:
        # linear_schedule clamps at transition_steps, so it already holds
        # cfg.learning_rate for every step >= warmup_steps
        lr = optax.linear_schedule(0.0, cfg.learning_rate, cfg.warmup_steps)
    else:
        lr = cfg.learning_rate
    tx = optax.adamw(
        lr, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, weight_decay=cfg.weight_decay
    )
    if cfg.max_grad_norm > 0:
        tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm), tx)
    if cfg.gradient_accumulation_steps > 1:
        # MultiSteps averages grads over k micro-steps and applies the inner
        # chain once on the average, so clipping/warmup act on the effective
        # batch exactly like HF's gradient_accumulation_steps (reference
        # train_item_individual_token_joint.py:758); intermediate micro-steps
        # emit zero updates (params unchanged until the k-th step).
        # HF-parity note: the HF Trainer forces an optimizer apply on the
        # last (possibly incomplete) accumulation of each epoch, while
        # MultiSteps carries a partial accumulation across the epoch
        # boundary.  The end-of-training tail is FLUSHED by the drivers via
        # flush_grad_accum() below, so pending micro-grads always land;
        # the remaining divergence is only that mid-run epoch boundaries
        # defer (never drop) at most k-1 micro-batches to the next epoch.
        tx = optax.MultiSteps(
            tx, every_k_schedule=cfg.gradient_accumulation_steps
        )
    return tx


def flush_grad_accum(state: TrainState, cfg: OptimizerConfig) -> TrainState:
    """Force-apply any pending micro-gradient accumulation at end of training.

    optax.MultiSteps holds the running MEAN of the micro-grads received since
    the last apply in ``acc_grads`` (mini_step counts them).  When training
    ends mid-accumulation (mini_step != 0) the HF Trainer semantics are to
    apply that partial average (reference joint stage runs under HF Trainer,
    train_item_individual_token_joint.py:755-773); this applies the inner
    AdamW chain once on ``acc_grads`` and resets the MultiSteps counters.
    No-op when grad accumulation is off or the accumulator is empty.
    ``state.step`` is left unchanged: it counts micro-steps (data consumed),
    and no new micro-batch is consumed by the flush.
    """
    import dataclasses

    opt = state.opt_state
    if not isinstance(opt, optax.MultiStepsState):
        return state
    if int(jax.device_get(opt.mini_step)) == 0:
        return state
    inner_tx = make_optimizer(
        dataclasses.replace(cfg, gradient_accumulation_steps=1)
    )
    updates, new_inner = inner_tx.update(
        opt.acc_grads, opt.inner_opt_state, state.params
    )
    new_params = optax.apply_updates(state.params, updates)
    new_opt = opt._replace(
        mini_step=jnp.zeros_like(opt.mini_step),
        gradient_step=opt.gradient_step + 1,
        inner_opt_state=new_inner,
        acc_grads=jax.tree_util.tree_map(jnp.zeros_like, opt.acc_grads),
    )
    return state.replace(params=new_params, opt_state=new_opt)


def epoch_batches(
    rng: np.random.Generator,
    num_examples: int,
    batch_size: int,
    shuffle: bool = True,
    drop_last: Optional[bool] = None,
) -> Iterator[np.ndarray]:
    """Yield index arrays per batch; host-side, cheap.

    drop_last defaults to True whenever at least one full batch exists: a
    ragged tail batch would retrace/recompile the jitted step for a new shape
    (a fresh compile).  When the dataset is smaller than one
    batch, the single short batch is yielded.
    """
    idx = np.arange(num_examples)
    if shuffle:
        rng.shuffle(idx)
    if drop_last is None:
        drop_last = num_examples >= batch_size
    stop = num_examples - (num_examples % batch_size) if drop_last else num_examples
    stop = max(stop, min(batch_size, num_examples))
    for i in range(0, stop, batch_size):
        yield idx[i : i + batch_size]


def pad_to_batch(batch, batch_size: int):
    """Pad a dict-of-arrays batch to a fixed leading size (repeat last row);
    returns (padded, original_n).  Keeps eval jit shapes constant."""
    n = next(iter(batch.values())).shape[0]
    if n == batch_size:
        return batch, n
    pad = batch_size - n
    padded = {
        k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)
        for k, v in batch.items()
    }
    return padded, n


def prefetch_to_device(iterator, size: int = 2, sharding=None):
    """Double-buffered device prefetch: keeps `size` batches in flight so the
    host-side gather/assembly of batch N+1 overlaps the device step on batch
    N (the JAX analog of the reference's DataLoader prefetch_factor,
    item_qformer_training.py:86-102)."""
    import collections
    import itertools

    import jax

    queue = collections.deque()

    def put(batch):
        if sharding is not None:
            batch = jax.tree_util.tree_map(
                lambda x: jax.device_put(x, sharding), batch
            )
        else:
            batch = jax.tree_util.tree_map(jax.device_put, batch)
        queue.append(batch)

    it = iter(iterator)
    for batch in itertools.islice(it, size):
        put(batch)
    while queue:
        yield queue.popleft()
        for batch in itertools.islice(it, 1):
            put(batch)


def drive_steps(
    train_step,
    state,
    batches,
    *,
    sharding=None,
    prefetch: int = 2,
    max_in_flight: int = 2,
    step_hook=None,
):
    """Drive a jitted train step over host-assembled batches with overlap.

    Batches flow through ``prefetch_to_device`` (assembly + transfer of batch
    N+1 overlaps the device step on batch N), steps are dispatched
    asynchronously, and metric scalars are synced ``max_in_flight`` steps late
    so at most that many steps (and their on-device batches) are in flight —
    the host never serializes with the device, and device memory holds a bounded number
    of staged batches.  This is the analog of the reference DataLoader's
    pin_memory + prefetch_factor (reference: item_qformer_training.py:86-102).

    ``step_hook(step_index, state, metrics_floats)`` forces a per-step sync
    (hooks observe real values); pass None for maximum overlap.

    Returns ``(state, mean_metrics, last_metrics)``.
    """
    import collections

    queue: collections.deque = collections.deque()
    sums: Dict[str, float] = {}
    count = 0
    last: Dict[str, float] = {}

    def drain_one():
        nonlocal count, last
        m = queue.popleft()
        floats = {k: float(v) for k, v in m.items()}
        for k, v in floats.items():
            sums[k] = sums.get(k, 0.0) + v
        count += 1
        last = floats
        return floats

    step_index = 0
    for batch in prefetch_to_device(batches, prefetch, sharding=sharding):
        state, metrics = train_step(state, batch)
        queue.append(metrics)
        if step_hook is not None:
            floats = drain_one()
            state = step_hook(step_index, state, floats) or state
        elif len(queue) >= max_in_flight:
            # drain at the bound (>=, not >): with `>` the queue reached
            # max_in_flight+1 dispatched steps before the first drain,
            # holding one extra staged batch in device memory (code-review r3)
            drain_one()
        step_index += 1
    while queue:
        drain_one()
    mean = {k: v / max(count, 1) for k, v in sums.items()}
    return state, mean, last


def mean_metrics(metric_list: Sequence[Dict[str, Any]]) -> Dict[str, float]:
    if not metric_list:
        return {}
    keys = metric_list[0].keys()
    return {k: float(np.mean([float(m[k]) for m in metric_list])) for k in keys}
