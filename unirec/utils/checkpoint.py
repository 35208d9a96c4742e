"""Checkpointing (orbax) with the reference's metadata contract.

The reference saves ad-hoc torch dicts with no optimizer state and no step
resume (SURVEY.md §5 "Checkpoint / resume").  Here every stage checkpoints
{params, opt_state, step} via orbax plus a JSON sidecar carrying the model
config and ``field_names`` (the reference contract that drives model shape at
load, reference: training/item_qformer_training.py:178-182).  orbax is
imported inside save and restore only: nothing else needs it.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import jax
import numpy as np


def _host_tree(tree: Any) -> Any:
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def save_checkpoint(
    directory: str,
    state: Any,
    config: Optional[Any] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Save a TrainState (or any pytree) + config/extra metadata."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "state")
    import orbax.checkpoint as ocp

    ckpt = ocp.PyTreeCheckpointer()
    tree = {
        "params": _host_tree(state.params),
        "opt_state": _host_tree(state.opt_state),
        "step": int(state.step),
    }
    ckpt.save(path, tree, force=True)
    meta: Dict[str, Any] = dict(extra or {})
    if config is not None:
        meta["config"] = dataclasses.asdict(config)
        meta["config_class"] = type(config).__name__
    with open(os.path.join(directory, "meta.json"), "w") as f:
        json.dump(meta, f, default=str)
    return directory


def load_checkpoint(
    directory: str, target: Optional[Any] = None
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Returns (tree with params/opt_state/step, meta dict).

    Pass ``target`` (a template tree, e.g. from a freshly created TrainState:
    ``{"params": s.params, "opt_state": s.opt_state, "step": 0}``) to restore
    optax NamedTuple structures — orbax otherwise returns plain dicts, which
    optax update functions reject.
    """
    directory = os.path.abspath(directory)
    import orbax.checkpoint as ocp

    ckpt = ocp.PyTreeCheckpointer()
    path = os.path.join(directory, "state")
    if target is not None:
        template = _host_tree(target)
        try:
            tree = ckpt.restore(path, item=template)
        except TypeError:  # newer orbax arg API
            tree = ckpt.restore(
                path, args=ocp.args.PyTreeRestore(item=template)
            )
    else:
        tree = ckpt.restore(path)
    meta_path = os.path.join(directory, "meta.json")
    meta: Dict[str, Any] = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return tree, meta


def restore_train_state(directory: str, template_state):
    """Restore a full TrainState (params + optimizer state + step) from a
    checkpoint using a freshly initialized state as the structure template."""
    target = {
        "params": template_state.params,
        "opt_state": template_state.opt_state,
        "step": 0,
    }
    tree, meta = load_checkpoint(directory, target=target)
    state = template_state.replace(
        params=tree["params"],
        opt_state=tree["opt_state"],
        step=int(tree["step"]),
    )
    return state, meta


def check_grad_accum(meta: Dict[str, Any], expected: int) -> None:
    """Validate a checkpoint's gradient-accumulation setting against the
    resuming run's.  optax.MultiSteps wraps the opt_state pytree
    (MultiStepsState around the inner chain), so a mismatched --grad-accum
    either fails the orbax template restore opaquely or — when both values
    are >1 — silently mis-restores the mini_step/acc_grads counters.
    Checkpoints from before this field was recorded default to 1."""
    saved = int(meta.get("grad_accum", 1))
    if saved != int(expected):
        raise ValueError(
            f"checkpoint was saved with gradient accumulation {saved} but "
            f"this run uses {int(expected)}; the optimizer-state layout "
            "depends on it — resume with the matching --grad-accum"
        )


def read_meta(directory: str) -> Dict[str, Any]:
    meta_path = os.path.join(os.path.abspath(directory), "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


def resume_train_state(directory: Optional[str], template_state,
                       log_fn=print, expect_grad_accum: Optional[int] = None):
    """``restore_train_state`` with the trainer-resume contract: error
    loudly when no checkpoint exists instead of silently training from
    scratch over the intended continuation.  Pass ``expect_grad_accum`` to
    fail fast (before the orbax restore) on an accumulation mismatch."""
    if not (directory and os.path.exists(os.path.join(directory, "state"))):
        raise FileNotFoundError(
            f"resume requested but no checkpoint under {directory!r}"
        )
    if expect_grad_accum is not None:
        check_grad_accum(read_meta(directory), expect_grad_accum)
    state, meta = restore_train_state(directory, template_state)
    log_fn(f"resumed from {directory} at step {int(state.step)}")
    return state, meta


def restore_config(meta: Dict[str, Any], config_cls):
    cfg = dict(meta.get("config", {}))
    fields = {f.name for f in dataclasses.fields(config_cls)}
    return config_cls(**{k: v for k, v in cfg.items() if k in fields})
