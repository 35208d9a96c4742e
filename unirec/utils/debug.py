"""Debugging aids (SURVEY.md §5 "race detection/sanitizers": the JAX-native
equivalents are NaN/Inf checks and disabled-jit tracing)."""

from __future__ import annotations

import contextlib

import jax


def enable_nan_checks(enable: bool = True) -> None:
    """Raise on NaN/Inf produced by any jitted computation."""
    jax.config.update("jax_debug_nans", enable)
    jax.config.update("jax_debug_infs", enable)


@contextlib.contextmanager
def nan_checks():
    prev_nan = jax.config.jax_debug_nans
    prev_inf = jax.config.jax_debug_infs
    enable_nan_checks(True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev_nan)
        jax.config.update("jax_debug_infs", prev_inf)


@contextlib.contextmanager
def eager_mode():
    """Run without jit for step-through debugging."""
    with jax.disable_jit():
        yield


def capture_attention_maps(model, variables, *args, **kwargs):
    """Run a Q-Former-family forward and return its per-layer attention maps.

    Functional equivalent of the reference's attention hooks
    (``save_attention=True`` → ``save_attention_map``/``attention_map``,
    reference: models/qformer.py:147-159, 252-254): instead of mutating
    module state, the post-dropout probabilities are sown into the
    ``intermediates`` collection and returned alongside the model outputs.

    Works for any model whose ``config`` attribute is one of the Q-Former
    config dataclasses (``QFormer``, ``ItemQFormer``, ``UserQFormer``):
    the model is cloned with ``capture_attention_probs=True`` (paths that
    never materialize probs — fast/sp — are disabled for the introspection
    pass; numerics match the strict fp32 path).

    Returns:
      ``(outputs, maps)`` where ``maps`` is an ordered dict
      ``{module_path: [B, H, Lq, Lkv] fp32 probs}`` with one entry per
      attention module in layer order, e.g.
      ``qformer/encoder/layers_0/self_attention``.
    """
    import dataclasses

    from unirec.nn import flatten_dict

    cfg = model.config
    field_names = {f.name for f in dataclasses.fields(cfg)}
    overrides = {"capture_attention_probs": True}
    for name in (
        "fast_attention",
        "sequence_parallel",
        # sown intermediates inside nn.remat-wrapped layers are dropped;
        # the introspection pass runs without checkpointing
        "gradient_checkpointing",
    ):
        if name in field_names:
            overrides[name] = False
    probed = model.clone(config=dataclasses.replace(cfg, **overrides))
    outputs, mutated = probed.apply(
        variables, *args, mutable="intermediates", **kwargs
    )
    flat = flatten_dict(
        mutated.get("intermediates", {})
    )
    maps = {
        "/".join(path[:-1]): values[0]
        for path, values in flat.items()
        if path[-1] == "attention_probs"
    }
    return outputs, maps
