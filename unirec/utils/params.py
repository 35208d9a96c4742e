"""Parameter-tree utilities: merging converted weights into initialized trees
and path-based trainability filters for LoRA fine-tuning."""

from __future__ import annotations

from typing import Callable, Dict

import jax


def merge_params(template: Dict, loaded: Dict) -> Dict:
    """Overwrite leaves of ``template`` with matching entries from ``loaded``.

    Entries present only in ``template`` (e.g. fresh LoRA ``lora_a/lora_b`` or
    ``extra_embed_tokens``) are kept; entries only in ``loaded`` raise (they
    indicate a conversion/config mismatch).
    """
    out = dict(template)
    for k, v in loaded.items():
        if k not in template:
            raise KeyError(f"loaded param {k!r} not in model structure")
        if isinstance(v, dict) and isinstance(template[k], dict):
            out[k] = merge_params(template[k], v)
        else:
            out[k] = v
    return out


def path_contains(*needles: str) -> Callable:
    """Predicate on a jax tree path: any segment name contains a needle."""

    def pred(path) -> bool:
        names = [p.key if hasattr(p, "key") else str(p) for p in path]
        return any(n in name for name in names for n in needles)

    return pred


def trainable_mask(params: Dict, predicate: Callable) -> Dict:
    """Boolean pytree: True where predicate(path) — for optax.masked."""
    return jax.tree_util.tree_map_with_path(
        lambda path, _: bool(predicate(path)), params
    )


def lora_trainable_mask(params: Dict) -> Dict:
    """Joint-training trainability (reference: LoRA adapters + resized token
    embeddings + the whole Q-Former train jointly,
    train_item_individual_token_joint.py:121-132, 202-212, 710)."""
    return trainable_mask(
        params,
        path_contains("lora_a", "lora_b", "extra_embed_tokens", "qformer"),
    )


def count_params(tree: Dict) -> int:
    return sum(x.size for x in jax.tree_util.tree_leaves(tree))


def cast_frozen_to_bf16(params: Dict) -> Dict:
    """Store the frozen Qwen3 base subtree in bfloat16.

    The joint model's bf16 compute mode casts every kernel to bf16 at use
    (models/qwen3.py DenseWithLoRA), so bf16 *storage* of frozen params is
    numerically identical on that path while halving their device memory footprint
    (0.6B params: 2.4 GB -> 1.2 GB) — freeing memory for larger batches or
    no-remat training.  Trainable leaves (LoRA, extra token embeddings, the
    Q-Former — `lora_trainable_mask`) keep fp32 masters; integer leaves are
    untouched.
    """
    import jax.numpy as jnp

    mask = lora_trainable_mask(params)
    return jax.tree_util.tree_map(
        lambda p, t: p
        if t or not jnp.issubdtype(p.dtype, jnp.floating)
        else p.astype(jnp.bfloat16),
        params,
        mask,
    )


def prune_to_structure(tree: Dict, template: Dict) -> Dict:
    """Recursively keep only the keys ``template`` has.

    Torch state dicts materialize params the query-only flax modules never
    create (e.g. BertLayer's text-FFN, absolute position tables in relative
    mode); converters emit them for completeness — prune before merging into
    a flax param tree.
    """
    if isinstance(template, dict):
        return {k: prune_to_structure(tree[k], template[k]) for k in template}
    return tree


def merge_lora_weights(params: Dict, scaling: float) -> Dict:
    """Fold trained LoRA adapters into their base kernels for deployment.

    The PEFT ``merge_and_unload`` move (reference serving would deploy the
    PEFT adapter this way): wherever a module holds ``kernel`` + ``lora_a``
    + ``lora_b``, produce ``kernel + (A @ B) * scaling`` (fp32 accumulate,
    stored back in the kernel's dtype) and DROP the adapter leaves.  Use the
    result with a model built with ``lora=None`` — the serving forward then
    runs 2 fewer matmuls per projection, and int8 quantization sees the
    adapted weights (``scaling`` = LoRAConfig.scaling = alpha/r).
    """
    import jax.numpy as jnp

    def walk(tree: Dict) -> Dict:
        out = {}
        for k, v in tree.items():
            if not isinstance(v, dict):
                out[k] = v
            elif "kernel" in v and "lora_a" in v and "lora_b" in v:
                merged = {
                    kk: vv for kk, vv in v.items()
                    if kk not in ("lora_a", "lora_b")
                }
                delta = (
                    v["lora_a"].astype(jnp.float32)
                    @ v["lora_b"].astype(jnp.float32)
                ) * scaling
                merged["kernel"] = (
                    v["kernel"].astype(jnp.float32) + delta
                ).astype(v["kernel"].dtype)
                out[k] = merged
            else:
                out[k] = walk(v)
        return out

    return walk(params)
