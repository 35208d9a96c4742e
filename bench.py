#!/usr/bin/env python
"""Item-query-token generation throughput on one GPU.

The production Item Q-Former (hidden 1024, 12 layers, 16 heads, K=32 query
tokens, F=14 fields — reference: models/qformer_utils.py:17-28) run in bf16
through ``QFormerInference``'s jitted forward over field embeddings already
on the device, batch 4096 (reference hot loop:
data_processing/generate_all_item_embeddings.py:238-316).  Each timed call
ends in ``block_until_ready``.

Prints ONE JSON line with the median rate over a few repeats and the device
JAX reports.  Exits non-zero where JAX finds no GPU.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def bench_item_token_generation(batch: int = 4096, iters: int = 5,
                                repeats: int = 3) -> dict:
    import jax
    import jax.numpy as jnp

    from unirec.configs import ItemQFormerConfig
    from unirec.inference.qformer_inference import QFormerInference
    from unirec.models.item_qformer import ItemQFormer

    cfg = ItemQFormerConfig()
    key = jax.random.PRNGKey(0)
    params = ItemQFormer(cfg).init(
        key, jnp.zeros((2, cfg.num_fields, cfg.field_embedding_dim)),
        jnp.ones((2, cfg.num_fields)))
    inference = QFormerInference(
        config=cfg, params=params, batch_size=batch,
        field_names=[f"field_{i}" for i in range(cfg.num_fields)])
    fields = jax.random.normal(
        key, (batch, cfg.num_fields, cfg.field_embedding_dim), jnp.float32)
    mask = jnp.ones((batch, cfg.num_fields))

    def call():
        return inference._forward(inference.params, fields, mask)

    t0 = time.perf_counter()
    jax.block_until_ready(call())
    warmup_s = time.perf_counter() - t0
    rates = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            jax.block_until_ready(call())
        rates.append(batch * iters / (time.perf_counter() - t0))
    rates.sort()
    return {"value": rates[len(rates) // 2], "min": rates[0],
            "max": rates[-1], "warmup_s": warmup_s, "repeats": repeats,
            "iters_per_repeat": iters, "batch": batch}


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: needs an NVIDIA GPU; JAX found platform "
                 f"{dev.platform!r}")
    from unirec.runtime import setup_runtime

    setup_runtime()
    r = bench_item_token_generation()
    print(json.dumps({
        "metric": "item_query_tokens_per_sec",
        "unit": "items/s",
        "precision": "bf16",
        **r,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": jax.device_count()},
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
