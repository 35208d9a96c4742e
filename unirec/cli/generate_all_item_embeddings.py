"""Batch item-query-token generation CLI (the repo's flagship data tool).

JAX rebuild of data_processing/generate_all_item_embeddings.py (C21),
with the ``QFormerInference`` dependency actually provided
(the reference imports it from a module where it doesn't exist — broken as
shipped, SURVEY.md §7.1.1).

Flags mirror the reference CLI (:574-630): --data --checkpoint --output
--batch-size --max-items --profile --compare --check-devices, plus
--cache-dir to run from a precomputed field-embedding cache (the fast path)
and --progress-file for resumable progress JSON (:311-316).

Per-batch failures fall back to per-item processing (:295-309); per-item
failures degrade to zero tokens rather than aborting the sweep.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time
from typing import Dict, List, Optional

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", help="item dict JSON (id -> fields)")
    p.add_argument("--checkpoint", required=False,
                   help="Item Q-Former checkpoint (checkpoint dir or "
                        "reference .pth)")
    p.add_argument("--cache-dir",
                   help="precomputed field-embedding cache directory")
    p.add_argument("--output", default="item_query_tokens.pkl",
                   help=".pkl or .json output path")
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--min-batch-size", type=int, default=16,
                   help="floor for the out-of-memory batch downshift")
    p.add_argument("--dp", type=int, default=-1,
                   help="data-parallel devices for the sweep: -1 = all "
                        "visible devices, 1 = single device")
    p.add_argument("--max-items", type=int, default=None)
    p.add_argument("--profile", action="store_true",
                   help="print per-batch timing stats")
    p.add_argument("--trace-dir", default=None,
                   help="write a jax.profiler trace here")
    p.add_argument("--compare", action="store_true",
                   help="benchmark batch vs per-item processing on a sample")
    p.add_argument("--check-devices", action="store_true")
    p.add_argument("--progress-file", default=None)
    return p.parse_args(argv)


def _load_items(data_path: str, max_items: Optional[int]) -> List[Dict]:
    with open(data_path) as f:
        data = json.load(f)
    items = []
    for item_id, item in data.items():
        if isinstance(item, dict):
            item = dict(item)
            item["item_id"] = item_id
            items.append(item)
    if max_items:
        items = items[:max_items]
    return items


def _save(tokens: Dict[str, np.ndarray], output: str) -> None:
    os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
    if output.endswith(".json"):
        with open(output, "w") as f:
            json.dump({k: v.tolist() for k, v in tokens.items()}, f)
    else:
        with open(output, "wb") as f:
            pickle.dump(tokens, f)


def is_oom_error(e: BaseException) -> bool:
    """OOM-shaped failure from the runtime/compiler (RESOURCE_EXHAUSTED,
    device allocation) — the signal for the batch downshift, mirroring the
    reference's GPU memory probe + halving
    (reference: generate_all_item_embeddings.py:191-211)."""
    s = str(e).lower()
    return any(
        key in s
        for key in (
            "resource_exhausted",
            "resource exhausted",
            "out of memory",
            "ran out of memory",
        )
    )


def compare_processing_methods(inference, cache, sample_size: int = 50) -> Dict:
    """Batch-vs-per-item benchmark
    (reference: generate_all_item_embeddings.py:465-572)."""
    ids = cache.item_ids[:sample_size]
    t0 = time.time()
    batch_tokens = inference.query_tokens_from_cache(cache, ids)
    t_batch = time.time() - t0

    t0 = time.time()
    single = {}
    for iid in ids:
        emb, mask = cache.gather([iid])
        single[iid] = inference.query_tokens_from_embeddings(emb, mask)[0]
    t_single = time.time() - t0

    ok = all(
        np.allclose(batch_tokens[i], single[i], atol=1e-2) for i in ids
    )
    result = {
        "sample_size": len(ids),
        "batch_time_s": round(t_batch, 3),
        "per_item_time_s": round(t_single, 3),
        "speedup": round(t_single / max(t_batch, 1e-9), 2),
        "outputs_match": bool(ok),
    }
    print(json.dumps(result, indent=2))
    return result


def build_inference(batch_size: int, dp: int = -1, checkpoint=None,
                    **model):
    """``QFormerInference`` as the sweep runs it: from ``checkpoint`` (or
    ``config``/``params``/``field_names`` in ``model``), sharded over ``dp``
    devices (-1 = all visible) with params replicated and batches split.
    ``batch_size`` is rounded up to a multiple of the device count."""
    import jax
    import numpy as _np
    from jax.sharding import Mesh

    from unirec.inference.qformer_inference import QFormerInference

    mesh = None
    dp = dp if dp > 0 else jax.device_count()
    if dp > 1:
        devices = jax.devices()[:dp]
        mesh = Mesh(_np.asarray(devices).reshape(len(devices), 1),
                    ("dp", "tp"))
        batch_size += -batch_size % len(devices)
        print(f"sweep sharded over {len(devices)} devices "
              f"(batch {batch_size})")
    return QFormerInference(checkpoint, batch_size=batch_size, mesh=mesh,
                            **model)


def main(argv=None) -> int:
    args = parse_args(argv)

    from unirec.utils.profiling import (
        ProgressWriter,
        ThroughputMeter,
        check_devices,
        profiler_trace,
    )

    if args.check_devices:
        info = check_devices()
        if not (args.data or args.cache_dir):
            return 0 if info["ok"] else 1

    from unirec.data.cache import FieldEmbeddingCache, build_cache

    if not args.checkpoint:
        print("error: --checkpoint required", file=sys.stderr)
        return 2

    inference = build_inference(args.batch_size, args.dp, args.checkpoint)
    args.batch_size = inference.batch_size

    # field embeddings: from cache (fast path) or encoded from raw items
    if args.cache_dir and FieldEmbeddingCache.exists(args.cache_dir):
        cache = FieldEmbeddingCache.load(args.cache_dir)
    elif args.data:
        from unirec.encoders.item_encoder import ItemEncoder

        items = _load_items(args.data, args.max_items)
        encoder = ItemEncoder()
        cache = build_cache(
            items, encoder, fields=inference.field_names,
            cache_dir=args.cache_dir,
        )
    else:
        print("error: need --cache-dir or --data", file=sys.stderr)
        return 2

    ids = cache.item_ids
    if args.max_items:
        ids = ids[: args.max_items]

    if args.compare:
        compare_processing_methods(inference, cache)
        return 0

    meter = ThroughputMeter(total_items=len(ids))
    progress = ProgressWriter(args.progress_file)
    tokens: Dict[str, np.ndarray] = {}

    current_bs = args.batch_size
    with profiler_trace(args.trace_dir):
        i = 0
        while i < len(ids):
            batch_ids = ids[i : i + current_bs]
            meter.start_batch()
            try:
                emb, mask = cache.gather(batch_ids)
                out = inference.query_tokens_from_embeddings(emb, mask)
                for j, iid in enumerate(batch_ids):
                    tokens[iid] = out[j]
            except Exception as e:
                # out-of-memory downshift: an OOM-shaped failure halves the
                # batch (sticky) and retries the same items — the analog of
                # the reference's memory probe + halving
                # (reference: generate_all_item_embeddings.py:191-211).
                if is_oom_error(e) and current_bs > max(args.min_batch_size, 1):
                    current_bs = max(current_bs // 2, args.min_batch_size, 1)
                    inference.batch_size = current_bs
                    print(
                        f"OOM at batch starting {i}; downshifting batch size "
                        f"to {current_bs} and retrying", file=sys.stderr,
                    )
                    continue
                # per-batch fallback (reference :295-309)
                print(f"batch starting {i} failed ({e}); "
                      "falling back to per-item", file=sys.stderr)
                for iid in batch_ids:
                    try:
                        e1, m1 = cache.gather([iid])
                        tokens[iid] = inference.query_tokens_from_embeddings(
                            e1, m1
                        )[0]
                    except Exception:
                        k = inference.config.num_query_tokens
                        h = inference.config.hidden_size
                        tokens[iid] = np.zeros((k, h), np.float32)
            i += len(batch_ids)
            dt = meter.end_batch(len(batch_ids))
            if args.profile:
                print(
                    f"batch {i // args.batch_size}: {dt * 1e3:.1f} ms, "
                    f"{json.dumps(meter.stats())}"
                )
            progress.update(
                {"done": meter.items_done, "total": len(ids), **meter.stats()}
            )

    _save(tokens, args.output)
    progress.finish({"done": meter.items_done, "total": len(ids),
                     **meter.stats()})
    print(
        f"generated query tokens for {len(tokens)} items "
        f"({meter.items_per_sec:.0f} items/s) -> {args.output}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
