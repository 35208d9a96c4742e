"""Serve CLI: load checkpoints + catalog, start the HTTP recommender.

    python -m unirec serve \
        --checkpoint joint_ckpt/ --qformer-checkpoint iq_ckpt/ \
        --cache-dir cache/ --item-dict items.json --catalog emb.json \
        --port 8099 [--quantize]

``--checkpoint`` (joint model weights) is optional: without it the server
runs with a freshly initialized joint model around the given Q-Former — the
ranking is then driven by the Q-Former + candidate embeddings only, which is
useful for smoke-testing a deployment before joint training finishes.
"""

from __future__ import annotations

import argparse
import json


def add_recommender_flags(p, batch_size: int = 8):
    """Every flag ``build_recommender`` reads — shared with the offline
    ``users`` sweep CLI so the two surfaces can't drift."""
    p.add_argument("--checkpoint", default=None,
                   help="joint-model checkpoint dir (optional)")
    p.add_argument("--qformer-checkpoint", required=True)
    p.add_argument("--cache-dir", required=True)
    p.add_argument("--item-dict", required=True)
    p.add_argument("--catalog", required=True,
                   help="candidate item-embedding JSON")
    p.add_argument("--hf-path", default=None)
    p.add_argument("--batch-size", type=int, default=batch_size)
    p.add_argument("--max-length", type=int, default=512)
    p.add_argument("--quantize", action="store_true",
                   help="int8-quantize the catalog")
    p.add_argument("--precision", default="bf16", choices=["bf16", "int8"],
                   help="int8: W8A8 Qwen3 projections for user encoding")
    p.add_argument("--merge-lora", action="store_true",
                   help="fold trained LoRA adapters into the base kernels "
                        "(PEFT merge_and_unload; 14 fewer matmuls/layer, "
                        "int8 quantizes the adapted weights)")
    p.add_argument("--prewarm", action="store_true",
                   help="batch-tokenize all prompt fragments at startup")
    p.add_argument("--tiny", action="store_true",
                   help="tiny Qwen3 config (smoke tests / CPU)")
    p.add_argument("--dp", type=int, default=0,
                   help="shard over a dp mesh of this many devices "
                        "(0 = single device); batch-size must divide by it")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_recommender_flags(p, batch_size=8)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8099)
    return p.parse_args(argv)


def build_recommender(args):
    """Load checkpoints + catalog and assemble the Recommender (separated
    from ``main`` so integration tests can drive the pipeline end-to-end
    without the blocking HTTP loop)."""
    import jax

    from unirec.configs import (
        JointModelConfig,
        LoRAConfig,
        Qwen3Config,
    )
    from unirec.data.cache import FieldEmbeddingCache
    from unirec.data.tokenizer import make_tokenizer
    from unirec.inference.qformer_inference import QFormerInference
    from unirec.models.joint import MultiModalQwenEmbedding
    from unirec.serving.recommender import Recommender

    with open(args.item_dict) as f:
        item_dict = json.load(f)
    with open(args.catalog) as f:
        catalog = json.load(f)
    cache = FieldEmbeddingCache.load(args.cache_dir)
    inf = QFormerInference(args.qformer_checkpoint)

    if args.tiny:
        # 2-layer Qwen3; hidden must match the Q-Former checkpoint because
        # query-token injection shares the LLM's embedding space
        # (models/joint.py:81-87)
        from unirec.configs import tiny_qwen3_config

        qwen_cfg = tiny_qwen3_config(
            vocab_size=4096,
            hidden_size=inf.config.hidden_size,
            intermediate_size=1024,
            num_hidden_layers=2,
            num_attention_heads=8,
            num_key_value_heads=4,
            head_dim=128,
            max_position_embeddings=max(128, args.max_length),
        )
    else:
        qwen_cfg = Qwen3Config()
    cat_dim = len(next(iter(catalog.values())))
    if cat_dim != qwen_cfg.hidden_size:
        raise ValueError(
            f"catalog embedding dim {cat_dim} != LLM hidden size "
            f"{qwen_cfg.hidden_size}; regenerate --catalog with the same "
            "base model (for --tiny smoke runs: embed qwen3 "
            f"--embedding-dim {qwen_cfg.hidden_size})"
        )
    jc = JointModelConfig(max_length=args.max_length)
    tokenizer = make_tokenizer(
        args.hf_path, qwen_cfg.vocab_size,
        jc.num_history_items, jc.num_query_tokens_per_item,
    )
    model = MultiModalQwenEmbedding(
        qwen_cfg, inf.config, jc, lora=LoRAConfig()
    )

    import jax.numpy as jnp

    if args.checkpoint:
        from unirec.utils.checkpoint import load_checkpoint

        tree, _ = load_checkpoint(args.checkpoint)
        params = {"params": tree["params"]}
    else:
        f_ = cache.num_fields
        fd = cache.embedding_dim
        params = model.init(
            jax.random.PRNGKey(0),
            jnp.zeros((1, jc.max_length), jnp.int32),
            jnp.ones((1, jc.max_length)),
            jnp.zeros((1, jc.num_history_items, f_, fd)),
            jnp.ones((1, jc.num_history_items, f_)),
        )
        from unirec.utils.params import merge_params

        qf_params = inf.params.get("params", inf.params)
        params["params"] = dict(params["params"])
        params["params"]["qformer"] = merge_params(
            params["params"]["qformer"], qf_params
        )

    mesh = None
    if args.dp:
        from unirec.configs import MeshConfig
        from unirec.parallel.mesh import make_mesh

        mesh = make_mesh(MeshConfig(dp=args.dp, tp=1))
    rec = Recommender(
        model, params, tokenizer, item_dict, cache, catalog,
        batch_size=args.batch_size, quantize_catalog=args.quantize,
        precision=args.precision, mesh=mesh,
        merge_lora=getattr(args, "merge_lora", False),
    )
    if args.prewarm:
        n = rec.prewarm_prompts()
        print(f"prewarmed {n} prompt fragments")
    return rec


def main(argv=None) -> int:
    from unirec.serving.server import serve

    args = parse_args(argv)
    rec = build_recommender(args)
    serve(rec, host=args.host, port=args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
