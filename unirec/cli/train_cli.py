"""Training CLI: one entry point per pipeline stage.

Subcommands mirror the reference training scripts:
  precompute    (training/precompute_full_field_embeddings.py, C9)
  mwne          (models/mwne.py train_improved_encoder, C6)
  item-qformer  (training/item_qformer_training.py, C10)
  user-qformer  (training/user_qformer_training.py, C11)
  joint         (training/train_item_individual_token_joint.py, C12)
  evaluate      (evaluation/evaluate_item_qformer.py, C22)

All hyperparameters default to the reference production configs and are
overridable by flags (the reference hardcodes them, SURVEY.md §5 "Config").
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _joint_cfg_meta(qwen_cfg, qformer_cfg) -> dict:
    """Config dicts recorded in joint checkpoint meta so `export-pretrained`
    can rebuild the exact model shapes without re-specifying them."""
    import dataclasses

    return {
        "qwen_config": dataclasses.asdict(qwen_cfg),
        "qformer_config": dataclasses.asdict(qformer_cfg),
    }


def _cfg_from_meta(meta: dict, key: str, config_cls):
    import dataclasses

    if key not in meta:
        raise SystemExit(
            f"checkpoint meta lacks {key!r} (saved before round 3?); "
            "re-save with `train joint` or pass a full .pth through "
            "export_joint_model instead"
        )
    fields = {f.name for f in dataclasses.fields(config_cls)}
    return config_cls(
        **{k: v for k, v in meta[key].items() if k in fields})


def _metrics_logger(args):
    """JSONL metrics under --checkpoint-dir (+ optional wandb).  Returns
    None when neither destination applies (pure-stdout runs)."""
    wandb = getattr(args, "wandb", False)
    ckpt = getattr(args, "checkpoint_dir", None)
    if not (wandb or ckpt):
        return None
    from unirec.utils.metrics_logger import MetricsLogger

    return MetricsLogger(
        os.path.join(ckpt, "metrics.jsonl") if ckpt else None,
        use_wandb=wandb,
        wandb_config={k: v for k, v in vars(args).items()
                      if isinstance(v, (int, float, str, bool))},
        stdout=False,
    )


def _common_train_flags(sp, batch_size: int, epochs: int, lr: float):
    sp.add_argument("--batch-size", type=int, default=batch_size)
    sp.add_argument("--num-epochs", type=int, default=epochs)
    sp.add_argument("--learning-rate", type=float, default=lr)
    sp.add_argument("--seed", type=int, default=42)
    sp.add_argument("--checkpoint-dir", default=None)
    sp.add_argument("--resume", action="store_true",
                    help="restore params + optimizer state + step from "
                         "--checkpoint-dir before training")
    sp.add_argument("--wandb", action="store_true",
                    help="also stream metrics to wandb (JSONL under "
                         "--checkpoint-dir is always written)")
    sp.add_argument("--dp", type=int, default=-1, help="data-parallel size")
    sp.add_argument("--tp", type=int, default=1, help="tensor-parallel size")
    sp.add_argument("--grad-accum", type=int, default=1,
                    help="apply the optimizer every k micro-batches on the "
                         "averaged gradient (= HF gradient_accumulation_steps)")


def build_parser() -> argparse.ArgumentParser:
    """Every subcommand's flags and their defaults."""
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("precompute")
    sp.add_argument("--data", required=True, help="item (triplet) dict JSON")
    sp.add_argument("--cache-dir", required=True)
    sp.add_argument("--batch-size", type=int, default=8192)
    sp.add_argument("--max-items", type=int, default=None)
    sp.add_argument("--config", default=None, help="field schema YAML")

    sp = sub.add_parser("mwne")
    sp.add_argument("--embedding-dim", type=int, default=1024)
    sp.add_argument("--num-frequencies", type=int, default=20)
    sp.add_argument("--num-steps", type=int, default=1500)
    sp.add_argument("--learning-rate", type=float, default=1e-3)
    sp.add_argument("--checkpoint-dir", default="number_encoders")

    sp = sub.add_parser("item-qformer")
    sp.add_argument("--data", required=True, help="item (triplet) dict JSON")
    sp.add_argument("--sequences", required=True, help="LRanker train JSON")
    sp.add_argument("--cache-dir", required=True)
    sp.add_argument("--num-query-tokens", type=int, default=32)
    sp.add_argument("--hidden-size", type=int, default=1024)
    sp.add_argument("--num-layers", type=int, default=12)
    sp.add_argument("--num-heads", type=int, default=16)
    sp.add_argument("--intermediate-size", type=int, default=4096)
    sp.add_argument("--contrastive-weight", type=float, default=0.25)
    sp.add_argument("--max-samples", type=int, default=None)
    sp.add_argument("--eval-every", type=int, default=50)
    sp.add_argument("--bf16", action="store_true",
                    help="bf16 activations (fp32 params); default fp32 for "
                         "strict reference parity")
    _common_train_flags(sp, 4096, 500, 1e-4)

    sp = sub.add_parser("user-qformer")
    sp.add_argument("--item-qformer-checkpoint", required=True)
    sp.add_argument("--history", required=True, help="LRanker train JSON")
    sp.add_argument("--reviews", required=True, help="review dict JSON")
    sp.add_argument("--cache-dir", required=True)
    sp.add_argument("--max-seq-len", type=int, default=50)
    sp.add_argument("--bf16", action="store_true",
                    help="bf16 activations (fp32 params)")
    sp.add_argument("--remat", action="store_true",
                    help="layer + sequence-assembly remat: saves the "
                    "per-layer attention probs of long histories")
    sp.add_argument("--sp", type=int, default=1,
                    help="sequence parallelism: shard the long-history "
                    "memory axis over N devices (N devices hold Nx the "
                    "history at the same per-device memory; exact LSE "
                    "combine by collectives — ops/sharded_attention.py). "
                    "Requires seq*K divisible by N; incompatible with "
                    "--tp>1. Zeroes attention-PROB dropout.")
    _common_train_flags(sp, 64, 50, 5e-5)

    sp = sub.add_parser("joint")
    sp.add_argument("--train-data", required=True)
    sp.add_argument("--val-data", required=True)
    sp.add_argument("--item-emb", required=True,
                    help="candidate item-embedding JSON")
    sp.add_argument("--item-dict", required=True)
    sp.add_argument("--qformer-checkpoint", required=True)
    sp.add_argument("--cache-dir", required=True)
    sp.add_argument("--hf-path", default=None,
                    help="local HF Qwen3 checkpoint for base weights")
    sp.add_argument("--max-length", type=int, default=512)
    sp.add_argument("--eval-every-steps", type=int, default=20)
    sp.add_argument("--save-strategy", default="both",
                    choices=["best_only", "always", "both"])
    sp.add_argument("--bf16", action="store_true", default=True)
    sp.add_argument("--bf16-base", action="store_true", default=None,
                    help="store the frozen Qwen3 base in bf16 (numerically "
                    "free under --bf16: kernels are cast to bf16 at use); "
                    "halves frozen-param memory. Default: on for "
                    "--no-remat, off with remat")
    sp.add_argument("--no-bf16-base", dest="bf16_base", action="store_false")
    sp.add_argument("--no-remat", dest="remat", action="store_false",
                    default=True,
                    help="disable rematerialization (the default keeps "
                    "GEMM outputs and recomputes the rest)")
    sp.add_argument("--pp", type=int, default=1,
                    help="pipeline-parallel stages (GPipe, "
                         "parallel/pipeline.py) for backbones deeper than "
                         "one device's memory; composes with --dp, refuses "
                         "--tp>1; --resume restores params only")
    sp.add_argument("--pp-microbatches", type=int, default=1,
                    help="microbatches per dp-local batch (shrinks the "
                         "pipeline bubble; batch/(dp*M) must stay integral)")
    sp.add_argument("--int8-base", action="store_true",
                    help="QLoRA-style quantized-base training: the frozen "
                    "Qwen3 projections run W8A8 in the training forward "
                    "(int8 dots) with an STE backward "
                    "(ops/int8_ste.py); LoRA/Q-Former grads stay exact. "
                    "Opt-in: changes training numerics like QLoRA does.")
    sp.add_argument("--lora-grouped", action="store_true",
                    help="grouped LoRA overlay: q/k/v (and gate/up) share "
                    "one dropout draw + one concatenated lora_a matmul "
                    "(LoRAConfig.grouped). Opt-in: dropout masks become "
                    "correlated within a group (structural numerics "
                    "change); param layout/checkpoints unchanged.")
    sp.add_argument("--tiny", action="store_true",
                    help="2-layer Qwen3 (hidden 1024) for smoke tests / CPU")
    _common_train_flags(sp, 16, 500, 1e-4)

    sp = sub.add_parser("evaluate")
    sp.add_argument("--checkpoint", required=True)
    sp.add_argument("--cache-dir", required=True)
    sp.add_argument("--batch-size", type=int, default=256)

    sp = sub.add_parser(
        "export-pth",
        help="export an item Q-Former checkpoint to the reference's "
             "best_qformer_model.pth schema (consumable by the reference's "
             "qformer_inference.py without modification)",
    )
    sp.add_argument("--checkpoint", required=True,
                    help="checkpoint dir (or, for --stage item, an "
                         "existing .pth)")
    sp.add_argument("--output", required=True, help="output .pth path")
    sp.add_argument("--stage", choices=["item", "user", "mwne"],
                    default="item")

    sp = sub.add_parser(
        "export-pretrained",
        help="export a joint-stage checkpoint as the reference's "
             "save_pretrained directory (PEFT adapter + qformer_model.bin "
             "+ model_config.json + tokenizer files, "
             "train_item_individual_token_joint.py:183-200)",
    )
    sp.add_argument("--checkpoint", required=True,
                    help="orbax joint checkpoint dir (from `train joint "
                         "--checkpoint-dir`)")
    sp.add_argument("--output", required=True, help="output directory")
    sp.add_argument("--tokenizer", default=None,
                    help="HF tokenizer path to copy into the directory "
                         "(optional; zero-egress hosts may not have one)")

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return _dispatch(args)


def _dispatch(args) -> int:
    from unirec.configs import (
        FieldSchema,
        ItemQFormerConfig,
        MeshConfig,
        MWNEConfig,
        OptimizerConfig,
        TrainConfig,
    )

    if args.cmd == "precompute":
        from unirec.data.cache import build_cache
        from unirec.encoders.item_encoder import ItemEncoder

        with open(args.data) as f:
            data = json.load(f)
        items = []
        for iid, item in data.items():
            item = dict(item)
            item["item_id"] = iid
            items.append(item)
        if args.max_items:
            items = items[: args.max_items]
        encoder = ItemEncoder(config_path=args.config)
        cache = build_cache(
            items, encoder, cache_dir=args.cache_dir,
            batch_size=args.batch_size,
        )
        print(f"cached {len(cache)} items x {cache.num_fields} fields "
              f"-> {args.cache_dir}")
        return 0

    if args.cmd == "mwne":
        from unirec.train.mwne import MWNETrainer
        import numpy as np

        cfg = MWNEConfig(
            embedding_dim=args.embedding_dim,
            num_frequencies=args.num_frequencies,
        )
        trainer = MWNETrainer(cfg, lr=args.learning_rate)
        metrics = trainer.train(num_steps=args.num_steps)
        test = np.array([0.5, 1.0, 2.0, 5.0, 10.0, -3.0, 42.0, 100.0],
                        np.float32)
        results = trainer.evaluate(test)
        print(json.dumps({"train": metrics, "eval": results}, indent=2))
        if args.checkpoint_dir:
            from unirec.utils.checkpoint import save_checkpoint

            class _S:  # minimal state for save_checkpoint
                params = trainer.params
                opt_state = trainer.opt_state
                step = args.num_steps

            save_checkpoint(args.checkpoint_dir, _S, config=cfg,
                            extra={"final_metrics": results})
        return 0

    if args.cmd == "item-qformer":
        import numpy as np

        from unirec.data.cache import build_cache
        from unirec.encoders.item_encoder import ItemEncoder
        from unirec.train.item_qformer import train_item_qformer

        with open(args.data) as f:
            data = json.load(f)
        items = []
        for iid, item in data.items():
            item = dict(item)
            item["item_id"] = iid
            items.append(item)
        if args.max_samples:
            items = items[: args.max_samples]
        with open(args.sequences) as f:
            seq_data = json.load(f)
        sequences = [
            s["history"] for s in seq_data
            if "history" in s and len(s["history"]) > 1
        ]
        cache = build_cache(
            items, ItemEncoder(), cache_dir=args.cache_dir
        )
        # 90/10 split, seed 42 (reference: item_qformer_training.py:64-68)
        rng = np.random.default_rng(args.seed)
        perm = rng.permutation(len(cache))
        split = int(0.9 * len(cache))
        val_rows = perm[split:]

        mc = ItemQFormerConfig(
            num_fields=cache.num_fields,
            field_embedding_dim=cache.embedding_dim,
            num_query_tokens=args.num_query_tokens,
            hidden_size=args.hidden_size,
            num_hidden_layers=args.num_layers,
            num_attention_heads=args.num_heads,
            intermediate_size=args.intermediate_size,
        )
        tc = TrainConfig(
            batch_size=args.batch_size,
            num_epochs=args.num_epochs,
            seed=args.seed,
            eval_every_epochs=args.eval_every,
            optimizer=OptimizerConfig(
                learning_rate=args.learning_rate,
                gradient_accumulation_steps=args.grad_accum,
            ),
            mesh=MeshConfig(dp=args.dp, tp=args.tp),
        )
        _, metrics = train_item_qformer(
            cache, sequences, mc, tc, val_rows=val_rows,
            checkpoint_dir=args.checkpoint_dir,
            contrastive_weight=args.contrastive_weight,
            dtype="bfloat16" if getattr(args, "bf16", False) else "float32",
            resume=getattr(args, "resume", False),
            metrics_logger=_metrics_logger(args),
        )
        print(json.dumps(metrics, indent=2))
        return 0

    if args.cmd == "user-qformer":
        from unirec.data.cache import FieldEmbeddingCache
        from unirec.inference.qformer_inference import QFormerInference
        from unirec.models.item_qformer import ItemQFormer
        from unirec.train.user_qformer import train_user_qformer

        inf = QFormerInference(args.item_qformer_checkpoint)
        cache = FieldEmbeddingCache.load(args.cache_dir)
        with open(args.history) as f:
            histories = json.load(f)
        with open(args.reviews) as f:
            reviews_raw = json.load(f)
        # review dict is keyed "user|asin" -> regroup per item
        reviews: dict = {}
        for key, review in reviews_raw.items():
            item_id = key.split("|", 1)[-1]
            reviews.setdefault(item_id, []).append(review)
        tc = TrainConfig(
            batch_size=args.batch_size, num_epochs=args.num_epochs,
            seed=args.seed,
            optimizer=OptimizerConfig(
                learning_rate=args.learning_rate,
                gradient_accumulation_steps=args.grad_accum,
            ),
            mesh=MeshConfig(dp=args.dp, tp=args.tp,
                            sp=getattr(args, "sp", 1)),
        )
        model = ItemQFormer(inf.config)
        from unirec.configs import UserQFormerConfig

        uc = UserQFormerConfig(
            num_item_tokens_to_predict=inf.config.num_query_tokens,
            input_embedding_dim=inf.config.hidden_size,
            gradient_checkpointing=getattr(args, "remat", False),
            sequence_parallel=getattr(args, "sp", 1) > 1,
        )
        _, metrics = train_user_qformer(
            cache, histories, reviews, model, inf.params,
            user_config=uc,
            train_config=tc, max_seq_len=args.max_seq_len,
            checkpoint_dir=args.checkpoint_dir,
            dtype="bfloat16" if getattr(args, "bf16", False) else "float32",
            resume=getattr(args, "resume", False),
            metrics_logger=_metrics_logger(args),
        )
        print(json.dumps(metrics, indent=2))
        return 0

    if args.cmd == "joint":
        return _run_joint(args)

    if args.cmd == "evaluate":
        from unirec.data.cache import FieldEmbeddingCache
        from unirec.eval.reconstruction import (
            evaluate_reconstruction_quality,
        )
        from unirec.inference.qformer_inference import QFormerInference
        from unirec.models.item_qformer import ItemQFormer

        inf = QFormerInference(args.checkpoint)
        cache = FieldEmbeddingCache.load(args.cache_dir)
        model = ItemQFormer(inf.config)
        res = evaluate_reconstruction_quality(
            model, inf.params, cache, batch_size=args.batch_size
        )
        print(json.dumps(res, indent=2))
        return 0

    if args.cmd == "export-pretrained":
        from unirec.configs import Qwen3Config
        from unirec.utils.checkpoint import load_checkpoint, read_meta
        from unirec.utils.torch_convert import save_pretrained_directory

        candidates = [
            os.path.join(args.checkpoint, "latest_model"),
            os.path.join(args.checkpoint, "best_model"),
            args.checkpoint,
        ]
        cand = next(
            (c for c in candidates
             if os.path.exists(os.path.join(c, "state"))), None)
        if cand is None:
            print(f"error: no checkpoint under {args.checkpoint}",
                  file=sys.stderr)
            return 2
        meta = read_meta(cand)
        qwen_cfg = _cfg_from_meta(meta, "qwen_config", Qwen3Config)
        qf_cfg = _cfg_from_meta(meta, "qformer_config", ItemQFormerConfig)
        tree, _ = load_checkpoint(cand)
        tokenizer = None
        if args.tokenizer:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
        save_pretrained_directory(
            args.output, tree["params"], qwen_cfg, qf_cfg,
            tokenizer=tokenizer,
        )
        print(f"wrote reference save_pretrained layout -> {args.output}")
        return 0

    if args.cmd == "export-pth":
        if args.stage == "mwne":
            from unirec.utils.checkpoint import (
                load_checkpoint,
                restore_config,
            )
            from unirec.utils.torch_convert import (
                save_reference_mwne_checkpoint,
            )

            tree, meta = load_checkpoint(args.checkpoint)
            mcfg = restore_config(meta, MWNEConfig)
            save_reference_mwne_checkpoint(
                args.output, mcfg, {"base": tree["params"]["encoder"]},
                final_metrics=meta.get("final_metrics"),
            )
            print(f"wrote reference-schema MWNE checkpoint -> {args.output}")
            return 0
        if args.stage == "user":
            from unirec.configs import UserQFormerConfig
            from unirec.utils.checkpoint import (
                load_checkpoint,
                restore_config,
            )
            from unirec.utils.torch_convert import (
                save_reference_user_qformer_checkpoint,
            )

            tree, meta = load_checkpoint(args.checkpoint)
            ucfg = restore_config(meta, UserQFormerConfig)
            save_reference_user_qformer_checkpoint(
                args.output, tree["params"]["user"], ucfg,
                epoch=int(meta.get("epoch", 0)),
                loss=float(meta.get("loss", 0.0)),
            )
            print(f"wrote reference-schema user checkpoint -> {args.output}")
            return 0

        from unirec.inference.qformer_inference import QFormerInference
        from unirec.utils.torch_convert import (
            save_reference_item_qformer_checkpoint,
        )

        inf = QFormerInference(args.checkpoint)
        save_reference_item_qformer_checkpoint(
            args.output, inf.params["params"], inf.config, inf.field_names
        )
        print(f"wrote reference-schema checkpoint -> {args.output} "
              f"({len(inf.field_names)} fields)")
        return 0

    raise SystemExit(f"unknown command {args.cmd}")


def joint_trainer_from_args(args, qwen_cfg, qformer_cfg, jc):
    """The ``JointTrainer`` that ``train joint`` builds from its flags:
    warmup 20, clip 1.0, remat keeping GEMM outputs unless --no-remat."""
    from unirec.configs import (
        LoRAConfig,
        MeshConfig,
        OptimizerConfig,
        TrainConfig,
    )
    from unirec.train.joint import JointTrainer

    tc = TrainConfig(
        batch_size=args.batch_size, num_epochs=args.num_epochs,
        seed=args.seed,
        optimizer=OptimizerConfig(
            learning_rate=args.learning_rate, warmup_steps=20,
            max_grad_norm=1.0,
            gradient_accumulation_steps=args.grad_accum,
        ),
        mesh=MeshConfig(dp=args.dp, tp=args.tp),
    )
    remat = getattr(args, "remat", True)
    bf16_base = getattr(args, "bf16_base", None)
    if bf16_base is None:
        # auto: the bf16 base frees frozen-param memory under no-remat
        bf16_base = not remat
    return JointTrainer(
        qwen_cfg, qformer_cfg, jc,
        lora=LoRAConfig(grouped=getattr(args, "lora_grouped", False)),
        train_config=tc,
        dtype="bfloat16" if args.bf16 else "float32",
        remat=remat,
        remat_policy="dots",  # keep GEMM outputs, recompute the rest
        bf16_base=bf16_base and args.bf16,
        int8_base=getattr(args, "int8_base", False),
    )


def _run_joint(args) -> int:
    import numpy as np

    from unirec.configs import JointModelConfig, Qwen3Config
    from unirec.data.cache import FieldEmbeddingCache
    from unirec.data.tokenizer import make_tokenizer
    from unirec.inference.qformer_inference import QFormerInference
    from unirec.train.joint import JointDataset

    with open(args.train_data) as f:
        train_data = json.load(f)
    with open(args.val_data) as f:
        val_data = json.load(f)
    with open(args.item_emb) as f:
        item_emb_dict = json.load(f)
    with open(args.item_dict) as f:
        item_dict = json.load(f)

    inf = QFormerInference(args.qformer_checkpoint)
    cache = FieldEmbeddingCache.load(args.cache_dir)
    if getattr(args, "tiny", False):
        from unirec.configs import tiny_qwen3_config

        qwen_cfg = tiny_qwen3_config(
            vocab_size=4096, hidden_size=inf.config.hidden_size,
            intermediate_size=1024, num_hidden_layers=2,
            num_attention_heads=8, num_key_value_heads=4, head_dim=128,
            max_position_embeddings=max(128, args.max_length),
        )
    else:
        qwen_cfg = Qwen3Config()
    jc = JointModelConfig(max_length=args.max_length)
    tokenizer = make_tokenizer(
        args.hf_path, qwen_cfg.vocab_size,
        jc.num_history_items, jc.num_query_tokens_per_item,
    )
    emb_dim = len(next(iter(item_emb_dict.values())))
    if emb_dim != qwen_cfg.hidden_size:
        # InfoNCE compares the pooled LLM user embedding against the frozen
        # candidate embeddings — they must share the LLM's hidden space
        # (reference: train_item_individual_token_joint.py:173-182).
        print(
            f"error: candidate embedding dim {emb_dim} != LLM hidden size "
            f"{qwen_cfg.hidden_size}; regenerate --item-emb with the same "
            "base model (for --tiny smoke runs: "
            f"embed qwen3 --embedding-dim {qwen_cfg.hidden_size})",
            file=sys.stderr,
        )
        return 2
    train_ds = JointDataset(train_data, item_emb_dict, tokenizer, item_dict,
                            cache, jc, item_emb_dim=emb_dim)
    val_ds = JointDataset(val_data, item_emb_dict, tokenizer, item_dict,
                          cache, jc, item_emb_dim=emb_dim)

    trainer = joint_trainer_from_args(args, qwen_cfg, inf.config, jc)

    qwen_params = None
    if args.hf_path:
        from unirec.utils.torch_convert import convert_qwen3
        import torch
        from transformers import AutoModel

        hf = AutoModel.from_pretrained(args.hf_path, torch_dtype=torch.float32)
        qwen_params = convert_qwen3(hf.state_dict(), qwen_cfg.num_hidden_layers)

    qf_params = inf.params.get("params", inf.params)
    state = trainer.init_state(qformer_params=qf_params, qwen_params=qwen_params)

    best_mrr = float("-inf")
    if getattr(args, "resume", False) and args.checkpoint_dir:
        from unirec.utils.checkpoint import restore_train_state

        # strategy "both" nests latest_model/best_model under the dir;
        # prefer latest (true continuation), then best, then the flat layout
        candidates = [
            os.path.join(args.checkpoint_dir, "latest_model"),
            os.path.join(args.checkpoint_dir, "best_model"),
            args.checkpoint_dir,
        ]
        for cand in candidates:
            if os.path.exists(os.path.join(cand, "state")):
                from unirec.utils.checkpoint import (
                    check_grad_accum,
                    read_meta,
                )

                check_grad_accum(read_meta(cand), args.grad_accum)
                try:
                    state, meta = restore_train_state(cand, state)
                except Exception:
                    # pp-saved checkpoints carry a sentinel opt_state
                    # ({"pp_layout": True}) that cannot fill the dp
                    # TrainState's optax template — restore params + step
                    # only (the optimizer restarts)
                    from unirec.utils.checkpoint import load_checkpoint

                    tree, meta = load_checkpoint(cand)
                    state = state.replace(
                        params=tree["params"], step=int(tree["step"])
                    )
                    print("restored params + step only (optimizer state "
                          "layout mismatch — it restarts)")
                best_mrr = float(meta.get("mrr", float("-inf")))
                print(f"resumed from {cand} at step {int(state.step)} "
                      f"(best MRR {best_mrr:.4f})")
                break
        else:
            print(f"error: --resume but no checkpoint under "
                  f"{args.checkpoint_dir}", file=sys.stderr)
            return 2

    if getattr(args, "pp", 1) > 1:
        if getattr(args, "int8_base", False):
            print("error: --pp is incompatible with --int8-base (the pp "
                  "layout stacks layer params; the qweights tree is not "
                  "stacked)", file=sys.stderr)
            return 2
        return _run_joint_pp(args, trainer, state, train_ds, val_ds, jc,
                             best_mrr)

    # initial + per-N-steps MRR eval with save strategies, mirroring the
    # reference's BestMRRCallback (train_item_individual_token_joint.py:788).
    from unirec.train.callbacks import BestMetricTracker
    from unirec.utils.checkpoint import save_checkpoint

    tracker = BestMetricTracker(
        args.checkpoint_dir,
        metric="mrr",
        strategy=args.save_strategy,
        eval_steps=args.eval_every_steps,
        save_fn=lambda path, st: save_checkpoint(
            path, st, config=jc,
            extra={"mrr": tracker.best, "grad_accum": args.grad_accum,
                   **_joint_cfg_meta(qwen_cfg, inf.config)},
        ),
    )
    if best_mrr > tracker.best:
        tracker.best = best_mrr  # resumed watermark: don't demote "best"
    ml = _metrics_logger(args)
    print("initial eval:", json.dumps(trainer.evaluate(state, val_ds)))

    def hook(step, st, metrics):
        if tracker.should_eval(step):
            ev = trainer.evaluate(st, val_ds)
            status = tracker.update(step, ev["mrr"], st)
            print(f"step {step}: loss={metrics['loss']:.4f} "
                  f"eval={json.dumps(ev)} {status}")
            if ml:
                ml.log({"loss": metrics["loss"], **ev}, step=step)
        return st

    rng = np.random.default_rng(args.seed)
    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    state, _ = trainer.train_steps(
        state, train_ds, rng, num_steps=args.num_epochs * steps_per_epoch,
        step_hook=hook,
    )
    # End-of-training: apply any pending micro-grad accumulation (HF Trainer
    # parity — it never drops the tail of the last accumulation window).
    from unirec.train.common import flush_grad_accum

    state = flush_grad_accum(state, trainer.train_config.optimizer)
    final = trainer.evaluate(state, val_ds)
    print(f"final eval: {json.dumps(final)}; best MRR: {tracker.best:.4f}")
    if ml:
        ml.log(final, step=int(state.step))
        ml.close()
    return 0


def _run_joint_pp(args, trainer, state, train_ds, val_ds, jc, best_mrr) -> int:
    """GPipe-staged joint training (`train joint --pp N`): same datasets,
    tracker semantics, and checkpoint schema as the dp path; the backbone
    streams through pp stages (train/joint.PipelinedJointTrainer).  A
    --resume restore carries params + step into the pp layout (the dp
    optimizer state is layout-incompatible and restarts)."""
    import types

    import numpy as np

    from unirec.train.callbacks import BestMetricTracker
    from unirec.train.joint import PipelinedJointTrainer
    from unirec.utils.checkpoint import save_checkpoint

    ptrainer = PipelinedJointTrainer(
        trainer, pp=args.pp, num_microbatches=args.pp_microbatches
    )
    if int(state.step) > 0:
        print("note: --resume under --pp restores params and the step "
              "counter; the optimizer state restarts (layout change)")
    trainable, opt_state, tx = ptrainer.init_trainable(state)
    start_step = int(state.step)
    del state

    def save_fn(path, tr):
        shim = types.SimpleNamespace(
            params=ptrainer.merged_params(tr, to_host=True),
            opt_state={"pp_layout": True},
            # the hook already passes GLOBAL steps to tracker.update
            step=tracker.last_eval_step,
        )
        save_checkpoint(path, shim, config=jc,
                        extra={"mrr": tracker.best,
                               "grad_accum": args.grad_accum,
                               **_joint_cfg_meta(
                                   ptrainer.trainer.qwen_config,
                                   ptrainer.trainer.qformer_config)})

    tracker = BestMetricTracker(
        args.checkpoint_dir, metric="mrr", strategy=args.save_strategy,
        eval_steps=args.eval_every_steps, save_fn=save_fn,
    )
    if best_mrr > tracker.best:
        tracker.best = best_mrr

    ml = _metrics_logger(args)
    print("initial eval:", json.dumps(ptrainer.evaluate(trainable, val_ds)))

    def hook(step, tr, metrics):
        if tracker.should_eval(step):
            ev = ptrainer.evaluate(tr, val_ds)
            status = tracker.update(step, ev["mrr"], tr)
            print(f"step {step}: loss={metrics['loss']:.4f} "
                  f"eval={json.dumps(ev)} {status}")
            if ml:
                ml.log({"loss": metrics["loss"], **ev}, step=step)

    rng = np.random.default_rng(args.seed)
    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    trainable, opt_state, _ = ptrainer.train_steps(
        trainable, opt_state, tx, train_ds, rng,
        num_steps=args.num_epochs * steps_per_epoch,
        start_step=start_step, step_hook=hook,
    )
    final = ptrainer.evaluate(trainable, val_ds)
    print(f"final eval: {json.dumps(final)}; best MRR: {tracker.best:.4f}")
    if ml:
        ml.log(final)
        ml.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
