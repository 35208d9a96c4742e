"""Candidate-pool item-embedding stages.

Two subcommands:

* ``clip`` — CLIP text+image mean embedding per item
  (reference: data_processing/item_embedding_clip.py: text = title + features
  + description + details; first large image; mean(text_embed, image_embed)
  -> ``*_item_embedding_clip.json``).
* ``qwen3`` — the *missing* reference stage (SURVEY.md §7.1.8): the joint
  trainer consumes ``all_beauty_item_embedding_qwen3_0.6B.json`` but no
  reference script generates it.  Here: the same assembled item text through
  the Qwen3-Embedding text backend -> JSON.

Both restrict to items appearing in the train/test samples' histories +
candidate pools (reference :64-78) when sample files are given.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Set

import numpy as np


def extract_text(item: Dict) -> str:
    """reference: data_processing/item_embedding_clip.py:17-26."""
    parts = [item.get("title", "")]
    if item.get("features"):
        f = item["features"]
        parts.append(" ".join(f) if isinstance(f, list) else str(f))
    if item.get("description"):
        d = item["description"]
        parts.append(" ".join(d) if isinstance(d, list) else str(d))
    if item.get("details"):
        parts.append(", ".join(f"{k}: {v}" for k, v in item["details"].items()))
    return " ".join(parts)


def get_main_images(item: Dict) -> List[str]:
    """reference: data_processing/item_embedding_clip.py:28-29."""
    return [img["large"] for img in item.get("images", []) if "large" in img]


def collect_sample_item_ids(sample_paths: List[str]) -> Set[str]:
    """Union of history + candidates + ground truth (reference :68-76)."""
    ids: Set[str] = set()
    for path in sample_paths:
        with open(path) as f:
            data = json.load(f)
        for sample in data:
            ids.update(sample.get("history", []))
            ids.update(sample.get("candidate", []))
            if "ground_truth" in sample:
                ids.add(sample["ground_truth"])
    return ids


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("mode", choices=["clip", "qwen3"])
    p.add_argument("--item-dict", required=True)
    p.add_argument("--samples", nargs="*", default=[],
                   help="train/test sample JSONs to restrict the item set")
    p.add_argument("--output", required=True)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--hf-path", default=None,
                   help="local HF checkpoint (CLIP or Qwen3) for real weights")
    p.add_argument("--max-items", type=int, default=None)
    p.add_argument("--embedding-dim", type=int, default=1024,
                   help="output dim for the weightless hash backend "
                        "(must match the joint model's hidden size)")
    args = p.parse_args(argv)

    with open(args.item_dict) as f:
        item_dict = json.load(f)

    if args.samples:
        keep = collect_sample_item_ids(args.samples)
        item_ids = [i for i in item_dict if i in keep]
    else:
        item_ids = list(item_dict)
    if args.max_items:
        item_ids = item_ids[: args.max_items]

    embeddings: Dict[str, list] = {}

    if args.mode == "qwen3":
        from unirec.encoders.backends import HashTextBackend, Qwen3TextBackend

        if args.hf_path:
            backend = Qwen3TextBackend.from_local_hf(args.hf_path)
        else:
            backend = HashTextBackend(args.embedding_dim)
        texts = [extract_text(item_dict[i]) for i in item_ids]
        embs = backend.encode(texts)
        for i, iid in enumerate(item_ids):
            embeddings[iid] = np.asarray(embs[i], np.float32).tolist()
    else:  # clip: mean(text_embed, image_embed); items w/o image skipped
        from unirec.encoders.backends import (
            CLIPImageBackend,
            HashImageBackend,
            HashTextBackend,
        )

        if args.hf_path:
            image_backend = CLIPImageBackend.from_local_hf(args.hf_path)
            from unirec.encoders.backends import TextBackend

            # CLIP text tower with its own tokenizer
            import jax

            from transformers import CLIPModel, CLIPTokenizerFast

            from unirec.models.clip import (
                CLIPTextConfig,
                CLIPTextTower,
                convert_clip_text,
            )

            hf = CLIPModel.from_pretrained(args.hf_path)
            tc = hf.config.text_config
            cfg = CLIPTextConfig(
                vocab_size=tc.vocab_size, hidden_size=tc.hidden_size,
                intermediate_size=tc.intermediate_size,
                num_hidden_layers=tc.num_hidden_layers,
                num_attention_heads=tc.num_attention_heads,
                max_position_embeddings=tc.max_position_embeddings,
                projection_dim=hf.config.projection_dim,
                eos_token_id=tc.eos_token_id,
            )
            tower = CLIPTextTower(cfg)
            tparams = {"params": convert_clip_text(hf.state_dict(), cfg)}
            tokenizer = CLIPTokenizerFast.from_pretrained(args.hf_path)
            fwd = jax.jit(lambda pr, ids, m: tower.apply(pr, ids, m))

            class _CLIPText(TextBackend):
                dim = cfg.projection_dim

                def encode(self, texts):
                    import jax.numpy as jnp

                    enc = tokenizer(
                        list(texts), padding="max_length", truncation=True,
                        max_length=77, return_tensors="np",
                    )
                    out = fwd(
                        tparams,
                        jnp.asarray(enc["input_ids"].astype(np.int32)),
                        jnp.asarray(enc["attention_mask"].astype(np.float32)),
                    )
                    return np.asarray(out, np.float32)

            text_backend = _CLIPText()
        else:
            dim = 512
            text_backend = HashTextBackend(dim)
            image_backend = HashImageBackend(dim)

        texts, urls, kept = [], [], []
        for iid in item_ids:
            item = item_dict[iid]
            images = get_main_images(item)
            if not images:
                continue  # reference skips items without images (:101-102)
            texts.append(extract_text(item))
            urls.append(images[0])
            kept.append(iid)
        for i in range(0, len(kept), args.batch_size):
            bt = texts[i : i + args.batch_size]
            bu = urls[i : i + args.batch_size]
            bi = kept[i : i + args.batch_size]
            t_emb = text_backend.encode(bt)
            i_emb = image_backend.encode(bu)
            for j, iid in enumerate(bi):
                if np.abs(i_emb[j]).sum() == 0:
                    continue  # image failed to load -> skip item
                combined = (t_emb[j] + i_emb[j]) / 2.0
                embeddings[iid] = combined.astype(np.float32).tolist()

    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(embeddings, f)
    print(f"{len(embeddings)} item embeddings -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
