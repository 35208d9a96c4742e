#!/usr/bin/env python
"""Smoke run of the main path on one NVIDIA GPU, at full model width.

    python chip_smoke.py                 # every phase on one GPU
    python chip_smoke.py --phase joint   # one phase
    python chip_smoke.py --four          # joint step on dp=4 and dp=2 x tp=2
                                         # against one GPU (needs four GPUs;
                                         # full widths, 2 layers each stack)

Phases (weights and data are random, made from ``--seed``; nothing is read):

  tokens  ``QFormerInference`` as the ``tokens`` CLI builds it, production
          Item Q-Former (hidden 1024, 12 layers, 16 heads, K=32, F=14), a
          few batches of 4096 items in bf16.  Per-token cosine >= 0.999
          against the float32 model at precision "highest" on >= 256 items;
          masked fields must not change the tokens.
  joint   ``JointTrainer`` as ``train joint`` builds it (Qwen3-0.6B widths,
          28 layers, LoRA r=16 on the seven projections, the K=2 Item
          Q-Former, batch 16, seq 512, 10 history items, HashTokenizer,
          remat keeping GEMM outputs), 5 steps.  Losses finite, only
          trainable leaves change, step-0 loss within 5% of a float32
          forward at precision "highest" on the same batch and dropout
          bits.
  serve   ``Recommender`` over a 112,590-item catalog with the device field
          cache, behind ``MicroBatcher`` and the HTTP server in this
          process; 8 /recommend requests from a thread.  Each top-10 must
          be a top-10 of the float32 reference (user embedding at
          "highest", full-catalog cosine, numpy top-k) up to score ties;
          one more batch with precision="int8" must keep user-embedding
          cosine > 0.98 against the reference.

Exits non-zero, printing no result, where JAX finds no GPU.  The last line
of standard output is one JSON object with the device JAX reports.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Tolerances, each with its reason.
TOKEN_COS_MIN = 0.999  # the repo's quality gate for bf16/int8 item tokens
# masked-field check: bf16 outputs of two runs may differ by reduction order
# (atomics in column reductions), at most ~2 bf16 ulps; a masked field that
# leaked would move tokens by O(1)
MASK_REL_TOL = 2.0 ** -7
# step-0 loss, bf16 trainer vs float32 trainer: bf16 activations keep 8
# mantissa bits through 28 layers, and InfoNCE scales cosines by 1/0.07
JOINT_LOSS_RTOL = 5e-2
# served score vs float32 reference score of the same item: served user
# embeddings run the float32 model at default (TF32) matmul precision
SERVE_SCORE_TOL = 2e-2
INT8_USER_COS_MIN = 0.98  # tests/test_serving.py::test_int8_recommender
# --four: float32 at "highest"; only the reduction order differs
FOUR_RTOL = 1e-3
FOUR_LAYERS = 2  # depth of the --four comparison (widths are full)


def log(msg: str) -> None:
    print(msg, flush=True)


def _require_gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: needs an NVIDIA GPU; JAX found platform "
                 f"{dev.platform!r}")
    return jax.devices()


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0] if out else "?"


def _peak_bytes() -> int:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def _cosine_rows(a, b):
    import numpy as np

    a = np.asarray(a, np.float64).reshape(-1, a.shape[-1])
    b = np.asarray(b, np.float64).reshape(-1, b.shape[-1])
    return (a * b).sum(-1) / (
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12)


# ---------------------------------------------------------------------------
# tokens
# ---------------------------------------------------------------------------


def phase_tokens(cfg=None, batch: int = 4096, n_batches: int = 3,
                 n_ref: int = 256, seed: int = 0) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from unirec.cli.generate_all_item_embeddings import build_inference
    from unirec.configs import ItemQFormerConfig
    from unirec.models.item_qformer import ItemQFormer

    cfg = cfg or ItemQFormerConfig()
    f, fd = cfg.num_fields, cfg.field_embedding_dim
    key = jax.random.PRNGKey(seed)
    model32 = ItemQFormer(cfg)
    params = model32.init(key, jnp.zeros((2, f, fd)), jnp.ones((2, f)))
    inference = build_inference(
        batch, dp=-1, config=cfg, params=params,
        field_names=[f"field_{i}" for i in range(f)])

    rng = np.random.default_rng(seed)
    n = batch * n_batches
    emb = rng.standard_normal((n, f, fd), dtype=np.float32)
    mask = (rng.random((n, f)) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    mask[-1] = 0.0  # one item with every field masked

    t0 = time.perf_counter()
    inference.query_tokens_from_embeddings(emb[:batch], mask[:batch])
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tokens = inference.query_tokens_from_embeddings(emb, mask)
    sweep_s = time.perf_counter() - t0
    assert tokens.shape == (n, cfg.num_query_tokens, cfg.hidden_size)
    assert np.isfinite(tokens).all(), "non-finite item tokens"

    with jax.default_matmul_precision("highest"):
        ref_fwd = jax.jit(
            lambda p, e, m: model32.apply(p, e, m)["query_outputs"])
        ref = np.asarray(ref_fwd(params, jnp.asarray(emb[:n_ref]),
                                 jnp.asarray(mask[:n_ref])))
    cos = _cosine_rows(tokens[:n_ref], ref)
    cos_min = float(cos.min())

    # masked-field invariance: rewrite the masked fields of a few items
    k = min(8, batch)
    emb2 = emb[:k].copy()
    noise = rng.standard_normal(emb2.shape, dtype=np.float32) * 10.0
    emb2 = np.where(mask[:k, :, None] > 0, emb2, noise)
    a = inference.query_tokens_from_embeddings(emb[:k], mask[:k])
    b = inference.query_tokens_from_embeddings(emb2, mask[:k])
    mask_dev = float(np.max(np.abs(a - b) - MASK_REL_TOL * np.abs(a)))

    out = {
        "items": n, "batch": batch, "compile_s": compile_s,
        "items_per_s": n / sweep_s, "cos_min": cos_min,
        "cos_mean": float(cos.mean()), "ref_items": n_ref,
        "masked_field_excess": mask_dev,
    }
    log(f"QUALITY bf16: cos_mean={out['cos_mean']:.6f} cos_min={cos_min:.6f}"
        f" (gate >= {TOKEN_COS_MIN}, {n_ref} items, float32 reference at "
        "precision highest)")
    log(f"tokens: {json.dumps(out)}")
    assert cos_min >= TOKEN_COS_MIN, f"token cosine {cos_min} < gate"
    assert mask_dev <= 0.0, f"masked fields moved the tokens ({mask_dev})"
    return out


# ---------------------------------------------------------------------------
# joint
# ---------------------------------------------------------------------------


def _joint_data(qwen_cfg, qformer_cfg, jc, n_samples: int, seed: int):
    """Synthetic catalog, field cache and rec samples for the joint stage."""
    import numpy as np

    from unirec.data.cache import FieldEmbeddingCache
    from unirec.data.tokenizer import HashTokenizer
    from unirec.train.joint import JointDataset

    rng = np.random.default_rng(seed)
    n_items = max(4 * jc.num_history_items, 64)
    ids = [f"item{i}" for i in range(n_items)]
    f, fd = qformer_cfg.num_fields, qformer_cfg.field_embedding_dim
    cache = FieldEmbeddingCache(
        embeddings=rng.standard_normal((n_items, f, fd), dtype=np.float32),
        masks=(rng.random((n_items, f)) > 0.2).astype(np.float32),
        fields=[f"field_{i}" for i in range(f)],
        item_ids=ids,
    )
    item_emb = {i: rng.standard_normal(qwen_cfg.hidden_size,
                                       dtype=np.float32) for i in ids}
    item_dict = {i: {"title": f"product {i} number {k}"}
                 for k, i in enumerate(ids)}
    data = []
    for s in range(n_samples):
        pick = rng.choice(n_items, jc.num_history_items + 11, replace=False)
        hist = [ids[j] for j in pick[:jc.num_history_items]]
        cands = [ids[j] for j in pick[jc.num_history_items:]]
        data.append({"history": hist, "candidate": cands,
                     "ground_truth": cands[0]})
    tok = HashTokenizer(qwen_cfg.vocab_size, jc.num_history_items,
                        jc.num_query_tokens_per_item)
    ds = JointDataset(data, item_emb, tok, item_dict, cache, jc,
                      item_emb_dim=qwen_cfg.hidden_size)
    return ds


def _joint_trainer(qwen_cfg, qformer_cfg, jc, batch, dp=1, tp=1):
    """``JointTrainer`` exactly as ``train joint`` builds it from flags."""
    from unirec.cli.train_cli import build_parser, joint_trainer_from_args

    args = build_parser().parse_args([
        "joint", "--train-data", "-", "--val-data", "-", "--item-emb", "-",
        "--item-dict", "-", "--qformer-checkpoint", "-", "--cache-dir", "-",
        "--batch-size", str(batch), "--dp", str(dp), "--tp", str(tp),
    ])
    return joint_trainer_from_args(args, qwen_cfg, qformer_cfg, jc)


def _run_steps(trainer, ds, steps, seed, state=None):
    """Steps through the trainer's own driver; per-step metrics and the
    host time at which each step's metrics were synced."""
    import numpy as np

    if state is None:
        state = trainer.init_state()
    rec = []

    def hook(i, st, m):
        rec.append((time.perf_counter(), dict(m)))

    t0 = time.perf_counter()
    state, _ = trainer.train_steps(state, ds, np.random.default_rng(seed),
                                   steps, step_hook=hook)
    return state, rec, t0


def _joint_reference_loss(trainer, ds, batch, seed, params):
    """InfoNCE loss of a float32 forward at precision "highest" (no remat)
    on the batch and dropout bits of the trainer's first step."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from unirec.ops.losses import info_nce_loss

    model = trainer.model.clone(dtype=jnp.float32, remat=False)
    first = next(trainer._batch_stream(ds, np.random.default_rng(seed),
                                       batch, 1))
    # the step's dropout key: fold_in(key(seed, rbg), step 0)
    rng = jax.random.fold_in(
        jax.random.key(trainer.train_config.seed, impl="rbg"), 0)

    def loss(p, b):
        user = model.apply(
            {"params": p}, b["input_ids"], b["attention_mask"],
            b["history_field_embeddings"], b["history_attention_mask"],
            deterministic=False, rngs={"dropout": rng})
        return info_nce_loss(user, b["positive_item_embeddings"],
                             b["negative_item_embeddings"],
                             b["negative_masks"])

    with jax.default_matmul_precision("highest"):
        return float(jax.jit(loss)(params, first))


def phase_joint(qwen_cfg=None, qformer_cfg=None, jc=None, batch: int = 16,
                steps: int = 5, seed: int = 0) -> dict:
    import jax
    import numpy as np

    from unirec.configs import ItemQFormerConfig, JointModelConfig, Qwen3Config
    from unirec.utils.params import lora_trainable_mask

    qwen_cfg = qwen_cfg or Qwen3Config()
    qformer_cfg = qformer_cfg or ItemQFormerConfig(num_query_tokens=2)
    jc = jc or JointModelConfig()
    ds = _joint_data(qwen_cfg, qformer_cfg, jc, 2 * batch, seed)

    trainer = _joint_trainer(qwen_cfg, qformer_cfg, jc, batch)
    state = trainer.init_state()
    init = jax.tree_util.tree_map(np.asarray, state.params)
    state, rec, t0 = _run_steps(trainer, ds, steps, seed, state)
    losses = [m["loss"] for _, m in rec]
    compile_s = rec[0][0] - t0
    step_ms = (1e3 * (rec[-1][0] - rec[0][0]) / (len(rec) - 1)
               if len(rec) > 1 else float("nan"))
    assert len(losses) == steps, losses
    assert all(np.isfinite(losses)), f"non-finite loss: {losses}"

    train_mask = lora_trainable_mask(init)
    after = jax.tree_util.tree_map(np.asarray, state.params)
    frozen_moved = sum(
        int(not np.array_equal(a, b))
        for a, b, t in zip(jax.tree_util.tree_leaves(init),
                           jax.tree_util.tree_leaves(after),
                           jax.tree_util.tree_leaves(train_mask)) if not t)
    trained_moved = sum(
        int(not np.array_equal(a, b))
        for a, b, t in zip(jax.tree_util.tree_leaves(init),
                           jax.tree_util.tree_leaves(after),
                           jax.tree_util.tree_leaves(train_mask)) if t)
    peak = _peak_bytes()
    remat = trainer.remat
    del state
    ref_loss = _joint_reference_loss(trainer, ds, batch, seed, init)
    rel = abs(losses[0] - ref_loss) / abs(ref_loss)

    out = {
        "batch": batch, "seq": jc.max_length, "layers":
        qwen_cfg.num_hidden_layers, "losses": losses,
        "grad_norms": [m["grad_norm"] for _, m in rec],
        "ref_loss_fp32": ref_loss, "loss_rel_err": rel,
        "compile_s": compile_s, "step_ms": step_ms,
        "peak_bytes_in_use": peak, "frozen_leaves_moved": frozen_moved,
        "trainable_leaves_moved": trained_moved, "remat": remat,
    }
    log(f"joint: step-0 loss {losses[0]:.6f} vs float32 {ref_loss:.6f} "
        f"(rel {rel:.2e}, tol {JOINT_LOSS_RTOL})")
    log(f"joint: {json.dumps(out)}")
    assert rel <= JOINT_LOSS_RTOL, f"step-0 loss off by {rel}"
    assert frozen_moved == 0, f"{frozen_moved} frozen leaves changed"
    assert trained_moved > 0, "no trainable leaf changed"
    return out


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------


def phase_serve(qwen_cfg=None, qformer_cfg=None, jc=None,
                n_items: int = 112_590, n_requests: int = 8, k: int = 10,
                batch_size: int = 8, seed: int = 0) -> dict:
    import threading
    import urllib.request

    import jax
    import jax.numpy as jnp
    import numpy as np

    from unirec.configs import (
        ItemQFormerConfig,
        JointModelConfig,
        LoRAConfig,
        Qwen3Config,
    )
    from unirec.data.cache import FieldEmbeddingCache
    from unirec.data.tokenizer import HashTokenizer
    from unirec.models.joint import MultiModalQwenEmbedding
    from unirec.serving.recommender import Recommender
    from unirec.serving.server import make_server

    qwen_cfg = qwen_cfg or Qwen3Config()
    qformer_cfg = qformer_cfg or ItemQFormerConfig(num_query_tokens=2)
    jc = jc or JointModelConfig()
    rng = np.random.default_rng(seed)
    f, fd = qformer_cfg.num_fields, qformer_cfg.field_embedding_dim
    ids = [f"item{i}" for i in range(n_items)]
    t0 = time.perf_counter()
    cache = FieldEmbeddingCache(
        embeddings=rng.standard_normal((n_items, f, fd), dtype=np.float32),
        masks=(rng.random((n_items, f)) > 0.2).astype(np.float32),
        fields=[f"field_{i}" for i in range(f)],
        item_ids=ids,
    )
    catalog_arr = rng.standard_normal((n_items, qwen_cfg.hidden_size),
                                      dtype=np.float32)
    catalog = dict(zip(ids, catalog_arr))
    item_dict = {i: {"title": f"product {i}"} for i in ids}
    tok = HashTokenizer(qwen_cfg.vocab_size, jc.num_history_items,
                        jc.num_query_tokens_per_item)
    # the model `serve` builds: float32 params and activations, LoRA r=16
    model = MultiModalQwenEmbedding(qwen_cfg, qformer_cfg, jc,
                                    lora=LoRAConfig())
    params = model.init(
        jax.random.PRNGKey(seed),
        jnp.zeros((1, jc.max_length), jnp.int32),
        jnp.ones((1, jc.max_length)),
        jnp.zeros((1, jc.num_history_items, f, fd)),
        jnp.ones((1, jc.num_history_items, f)),
    )
    rec = Recommender(model, params, tok, item_dict, cache, catalog,
                      batch_size=batch_size)
    data_s = time.perf_counter() - t0

    server, batcher = make_server(rec, port=0, warmup=True)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    histories = [
        [ids[j] for j in rng.choice(n_items, 1 + u % jc.num_history_items,
                                    replace=False)]
        for u in range(n_requests)
    ]
    served = [None] * n_requests

    def client():
        for u, h in enumerate(histories):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/recommend",
                data=json.dumps({"history": h, "k": k}).encode(),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=600) as r:
                served[u] = json.loads(r.read())

    t0 = time.perf_counter()
    ct = threading.Thread(target=client)
    ct.start()
    ct.join()
    http_s = time.perf_counter() - t0
    server.shutdown()
    server.server_close()
    batcher.close()

    # float32 reference: user embedding at "highest", cosine over the
    # whole catalog, numpy top-k with the history excluded
    ids_b, attn_b, he_b, hm_b = rec._build_batch(histories)
    with jax.default_matmul_precision("highest"):
        u_ref = np.asarray(jax.jit(model.apply)(
            params, ids_b, attn_b, he_b, hm_b), np.float64)
    u_ref /= np.linalg.norm(u_ref, axis=-1, keepdims=True)
    cat = catalog_arr.astype(np.float64)
    cat /= np.linalg.norm(cat, axis=-1, keepdims=True)
    scores = u_ref @ cat.T
    worst_gap = 0.0
    worst_err = 0.0
    for u, h in enumerate(histories):
        s = scores[u].copy()
        s[[rec.cache.id_to_row[i] for i in h]] = -np.inf
        kth = np.sort(s)[-k]
        items = served[u]["items"]
        assert len(items) == k, served[u]
        for it in items:
            row = int(it["item_id"][4:])
            worst_err = max(worst_err, abs(it["score"] - s[row]))
            worst_gap = max(worst_gap, kth - s[row])
    log(f"serve: max |served - reference score| {worst_err:.2e}, max "
        f"shortfall below the reference k-th score {worst_gap:.2e} "
        f"(tol {SERVE_SCORE_TOL})")

    # one more batch through the int8 projections (XLA int8 dots)
    rec8 = Recommender(model, params, tok, item_dict, cache, catalog,
                       batch_size=batch_size, precision="int8")
    u8 = rec8.encode_users(histories)
    recs8 = rec8.recommend(histories, k=k)
    cos8 = float(_cosine_rows(u8, u_ref).min())
    del rec8

    out = {
        "catalog_items": n_items, "requests": n_requests,
        "setup_s": data_s, "http_s": http_s,
        "max_score_err": worst_err, "max_kth_shortfall": worst_gap,
        "int8_user_cos_min": cos8, "peak_bytes_in_use": _peak_bytes(),
        "latency": batcher.latency_quantiles(),
    }
    log(f"serve: {json.dumps(out)}")
    assert worst_err <= SERVE_SCORE_TOL, worst_err
    assert worst_gap <= SERVE_SCORE_TOL, worst_gap
    assert all(len(r) == k for r in recs8)
    assert cos8 > INT8_USER_COS_MIN, f"int8 user cosine {cos8}"
    return out


# ---------------------------------------------------------------------------
# --four
# ---------------------------------------------------------------------------


def phase_four(qwen_cfg=None, qformer_cfg=None, jc=None, batch: int = 16,
               seed: int = 0, layouts=((4, 1), (2, 2))) -> dict:
    """One joint train step on each dp x tp layout against one device, on
    the same global batch, in float32 at precision "highest" with dropout
    off (rbg dropout bits depend on how the batch is partitioned).  Full
    widths; the decoder and the Q-Former are cut to FOUR_LAYERS layers,
    which keeps the three compilations short and changes nothing in how a
    layer is sharded."""
    import dataclasses

    import jax

    from unirec.configs import ItemQFormerConfig, JointModelConfig, Qwen3Config

    qwen_cfg = qwen_cfg or Qwen3Config(num_hidden_layers=FOUR_LAYERS)
    qformer_cfg = dataclasses.replace(
        qformer_cfg or ItemQFormerConfig(num_query_tokens=2,
                                         num_hidden_layers=FOUR_LAYERS),
        dropout=0.0)
    jc = jc or JointModelConfig()
    ds = _joint_data(qwen_cfg, qformer_cfg, jc, batch, seed)

    def one_step(dp, tp):
        trainer = _joint_trainer(qwen_cfg, qformer_cfg, jc, batch, dp, tp)
        trainer = dataclasses.replace(
            trainer, dtype="float32",
            lora=dataclasses.replace(trainer.lora, dropout=0.0))
        with jax.default_matmul_precision("highest"):
            _, rec, t0 = _run_steps(trainer, ds, 1, seed)
        m = rec[0][1]
        return {"loss": m["loss"], "grad_norm": m["grad_norm"],
                "step_s": rec[0][0] - t0}

    ref = one_step(1, 1)
    out = {"1x1": ref}
    for dp, tp in layouts:
        got = one_step(dp, tp)
        got["loss_rel_err"] = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
        got["grad_norm_rel_err"] = (abs(got["grad_norm"] - ref["grad_norm"])
                                    / abs(ref["grad_norm"]))
        out[f"dp{dp}xtp{tp}"] = got
        log(f"four: dp={dp} tp={tp} loss {got['loss']:.6f} vs "
            f"{ref['loss']:.6f} (rel {got['loss_rel_err']:.2e}), grad norm "
            f"{got['grad_norm']:.6f} vs {ref['grad_norm']:.6f} (rel "
            f"{got['grad_norm_rel_err']:.2e}), tol {FOUR_RTOL}")
    log(f"four: {json.dumps(out)}")
    for name, got in out.items():
        if name != "1x1":
            assert got["loss_rel_err"] <= FOUR_RTOL, (name, got)
            assert got["grad_norm_rel_err"] <= FOUR_RTOL, (name, got)
    return out


PHASES = {"tokens": phase_tokens, "joint": phase_joint, "serve": phase_serve}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", choices=sorted(PHASES),
                    help="run only this phase")
    ap.add_argument("--four", action="store_true",
                    help="only the joint step on dp=4 and dp=2 x tp=2 "
                         "against one GPU (four GPUs)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    devices = _require_gpu()
    sys.path.insert(0, REPO)
    from unirec.runtime import setup_runtime

    cache_dir = setup_runtime()
    import jax

    dev = devices[0]
    log(f"gpu: {_nvidia_smi()}")
    log(f"device_kind: {dev.device_kind}; devices: {len(devices)}; "
        f"jax {jax.__version__}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; compile cache: "
        f"{cache_dir}")

    if args.four:
        if len(devices) < 4:
            sys.exit(f"chip_smoke --four: needs 4 GPUs, found {len(devices)}")
        phase_four(seed=args.seed)
    else:
        for name, fn in PHASES.items():
            if args.phase in (None, name):
                t0 = time.perf_counter()
                fn(seed=args.seed)
                log(f"phase {name} ok in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
