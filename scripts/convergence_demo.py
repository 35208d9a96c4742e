"""Convergence-quality demo: both frameworks trained to convergence on a
deterministic synthetic All_Beauty-shaped corpus.

The feasible proxy for the environment-blocked real-data north star
(BASELINE.json Recall@10/NDCG@10 on All_Beauty — no dataset or pretrained
weights are available offline): generate a seeded corpus with learnable latent
structure, train the ITEM stage and the JOINT stage to convergence in BOTH
frameworks from identical random init on identical batches, and compare the
final quality metrics each framework's own evaluator reports:

* item stage — masked reconstruction MSE + mean per-valid-field cosine
  (reference evaluator semantics: evaluation/evaluate_item_qformer.py:41-104);
* joint stage — MRR / Recall@10 / NDCG@10 over 100-candidate pools
  (reference eval loop: train_item_individual_token_joint.py:392-419; the
  reference computes MRR only — Recall/NDCG are computed for both sides here
  with the same ranking rule).

Run: python scripts/convergence_demo.py  (CPU; ~2-4 min on this host)
Prints one JSON line per stage with both frameworks' numbers side by side.
"""

import json
import sys

sys.path.insert(0, ".")
sys.path.insert(0, "/root/reference")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

# reference-module shims (older transformers; CPU host)
import transformers.modeling_utils as _mu  # noqa: E402
import transformers.pytorch_utils as _pu  # noqa: E402

for _name in (
    "apply_chunking_to_forward",
    "find_pruneable_heads_and_indices",
    "prune_linear_layer",
):
    if not hasattr(_mu, _name):
        setattr(_mu, _name, getattr(_pu, _name))
_orig = torch.cuda.set_device
torch.cuda.set_device = lambda *a, **k: None
from training.train_item_individual_token_joint import (  # noqa: E402
    InfoNCELoss as RefInfoNCELoss,
    MultiModalQwenEmbedding as RefJointModel,
)

torch.cuda.set_device = _orig
from models.qformer_utils import QFormerForItemRepresentation  # noqa: E402
from training.item_qformer_training import QFormerLoss  # noqa: E402

from unirec.configs import (  # noqa: E402
    ItemQFormerConfig,
    JointModelConfig,
    LoRAConfig,
    MeshConfig,
    OptimizerConfig,
    Qwen3Config,
    TrainConfig,
)
from unirec.data.cache import FieldEmbeddingCache  # noqa: E402
from unirec.data.tokenizer import HashTokenizer  # noqa: E402
from unirec.models.item_qformer import ItemQFormer  # noqa: E402
from unirec.train.common import TrainState, make_optimizer  # noqa: E402
from unirec.train.item_qformer import make_train_step  # noqa: E402
from unirec.train.joint import JointDataset, JointTrainer  # noqa: E402
from unirec.utils.params import prune_to_structure  # noqa: E402
from unirec.utils.torch_convert import (  # noqa: E402
    convert_item_qformer,
    convert_joint_model,
)

HIDDEN, LAYERS, HEADS, FFN, WIDTH, F = 64, 2, 4, 128, 48, 6
N_ITEMS, N_USERS, LATENT = 240, 160, 16
K_ITEM = 8  # item-stage query tokens (production: 32 — `--scaled`)
VOCAB = 128


# ---------------------------------------------------------------------------
# Synthetic corpus with learnable latent structure
# ---------------------------------------------------------------------------


def make_corpus(seed=0):
    rng = np.random.RandomState(seed)
    z = rng.randn(N_ITEMS, LATENT).astype(np.float32)
    field_maps = (rng.randn(F, LATENT, WIDTH) / np.sqrt(LATENT)).astype(np.float32)
    fields = np.einsum("nl,flw->nfw", z, field_maps).astype(np.float32)
    fields += (0.1 * rng.randn(*fields.shape)).astype(np.float32)
    masks = (rng.rand(N_ITEMS, F) > 0.15).astype(np.float32)
    masks[:, 0] = 1.0
    fields *= masks[..., None]

    # candidate-pool target embeddings share the latent (so ranking is
    # learnable): E = z @ B, unit-normalized
    emb_map = (rng.randn(LATENT, HIDDEN) / np.sqrt(LATENT)).astype(np.float32)
    cand = (z @ emb_map).astype(np.float32)
    cand /= np.linalg.norm(cand, axis=-1, keepdims=True)

    # users walk a preference direction; histories + gt sampled by affinity
    users = []
    for _ in range(N_USERS):
        pref = rng.randn(LATENT).astype(np.float32)
        logits = z @ pref * 1.5
        p = np.exp(logits - logits.max())
        p /= p.sum()
        seq = rng.choice(N_ITEMS, size=12, replace=False, p=p)
        gt = seq[-1]
        negs = rng.choice(
            [i for i in range(N_ITEMS) if i != gt], size=99, replace=False
        )
        users.append(
            {
                "history": [f"i{k}" for k in seq[:-1]],
                "ground_truth": f"i{gt}",
                "candidate": [f"i{gt}"] + [f"i{k}" for k in negs],
            }
        )
    cache = FieldEmbeddingCache(
        embeddings=fields,
        masks=masks,
        fields=[f"f{j}" for j in range(F)],
        item_ids=[f"i{k}" for k in range(N_ITEMS)],
    )
    emb_dict = {f"i{k}": cand[k].tolist() for k in range(N_ITEMS)}
    item_dict = {f"i{k}": {"title": f"Synthetic product {k}"} for k in range(N_ITEMS)}
    return cache, emb_dict, item_dict, users, fields, masks


# ---------------------------------------------------------------------------
# Stage 1: item Q-Former to convergence
# ---------------------------------------------------------------------------


def item_stage(cache, users, fields, masks, steps=400, batch=64, lr=1e-3,
               seed=1):
    cfg = ItemQFormerConfig(
        hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN,
        num_query_tokens=K_ITEM, field_embedding_dim=WIDTH, num_fields=F,
        dropout=0.0,
    )
    torch.manual_seed(seed)
    tmodel = QFormerForItemRepresentation(
        hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN,
        num_query_tokens=K_ITEM, field_embedding_dim=WIDTH, num_fields=F,
        dropout=0.0,
    )
    tmodel.train()
    criterion = QFormerLoss(
        reconstruction_weight=1.0, contrastive_weight=0.25, margin=0.5
    )
    topt = torch.optim.AdamW(tmodel.parameters(), lr=lr, weight_decay=0.01)

    fmodel = ItemQFormer(cfg)
    params = convert_item_qformer(tmodel.state_dict(), cfg)
    state = TrainState.create(
        apply_fn=fmodel.apply, params=params,
        tx=make_optimizer(OptimizerConfig(learning_rate=lr, weight_decay=0.01)),
    )
    step = jax.jit(make_train_step(fmodel))

    # triplets: consecutive history pairs; 90/10 item split for held-out eval
    rng = np.random.RandomState(seed)
    row = {f"i{k}": k for k in range(N_ITEMS)}
    perm = rng.permutation(N_ITEMS)
    val_rows = np.sort(perm[: N_ITEMS // 10])
    val_set = set(val_rows.tolist())
    pairs = [
        (row[u["history"][i]], row[u["history"][i + 1]])
        for u in users
        for i in range(len(u["history"]) - 1)
        if row[u["history"][i]] not in val_set
        and row[u["history"][i + 1]] not in val_set
    ]
    pairs = np.asarray(pairs, np.int32)

    for s in range(steps):
        idx = rng.randint(0, len(pairs), batch)
        anc, pos = pairs[idx, 0], pairs[idx, 1]
        neg = rng.randint(0, N_ITEMS, batch)
        b = {
            "anchor_emb": fields[anc], "anchor_mask": masks[anc],
            "pos_emb": fields[pos], "pos_mask": masks[pos],
            "neg_emb": fields[neg], "neg_mask": masks[neg],
        }
        # torch step (reference loop, item_qformer_training.py:114-131)
        a_out = tmodel(torch.tensor(b["anchor_emb"]),
                       torch.tensor(b["anchor_mask"]))
        with torch.no_grad():
            p_out = tmodel(torch.tensor(b["pos_emb"]),
                           torch.tensor(b["pos_mask"]))
            n_out = tmodel(torch.tensor(b["neg_emb"]),
                           torch.tensor(b["neg_mask"]))
        loss, _, _ = criterion(
            a_out, {"field_embeddings": torch.tensor(b["anchor_emb"])},
            p_out["item_representation"], n_out["item_representation"],
            torch.tensor(b["anchor_mask"]),
        )
        topt.zero_grad()
        loss.backward()
        topt.step()
        # flax step (the shipped trainer step) on the same batch
        state, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()})

    # held-out reconstruction quality, reference evaluator semantics
    ve, vm = fields[val_rows], masks[val_rows]
    tmodel.eval()
    with torch.no_grad():
        t_out = tmodel(torch.tensor(ve), torch.tensor(vm))
    t_rec = t_out["reconstructed_fields"].numpy()

    f_out = fmodel.apply({"params": state.params}, jnp.asarray(ve),
                         jnp.asarray(vm))
    f_rec = np.asarray(f_out["reconstructed_fields"])

    def recon_metrics(rec):
        err = ((rec - ve) ** 2 * vm[..., None]).sum() / vm.sum()
        o = ve / np.maximum(np.linalg.norm(ve, axis=-1, keepdims=True), 1e-12)
        r = rec / np.maximum(np.linalg.norm(rec, axis=-1, keepdims=True), 1e-12)
        cos = ((o * r).sum(-1) * vm).sum() / vm.sum()
        return float(err), float(cos)

    t_mse, t_cos = recon_metrics(t_rec)
    f_mse, f_cos = recon_metrics(f_rec)
    return {
        "stage": "item",
        "steps": steps,
        "reference": {"val_recon_mse": round(t_mse, 4),
                      "val_cosine": round(t_cos, 4)},
        "unirec": {"val_recon_mse": round(f_mse, 4),
                       "val_cosine": round(f_cos, 4)},
    }


# ---------------------------------------------------------------------------
# Stage 1.5: user Q-Former to convergence
# ---------------------------------------------------------------------------


def user_stage(users, fields, masks, steps=300, batch=32, lr=1e-3, seed=3):
    """Next-item token prediction (reference: user_qformer_training.py:17-68,
    199-213 — MSE between UserQFormer(seq) and the next item's query tokens,
    AdamW).  Item tokens are a fixed linear image of the corpus fields, so
    they inherit the latent preference structure and the next item is
    learnable from the history."""
    from training.user_qformer_training import UserQFormer as RefUserQFormer

    from unirec.configs import UserQFormerConfig
    from unirec.models.user_qformer import UserQFormer as FlaxUserQFormer
    from unirec.utils.torch_convert import convert_user_qformer

    K_PRED, L_ITEMS = 4, 8  # tokens per item; max history items in a window
    rng = np.random.RandomState(seed)
    proj = (rng.randn(F * WIDTH, K_PRED * HIDDEN)
            / np.sqrt(F * WIDTH)).astype(np.float32)
    tokens = (
        (fields * masks[..., None]).reshape(N_ITEMS, F * WIDTH) @ proj
    ).reshape(N_ITEMS, K_PRED, HIDDEN) * 3.0

    row = {f"i{k}": k for k in range(N_ITEMS)}
    split = int(0.9 * len(users))

    def windows(us):
        seq_len = L_ITEMS * K_PRED
        inp, msk, tgt = [], [], []
        for u in us:
            hist = [row[i] for i in u["history"]]
            for j in range(3, len(hist)):
                ctx = hist[max(0, j - L_ITEMS): j]
                x = np.zeros((seq_len, HIDDEN), np.float32)
                m = np.zeros((seq_len,), np.float32)
                flat = tokens[ctx].reshape(-1, HIDDEN)
                x[: len(flat)] = flat
                m[: len(flat)] = 1.0
                inp.append(x)
                msk.append(m)
                tgt.append(tokens[hist[j]])
        return (np.stack(inp), np.stack(msk), np.stack(tgt))

    tr_inp, tr_msk, tr_tgt = windows(users[:split])
    va_inp, va_msk, va_tgt = windows(users[split:])

    torch.manual_seed(seed)
    tmodel = RefUserQFormer(
        hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN,
        num_query_tokens=8, input_embedding_dim=HIDDEN,
        num_item_tokens_to_predict=K_PRED, dropout=0.0,
    )
    tmodel.train()
    criterion = torch.nn.MSELoss()
    # reference: optim.AdamW(model.parameters(), lr=...) — default wd 0.01
    topt = torch.optim.AdamW(tmodel.parameters(), lr=lr, weight_decay=0.01)

    ucfg = UserQFormerConfig(
        hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN,
        num_query_tokens=8, input_embedding_dim=HIDDEN,
        num_item_tokens_to_predict=K_PRED, dropout=0.0,
    )
    fmodel = FlaxUserQFormer(ucfg)
    init = fmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(tr_inp[:2]), jnp.asarray(tr_msk[:2])
    )["params"]
    params = prune_to_structure(
        convert_user_qformer(tmodel.state_dict(), ucfg), jax.device_get(init)
    )
    state = TrainState.create(
        apply_fn=fmodel.apply, params=params,
        tx=make_optimizer(OptimizerConfig(learning_rate=lr, weight_decay=0.01)),
    )

    @jax.jit
    def step(state, inp, msk, tgt):
        def loss_fn(p):
            pred = fmodel.apply({"params": p}, inp, msk)
            return jnp.mean((pred - tgt) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads=grads), loss

    for s in range(steps):
        idx = rng.randint(0, len(tr_inp), batch)
        bi, bm, bt = tr_inp[idx], tr_msk[idx], tr_tgt[idx]
        pred = tmodel(torch.tensor(bi), torch.tensor(bm))
        loss = criterion(pred, torch.tensor(bt))
        topt.zero_grad()
        loss.backward()
        topt.step()
        state, _ = step(state, jnp.asarray(bi), jnp.asarray(bm),
                        jnp.asarray(bt))

    def pred_metrics(pred):
        mse = float(np.mean((pred - va_tgt) ** 2))
        o = va_tgt / np.maximum(
            np.linalg.norm(va_tgt, axis=-1, keepdims=True), 1e-12)
        r = pred / np.maximum(
            np.linalg.norm(pred, axis=-1, keepdims=True), 1e-12)
        return mse, float(np.mean((o * r).sum(-1)))

    tmodel.eval()
    with torch.no_grad():
        t_pred = tmodel(torch.tensor(va_inp), torch.tensor(va_msk)).numpy()
    f_pred = np.asarray(
        fmodel.apply({"params": state.params}, jnp.asarray(va_inp),
                     jnp.asarray(va_msk))
    )
    t_mse, t_cos = pred_metrics(t_pred)
    f_mse, f_cos = pred_metrics(f_pred)
    base = float(np.mean(va_tgt ** 2))  # predict-zero baseline
    return {
        "stage": "user",
        "steps": steps,
        "val_windows": len(va_inp),
        "predict_zero_mse": round(base, 4),
        "reference": {"val_pred_mse": round(t_mse, 4),
                      "val_token_cosine": round(t_cos, 4)},
        "unirec": {"val_pred_mse": round(f_mse, 4),
                       "val_token_cosine": round(f_cos, 4)},
    }


# ---------------------------------------------------------------------------
# Stage 2: joint Qwen3+LoRA to convergence
# ---------------------------------------------------------------------------


class _StubTok:
    def __init__(self, history_tokens):
        self._ids = {t: VOCAB + i for i, t in enumerate(history_tokens)}

    def convert_tokens_to_ids(self, tok):
        return self._ids[tok]


def build_ref_joint(lora_cfg, seed):
    from peft import LoraConfig, TaskType, get_peft_model
    from transformers import Qwen3Config as HFQwen3Config, Qwen3Model

    torch.manual_seed(seed)
    base = Qwen3Model(HFQwen3Config(
        vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=FFN,
        num_hidden_layers=LAYERS, num_attention_heads=HEADS,
        num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-6,
        rope_theta=1000000.0, attention_bias=False,
    ))
    base.resize_token_embeddings(VOCAB + 20)
    base = get_peft_model(base, LoraConfig(
        task_type=TaskType.FEATURE_EXTRACTION, r=lora_cfg.r,
        lora_alpha=int(lora_cfg.alpha), lora_dropout=0.0,
        target_modules=list(lora_cfg.target_modules), bias="none",
    ))
    qformer = QFormerForItemRepresentation(
        hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN,
        num_query_tokens=2, field_embedding_dim=WIDTH, num_fields=F,
        dropout=0.0,
    )
    model = RefJointModel.__new__(RefJointModel)
    torch.nn.Module.__init__(model)
    model.device = torch.device("cpu")
    model.use_lora = True
    model.num_history_items = 10
    model.num_query_tokens_per_item = 2
    model.qformer_model = qformer
    model.base_model = base
    model.hidden_size = HIDDEN
    model.history_tokens = [
        f"<|history_item_{i}_query_{j}|>" for i in range(10) for j in range(2)
    ]
    model.tokenizer = _StubTok(model.history_tokens)
    return model


def _torch_user_emb(tmodel, batch):
    return tmodel(
        input_ids=torch.tensor(batch["input_ids"], dtype=torch.long),
        attention_mask=torch.tensor(batch["attention_mask"]),
        history_field_embeddings=torch.tensor(
            batch["history_field_embeddings"]),
        history_attention_mask=torch.tensor(
            batch["history_attention_mask"]),
    )


def _rank_metrics(ranks, ks=(10,)):
    ranks = np.asarray(ranks, np.float64)
    out = {"mrr": round(float(np.mean(1.0 / ranks)), 4)}
    for k in ks:
        out[f"recall@{k}"] = round(float(np.mean(ranks <= k)), 4)
        out[f"ndcg@{k}"] = round(
            float(np.mean(np.where(ranks <= k, 1.0 / np.log2(ranks + 1), 0.0))),
            4,
        )
    return out


def joint_stage(cache, emb_dict, item_dict, users, steps=800, batch=8,
                lr=1e-3, seed=2):
    qc = Qwen3Config(
        vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=FFN,
        num_hidden_layers=LAYERS, num_attention_heads=HEADS,
        num_key_value_heads=2, head_dim=16,
    )
    icfg = ItemQFormerConfig(
        hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN,
        num_query_tokens=2, field_embedding_dim=WIDTH, num_fields=F,
        dropout=0.0,
    )
    lora = LoRAConfig(r=4, alpha=8.0, dropout=0.0)
    jc = JointModelConfig(max_length=96)

    tmodel = build_ref_joint(lora, seed)
    tmodel.train()
    criterion = RefInfoNCELoss(temperature=0.07)
    trainable = [p for p in tmodel.parameters() if p.requires_grad]
    topt = torch.optim.AdamW(trainable, lr=lr, weight_decay=0.0)
    sched = torch.optim.lr_scheduler.LambdaLR(topt, lambda s: min(1.0, s / 5.0))

    opt = OptimizerConfig(learning_rate=lr, weight_decay=0.0, warmup_steps=5,
                          max_grad_norm=1.0)
    trainer = JointTrainer(
        qc, icfg, jc, lora=lora,
        train_config=TrainConfig(batch_size=batch, optimizer=opt,
                                 mesh=MeshConfig(dp=1)),
    )
    state = trainer.init_state()
    converted = convert_joint_model(tmodel.state_dict(), qc, icfg)
    params = prune_to_structure(converted, jax.device_get(state.params))
    state = TrainState.create(
        apply_fn=state.apply_fn, params=params, tx=state.tx
    )

    tok = HashTokenizer(VOCAB, 10, 2)
    # 80/20 train/test (reference split rule, process_rec_new_user.py:118)
    split = int(0.8 * len(users))
    train_ds = JointDataset(users[:split], emb_dict, tok, item_dict, cache,
                            jc, max_negatives=10, item_emb_dim=HIDDEN)
    test_ds = JointDataset(users[split:], emb_dict, tok, item_dict, cache,
                           jc, max_negatives=99, item_emb_dim=HIDDEN)

    init_metrics = trainer.evaluate(state, test_ds, batch_size=16,
                                    max_negatives=99, ks=(10,))
    init_metrics = {k: round(float(v), 4) for k, v in init_metrics.items()
                    if k in ("mrr", "recall@10", "ndcg@10")}

    rng = np.random.RandomState(seed)
    for s in range(steps):
        idx = rng.randint(0, len(train_ds), batch)
        b = train_ds.batch(idx.tolist())
        # torch step (reference compute_loss + Trainer optimization,
        # train_item_individual_token_joint.py:482-498, 755-773)
        user = _torch_user_emb(tmodel, b)
        loss = criterion(
            user,
            torch.tensor(b["positive_item_embeddings"]),
            torch.tensor(b["negative_item_embeddings"]),
            torch.tensor(b["negative_masks"]).bool(),
        )
        topt.zero_grad()
        loss.backward()
        torch.nn.utils.clip_grad_norm_(trainable, 1.0)
        topt.step()
        sched.step()
        # flax step on the same batch
        state, _ = trainer._train_step(
            state, {k: jnp.asarray(v) for k, v in b.items()}
        )

    # -- eval: both frameworks rank the full 100-candidate pools -----------
    f_metrics = trainer.evaluate(state, test_ds, batch_size=16,
                                 max_negatives=99, ks=(10,))
    f_metrics = {k: round(float(v), 4) for k, v in f_metrics.items()
                 if k in ("mrr", "recall@10", "ndcg@10")}

    tmodel.eval()
    ranks = []
    with torch.no_grad():
        for i in range(0, len(test_ds), 16):
            idx = list(range(i, min(i + 16, len(test_ds))))
            b = test_ds.batch(idx, max_negatives=99)
            u = _torch_user_emb(tmodel, b).numpy()
            u = u / np.maximum(np.linalg.norm(u, axis=-1, keepdims=True), 1e-12)
            p = b["positive_item_embeddings"]
            p = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-12)
            n = b["negative_item_embeddings"]
            n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
            pos_sim = (u * p).sum(-1)
            neg_sim = np.einsum("bd,bnd->bn", u, n)
            neg_sim[b["negative_masks"] == 0] = -np.inf
            ranks.extend((1 + (neg_sim > pos_sim[:, None]).sum(-1)).tolist())
    t_metrics = _rank_metrics(ranks)

    return {
        "stage": "joint",
        "steps": steps,
        "test_users": len(test_ds),
        "untrained_init": init_metrics,
        "reference": t_metrics,
        "unirec": f_metrics,
    }


def main():
    import argparse

    global N_ITEMS, N_USERS, F, K_ITEM

    p = argparse.ArgumentParser()
    p.add_argument(
        "--scaled", action="store_true",
        help="one notch up — 2k items / 1k users, the production field "
        "count (F=14) and item query-token count (K=32); step counts "
        "scaled with the corpus.  ~10x the default's runtime (the torch "
        "reference side dominates).",
    )
    args = p.parse_args()
    steps = {"item": 400, "user": 300, "joint": 800}
    if args.scaled:
        N_ITEMS, N_USERS, F, K_ITEM = 2000, 1000, 14, 32
        steps = {"item": 1200, "user": 600, "joint": 1600}

    cache, emb_dict, item_dict, users, fields, masks = make_corpus()
    r1 = item_stage(cache, users, fields, masks, steps=steps["item"])
    print(json.dumps(r1), flush=True)
    r15 = user_stage(users, fields, masks, steps=steps["user"])
    print(json.dumps(r15), flush=True)
    r2 = joint_stage(cache, emb_dict, item_dict, users, steps=steps["joint"])
    print(json.dumps(r2), flush=True)


if __name__ == "__main__":
    main()
