"""Training-step parity: rebuilt trainers vs the PyTorch reference trainers.

the last unverified correctness axis: identical-init,
identical-batch ONE-STEP loss + per-leaf gradient comparison, then a
~20-step loss-trajectory comparison with matched AdamW hyperparameters,
for all three training stages:

* item Q-Former trainer — masked recon MSE + TripletMargin(0.5), pos/neg
  forwards detached (reference: training/item_qformer_training.py:41-56,
  114-131);
* user Q-Former trainer — MSE on next-item query tokens, frozen context
  encoding (reference: training/user_qformer_training.py:190-229);
* joint Qwen3+LoRA trainer — InfoNCE τ=0.07 over pos + masked negatives,
  query-token injection, mean pooling, PEFT-style freeze (reference:
  training/train_item_individual_token_joint.py:88-212, 326-352, 477-498).

The reference is used strictly as a test oracle.  Gradients are compared by
converting the torch ``.grad`` tree through the same weight converters used
for parameters (utils/torch_convert) so both sides share one tree layout.
"""

import numpy as np
import pytest

from tests.conftest import add_reference_to_path, reference_available

torch = pytest.importorskip("torch")

if not reference_available():  # pragma: no cover
    pytest.skip("reference tree unavailable", allow_module_level=True)

add_reference_to_path()

# Older-transformers shim (same as test_parity_qformer).
import transformers.modeling_utils as _mu  # noqa: E402
import transformers.pytorch_utils as _pu  # noqa: E402

for _name in (
    "apply_chunking_to_forward",
    "find_pruneable_heads_and_indices",
    "prune_linear_layer",
):
    if not hasattr(_mu, _name):
        setattr(_mu, _name, getattr(_pu, _name))

# The reference joint module calls torch.cuda.set_device(0) at import time
# (train_item_individual_token_joint.py:33) — no-op it on this CPU host.
_orig_set_device = torch.cuda.set_device
torch.cuda.set_device = lambda *a, **k: None
try:
    from training.train_item_individual_token_joint import (  # noqa: E402
        InfoNCELoss as RefInfoNCELoss,
        MultiModalQwenEmbedding as RefJointModel,
    )
finally:
    torch.cuda.set_device = _orig_set_device

from models.qformer_utils import QFormerForItemRepresentation  # noqa: E402
from training.item_qformer_training import QFormerLoss  # noqa: E402
from training.user_qformer_training import UserQFormer as RefUserQFormer  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from unirec.configs import (  # noqa: E402
    ItemQFormerConfig,
    JointModelConfig,
    LoRAConfig,
    MeshConfig,
    OptimizerConfig,
    Qwen3Config,
    TrainConfig,
    UserQFormerConfig,
)
from unirec.models.item_qformer import ItemQFormer  # noqa: E402
from unirec.models.joint import MultiModalQwenEmbedding  # noqa: E402
from unirec.train.common import TrainState, make_optimizer  # noqa: E402
from unirec.utils.torch_convert import (  # noqa: E402
    convert_item_qformer,
    convert_joint_model,
    convert_user_qformer,
)

HIDDEN, LAYERS, HEADS, FFN, WIDTH, K, F = 64, 2, 4, 128, 48, 8, 6


def _prune_to(tree, template):
    """Drop converter-emitted subtrees the flax init does not create (the
    torch BertLayer always materializes the text-FFN params even on the
    query-only path; they are unused and carry zero grads)."""
    if isinstance(template, dict):
        return {k: _prune_to(tree[k], template[k]) for k in template}
    return tree


def _grads_sd(model):
    """state_dict-shaped dict of grads; None (frozen/unused) -> zeros."""
    return {
        name: (p.grad if p.grad is not None else torch.zeros_like(p))
        for name, p in model.named_parameters()
    }


def _assert_tree_close(got, want, atol, rtol, prefix=""):
    flat_g, _ = jax.tree_util.tree_flatten_with_path(got)
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    assert len(flat_g) == len(flat_w)
    for (pg, g), (pw, w) in zip(flat_g, flat_w):
        assert jax.tree_util.keystr(pg) == jax.tree_util.keystr(pw)
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w), atol=atol, rtol=rtol,
            err_msg=prefix + jax.tree_util.keystr(pg),
        )


# ---------------------------------------------------------------------------
# Stage 2: item Q-Former trainer
# ---------------------------------------------------------------------------


def _item_batch(rng, b=4):
    def fields():
        emb = rng.randn(b, F, WIDTH).astype(np.float32)
        mask = (rng.rand(b, F) > 0.3).astype(np.float32)
        mask[:, 0] = 1.0
        return emb, mask

    a_emb, a_mask = fields()
    p_emb, p_mask = fields()
    n_emb, n_mask = fields()
    return {
        "anchor_emb": a_emb, "anchor_mask": a_mask,
        "pos_emb": p_emb, "pos_mask": p_mask,
        "neg_emb": n_emb, "neg_mask": n_mask,
    }


def _torch_item_step(tmodel, criterion, batch):
    """One reference train step (item_qformer_training.py:114-131); returns
    (loss, grads state_dict) WITHOUT applying the optimizer."""
    anc_out = tmodel(
        torch.tensor(batch["anchor_emb"]), torch.tensor(batch["anchor_mask"])
    )
    with torch.no_grad():
        pos_out = tmodel(
            torch.tensor(batch["pos_emb"]), torch.tensor(batch["pos_mask"])
        )
        neg_out = tmodel(
            torch.tensor(batch["neg_emb"]), torch.tensor(batch["neg_mask"])
        )
    loss, recon, cont = criterion(
        anc_out,
        {"field_embeddings": torch.tensor(batch["anchor_emb"])},
        pos_out["item_representation"],
        neg_out["item_representation"],
        torch.tensor(batch["anchor_mask"]),
    )
    tmodel.zero_grad()
    loss.backward()
    return float(loss.detach()), _grads_sd(tmodel)


def test_item_trainer_step_and_trajectory_parity():
    from unirec.train.item_qformer import make_train_step

    torch.manual_seed(10)
    tmodel = QFormerForItemRepresentation(
        hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN,
        num_query_tokens=K, field_embedding_dim=WIDTH, num_fields=F,
        dropout=0.0,
    )
    tmodel.train()
    criterion = QFormerLoss(
        reconstruction_weight=1.0, contrastive_weight=0.25, margin=0.5
    )

    cfg = ItemQFormerConfig(
        hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN,
        num_query_tokens=K, field_embedding_dim=WIDTH, num_fields=F,
        dropout=0.0,
    )
    fmodel = ItemQFormer(cfg)
    params = convert_item_qformer(tmodel.state_dict(), cfg)

    rng = np.random.RandomState(10)
    batches = [_item_batch(rng) for _ in range(5)]

    # -- one-step gradient parity ------------------------------------------
    t_loss, t_grads_sd = _torch_item_step(tmodel, criterion, batches[0])
    t_grads = convert_item_qformer(t_grads_sd, cfg)

    # torch AdamW defaults (item_qformer_training.py:107): wd=0.01, eps=1e-8
    opt = OptimizerConfig(learning_rate=1e-3, weight_decay=0.01)
    step = jax.jit(make_train_step(
        fmodel, 1.0, 0.25, 0.5, return_grads=True
    ))
    state = TrainState.create(
        apply_fn=fmodel.apply, params=params, tx=make_optimizer(opt)
    )
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    state, metrics = step(state, jb)
    np.testing.assert_allclose(float(metrics["loss"]), t_loss, rtol=1e-5)
    _assert_tree_close(metrics["grads"], t_grads, atol=3e-6, rtol=2e-3,
                       prefix="item grad ")

    # -- 20-step loss trajectory with matched AdamW ------------------------
    topt = torch.optim.AdamW(
        tmodel.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=0.01,
    )
    t_traj = [t_loss]
    topt.step()  # apply step 0's grads (already backpropped above)
    for i in range(1, 20):
        batch = batches[i % len(batches)]
        loss, _ = _torch_item_step(tmodel, criterion, batch)
        t_traj.append(loss)
        topt.step()

    f_traj = [float(metrics["loss"])]
    for i in range(1, 20):
        jb = {k: jnp.asarray(v) for k, v in batches[i % len(batches)].items()}
        state, metrics = step(state, jb)
        f_traj.append(float(metrics["loss"]))

    np.testing.assert_allclose(f_traj, t_traj, rtol=5e-4, atol=1e-6)
    # actually training: same batch (0) recurs every 5 steps
    assert f_traj[15] < f_traj[0]


# ---------------------------------------------------------------------------
# Stage 3: user Q-Former trainer
# ---------------------------------------------------------------------------


def test_user_trainer_step_and_trajectory_parity():
    from unirec.train.user_qformer import UserQFormerTrainer

    k_pred, n_q = 4, K  # predict 4 item tokens; 8 user query tokens
    torch.manual_seed(11)
    tmodel = RefUserQFormer(
        hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN,
        num_query_tokens=n_q, input_embedding_dim=WIDTH,
        num_item_tokens_to_predict=k_pred, dropout=0.0,
    )
    tmodel.train()

    ucfg = UserQFormerConfig(
        hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN,
        num_query_tokens=n_q, input_embedding_dim=WIDTH,
        num_item_tokens_to_predict=k_pred, dropout=0.0,
    )
    # reference semantics: context encoders frozen, AdamW(torch defaults)
    # over UserQFormer params only (user_qformer_training.py:191-194)
    trainer = UserQFormerTrainer(
        ucfg,
        TrainConfig(
            batch_size=4,
            optimizer=OptimizerConfig(learning_rate=1e-3, weight_decay=0.01),
            mesh=MeshConfig(dp=1),
        ),
        max_seq_len=5,
        train_context=False,
    )
    state = trainer.init_state()
    user_params = _prune_to(
        convert_user_qformer(tmodel.state_dict(), ucfg),
        jax.device_get(state.params["user"]),
    )
    params = {"sequence": state.params["sequence"], "user": user_params}
    state = TrainState.create(
        apply_fn=trainer.user_model.apply, params=params, tx=state.tx
    )

    rng = np.random.RandomState(11)
    b, s = 4, 5
    batches = []
    for _ in range(5):
        batches.append({
            "item_tokens": rng.randn(b, s, k_pred, WIDTH).astype(np.float32),
            "timestamps": rng.rand(b, s).astype(np.float32) * 1e9,
            "coordinates": rng.randn(b, s, 2).astype(np.float32),
            "seq_mask": np.concatenate(
                [np.ones((b, 3), np.float32),
                 (rng.rand(b, s - 3) > 0.5).astype(np.float32)], axis=1),
            "target_tokens": rng.randn(b, k_pred, WIDTH).astype(np.float32),
        })

    # the frozen sequence assembly feeds BOTH frameworks identical inputs
    seq_apply = jax.jit(trainer.seq_model.apply)
    torch_inputs = []
    for batch in batches:
        flat, flat_mask = seq_apply(
            {"params": params["sequence"]},
            jnp.asarray(batch["item_tokens"]),
            jnp.asarray(batch["timestamps"]),
            jnp.asarray(batch["coordinates"]),
            jnp.asarray(batch["seq_mask"]),
        )
        torch_inputs.append(
            (torch.tensor(np.asarray(flat)), torch.tensor(np.asarray(flat_mask)),
             torch.tensor(batch["target_tokens"]))
        )

    def torch_step(i):
        """reference: user_qformer_training.py:199-213 (without opt.step)."""
        flat, mask, target = torch_inputs[i % len(torch_inputs)]
        pred = tmodel(flat, mask)
        loss = torch.nn.functional.mse_loss(pred, target)
        tmodel.zero_grad()
        loss.backward()
        return float(loss.detach()), _grads_sd(tmodel)

    step = jax.jit(trainer._make_step(return_grads=True))

    # -- one-step parity ---------------------------------------------------
    t_loss, t_grads_sd = torch_step(0)
    t_grads = _prune_to(
        convert_user_qformer(t_grads_sd, ucfg), user_params
    )
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    state, metrics = step(state, jb)
    np.testing.assert_allclose(float(metrics["loss"]), t_loss, rtol=1e-5)
    _assert_tree_close(metrics["grads"]["user"], t_grads, atol=3e-6,
                       rtol=2e-3, prefix="user grad ")
    # frozen context: zero grads, params untouched
    assert all(
        float(jnp.abs(g).max()) == 0.0
        for g in jax.tree_util.tree_leaves(metrics["grads"]["sequence"])
    )
    _assert_tree_close(state.params["sequence"], params["sequence"], 0, 0,
                       prefix="frozen seq ")

    # -- 20-step trajectory ------------------------------------------------
    topt = torch.optim.AdamW(
        [p for p in tmodel.parameters()], lr=1e-3, betas=(0.9, 0.999),
        eps=1e-8, weight_decay=0.01,
    )
    topt.step()
    t_traj = [t_loss]
    for i in range(1, 20):
        loss, _ = torch_step(i)
        t_traj.append(loss)
        topt.step()

    f_traj = [float(metrics["loss"])]
    for i in range(1, 20):
        jb = {k: jnp.asarray(v)
              for k, v in batches[i % len(batches)].items()}
        state, metrics = step(state, jb)
        f_traj.append(float(metrics["loss"]))

    np.testing.assert_allclose(f_traj, t_traj, rtol=5e-4, atol=1e-6)
    # actually training: same batch (0) recurs every 5 steps
    assert f_traj[15] < f_traj[0]


# ---------------------------------------------------------------------------
# Stage 4: joint Qwen3 + LoRA trainer
# ---------------------------------------------------------------------------

VOCAB, N_SPECIAL = 128, 20


class _StubTokenizer:
    """convert_tokens_to_ids is the only tokenizer surface the reference
    forward touches (train_item_individual_token_joint.py:163-165); special
    ids are laid out [vocab, vocab + 20) in i-major j-minor order — the same
    contract as the HF add_special_tokens path (:112-119)."""

    def __init__(self, history_tokens):
        self._ids = {t: VOCAB + i for i, t in enumerate(history_tokens)}

    def convert_tokens_to_ids(self, tok):
        return self._ids[tok]


def _build_ref_joint(qc_hf, qformer, lora_cfg):
    """Assemble the reference MultiModalQwenEmbedding without its
    hub-downloading __init__ (AutoModel/AutoTokenizer are unavailable
    offline); every attribute the reference forward (:134-181) reads is set
    to the same objects its __init__ would produce."""
    from peft import LoraConfig, TaskType, get_peft_model
    from transformers import Qwen3Model

    torch.manual_seed(12)
    base = Qwen3Model(qc_hf)
    base.resize_token_embeddings(VOCAB + N_SPECIAL)
    peft_cfg = LoraConfig(
        task_type=TaskType.FEATURE_EXTRACTION,
        r=lora_cfg.r, lora_alpha=int(lora_cfg.alpha),
        lora_dropout=lora_cfg.dropout,
        target_modules=list(lora_cfg.target_modules), bias="none",
    )
    base = get_peft_model(base, peft_cfg)

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
        f"<|history_item_{i}_query_{j}|>"
        for i in range(10) for j in range(2)
    ]
    model.tokenizer = _StubTokenizer(model.history_tokens)
    return model


def _joint_batch(rng, b=2, seq=32, n_neg=5):
    ids = rng.randint(1, VOCAB, (b, seq))
    # all 20 special ids present once per row (as the prompt template
    # guarantees, :579-592) at shuffled positions
    for row in range(b):
        pos = rng.choice(seq, N_SPECIAL, replace=False)
        ids[row, pos] = VOCAB + np.arange(N_SPECIAL)
    mask = np.ones((b, seq), np.float32)
    mask[:, -3:] = 0.0  # padding tail
    return {
        "input_ids": ids.astype(np.int32),
        "attention_mask": mask,
        "history_field_embeddings":
            rng.randn(b, 10, F, WIDTH).astype(np.float32),
        "history_attention_mask":
            (rng.rand(b, 10, F) > 0.3).astype(np.float32),
        "positive_item_embeddings": rng.randn(b, HIDDEN).astype(np.float32),
        "negative_item_embeddings":
            rng.randn(b, n_neg, HIDDEN).astype(np.float32),
        "negative_masks": (rng.rand(b, n_neg) > 0.2).astype(np.float32),
    }


def test_joint_trainer_step_and_trajectory_parity():
    from transformers import Qwen3Config as HFQwen3Config

    from unirec.train.joint import (
        make_joint_optimizer,
        make_joint_train_step,
    )

    qc = Qwen3Config(
        vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=FFN,
        num_hidden_layers=LAYERS, num_attention_heads=HEADS,
        num_key_value_heads=2, head_dim=16,
    )
    qc_hf = HFQwen3Config(
        vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=FFN,
        num_hidden_layers=LAYERS, num_attention_heads=HEADS,
        num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-6,
        rope_theta=1000000.0, attention_bias=False, tie_word_embeddings=True,
    )
    icfg = ItemQFormerConfig(
        hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN,
        num_query_tokens=2, field_embedding_dim=WIDTH, num_fields=F,
        dropout=0.0,
    )
    lora = LoRAConfig(r=4, alpha=8.0, dropout=0.0)

    torch.manual_seed(13)
    tqformer = QFormerForItemRepresentation(
        hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN,
        num_query_tokens=2, field_embedding_dim=WIDTH, num_fields=F,
        dropout=0.0,
    )
    tmodel = _build_ref_joint(qc_hf, tqformer, lora)
    tmodel.train()
    criterion = RefInfoNCELoss(temperature=0.07)

    fmodel = MultiModalQwenEmbedding(
        qc, icfg, JointModelConfig(), lora=lora
    )
    params = convert_joint_model(tmodel.state_dict(), qc, icfg)

    rng = np.random.RandomState(13)
    batches = [_joint_batch(rng) for _ in range(4)]

    def torch_step(i):
        """reference: MultiModalTrainer.compute_loss (:482-498)."""
        batch = batches[i % len(batches)]
        user_emb = tmodel(
            input_ids=torch.tensor(batch["input_ids"], dtype=torch.long),
            attention_mask=torch.tensor(batch["attention_mask"]),
            history_field_embeddings=torch.tensor(
                batch["history_field_embeddings"]),
            history_attention_mask=torch.tensor(
                batch["history_attention_mask"]),
        )
        loss = criterion(
            user_emb,
            torch.tensor(batch["positive_item_embeddings"]),
            torch.tensor(batch["negative_item_embeddings"]),
            torch.tensor(batch["negative_masks"]).bool(),
        )
        tmodel.zero_grad()
        loss.backward()
        return float(loss.detach()), _grads_sd(tmodel)

    # reference run hyperparams scaled down: lr 1e-4->1e-3, warmup 20->3,
    # clip 1.0, HF TrainingArguments weight_decay default 0.0 (:755-773)
    opt = OptimizerConfig(
        learning_rate=1e-3, weight_decay=0.0, warmup_steps=3,
        max_grad_norm=1.0,
    )
    tx = make_joint_optimizer(params, opt)
    state = TrainState.create(apply_fn=fmodel.apply, params=params, tx=tx)
    step = jax.jit(make_joint_train_step(fmodel, 0.07, return_grads=True))

    # -- one-step parity ---------------------------------------------------
    t_loss, t_grads_sd = torch_step(0)
    t_grads = convert_joint_model(t_grads_sd, qc, icfg)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    state, metrics = step(state, jb)
    np.testing.assert_allclose(float(metrics["loss"]), t_loss, rtol=2e-5)
    _assert_tree_close(metrics["grads"], t_grads, atol=1e-5, rtol=5e-3,
                       prefix="joint grad ")

    # -- 20-step trajectory with matched AdamW + warmup + clip -------------
    trainable = [p for p in tmodel.parameters() if p.requires_grad]
    topt = torch.optim.AdamW(
        trainable, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0
    )
    sched = torch.optim.lr_scheduler.LambdaLR(
        topt, lambda s: min(1.0, s / 3.0)
    )

    def torch_apply():
        torch.nn.utils.clip_grad_norm_(trainable, 1.0)
        topt.step()
        sched.step()

    torch_apply()
    t_traj = [t_loss]
    for i in range(1, 20):
        loss, _ = torch_step(i)
        t_traj.append(loss)
        torch_apply()

    f_traj = [float(metrics["loss"])]
    for i in range(1, 20):
        jb = {k: jnp.asarray(v) for k, v in batches[i % len(batches)].items()}
        state, metrics = step(state, jb)
        f_traj.append(float(metrics["loss"]))

    np.testing.assert_allclose(f_traj, t_traj, rtol=1e-3, atol=1e-5)
    # actually training: same batch (0) recurs every 4 steps
    assert f_traj[16] < f_traj[0]


def test_joint_export_is_exact_inverse_and_loads_strict():
    """export_joint_model must invert convert_joint_model bit-for-bit on
    the reference MultiModalQwenEmbedding's own PEFT-wrapped state_dict
    (same key set, same values), so JAX-trained joint checkpoints load
    strict into the reference module
    (train_item_individual_token_joint.py:65)."""
    from transformers import Qwen3Config as HFQwen3Config

    from unirec.utils.torch_convert import export_joint_model

    qc = Qwen3Config(
        vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=FFN,
        num_hidden_layers=LAYERS, num_attention_heads=HEADS,
        num_key_value_heads=2, head_dim=16,
    )
    qc_hf = HFQwen3Config(
        vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=FFN,
        num_hidden_layers=LAYERS, num_attention_heads=HEADS,
        num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-6,
        rope_theta=1000000.0, attention_bias=False, tie_word_embeddings=True,
    )
    icfg = ItemQFormerConfig(
        hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN,
        num_query_tokens=2, field_embedding_dim=WIDTH, num_fields=F,
        dropout=0.0,
    )
    lora = LoRAConfig(r=4, alpha=8.0, dropout=0.0)

    torch.manual_seed(21)
    tqformer = QFormerForItemRepresentation(
        hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN,
        num_query_tokens=2, field_embedding_dim=WIDTH, num_fields=F,
        dropout=0.0,
    )
    tmodel = _build_ref_joint(qc_hf, tqformer, lora)

    sd_ref = {k: v.detach().numpy() for k, v in tmodel.state_dict().items()}
    params = convert_joint_model(sd_ref, qc, icfg)
    sd_out = export_joint_model(params, qc, icfg)

    assert sorted(sd_out) == sorted(sd_ref)
    for k in sd_ref:
        np.testing.assert_array_equal(sd_out[k], sd_ref[k], err_msg=k)

    tmodel.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in sd_out.items()},
        strict=True,
    )


def test_save_pretrained_directory_loads_via_peft(tmp_path):
    """save_pretrained_directory writes the reference's persisted artifact
    (tokenizer + PEFT adapter + qformer_model.bin + model_config.json,
    train_item_individual_token_joint.py:183-200) and the pieces load
    through the same machinery the reference uses: PeftModel.from_pretrained
    for the adapter, load_state_dict(strict) for the Q-Former."""
    import json

    from peft import PeftModel, get_peft_model
    from transformers import Qwen3Config as HFQwen3Config, Qwen3Model

    from unirec.utils.torch_convert import save_pretrained_directory

    qc = Qwen3Config(
        vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=FFN,
        num_hidden_layers=LAYERS, num_attention_heads=HEADS,
        num_key_value_heads=2, head_dim=16,
    )
    qc_hf = HFQwen3Config(
        vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=FFN,
        num_hidden_layers=LAYERS, num_attention_heads=HEADS,
        num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-6,
        rope_theta=1000000.0, attention_bias=False, tie_word_embeddings=True,
    )
    icfg = ItemQFormerConfig(
        hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN,
        num_query_tokens=2, field_embedding_dim=WIDTH, num_fields=F,
        dropout=0.0,
    )
    lora = LoRAConfig(r=4, alpha=8.0, dropout=0.0)

    torch.manual_seed(33)
    tqformer = QFormerForItemRepresentation(
        hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN,
        num_query_tokens=2, field_embedding_dim=WIDTH, num_fields=F,
        dropout=0.0,
    )
    tmodel = _build_ref_joint(qc_hf, tqformer, lora)
    sd_ref = {k: v.detach().numpy() for k, v in tmodel.state_dict().items()}
    params = convert_joint_model(sd_ref, qc, icfg)

    out = str(tmp_path / "saved_model")
    save_pretrained_directory(out, params, qc, icfg, lora_config=lora)
    assert json.load(open(f"{out}/model_config.json")) == {
        "hidden_size": HIDDEN, "use_lora": True,
    }

    # Q-Former half: strict load into the reference module (ref :192)
    tqformer.load_state_dict(
        torch.load(f"{out}/qformer_model.bin", map_location="cpu",
                   weights_only=True),
        strict=True,
    )

    # adapter half: the reference reloads by rebuilding the resized base
    # and attaching the saved adapter (standard PEFT flow)
    torch.manual_seed(99)  # DIFFERENT base init: only adapter weights travel
    base2 = Qwen3Model(qc_hf)
    base2.resize_token_embeddings(VOCAB + N_SPECIAL)
    loaded = PeftModel.from_pretrained(base2, out)
    got = {
        k: v for k, v in loaded.state_dict().items()
        if ".lora_A." in k or ".lora_B." in k
    }
    want = {
        k: v for k, v in tmodel.base_model.state_dict().items()
        if ".lora_A." in k or ".lora_B." in k
    }
    assert sorted(got) == sorted(want) and len(got) > 0
    for k in want:
        np.testing.assert_array_equal(
            got[k].numpy(), want[k].numpy(), err_msg=k)
