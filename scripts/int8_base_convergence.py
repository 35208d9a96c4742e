"""Convergence-quality gate for `train joint --int8-base` (QLoRA-style).

`--int8-base` changes training numerics (the frozen base's projections run
W8A8 in the forward with an STE backward — ops/int8_ste.py), so any speed
claim for it needs the same kind of quality evidence QLoRA itself shipped: train the SAME joint model on the
SAME synthetic corpus (scripts/convergence_demo.py) with and without
int8_base from identical init/seed, and compare the final ranking metrics
each run's evaluator reports (MRR / Recall@10 / NDCG@10 over 100-candidate
pools — the reference's eval rule,
/root/reference/training/train_item_individual_token_joint.py:392-419).

Run: python scripts/int8_base_convergence.py   (CPU; flax-only, a few min)
Prints one JSON line: {"exact": {...}, "int8_base": {...}, ...}.
"""

import json
import sys

sys.path.insert(0, ".")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from unirec.configs import (  # noqa: E402
    ItemQFormerConfig,
    JointModelConfig,
    LoRAConfig,
    MeshConfig,
    OptimizerConfig,
    Qwen3Config,
    TrainConfig,
)
from unirec.data.tokenizer import HashTokenizer  # noqa: E402
from unirec.train.joint import JointDataset, JointTrainer  # noqa: E402

# the convergence demo's corpus generator (torch/reference imports happen at
# module import; only make_corpus and the shape constants are used here)
from scripts.convergence_demo import (  # noqa: E402
    FFN,
    HEADS,
    HIDDEN,
    LAYERS,
    VOCAB,
    WIDTH,
    F,
    make_corpus,
)


def run(int8_base: bool, cache, emb_dict, item_dict, users, steps=800,
        batch=8, lr=1e-3, seed=2):
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
    jc = JointModelConfig(max_length=96)
    trainer = JointTrainer(
        qc, icfg, jc, lora=LoRAConfig(r=4, alpha=8.0, dropout=0.0),
        train_config=TrainConfig(
            batch_size=batch,
            optimizer=OptimizerConfig(learning_rate=lr, weight_decay=0.0,
                                      warmup_steps=5, max_grad_norm=1.0),
            mesh=MeshConfig(dp=1), seed=seed,
        ),
        int8_base=int8_base,
    )
    state = trainer.init_state()

    tok = HashTokenizer(VOCAB, 10, 2)
    split = int(0.8 * len(users))
    train_ds = JointDataset(users[:split], emb_dict, tok, item_dict, cache,
                            jc, max_negatives=10, item_emb_dim=HIDDEN)
    test_ds = JointDataset(users[split:], emb_dict, tok, item_dict, cache,
                           jc, max_negatives=99, item_emb_dim=HIDDEN)

    rng = np.random.RandomState(seed)
    for _ in range(steps):
        idx = rng.randint(0, len(train_ds), batch)
        b = train_ds.batch(idx.tolist())
        state, _ = trainer._train_step(
            state, {k: jnp.asarray(v) for k, v in b.items()}
        )
    m = trainer.evaluate(state, test_ds, batch_size=16, max_negatives=99,
                         ks=(10,))
    return {k: round(float(v), 4) for k, v in m.items()
            if k in ("mrr", "recall@10", "ndcg@10")}


def main():
    cache, emb_dict, item_dict, users, _, _ = make_corpus()
    exact = run(False, cache, emb_dict, item_dict, users)
    q = run(True, cache, emb_dict, item_dict, users)
    print(json.dumps({
        "corpus": "convergence_demo default (240 items / 160 users)",
        "steps": 800,
        # held-out eval size: Recall@10 is quantized in 1/n_test steps, so
        # gates on it must be granularity-aware (quality_gates.py)
        "n_test": len(users) - int(0.8 * len(users)),
        "exact": exact,
        "int8_base": q,
    }), flush=True)


if __name__ == "__main__":
    main()
