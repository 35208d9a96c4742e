"""BestMetricTracker save strategies + step-driven joint training."""

import os

import numpy as np
import pytest

from unirec.train.callbacks import BestMetricTracker


def _tracker(tmp_path, strategy, saves):
    return BestMetricTracker(
        str(tmp_path), strategy=strategy, eval_steps=10,
        save_fn=lambda path, st: saves.append((path, st)),
    )


def test_should_eval_cadence(tmp_path):
    t = _tracker(tmp_path, "best_only", [])
    assert not t.should_eval(0)
    assert not t.should_eval(5)
    assert t.should_eval(10)
    t.update(10, 0.5)
    assert not t.should_eval(15)
    assert t.should_eval(20)


def test_best_only_saves_on_improvement(tmp_path):
    saves = []
    t = _tracker(tmp_path, "best_only", saves)
    s1 = t.update(10, 0.3, state="A")
    assert s1["improved"] and saves[-1][1] == "A"
    s2 = t.update(20, 0.2, state="B")
    assert not s2["improved"] and len(saves) == 1
    s3 = t.update(30, 0.4, state="C")
    assert s3["improved"] and saves[-1][1] == "C" and t.best == 0.4


def test_always_saves_every_eval(tmp_path):
    saves = []
    t = _tracker(tmp_path, "always", saves)
    t.update(10, 0.3, state="A")
    t.update(20, 0.1, state="B")
    assert [s[1] for s in saves] == ["A", "B"]
    assert t.best == 0.3


def test_both_saves_latest_and_best(tmp_path):
    saves = []
    t = _tracker(tmp_path, "both", saves)
    t.update(10, 0.3, state="A")
    assert [os.path.basename(p) for p, _ in saves] == ["latest_model",
                                                        "best_model"]
    saves.clear()
    t.update(20, 0.1, state="B")
    assert [os.path.basename(p) for p, _ in saves] == ["latest_model"]


def test_min_mode(tmp_path):
    t = BestMetricTracker(str(tmp_path), strategy="best_only", mode="min",
                          save_fn=lambda *a: None)
    assert t.update(10, 5.0)["improved"]
    assert not t.update(20, 6.0)["improved"]
    assert t.update(30, 4.0)["improved"]


def test_invalid_args():
    with pytest.raises(ValueError):
        BestMetricTracker(None, strategy="sometimes")
    with pytest.raises(ValueError):
        BestMetricTracker(None, mode="sideways")


def test_joint_train_steps_hook(eight_devices):
    from tests.test_joint import QF, QWEN, JC, joint_setup  # reuse fixtures?

    # build a minimal dataset inline instead of reusing the fixture machinery
    import jax.numpy as jnp

    from unirec.configs import (LoRAConfig, MeshConfig, OptimizerConfig,
                                    TrainConfig)
    from unirec.data.cache import FieldEmbeddingCache
    from unirec.data.tokenizer import HashTokenizer
    from unirec.train.joint import JointDataset, JointTrainer

    rng = np.random.RandomState(0)
    n = 16
    ids = [f"i{j}" for j in range(n)]
    cache = FieldEmbeddingCache(
        rng.randn(n, 4, 32).astype(np.float32), np.ones((n, 4), np.float32),
        ["a", "b", "c", "d"], ids,
    )
    emb = {i: rng.randn(QWEN.hidden_size).astype(np.float32).tolist()
           for i in ids}
    data = [
        {"history": [f"i{(s + j) % n}" for j in range(3)],
         "candidate": [f"i{(s + 4 + j) % n}" for j in range(6)],
         "ground_truth": f"i{(s + 5) % n}"}
        for s in range(10)
    ]
    tok = HashTokenizer(QWEN.vocab_size, JC.num_history_items,
                        JC.num_query_tokens_per_item)
    ds = JointDataset(data, emb, tok, {i: {"title": i} for i in ids}, cache,
                      JC, max_negatives=4, item_emb_dim=QWEN.hidden_size)
    trainer = JointTrainer(
        QWEN, QF, JC, lora=LoRAConfig(r=2),
        train_config=TrainConfig(batch_size=8,
                                 optimizer=OptimizerConfig(learning_rate=1e-3),
                                 mesh=MeshConfig(dp=8)),
    )
    state = trainer.init_state()
    seen = []
    state, metrics = trainer.train_steps(
        state, ds, np.random.default_rng(0), num_steps=5,
        step_hook=lambda step, st, m: seen.append(step) or st,
    )
    assert len(seen) == 5
    assert seen == sorted(seen)
    assert np.isfinite(metrics["loss"])
