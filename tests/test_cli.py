"""CLI integration: the full pipeline on tiny fixtures through the real
entry points (python -m unirec ...).

data -> precompute -> item-qformer train -> evaluate -> tokens -> embed.
"""

import json
import pickle
import subprocess
import sys
import os

import numpy as np
import pytest

from unirec.cli.candidate_embeddings import main as embed_main
from unirec.cli.data_pipeline import main as data_main
from unirec.cli.generate_all_item_embeddings import main as tokens_main
from unirec.cli.train_cli import main as train_main

N_ITEMS = 40


@pytest.fixture(scope="module")
def pipeline_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    # raw meta jsonl
    meta = root / "meta.jsonl"
    with open(meta, "w") as f:
        for i in range(N_ITEMS):
            f.write(
                json.dumps(
                    {
                        "parent_asin": f"A{i}",
                        "title": f"Product {i}",
                        "description": [f"desc {i}", "extra"],
                        "price": str(4.0 + i),
                        "details": {"Brand": f"B{i % 5}"},
                        "images": [{"variant": "MAIN", "large": f"http://x/{i}.jpg"}],
                    }
                )
                + "\n"
            )
    # interactions
    inter = root / "x.inter"
    with open(inter, "w") as f:
        f.write("user_id\titem_id\trating\ttimestamp\n")
        for u in range(5):
            for t in range(14):
                f.write(f"u{u}\tA{(u * 7 + t) % N_ITEMS}\t5.0\t{1000 + t}\n")
    return root


def test_data_pipeline_cli(pipeline_dir):
    d = pipeline_dir
    assert data_main(["item-dict", "--input", str(d / "meta.jsonl"),
                      "--output", str(d / "item_dict.json")]) == 0
    assert data_main(["triplet-dict", "--input", str(d / "item_dict.json"),
                      "--output", str(d / "triplet_dict.json")]) == 0
    with open(d / "triplet_dict.json") as f:
        td = json.load(f)
    assert len(td) == N_ITEMS
    assert td["A0"]["description"] == "desc 0 extra"
    assert td["A0"]["brand"] == "B0"
    assert td["A0"]["main_image"] == "http://x/0.jpg"

    assert data_main(["rec-old-user", "--inter", str(d / "x.inter"),
                      "--output-prefix", str(d / "rec"),
                      "--num-candidates", "12"]) == 0
    with open(str(d / "rec_train.json")) as f:
        train = json.load(f)
    assert len(train) == 5
    assert all(s["ground_truth"] in s["candidate"] for s in train)

    assert data_main(["rec-new-user", "--inter", str(d / "x.inter"),
                      "--output-prefix", str(d / "new"),
                      "--num-samples", "4", "--hist-len", "10",
                      "--num-candidates", "12"]) == 0
    assert os.path.exists(str(d / "new_train_LRanker.json"))


def test_train_and_tokens_cli(pipeline_dir):
    d = pipeline_dir
    if not os.path.exists(d / "triplet_dict.json"):
        test_data_pipeline_cli(pipeline_dir)

    cache_dir = str(d / "cache")
    assert train_main(["precompute", "--data", str(d / "triplet_dict.json"),
                       "--cache-dir", cache_dir,
                       "--batch-size", "16"]) == 0
    assert os.path.exists(os.path.join(cache_dir, "embeddings.npy"))

    ckpt = str(d / "iq_ckpt")
    assert train_main([
        "item-qformer",
        "--data", str(d / "triplet_dict.json"),
        "--sequences", str(d / "rec_train.json"),
        "--cache-dir", cache_dir,
        "--num-query-tokens", "4",
        "--hidden-size", "32", "--num-layers", "2", "--num-heads", "2",
        "--intermediate-size", "64",
        "--batch-size", "16", "--num-epochs", "2", "--eval-every", "2",
        "--checkpoint-dir", ckpt,
    ]) == 0
    assert os.path.exists(os.path.join(ckpt, "meta.json"))

    assert train_main(["evaluate", "--checkpoint", ckpt,
                       "--cache-dir", cache_dir]) == 0

    out_pkl = str(d / "tokens.pkl")
    assert tokens_main(["--checkpoint", ckpt, "--cache-dir", cache_dir,
                        "--output", out_pkl, "--batch-size", "16",
                        "--profile",
                        "--progress-file", str(d / "progress.json")]) == 0
    with open(out_pkl, "rb") as f:
        tokens = pickle.load(f)
    assert len(tokens) == N_ITEMS
    assert tokens["A0"].shape == (4, 32)
    with open(d / "progress.json") as f:
        prog = json.load(f)
    assert prog["done"] == N_ITEMS

    # compare mode
    assert tokens_main(["--checkpoint", ckpt, "--cache-dir", cache_dir,
                        "--compare", "--output", str(d / "cmp.pkl")]) == 0


def test_embed_cli(pipeline_dir):
    d = pipeline_dir
    if not os.path.exists(d / "item_dict.json"):
        test_data_pipeline_cli(pipeline_dir)
    out = str(d / "qwen_emb.json")
    assert embed_main(["qwen3", "--item-dict", str(d / "item_dict.json"),
                       "--samples", str(d / "rec_train.json"),
                       "--output", out]) == 0
    with open(out) as f:
        embs = json.load(f)
    assert len(embs) > 0
    assert len(next(iter(embs.values()))) == 1024

    out2 = str(d / "clip_emb.json")
    assert embed_main(["clip", "--item-dict", str(d / "item_dict.json"),
                       "--output", out2, "--max-items", "5"]) == 0
    with open(out2) as f:
        embs2 = json.load(f)
    assert len(embs2) == 5  # hash image backend never fails


def test_mwne_cli(tmp_path):
    assert train_main(["mwne", "--embedding-dim", "64",
                       "--num-frequencies", "8", "--num-steps", "30",
                       "--checkpoint-dir", str(tmp_path / "mwne")]) == 0
    assert os.path.exists(str(tmp_path / "mwne" / "meta.json"))

    # export-pth --stage mwne writes the reference schema
    # (models/mwne.py:784-806) and the result reloads through the import
    # converter into a working backend
    torch = pytest.importorskip("torch")
    pth = str(tmp_path / "mathematical_encoder_64d_normalized.pth")
    assert train_main(["export-pth", "--stage", "mwne",
                       "--checkpoint", str(tmp_path / "mwne"),
                       "--output", pth]) == 0
    ck = torch.load(pth, map_location="cpu", weights_only=False)
    assert set(ck) >= {"encoder_state_dict", "encoder_config",
                       "normalization_config", "final_metrics"}
    assert ck["encoder_config"]["embedding_dim"] == 64
    assert "fourier_weight" in ck["encoder_state_dict"]

    from unirec.encoders.backends import MWNENumberBackend

    backend = MWNENumberBackend.from_reference_checkpoint(pth)
    out = backend.encode([1.5, -2.0, 100.0])
    assert out.shape == (3, 64)
    assert np.isfinite(out).all()


def test_module_dispatcher_help():
    r = subprocess.run(
        [sys.executable, "-m", "unirec", "--help"],
        capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 0
    assert "tokens" in r.stdout


def test_check_devices_flag():
    assert tokens_main(["--check-devices"]) == 0


def test_tokens_cli_per_item_fallback(pipeline_dir, monkeypatch):
    """A failing batch must degrade to per-item processing, not abort
    (reference semantics: generate_all_item_embeddings.py:295-309)."""
    d = pipeline_dir
    if not os.path.exists(d / "cache"):
        test_train_and_tokens_cli(pipeline_dir)

    from unirec.inference import qformer_inference as qi

    orig = qi.QFormerInference.query_tokens_from_embeddings
    calls = {"n": 0}

    def flaky(self, emb, mask):
        calls["n"] += 1
        if calls["n"] == 1 and emb.shape[0] > 1:
            raise RuntimeError("injected batch failure")
        return orig(self, emb, mask)

    monkeypatch.setattr(qi.QFormerInference, "query_tokens_from_embeddings",
                        flaky)
    out = str(d / "tokens_fallback.pkl")
    assert tokens_main(["--checkpoint", str(d / "iq_ckpt"),
                        "--cache-dir", str(d / "cache"),
                        "--output", out, "--batch-size", "64"]) == 0
    with open(out, "rb") as f:
        tokens = pickle.load(f)
    assert len(tokens) == N_ITEMS  # every item still produced
    assert calls["n"] > 1  # fallback actually ran per-item


def test_tokens_cli_hbm_downshift(pipeline_dir, monkeypatch):
    """An OOM-shaped failure must halve the batch size (sticky) and retry —
    the analog of the reference's GPU memory probe
    (reference: generate_all_item_embeddings.py:191-211)."""
    d = pipeline_dir
    if not os.path.exists(d / "cache"):
        test_train_and_tokens_cli(pipeline_dir)

    from unirec.inference import qformer_inference as qi

    orig = qi.QFormerInference.query_tokens_from_embeddings
    seen = []

    def oomy(self, emb, mask):
        seen.append(emb.shape[0])
        if emb.shape[0] > 16:
            raise RuntimeError(
                "RESOURCE_EXHAUSTED: Ran out of memory in memory space hbm"
            )
        return orig(self, emb, mask)

    monkeypatch.setattr(qi.QFormerInference, "query_tokens_from_embeddings",
                        oomy)
    out = str(d / "tokens_downshift.pkl")
    assert tokens_main(["--checkpoint", str(d / "iq_ckpt"),
                        "--cache-dir", str(d / "cache"),
                        "--output", out, "--batch-size", "64",
                        "--min-batch-size", "4"]) == 0
    with open(out, "rb") as f:
        tokens = pickle.load(f)
    assert len(tokens) == N_ITEMS
    # first sweep is min(64, N_ITEMS)=40 rows -> OOM -> 32 -> OOM -> 16 ok,
    # and the downshift is sticky for the rest of the sweep
    assert seen[:3] == [40, 32, 16]
    assert all(s <= 16 for s in seen[2:])


def test_full_pipeline_raw_jsonl_to_recommendation(pipeline_dir):
    """One chain through every stage on All_Beauty-shaped fixtures
   : raw meta/review JSONL + interactions ->
    data CLIs -> precompute -> item-qformer train -> tokens ->
    candidate embeddings -> user-qformer train -> joint train (tiny) ->
    serve-CLI Recommender -> a ranked recommendation."""
    d = pipeline_dir
    if not os.path.exists(d / "tokens.pkl"):
        test_train_and_tokens_cli(pipeline_dir)
    if not os.path.exists(d / "qwen_emb.json"):
        test_embed_cli(pipeline_dir)

    # reviews jsonl -> review dict (C14)
    reviews = d / "reviews.jsonl"
    with open(reviews, "w") as f:
        for u in range(5):
            for t in range(3):
                f.write(json.dumps({
                    "user_id": f"u{u}", "parent_asin": f"A{(u * 7 + t) % N_ITEMS}",
                    "text": f"review {u}-{t}", "unixReviewTime": 1000 + t,
                }) + "\n")
    assert data_main(["review-dict", "--input", str(reviews),
                      "--output", str(d / "review_dict.json")]) == 0

    # user-stage training on the item-qformer checkpoint (C11)
    assert train_main([
        "user-qformer",
        "--item-qformer-checkpoint", str(d / "iq_ckpt"),
        "--history", str(d / "rec_train.json"),
        "--reviews", str(d / "review_dict.json"),
        "--cache-dir", str(d / "cache"),
        "--max-seq-len", "8", "--batch-size", "4", "--num-epochs", "1",
        "--checkpoint-dir", str(d / "uq_ckpt"),
    ]) == 0

    # candidate catalog in the tiny LLM's hidden space (32 = iq_ckpt hidden;
    # query-token injection shares the LLM embedding space, models/joint.py)
    assert embed_main(["qwen3", "--item-dict", str(d / "item_dict.json"),
                       "--output", str(d / "qwen_emb32.json"),
                       "--embedding-dim", "32"]) == 0

    # joint stage (tiny Qwen3 smoke config, C12); eval-every-steps 2 forces
    # a best-MRR save so the --resume leg below has a checkpoint
    joint_args = [
        "joint", "--tiny",
        "--train-data", str(d / "rec_train.json"),
        "--val-data", str(d / "rec_test.json"),
        "--item-emb", str(d / "qwen_emb32.json"),
        "--item-dict", str(d / "triplet_dict.json"),
        "--qformer-checkpoint", str(d / "iq_ckpt"),
        "--cache-dir", str(d / "cache"),
        # 3 epochs x 1 step: the step counter must pass eval-every-steps 2
        # for the tracker to fire a best-MRR save (should_eval is >=)
        "--max-length", "64", "--batch-size", "4", "--num-epochs", "3",
        "--eval-every-steps", "2",
        "--checkpoint-dir", str(d / "joint_ckpt"),
    ]
    assert train_main(joint_args) == 0
    # default --save-strategy both nests latest_model/best_model
    assert os.path.exists(str(d / "joint_ckpt" / "latest_model" / "state"))
    assert os.path.exists(str(d / "joint_ckpt" / "best_model" / "state"))
    # resume restores params + opt state + step and keeps training
    assert train_main(joint_args + ["--resume"]) == 0

    # serving: assemble the recommender exactly as `python -m unirec
    # serve` would, and produce a recommendation from a raw history
    from unirec.cli.serve_cli import build_recommender, parse_args

    rec = build_recommender(parse_args([
        "--qformer-checkpoint", str(d / "iq_ckpt"),
        "--cache-dir", str(d / "cache"),
        "--item-dict", str(d / "triplet_dict.json"),
        "--catalog", str(d / "qwen_emb32.json"),
        "--tiny", "--max-length", "64", "--batch-size", "4",
    ]))
    recs = rec.recommend([["A0", "A7", "A14"]], k=5)[0]
    assert len(recs) == 5
    assert all(r.item_id.startswith("A") for r in recs)
    assert all(isinstance(r.score, float) for r in recs)
    # history exclusion: recommended items are outside the user's history
    assert not {r.item_id for r in recs} & {"A0", "A7", "A14"}

    # --dp 2: the same CLI assembly sharded over a dp mesh must rank
    # identically (serving/recommender.py shard_map path)
    import jax

    if len(jax.devices()) >= 2:
        rec_dp = build_recommender(parse_args([
            "--qformer-checkpoint", str(d / "iq_ckpt"),
            "--cache-dir", str(d / "cache"),
            "--item-dict", str(d / "triplet_dict.json"),
            "--catalog", str(d / "qwen_emb32.json"),
            "--tiny", "--max-length", "64", "--batch-size", "4",
            "--dp", "2",
        ]))
        recs_dp = rec_dp.recommend([["A0", "A7", "A14"]], k=5)[0]
        assert [r.item_id for r in recs_dp] == [r.item_id for r in recs]


def test_tokens_cli_dp_sharded_sweep(pipeline_dir):
    """--dp 8 shards the token-generation sweep over the device mesh; output
    must match an explicit --dp 1 single-device sweep (the multi-device
    path through the real CLI entry point — the default tokens.pkl is NOT a
    valid baseline because --dp defaults to all devices)."""
    d = pipeline_dir
    if not os.path.exists(d / "cache"):
        test_train_and_tokens_cli(pipeline_dir)
    out1 = str(d / "tokens_dp1.pkl")
    assert tokens_main(["--checkpoint", str(d / "iq_ckpt"),
                        "--cache-dir", str(d / "cache"),
                        "--output", out1, "--batch-size", "16",
                        "--dp", "1"]) == 0
    out8 = str(d / "tokens_dp8.pkl")
    assert tokens_main(["--checkpoint", str(d / "iq_ckpt"),
                        "--cache-dir", str(d / "cache"),
                        "--output", out8, "--batch-size", "16",
                        "--dp", "8"]) == 0
    with open(out8, "rb") as f:
        dp_tokens = pickle.load(f)
    with open(out1, "rb") as f:
        single = pickle.load(f)
    assert set(dp_tokens) == set(single) and len(single) == N_ITEMS
    for iid in list(single)[:8]:
        np.testing.assert_allclose(dp_tokens[iid], single[iid], atol=1e-5)


def test_export_pth_cli(pipeline_dir):
    """`train export-pth` writes a reference-schema .pth from an orbax
    checkpoint; it loads back through the same inference entry point with
    identical outputs (the strict torch-module load is covered by
    tests/test_reference_checkpoint.py)."""
    d = pipeline_dir
    ckpt = str(d / "iq_ckpt")
    if not os.path.exists(os.path.join(ckpt, "meta.json")):
        test_train_and_tokens_cli(pipeline_dir)
    torch = pytest.importorskip("torch")

    pth = str(d / "exported.pth")
    assert train_main(["export-pth", "--checkpoint", ckpt,
                       "--output", pth]) == 0
    ck = torch.load(pth, map_location="cpu", weights_only=False)
    assert set(ck) == {"model_state_dict", "config", "field_names"}
    assert ck["config"].query_length == 4

    from unirec.inference.qformer_inference import QFormerInference

    a = QFormerInference(ckpt, batch_size=8)
    b = QFormerInference(pth, batch_size=8)
    assert a.field_names == b.field_names
    rng = np.random.RandomState(0)
    f = len(a.field_names)
    fields = rng.randn(3, f, a.config.field_embedding_dim).astype(np.float32)
    mask = np.ones((3, f), np.float32)
    np.testing.assert_allclose(
        a.query_tokens_from_embeddings(fields, mask),
        b.query_tokens_from_embeddings(fields, mask),
        atol=1e-5,
    )


def test_export_pth_user_cli(tmp_path):
    """`train export-pth --stage user` converts an orbax user-qformer
    checkpoint to the reference's best_user_qformer_model.pth schema
    (training/user_qformer_training.py:218-228)."""
    torch = pytest.importorskip("torch")

    from unirec.configs import TrainConfig, UserQFormerConfig
    from unirec.train.user_qformer import UserQFormerTrainer
    from unirec.utils.checkpoint import save_checkpoint

    cfg = UserQFormerConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, num_query_tokens=4, input_embedding_dim=24,
        num_item_tokens_to_predict=2, dropout=0.0,
    )
    t = UserQFormerTrainer(cfg, TrainConfig(batch_size=4))
    state = t.init_state(seed=0)
    ckpt = str(tmp_path / "uq")
    save_checkpoint(ckpt, state, config=cfg, extra={"epoch": 1, "loss": 2.0})

    pth = str(tmp_path / "u.pth")
    assert train_main(["export-pth", "--stage", "user",
                       "--checkpoint", ckpt, "--output", pth]) == 0
    ck = torch.load(pth, map_location="cpu", weights_only=False)
    assert set(ck) == {"model_state_dict", "config", "epoch", "loss"}
    assert ck["epoch"] == 1
    assert ck["config"].cross_attention_freq == 1
    assert "prediction_head.3.weight" in ck["model_state_dict"]


def test_item_qformer_resume_cli(pipeline_dir, capsys):
    """`--resume` restores params + optimizer state + step from
    --checkpoint-dir and continues training (the step counter advances
    past the restored value)."""
    d = pipeline_dir
    ckpt = str(d / "iq_ckpt")
    if not os.path.exists(os.path.join(ckpt, "meta.json")):
        test_train_and_tokens_cli(pipeline_dir)

    assert train_main([
        "item-qformer",
        "--data", str(d / "triplet_dict.json"),
        "--sequences", str(d / "rec_train.json"),
        "--cache-dir", str(d / "cache"),
        "--num-query-tokens", "4",
        "--hidden-size", "32", "--num-layers", "2", "--num-heads", "2",
        "--intermediate-size", "64",
        "--batch-size", "16", "--num-epochs", "1", "--eval-every", "1",
        "--checkpoint-dir", ckpt, "--resume",
    ]) == 0
    out = capsys.readouterr().out
    assert "resumed from" in out
    # the restored step is > 0 (two prior epochs trained on this fixture)
    import re

    m = re.search(r"resumed from .* at step (\d+)", out)
    assert m and int(m.group(1)) > 0

    # structured metrics stream to JSONL under --checkpoint-dir
    # (utils/metrics_logger.py — the reference's dead USE_WANDB made real)
    mlog = os.path.join(ckpt, "metrics.jsonl")
    assert os.path.exists(mlog)
    with open(mlog) as f:
        records = [json.loads(line) for line in f]
    assert records and all("ts" in r and "step" in r for r in records)


def test_joint_pp_cli(pipeline_dir):
    """`train joint --pp 2` stages the tiny backbone over a dp x pp mesh
    end-to-end through the CLI (parallel/pipeline.py), producing finite
    eval metrics and a best-MRR checkpoint in the regular (merged) param
    layout."""
    d = pipeline_dir
    if not os.path.exists(d / "qwen_emb32.json"):
        test_full_pipeline_raw_jsonl_to_recommendation(pipeline_dir)

    ckpt = str(d / "joint_pp_ckpt")
    assert train_main([
        "joint", "--tiny", "--pp", "2",
        "--train-data", str(d / "rec_train.json"),
        "--val-data", str(d / "rec_test.json"),
        "--item-emb", str(d / "qwen_emb32.json"),
        "--item-dict", str(d / "triplet_dict.json"),
        "--qformer-checkpoint", str(d / "iq_ckpt"),
        "--cache-dir", str(d / "cache"),
        "--max-length", "64", "--batch-size", "4", "--num-epochs", "3",
        "--eval-every-steps", "2", "--save-strategy", "best_only",
        "--checkpoint-dir", ckpt,
    ]) == 0
    assert os.path.exists(os.path.join(ckpt, "state"))
    # the saved tree is the REGULAR joint layout (merged back from pp):
    # it reloads through the ordinary checkpoint loader
    from unirec.utils.checkpoint import load_checkpoint

    tree, meta = load_checkpoint(ckpt)
    assert "base_model" in tree["params"] and "qformer" in tree["params"]
    assert any(k.startswith("layers_") for k in tree["params"]["base_model"])
    assert np.isfinite(float(meta["mrr"]))
    assert int(tree["step"]) > 0  # global step, not start_step-doubled

    # pp checkpoints carry a sentinel opt_state the dp TrainState template
    # cannot fill — --resume must fall back to params + step and continue
    assert train_main([
        "joint", "--tiny", "--pp", "2", "--resume",
        "--train-data", str(d / "rec_train.json"),
        "--val-data", str(d / "rec_test.json"),
        "--item-emb", str(d / "qwen_emb32.json"),
        "--item-dict", str(d / "triplet_dict.json"),
        "--qformer-checkpoint", str(d / "iq_ckpt"),
        "--cache-dir", str(d / "cache"),
        "--max-length", "64", "--batch-size", "4", "--num-epochs", "1",
        "--eval-every-steps", "100", "--save-strategy", "best_only",
        "--checkpoint-dir", ckpt,
    ]) == 0


def test_users_cli(pipeline_dir):
    """`users`: offline bulk user-embedding sweep — L2-normalized
    joint-space vectors for every history, identical across input schemas
    (LRanker list vs dict) and across a dp-sharded mesh."""
    d = pipeline_dir
    if not os.path.exists(d / "qwen_emb32.json"):
        test_full_pipeline_raw_jsonl_to_recommendation(pipeline_dir)

    from unirec.cli.user_embeddings import main as users_main

    base = [
        "--qformer-checkpoint", str(d / "iq_ckpt"),
        "--cache-dir", str(d / "cache"),
        "--item-dict", str(d / "triplet_dict.json"),
        "--catalog", str(d / "qwen_emb32.json"),
        "--tiny", "--max-length", "64", "--batch-size", "4",
    ]
    out = str(d / "user_emb.npy")
    assert users_main(base + ["--histories", str(d / "rec_train.json"),
                              "--output", out]) == 0
    emb = np.load(out)
    with open(out + ".ids.json") as f:
        ids = json.load(f)
    assert emb.shape[0] == len(ids) == 5
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-3)

    # dict input + json output: same users -> same vectors
    with open(d / "rec_train.json") as f:
        samples = json.load(f)
    hist_dict = {s["user_id"]: s["history"] for s in samples}
    jout = str(d / "user_emb.json")
    with open(d / "hist_dict.json", "w") as f:
        json.dump(hist_dict, f)
    assert users_main(base + ["--histories", str(d / "hist_dict.json"),
                              "--output", jout]) == 0
    with open(jout) as f:
        jm = json.load(f)
    for i, u in enumerate(ids):
        uid = samples[i]["user_id"]
        np.testing.assert_allclose(np.asarray(jm[uid]), emb[i], atol=1e-5)

    # dp-sharded sweep matches single-device
    import jax

    if len(jax.devices()) >= 2:
        out_dp = str(d / "user_emb_dp.npy")
        assert users_main(base + ["--histories", str(d / "rec_train.json"),
                                  "--output", out_dp, "--dp", "2"]) == 0
        np.testing.assert_allclose(np.load(out_dp), emb, atol=1e-5)


def test_export_pretrained_cli(pipeline_dir):
    """`train export-pretrained` writes the reference save_pretrained
    directory (train_item_individual_token_joint.py:183-200) from a joint
    orbax checkpoint, rebuilding model shapes from the config dicts the
    joint save now records in meta; the adapter loads through
    PeftModel.from_pretrained on a matching resized base."""
    torch = pytest.importorskip("torch")
    peft = pytest.importorskip("peft")

    d = pipeline_dir
    if not os.path.exists(str(d / "joint_ckpt" / "latest_model" / "state")):
        test_full_pipeline_raw_jsonl_to_recommendation(pipeline_dir)

    out = str(d / "saved_model")
    assert train_main(["export-pretrained",
                       "--checkpoint", str(d / "joint_ckpt"),
                       "--output", out]) == 0
    for fn in ("adapter_config.json", "adapter_model.bin",
               "qformer_model.bin", "model_config.json"):
        assert os.path.exists(os.path.join(out, fn)), fn
    with open(os.path.join(out, "model_config.json")) as f:
        mc = json.load(f)
    assert mc["use_lora"] is True and mc["hidden_size"] > 0

    from transformers import Qwen3Config as HFQwen3Config, Qwen3Model

    from unirec.utils.checkpoint import read_meta

    qc = read_meta(str(d / "joint_ckpt" / "latest_model"))["qwen_config"]
    base = Qwen3Model(HFQwen3Config(
        vocab_size=qc["vocab_size"], hidden_size=qc["hidden_size"],
        intermediate_size=qc["intermediate_size"],
        num_hidden_layers=qc["num_hidden_layers"],
        num_attention_heads=qc["num_attention_heads"],
        num_key_value_heads=qc["num_key_value_heads"],
        head_dim=qc["head_dim"], attention_bias=False,
    ))
    base.resize_token_embeddings(qc["vocab_size"] + 20)
    loaded = peft.PeftModel.from_pretrained(base, out)
    lora_keys = [k for k in loaded.state_dict() if ".lora_A." in k]
    assert lora_keys  # adapter weights actually attached
