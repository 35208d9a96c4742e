"""CachedPromptEncoder: fragment-cached serving tokenization must be exact."""

import numpy as np

from unirec.data.tokenizer import HashTokenizer
from unirec.models.joint import construct_input_text
from unirec.serving.prompt_cache import CachedPromptEncoder

ITEMS = {
    "a1": {"title": "Hydrating Face Cream"},
    "a2": {"title": "x" * 200},  # exercises the 80-char truncation
    "a3": {"title": "Mascara, waterproof (black) <brackets>"},
    "a4": {},  # no title -> "Item a4" fallback
}


def _slow(tok, history, n_hist, n_q, max_length):
    # production (Recommender._build_batch) truncates to the LAST n_hist
    # items before building the prompt text
    history = [str(h) for h in history][-n_hist:]
    text = construct_input_text(history, ITEMS, n_hist, n_q)
    return tok.encode(text, max_length)


def test_exact_vs_slow_path():
    n_hist, n_q, max_length = 4, 2, 64
    tok = HashTokenizer(1000, n_hist, n_q)
    enc = CachedPromptEncoder(tok, ITEMS, n_hist, n_q)
    assert enc.enabled, "self-check must pass for the hash tokenizer"
    cases = [
        [],
        ["a1"],
        ["a1", "a2"],
        ["a1", "a2", "a3", "a4"],
        ["a2", "a2", "a2", "a2"],          # repeated items
        ["zz-unknown"],                     # absent from the item dict
        ["a1", "a2", "a3", "a4", "a1", "a3"],  # longer than n_hist
    ]
    for history in cases:
        want_ids, want_mask = _slow(tok, history, n_hist, n_q, max_length)
        # the slow path truncates the history the same way _build_batch does
        got_ids, got_mask = enc.encode(history[-n_hist:], max_length)
        np.testing.assert_array_equal(got_ids, want_ids, err_msg=str(history))
        np.testing.assert_array_equal(got_mask, want_mask)


def test_truncation_at_max_length():
    n_hist, n_q = 4, 2
    tok = HashTokenizer(1000, n_hist, n_q)
    enc = CachedPromptEncoder(tok, ITEMS, n_hist, n_q)
    history = ["a1", "a2", "a3", "a4"]
    want_ids, want_mask = _slow(tok, history, n_hist, n_q, 12)
    got_ids, got_mask = enc.encode(history, 12)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert got_mask.sum() == 12


def test_fragment_cache_hit(monkeypatch):
    n_hist, n_q = 2, 2
    tok = HashTokenizer(1000, n_hist, n_q)
    enc = CachedPromptEncoder(tok, ITEMS, n_hist, n_q)
    enc.encode(["a1", "a3"], 32)
    calls = []
    monkeypatch.setattr(
        tok, "encode_plain",
        lambda text: calls.append(text) or [1],
    )
    enc.encode(["a1", "a3"], 32)  # all fragments cached
    assert calls == []


def test_self_check_disables_broken_fast_path():
    n_hist, n_q = 2, 2

    class BrokenTokenizer(HashTokenizer):
        def encode_plain(self, text):  # drops whitespace -> fragments differ
            return super().encode_plain(text.replace(" ", ""))

    tok = BrokenTokenizer(1000, n_hist, n_q)
    enc = CachedPromptEncoder(tok, ITEMS, n_hist, n_q)
    assert not enc.enabled
    # and it still produces the slow path's exact output
    want_ids, _ = _slow(tok, ["a1"], n_hist, n_q, 32)
    got_ids, _ = enc.encode(["a1"], 32)
    np.testing.assert_array_equal(got_ids, want_ids)


def test_prewarm_batch(monkeypatch):
    n_hist, n_q = 3, 2
    tok = HashTokenizer(1000, n_hist, n_q)
    enc = CachedPromptEncoder(tok, ITEMS, n_hist, n_q)
    n = enc.prewarm()
    # the init self-check already cached a few fragments; prewarm fills the rest
    assert 0 < n <= n_hist * len(ITEMS)
    assert len(enc._frag_cache) == n_hist * len(ITEMS)
    assert enc.prewarm() == 0  # idempotent
    # no tokenizer calls after prewarm, and output still exact
    want_ids, _ = _slow(tok, ["a1", "a3", "a4"], n_hist, n_q, 48)
    calls = []
    monkeypatch.setattr(tok, "encode_plain",
                        lambda text: calls.append(text) or [1])
    got_ids, _ = enc.encode(["a1", "a3", "a4"], 48)
    assert calls == []
    np.testing.assert_array_equal(got_ids, want_ids)


def test_prewarm_disabled_noop():
    class Broken(HashTokenizer):
        def encode_plain(self, text):
            return super().encode_plain(text.replace(" ", ""))

    tok = Broken(1000, 2, 2)
    enc = CachedPromptEncoder(tok, ITEMS, 2, 2)
    assert not enc.enabled
    assert enc.prewarm() == 0


def test_overlength_history_same_on_fast_and_fallback_paths():
    """Both paths must keep the LAST n_hist items (the serving contract) —
    the fallback used to keep the first (code-review r3 finding)."""
    n_hist, n_q = 2, 2
    history = ["a1", "a2", "a3", "a4"]  # longer than n_hist

    tok = HashTokenizer(1000, n_hist, n_q)
    fast = CachedPromptEncoder(tok, ITEMS, n_hist, n_q)
    assert fast.enabled

    class Broken(HashTokenizer):
        def encode_plain(self, text):
            return super().encode_plain(text.replace(" ", ""))

    slow = CachedPromptEncoder(Broken(1000, n_hist, n_q), ITEMS, n_hist, n_q)
    assert not slow.enabled

    ids_fast, _ = fast.encode(history, 32)
    ids_slow, _ = slow.encode(history, 32)
    # both must equal the canonical last-n_hist encoding by their own tok
    want_fast, _ = _slow(tok, history, n_hist, n_q, 32)
    np.testing.assert_array_equal(ids_fast, want_fast)
    # the slow path's own tokenizer differs, but it must ALSO use the last
    # n_hist items: encoding the pre-trimmed history must be identical
    ids_slow_trim, _ = slow.encode(history[-n_hist:], 32)
    np.testing.assert_array_equal(ids_slow, ids_slow_trim)
