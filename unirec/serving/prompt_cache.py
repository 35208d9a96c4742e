"""Cached prompt-token assembly for serving.

Serving re-tokenizes the same item titles request after request: the joint
prompt (models/joint.construct_input_text, reference:
train_item_individual_token_joint.py:579-592) is a fixed template whose only
variable parts are per-(slot, item) title fragments.  The reserved history
special tokens are hard segmentation boundaries for every tokenizer (HF
matches added special tokens before BPE; the hash tokenizer splits on
whitespace), so the ids of each text fragment between special tokens are
position-independent and cacheable.

``CachedPromptEncoder`` assembles full fixed-length (ids, mask) rows from:

* a per-(slot, item_id) LRU-less dict cache of title-fragment ids,
* precomputed constant fragments (prompt head, ", " separators, inter-token
  gaps, sequence affixes),
* the tokenizer's special-token id table (no tokenizer call needed).

On construction it self-verifies against the tokenizer's full-text path on a
representative prompt and falls back to slow encoding on any mismatch, so the
fast path can never change serving numerics.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from unirec.data.tokenizer import BaseTokenizer
from unirec.models.joint import construct_input_text

_HEAD = "I have bought these items in the past: "


def _truncate_title(title: str) -> str:
    return title[:77] + "..." if len(title) > 80 else title


class CachedPromptEncoder:
    """Fragment-cached drop-in for ``tokenizer.encode(construct_input_text(...))``."""

    def __init__(
        self,
        tokenizer: BaseTokenizer,
        item_dict: Dict[str, dict],
        num_history_items: int = 10,
        num_query_tokens_per_item: int = 2,
        verify: bool = True,
    ):
        self.tok = tokenizer
        self.item_dict = item_dict
        self.n_hist = num_history_items
        self.n_q = num_query_tokens_per_item
        # special ids laid out [slot][j]
        self.special_ids = [
            [
                tokenizer.special_to_id[
                    f"<|history_item_{i}_query_{j}|>"
                ]
                for j in range(self.n_q)
            ]
            for i in range(self.n_hist)
        ]
        self.prefix, self.suffix = tokenizer.affix_ids()
        self.head_absent = tokenizer.encode_plain(_HEAD)
        self.mid_absent = tokenizer.encode_plain(", ")
        self.gap = tokenizer.encode_plain(" ") if self.n_q > 1 else []
        self._frag_cache: Dict[Tuple[int, str], List[int]] = {}
        self.enabled = True
        if verify:
            self.enabled = self._self_check()

    # -- fragments -----------------------------------------------------------

    def _fragment(self, slot: int, item_id: str) -> List[int]:
        key = (slot, item_id)
        ids = self._frag_cache.get(key)
        if ids is None:
            title = _truncate_title(
                self.item_dict.get(item_id, {}).get(
                    "title", f"Item {item_id}"
                )
            )
            text = (
                f"{_HEAD}1. {title} "
                if slot == 0
                else f", {slot + 1}. {title} "
            )
            ids = self.tok.encode_plain(text)
            self._frag_cache[key] = ids
        return ids

    def _assemble(self, history: Sequence[str]) -> List[int]:
        history = [str(h) for h in history][-self.n_hist :]
        ids: List[int] = list(self.prefix)
        for i in range(self.n_hist):
            if i < len(history):
                ids += self._fragment(i, history[i])
            elif i == 0:
                ids += self.head_absent
            else:
                ids += self.mid_absent
            specials = self.special_ids[i]
            ids.append(specials[0])
            for j in range(1, self.n_q):
                ids += self.gap
                ids.append(specials[j])
        ids += self.suffix
        return ids

    def prewarm(self, item_ids=None, slots=None) -> int:
        """Batch-tokenize fragments ahead of traffic (cold-start removal).

        ``item_ids`` defaults to the whole item dict; ``slots`` to every
        history slot.  Uses the tokenizer's native batch path (HF tokenizes
        batches in native code).  Returns the number of fragments cached.
        Memory: ~a few dozen ints per (slot, item) — about 100 MB for a
        112k-item catalog across 10 slots; pass ``slots=range(k)`` to cap.
        """
        if not self.enabled:
            return 0
        ids = list(item_ids) if item_ids is not None else list(self.item_dict)
        slot_list = list(slots) if slots is not None else range(self.n_hist)
        keys, texts = [], []
        for slot in slot_list:
            for iid in ids:
                iid = str(iid)
                if (slot, iid) in self._frag_cache:
                    continue
                title = _truncate_title(
                    self.item_dict.get(iid, {}).get("title", f"Item {iid}")
                )
                keys.append((slot, iid))
                texts.append(
                    f"{_HEAD}1. {title} " if slot == 0
                    else f", {slot + 1}. {title} "
                )
        if texts:
            for key, ids_ in zip(keys, self.tok.encode_plain_batch(texts)):
                self._frag_cache[key] = list(ids_)
        return len(texts)

    # -- public API ----------------------------------------------------------

    def encode(
        self, history: Sequence[str], max_length: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, mask) for one user history, fixed length ``max_length``.

        Histories longer than ``num_history_items`` keep the LAST items (the
        serving contract, matching Recommender._build_batch) on BOTH the
        fast and the fallback path.
        """
        ids, length = self.encode_ids(history, max_length)
        mask = np.zeros(max_length, np.float32)
        mask[:length] = 1.0
        return ids, mask

    def encode_ids(
        self, history: Sequence[str], max_length: int
    ) -> Tuple[np.ndarray, int]:
        """(ids row, valid length) — the mask is always a PREFIX mask
        (right padding on both the fast and the fallback path), so callers
        that already upload device batches can send one int32 length per
        user instead of a [L] float mask and rebuild it on device
        (Recommender._build_batch_rows: halves the per-batch host->device
        traffic)."""
        if not self.enabled:
            # same truncation as the fast path (and Recommender._build_batch):
            # keep the LAST n_hist items — construct_input_text alone would
            # keep the first
            text = construct_input_text(
                [str(h) for h in history][-self.n_hist :], self.item_dict,
                self.n_hist, self.n_q,
            )
            ids, mask = self.tok.encode(text, max_length)
            return ids, int(np.asarray(mask).sum())
        ids = self._assemble(history)[:max_length]
        out = np.full(max_length, self.tok.pad_id, np.int32)
        out[: len(ids)] = ids
        return out, len(ids)

    # -- verification ---------------------------------------------------------

    def _self_check(self) -> bool:
        """Assembled ids must equal the tokenizer's full-text path bit-for-bit
        on representative histories (full, partial, empty); disable the fast
        path otherwise — e.g. a tokenizer whose added tokens strip
        neighboring whitespace."""
        sample_ids = list(self.item_dict)[:3]
        # synthetic items exercise paths short catalog titles may not: the
        # 77-char '...' truncation, trailing punctuation/whitespace next to
        # a special token, and non-ASCII text
        synthetic = {
            "__selfcheck_long__": {
                "title": "Ultra Hydrating Vitamin-C Brightening Facial "
                "Serum with Hyaluronic Acid, Niacinamide and Botanical "
                "Extracts, 2 Fl Oz"
            },
            "__selfcheck_punct__": {"title": "Lip balm (cherry), tube.  "},
            "__selfcheck_unicode__": {"title": "Crème brûlée café — 10 µl"},
        }
        assert len(synthetic["__selfcheck_long__"]["title"]) > 80
        self.item_dict.update(synthetic)
        try:
            cases: List[List[str]] = [
                [],
                sample_ids[:1],
                sample_ids,
                list(synthetic),
                (sample_ids[:1] + list(synthetic)),
            ]
            return self._run_check_cases(cases)
        finally:
            for key in synthetic:
                self.item_dict.pop(key, None)
            self._frag_cache = {
                k: v
                for k, v in self._frag_cache.items()
                if k[1] not in synthetic
            }

    def _run_check_cases(self, cases: List[List[str]]) -> bool:
        for history in cases:
            # the serving contract keeps the LAST n_hist items on every path
            history = history[-self.n_hist :]
            text = construct_input_text(
                history, self.item_dict, self.n_hist, self.n_q
            )
            want = self.tok._encode_text(text)
            got = self._assemble(history)
            if list(want) != list(got):
                self._frag_cache.clear()
                return False
        return True
