"""Tokenizer layer for the joint model.

The reference uses the HF Qwen tokenizer with 20 added special tokens
(reference: train_item_individual_token_joint.py:98-119).  This environment is
zero-egress, so the framework abstracts tokenization behind one interface:

* ``HFTokenizer`` — wraps a locally available HF tokenizer (pass a local path
  or cached model name); special history tokens are added and resolve to ids
  ``>= base_vocab``;
* ``HashTokenizer`` — deterministic hash-based word tokenizer for tests and
  weightless runs; same special-token contract.

Both produce fixed-length (max_length) right-padded ids + attention mask, the
shapes the jit graph expects.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from unirec.models.joint import history_token_strings

_SPECIAL_RE = re.compile(r"<\|history_item_\d+_query_\d+\|>")
_WORD_RE = re.compile(r"<\|history_item_\d+_query_\d+\|>|\S+")


class BaseTokenizer:
    """Fixed-shape batch encoding with reserved history special tokens."""

    def __init__(
        self,
        base_vocab_size: int,
        num_history_items: int = 10,
        num_query_tokens_per_item: int = 2,
        pad_id: int = 0,
    ):
        self.base_vocab_size = base_vocab_size
        self.pad_id = pad_id
        self.special_tokens = history_token_strings(
            num_history_items, num_query_tokens_per_item
        )
        self.special_to_id = {
            tok: base_vocab_size + i for i, tok in enumerate(self.special_tokens)
        }

    @property
    def vocab_size(self) -> int:
        return self.base_vocab_size + len(self.special_tokens)

    def _encode_text(self, text: str) -> List[int]:  # pragma: no cover
        raise NotImplementedError

    def encode_plain(self, text: str) -> List[int]:
        """Ids for a text FRAGMENT: no sequence affixes (BOS/EOS), no special
        tokens inside.  Used by the serving prompt cache
        (serving/prompt_cache.py) to assemble full prompts from cached
        per-item fragments."""
        return self._encode_text(text)

    def encode_plain_batch(self, texts: Sequence[str]) -> List[List[int]]:
        """Batched ``encode_plain`` (HF tokenizers batch in native code —
        used by the prompt cache's prewarm)."""
        return [self.encode_plain(t) for t in texts]

    def affix_ids(self) -> Tuple[List[int], List[int]]:
        """(prefix, suffix) ids the tokenizer adds around a full sequence."""
        return [], []

    def encode(self, text: str, max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        ids = self._encode_text(text)[:max_length]
        mask = np.zeros(max_length, np.float32)
        mask[: len(ids)] = 1.0
        out = np.full(max_length, self.pad_id, np.int32)
        out[: len(ids)] = ids
        return out, mask

    def encode_batch(
        self, texts: Sequence[str], max_length: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        ids, masks = zip(*(self.encode(t, max_length) for t in texts))
        return np.stack(ids), np.stack(masks)


class HashTokenizer(BaseTokenizer):
    """Deterministic word-hash tokenizer (no vocabulary files needed)."""

    def _encode_text(self, text: str) -> List[int]:
        import hashlib

        ids = []
        for tok in _WORD_RE.findall(text):
            if tok in self.special_to_id:
                ids.append(self.special_to_id[tok])
            else:
                h = int(hashlib.md5(tok.lower().encode()).hexdigest(), 16)
                # avoid pad id 0
                ids.append(1 + h % (self.base_vocab_size - 1))
        return ids


class HFTokenizer(BaseTokenizer):
    """Wraps a local HF tokenizer; adds the history special tokens exactly as
    the reference does (train_item_individual_token_joint.py:117-119)."""

    def __init__(
        self,
        name_or_path: str,
        num_history_items: int = 10,
        num_query_tokens_per_item: int = 2,
    ):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(name_or_path)
        base_vocab = len(self.tok)
        super().__init__(
            base_vocab, num_history_items, num_query_tokens_per_item,
            pad_id=self.tok.pad_token_id or 0,
        )
        self.tok.add_special_tokens(
            {"additional_special_tokens": self.special_tokens}
        )
        # HF assigns added ids sequentially from base_vocab -> same contract
        self.special_to_id = {
            t: self.tok.convert_tokens_to_ids(t) for t in self.special_tokens
        }

    def _encode_text(self, text: str) -> List[int]:
        return self.tok(text, add_special_tokens=True)["input_ids"]

    def encode_plain(self, text: str) -> List[int]:
        return self.tok(text, add_special_tokens=False)["input_ids"]

    def encode_plain_batch(self, texts: Sequence[str]) -> List[List[int]]:
        return self.tok(list(texts), add_special_tokens=False)["input_ids"]

    def affix_ids(self) -> Tuple[List[int], List[int]]:
        """Sequence affixes from the tokenizer's own template: ids added
        around an empty input (Qwen adds none; BERT-style adds CLS/SEP)."""
        ids = self.tok("", add_special_tokens=True)["input_ids"]
        if not ids:
            return [], []
        # split at the insertion point of an empty body: everything a bare
        # encode emits is affix; a single probe token locates the boundary.
        probe = self.tok("a", add_special_tokens=False)["input_ids"]
        full = self.tok("a", add_special_tokens=True)["input_ids"]
        for start in range(len(full) - len(probe) + 1):
            if full[start : start + len(probe)] == probe:
                return full[:start], full[start + len(probe):]
        return ids, []  # fallback: treat everything as prefix


def make_tokenizer(
    name_or_path: Optional[str] = None,
    base_vocab_size: int = 151669,
    num_history_items: int = 10,
    num_query_tokens_per_item: int = 2,
) -> BaseTokenizer:
    """HF tokenizer when a path/model is given, hash tokenizer otherwise.

    An explicit ``name_or_path`` that fails to load RAISES instead of silently
    degrading: a typo'd checkpoint path must not train the flagship on hash
    tokens.  The hash fallback is only for the no-path (weightless) case.
    """
    if name_or_path:
        try:
            return HFTokenizer(
                name_or_path, num_history_items, num_query_tokens_per_item
            )
        except Exception as e:
            raise ValueError(
                f"failed to load HF tokenizer from {name_or_path!r}; "
                "pass name_or_path=None to use the hash tokenizer explicitly"
            ) from e
    return HashTokenizer(
        base_vocab_size, num_history_items, num_query_tokens_per_item
    )
