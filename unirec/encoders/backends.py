"""Field-encoder backends: text (Qwen3-Embedding), image (CLIP), number (MWNE).

Each backend exposes a batched numpy-in/numpy-out interface the ItemEncoder
orchestrates.  Heavy compute is a jitted device forward; IO (image download /
decode) stays host-side with a thread pool, mirroring the reference
(models/item_encoder_pure_value.py:204-217) — IO is not a device problem.

Backends are pluggable:
  * ``Qwen3TextBackend`` / ``CLIPImageBackend`` — real towers; load converted
    HF weights when a local checkpoint is available (zero-egress safe);
  * ``HashTextBackend`` / ``HashImageBackend`` — deterministic stand-ins for
    tests and weightless environments;
  * ``MWNENumberBackend`` — the math-aware number encoder (always real).
"""

from __future__ import annotations

import hashlib
import io
from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from unirec.configs import MWNEConfig, Qwen3Config
from unirec.models.clip import (
    CLIPVisionConfig,
    CLIPVisionTower,
    preprocess_image,
)
from unirec.models.mwne import NormalizedMathematicalEncoder
from unirec.models.qwen3 import Qwen3Model, last_token_pool


class TextBackend:
    dim: int

    def encode(self, texts: Sequence[str]) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError


class ImageBackend:
    dim: int

    def encode(self, images: Sequence[Any]) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError


class NumberBackend:
    dim: int

    def encode(self, numbers: Sequence[float]) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError


def _l2_normalize_np(x: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + eps)


class HashTextBackend(TextBackend):
    """Deterministic pseudo-embeddings keyed by text content."""

    def __init__(self, dim: int = 1024):
        self.dim = dim

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            seed = int(hashlib.md5(str(t).encode()).hexdigest()[:8], 16)
            out[i] = np.random.RandomState(seed).randn(self.dim)
        return _l2_normalize_np(out)


class HashImageBackend(ImageBackend):
    """Deterministic pseudo-embeddings keyed by image reference (URL/path)."""

    def __init__(self, dim: int = 768):
        self.dim = dim

    def encode(self, images: Sequence[Any]) -> np.ndarray:
        out = np.zeros((len(images), self.dim), np.float32)
        for i, ref in enumerate(images):
            seed = int(hashlib.md5(str(ref).encode()).hexdigest()[:8], 16)
            out[i] = np.random.RandomState(seed ^ 0xBEEF).randn(self.dim)
        return _l2_normalize_np(out)


class Qwen3TextBackend(TextBackend):
    """Qwen3-Embedding-style text encoder: tokenize -> decoder forward ->
    last-token pool -> L2 normalize (what
    SentenceTransformer("Qwen/Qwen3-Embedding-0.6B") computes,
    reference: models/item_encoder_pure_value.py:50, 84-86)."""

    def __init__(
        self,
        config: Optional[Qwen3Config] = None,
        params=None,
        tokenizer=None,
        max_length: int = 128,
        batch_size: int = 64,
        dtype=jnp.bfloat16,
    ):
        self.config = config or Qwen3Config()
        self.dim = self.config.hidden_size
        self.max_length = max_length
        self.batch_size = batch_size
        if tokenizer is None:
            from unirec.data.tokenizer import HashTokenizer

            tokenizer = HashTokenizer(self.config.vocab_size, 0, 0)
        self.tokenizer = tokenizer
        self.model = Qwen3Model(self.config, dtype=dtype)
        if params is None:
            params = self.model.init(
                jax.random.PRNGKey(0), input_ids=jnp.zeros((1, 4), jnp.int32)
            )
        self.params = params

        def fwd(p, ids, mask):
            hidden = self.model.apply(p, input_ids=ids, attention_mask=mask)
            pooled = last_token_pool(hidden, mask)
            norm = jnp.linalg.norm(pooled, axis=-1, keepdims=True)
            return pooled / jnp.maximum(norm, 1e-8)

        self._fwd = jax.jit(fwd)

    @classmethod
    def from_local_hf(cls, path: str, **kw) -> "Qwen3TextBackend":
        """Load a locally available HF Qwen3 checkpoint (no network)."""
        import torch
        from transformers import AutoConfig, AutoModel, AutoTokenizer

        from unirec.utils.torch_convert import convert_qwen3

        hf_cfg = AutoConfig.from_pretrained(path)
        cfg = Qwen3Config(
            vocab_size=hf_cfg.vocab_size,
            hidden_size=hf_cfg.hidden_size,
            intermediate_size=hf_cfg.intermediate_size,
            num_hidden_layers=hf_cfg.num_hidden_layers,
            num_attention_heads=hf_cfg.num_attention_heads,
            num_key_value_heads=hf_cfg.num_key_value_heads,
            head_dim=getattr(hf_cfg, "head_dim", 128),
            rope_theta=hf_cfg.rope_theta,
        )
        model = AutoModel.from_pretrained(path, torch_dtype=torch.float32)
        params = {
            "params": convert_qwen3(model.state_dict(), cfg.num_hidden_layers)
        }

        class _TokWrap:
            def __init__(self, tok):
                self.tok = tok

            def encode(self, text, max_length):
                out = self.tok(
                    text, truncation=True, max_length=max_length,
                    padding="max_length", return_tensors="np",
                )
                return out["input_ids"][0].astype(np.int32), out[
                    "attention_mask"
                ][0].astype(np.float32)

        tok = _TokWrap(AutoTokenizer.from_pretrained(path))
        return cls(cfg, params, tok, **kw)

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        """One compiled shape per regime: full chunks (and tails after them)
        run at ``batch_size``; a lone undersized call runs at its natural
        shape — never a second trace within one regime (the old ``pad and i > 0`` guard compiled two shapes per loop)."""
        n = len(texts)
        out = np.zeros((n, self.dim), np.float32)
        for i in range(0, n, self.batch_size):
            chunk = list(texts[i : i + self.batch_size])
            ids, masks = zip(
                *(self.tokenizer.encode(t, self.max_length) for t in chunk)
            )
            ids = np.stack(ids)
            masks = np.stack(masks)
            take = len(chunk)
            pad = 0 if (i == 0 and n <= self.batch_size) else (
                self.batch_size - take
            )
            if pad > 0:
                ids = np.pad(ids, ((0, pad), (0, 0)))
                masks = np.pad(masks, ((0, pad), (0, 0)))
                masks[take:, 0] = 1.0  # avoid empty rows
            emb = self._fwd(self.params, jnp.asarray(ids), jnp.asarray(masks))
            out[i : i + take] = np.asarray(emb, np.float32)[:take]
        return out


class CLIPImageBackend(ImageBackend):
    """CLIP vision tower + host-side loading.

    Accepts URLs (parallel thread-pool download, reference
    item_encoder_pure_value.py:204-217), base64 strings, file paths, or PIL
    images.  Failures degrade to zero embeddings (reference :167-170).
    """

    def __init__(
        self,
        config: Optional[CLIPVisionConfig] = None,
        params=None,
        batch_size: int = 32,
        download_workers: int = 16,
        dtype=jnp.bfloat16,
    ):
        self.config = config or CLIPVisionConfig()
        self.dim = self.config.projection_dim
        self.batch_size = batch_size
        self.download_workers = download_workers
        self.model = CLIPVisionTower(self.config, dtype=dtype)
        if params is None:
            params = self.model.init(
                jax.random.PRNGKey(0),
                jnp.zeros(
                    (1, self.config.image_size, self.config.image_size, 3)
                ),
            )
        self.params = params
        self._fwd = jax.jit(lambda p, x: self.model.apply(p, x))

    @classmethod
    def from_local_hf(cls, path: str, **kw) -> "CLIPImageBackend":
        import torch
        from transformers import CLIPModel

        from unirec.models.clip import convert_clip_vision

        hf = CLIPModel.from_pretrained(path, torch_dtype=torch.float32)
        vc = hf.config.vision_config
        cfg = CLIPVisionConfig(
            hidden_size=vc.hidden_size,
            intermediate_size=vc.intermediate_size,
            num_hidden_layers=vc.num_hidden_layers,
            num_attention_heads=vc.num_attention_heads,
            image_size=vc.image_size,
            patch_size=vc.patch_size,
            projection_dim=hf.config.projection_dim,
        )
        params = {"params": convert_clip_vision(hf.state_dict(), cfg)}
        return cls(cfg, params, **kw)

    def _load_image(self, ref: Any):
        from PIL import Image

        if hasattr(ref, "convert"):  # PIL image
            return ref.convert("RGB")
        s = str(ref)
        if s.startswith("http"):
            import requests

            resp = requests.get(s, stream=True, timeout=10)
            resp.raise_for_status()
            return Image.open(resp.raw).convert("RGB")
        if s.startswith("data:image") or len(s) > 260:
            import base64

            if s.startswith("data:image"):
                s = s.split(",")[1]
            return Image.open(io.BytesIO(base64.b64decode(s))).convert("RGB")
        return Image.open(s).convert("RGB")

    def _load_all(self, refs: Sequence[Any]):
        import concurrent.futures

        def load(idx_ref):
            idx, ref = idx_ref
            try:
                return idx, self._load_image(ref)
            except Exception:
                return idx, None

        urls = [(i, r) for i, r in enumerate(refs)
                if str(r).startswith("http")]
        others = [(i, r) for i, r in enumerate(refs)
                  if not str(r).startswith("http")]
        results = {}
        if urls:
            with concurrent.futures.ThreadPoolExecutor(
                max_workers=self.download_workers
            ) as ex:
                for idx, img in ex.map(load, urls):
                    results[idx] = img
        for idx, ref in others:
            results[idx] = load((idx, ref))[1]
        return results

    def encode(self, images: Sequence[Any]) -> np.ndarray:
        n = len(images)
        out = np.zeros((n, self.dim), np.float32)
        valid = [
            (i, r) for i, r in enumerate(images) if r is not None and str(r).strip()
        ]
        if not valid:
            return out
        loaded = self._load_all([r for _, r in valid])
        pix, rows = [], []
        for j, (i, _) in enumerate(valid):
            img = loaded.get(j)
            if img is not None:
                pix.append(preprocess_image(img, self.config.image_size))
                rows.append(i)
        for i in range(0, len(pix), self.batch_size):
            chunk = np.stack(pix[i : i + self.batch_size])
            emb = np.asarray(
                self._fwd(self.params, jnp.asarray(chunk)), np.float32
            )
            for k, row in enumerate(rows[i : i + self.batch_size]):
                out[row] = emb[k]
        return out


class MWNENumberBackend(NumberBackend):
    """Normalized math-aware number encoder + L2 normalization
    (reference: models/item_encoder_pure_value.py:290-306)."""

    def __init__(
        self,
        config: Optional[MWNEConfig] = None,
        variables=None,
    ):
        self.config = config or MWNEConfig()
        self.dim = self.config.embedding_dim
        self.model = NormalizedMathematicalEncoder(self.config)
        if variables is None:
            variables = self.model.init(jax.random.PRNGKey(0), jnp.zeros((2,)))
        self.variables = variables
        self._fwd = jax.jit(
            lambda v, x: self.model.apply(v, x, train=False)
        )

    @classmethod
    def from_reference_checkpoint(cls, path: str) -> "MWNENumberBackend":
        """Load the reference's trained number-encoder checkpoint
        (number_encoders/mathematical_encoder_1024d_normalized.pth —
        reference: models/item_encoder_pure_value.py:68-70, schema
        models/mwne.py:784-806) so number-field embeddings match the
        reference pipeline's."""
        from unirec.utils.torch_convert import (
            load_reference_mwne_checkpoint,
        )

        cfg, variables = load_reference_mwne_checkpoint(path)
        return cls(cfg, variables=variables)

    def encode(self, numbers: Sequence[float]) -> np.ndarray:
        # Sanitize: invalid -> 0.0 (reference :295-301)
        clean = []
        for x in numbers:
            try:
                clean.append(float(x))
            except (TypeError, ValueError):
                clean.append(0.0)
        emb = np.asarray(
            self._fwd(self.variables, jnp.asarray(clean, jnp.float32)),
            np.float32,
        )
        return _l2_normalize_np(emb)
