"""Serving: end-to-end recommendation from trained checkpoints.

The reference has no serving layer (SURVEY.md §0 "no serving layer"); its eval
loop ranks a fixed 100-candidate pool per user offline.  This module closes
the loop for production use:

* ``Recommender`` — loads the joint model (or a lighter user-embedding stack),
  encodes user histories in one jit forward, and ranks the FULL item catalog
  with one cosine matmul + ``lax.top_k`` (ops/ranking.top_k_items);
* a batched request API with fixed shapes: requests are padded to the
  compiled batch size, so serving never retraces.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from unirec.data.cache import FieldEmbeddingCache
from unirec.data.tokenizer import BaseTokenizer
from unirec.models.joint import MultiModalQwenEmbedding
from unirec.ops.losses import l2_normalize
from unirec.ops.ranking import top_k_items
from unirec.parallel.mesh import replicate


@dataclasses.dataclass
class Recommendation:
    item_id: str
    score: float


def _dp_sharded(mesh, fn, in_specs, n_out=1):
    """jit(shard_map(fn)) over a dp mesh: each device gets its per-shard
    rows explicitly.  ``in_specs`` marks each argument P() (replicated) or
    P("dp") (user axis split); outputs are always split."""
    return jax.jit(
        jax.shard_map(
            fn,
            mesh=mesh,
            in_specs=in_specs,
            out_specs=P("dp") if n_out == 1 else (P("dp"),) * n_out,
            check_vma=False,
        )
    )


class Recommender:
    """Joint-model recommender over a precomputed catalog."""

    def __init__(
        self,
        model: MultiModalQwenEmbedding,
        params,
        tokenizer: BaseTokenizer,
        item_dict: Dict[str, Dict],
        field_cache: FieldEmbeddingCache,
        catalog_embeddings: Dict[str, Sequence[float]],
        batch_size: int = 8,
        quantize_catalog: bool = False,
        precision: str = "bf16",
        device_field_cache: bool = True,
        mesh=None,
        merge_lora: bool = False,
    ):
        """``precision="int8"`` runs the user-encoding Qwen3 forward with
        int8 (W8A8) projection dots (models/qwen3.quantize_qwen3_weights)
        for the FLOP-dominant GEMMs.  Opt-in; it changes the embeddings
        within the quantization error.

        ``mesh`` (a dp mesh from parallel.mesh.make_mesh) shards serving over
        devices: params/caches/catalog replicated, every request batch and
        the retrieval's user axis split over ``dp`` (the forward has zero
        collectives; each device scans the catalog for its own user shard),
        under ``jax.shard_map``.

        ``merge_lora=True`` folds the trained LoRA adapters into the base
        kernels before deployment (the PEFT merge_and_unload move —
        utils/params.merge_lora_weights): 14 fewer rank-16 matmuls + adds
        per layer in the serving forward, and int8 quantization sees the
        adapted weights.  Numerics shift within adapter-magnitude rounding."""
        if merge_lora and getattr(model, "lora", None) is not None:
            from unirec.utils.params import merge_lora_weights

            scaling = model.lora.scaling
            if "params" in params:
                params = dict(
                    params, params=merge_lora_weights(
                        params["params"], scaling
                    )
                )
            else:
                params = merge_lora_weights(params, scaling)
            model = model.clone(lora=None)
        self.model = model
        self.params = params
        self.tokenizer = tokenizer
        self.item_dict = item_dict
        self.cache = field_cache
        self.batch_size = batch_size
        self.jc = model.joint_config
        self.mesh = mesh
        self.dp_size = int(mesh.shape["dp"]) if mesh is not None else 1
        if precision not in ("bf16", "int8"):
            raise ValueError(f"precision must be bf16 or int8, got {precision!r}")
        if mesh is not None and batch_size % self.dp_size:
            raise ValueError(
                f"batch_size {batch_size} not divisible by dp mesh size "
                f"{self.dp_size}"
            )
        self._retrievals = {}  # fetch-k -> jitted dp retrieval
        # per-phase host wall time inside recommend_submit (serving-bench
        # attribution; see recommend_submit docstring)
        from collections import defaultdict
        import threading

        self.submit_phase_s = defaultdict(float)
        # the float += below is not atomic; correct under the single
        # MicroBatcher dispatcher thread, but direct multi-threaded
        # recommend() callers would drop samples without this
        self._phase_lock = threading.Lock()
        if mesh is not None:
            self.params = params = replicate(mesh, params)

        self.catalog_ids: List[str] = list(catalog_embeddings)
        self.catalog = np.asarray(
            [catalog_embeddings[i] for i in self.catalog_ids], np.float32
        )
        self.quantized = quantize_catalog
        if quantize_catalog:
            # int8 catalog: 4x less device memory and catalog traffic
            # (unirec/ops/quantization.py)
            from unirec.ops.quantization import quantize_rows

            q, scales = quantize_rows(jnp.asarray(self.catalog))
            self._catalog_q = q
            self._catalog_scales = scales
            self._catalog_dev = None
        else:
            self._catalog_dev = jnp.asarray(self.catalog)
        if mesh is not None:
            # every device holds the FULL catalog and scans it for its own
            # user shard — retrieval is embarrassingly dp, zero collectives
            if self.quantized:
                self._catalog_q = replicate(mesh, self._catalog_q)
                self._catalog_scales = replicate(mesh, self._catalog_scales)
            else:
                self._catalog_dev = replicate(mesh, self._catalog_dev)

        self.precision = precision
        self._qweights = None
        if precision == "int8":
            from unirec.models.qwen3 import quantize_qwen3_weights

            self._qweights = quantize_qwen3_weights(params)
            if mesh is not None:
                self._qweights = replicate(mesh, self._qweights)

        # user forward with L2 norm fused in (one less host round trip).
        # qweights ride as a jit ARGUMENT on EVERY jitted entry point (a
        # closure capture would bake the 0.6 GB int8 tree into the
        # executable as constants).
        def _apply(p, qw, ids, m, he, hm):
            variables = {"params": p} if "params" not in p else dict(p)
            if qw is not None:
                variables = dict(variables, qweights=qw)
            return l2_normalize(self.model.apply(variables, ids, m, he, hm))

        if mesh is None:
            inner = jax.jit(_apply)
        else:
            inner = _dp_sharded(
                mesh, _apply,
                in_specs=(P(), P(), P("dp"), P("dp"), P("dp"), P("dp")),
            )
        self._fwd = lambda p, ids, m, he, hm: inner(
            p, self._qweights, ids, m, he, hm
        )
        # Device-resident field cache: per-batch history gathers move ON
        # DEVICE so each request batch uploads [B, H] int32 row indices
        # instead of [B, H, F, FD] fp32 embeddings (~9 MB/batch at the
        # production config).  Costs num_items*F*FD bf16 device memory
        # once (~3.2 GB for a 112,590-item catalog).
        self.device_cache = device_field_cache
        if device_field_cache:
            self._cache_emb_dev = jnp.asarray(
                field_cache.embeddings, jnp.bfloat16
            )
            self._cache_mask_dev = jnp.asarray(
                field_cache.masks, jnp.float32
            )
            if mesh is not None:
                self._cache_emb_dev = replicate(mesh, self._cache_emb_dev)
                self._cache_mask_dev = replicate(mesh, self._cache_mask_dev)
            # cache arrays AND qweights ride as jit ARGUMENTS (closure
            # captures would bake 0.57 GB + 0.6 GB of constants into the
            # executable — see the qweights note above).  The attention mask
            # is rebuilt ON DEVICE from one int32 length per user (prompt
            # padding is always a prefix mask — prompt_cache.encode_ids):
            # [B] lengths are uploaded instead of [B, L] floats.
            def fwd_rows(p, qw, cache_emb, cache_mask, ids, lengths, rows):
                m = (
                    jnp.arange(ids.shape[1])[None, :] < lengths[:, None]
                ).astype(jnp.float32)
                valid = rows >= 0  # [B, H]
                safe = jnp.clip(rows, 0, None)
                he = jnp.where(
                    valid[..., None, None],
                    cache_emb[safe].astype(jnp.float32),
                    0.0,
                )
                hm = jnp.where(valid[..., None], cache_mask[safe], 0.0)
                return _apply(p, qw, ids, m, he, hm)

            if mesh is None:
                inner_rows = jax.jit(fwd_rows)
            else:
                inner_rows = _dp_sharded(
                    mesh, fwd_rows,
                    in_specs=(
                        P(), P(), P(), P(), P("dp"), P("dp"), P("dp"),
                    ),
                )
            self._fwd_rows = lambda p, ids, lengths, rows: inner_rows(
                p, self._qweights, self._cache_emb_dev, self._cache_mask_dev,
                ids, lengths, rows,
            )

        # fragment-cached prompt tokenization (serving/prompt_cache.py):
        # exact by construction (self-verified) and ~free after warmup on
        # repeated titles (tokenization is host work on every request).
        from unirec.serving.prompt_cache import CachedPromptEncoder

        self._prompt = CachedPromptEncoder(
            tokenizer, item_dict, self.jc.num_history_items,
            self.jc.num_query_tokens_per_item,
        )

    def prewarm_prompts(self, item_ids=None, slots=None) -> int:
        """Batch-tokenize prompt fragments ahead of traffic (removes the
        cold-start tokenization cost; serving/prompt_cache.py)."""
        return self._prompt.prewarm(item_ids, slots)

    # -- user encoding -----------------------------------------------------

    def _build_batch(self, histories: Sequence[Sequence[str]]):
        jc = self.jc
        n = len(histories)
        f = self.cache.num_fields
        fd = self.cache.embedding_dim
        input_ids = np.zeros((n, jc.max_length), np.int32)
        attn = np.zeros((n, jc.max_length), np.float32)
        hist_emb = np.zeros((n, jc.num_history_items, f, fd), np.float32)
        hist_mask = np.zeros((n, jc.num_history_items, f), np.float32)
        for i, history in enumerate(histories):
            history = [str(h) for h in history][-jc.num_history_items:]
            e, m = self.cache.gather(history)
            hist_emb[i, : len(history)] = e
            hist_mask[i, : len(history)] = m
            input_ids[i], attn[i] = self._prompt.encode(history, jc.max_length)
        return input_ids, attn, hist_emb, hist_mask

    def _build_batch_rows(self, histories: Sequence[Sequence[str]]):
        """(input_ids, lengths [B], cache rows [B, H]) — the device-gather
        path.  The prefix attention mask is rebuilt on device from lengths
        (see fwd_rows above)."""
        jc = self.jc
        n = len(histories)
        input_ids = np.zeros((n, jc.max_length), np.int32)
        lengths = np.zeros((n,), np.int32)
        rows = np.full((n, jc.num_history_items), -1, np.int32)
        for i, history in enumerate(histories):
            history = [str(h) for h in history][-jc.num_history_items:]
            rows[i, : len(history)] = self.cache.rows_for(history)
            input_ids[i], lengths[i] = self._prompt.encode_ids(
                history, jc.max_length
            )
        return input_ids, lengths, rows

    # batches allowed in flight on the device before the oldest result is
    # drained: overlaps host assembly with device compute without letting a
    # bulk encode_users call accumulate unbounded device buffers (each batch
    # pins its inputs + output in device memory until fetched)
    MAX_IN_FLIGHT = 8

    def encode_users(self, histories: Sequence[Sequence[str]]) -> np.ndarray:
        """[num_users, D] L2-normalized user embeddings; fixed-shape batches.

        Dispatch is pipelined: host assembly of batch N+1 overlaps device
        compute of batch N (jax dispatch is async), with at most
        ``MAX_IN_FLIGHT`` un-fetched batches on the device — bounded memory for
        arbitrarily large offline sweeps, no per-batch sync for small ones.
        """
        chunks = self._encode_user_chunks(histories, to_host=True)
        return np.concatenate([emb[:n] for emb, n in chunks], axis=0)

    def _encode_user_chunks(
        self, histories: Sequence[Sequence[str]], to_host: bool = False
    ):
        """[(embedding chunk [bs, D], n_valid), ...].

        ``to_host=False`` (the ``recommend`` path) keeps chunks ON DEVICE so
        ranking can consume them without a host round trip — device memory
        then grows with the number of users, which is fine for bounded
        request batches.  ``to_host=True`` (bulk ``encode_users`` sweeps)
        drains each chunk to numpy as soon as it leaves the in-flight
        window, keeping at most ``MAX_IN_FLIGHT`` batches on the device for
        arbitrarily large sweeps."""
        from collections import deque

        out = []
        pending: deque = deque()
        bs = self.batch_size

        def drain(emb, n):
            if to_host:
                out.append((np.asarray(emb, np.float32), n))
            else:
                # bound the dispatch queue (queued batches pin their input
                # buffers)
                jax.block_until_ready(emb)
                out.append((emb, n))

        for i in range(0, len(histories), bs):
            chunk = list(histories[i : i + bs])
            n = len(chunk)
            while len(chunk) < bs:
                chunk.append([])  # pad with empty histories
            if self.device_cache:
                ids, lengths, rows = self._build_batch_rows(chunk)
                emb = self._fwd_rows(
                    self.params, jnp.asarray(ids), jnp.asarray(lengths),
                    jnp.asarray(rows),
                )
            else:
                ids, attn, he, hm = self._build_batch(chunk)
                emb = self._fwd(
                    self.params, jnp.asarray(ids), jnp.asarray(attn),
                    jnp.asarray(he), jnp.asarray(hm),
                )
            pending.append((emb, n))
            if len(pending) >= self.MAX_IN_FLIGHT:
                drain(*pending.popleft())
        while pending:
            if to_host:
                drain(*pending.popleft())
            else:
                out.append(pending.popleft())
        return out

    # -- ranking -----------------------------------------------------------

    def recommend(
        self,
        histories: Sequence[Sequence[str]],
        k: int = 10,
        exclude_history: bool = True,
    ) -> List[List[Recommendation]]:
        """Top-k catalog items per user (full-catalog retrieval).

        User embeddings never leave the device between encoding and
        ranking; only the [users, k] scores/indices are fetched.
        Retrieval runs as ONE call over all chunks: its cost is dominated
        by the catalog scan (per-CALL, independent of the user batch), so
        per-chunk ranking would multiply it by the chunk count.  The
        concatenated
        shape is a multiple of batch_size, so retrieval retraces per
        distinct CHUNK COUNT, not per user count.
        """
        return self.recommend_finalize(
            self.recommend_submit(histories, k, exclude_history))

    def recommend_submit(
        self,
        histories: Sequence[Sequence[str]],
        k: int = 10,
        exclude_history: bool = True,
    ):
        """Host-assembly + async device dispatch half of ``recommend``.

        Returns an opaque handle for :meth:`recommend_finalize`.  JAX
        dispatch is asynchronous, so between the two calls the device
        crunches this batch in the background while the caller does host
        work — the serving dispatcher uses this to overlap batch N+1's
        tokenization/assembly and batch N's response post-processing with
        batch N's device compute (the same MAX_IN_FLIGHT overlap the
        offline ``encode_users`` sweep gets).

        ``submit_phase_s`` accumulates per-phase wall time (encode /
        retrieve dispatch) for the serving benches' attribution — host
        cost only; both phases are asynchronous device dispatches."""
        import time as _time

        t0 = _time.perf_counter()
        chunks = self._encode_user_chunks(histories)
        t1 = _time.perf_counter()
        fetch = k + (self.jc.num_history_items if exclude_history else 0)
        users_dev = jnp.concatenate([emb for emb, _ in chunks], axis=0).astype(
            jnp.float32
        )
        s, ix = self._retrieve(users_dev, fetch)
        t2 = _time.perf_counter()
        with self._phase_lock:
            self.submit_phase_s["encode"] += t1 - t0
            self.submit_phase_s["retrieve"] += t2 - t1
        return (s, ix, [n for _, n in chunks], histories, k, exclude_history)

    def recommend_finalize(self, handle) -> List[List[Recommendation]]:
        """Blocking half of ``recommend``: fetch the [users, k]
        scores/indices and build the per-user result lists."""
        s, ix, counts, histories, k, exclude_history = handle
        s, ix = np.asarray(s), np.asarray(ix)
        keep = np.concatenate(
            [np.arange(i * self.batch_size, i * self.batch_size + n)
             for i, n in enumerate(counts)]
        )
        scores, idx = s[keep], ix[keep]
        results: List[List[Recommendation]] = []
        for u, history in enumerate(histories):
            seen = set(map(str, history)) if exclude_history else set()
            recs: List[Recommendation] = []
            for s, j in zip(scores[u], idx[u]):
                iid = self.catalog_ids[int(j)]
                if iid in seen:
                    continue
                recs.append(Recommendation(iid, float(s)))
                if len(recs) == k:
                    break
            results.append(recs)
        return results

    def _retrieve(self, users_dev, fetch: int):
        """Top-``fetch`` scores/indices for [U, D] user embeddings, as one
        jitted call cached per fetch-k.  dp mesh: users split over dp, the
        full catalog replicated on every device; each device's top-k over
        the whole catalog is already final for its users (no merge)."""
        if self.quantized:
            from unirec.ops.quantization import quantized_top_k

            def retrieve(u, *cat):
                return quantized_top_k(u, *cat, k=fetch)

            cat = (self._catalog_q, self._catalog_scales)
        else:

            def retrieve(u, *cat):
                return top_k_items(u, *cat, k=fetch)

            cat = (self._catalog_dev,)
        fn = self._retrievals.get(fetch)
        if fn is None:
            if self.mesh is None:
                fn = jax.jit(retrieve)
            else:
                fn = _dp_sharded(
                    self.mesh, lambda u, *c: tuple(retrieve(u, *c)),
                    in_specs=(P("dp"),) + (P(),) * len(cat), n_out=2,
                )
            self._retrievals[fetch] = fn
        return fn(users_dev, *cat)

    def score_candidates(
        self, history: Sequence[str], candidate_ids: Sequence[str]
    ) -> List[Tuple[str, float]]:
        """Rank an explicit candidate pool (the reference's eval setting)."""
        user = self.encode_users([history])[0]
        default = np.zeros(self.catalog.shape[1], np.float32)
        cand = np.asarray(
            [
                self.catalog[self.catalog_ids.index(c)]
                if c in self.catalog_ids
                else default
                for c in map(str, candidate_ids)
            ]
        )
        cand = np.asarray(l2_normalize(jnp.asarray(cand)))
        sims = cand @ user
        order = np.argsort(-sims)
        return [(str(candidate_ids[i]), float(sims[i])) for i in order]
