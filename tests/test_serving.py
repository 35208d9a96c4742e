"""Serving: Recommender end-to-end + HTTP server round trip."""

import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unirec.configs import (
    ItemQFormerConfig,
    JointModelConfig,
    LoRAConfig,
    tiny_qwen3_config,
)
from unirec.data.cache import FieldEmbeddingCache
from unirec.data.tokenizer import HashTokenizer
from unirec.models.joint import MultiModalQwenEmbedding
from unirec.serving.recommender import Recommender

QWEN = tiny_qwen3_config(max_position_embeddings=64)
F, FD = 3, 16
QF = ItemQFormerConfig(
    hidden_size=QWEN.hidden_size, num_hidden_layers=1, num_attention_heads=2,
    intermediate_size=64, num_query_tokens=2, field_embedding_dim=FD,
    num_fields=F, dropout=0.0,
)
JC = JointModelConfig(num_history_items=2, num_query_tokens_per_item=2,
                      max_length=32)


@pytest.fixture(scope="module")
def recommender():
    rng = np.random.RandomState(0)
    n = 20
    item_ids = [f"i{j}" for j in range(n)]
    cache = FieldEmbeddingCache(
        embeddings=rng.randn(n, F, FD).astype(np.float32),
        masks=np.ones((n, F), np.float32),
        fields=["a", "b", "c"],
        item_ids=item_ids,
    )
    catalog = {
        iid: rng.randn(QWEN.hidden_size).astype(np.float32).tolist()
        for iid in item_ids
    }
    item_dict = {iid: {"title": f"Item {iid}"} for iid in item_ids}
    tok = HashTokenizer(QWEN.vocab_size, JC.num_history_items,
                        JC.num_query_tokens_per_item)
    model = MultiModalQwenEmbedding(QWEN, QF, JC, lora=LoRAConfig(r=2))
    params = model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, JC.max_length), jnp.int32),
        jnp.ones((1, JC.max_length)),
        jnp.zeros((1, JC.num_history_items, F, FD)),
        jnp.ones((1, JC.num_history_items, F)),
    )
    return Recommender(model, params, tok, item_dict, cache, catalog,
                       batch_size=4)


def test_encode_users_fixed_shapes(recommender):
    users = recommender.encode_users([["i0", "i1"], ["i5"], [], ["i2", "i3"],
                                      ["i4"]])
    assert users.shape == (5, QWEN.hidden_size)
    np.testing.assert_allclose(np.linalg.norm(users, axis=1), 1.0, rtol=1e-4)


def test_recommend_top_k(recommender):
    recs = recommender.recommend([["i0", "i1"], ["i3"]], k=5)
    assert len(recs) == 2 and all(len(r) == 5 for r in recs)
    # excluded history
    assert all(r.item_id not in {"i0", "i1"} for r in recs[0])
    # scores sorted desc
    s = [r.score for r in recs[0]]
    assert s == sorted(s, reverse=True)
    # brute force agreement for user 1
    users = recommender.encode_users([["i3"]])
    cat = recommender.catalog / np.linalg.norm(
        recommender.catalog, axis=1, keepdims=True
    )
    sims = cat @ users[0]
    best = [recommender.catalog_ids[j] for j in np.argsort(-sims)]
    best = [b for b in best if b != "i3"][:5]
    assert [r.item_id for r in recs[1]] == best


def test_recommend_multi_chunk_ragged_tail(recommender):
    """5 users at batch_size=4 -> 2 encode chunks, last chunk 1/4 full: the
    single concatenated retrieval must drop the pad rows and keep per-user
    results identical to one-user-at-a-time calls."""
    histories = [["i0", "i1"], ["i3"], [], ["i2"], ["i4", "i5"]]
    recs = recommender.recommend(histories, k=5)
    assert len(recs) == 5 and all(len(r) == 5 for r in recs)
    for h, batched in zip(histories, recs):
        solo = recommender.recommend([h], k=5)[0]
        assert [r.item_id for r in batched] == [r.item_id for r in solo]


def test_score_candidates(recommender):
    ranking = recommender.score_candidates(["i0"], ["i5", "i6", "unknown"])
    assert len(ranking) == 3
    assert {r[0] for r in ranking} == {"i5", "i6", "unknown"}
    scores = [r[1] for r in ranking]
    assert scores == sorted(scores, reverse=True)


def test_http_server_roundtrip(recommender):
    from unirec.serving.server import make_server

    server, batcher = make_server(recommender, port=0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz"
        ) as resp:
            health = json.loads(resp.read())
        assert health["ok"] and health["catalog_size"] == 20

        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/recommend",
            data=json.dumps({"history": ["i0"], "k": 3}).encode(),
            method="POST",
        )
        with urllib.request.urlopen(req) as resp:
            out = json.loads(resp.read())
        assert len(out["items"]) == 3
        assert all("item_id" in r and "score" in r for r in out["items"])

        # malformed body -> 400
        bad = urllib.request.Request(
            f"http://127.0.0.1:{port}/recommend", data=b"{not json",
            method="POST",
        )
        try:
            urllib.request.urlopen(bad)
            assert False, "expected HTTPError"
        except urllib.error.HTTPError as e:
            assert e.code == 400
    finally:
        server.shutdown()
        batcher.close()


def test_concurrent_requests_are_micro_batched(recommender):
    """N concurrent clients must coalesce into shared device batches
    (the old server ran the batch-N forward 1/N full
    per request)."""
    from unirec.serving.server import make_server

    server, batcher = make_server(recommender, port=0, max_wait_ms=100.0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    n_clients = 12
    results = [None] * n_clients
    errors = []

    def client(i):
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/recommend",
                data=json.dumps({"history": [f"i{i % 20}"], "k": 3}).encode(),
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=60) as resp:
                results[i] = json.loads(resp.read())
        except Exception as e:  # pragma: no cover
            errors.append((i, e))

    try:
        threads = [
            threading.Thread(target=client, args=(i,))
            for i in range(n_clients)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=90)
        assert not errors, errors
        assert all(r is not None and len(r["items"]) == 3 for r in results)
        # batching actually happened: far fewer device batches than requests
        assert batcher.requests_served == n_clients
        assert batcher.batches_run < n_clients, (
            batcher.batches_run, n_clients
        )
        # per-request results match the direct path
        direct = recommender.recommend([["i3"]], k=3)[0]
        via = results[3]["items"]
        assert [r.item_id for r in direct] == [r["item_id"] for r in via]
    finally:
        server.shutdown()
        batcher.close()


class _StubRecommender:
    """Minimal Recommender stand-in for batcher-level tests."""

    def __init__(self, poison=None):
        self.batch_size = 4
        self.catalog_ids = [f"c{j}" for j in range(25)]
        self.poison = poison
        self.calls = []

    def recommend(self, histories, k=10):
        return self.recommend_finalize(self.recommend_submit(histories, k))

    # the batcher drives the split submit/finalize interface (pipelined
    # dispatcher); the stub poisons at submit like real assembly errors
    def recommend_submit(self, histories, k=10):
        self.calls.append([list(h) for h in histories])
        if self.poison is not None and any(
            self.poison in h for h in histories
        ):
            raise ValueError("poisoned request")
        return (histories, k)

    def recommend_finalize(self, handle):
        histories, k = handle
        return [
            [type("R", (), {"item_id": c, "score": 1.0})()
             for c in self.catalog_ids[:k]]
            for _ in histories
        ]


def test_batcher_isolates_failing_request():
    """A request that makes the batched call raise must not 500 its
    co-batched neighbors: the batcher retries each request solo and only
    the offender surfaces the error."""
    from unirec.serving.batching import MicroBatcher

    rec = _StubRecommender(poison="bad")
    batcher = MicroBatcher(rec, max_wait_ms=100.0, request_timeout_s=10.0)
    results, errors = {}, {}

    def client(i, history):
        try:
            results[i] = batcher.recommend(history, k=3)
        except Exception as e:
            errors[i] = e

    threads = [
        threading.Thread(target=client, args=(i, h))
        for i, h in enumerate([["a"], ["bad"], ["c"]])
    ]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert set(results) == {0, 2} and all(
            len(r) == 3 for r in results.values()
        )
        assert set(errors) == {1}
        assert isinstance(errors[1], ValueError)
    finally:
        batcher.close()


def test_batcher_k_bucketing_caps_at_catalog():
    from unirec.serving.batching import MicroBatcher

    rec = _StubRecommender()
    batcher = MicroBatcher(rec, max_wait_ms=1.0, request_timeout_s=10.0)
    try:
        out = batcher.recommend(["x"], k=3)
        assert len(out) == 3
        # bucketed to 10, not 3 (shared retrieval shape for mixed-k traffic)
        assert rec.calls and len(rec.calls[-1]) == rec.batch_size
        out = batcher.recommend(["x"], k=23)
        assert len(out) == 23  # capped internally at 25 then sliced
    finally:
        batcher.close()


def test_batcher_close_rejects_promptly():
    """After close(): new calls fail fast and queued requests are rejected
    instead of sleeping out the full request timeout."""
    from unirec.serving.batching import MicroBatcher, _Pending

    batcher = MicroBatcher(_StubRecommender(), request_timeout_s=60.0)
    batcher.close()
    t0 = time.time()
    with pytest.raises(RuntimeError):
        batcher.recommend(["x"], k=3)
    assert time.time() - t0 < 5.0
    # a request stuck in the queue at shutdown gets an error, not a hang
    p = _Pending(["y"], 3)
    batcher._q.put(p)
    batcher.close()
    assert p.event.is_set() and isinstance(p.error, RuntimeError)


def test_server_validates_k(recommender):
    from unirec.serving.server import make_server

    server, batcher = make_server(recommender, port=0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        for bad_k in (0, -1, 10**6, "abc"):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/recommend",
                data=json.dumps({"history": ["i0"], "k": bad_k}).encode(),
                method="POST",
            )
            try:
                urllib.request.urlopen(req, timeout=30)
                assert False, f"expected 400 for k={bad_k!r}"
            except urllib.error.HTTPError as e:
                assert e.code == 400, (bad_k, e.code)
    finally:
        server.shutdown()
        batcher.close()


def test_make_server_warmup_runs_a_batch(recommender):
    from unirec.serving.server import make_server

    server, batcher = make_server(recommender, port=0, warmup=True)
    try:
        assert batcher.batches_run >= 1
    finally:
        server.server_close()
        batcher.close()


def test_make_server_freeze_heap_still_serves(recommender):
    """freeze_heap must freeze the warm heap and leave serving correct;
    unfreeze afterwards so the process-global state doesn't leak into
    other tests."""
    import gc

    from unirec.serving.server import make_server

    before = gc.get_freeze_count()
    server, batcher = make_server(recommender, port=0, warmup=True,
                                  freeze_heap=True)
    try:
        assert gc.get_freeze_count() > before
        out = batcher.recommend(["i1", "i2"], k=3)
        assert len(out) == 3
    finally:
        server.server_close()
        batcher.close()
        gc.unfreeze()


def test_int8_large_batch_accepted():
    """batch 32 int8 is a supported configuration: large batches construct
    and serve normally."""
    rng = np.random.RandomState(3)
    n = 4
    ids = [f"i{j}" for j in range(n)]
    cache = FieldEmbeddingCache(
        embeddings=rng.randn(n, F, FD).astype(np.float32),
        masks=np.ones((n, F), np.float32),
        fields=["a", "b", "c"],
        item_ids=ids,
    )
    catalog = {i: rng.randn(QWEN.hidden_size).astype(np.float32).tolist()
               for i in ids}
    tok = HashTokenizer(QWEN.vocab_size, JC.num_history_items,
                        JC.num_query_tokens_per_item)
    model = MultiModalQwenEmbedding(QWEN, QF, JC, lora=LoRAConfig(r=2))
    params = model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, JC.max_length), jnp.int32),
        jnp.ones((1, JC.max_length)),
        jnp.zeros((1, JC.num_history_items, F, FD)),
        jnp.ones((1, JC.num_history_items, F)),
    )
    rec = Recommender(
        model, params, tok, {i: {"title": i} for i in ids}, cache,
        catalog, batch_size=32, precision="int8",
    )
    assert rec.batch_size == 32
    recs = rec.recommend([["i0"], []], k=2)
    assert all(len(r) == 2 for r in recs)


def test_quantized_recommender(recommender):
    from unirec.serving.recommender import Recommender

    q_rec = Recommender(
        recommender.model, recommender.params, recommender.tokenizer,
        recommender.item_dict, recommender.cache,
        {i: recommender.catalog[j]
         for j, i in enumerate(recommender.catalog_ids)},
        batch_size=4, quantize_catalog=True,
    )
    r_fp = recommender.recommend([["i0", "i1"]], k=5)[0]
    r_q = q_rec.recommend([["i0", "i1"]], k=5)[0]
    # int8 vs fp32: top item identical, top-5 sets nearly identical
    assert r_fp[0].item_id == r_q[0].item_id
    overlap = len({r.item_id for r in r_fp} & {r.item_id for r in r_q})
    assert overlap >= 4


def test_int8_recommender(recommender):
    """precision="int8": Qwen3 projections run W8A8; user embeddings must
    stay close to the full-precision path and retrieval must still work."""
    from unirec.models.qwen3 import quantize_qwen3_weights
    from unirec.serving.recommender import Recommender

    qw = quantize_qwen3_weights(recommender.params)
    # every decoder layer contributes 7 quantized projections
    n_q = len(jax.tree_util.tree_leaves(qw))
    assert n_q == QWEN.num_hidden_layers * 7 * 2  # kernel_q + scale each

    r8 = Recommender(
        recommender.model, recommender.params, recommender.tokenizer,
        recommender.item_dict, recommender.cache,
        {i: recommender.catalog[j] for j, i in
         enumerate(recommender.catalog_ids)},
        batch_size=4, precision="int8",
    )
    hs = [["i0", "i1"], ["i5"], []]
    u_ref = recommender.encode_users(hs)
    u8 = r8.encode_users(hs)
    cos = (u_ref * u8).sum(-1)  # both L2-normalized
    assert cos.min() > 0.98, cos
    recs = r8.recommend(hs, k=5)
    assert all(len(r) == 5 for r in recs)

    with pytest.raises(ValueError):
        Recommender(
            recommender.model, recommender.params, recommender.tokenizer,
            recommender.item_dict, recommender.cache, {}, precision="fp4",
        )


def test_int8_dp_divisibility_still_enforced(recommender):
    """The dp divisibility invariant holds for int8 serving too (a
    non-divisible batch is a shard_map crash at serve time)."""
    from unirec.configs import MeshConfig
    from unirec.parallel.mesh import make_mesh

    catalog = {i: recommender.catalog[j]
               for j, i in enumerate(recommender.catalog_ids)}
    args = (recommender.model, recommender.params, recommender.tokenizer,
            recommender.item_dict, recommender.cache, catalog)

    r = Recommender(*args, batch_size=32, precision="int8")
    assert r.batch_size == 32

    if len(jax.devices()) < 2:
        pytest.skip("needs >= 2 devices")
    mesh = make_mesh(MeshConfig(dp=2, tp=1))
    r48 = Recommender(*args, batch_size=48, precision="int8", mesh=mesh)
    assert r48.batch_size == 48
    with pytest.raises(ValueError, match="not divisible"):
        Recommender(*args, batch_size=33, precision="int8", mesh=mesh)


def test_dp_mesh_recommender_matches_single_device(recommender):
    """Recommender(mesh=dp) shards the user forward AND the retrieval over
    a dp mesh via shard_map.  Per-user results must match the
    single-device path."""
    from unirec.configs import MeshConfig
    from unirec.parallel.mesh import make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs >= 2 devices")
    mesh = make_mesh(MeshConfig(dp=2, tp=1))
    catalog = {iid: recommender.catalog[i].tolist()
               for i, iid in enumerate(recommender.catalog_ids)}
    dp = Recommender(
        recommender.model, recommender.params, recommender.tokenizer,
        recommender.item_dict, recommender.cache, catalog,
        batch_size=4, mesh=mesh,
    )
    histories = [["i0", "i1"], ["i3"], [], ["i2"], ["i4", "i5"]]
    u_dp = dp.encode_users(histories)
    u_1 = recommender.encode_users(histories)
    np.testing.assert_allclose(u_dp, u_1, atol=1e-5, rtol=1e-5)
    recs_dp = dp.recommend(histories, k=5)
    recs_1 = recommender.recommend(histories, k=5)
    for a, b in zip(recs_dp, recs_1):
        assert [r.item_id for r in a] == [r.item_id for r in b]
    # batch not divisible by dp: loud error
    with pytest.raises(ValueError, match="not divisible"):
        Recommender(
            recommender.model, recommender.params, recommender.tokenizer,
            recommender.item_dict, recommender.cache, catalog,
            batch_size=3, mesh=mesh,
        )


def test_device_field_cache_matches_host_gather(recommender):
    """The device-resident field cache (rows uploaded, gather on device)
    must match the host-gather path to bf16-cast tolerance, including
    unknown-id zero-row degradation."""
    rng = np.random.RandomState(5)
    n = 20
    item_ids = [f"i{j}" for j in range(n)]
    cache = FieldEmbeddingCache(
        embeddings=rng.randn(n, F, FD).astype(np.float32),
        masks=np.ones((n, F), np.float32),
        fields=["a", "b", "c"],
        item_ids=item_ids,
    )
    catalog = {i: rng.randn(QWEN.hidden_size).astype(np.float32).tolist()
               for i in item_ids}
    tok = HashTokenizer(QWEN.vocab_size, JC.num_history_items,
                        JC.num_query_tokens_per_item)
    model = MultiModalQwenEmbedding(QWEN, QF, JC, lora=LoRAConfig(r=2))
    params = model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, JC.max_length), jnp.int32),
        jnp.ones((1, JC.max_length)),
        jnp.zeros((1, JC.num_history_items, F, FD)),
        jnp.ones((1, JC.num_history_items, F)),
    )
    item_dict = {i: {"title": i} for i in item_ids}
    kw = dict(batch_size=4)
    host = Recommender(model, params, tok, item_dict, cache, catalog,
                       device_field_cache=False, **kw)
    dev = Recommender(model, params, tok, item_dict, cache, catalog,
                      device_field_cache=True, **kw)
    histories = [["i0", "i1"], ["i5"], ["nonexistent", "i2"], []]
    u_host = host.encode_users(histories)
    u_dev = dev.encode_users(histories)
    # bf16 device cache: small rounding vs the fp32 host gather
    np.testing.assert_allclose(u_dev, u_host, atol=2e-2, rtol=2e-2)
    cos = (u_dev * u_host).sum(-1)
    assert (cos > 0.999).all(), cos


def test_batcher_sheds_at_admission_bound():
    """Latency SLO: when `max_queued` requests already wait
    for collection, further requests shed with ServerOverloaded instead of
    growing the p99 queue tail; everything admitted still completes, and
    latency quantiles are published."""
    import time as _time

    from unirec.serving.batching import MicroBatcher, ServerOverloaded

    class _SlowStub(_StubRecommender):
        def recommend_finalize(self, handle):
            _time.sleep(0.05)  # hold batches in flight so the queue builds
            return super().recommend_finalize(handle)

    rec = _SlowStub()
    batcher = MicroBatcher(
        rec, max_wait_ms=20.0, request_timeout_s=30.0, max_queued=6
    )
    done, shed, other = [], [], []

    def client(i):
        try:
            done.append(batcher.recommend([f"h{i}"], k=3))
        except ServerOverloaded:
            shed.append(i)
        except Exception as e:  # pragma: no cover
            other.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(40)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not other, other
        assert shed, "40 bursty clients over a 6-deep queue must shed some"
        assert len(done) + len(shed) == 40
        assert all(len(r) == 3 for r in done)
        assert batcher.requests_shed == len(shed)
        q = batcher.latency_quantiles()
        assert q["n"] == len(done)
        assert 0 < q["p50_ms"] <= q["p95_ms"] <= q["p99_ms"]
        # the bound is the SLO statement: an admitted request waits at most
        # max_queued ahead of it + <=2 in-flight batches
        assert q["p99_ms"] < 30_000
    finally:
        batcher.close()


def test_batcher_inline_settle_at_light_load():
    """With an empty queue the dispatcher settles inline (nothing to
    overlap); results and accounting stay correct."""
    from unirec.serving.batching import MicroBatcher

    rec = _StubRecommender()
    batcher = MicroBatcher(rec, max_wait_ms=1.0, request_timeout_s=10.0)
    try:
        for i in range(3):  # strictly sequential -> queue empty at submit
            r = batcher.recommend([f"h{i}"], k=3)
            assert len(r) == 3
        assert batcher.requests_served == 3
        assert batcher.latency_quantiles()["n"] == 3
    finally:
        batcher.close()


def test_merge_lora_serving_matches_unmerged():
    """merge_lora=True (PEFT merge_and_unload for deployment) must produce
    the same user embeddings and rankings as the adapter path, with TRAINED
    (nonzero) adapters."""
    rng = np.random.RandomState(7)
    n = 16
    item_ids = [f"i{j}" for j in range(n)]
    cache = FieldEmbeddingCache(
        embeddings=rng.randn(n, F, FD).astype(np.float32),
        masks=np.ones((n, F), np.float32),
        fields=["a", "b", "c"],
        item_ids=item_ids,
    )
    catalog = {
        iid: rng.randn(QWEN.hidden_size).astype(np.float32).tolist()
        for iid in item_ids
    }
    item_dict = {iid: {"title": f"Item {iid}"} for iid in item_ids}
    tok = HashTokenizer(QWEN.vocab_size, JC.num_history_items,
                        JC.num_query_tokens_per_item)
    model = MultiModalQwenEmbedding(QWEN, QF, JC, lora=LoRAConfig(r=2))
    params = model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, JC.max_length), jnp.int32),
        jnp.ones((1, JC.max_length)),
        jnp.zeros((1, JC.num_history_items, F, FD)),
        jnp.ones((1, JC.num_history_items, F)),
    )
    # "train" the adapters: fill every lora_a/lora_b with nonzero values
    # (fresh init has lora_b = 0, which would make the merge trivially exact)
    leaves = []

    def fill(tree, path=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v, path + "/" + k)
            elif k in ("lora_a", "lora_b"):
                leaves.append(path + "/" + k)
                tree[k] = jnp.asarray(
                    rng.randn(*v.shape).astype(np.float32) * 0.05
                )

    fill(params["params"])
    assert any("lora_b" in p for p in leaves), "no adapters found"

    kw = dict(batch_size=4)
    r_adapter = Recommender(
        model, params, tok, item_dict, cache, catalog, **kw
    )
    r_merged = Recommender(
        model, params, tok, item_dict, cache, catalog, merge_lora=True, **kw
    )
    # merged model carries no adapter leaves
    flat = {
        "/".join(map(str, p))
        for p, _ in jax.tree_util.tree_flatten_with_path(r_merged.params)[0]
    }
    assert not any("lora_a" in p or "lora_b" in p for p in flat)

    hists = [["i0", "i1"], ["i3"], []]
    ua = r_adapter.encode_users(hists)
    um = r_merged.encode_users(hists)
    np.testing.assert_allclose(np.asarray(ua), np.asarray(um), atol=2e-5)
    ra = r_adapter.recommend(hists, k=5)
    rm = r_merged.recommend(hists, k=5)
    assert [[x.item_id for x in row] for row in ra] == [
        [x.item_id for x in row] for row in rm
    ]


def test_int8_merged_lora_serving_matches_float32():
    """Recommender(precision="int8", merge_lora=True): int8 dots over the
    adapted weights must stay close to the float32 merged model, and rank
    the same top item."""
    qwen = tiny_qwen3_config(
        hidden_size=128, intermediate_size=256, num_attention_heads=1,
        num_key_value_heads=1, head_dim=128, max_position_embeddings=64,
    )
    qf = ItemQFormerConfig(
        hidden_size=128, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=64, num_query_tokens=2, field_embedding_dim=FD,
        num_fields=F, dropout=0.0,
    )
    jc = JointModelConfig(num_history_items=2, num_query_tokens_per_item=2,
                          max_length=64)
    rng = np.random.RandomState(11)
    n = 12
    item_ids = [f"i{j}" for j in range(n)]
    cache = FieldEmbeddingCache(
        embeddings=rng.randn(n, F, FD).astype(np.float32),
        masks=np.ones((n, F), np.float32),
        fields=["a", "b", "c"],
        item_ids=item_ids,
    )
    catalog = {iid: rng.randn(qwen.hidden_size).astype(np.float32).tolist()
               for iid in item_ids}
    item_dict = {iid: {"title": f"Item {iid}"} for iid in item_ids}
    tok = HashTokenizer(qwen.vocab_size, jc.num_history_items,
                        jc.num_query_tokens_per_item)
    model = MultiModalQwenEmbedding(qwen, qf, jc, lora=LoRAConfig(r=2))
    params = model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, jc.max_length), jnp.int32),
        jnp.ones((1, jc.max_length)),
        jnp.zeros((1, jc.num_history_items, F, FD)),
        jnp.ones((1, jc.num_history_items, F)),
    )
    r_8 = Recommender(model, params, tok, item_dict, cache, catalog,
                      merge_lora=True, batch_size=8, precision="int8")
    r_32 = Recommender(model, params, tok, item_dict, cache, catalog,
                       merge_lora=True, batch_size=8)
    assert r_8.model.lora is None and r_8._qweights is not None

    hists = [["i0", "i1"], ["i3"], [], ["i2", "i5"]]
    u8 = np.asarray(r_8.encode_users(hists), np.float32)
    u32 = np.asarray(r_32.encode_users(hists), np.float32)
    cos = (u8 * u32).sum(-1) / (
        np.linalg.norm(u8, axis=-1) * np.linalg.norm(u32, axis=-1) + 1e-9
    )
    assert cos.min() > 0.98, cos.min()
    r8 = r_8.recommend(hists, k=5)
    r32 = r_32.recommend(hists, k=5)
    assert all(len(row) == 5 for row in r8)
    assert [row[0].item_id for row in r8] == [row[0].item_id for row in r32]


def test_int8_serving_under_dp_mesh():
    """int8 serving under a dp shard_map must match single-device
    output."""
    from unirec.configs import MeshConfig
    from unirec.parallel.mesh import make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs >= 2 devices")
    qwen = tiny_qwen3_config(
        hidden_size=128, intermediate_size=256, num_attention_heads=1,
        num_key_value_heads=1, head_dim=128, max_position_embeddings=64,
    )
    qf = ItemQFormerConfig(
        hidden_size=128, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=64, num_query_tokens=2, field_embedding_dim=FD,
        num_fields=F, dropout=0.0,
    )
    jc = JointModelConfig(num_history_items=2, num_query_tokens_per_item=2,
                          max_length=64)
    rng = np.random.RandomState(13)
    n = 10
    item_ids = [f"i{j}" for j in range(n)]
    cache = FieldEmbeddingCache(
        embeddings=rng.randn(n, F, FD).astype(np.float32),
        masks=np.ones((n, F), np.float32),
        fields=["a", "b", "c"],
        item_ids=item_ids,
    )
    catalog = {iid: rng.randn(qwen.hidden_size).astype(np.float32).tolist()
               for iid in item_ids}
    item_dict = {iid: {"title": f"Item {iid}"} for iid in item_ids}
    tok = HashTokenizer(qwen.vocab_size, jc.num_history_items,
                        jc.num_query_tokens_per_item)
    model = MultiModalQwenEmbedding(qwen, qf, jc)  # no LoRA
    params = model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, jc.max_length), jnp.int32),
        jnp.ones((1, jc.max_length)),
        jnp.zeros((1, jc.num_history_items, F, FD)),
        jnp.ones((1, jc.num_history_items, F)),
    )
    mesh = make_mesh(MeshConfig(dp=2, tp=1))
    kw = dict(precision="int8")
    r_dp = Recommender(model, params, tok, item_dict, cache, catalog,
                       batch_size=16, mesh=mesh, **kw)
    r_1 = Recommender(model, params, tok, item_dict, cache, catalog,
                      batch_size=16, **kw)
    hists = [["i0", "i1"], ["i3"], [], ["i2"], ["i4", "i5"]]
    u_dp = np.asarray(r_dp.encode_users(hists), np.float32)
    u_1 = np.asarray(r_1.encode_users(hists), np.float32)
    np.testing.assert_allclose(u_dp, u_1, atol=1e-5, rtol=1e-5)


def test_warmup_exempt_from_request_timeout():
    """A cold jit compile can exceed request_timeout_s; warmup() must wait
    it out instead
    of killing the server before it admits traffic — and must restore the
    configured timeout afterwards."""
    import time as _time

    from unirec.serving.batching import MicroBatcher

    class _SlowFirstCall(_StubRecommender):
        def __init__(self):
            super().__init__()
            self.first = True

        def recommend_submit(self, histories, k=10):
            if self.first:
                self.first = False
                _time.sleep(0.5)  # "compile" longer than the SLO below
            return super().recommend_submit(histories, k)

    rec = _SlowFirstCall()
    batcher = MicroBatcher(rec, max_wait_ms=1.0, request_timeout_s=0.2)
    try:
        batcher.warmup()  # must NOT raise TimeoutError
        assert batcher.request_timeout_s == 0.2  # restored
    finally:
        batcher.close()


def test_single_chip_retrieval_is_jitted(recommender):
    """The single-device retrieval must run as ONE jitted callable (cached
    per fetch-k), not a chain of eager ops each dispatched separately."""
    recommender._retrievals.clear()
    recommender.recommend([["item0", "item1"]], k=3)
    assert recommender._retrievals, "retrieval did not go through the jit cache"
    fetch, fn = next(iter(recommender._retrievals.items()))
    import jax

    assert isinstance(fn, jax.stages.Wrapped)
    # second call reuses the cached callable (no growth)
    recommender.recommend([["item2"]], k=3)
    assert len(recommender._retrievals) == 1


def test_batcher_settle_depth_2():
    """settle_depth=2 (a serving knob): three batches may be in flight;
    all concurrent requests still complete with correct results and
    accounting — the knob must stay correct for load-shape experiments."""
    from unirec.serving.batching import MicroBatcher

    rec = _StubRecommender()
    batcher = MicroBatcher(rec, max_wait_ms=5.0, request_timeout_s=30.0,
                           settle_depth=2)
    assert batcher._settle_q.maxsize == 2
    done, errs = [], []

    def client(i):
        try:
            done.append((i, batcher.recommend([f"h{i}"], k=3)))
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(24)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errs, errs
        assert len(done) == 24
        assert all(len(r) == 3 for _, r in done)
        assert batcher.requests_served == 24
    finally:
        batcher.close()
