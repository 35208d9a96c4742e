"""JSON-over-HTTP recommendation server with cross-request micro-batching.

POST /recommend   {"history": [item_id, ...], "k": 10}
                  -> {"items": [{"item_id": ..., "score": ...}, ...]}
POST /score       {"history": [...], "candidates": [...]}
                  -> {"ranking": [[item_id, score], ...]}
GET  /healthz     -> {"ok": true, "catalog_size": N, "batches_run": M,
                      "requests_served": R}

Threaded server + ``serving.batching.MicroBatcher``: concurrent
``/recommend`` requests coalesce into full fixed-shape device batches (the
batch-16 forward of a single-threaded server would run 1/16 full per
request).  ``/score`` stays direct (it is the offline
eval surface, not the QPS path).
"""

from __future__ import annotations

import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from unirec.serving.batching import MicroBatcher, ServerOverloaded
from unirec.serving.recommender import Recommender


def make_handler(recommender: Recommender, batcher: MicroBatcher):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._send(
                    200,
                    {
                        "ok": True,
                        "catalog_size": len(recommender.catalog_ids),
                        "batches_run": batcher.batches_run,
                        "requests_served": batcher.requests_served,
                        "device_time_s": batcher.device_time_s,
                        "idle_time_s": batcher.idle_time_s,
                        "submit_time_s": batcher.submit_time_s,
                        "finalize_time_s": batcher.finalize_time_s,
                        "requests_shed": batcher.requests_shed,
                        "max_queued": batcher.max_queued,
                        "handler_parse_s": batcher.handler_parse_s,
                        "handler_wait_s": batcher.handler_wait_s,
                        "handler_respond_s": batcher.handler_respond_s,
                        # end-to-end latency quantiles over the last <=4096
                        # requests: every throughput reading carries its tail
                        "latency": batcher.latency_quantiles(),
                    },
                )
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            t_in = time.perf_counter()
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
            except Exception as e:
                self._send(400, {"error": f"bad json: {e}"})
                return
            t_parsed = time.perf_counter()
            try:
                if self.path == "/recommend":
                    history = req.get("history", [])
                    if not isinstance(history, list):
                        self._send(400, {"error": "history must be a list"})
                        return
                    try:
                        k = int(req.get("k", 10))
                    except (TypeError, ValueError):
                        self._send(400, {"error": "k must be an integer"})
                        return
                    if not 1 <= k <= len(recommender.catalog_ids):
                        self._send(
                            400,
                            {"error": f"k must be in [1, "
                                      f"{len(recommender.catalog_ids)}]"},
                        )
                        return
                    try:
                        recs = batcher.recommend(history, k=k)
                    except ServerOverloaded as e:
                        # shed at saturation: clients retry with backoff
                        # instead of queueing into an unbounded p99 tail
                        self.send_response(503)
                        self.send_header("Retry-After", "1")
                        body = json.dumps({"error": str(e)}).encode()
                        self.send_header("Content-Type", "application/json")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return
                    t_done = time.perf_counter()
                    self._send(
                        200,
                        {"items": [
                            {"item_id": r.item_id, "score": r.score}
                            for r in recs
                        ]},
                    )
                    t_out = time.perf_counter()
                    # host-phase attribution: parse /
                    # batcher wait / response build+write, per request
                    with batcher._acct:
                        batcher.handler_parse_s += t_parsed - t_in
                        batcher.handler_wait_s += t_done - t_parsed
                        batcher.handler_respond_s += t_out - t_done
                elif self.path == "/score":
                    ranking = recommender.score_candidates(
                        req.get("history", []), req.get("candidates", [])
                    )
                    self._send(200, {"ranking": ranking})
                else:
                    self._send(404, {"error": "not found"})
            except Exception as e:
                self._send(500, {"error": str(e)})

    return Handler


def make_server(
    recommender: Recommender,
    host: str = "127.0.0.1",
    port: int = 8099,
    max_wait_ms: float = 3.0,
    request_timeout_s: float = 600.0,
    warmup: bool = False,
    freeze_heap: bool = False,
    max_queued: int = None,
    settle_depth: int = 1,
):
    """(server, batcher) — caller owns serve_forever/shutdown (tests).

    ``warmup=True`` runs one full-shape batch before returning so the
    first-request jit compile is paid before traffic is admitted; ``request_timeout_s`` must cover a
    compile when warmup is skipped.  ``freeze_heap=True`` gc.freeze()s the
    post-warmup heap so gen-2 collections stop rescanning the permanent
    catalog/cache state (serving/host_tuning.py) — process-global, so
    opt-in."""
    batcher = MicroBatcher(recommender, max_wait_ms=max_wait_ms,
                           request_timeout_s=request_timeout_s,
                           max_queued=max_queued,
                           settle_depth=settle_depth)
    if warmup:
        batcher.warmup()
    if freeze_heap:
        from unirec.serving.host_tuning import freeze_host_heap

        freeze_host_heap()

    class _Server(ThreadingHTTPServer):
        daemon_threads = True
        # stdlib default backlog is 5: a burst of concurrent clients
        # overflows the accept queue and stalls on kernel SYN retries
        request_queue_size = 128

    server = _Server((host, port), make_handler(recommender, batcher))
    return server, batcher


def serve(recommender: Recommender, host: str = "127.0.0.1", port: int = 8099):
    server, _ = make_server(recommender, host, port, warmup=True,
                            freeze_heap=True)
    print(f"serving on http://{host}:{port}")
    server.serve_forever()
