"""Profiling + metrics: jax.profiler hooks and throughput meters.

Replaces the reference's hand-rolled ``time.time()`` batch timing, items/sec,
ETA, variance, and memory prints behind ``--profile``
(reference: data_processing/generate_all_item_embeddings.py:221-293, 336-342)
with a reusable module, and adds real ``jax.profiler`` traces (SURVEY.md §5).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import jax
import numpy as np


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """jax.profiler trace context (view with TensorBoard/XProf); no-op when
    log_dir is None."""
    if not log_dir:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named trace span for host-side phases."""
    return jax.profiler.TraceAnnotation(name)


@dataclass
class ThroughputMeter:
    """Per-batch timing with items/sec, ETA and variance stats."""

    total_items: int = 0
    batch_times: List[float] = field(default_factory=list)
    batch_sizes: List[int] = field(default_factory=list)
    _t0: float = 0.0

    def start_batch(self) -> None:
        self._t0 = time.time()

    def end_batch(self, n_items: int) -> float:
        dt = time.time() - self._t0
        self.batch_times.append(dt)
        self.batch_sizes.append(n_items)
        return dt

    @property
    def items_done(self) -> int:
        return int(sum(self.batch_sizes))

    @property
    def items_per_sec(self) -> float:
        t = sum(self.batch_times)
        return self.items_done / t if t > 0 else 0.0

    def eta_seconds(self) -> float:
        if not self.batch_times or self.total_items <= 0:
            return 0.0
        remaining = max(self.total_items - self.items_done, 0)
        return remaining / max(self.items_per_sec, 1e-9)

    def stats(self) -> Dict[str, float]:
        times = np.asarray(self.batch_times) if self.batch_times else np.zeros(1)
        return {
            "items_done": self.items_done,
            "items_per_sec": round(self.items_per_sec, 2),
            "mean_batch_time_s": round(float(times.mean()), 4),
            "batch_time_std_s": round(float(times.std()), 4),
            "eta_s": round(self.eta_seconds(), 1),
        }


def device_memory_stats() -> Dict[str, float]:
    """Per-device memory stats where the backend exposes them."""
    out: Dict[str, float] = {}
    for d in jax.devices():
        try:
            s = d.memory_stats()
            if s:
                out[str(d)] = {
                    "bytes_in_use": s.get("bytes_in_use", 0),
                    "bytes_limit": s.get("bytes_limit", 0),
                }
        except Exception:
            pass
    return out


def check_devices(verbose: bool = True) -> Dict[str, object]:
    """Device self-test (the JAX analog of the reference's --check-gpu probe,
    generate_all_item_embeddings.py:52-120): list devices, run one matmul."""
    import jax.numpy as jnp

    info: Dict[str, object] = {
        "backend": jax.default_backend(),
        "devices": [str(d) for d in jax.devices()],
        "device_count": jax.device_count(),
    }
    try:
        x = jnp.ones((128, 128))
        y = jax.jit(lambda a: (a @ a).sum())(x)
        info["probe_matmul"] = float(y)
        info["ok"] = True
    except Exception as e:  # pragma: no cover
        info["ok"] = False
        info["error"] = str(e)
    if verbose:
        print(json.dumps(info, indent=2))
    return info


class ProgressWriter:
    """Periodic progress JSON enabling manual resume
    (reference: generate_all_item_embeddings.py:311-316)."""

    def __init__(self, path: Optional[str], every_batches: int = 5):
        self.path = path
        self.every = every_batches
        self._count = 0

    def update(self, payload: Dict) -> None:
        self._count += 1
        if self.path and self._count % self.every == 0:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path)

    def finish(self, payload: Dict) -> None:
        if self.path:
            with open(self.path, "w") as f:
                json.dump(payload, f)
