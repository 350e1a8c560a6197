"""Serving metrics: counters + latency quantiles.

A copy of ``interactive_vit_tpu/serving/metrics.py`` (framework-neutral):
request, queue, compute, decode and encode latency reservoirs, and the
counters that ``/metrics`` reports.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict


class LatencyHistogram:
    """Reservoir of recent latencies; cheap quantile queries."""

    def __init__(self, cap: int = 4096):
        self.cap = cap
        # deque(maxlen): O(1) keep-most-recent appends — a list slice per
        # observation would copy the whole window on every hot-path call
        # once at capacity
        self._vals: "collections.deque[float]" = collections.deque(maxlen=cap)
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._vals.append(seconds)

    def quantile(self, q: float) -> float:
        with self._lock:
            if not self._vals:
                return 0.0
            vals = sorted(self._vals)
        idx = min(len(vals) - 1, int(q * len(vals)))
        return vals[idx]

    def count(self) -> int:
        with self._lock:
            return len(self._vals)

    def mean(self) -> float:
        with self._lock:
            return sum(self._vals) / len(self._vals) if self._vals else 0.0


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {}
        self.request_latency = LatencyHistogram()  # enqueue -> resolved
        self.compute_latency = LatencyHistogram()  # batch dispatch -> host
        self.wire_latency = LatencyHistogram()     # decode -> encoded
        self.decode_latency = LatencyHistogram()   # wire decode only
        self.queue_latency = LatencyHistogram()    # enqueue -> dispatch
        self.encode_latency = LatencyHistogram()   # wire encode only
        self.batch_sizes = LatencyHistogram()
        self.started = time.monotonic()  # clock steps must not corrupt uptime

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + by

    def snapshot(self) -> Dict:
        with self._lock:
            counters = dict(self.counters)
        up = time.monotonic() - self.started
        return {
            "uptime_s": up,
            "counters": counters,
            "request_p50_ms": self.request_latency.quantile(0.5) * 1e3,
            "request_p95_ms": self.request_latency.quantile(0.95) * 1e3,
            "compute_p50_ms": self.compute_latency.quantile(0.5) * 1e3,
            "compute_p95_ms": self.compute_latency.quantile(0.95) * 1e3,
            "wire_p50_ms": self.wire_latency.quantile(0.5) * 1e3,
            # per-request phase breakdown (server-side; anything the client
            # measures beyond wire_p50 is network RTT + client work):
            # decode -> queue -> compute -> encode
            "decode_p50_ms": self.decode_latency.quantile(0.5) * 1e3,
            "queue_p50_ms": self.queue_latency.quantile(0.5) * 1e3,
            "encode_p50_ms": self.encode_latency.quantile(0.5) * 1e3,
            "mean_batch_size": self.batch_sizes.mean(),
            "requests_per_s": counters.get("compute_requests", 0) / max(up, 1e-9),
        }
