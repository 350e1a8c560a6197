"""Micro-batcher: group concurrent graph evals by signature.

Counterpart of ``interactive_vit_tpu/serving/batcher.py`` (BASELINE config
5, continuous micro-batched serving). One worker thread queues incoming
(graph, taps) requests, groups consecutive requests whose executor group
signature matches (topology, params, input shapes, taps) up to
``max_batch`` within ``max_wait_ms``, runs a group as one batched pass
(``Executor.run_stacked``; one request: ``Executor.run``), and resolves
each request's future with its slice of the results. All device work
happens on that one thread.

Dispatch is pipelined: a group is dispatched (its launches and its
results' copies to the host enqueued, ``defer=True``), and the worker goes
on to collect and dispatch the next group while the card works; a group
is materialized as soon as its copies have landed (checked before each
collect and each dispatch: an eager dispatch is a whole host pass, which
finished results must not wait behind), when ``pipeline_depth`` newer
groups are in flight, or when the queue runs dry. Depth 0 materializes
each group at once. Before a dispatch whose program is not in the
executor's cache (``is_compiled``: its first run may build kernel sources
for tens of seconds, and on a card captures its CUDA graph) the groups in
flight are materialized first. Other-signature requests seen
while a group collects wait in a backlog that is served first on the next
cycle, so a minority signature is not starved.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional

from interactive_vit_tpu_torch.graph.executor import Executor, TapSpec
from interactive_vit_tpu_torch.graph.ir import Graph
from interactive_vit_tpu_torch.serving.metrics import Metrics

logger = logging.getLogger(__name__)

_IDLE = object()  # a poll that found nothing queued


class _Item:
    __slots__ = ("graph", "taps", "future", "enqueued", "sig", "queue_s")

    def __init__(self, graph: Graph, taps: TapSpec, sig: str):
        self.graph = graph
        self.taps = taps
        self.sig = sig
        self.future: Future = Future()
        self.enqueued = time.perf_counter()
        self.queue_s = 0.0


class MicroBatcher:
    """Background worker turning a request stream into micro-batches."""

    def __init__(self, executor: Executor, max_batch: int = 8,
                 max_wait_ms: float = 3.0, metrics: Optional[Metrics] = None,
                 pipeline_depth: int = 1):
        self.executor = executor
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.metrics = metrics or Metrics()
        # groups dispatched and not yet materialized, at most
        self.pipeline_depth = max(0, int(pipeline_depth))
        self._q: "queue.Queue[Optional[_Item]]" = queue.Queue()
        self._backlog: List[_Item] = []  # worker-thread only
        # the newest submit or result delivery, and the groups dispatched
        # and not yet resolved: ``quiet_for`` reads both (a dispatched
        # group has left the queue, so an empty queue alone is not idle)
        self.last_activity_t = 0.0
        self.inflight = 0
        # optional hook, called on the worker thread before each dispatch
        # with (graph, taps, batch or None, group length); its failures
        # are logged and never fail the group
        self.on_dispatch = None
        self._thread: Optional[threading.Thread] = None
        self._started = False
        self._lock = threading.Lock()

    def start(self) -> None:
        with self._lock:
            self._start_locked()

    def _start_locked(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="ivt-batcher")
            self._thread.start()
            self._started = True

    def stop(self) -> None:
        """Stop the worker; requests still queued fail with RuntimeError.
        Atomic with respect to ``submit`` (same lock)."""
        with self._lock:
            if self._started and self._thread is not None:
                self._q.put(None)
                self._thread.join(timeout=30)
                self._started = False
                if not self._thread.is_alive():
                    self._thread = None

    def submit(self, graph: Graph, taps: TapSpec = "all") -> Future:
        """Enqueue one eval; returns a Future of {node: {ch: array}}."""
        if not isinstance(taps, str):
            taps = frozenset(taps)  # a generator would be exhausted below
        tap_key = taps if isinstance(taps, str) else str(sorted(taps))
        item = _Item(graph, taps, self.executor.group_sig(graph,
                                                          extra=[tap_key]))
        with self._lock:
            if (not self._started and self._thread is not None
                    and self._thread.is_alive()):
                raise RuntimeError(
                    "batcher is stopping (worker still exiting); retry")
            self._start_locked()
            self.last_activity_t = time.perf_counter()
            self._q.put(item)
        return item.future

    def quiet_for(self, seconds: float) -> bool:
        """True when nothing is queued or in flight and no submit or
        result happened for ``seconds``."""
        return (self.inflight == 0 and self._q.empty()
                and not self._backlog
                and time.perf_counter() - self.last_activity_t >= seconds)

    # -- worker ----------------------------------------------------------------
    def _collect_group(self, first: _Item) -> List[_Item]:
        """Gather same-signature items up to max_batch within the window."""
        group = [first]
        keep: List[_Item] = []
        for it in self._backlog:
            if it.sig == first.sig and len(group) < self.max_batch:
                group.append(it)
            else:
                keep.append(it)
        self._backlog = keep
        deadline = time.perf_counter() + self.max_wait_s
        while len(group) < self.max_batch:
            timeout = deadline - time.perf_counter()
            if timeout <= 0:
                break
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if item is None:  # shutdown marker: push back and bail
                self._q.put(None)
                break
            if item.sig == first.sig:
                group.append(item)
            else:
                self._backlog.append(item)
        return group

    def _next_item(self, block: bool):
        if self._backlog:
            return self._backlog.pop(0)
        try:
            return self._q.get() if block else self._q.get_nowait()
        except queue.Empty:
            return _IDLE

    def _loop(self) -> None:
        pending: List[tuple] = []  # FIFO of dispatched groups
        while True:
            item = self._next_item(block=not pending)
            if item is _IDLE:  # nothing queued: finish what is in flight
                for p in pending:
                    self._materialize(p)
                pending = []
                continue
            if item is None:
                for p in pending:
                    self._materialize(p)
                self._drain_stopped()
                return
            pending = self._resolve_ready(pending)
            group = self._collect_group(item)
            pending = self._resolve_ready(pending)
            if pending and not self._warm(group):
                for p in pending:
                    self._materialize(p)
                pending = []
            dispatched = self._dispatch(group)
            if dispatched is not None:
                pending.append(dispatched)
            while len(pending) > self.pipeline_depth:
                self._materialize(pending.pop(0))

    def _resolve_ready(self, pending: List[tuple]) -> List[tuple]:
        """Materialize the oldest groups whose results have landed, in
        order; returns the rest."""
        while pending and pending[0][1].ready():
            self._materialize(pending.pop(0))
        return pending

    def _warm(self, group: List[_Item]) -> bool:
        """Whether the group's program is in the executor's cache (a
        single request runs ``run``: batch None; a group, its power-of-two
        bucket)."""
        try:
            return self.executor.is_compiled(
                group[0].graph, group[0].taps,
                len(group) if len(group) > 1 else None)
        except Exception:  # noqa: BLE001 -- a bad graph: _dispatch fails
            # its futures with the attributed error; a raise here would
            # end the worker and orphan the groups in flight
            return False

    def _drain_stopped(self) -> None:
        """Fail anything still queued at shutdown: a future never resolved
        would hang its HTTP handler thread."""
        err = RuntimeError("batcher stopped")
        leftovers = list(self._backlog)
        self._backlog = []
        while True:
            try:
                it = self._q.get_nowait()
            except queue.Empty:
                break
            if it is not None:
                leftovers.append(it)
        for it in leftovers:
            if not it.future.done():
                it.future.set_exception(err)

    def _dispatch(self, group: List[_Item]):
        """Launch a group; returns (group, in-flight handle, t0), or None
        when the dispatch failed (the group's futures then hold the
        error)."""
        t0 = time.perf_counter()
        self.last_activity_t = t0
        self.inflight += 1
        for it in group:
            it.queue_s = t0 - it.enqueued
            self.metrics.queue_latency.observe(it.queue_s)
        if self.on_dispatch is not None:
            try:
                self.on_dispatch(group[0].graph, group[0].taps,
                                 len(group) if len(group) > 1 else None,
                                 len(group))
            except Exception:  # noqa: BLE001 -- a hook never fails a group
                logger.debug("dispatch hook failed", exc_info=True)
        try:
            if len(group) == 1:
                handle = self.executor.run(group[0].graph, group[0].taps,
                                           defer=True)
            else:
                handle = self.executor.run_stacked(
                    [it.graph for it in group], group[0].taps, defer=True)
            return (group, handle, t0)
        except Exception as err:  # noqa: BLE001 -- fail the whole group
            logger.exception("batch dispatch failed")
            self._fail(group, err)
            return None

    def _fail(self, group: List[_Item], err: Exception) -> None:
        self.metrics.inc("batch_errors")
        self.inflight -= 1
        self.last_activity_t = time.perf_counter()
        for it in group:
            if not it.future.done():
                it.future.set_exception(err)

    def _materialize(self, pending) -> None:
        """Wait for a dispatched group's results and resolve its futures;
        a device error fails that group alone."""
        group, handle, t0 = pending
        try:
            results = handle.materialize()
            if len(group) == 1:
                results = [results]
        except Exception as err:  # noqa: BLE001 -- device errors land here
            logger.exception("batch failed")
            self._fail(group, err)
            return
        compute_s = time.perf_counter() - t0
        self.metrics.compute_latency.observe(compute_s)
        self.metrics.batch_sizes.observe(len(group))
        self.metrics.inc("batches")
        self.metrics.inc("batched_requests", len(group))
        for it, res in zip(group, results):
            # per-request phase attribution, read by App.compute
            it.future.ivt_timing = {
                "queue_ms": round(it.queue_s * 1e3, 2),
                "compute_ms": round(compute_s * 1e3, 2),
                "batch": len(group),
            }
            it.future.set_result(res)
            self.metrics.request_latency.observe(
                time.perf_counter() - it.enqueued)
        self.inflight -= 1
        self.last_activity_t = time.perf_counter()
