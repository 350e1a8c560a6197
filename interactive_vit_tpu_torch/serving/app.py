"""HTTP application: the reference endpoints + metrics, stdlib-only.

Counterpart of ``interactive_vit_tpu/serving/app.py``:

    GET  /                      index page (frontend)
    GET  /list_graphs           JSON list of saved graph names
    GET  /load_graph/<name>     saved graph JSON
    POST /compute               binary wire protocol eval
    POST /profile               device-time profile of one wire request
                                (?iters=N&top=K; torch.profiler)
    POST /debug_eval            per-node eval: times, shapes, fault isolation
    POST /save_graph/<name>     persist a graph JSON to the library
    GET  /description/<name>    node IO declaration JSON (params via query)
    GET  /contents/<name>       node HTML body (params via query)
    GET  /descriptions?names=a,b,c   batched IO declarations
    GET  /metrics               serving metrics JSON
    GET  /health                device liveness probe
    GET  /static/<path>         frontend assets

Error contract: failures return HTTP 400 with the error text as the body;
compute errors attributed to a node are prefixed with ``node <i> (<name>):``.
A /compute past its deadline returns 503; a /profile while another runs,
409. Every /compute response, an error included, carries
``X-IVT-Request-Id: g0-<pid hex>-<counter hex>`` (generation 0: the port
does not recycle its workers) and ``X-IVT-Timing`` (decode, queue,
compute, encode and wall ms, and the batch the request ran in). Not ported
yet: tap speculation, the program inventory and worker recycling.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, unquote, urlparse

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity
from torch.profiler import profile as torch_profile

from interactive_vit_tpu_torch.graph.executor import Executor
from interactive_vit_tpu_torch.graph.registry import Registry, registry
from interactive_vit_tpu_torch.serving.batcher import MicroBatcher
from interactive_vit_tpu_torch.serving.metrics import Metrics
from interactive_vit_tpu_torch.wire.codec import Request as WireRequest
from interactive_vit_tpu_torch.wire.codec import Response as WireResponse
from interactive_vit_tpu_torch.wire.schema import GraphLibrary

logger = logging.getLogger(__name__)


class ComputeTimeout(Exception):
    """A /compute request exceeded its deadline -- mapped to HTTP 503."""


class ProfileBusy(Exception):
    """A /profile capture is already in progress -- mapped to HTTP 409
    (one profiler session at a time)."""


_MIME = {
    ".html": "text/html",
    ".js": "text/javascript",
    ".css": "text/css",
    ".json": "application/json",
    ".svg": "image/svg+xml",
    ".png": "image/png",
}


class App:
    """Server state: registry, executor, batcher, graph library, metrics."""

    def __init__(
        self,
        reg: Optional[Registry] = None,
        graphs_dir: str = "static/graphs",
        frontend_dir: Optional[str] = None,
        device="cuda",
        use_jit: bool = True,
        max_batch: int = 8,
        max_wait_ms: float = 3.0,
        compute_timeout_s: float = 120.0,
        pipeline_depth: int = 1,
    ):
        self.compute_timeout_s = compute_timeout_s
        self.reg = reg or registry()
        self.executor = Executor(self.reg, use_jit=use_jit, device=device)
        self.metrics = Metrics()
        self.batcher = MicroBatcher(self.executor, max_batch=max_batch,
                                    max_wait_ms=max_wait_ms,
                                    metrics=self.metrics,
                                    pipeline_depth=pipeline_depth)
        self._profile_lock = threading.Lock()
        self.graphs = GraphLibrary(graphs_dir)
        self.frontend_dir = frontend_dir and os.path.abspath(frontend_dir)
        self._health_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="health-probe")
        self._health_fut: Optional[concurrent.futures.Future] = None
        self._rid_lock = threading.Lock()
        self._rid_counter = 0

    def next_request_id(self) -> str:
        """A fresh /compute request id: ``g0-<pid hex>-<counter hex>``."""
        with self._rid_lock:
            self._rid_counter += 1
            return f"g0-{os.getpid():x}-{self._rid_counter:x}"

    # -- endpoint implementations (transport-independent) ---------------------
    def compute(self, body: bytes, timing_out: Optional[Dict] = None) -> bytes:
        """One wire request -> response bytes. ``timing_out`` is filled with
        the per-request phase times (decode/queue/compute/encode/wall ms)."""
        t0 = time.perf_counter()
        self.metrics.inc("compute_requests")
        req = WireRequest()
        req.decode(body)
        t_dec = time.perf_counter()
        self.metrics.decode_latency.observe(t_dec - t0)
        # explicit client taps when given; else the primary policy
        taps = req.taps if req.taps is not None else "primary"
        fut = self.batcher.submit(req.graph, taps=taps)
        try:
            outputs = fut.result(timeout=self.compute_timeout_s)
        except concurrent.futures.TimeoutError:
            raise ComputeTimeout(
                f"compute exceeded {self.compute_timeout_s}s "
                "(device wedged or overloaded)") from None
        t_enc = time.perf_counter()
        raw = WireResponse(outputs).encode(dtype=req.resp_dtype)
        t_done = time.perf_counter()
        self.metrics.encode_latency.observe(t_done - t_enc)
        self.metrics.inc("response_bytes", len(raw))
        self.metrics.wire_latency.observe(t_done - t0)
        if timing_out is not None:
            timing_out.update(getattr(fut, "ivt_timing", {}))
            timing_out.update({
                "decode_ms": round((t_dec - t0) * 1e3, 2),
                "encode_ms": round((t_done - t_enc) * 1e3, 2),
                "wall_ms": round((t_done - t0) * 1e3, 2),
            })
        return raw

    def profile(self, body: bytes, iters: int = 1, top: int = 20) -> Dict:
        """Device-time profile of ONE wire request (``POST /profile``).

        The request runs once untraced (first-run builds, allocator
        growth and the capture stay out of the window; on a card the traced
        runs replay the captured graph), then ``iters`` times under
        ``torch.profiler``, bypassing the batcher: a trace mixing other
        sessions' groups would not attribute (their kernels still land in
        the window if they run meanwhile: profile a quiet server). Returns
        the wall time and, on a CUDA device, the device kernels by CUDA
        time (``key_averages``): ``total_device_us`` and the ``top`` kernels
        in ``top_ops_us``. One capture at a time (``ProfileBusy``)."""
        req = WireRequest()
        req.decode(body)
        taps = req.taps if req.taps is not None else "primary"
        if not self._profile_lock.acquire(blocking=False):
            raise ProfileBusy("a profile capture is already in progress")
        try:
            iters = max(1, iters)
            self.executor.run(req.graph, taps=taps)
            cuda = self.executor.device.type == "cuda"
            window = (torch_profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                      if cuda else contextlib.nullcontext())
            with window as prof:
                t0 = time.perf_counter()
                for _ in range(iters):
                    self.executor.run(req.graph, taps=taps)
                wall = time.perf_counter() - t0
            kernels = sorted(
                ((e.self_device_time_total, e.key)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and e.self_device_time_total > 0
                 # the executor's node ranges (utils/tracing) are no kernels
                 and not getattr(e, "is_user_annotation", False)),
                reverse=True) \
                if cuda else []
        finally:
            self._profile_lock.release()
        return {
            "iters": iters,
            "wall_ms": round(wall * 1e3, 3),
            "total_device_us": round(sum(t for t, _ in kernels), 3),
            "top_ops_us": {name: round(t, 3) for t, name in kernels[:top]},
            "note": ("device kernels by CUDA time (torch.profiler); "
                     "summed over iters" if cuda else
                     "CPU device: wall time only"),
        }

    def debug_eval(self, body: bytes) -> Dict:
        """Per-node evaluation of one wire request (``POST /debug_eval``):
        each node's steady-state time, its output shapes, and fault
        isolation (a failing node's descendants report "eval error
        upstream"); ``Executor.run_timed_eager``."""
        req = WireRequest()
        req.decode(body)
        timings, shapes, errors = self.executor.run_timed_eager(req.graph)
        return {
            "timings_ms": {str(k): round(v, 3) for k, v in timings.items()},
            "output_shapes": {str(k): v for k, v in shapes.items()},
            "errors": {str(k): v for k, v in errors.items()},
        }

    def save_graph(self, name: str, body: bytes) -> Dict:
        """Persist a graph JSON to the library (``POST /save_graph/``);
        ``.json`` is appended when missing."""
        if not name.endswith(".json"):
            name += ".json"
        self.graphs.save(name, json.loads(body.decode()))
        return {"saved": name}

    def description(self, name: str, params: Dict[str, str]) -> Dict:
        return self.reg.get_node(name).io(params)

    def contents(self, name: str, params: Dict[str, str]) -> str:
        return self.reg.get_node(name).contents(params)

    def descriptions(self, names) -> Dict[str, Dict]:
        out = {}
        for name in names:
            try:
                kind = self.reg.get_node(name)
                out[name] = {"io": kind.io({}), "contents": kind.contents({})}
            except Exception as e:  # noqa: BLE001 -- isolate bad entries
                out[name] = {"error": str(e)}
        return out

    def list_graphs(self):
        return self.graphs.list()

    def health(self, timeout_s: float = 5.0) -> Dict:
        """Device liveness: a tiny op on the serving device, with a deadline.
        One probe thread for the process; while a probe is stuck, report
        failure at once instead of queueing more."""
        dev = self.executor.device

        def probe():
            x = torch.ones((8, 8), device=dev) @ torch.ones((8, 8), device=dev)
            float(x[0, 0])  # waits for the device
            return str(dev) if dev.type != "cuda" else \
                f"{dev} ({torch.cuda.get_device_name(dev)})"

        if self._health_fut is not None and not self._health_fut.done():
            return {"ok": False, "error": "previous device probe still "
                                          "outstanding (device wedged?)"}
        t0 = time.perf_counter()
        self._health_fut = fut = self._health_pool.submit(probe)
        try:
            device = fut.result(timeout=timeout_s)
        except concurrent.futures.TimeoutError:
            return {"ok": False, "error": f"device probe exceeded {timeout_s}s"}
        except Exception as e:  # noqa: BLE001 -- reported, not raised
            return {"ok": False, "error": str(e)}
        return {"ok": True, "device": device,
                "latency_ms": round((time.perf_counter() - t0) * 1e3, 2)}

    def close(self) -> None:
        """Stop the batcher and the health-probe thread."""
        self.batcher.stop()
        self._health_pool.shutdown(wait=False)

    # -- HTTP plumbing ----------------------------------------------------------
    def make_handler(self):
        app = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            _rid: Optional[str] = None  # this request's /compute id

            def log_message(self, fmt, *args):  # route through logging
                logger.debug("%s " + fmt, self.client_address[0], *args)

            def _send(self, code: int, body: bytes, ctype: str,
                      headers: Optional[Dict[str, str]] = None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if self._rid:
                    # correlates a client's observation with the server
                    # log; the error body stays untouched
                    self.send_header("X-IVT-Request-Id", self._rid)
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code: int = 200) -> None:
                self._send(code, json.dumps(obj).encode(), "application/json")

            def _bad(self, message: str) -> None:
                app.metrics.inc("errors")
                self._send(400, message.encode(), "text/plain")

            def do_GET(self):  # noqa: N802 -- http.server API
                # a handler serves every request of a keep-alive
                # connection: a stale id would be echoed on the next one
                self._rid = None
                try:
                    url = urlparse(self.path)
                    path = unquote(url.path)
                    qs = {k: v[0] for k, v in parse_qs(url.query).items()}
                    if path in ("/", "/index.html"):
                        self._serve_frontend("index.html")
                    elif path == "/list_graphs":
                        self._json(app.list_graphs())
                    elif path.startswith("/load_graph/"):
                        self._send(200, app.graphs.load_bytes(
                            path[len("/load_graph/"):]), "application/json")
                    elif path.startswith("/description/"):
                        self._json(app.description(
                            path[len("/description/"):], qs))
                    elif path.startswith("/contents/"):
                        self._send(200, app.contents(
                            path[len("/contents/"):], qs).encode(),
                            "text/html")
                    elif path == "/descriptions":
                        names = [n for n in qs.get("names", "").split(",")
                                 if n]
                        self._json(app.descriptions(names))
                    elif path == "/metrics":
                        snap = app.metrics.snapshot()
                        snap["pid"] = os.getpid()
                        snap["device"] = str(app.executor.device)
                        self._json(snap)
                    elif path == "/health":
                        h = app.health()
                        self._json(h, code=200 if h["ok"] else 503)
                    elif path.startswith("/static/"):
                        self._serve_frontend(path[len("/static/"):])
                    else:
                        self._send(404, b"not found", "text/plain")
                except Exception as e:  # noqa: BLE001 -- 400 contract
                    logger.exception("GET %s failed", self.path)
                    self._bad(str(e))

            def do_POST(self):  # noqa: N802
                self._rid = None
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(length)
                    url = urlparse(self.path)
                    path = unquote(url.path)
                    qs = {k: v[0] for k, v in parse_qs(url.query).items()}
                    if path == "/compute":
                        self._rid = app.next_request_id()
                        timing: Dict = {}
                        raw = app.compute(body, timing_out=timing)
                        header = ";".join(f"{k.removesuffix('_ms')}={v}"
                                          for k, v in sorted(timing.items()))
                        self._send(200, raw, "application/octet-stream",
                                   {"X-IVT-Timing": header})
                    elif path == "/profile":
                        self._json(app.profile(
                            body, iters=int(qs.get("iters", 1)),
                            top=int(qs.get("top", 20))))
                    elif path == "/debug_eval":
                        self._json(app.debug_eval(body))
                    elif path.startswith("/save_graph/"):
                        self._json(app.save_graph(
                            path[len("/save_graph/"):], body))
                    else:
                        self._send(404, b"not found", "text/plain")
                except ComputeTimeout as e:
                    app.metrics.inc("errors")
                    logger.error("POST %s (rid=%s) timed out: %s", self.path,
                                 self._rid, e)
                    self._send(503, str(e).encode(), "text/plain")
                except ProfileBusy as e:
                    self._send(409, str(e).encode(), "text/plain")
                except Exception as e:  # noqa: BLE001 -- 400 contract
                    logger.exception("POST %s (rid=%s) failed", self.path,
                                     self._rid)
                    self._bad(str(e))

            def _serve_frontend(self, rel: str) -> None:
                if app.frontend_dir is None:
                    self._send(200, b"<html><body>interactive_vit_tpu_torch "
                               b"server (no frontend bundled)</body></html>",
                               "text/html")
                    return
                # traversal guard: resolve, then require containment
                root = os.path.realpath(app.frontend_dir)
                full = os.path.realpath(os.path.join(root, rel.lstrip("/\\")))
                if not full.startswith(root + os.sep):
                    raise FileNotFoundError(rel)
                with open(full, "rb") as f:
                    data = f.read()
                self._send(200, data, _MIME.get(os.path.splitext(full)[1],
                                                "application/octet-stream"))

        return Handler

    def serve(self, host: str = "127.0.0.1", port: int = 8000,
              background: bool = False) -> ThreadingHTTPServer:
        """Serve HTTP on host:port (port 0 picks a free one). With
        ``background=True`` the accept loop runs on a daemon thread and the
        server is returned; stop it with ``shutdown()`` and ``close()``."""
        self.batcher.start()
        httpd = ThreadingHTTPServer((host, port), self.make_handler())
        if background:
            threading.Thread(target=httpd.serve_forever, daemon=True,
                             name="ivt-http").start()
        else:
            logger.info("serving on %s:%d", host, httpd.server_address[1])
            httpd.serve_forever()
        return httpd
