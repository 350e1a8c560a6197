"""Serve-from-artifact: the reference HTTP surface over an exported graph.

Counterpart of ``interactive_vit_tpu/serving/export_app.py``. ``python -m
interactive_vit_tpu_torch.serving.server --from-export <dir>`` boots this
app instead of the live one: NO node registry, NO model code, NO plugin
code, only the artifact (program, captures and manifest,
``graph/export.py``) and the custom ops of ``ops/custom_ops.py`` that its
program calls. Copy a directory, run one process, get the same endpoints.

What a fixed program CAN serve:
- ``/compute`` requests whose graph matches the exported one (same nodes,
  wiring, input shapes, static params). The tap set may be any subset of
  the exported taps.
- Interactive edits of the verified dynamic params (cos A / b, the noise
  seed, the saliency / attrib class, the conv2d matrix, ...): their values
  ride as runtime captures, as in the live executor, so an edit captures
  nothing new. A request's edits are a per-call overlay of the artifact's
  captures, applied and undone under the artifact's lock, so concurrent
  edits do not race.
- ``/description`` and ``/contents`` from the manifest's metadata;
  ``/list_graphs`` / ``/load_graph`` serve the client graph JSON that the
  exporter embedded. ``/save_graph`` answers 400: the deployment is
  read-only.

Anything else (a new topology, other shapes, a changed STATIC param, which
would need a new export) is a 400 naming the offending node in the ``node
<i> (...)`` form the client UI parses. Each ``/compute`` response carries
``X-IVT-Request-Id`` and the ``X-IVT-Timing`` phases.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, unquote, urlparse

import numpy as np

from interactive_vit_tpu_torch.graph.export import (
    ExportedGraph, ExportError, parse_editable,
)
from interactive_vit_tpu_torch.serving.metrics import Metrics
from interactive_vit_tpu_torch.wire.codec import (
    Request as WireRequest, Response as WireResponse, WireError,
)

logger = logging.getLogger(__name__)

# per-process /compute ids (X-IVT-Request-Id): correlate client-observed
# responses with server log lines, same contract as the live app
_RID = itertools.count(1)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class MatchError(Exception):
    """Request does not fit the exported program (→ HTTP 400)."""


def _params_equal(a: Optional[str], b: Optional[str]) -> bool:
    """Semantic param comparison: the same saved graph reaches the
    server with two spellings — ``wire/schema.graph_from_json`` folds
    instance fields with default json.dumps separators, the frontend's
    wireSpec uses compact JSON.stringify. Node kinds json.loads either;
    so must the match."""
    if a == b:
        return True
    if a is None or b is None:
        return False
    try:
        return json.loads(a) == json.loads(b)
    except Exception:  # noqa: BLE001 — non-JSON params compare as text
        return False


class _View:
    """One acceptable request shape over the exported graph.

    Artifacts are exported from SAVED graphs, which include source
    (img_src) and viewer (img_view, ...) nodes; the frontend strips
    those from requests (sources become shipped tensors, viewer edges
    become taps — frontend/js/partition.js planRequest). The identity
    view matches the exported graph verbatim (ivt-run-exported style
    callers); the client view matches what the browser actually ships.
    """

    def __init__(self, exp_nodes, keep, graph_edges, input_specs):
        from interactive_vit_tpu_torch.wire.partition import (
            SOURCE_KINDS, VIEWER_KINDS,
        )

        self.exp_of = [i for i in range(len(exp_nodes)) if keep[i]]
        view_of = {e: v for v, e in enumerate(self.exp_of)}
        self.nodes = [exp_nodes[i] for i in self.exp_of]
        self.edges = set()
        # per manifest input: the (view node, channel) bindings a request
        # may feed this program input through
        self.input_bindings = []
        src_consumers: Dict[int, list] = {}
        for s, sch, d, dch in graph_edges:
            if keep[s] and keep[d]:
                self.edges.add((view_of[s], sch, view_of[d], dch))
            elif (not keep[s]) and keep[d] \
                    and exp_nodes[s]["name"] in SOURCE_KINDS:
                src_consumers.setdefault(s, []).append(
                    (view_of[d], dch))
        for spec in input_specs:
            if keep[spec["node"]]:
                self.input_bindings.append(
                    [(view_of[spec["node"]], spec["channel"])])
            else:
                binds = src_consumers.get(spec["node"], [])
                if not binds:
                    raise ExportError(
                        f"input at node {spec['node']} "
                        f"({spec['name']}) has no in-view consumer")
                self.input_bindings.append(binds)

    def exp_index(self, view_index: int) -> int:
        return self.exp_of[view_index]


class ExportApp:
    """The six-endpoint server over one loaded artifact."""

    def __init__(self, artifact_dir: str,
                 frontend_dir: Optional[str] = None):
        t0 = time.perf_counter()
        self.art = ExportedGraph(artifact_dir)
        self.boot_load_s = time.perf_counter() - t0
        self.artifact_dir = artifact_dir
        self.frontend_dir = frontend_dir
        if frontend_dir is None:
            cand = os.path.join(_REPO_ROOT, "frontend")
            self.frontend_dir = cand if os.path.isdir(cand) else None
        self.metrics = Metrics()
        m = self.art.manifest
        self.graph_nodes = m.get("graph_nodes") or []
        self.graph_edges = {tuple(e) for e in m.get("graph_edges") or []}
        self.dynamic = {int(i): set(v)
                        for i, v in (m.get("dynamic_params") or {}).items()}
        self.editable = {int(i): dict(v)
                         for i, v in (m.get("editable") or {}).items()}
        self.node_io = m.get("node_io") or {}
        self.node_meta = m.get("node_meta") or []
        self.out_keys = set(self.art.out_keys)
        if not self.graph_nodes:
            raise ExportError(
                f"{artifact_dir}: manifest has no serving metadata "
                f"(graph_nodes) — re-export with this build")
        name = (m.get("provenance") or {}).get("graph") or "exported.json"
        self.graph_name = name if name.endswith(".json") else name + ".json"

        from interactive_vit_tpu_torch.wire.partition import (
            SOURCE_KINDS, VIEWER_KINDS,
        )

        edges4 = sorted(self.graph_edges)
        specs = m["inputs"]
        identity = _View(self.graph_nodes,
                         [True] * len(self.graph_nodes), edges4, specs)
        self.views = [identity]
        keep = [n["name"] not in SOURCE_KINDS
                and n["name"] not in VIEWER_KINDS
                for n in self.graph_nodes]
        if not all(keep):
            # best-effort: a saved graph can have a source feeding ONLY
            # viewer nodes (an img_src -> img_view preview branch beside
            # the model chain); that input has no in-view consumer and
            # the client view is unconstructable. The identity view is
            # still perfectly servable — log and serve it alone instead
            # of refusing to boot.
            try:
                self.views.append(
                    _View(self.graph_nodes, keep, edges4, specs))
            except ExportError as e:
                logger.warning(
                    "%s: client view unavailable (%s); serving the "
                    "identity view only", artifact_dir, e)

    # -- request matching -----------------------------------------------------

    def _pick_view(self, g) -> _View:
        for v in self.views:
            if len(g.nodes) == len(v.nodes) and all(
                    n.name == meta["name"]
                    for n, meta in zip(g.nodes, v.nodes)):
                return v
        shapes = " or ".join(
            "[" + ", ".join(m["name"] for m in v.nodes) + "]"
            for v in self.views)
        raise MatchError(
            f"this deployment serves a fixed program; request nodes "
            f"[{', '.join(n.name for n in g.nodes)}] do not match "
            f"{shapes}")

    def _match(self, req: WireRequest):
        """Validate the request against the exported shape; return
        (ordered input arrays, per-request caps or None, requested
        (view_index, exp_index, channel) out keys)."""
        g = req.graph
        view = self._pick_view(g)
        overlay: Dict[str, Dict[str, np.ndarray]] = {}
        for n, meta in zip(g.nodes, view.nodes):
            exp_i = view.exp_index(n.index)
            dyn = self.dynamic.get(exp_i, set())
            exp_params = meta["params"]
            static_mismatch = sorted(
                k for k in (set(n.params) | set(exp_params)) - dyn
                if not _params_equal(n.params.get(k), exp_params.get(k)))
            if static_mismatch:
                raise MatchError(
                    f"node {n.index} ({n.name}): static param(s) "
                    f"{static_mismatch} differ from the exported program "
                    f"(re-export to change them)")
            edits = {k for k in dyn
                     if not _params_equal(n.params.get(k),
                                          exp_params.get(k))}
            if not edits:
                continue
            modes = self.editable.get(exp_i, {})
            blocked = sorted(edits - set(modes))
            if blocked:
                raise MatchError(
                    f"node {n.index} ({n.name}): dynamic param(s) "
                    f"{blocked} are not editable in this artifact")
            caps = self.art.caps.get(str(exp_i))
            new = dict(caps)
            for k in edits:
                try:
                    new[k] = parse_editable(
                        modes[k], n.params[k], caps[k])
                except Exception as err:  # noqa: BLE001
                    raise MatchError(
                        f"node {n.index} ({n.name}): bad value for "
                        f"{k!r}: {err}") from err
            overlay[str(exp_i)] = new

        edges = set()
        for n in g.nodes:
            for ch, e in n.inputs.items():
                if e.src is not None:
                    edges.add((e.src.node.index, e.src.channel,
                               n.index, ch))
        if edges != view.edges:
            extra = sorted(edges - view.edges)
            missing = sorted(view.edges - edges)
            raise MatchError(
                f"wiring differs from the exported program "
                f"(extra: {extra}, missing: {missing})")

        fed = {}
        for n, ch, e in g.input_edges():
            fed[(n.index, ch)] = np.asarray(e.tensor)
        inputs = []
        for spec, binds in zip(self.art.input_specs,
                               view.input_bindings):
            arr = None
            for b in binds:
                got = fed.pop(b, None)
                if got is not None and arr is None:
                    arr = got
            if arr is None:
                raise MatchError(
                    f"node {spec['node']} ({spec['name']}): missing "
                    f"input tensor on {spec['channel']!r}")
            want = spec["shape"]
            if (list(arr.shape) != want and want
                    and want[0] == 1 and list(arr.shape) == want[1:]):
                arr = arr[None]  # unbatched client tensor, batch-1 program
            if list(arr.shape) != want:
                raise MatchError(
                    f"node {spec['node']} ({spec['name']}): input shape "
                    f"{list(arr.shape)} != exported {want}")
            inputs.append(arr)  # the artifact casts to spec["dtype"]
        if fed:
            raise MatchError(
                f"unexpected input tensors on {sorted(fed)}")

        exp_of_view = {v: e for v, e in enumerate(view.exp_of)}
        if req.taps is None:
            view_of_exp = {e: v for v, e in exp_of_view.items()}
            want_keys = [(view_of_exp[i], i, ch)
                         for i, ch in self.art.out_keys
                         if i in view_of_exp]
        else:
            want_keys = []
            for i, ch in req.taps:
                i = int(i)
                if i not in exp_of_view or (
                        exp_of_view[i], ch) not in self.out_keys:
                    raise MatchError(
                        f"tap ({i}, {ch!r}) was not exported; this "
                        f"artifact serves {sorted(self.out_keys)}")
                want_keys.append((i, exp_of_view[i], ch))
        caps = None
        if overlay:
            caps = dict(self.art.caps)
            caps.update(overlay)
        return inputs, caps, want_keys

    # -- endpoints -------------------------------------------------------------

    def run_request(self, req: WireRequest) -> Dict[int, Dict[str, Any]]:
        """Match + execute one decoded request; outputs remapped onto
        the REQUEST's node indices, only the requested taps delivered."""
        inputs, caps, want_keys = self._match(req)
        # the artifact serializes its calls; only the requested taps are
        # copied to the host (the frozen program computes every output)
        outs = self.art(*inputs, caps=caps,
                        want={(e, ch) for _v, e, ch in want_keys})
        routed: Dict[int, Dict[str, Any]] = {}
        for view_i, exp_i, ch in want_keys:
            v = outs.get(exp_i, {}).get(ch)
            if v is not None:
                routed.setdefault(view_i, {})[ch] = v
        return routed

    def compute(self, body: bytes,
                timing_out: Optional[Dict] = None) -> bytes:
        t0 = time.perf_counter()
        self.metrics.inc("compute_requests")
        req = WireRequest()
        req.decode(body)
        t_dec = time.perf_counter()
        routed = self.run_request(req)
        t_run = time.perf_counter()
        raw = WireResponse(routed).encode(dtype=req.resp_dtype)
        t_done = time.perf_counter()
        self.metrics.request_latency.observe(t_done - t0)
        self.metrics.inc("response_bytes", len(raw))
        if timing_out is not None:
            # same phase-attribution contract as the live app's
            # X-IVT-Timing (no batcher here: compute = match + device)
            timing_out.update({
                "decode_ms": round((t_dec - t0) * 1e3, 2),
                "compute_ms": round((t_run - t_dec) * 1e3, 2),
                "encode_ms": round((t_done - t_run) * 1e3, 2),
                "wall_ms": round((t_done - t0) * 1e3, 2),
            })
        return raw

    def _meta_for(self, name: str, params: Optional[Dict] = None):
        """Params-aware metadata lookup: contents/io are rendered from
        each node's own params at export (a slice node shows ITS spec),
        so the frontend's ``?{params}`` query selects the matching
        exported node; falls back to the first same-name node."""
        if params:
            for meta in self.node_meta:
                if meta["name"] != name:
                    continue
                keys = set(meta["params"]) | set(params)
                if all(_params_equal(meta["params"].get(k),
                                     params.get(k)) for k in keys):
                    return meta
        for meta in self.node_meta:
            if meta["name"] == name:
                return meta
        return self.node_io.get(name)  # pre-node_meta artifacts

    def description(self, name: str,
                    params: Optional[Dict] = None) -> Dict:
        meta = self._meta_for(name, params)
        if meta is None:
            raise MatchError(f"unknown node kind {name!r} (artifact "
                             f"serves {sorted(self.node_io)})")
        return meta["io"]

    def contents(self, name: str, params: Optional[Dict] = None) -> str:
        meta = self._meta_for(name, params)
        if meta is None:
            raise MatchError(f"unknown node kind {name!r}")
        return meta.get("contents", "")

    def descriptions(self, names) -> Dict[str, Dict]:
        out = {}
        for name in names:
            meta = self.node_io.get(name)
            if meta is not None:
                out[name] = {"io": meta["io"],
                             "contents": meta.get("contents", "")}
        return out

    def list_graphs(self):
        m = self.art.manifest
        return [self.graph_name] if m.get("client_graph") else []

    def load_graph(self, name: str) -> bytes:
        m = self.art.manifest
        if name != self.graph_name or not m.get("client_graph"):
            raise FileNotFoundError(f"no saved graph {name!r}")
        return json.dumps(m["client_graph"]).encode()

    def health(self) -> Dict[str, Any]:
        return {"ok": True, "mode": "from-export",
                "artifact": self.artifact_dir,
                "outputs": len(self.out_keys),
                "boot_load_s": round(self.boot_load_s, 3)}

    # -- HTTP ------------------------------------------------------------------

    def make_handler(self):
        app = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                logger.debug("%s " + fmt, self.client_address[0], *args)

            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                rid = getattr(self, "_rid", None)
                if rid:
                    self.send_header("X-IVT-Request-Id", rid)
                timing = getattr(self, "_timing", None)
                if timing:
                    self.send_header("X-IVT-Timing", timing)
                    self._timing = None
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code=200):
                self._send(code, json.dumps(obj).encode(),
                           "application/json")

            def _bad(self, message):
                app.metrics.inc("errors")
                self._send(400, message.encode(), "text/plain")

            def do_GET(self):  # noqa: N802
                # handler instances persist across a keep-alive
                # connection's requests; reset so only /compute
                # responses carry an id
                self._rid = None
                self._timing = None
                try:
                    url = urlparse(self.path)
                    path = unquote(url.path)
                    if path in ("/", "/index.html"):
                        self._frontend("index.html")
                    elif path == "/list_graphs":
                        self._json(app.list_graphs())
                    elif path.startswith("/load_graph/"):
                        self._send(200, app.load_graph(
                            path[len("/load_graph/"):]),
                            "application/json")
                    elif path.startswith("/description/"):
                        qs = {k: v[0]
                              for k, v in parse_qs(url.query).items()}
                        self._json(app.description(
                            path[len("/description/"):], qs))
                    elif path.startswith("/contents/"):
                        qs = {k: v[0]
                              for k, v in parse_qs(url.query).items()}
                        self._send(200, app.contents(
                            path[len("/contents/"):], qs).encode(),
                            "text/html")
                    elif path == "/descriptions":
                        qs = {k: v[0]
                              for k, v in parse_qs(url.query).items()}
                        names = [n for n in
                                 qs.get("names", "").split(",") if n]
                        self._json(app.descriptions(names))
                    elif path == "/metrics":
                        snap = app.metrics.snapshot()
                        snap["mode"] = "from-export"
                        self._json(snap)
                    elif path == "/health":
                        self._json(app.health())
                    elif path.startswith("/static/"):
                        self._frontend(path[len("/static/"):])
                    else:
                        self._send(404, b"not found", "text/plain")
                except FileNotFoundError as e:
                    self._bad(str(e))
                except Exception as e:  # noqa: BLE001 — 400 contract
                    logger.exception("GET %s failed", self.path)
                    self._bad(str(e))

            def do_POST(self):  # noqa: N802
                self._rid = None
                self._timing = None
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(length)
                    path = unquote(urlparse(self.path).path)
                    if path.startswith("/save_graph/"):
                        # the frontend's "Save to server" tool: a frozen
                        # deployment has no graph library to write —
                        # answer with a clear 400, not a confusing 404
                        self._bad("this is a read-only from-export "
                                  "deployment; save the graph locally "
                                  "(download) or use a live server")
                        return
                    if path == "/compute":
                        self._rid = f"x-{os.getpid():x}-{next(_RID):x}"
                        t0 = time.perf_counter()
                        timing: Dict = {}
                        raw = app.compute(body, timing_out=timing)
                        logger.info(
                            "rid=%s compute ok in %.1fms (%d B out)",
                            self._rid,
                            (time.perf_counter() - t0) * 1e3, len(raw))
                        self._timing = ";".join(
                            f"{k.removesuffix('_ms')}={v}"
                            for k, v in sorted(timing.items()))
                        self._send(200, raw,
                                   "application/octet-stream")
                    else:
                        self._send(404, b"not found", "text/plain")
                except (MatchError, WireError, ExportError) as e:
                    self._bad(str(e))
                except Exception as e:  # noqa: BLE001
                    logger.exception("POST %s failed", self.path)
                    self._bad(str(e))

            def _frontend(self, rel):
                if app.frontend_dir is None:
                    self._send(200, b"<html><body>serve-from-export "
                               b"(no frontend bundled)</body></html>",
                               "text/html")
                    return
                root = os.path.realpath(app.frontend_dir)
                full = os.path.realpath(
                    os.path.join(root, rel.lstrip("/\\")))
                if not full.startswith(root + os.sep):
                    raise FileNotFoundError(rel)
                with open(full, "rb") as f:
                    data = f.read()
                ctype = {"html": "text/html", "js": "text/javascript",
                         "mjs": "text/javascript", "css": "text/css",
                         "json": "application/json"}.get(
                    full.rsplit(".", 1)[-1], "application/octet-stream")
                self._send(200, data, ctype)

        return Handler

    def serve(self, host: str = "127.0.0.1", port: int = 8000,
              background: bool = False) -> ThreadingHTTPServer:
        httpd = ThreadingHTTPServer((host, port), self.make_handler())
        if background:
            t = threading.Thread(target=httpd.serve_forever, daemon=True)
            t.start()
        else:
            logger.info("serving artifact %s on %s:%d",
                        self.artifact_dir, host, port)
            httpd.serve_forever()
        return httpd


class MultiExportApp:
    """Several artifacts behind ONE server: ``--from-export a,b,c``.

    One deployment can host several exported workflows (a classify
    chain, a saliency graph, a second model family) the way the live
    server hosts several registered models. ``/compute`` routes each
    request to the artifact whose exported shape (node-name sequence,
    either view) matches; the metadata endpoints serve the union
    (first artifact wins on a node-kind collision, mirroring the live
    registry's scan order). Duck-types ``ExportApp``'s endpoint surface
    so the HTTP handler is shared verbatim.
    """

    def __init__(self, dirs, frontend_dir: Optional[str] = None):
        dirs = [d for d in dirs if d]
        if not dirs:
            raise ExportError("--from-export got no artifact dirs")
        self.units = [ExportApp(d, frontend_dir=frontend_dir)
                      for d in dirs]
        self.frontend_dir = self.units[0].frontend_dir
        self.metrics = Metrics()
        self.boot_load_s = sum(u.boot_load_s for u in self.units)
        self.artifact_dir = ",".join(u.artifact_dir for u in self.units)

    def compute(self, body: bytes,
                timing_out: Optional[Dict] = None) -> bytes:
        t0 = time.perf_counter()
        self.metrics.inc("compute_requests")
        req = WireRequest()
        req.decode(body)
        t_dec = time.perf_counter()
        # route by FULL match, not just the node-name sequence: two
        # artifacts can share names but differ in shapes/static params
        # (the same workflow exported at batch 1 and batch 8) — a
        # name-only router would make the second permanently
        # unreachable. A shape-matching unit whose params/wiring check
        # fails yields the most specific error if nothing else serves.
        shape_errs: list = []
        match_errs: list = []
        routed = None
        for u in self.units:
            try:
                u._pick_view(req.graph)
            except MatchError as e:
                shape_errs.append(str(e))
                continue
            try:
                routed = u.run_request(req)
                break
            except MatchError as e:
                match_errs.append(str(e))
        if routed is None:
            if match_errs:
                raise MatchError(match_errs[0])
            raise MatchError(
                "no artifact matches this request; per-artifact: "
                + " | ".join(e.split(";")[0] for e in shape_errs))
        t_run = time.perf_counter()
        raw = WireResponse(routed).encode(dtype=req.resp_dtype)
        t_done = time.perf_counter()
        self.metrics.request_latency.observe(t_done - t0)
        self.metrics.inc("response_bytes", len(raw))
        if timing_out is not None:
            timing_out.update({
                "decode_ms": round((t_dec - t0) * 1e3, 2),
                "compute_ms": round((t_run - t_dec) * 1e3, 2),
                "encode_ms": round((t_done - t_run) * 1e3, 2),
                "wall_ms": round((t_done - t0) * 1e3, 2),
            })
        return raw

    def description(self, name: str,
                    params: Optional[Dict] = None) -> Dict:
        for u in self.units:
            if u._meta_for(name, params) is not None:
                return u.description(name, params)
        raise MatchError(
            f"unknown node kind {name!r} (artifacts serve "
            f"{sorted(set().union(*(u.node_io for u in self.units)))})")

    def contents(self, name: str, params: Optional[Dict] = None) -> str:
        for u in self.units:
            if u._meta_for(name, params) is not None:
                return u.contents(name, params)
        raise MatchError(f"unknown node kind {name!r}")

    def descriptions(self, names) -> Dict[str, Dict]:
        out: Dict[str, Dict] = {}
        for u in self.units:
            for k, v in u.descriptions(names).items():
                out.setdefault(k, v)
        return out

    def list_graphs(self):
        seen, out = set(), []
        for u in self.units:
            for g in u.list_graphs():
                if g not in seen:
                    seen.add(g)
                    out.append(g)
        return out

    def load_graph(self, name: str) -> bytes:
        for u in self.units:
            try:
                return u.load_graph(name)
            except FileNotFoundError:
                continue
        raise FileNotFoundError(f"no saved graph {name!r}")

    def health(self) -> Dict[str, Any]:
        return {"ok": True, "mode": "from-export",
                "artifacts": [u.health() for u in self.units],
                "boot_load_s": round(self.boot_load_s, 3)}

    # the HTTP tier is identical — bind ExportApp's handler/serve
    # directly (they touch only the duck-typed surface above)
    make_handler = ExportApp.make_handler
    serve = ExportApp.serve
