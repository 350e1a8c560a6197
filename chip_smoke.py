"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``interactive_vit_tpu_torch`` through its main path and fails
(non-zero exit, no result line) on the first phase that goes wrong:

1. device  -- a CUDA card must be present; TF32 is turned off; prints the
   card's name and power limit as ``nvidia-smi`` reports them.
2. build   -- builds the hand-written kernel from ``csrc/`` with nvcc.
3. kernel  -- the fused attention-block kernel against its plain PyTorch
   version on the card, at the vit_b16 (B=1 and 8) and vit_t16 block
   shapes, bf16 and f32, maps off / maps + head-mean / a head subset;
   prints max abs errors against the stated bounds and CUDA-event times.
4. slice   -- the HTTP server in-process (vit_b16 and vit_t16, bf16,
   seeded random weights, the saved graphs copied to a temp dir): POST
   /compute with ``static/graphs/vit_b16.json``, a seeded 224x224 image and
   ``attn`` + ``r`` taps, sequentially and 4 at once; shapes, finiteness,
   probs rows summing to 1, logits and maps against the port's plain path
   on the card, the kernel launch count; then one f32 request whose logits
   must match the plain path at 1e-4.
5. result  -- a JSON line describing the kernel, then the final line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX. Weights are random (seeded), so the logits are
meaningless as classifications; what is checked is that the served path
and the plain path agree.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "interactive_vit_tpu_torch/csrc/fused_attn_block.cu"
KERNEL_REPLACES = "interactive_vit_tpu/ops/fused_block.py:205"

# Bounds of the kernel against its plain version (same inputs, same cast
# points; only the order of f32 sums differs). f32: 1e-4 absolute. bf16
# keeps 8 significant bits: a sum that lands within its f32 rounding error
# of a bf16 rounding boundary rounds to the neighbour, one ulp (2^-8
# relative) in a qkv, head-output or y element. Allow a few ulps at the top
# of each tensor's range: y 2^-6 of its scale, probs/mean 2^-7 (in [0, 1]).
F32_BOUND = 1e-4
BF16_Y_REL = 2.0 ** -6
BF16_P_BOUND = 2.0 ** -7
# The served bf16 path against the plain path through all 12 blocks: the
# rare one-ulp flips above enter the residual stream and propagate through
# later blocks, so the bound is set on the whole network's scale: logits
# within 2^-4 of their scale, maps within 2^-5 (they lie in [0, 1]).
SLICE_LOGITS_REL = 2.0 ** -4
SLICE_MAPS_BOUND = 2.0 ** -5
# bf16 probs rows: each of N probs rounds by <= 2^-9 relative, so a row
# sums to 1 within 2^-9; bound 2^-7.
ROW_SUM_BOUND = 2.0 ** -7

TAPPED_BLOCKS = (0, 5, 11)
MAIN_MODEL, OTHER_MODEL = "vit_b16", "vit_t16"  # BASELINE configs 2 and 1


def log(msg: str) -> None:
    print(msg, flush=True)


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` on the card from CUDA events, after a warm-up
    and a synchronize."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_block(d: int, dtype, device, seed: int):
    """One block's attention parameters with non-trivial LN and biases."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=g) * std + mean).to(
            device=device, dtype=dtype)

    return {
        "ln1_s": rnd(d, std=0.1, mean=1.0), "ln1_b": rnd(d, std=0.1),
        "qkv_w": rnd(d, 3 * d, std=d ** -0.5), "qkv_b": rnd(3 * d, std=0.1),
        "proj_w": rnd(d, d, std=d ** -0.5), "proj_b": rnd(d, std=0.1),
    }


def phase_kernel(device) -> dict:
    """Kernel against plain version; returns the served configuration's
    numbers (vit_b16, bf16, B=1, maps + mean) for the result line."""
    import torch

    from interactive_vit_tpu_torch.ops import fused_block as fb

    served = {}
    for name, b, n, d, heads in (("vit_b16", 1, 197, 768, 12),
                                 ("vit_b16", 8, 197, 768, 12),
                                 ("vit_t16", 1, 197, 192, 3)):
        for dtype in (torch.bfloat16, torch.float32):
            p = random_block(d, dtype, device, seed=b * 100 + d)
            x = torch.randn((b, n, d), generator=torch.Generator()
                            .manual_seed(d + b)).to(device=device, dtype=dtype)
            modes = {
                "maps_off": {},
                "maps_mean": {"want_attn": True, "want_mean": True},
                "subset": {"want_attn": True,
                           "attn_heads": tuple(sorted({0, heads // 2,
                                                       heads - 1}))},
            }
            for mode, kw in modes.items():
                got = fb.fused_attn_block(x, p, heads, 1e-6, **kw)
                ref = fb.fused_attn_block_reference(x, p, heads, 1e-6, **kw)
                torch.cuda.synchronize()
                errs = [max_err(g, r) for g, r in zip(got, ref)
                        if r is not None]  # y[, probs][, mean]
                if dtype == torch.float32:
                    bounds = [F32_BOUND] * len(errs)
                else:
                    y_b = BF16_Y_REL * max(1.0, ref[0].abs().max().item())
                    bounds = [y_b] + [BF16_P_BOUND] * (len(errs) - 1)
                if any(g.shape != r.shape for g, r in zip(got, ref)
                       if r is not None):
                    raise AssertionError(f"{name} {mode}: shape mismatch")
                ok = all(e <= bd for e, bd in zip(errs, bounds))
                dt = str(dtype).replace("torch.", "")
                labels = [lbl for lbl, r in zip(("y", "probs", "mean"), ref)
                          if r is not None]
                line = (f"  kernel {name} B={b} {dt} {mode}: max abs err "
                        + ", ".join(f"{lbl}={e:.3g} (bound {bd:.3g})"
                                    for lbl, e, bd in zip(labels, errs,
                                                          bounds)))
                if mode in ("maps_off", "maps_mean"):
                    # turns: plain, kernel, kernel, plain
                    t_p1 = time_ms(lambda: fb.fused_attn_block_reference(
                        x, p, heads, 1e-6, **kw))
                    t_k1 = time_ms(lambda: fb.fused_attn_block(
                        x, p, heads, 1e-6, **kw))
                    t_k2 = time_ms(lambda: fb.fused_attn_block(
                        x, p, heads, 1e-6, **kw))
                    t_p2 = time_ms(lambda: fb.fused_attn_block_reference(
                        x, p, heads, 1e-6, **kw))
                    t_k, t_p = (t_k1 + t_k2) / 2, (t_p1 + t_p2) / 2
                    line += f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms"
                    if (name, b, dtype, mode) == ("vit_b16", 1, torch.bfloat16,
                                                  "maps_mean"):
                        served = {"max_abs_err": max(errs), "ms": t_k,
                                  "plain_ms": t_p}
                log(line)
                if not ok:
                    raise AssertionError(f"kernel {name} B={b} {dt} {mode} "
                                         f"outside its bounds: {errs} > "
                                         f"{bounds}")
    return served


def chain_request(graph_obj, image, taps):
    """Request bytes for a saved graph with ``image`` bound to node 0 and
    an explicit tap list."""
    from interactive_vit_tpu_torch.wire.codec import (
        REQUEST_MAGIC, Request, decode_message, encode_message,
    )
    from interactive_vit_tpu_torch.wire.schema import graph_from_json

    g = graph_from_json(graph_obj)
    g.add_input(image, g.nodes[0], "o")
    obj, tensors = decode_message(Request.encode(g), expect_magic=REQUEST_MAGIC)
    obj["taps"] = [{"node": i, "channel": ch} for i, ch in taps]
    return encode_message(REQUEST_MAGIC, obj, tensors)


def plain_taps(model, image, device):
    """The port's plain path on ``device`` with the served model's weights:
    the same layer chain with the kernel's plain version in every block.
    Returns (logits, {block: (attn, r)}) for TAPPED_BLOCKS."""
    import torch

    from interactive_vit_tpu_torch.models import vit
    from interactive_vit_tpu_torch.ops.fused_block import (
        fused_attn_block_reference,
    )

    cfg = vit.resolve_variant(model.name)
    x = torch.from_numpy(image).to(device)
    maps = {}
    with torch.inference_mode():
        for name, extra, fn in vit.layer_fns(
                cfg, block_impl=fused_attn_block_reference):
            p = vit.layer_params(model.params, name)
            if extra:
                i = int(name.split(".")[1])
                want = frozenset({"attn", "r"}) if i in TAPPED_BLOCKS \
                    else frozenset()
                out = fn(p, {"o": x}, want=want)
                if want:
                    maps[i] = (out["attn"], out["r"])
            else:
                out = fn(p, {"o": x})
            x = out["o"]
    return x, maps


def post(url: str, body: bytes) -> bytes:
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read()


def serve(models, dtype_name, device, graphs_dir):
    from interactive_vit_tpu_torch.serving.server import build_app

    app = build_app(models=models, graphs_dir=graphs_dir,
                    dtype_name=dtype_name, device=device, seed=0)
    httpd = app.serve("127.0.0.1", 0, background=True)
    return app, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def stop(app, httpd) -> None:
    httpd.shutdown()
    httpd.server_close()
    app.close()


def check_response(raw, variant_cfg, plain, tag, bf16=True):
    """Shapes, finiteness, row sums and agreement with the plain path."""
    from interactive_vit_tpu_torch.wire.codec import Response

    out = Response.decode(raw)
    n, heads = variant_cfg.tokens, variant_cfg.heads
    head_node = 2 + variant_cfg.depth + 1
    logits = out[head_node]["o"]
    if logits.shape != (1, variant_cfg.num_classes):
        raise AssertionError(f"{tag}: logits shape {logits.shape}")
    p_logits, p_maps = plain
    p_logits = p_logits.float().cpu().numpy()
    scale = max(1.0, float(np.abs(p_logits).max()))
    err_logits = float(np.abs(logits - p_logits).max())
    bound = SLICE_LOGITS_REL * scale if bf16 else F32_BOUND
    errs = {"logits": err_logits}
    for i in TAPPED_BLOCKS:
        attn, r = out[2 + i]["attn"], out[2 + i]["r"]
        if attn.shape != (1, heads, n, n) or r.shape != (1, n, n):
            raise AssertionError(f"{tag}: block {i} attn {attn.shape} "
                                 f"r {r.shape}")
        for name, arr in (("attn", attn), ("r", r), ("logits", logits)):
            if not np.isfinite(arr).all():
                raise AssertionError(f"{tag}: non-finite {name}")
        row_err = float(np.abs(attn.sum(-1) - 1.0).max())
        if row_err > ROW_SUM_BOUND:
            raise AssertionError(f"{tag}: block {i} probs rows sum to 1 "
                                 f"within {row_err} > {ROW_SUM_BOUND}")
        pa, pr = (t.float().cpu().numpy() for t in p_maps[i])
        errs[f"attn{i}"] = float(np.abs(attn - pa).max())
        errs[f"r{i}"] = float(np.abs(r - pr).max())
    map_bound = SLICE_MAPS_BOUND if bf16 else F32_BOUND
    bad = {k: v for k, v in errs.items()
           if v > (bound if k == "logits" else map_bound)}
    if bad:
        raise AssertionError(f"{tag}: served vs plain path outside bounds "
                             f"(logits {bound:.3g}, maps {map_bound:.3g}): "
                             f"{bad}")
    return errs


def phase_slice(device, graphs_src: str) -> dict:
    """The served main path (MAIN_MODEL, plus one request to OTHER_MODEL);
    returns the kernel launch count and the p50 request latency."""
    main, other = MAIN_MODEL, OTHER_MODEL
    import torch

    from interactive_vit_tpu_torch.models import vit
    from interactive_vit_tpu_torch.ops import fused_block as fb

    tmp = tempfile.mkdtemp(prefix="ivt_chip_smoke_")
    try:
        graphs_dir = os.path.join(tmp, "graphs")
        shutil.copytree(graphs_src, graphs_dir)
        rng = np.random.default_rng(0)
        images = [rng.random((3, 224, 224), dtype=np.float32)
                  for _ in range(10)]
        variants = list(dict.fromkeys([main, other]))
        app, httpd, url = serve(variants, "bfloat16", device, graphs_dir)
        try:
            graphs = {v: app.graphs.load(v + ".json") for v in variants}
            models = {v: app.reg.get_node(v + ":head").model
                      for v in variants}
            cfgs = {v: vit.resolve_variant(v) for v in variants}

            def taps(cfg):
                return ([(2 + i, ch) for i in TAPPED_BLOCKS
                         for ch in ("attn", "r")]
                        + [(2 + cfg.depth + 1, "o")])

            bodies = [chain_request(graphs[main], im, taps(cfgs[main]))
                      for im in images]
            other_body = chain_request(graphs[other], images[9],
                                       taps(cfgs[other]))
            # the first request warms up allocator and kernel loading
            post(url + "/compute", bodies[0])

            fb.fused_attn_block.launches = 0  # the main path starts here
            served = 0
            lat = []
            raws = []
            for body in bodies[:5]:
                t0 = time.perf_counter()
                raws.append(post(url + "/compute", body))
                lat.append(time.perf_counter() - t0)
                served += 1
            conc = [None] * 4

            def worker(k):
                conc[k] = post(url + "/compute", bodies[5 + k])

            threads = [threading.Thread(target=worker, args=(k,))
                       for k in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            if any(t.is_alive() for t in threads) or any(c is None
                                                         for c in conc):
                raise AssertionError("concurrent requests did not complete")
            served += 4
            other_raw = post(url + "/compute", other_body)
            launches_bf16 = fb.fused_attn_block.launches
            metrics = json.loads(urllib.request.urlopen(
                url + "/metrics", timeout=30).read())
            health = json.loads(urllib.request.urlopen(
                url + "/health", timeout=30).read())
        finally:
            stop(app, httpd)

        want = cfgs[main].depth * served + cfgs[other].depth
        if launches_bf16 < want:
            raise AssertionError(f"kernel launched {launches_bf16} times for "
                                 f"{served} {main} + 1 {other} requests; "
                                 f"expected >= {want}")
        worst = {}
        for k, raw in enumerate(raws + conc):
            errs = check_response(raw, cfgs[main],
                                  plain_taps(models[main], images[k], device),
                                  f"{main} request {k}")
            for key, v in errs.items():
                worst[key] = max(worst.get(key, 0.0), v)
        errs_other = check_response(other_raw, cfgs[other],
                                    plain_taps(models[other], images[9],
                                               device), f"{other} request")
        p50 = float(np.median(lat)) * 1e3
        log(f"  slice bf16: {served} {main} requests (5 sequential, 4 "
            f"concurrent) + 1 {other}; kernel launches {launches_bf16} "
            f"(>= {want}); p50 latency per {main} request {p50:.2f} ms "
            f"(client wall, sequential); health {health['ok']}")
        log("  server p50s (ms, all requests): " + ", ".join(
            f"{k.removesuffix('_p50_ms')} {metrics[k]:.2f}" for k in (
                "wire_p50_ms", "decode_p50_ms", "queue_p50_ms",
                "compute_p50_ms", "encode_p50_ms", "request_p50_ms"))
            + f"; mean batch {metrics['mean_batch_size']:.2f}")
        log("  slice bf16 vs plain path, worst max abs err: "
            + ", ".join(f"{k}={v:.3g}" for k, v in sorted(worst.items()))
            + f"; {other} logits {errs_other['logits']:.3g}")

        # one f32 request: logits must match the plain path at 1e-4
        app, httpd, url = serve([main], "float32", device, graphs_dir)
        try:
            before = fb.fused_attn_block.launches
            raw = post(url + "/compute", bodies[0])
            launches_f32 = fb.fused_attn_block.launches - before
            model = app.reg.get_node(main + ":head").model
        finally:
            stop(app, httpd)
        if launches_f32 < cfgs[main].depth:
            raise AssertionError(f"f32 request launched the kernel "
                                 f"{launches_f32} times; expected >= "
                                 f"{cfgs[main].depth}")
        errs32 = check_response(raw, cfgs[main],
                                plain_taps(model, images[0], device),
                                f"{main} f32 request", bf16=False)
        log(f"  slice f32: 1 {main} request, kernel launches "
            f"{launches_f32}; logits max abs err vs plain "
            f"{errs32['logits']:.3g} (bound {F32_BOUND:g}), maps "
            f"{max(v for k, v in errs32.items() if k != 'logits'):.3g}")
        return {"launches": fb.fused_attn_block.launches, "p50_ms": p50}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "interactive_vit_tpu_torch")):
        raise SystemExit("chip_smoke.py: run it from a checkout of the "
                         "repository (interactive_vit_tpu_torch/ missing)")
    import torch

    from interactive_vit_tpu_torch.ops import fused_block as fb

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; this script runs "
                         "the port on the card and has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    log(f"phase 1 device: {kind}, {torch.cuda.device_count()} visible, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi[0])

    # 2. build
    t0 = time.perf_counter()
    fb.load_kernel()
    log(f"phase 2 build: fused_attn_block built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")

    # 3. kernel against its plain version
    log("phase 3 kernel vs plain version on the card:")
    served = phase_kernel(device)

    # 4. the slice through the server
    log("phase 4 slice through the HTTP server:")
    res = phase_slice(device, os.path.join(HERE, "static", "graphs"))

    # 5. result
    log("phase 5 result: all phases passed")
    print(json.dumps({"kernels": [{
        "name": "fused_attn_block", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": res["launches"],
        "max_abs_err": served["max_abs_err"], "ms": served["ms"],
        "plain_ms": served["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
