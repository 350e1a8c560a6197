"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``interactive_vit_tpu_torch`` through its main paths and fails
(non-zero exit, no result line) on the first phase that goes wrong:

1. device  -- a CUDA card must be present; TF32 is turned off; prints the
   card's name and power limit as ``nvidia-smi`` reports them.
2. build   -- builds the three hand-written kernels from ``csrc/`` with
   nvcc, one compiler process each, all at once.
3. kernel  -- each kernel against its plain PyTorch version on the card,
   with max abs errors against the stated bounds (which must refuse the
   kernel's maps or mean zeroed or halved) and CUDA-event times (turns
   plain, kernel, kernel, plain):
   * the fused attention block at the vit_b16 (B=1 and 8) and vit_t16
     block shapes, bf16 and f32, maps off / maps + head-mean / a subset;
   * the headwise attention block at the vit_l16@384 block shape (B=1 and
     4), bf16 and f32, maps off / maps + mean / heads (0, 7, 15) + mean;
   * the flash attention at the dinov2_s14_reg@518 shape (6 heads, N=1374,
     dh=64) and at N=577, maps on and off, plus keys masked beyond
     n_real=1374 of N=1408; ``scaled_dot_product_attention`` is timed
     beside it with maps off (a yardstick; the port never calls it).
4. slice   -- three paths through the HTTP server in-process, seeded random
   weights, the saved graphs copied to a temp dir (a missing chain graph
   is generated there). Each path's launch counts are set to 0 just
   before it and read just after:
   * vit_b16 (+ one vit_t16 request), bf16: ``attn`` + ``r`` on blocks
     0, 5, 11 and the logits, 5 requests in sequence and 4 at once; the
     fused block kernel in every block;
   * vit_l16 @384, bf16: ``attn`` + ``r`` on block 0, ``attn`` of heads
     (0, 7, 15) + ``r`` on block 12, ``r`` on block 23, the logits; 3 in
     sequence and 2 at once; the headwise kernel in all 24 blocks;
   * dinov2_s14_reg @518, bf16: ``attn`` + ``r`` on block 0, ``r`` on
     blocks 6 and 11, the CLS features; 3 in sequence; the flash kernel
     in all 12 blocks;
   each checked for shapes, finiteness, probs rows summing to 1 and
   agreement with the port's plain path on the card (the kernels' plain
   versions in every block), then one f32 request per path whose output
   must match the plain path at 1e-4. Each path also prints its
   ``/metrics`` p50s and one ``executor.run`` under ``torch.profiler``
   (device busy share, the kernels that take the most time).
5. result  -- a JSON line describing the kernels, then the final line
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
CSRC = "interactive_vit_tpu_torch/csrc/"
# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "fused_attn_block": (CSRC + "fused_attn_block.cu",
                         "interactive_vit_tpu/ops/fused_block.py:205"),
    "headwise_attn_block": (CSRC + "headwise_attn_block.cu",
                            "interactive_vit_tpu/ops/fused_block.py:501"),
    "flash_attention": (CSRC + "flash_attention.cu",
                        "interactive_vit_tpu/ops/flash_attention.py:87"),
}

# Bounds of a kernel against its plain version (same inputs, same cast
# points; only the order of f32 sums differs). f32: 1e-4 absolute. bf16
# keeps 8 significant bits: a sum that lands within its f32 rounding error
# of a bf16 rounding boundary rounds to the neighbour, one ulp (2^-8 to
# 2^-7 of the element) in a qkv, head-output or y element. y (and the flash
# output) may move by a few ulps at the top of its range: 2^-6 of its
# scale. A probs or mean element moves in proportion to itself: a one-ulp
# flip in a q or k element (the fused kernel computes its own qkv) shifts
# a score by up to 2^-7 |q_i k_i| dh^-0.5 and the probs by that share,
# before their own rounding. So the bound is per element: 2^-5 of the
# plain value (four ulps), plus 1e-6 for values at or near 0, and never
# above 2^-7. (A bound on the whole tensor would not do: at N=1374 a
# typical probability is 7e-4.)
F32_BOUND = 1e-4
BF16_Y_REL = 2.0 ** -6
BF16_P_REL = 2.0 ** -5
BF16_P_ABS = 1e-6
BF16_P_CAP = 2.0 ** -7
# A served bf16 path against the plain path through all its blocks: the
# rare one-ulp flips above enter the residual stream and propagate through
# later blocks, so each output is bound by its own scale: within 2^-4 of
# its largest value (the head output: of max(1, its largest value)).
SLICE_REL = 2.0 ** -4
# bf16 probs rows: each of N probs rounds by <= 2^-9 relative, so a row
# sums to 1 within 2^-9; bound 2^-7.
ROW_SUM_BOUND = 2.0 ** -7

# The least time the card could take (H100 SXM published peaks): bytes over
# the memory rate, operations over the peak rate for the inputs' type (bf16
# tensor cores; f32 outside them).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


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


def time_turns(kernel_fn, plain_fn):
    """(kernel ms, plain ms), each the mean of two turns taken in the
    order plain, kernel, kernel, plain."""
    t_p1 = time_ms(plain_fn)
    t_k1 = time_ms(kernel_fn)
    t_k2 = time_ms(kernel_fn)
    t_p2 = time_ms(plain_fn)
    return (t_k1 + t_k2) / 2, (t_p1 + t_p2) / 2


def bound(nbytes: float, flops: float, dtype_name: str):
    """(bound_ms, bound_by) for work that moves ``nbytes`` and does
    ``flops`` multiply-adds x 2 on inputs of ``dtype_name``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def block_cost(b, n, d, heads, esize, n_maps, mean):
    """Bytes and FLOPs of one attention block (LN1 + QKV + attention +
    projection + residual): x, LN, qkv and proj weights read once, y, the
    maps of ``n_maps`` heads and the mean written once."""
    nbytes = esize * (2 * b * n * d + 4 * d * d + 6 * d
                      + n_maps * b * n * n + (b * n * n if mean else 0))
    flops = (2 * b * n * d * 3 * d + 4 * b * heads * n * n * (d // heads)
             + 2 * b * n * d * d)
    return nbytes, flops


def flash_cost(b, h, n, dh, esize, maps):
    """Bytes and FLOPs of attention on q, k, v [b, h, n, dh]."""
    nbytes = esize * (4 * b * h * n * dh + (b * h * n * n if maps else 0))
    return nbytes, 4 * b * h * n * n * dh


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


def output_bound(i, ref, dtype):
    """(bound of each element of output ``i`` against the plain ``ref``, a
    tensor or a number; its description)."""
    import torch

    if dtype == torch.float32:
        return F32_BOUND, f"{F32_BOUND:g}"
    if i == 0:
        bound = BF16_Y_REL * max(1.0, ref.abs().max().item())
        return bound, f"{bound:.3g}"
    return ((BF16_P_REL * ref.float().abs() + BF16_P_ABS)
            .clamp(max=BF16_P_CAP),
            f"min({BF16_P_CAP:g}, {BF16_P_REL:g}|ref|+{BF16_P_ABS:g})")


def check_outputs(tag, got, ref, dtype, labels, quiet=False):
    """Max abs errors of ``got`` against ``ref`` (same layout, ``None``
    where absent) and their bounds; raises outside a bound. The first
    tensor is y (or the attention output), the rest probs / mean."""
    errs, parts, ok = [], [], True
    for i, (g, r) in enumerate(zip(got, ref)):
        if r is None:
            if g is not None:
                raise AssertionError(f"{tag}: unexpected output {i}")
            continue
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{tag}: output {i} is {tuple(g.shape)} "
                                 f"{g.dtype}, plain {tuple(r.shape)} "
                                 f"{r.dtype}")
        bound, text = output_bound(i, r, dtype)
        diff = (g.float() - r.float()).abs()
        use = (diff / bound).max().item()
        ok = ok and use <= 1.0
        errs.append(diff.max().item())
        parts.append(f"{labels[i]}={errs[-1]:.3g} (bound {text}, "
                     f"{use:.2f} of it)")
    line = f"  {tag}: max abs err " + ", ".join(parts)
    if not ok:
        if not quiet:
            log(line)
        raise AssertionError(f"{tag} outside its bounds")
    return errs, line


def check_bounds_refuse(tag, got, ref, dtype, labels) -> None:
    """The bounds must refuse a kernel whose maps or mean are zero or half
    the plain values: each such corruption of ``got`` has to fail."""
    for i in range(1, len(got)):
        if got[i] is None:
            continue
        for factor in (0.0, 0.5):
            bad = list(got)
            bad[i] = got[i] * factor
            try:
                check_outputs(tag, bad, ref, dtype, labels, quiet=True)
            except AssertionError:
                continue
            raise AssertionError(f"{tag}: {labels[i]} x {factor} passed "
                                 f"the bounds")


def phase_block_kernel(device, name, kernel, plain, shapes, modes, served):
    """A block kernel against its plain version over ``shapes`` x dtypes x
    ``modes``; returns the numbers of the ``served`` (shape name, batch,
    dtype, mode) for the result line."""
    import torch

    out = {}
    for sname, b, n, d, heads in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype).replace("torch.", "")
            p = random_block(d, dtype, device, seed=b * 100 + d)
            x = torch.randn((b, n, d), generator=torch.Generator()
                            .manual_seed(d + b)).to(device=device, dtype=dtype)
            for mode, kw in modes(heads).items():
                got = kernel(x, p, heads, 1e-6, **kw)
                ref = plain(x, p, heads, 1e-6, **kw)
                torch.cuda.synchronize()
                tag = f"{name} {sname} B={b} {dt} {mode}"
                labels = ("y", "probs", "mean")
                errs, line = check_outputs(tag, got, ref, dtype, labels)
                check_bounds_refuse(tag, got, ref, dtype, labels)
                if mode != "subset":
                    t_k, t_p = time_turns(
                        lambda: kernel(x, p, heads, 1e-6, **kw),
                        lambda: plain(x, p, heads, 1e-6, **kw))
                    line += f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms"
                    if (sname, b, dt, mode) == served:
                        sel = kw.get("attn_heads")
                        n_maps = (0 if not kw.get("want_attn") else
                                  len(sel) if sel else heads)
                        nbytes, flops = block_cost(
                            b, n, d, heads, x.element_size(), n_maps,
                            kw.get("want_mean", False))
                        bms, by = bound(nbytes, flops, dt)
                        out = {"max_abs_err": max(errs), "ms": t_k,
                               "plain_ms": t_p, "bound_ms": bms,
                               "bound_by": by, "library_ms": None}
                        line += (f"; bound {bms:.5f} ms ({by}: "
                                 f"{nbytes / 1e6:.2f} MB, "
                                 f"{flops / 1e9:.3f} GFLOP)")
                log(line)
    return out


def phase_flash_kernel(device) -> dict:
    """The flash kernel against its plain version; returns the served
    configuration's numbers (dinov2_s14_reg, bf16, maps off) for the result
    line, SDPA's time beside them."""
    import torch
    import torch.nn.functional as F

    from interactive_vit_tpu_torch.ops import flash_attention as fa

    out = {}
    cases = [("dinov2_s14_reg", (1, 6, 1374, 64), None),
             ("vit_l16", (1, 16, 577, 64), None),
             ("padded", (1, 6, 1408, 64), 1374)]
    for cname, shape, n_real in cases:
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype).replace("torch.", "")
            g = torch.Generator().manual_seed(shape[2])
            q, k, v = [(torch.randn(shape, generator=g) * 2).to(device, dtype)
                       for _ in range(3)]
            for maps in (False, True):
                if n_real is not None and not maps:
                    continue
                kw = {"want_attn": maps, "n_real": n_real}
                got = fa.flash_attention(q, k, v, **kw)
                ref = fa.flash_attention_reference(q, k, v, **kw)
                torch.cuda.synchronize()
                tag = (f"flash_attention {cname} {shape} {dt} "
                       f"maps {'on' if maps else 'off'}"
                       + (f" n_real={n_real}" if n_real else ""))
                errs, line = check_outputs(tag, got, ref, dtype,
                                           ("o", "probs"))
                check_bounds_refuse(tag, got, ref, dtype, ("o", "probs"))
                if n_real is not None:
                    if not torch.all(got[1][..., n_real:] == 0):
                        raise AssertionError(f"{tag}: masked keys got probs")
                    log(line)
                    continue
                t_k, t_p = time_turns(
                    lambda: fa.flash_attention(q, k, v, **kw),
                    lambda: fa.flash_attention_reference(q, k, v, **kw))
                nbytes, flops = flash_cost(*shape, q.element_size(), maps)
                bms, by = bound(nbytes, flops, dt)
                line += (f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms; bound "
                         f"{bms:.5f} ms ({by})")
                t_lib = None
                if not maps:
                    t_lib = time_ms(
                        lambda: F.scaled_dot_product_attention(q, k, v))
                    line += f"; scaled_dot_product_attention {t_lib:.4f} ms"
                if (cname, dt, maps) == ("dinov2_s14_reg", "bfloat16", False):
                    out = {"max_abs_err": max(errs), "ms": t_k,
                           "plain_ms": t_p, "bound_ms": bms, "bound_by": by,
                           "library_ms": t_lib}
                log(line)
    return out


def chain_graph(graph_obj, image, node_params=None):
    """A saved graph with per-node params and ``image`` bound to node 0."""
    from interactive_vit_tpu_torch.wire.schema import graph_from_json

    g = graph_from_json(graph_obj)
    for i, params in (node_params or {}).items():
        g.nodes[i].params.update(params)
    g.add_input(image, g.nodes[0], "o")
    return g


def chain_request(graph_obj, image, taps, node_params=None):
    """Request bytes for ``chain_graph`` with an explicit tap list."""
    from interactive_vit_tpu_torch.wire.codec import (
        REQUEST_MAGIC, Request, decode_message, encode_message,
    )

    g = chain_graph(graph_obj, image, node_params)
    obj, tensors = decode_message(Request.encode(g), expect_magic=REQUEST_MAGIC)
    obj["taps"] = [{"node": i, "channel": ch} for i, ch in taps]
    return encode_message(REQUEST_MAGIC, obj, tensors)


def profile_request(app, graph, taps, tag) -> None:
    """One ``executor.run`` of a served request under ``torch.profiler``:
    host wall time, device busy time (the sum of kernel times: the port
    runs on one stream, so kernels do not overlap) and the kernels that
    take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        app.executor.run(graph, taps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.self_device_time_total / 1e3, e.count, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(t for t, _, _ in kernels)
    if not kernels:
        log(f"  {tag} profile: wall {wall_ms:.2f} ms; device time not "
            f"measured (the profiler saw no kernel)")
        return
    top = sorted(kernels, reverse=True)[:6]
    log(f"  {tag} profile of one executor.run: wall {wall_ms:.2f} ms, device "
        f"busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}%, idle "
        f"{100 - 100 * busy / wall_ms:.1f}%); top: " + "; ".join(
            f"{name[:48]} x{n} {t:.3f} ms" for t, n, name in top))


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


class Path:
    """One served path: a model, its taps and what its blocks launch."""

    def __init__(self, model, img, blocks, kernel, plain, seq, conc,
                 node_params=None, other=None):
        self.model, self.img, self.blocks = model, img, blocks
        self.kernel, self.plain = kernel, plain
        self.seq, self.conc = seq, conc
        self.node_params = node_params or {}
        self.other = other

    def taps(self, cfg):
        return ([(2 + i, ch) for i, chs in self.blocks.items() for ch in chs]
                + [(2 + cfg.depth + 1, "o")])

    def block_params(self, i):
        return {k: v for k, v in self.node_params.get(2 + i, {}).items()}


def plain_taps(path, model, image, device):
    """The port's plain path on ``device`` with the served model's weights:
    the same layer chain with the kernels' plain versions in every block.
    Returns (head output, {block: {channel: tensor}})."""
    import torch

    from interactive_vit_tpu_torch.models import vit

    cfg = vit.resolve_variant(model.name)
    x = torch.from_numpy(image).to(device)
    maps = {}
    with torch.inference_mode():
        for name, extra, fn in vit.layer_fns(cfg, **path.plain):
            p = vit.layer_params(model.params, name)
            if extra:
                i = int(name.split(".")[1])
                want = frozenset(path.blocks.get(i, ()))
                out = fn(p, {"o": x}, want=want,
                         node_params=path.block_params(i))
                if want:
                    maps[i] = {ch: out[ch] for ch in want}
            else:
                out = fn(p, {"o": x})
            x = out["o"]
    return x, maps


def check_response(raw, path, cfg, plain, tag, bf16=True):
    """Shapes, finiteness, row sums and agreement with the plain path.
    Returns ({output: max abs err}, {output: the share of its bound that
    err uses})."""
    from interactive_vit_tpu_torch.models.vit import parse_attn_heads
    from interactive_vit_tpu_torch.wire.codec import Response

    out = Response.decode(raw)
    n = cfg.tokens
    head = out[2 + cfg.depth + 1]["o"]
    want_head = (1, cfg.num_classes or cfg.width)
    if head.shape != want_head:
        raise AssertionError(f"{tag}: head output shape {head.shape}")
    if not np.isfinite(head).all():
        raise AssertionError(f"{tag}: non-finite head output")
    p_head, p_maps = plain
    pairs = {"head": (head, p_head.float().cpu().numpy())}
    for i, chs in path.blocks.items():
        sel = parse_attn_heads(path.block_params(i))
        heads = len(sel) if sel else cfg.heads
        shapes = {"attn": (1, heads, n, n), "r": (1, n, n)}
        for ch in chs:
            arr = out[2 + i][ch]
            if arr.shape != shapes[ch]:
                raise AssertionError(f"{tag}: block {i} {ch} {arr.shape}")
            if not np.isfinite(arr).all():
                raise AssertionError(f"{tag}: non-finite block {i} {ch}")
            if ch == "attn":
                row_err = float(np.abs(arr.sum(-1) - 1.0).max())
                if row_err > ROW_SUM_BOUND:
                    raise AssertionError(
                        f"{tag}: block {i} probs rows sum to 1 within "
                        f"{row_err} > {ROW_SUM_BOUND}")
            pairs[f"{ch}{i}"] = (arr, p_maps[i][ch].float().cpu().numpy())
    errs, uses = {}, {}
    for key, (got, ref) in pairs.items():
        scale = float(np.abs(ref).max())
        if not bf16:
            bound = F32_BOUND
        else:
            bound = SLICE_REL * (max(1.0, scale) if key == "head" else scale)
        errs[key] = float(np.abs(got - ref).max())
        uses[key] = errs[key] / bound
    bad = {k: f"{errs[k]:.3g} ({uses[k]:.2f} of its bound)"
           for k in errs if uses[k] > 1.0}
    if bad:
        raise AssertionError(f"{tag}: served vs plain path outside bounds: "
                             f"{bad}")
    return errs, uses


def run_path(path, device, graphs_dir, counters) -> dict:
    """One path: warm-up, then with every launch count at 0, ``seq``
    requests in sequence, ``conc`` at once (and one request to
    ``path.other``), then one f32 request on a fresh f32 server; the
    counts are read after it. Returns the counts and the p50."""
    from interactive_vit_tpu_torch.models import vit

    cfg = vit.resolve_variant(path.model)
    rng = np.random.default_rng(0)
    images = [rng.random((3, path.img, path.img), dtype=np.float32)
              for _ in range(path.seq + path.conc)]
    variants = [path.model] + ([path.other] if path.other else [])
    app, httpd, url = serve(variants, "bfloat16", device, graphs_dir)
    try:
        graph = app.graphs.load(path.model + ".json")
        model = app.reg.get_node(path.model + ":head").model
        bodies = [chain_request(graph, im, path.taps(cfg), path.node_params)
                  for im in images]
        other_raw = None
        if path.other:
            ocfg = vit.resolve_variant(path.other)
            opath = Path(path.other, 224, path.blocks, path.kernel,
                         path.plain, 1, 0)
            other_body = chain_request(app.graphs.load(path.other + ".json"),
                                       images[0][:, :224, :224],
                                       opath.taps(ocfg))
            other_model = app.reg.get_node(path.other + ":head").model
        post(url + "/compute", bodies[0])  # warms the allocator

        for fn in counters.values():  # the path starts here
            fn.launches = 0
        batches0 = app.metrics.counters.get("batches", 0)
        lat, raws = [], []
        for body in bodies[:path.seq]:
            t0 = time.perf_counter()
            raws.append(post(url + "/compute", body))
            lat.append(time.perf_counter() - t0)
        conc = [None] * path.conc

        def worker(k):
            conc[k] = post(url + "/compute", bodies[path.seq + k])

        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(path.conc)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads) or None in conc:
            raise AssertionError("concurrent requests did not complete")
        # concurrent requests may share a batch, and a batch runs each
        # block once for all its requests
        batches = app.metrics.counters.get("batches", 0) - batches0
        if path.other:
            other_raw = post(url + "/compute", other_body)
        bf16_counts = {k: fn.launches for k, fn in counters.items()}
        metrics = json.loads(urllib.request.urlopen(
            url + "/metrics", timeout=30).read())
        profile_request(app, chain_graph(graph, images[0], path.node_params),
                        path.taps(cfg), path.model)
    finally:
        stop(app, httpd)

    served = path.seq + path.conc
    want = cfg.depth * batches + (vit.resolve_variant(path.other).depth
                                  if path.other else 0)
    if batches < path.seq or bf16_counts[path.kernel] < want:
        raise AssertionError(f"{path.kernel} launched "
                             f"{bf16_counts[path.kernel]} times for {served} "
                             f"{path.model} requests in {batches} batches; "
                             f"expected >= {want}")
    worst, worst_use = {}, {}
    for k, raw in enumerate(raws + conc):
        errs, uses = check_response(raw, path, cfg,
                                    plain_taps(path, model, images[k],
                                               device),
                                    f"{path.model} request {k}")
        for key, v in errs.items():
            worst[key] = max(worst.get(key, 0.0), v)
            worst_use[key] = max(worst_use.get(key, 0.0), uses[key])
    p50 = float(np.median(lat)) * 1e3
    log(f"  {path.model} bf16: {path.seq} sequential + {path.conc} "
        f"concurrent requests{' + 1 ' + path.other if path.other else ''} "
        f"in {batches} {path.model} batches; launches {bf16_counts} "
        f"({path.kernel} >= {want}); p50 latency per "
        f"request {p50:.2f} ms (client wall, sequential)")
    log("  server p50s (ms, all requests): " + ", ".join(
        f"{k.removesuffix('_p50_ms')} {metrics[k]:.2f}" for k in (
            "wire_p50_ms", "decode_p50_ms", "queue_p50_ms",
            "compute_p50_ms", "encode_p50_ms", "request_p50_ms"))
        + f"; mean batch {metrics['mean_batch_size']:.2f}")
    log(f"  {path.model} bf16 vs plain path, worst max abs err (share of "
        f"its bound): " + ", ".join(f"{k}={v:.3g} ({worst_use[k]:.2f})"
                                    for k, v in sorted(worst.items())))
    if path.other:
        errs, _ = check_response(other_raw, opath, ocfg,
                                 plain_taps(opath, other_model, images[0]
                                            [:, :224, :224], device),
                                 f"{path.other} request")
        log(f"  {path.other} head output vs plain {errs['head']:.3g}")

    # one f32 request: the output must match the plain path at 1e-4
    app, httpd, url = serve([path.model], "float32", device, graphs_dir)
    try:
        before = {k: fn.launches for k, fn in counters.items()}
        raw = post(url + "/compute", bodies[0])
        counts = {k: bf16_counts[k] + fn.launches - before[k]
                  for k, fn in counters.items()}
        model = app.reg.get_node(path.model + ":head").model
    finally:
        stop(app, httpd)
    launches_f32 = counts[path.kernel] - bf16_counts[path.kernel]
    if launches_f32 < cfg.depth:
        raise AssertionError(f"f32 request launched {path.kernel} "
                             f"{launches_f32} times; expected >= {cfg.depth}")
    errs32, _ = check_response(raw, path, cfg,
                               plain_taps(path, model, images[0], device),
                               f"{path.model} f32 request", bf16=False)
    log(f"  {path.model} f32: 1 request, {path.kernel} launches "
        f"{launches_f32}; head output max abs err vs plain "
        f"{errs32['head']:.3g} (bound {F32_BOUND:g}), maps "
        f"{max(v for k, v in errs32.items() if k != 'head'):.3g}; path "
        f"launch counts {counts}")
    return {"launches": counts, "p50_ms": p50}


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "interactive_vit_tpu_torch")):
        raise SystemExit("chip_smoke.py: run it from a checkout of the "
                         "repository (interactive_vit_tpu_torch/ missing)")
    import torch

    from interactive_vit_tpu_torch.ops import flash_attention as fa
    from interactive_vit_tpu_torch.ops import fused_block as fb
    from interactive_vit_tpu_torch.runtime import cuda_build

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

    # 2. build: one nvcc per source, all at once
    t0 = time.perf_counter()
    cuda_build.build_all(list(KERNELS))
    fb.load_kernel()
    fb.load_headwise_kernel()
    fa.load_kernel()
    log(f"phase 2 build: {', '.join(KERNELS)} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    counters = {"fused_attn_block": fb.fused_attn_block,
                "headwise_attn_block": fb.headwise_attn_block,
                "flash_attention": fa.flash_attention}

    # 3. kernels against their plain versions
    log("phase 3 kernels vs plain versions on the card:")
    numbers = {
        "fused_attn_block": phase_block_kernel(
            device, "fused_attn_block", fb.fused_attn_block,
            fb.fused_attn_block_reference,
            (("vit_b16", 1, 197, 768, 12), ("vit_b16", 8, 197, 768, 12),
             ("vit_t16", 1, 197, 192, 3)),
            lambda heads: {
                "maps_off": {},
                "maps_mean": {"want_attn": True, "want_mean": True},
                "subset": {"want_attn": True,
                           "attn_heads": tuple(sorted({0, heads // 2,
                                                       heads - 1}))}},
            ("vit_b16", 1, "bfloat16", "maps_mean")),
        "headwise_attn_block": phase_block_kernel(
            device, "headwise_attn_block", fb.headwise_attn_block,
            fb.headwise_attn_block_reference,
            (("vit_l16", 1, 577, 1024, 16), ("vit_l16", 4, 577, 1024, 16)),
            lambda heads: {
                "maps_off": {},
                "maps_mean": {"want_attn": True, "want_mean": True},
                "subset": {"want_attn": True, "want_mean": True,
                           "attn_heads": (0, 7, 15)}},
            ("vit_l16", 1, "bfloat16", "maps_mean")),
        "flash_attention": phase_flash_kernel(device),
    }

    # 4. the paths through the server
    log("phase 4 slice through the HTTP server:")
    paths = [
        Path("vit_b16", 224, {0: ("attn", "r"), 5: ("attn", "r"),
                              11: ("attn", "r")}, "fused_attn_block",
             {"block_impl": fb.fused_attn_block_reference}, seq=5, conc=4,
             other="vit_t16"),
        Path("vit_l16", 384, {0: ("attn", "r"), 12: ("attn", "r"),
                              23: ("r",)}, "headwise_attn_block",
             {"block_impl": fb.headwise_attn_block_reference}, seq=3,
             conc=2, node_params={2 + 12: {"attn_heads": "[0,7,15]"}}),
        Path("dinov2_s14_reg", 518, {0: ("attn", "r"), 6: ("r",),
                                     11: ("r",)}, "flash_attention",
             {"attn_impl": fa.flash_attention_reference}, seq=3, conc=0),
    ]
    tmp = tempfile.mkdtemp(prefix="ivt_chip_smoke_")
    try:
        graphs_dir = os.path.join(tmp, "graphs")
        shutil.copytree(os.path.join(HERE, "static", "graphs"), graphs_dir)
        for path in paths:
            res = run_path(path, device, graphs_dir, counters)
            numbers[path.kernel]["launches"] = res["launches"][path.kernel]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 5. result
    log("phase 5 result: all phases passed")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        nums = numbers[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": nums["launches"],
            "max_abs_err": nums["max_abs_err"], "ms": nums["ms"],
            "plain_ms": nums["plain_ms"], "bound_ms": nums["bound_ms"],
            "bound_by": nums["bound_by"], "library_ms": nums["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
