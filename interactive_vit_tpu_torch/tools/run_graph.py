"""Headless graph runner: evaluate a saved graph on an image, dump taps.

Counterpart of ``interactive_vit_tpu/tools/run_graph.py``. Runs a saved
graph JSON through the port's executor with no browser in the loop:

    python -m interactive_vit_tpu_torch.tools.run_graph \\
        static/graphs/dino_s16.json --image cat.npy --out /tmp/taps
    python -m interactive_vit_tpu_torch.tools.run_graph demo_noise \\
        --taps all --out /tmp/taps --device cpu

Writes one ``.npy`` per tapped (node, channel) and ``manifest.json`` (the
JAX runner's keys); image-shaped taps ([3,H,W] / [B,3,H,W] in [0,1], such
as ``pca_view`` / ``patch_sim`` maps) and square 2-D heatmaps are also
rendered to ``.png`` by a small writer of its own (``zlib`` + ``struct``).
``--image`` takes a CHW ``.npy`` in [0, 1], or a PNG / JPEG, read through
PIL (imported only then).

The image binds to every ``img_src`` node and to every unwired root that
takes "o" and feeds another node (the bare ``<model>:transform`` heads of
generated graphs); a dangling sink neither demands nor receives it. Model
node kinds are registered from the graph's endpoints
(``models.autoregister.make_model``, seeded random weights), and
``--plugin-dirs`` adds plugin kinds, as the server does. It runs on the
card (``--device cuda``, the default; it raises where there is none)
unless ``--device cpu`` is given, with TF32 off (exact f32 matmuls). The
``*_saliency.json`` graphs run too (their gradient kinds on the executor's
cone staging). Not ported: ``--platform`` (a TPU-rig
flag) and ``--ckpt`` (the weight loaders are not ported yet); the parser
refuses both.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys
import zlib
from typing import Dict, Optional, Set

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _load_image(path: str) -> np.ndarray:
    """CHW f32 in [0, 1]: a ``.npy`` as saved, anything else decoded by PIL
    to RGB / 255 (the image-source contract)."""
    if path.endswith(".npy"):
        arr = np.load(path).astype(np.float32)
        if arr.ndim != 3 or arr.shape[0] != 3:
            raise ValueError(f"{path}: expected a CHW [3,H,W] array, got "
                             f"shape {arr.shape}")
        return arr
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return (np.asarray(img, dtype=np.float32) / 255.0).transpose(2, 0, 1)


def _model_variants(endpoints: Set[str]) -> Set[str]:
    return {e.split(":", 1)[0] for e in endpoints if ":" in e}


def _register_models(reg, variants: Set[str], dtype_name: str,
                     device: str) -> None:
    """Register every model family the graph references, through the one
    variant dispatch (``autoregister.make_model``). An unknown prefix is
    left to the built-in and plugin kinds, with a warning; a known variant
    that fails to build raises."""
    import torch

    from interactive_vit_tpu_torch.models.autoregister import (
        known_variants, make_model,
    )

    dtype = torch.float32 if dtype_name == "float32" else torch.bfloat16
    known = set(known_variants())
    for v in sorted(variants):
        if v not in known and v.partition("@")[0] not in known:
            print(f"warning: unknown model prefix {v!r} — relying on "
                  f"builtin/plugin kinds", file=sys.stderr)
            continue
        make_model(v, dtype=dtype, device=device).register(reg)


def _png_bytes(pixels: np.ndarray) -> bytes:
    """A PNG of uint8 ``pixels``, [H, W] (gray) or [H, W, 3] (RGB)."""
    h, w = pixels.shape[:2]
    color = 2 if pixels.ndim == 3 else 0
    raw = b"".join(b"\x00" + pixels[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _save_png(path: str, a: np.ndarray) -> bool:
    """Render [3,H,W] / [1,3,H,W] (RGB in [0,1]) or square [H,W] heatmaps
    (leading 1s dropped); returns False for shapes that are not
    image-like."""
    x = np.asarray(a, dtype=np.float32)
    while x.ndim > 2 and x.shape[0] == 1:
        x = x[0]
    if x.ndim == 3 and x.shape[0] == 3:
        img = (np.clip(x, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
    elif x.ndim == 2 and x.shape[0] == x.shape[1] and x.shape[0] >= 2:
        # square maps only (attention, rollout, similarity); rectangular
        # token matrices stay .npy-only
        lo, hi = float(x.min()), float(x.max())
        g = (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)
        img = (g * 255).astype(np.uint8)
    else:
        return False
    with open(path, "wb") as f:
        f.write(_png_bytes(np.ascontiguousarray(img)))
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("graph", help="graph JSON path, or a name in --graphs-dir")
    ap.add_argument("--image", help="input image bound to every img_src "
                                    "node: a CHW .npy, or a PNG / JPEG")
    ap.add_argument("--out", default=".", help="output directory")
    ap.add_argument("--taps", default="primary",
                    choices=["primary", "all", "sinks"],
                    help="tap policy (graph/executor.py docstring)")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--graphs-dir", default=None)
    ap.add_argument("--plugin-dirs", default="",
                    help="comma-separated plugin dirs (same contract as "
                         "the server)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from interactive_vit_tpu_torch.graph.executor import Executor
    from interactive_vit_tpu_torch.graph.registry import (
        Registry, scan_plugins,
    )
    from interactive_vit_tpu_torch.ops.node_ops import register_builtin
    from interactive_vit_tpu_torch.runtime.device import (
        exact_f32_matmuls, require_device,
    )
    from interactive_vit_tpu_torch.wire.schema import graph_from_json

    device = require_device(args.device)
    exact_f32_matmuls()
    path = args.graph
    if not os.path.exists(path):
        root = args.graphs_dir or os.path.join(_REPO_ROOT, "static",
                                               "graphs")
        cand = os.path.join(root, path if path.endswith(".json")
                            else path + ".json")
        if not os.path.exists(cand):
            print(f"graph not found: {args.graph}", file=sys.stderr)
            return 2
        path = cand
    with open(path) as f:
        obj = json.load(f)

    reg = Registry()
    register_builtin(reg)
    dirs = [d for d in args.plugin_dirs.split(",") if d]
    if dirs:
        scan_plugins(dirs, reg)
    endpoints = {n["instance"].get("endpoint") or n["instance"]["kind"]
                 for n in obj["nodes"]}
    _register_models(reg, _model_variants(endpoints), args.dtype, device)

    g = graph_from_json(obj)
    image: Optional[np.ndarray] = (_load_image(args.image) if args.image
                                   else None)
    n_src = 0
    # nodes some other node consumes: an input-less sink (a dangling
    # img_view left over from editing) must not demand the image, and
    # binding it there would add bogus outputs to the manifest
    consumed = {e.src.node.index for n in g.nodes
                for e in n.inputs.values() if e.src is not None}

    def root_wants_image(n) -> bool:
        if n.inputs:
            return False
        if n.index not in consumed and len(g.nodes) > 1:
            return False  # dangling sink, nothing downstream
        try:
            ins = reg.get_node(n.name).io(n.params).get("ins", ())
        except Exception:  # noqa: BLE001 -- the executor attributes it
            return False
        return "o" in ins

    for n in g.nodes:
        # the image binds to img_src nodes and to the bare
        # <model>:transform heads of generated graphs
        if ((n.name == "img_src" or root_wants_image(n))
                and "o" not in n.inputs):
            if image is None:
                print(f"graph needs an image at node {n.index} "
                      f"({n.name}); pass --image", file=sys.stderr)
                return 2
            g.add_input(image, n, "o")
            n_src += 1

    ex = Executor(reg=reg, device=device)
    outs = ex.run(g, taps=args.taps)
    st = ex.last_stats
    print(f"evaluated {len(g.nodes)} nodes ({n_src} image inputs) on "
          f"{device} in {st.execute_s * 1e3:.1f} ms (capture "
          f"{st.compile_s * 1e3:.1f} ms)", file=sys.stderr)

    os.makedirs(args.out, exist_ok=True)
    manifest: Dict[str, Dict] = {}
    for i, chans in sorted(outs.items()):
        for ch, a in chans.items():
            stem = f"{i:03d}_{g.nodes[i].name.replace(':', '.')}_{ch}"
            np.save(os.path.join(args.out, stem + ".npy"), a)
            png = _save_png(os.path.join(args.out, stem + ".png"), a)
            manifest[stem] = {"node": i, "name": g.nodes[i].name,
                              "channel": ch, "shape": list(a.shape),
                              "png": png}
            print(f"  {stem}  {a.shape}" + ("  [png]" if png else ""),
                  file=sys.stderr)
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
