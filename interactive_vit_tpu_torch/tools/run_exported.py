"""Run an exported graph artifact headlessly (no model code needed).

Counterpart of ``interactive_vit_tpu/tools/run_exported.py`` for artifacts
of ``tools/export_graph.py``: the program holds every node's math, so this
runner imports no model code, no node registry and no plugin to run one:

    python -m interactive_vit_tpu_torch.tools.run_exported /tmp/art \\
        input.npy --out /tmp/taps
    python -m interactive_vit_tpu_torch.tools.run_exported /tmp/art \\
        --image cat.png --out /tmp/taps
    python -m interactive_vit_tpu_torch.tools.run_exported /tmp/art \\
        input.npy --set-cap "17:class=281"

The artifact runs on its own platform (a ``cuda`` artifact needs a card).
``--image`` (a CHW ``.npy`` in [0, 1], or a PNG / JPEG through PIL) is
resized to each image input by the ``resize`` node kind's bilinear filter
(``jax.image.resize``'s) and fed to every input. ``--selftest`` replays the
manifest's seeded inputs against the recorded output statistics and exits
0 (ok), 1 (failed) or 2 (no record). Each output is written as ``.npy``,
and image-like ones also as ``.png``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _resized(img, shape):
    """``img`` [3, H, W] resized to ``shape`` [B, 3, h, w] and broadcast
    over the batch, by the ``resize`` kind's filter."""
    import numpy as np
    import torch

    from interactive_vit_tpu_torch.ops.node_ops import ResizeNode

    run = ResizeNode().fn({"dims": json.dumps(list(shape[2:]))})
    r = run({"o": torch.from_numpy(img)})["o"].numpy()
    return np.broadcast_to(r[None], shape).copy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("artifact", help="artifact directory (export_graph "
                                     "--out)")
    ap.add_argument("inputs", nargs="*",
                    help=".npy files, one per program input (the exported "
                         "shapes, batch included)")
    ap.add_argument("--image", help="image file fed (resized and broadcast "
                                    "to the exported input shape) to every "
                                    "program input instead of .npy files")
    ap.add_argument("--out", default=".", help="output directory")
    ap.add_argument("--set-cap", action="append", default=[],
                    metavar="NODE:NAME=VALUE",
                    help="edit a dynamic capture before running (e.g. "
                         "'17:class=281'); repeatable")
    ap.add_argument("--selftest", action="store_true",
                    help="verify the artifact (seeded replay against the "
                         "manifest's output statistics) and exit 0/1")
    args = ap.parse_args(argv)

    import numpy as np

    from interactive_vit_tpu_torch.graph.export import (
        ExportError, load_artifact,
    )

    try:
        art = load_artifact(args.artifact)
    except ExportError as err:
        print(f"cannot load artifact: {err}", file=sys.stderr)
        return 2

    if args.selftest:
        try:
            res = art.selftest()
        except ExportError as err:
            print(f"selftest unavailable: {err}", file=sys.stderr)
            return 2
        print(json.dumps(res))
        return 0 if res["ok"] else 1

    specs = art.input_specs
    if args.image:
        from interactive_vit_tpu_torch.tools.run_graph import _load_image

        img = _load_image(args.image)  # [3, H, W] in [0, 1]
        feeds = []
        for s in specs:
            shp = s["shape"]
            if len(shp) != 4 or shp[1] != 3:
                print(f"input {s['name']}:{s['channel']} has non-image "
                      f"shape {shp}; pass a .npy for it", file=sys.stderr)
                return 2
            feeds.append(_resized(img, shp))
    else:
        if len(args.inputs) != len(specs):
            print(f"program takes {len(specs)} inputs "
                  f"({[(s['name'], s['shape']) for s in specs]}), "
                  f"got {len(args.inputs)} .npy files", file=sys.stderr)
            return 2
        feeds = [np.load(p) for p in args.inputs]

    for spec in args.set_cap:
        try:
            key, val = spec.split("=", 1)
            node, name = key.split(":", 1)
            art.set_cap(int(node), name, float(val) if "." in val
                        else int(val))
        except (ValueError, ExportError) as err:
            print(f"bad --set-cap {spec!r}: {err}", file=sys.stderr)
            return 2

    try:
        outs = art(*feeds)
    except ExportError as err:
        print(f"run failed: {err}", file=sys.stderr)
        return 1

    from interactive_vit_tpu_torch.tools.run_graph import _save_png

    os.makedirs(args.out, exist_ok=True)
    for i, chans in sorted(outs.items()):
        for ch, a in chans.items():
            stem = f"{i:03d}_{ch}"
            np.save(os.path.join(args.out, stem + ".npy"), a)
            png = _save_png(os.path.join(args.out, stem + ".png"), a)
            print(f"  {stem}  {a.shape}" + ("  [png]" if png else ""),
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
