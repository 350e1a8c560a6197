"""Graph exporter CLI: saved graph JSON -> deployable artifact.

Counterpart of ``interactive_vit_tpu/tools/export_graph.py``. Traces the
whole tapped graph's staged pass into ONE ``torch.export`` program
(``graph/export.py``) beside its weights and dynamic params, a directory
that this package runs with no model code, no registry and no plugins:

    python -m interactive_vit_tpu_torch.tools.export_graph vit_b16 \\
        --dtype bfloat16 --out /tmp/vit_b16_art --check
    python -m interactive_vit_tpu_torch.tools.export_graph demo_noise \\
        --taps all --out /tmp/noise_art --device cpu

The program is traced on ``--device`` (``cuda``, the default, raises
without a card; ``cpu``) and is for that platform alone: a ``cuda``
artifact's kernels are the ``ivt`` custom ops. ``--check`` loads the
artifact and holds it against the live executor on seeded random inputs
(max abs difference 1e-5 in f32, 2e-2 in bf16) before declaring success.
TF32 is turned off first (exact f32 matmuls), as the server and
``run_graph`` do. ``--mesh`` is refused: mesh-sharded export is not
ported (``ROADMAP.md`` queue 1 item 7b).

Run an artifact headlessly with ``tools/run_exported.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _parse_shape(s: str):
    return tuple(int(x) for x in s.split(",") if x)


def _unfed_inputs(g, reg):
    """Unfed required 'o' inputs in deterministic wiring order: the ONE
    iteration that both the export's wiring and ``--check``'s use, so the
    check's feeds never misalign with the exported input order."""
    out = []
    for n in g.nodes:
        kind = reg.get_node(n.name)
        if getattr(kind, "optional_inputs", False):
            continue
        for ch in kind.io(n.params)["ins"]:
            if ch == "o" and ch not in n.inputs:
                out.append((n, ch))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("graph", help="graph JSON path, or a name in "
                                  "--graphs-dir (default static/graphs)")
    ap.add_argument("--out", required=True, help="artifact directory")
    ap.add_argument("--taps", default="primary",
                    choices=["primary", "all", "sinks"])
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--batch", type=int, default=1,
                    help="input batch size baked into the program")
    ap.add_argument("--image-shape", default="3,224,224",
                    help="C,H,W fed to every unfed image input")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or "
                         "cpu: the artifact's platform")
    ap.add_argument("--ckpt", action="append", default=[],
                    metavar="VARIANT=PATH",
                    help="real weights (the server's --ckpt contract); "
                         "repeatable")
    ap.add_argument("--check", action="store_true",
                    help="load the artifact and hold it against the live "
                         "executor on random inputs")
    ap.add_argument("--mesh", default="",
                    help="refused: mesh-sharded export is not ported")
    ap.add_argument("--graphs-dir", default=None)
    ap.add_argument("--plugin-dirs", default="")
    args = ap.parse_args(argv)
    if args.mesh:
        print("--mesh: mesh-sharded export is not ported yet (ROADMAP.md "
              "queue 1 item 7b)", file=sys.stderr)
        return 2

    import numpy as np

    from interactive_vit_tpu_torch.graph.executor import Executor
    from interactive_vit_tpu_torch.graph.export import (
        export_graph, load_artifact, shape_struct,
    )
    from interactive_vit_tpu_torch.graph.registry import (
        Registry, scan_plugins,
    )
    from interactive_vit_tpu_torch.ops.node_ops import register_builtin
    from interactive_vit_tpu_torch.runtime.device import (
        exact_f32_matmuls, require_device,
    )
    from interactive_vit_tpu_torch.tools.run_graph import (
        _REPO_ROOT, _model_variants, _register_models,
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
    _register_models(reg, _model_variants(endpoints), args.dtype, device,
                     ckpts=dict(kv.split("=", 1) for kv in args.ckpt))

    g = graph_from_json(obj)
    img_shape = (args.batch,) + _parse_shape(args.image_shape)
    unfed = _unfed_inputs(g, reg)
    for n, ch in unfed:
        g.add_input(shape_struct(img_shape), n, ch)
    if unfed:
        print(f"wired {len(unfed)} image input(s) of shape "
              f"{list(img_shape)}", file=sys.stderr)

    ex = Executor(reg=reg, device=device)
    manifest = export_graph(
        g, args.out, taps=args.taps, executor=ex,
        provenance={"graph": os.path.basename(path),
                    "dtype": args.dtype, "taps": args.taps},
        client_graph=obj)
    size = sum(os.path.getsize(os.path.join(args.out, f))
               for f in os.listdir(args.out))
    print(f"exported {len(manifest['out_keys'])} outputs for platforms "
          f"{manifest['platforms']} -> {args.out} ({size / 1e6:.1f} MB)",
          file=sys.stderr)

    if args.check:
        art = load_artifact(args.out)
        rng = np.random.default_rng(0)
        feeds = [rng.random(s["shape"], np.float32)
                 for s in art.input_specs]
        got = art(*feeds)
        # the live executor on the same inputs (the same wiring order by
        # construction: _unfed_inputs is the one iteration)
        g2 = graph_from_json(obj)
        for (n, ch), feed in zip(_unfed_inputs(g2, reg), feeds):
            g2.add_input(feed, n, ch)
        want = ex.run(g2, taps=args.taps)
        worst = 0.0
        for i, chans in want.items():
            for ch, v in chans.items():
                worst = max(worst, float(np.max(np.abs(
                    np.asarray(v, np.float32) - got[i][ch]))))
        tol = 1e-5 if args.dtype == "float32" else 2e-2
        if worst > tol:
            print(f"CHECK FAILED: max |live - exported| = {worst:.3e} "
                  f"> {tol}", file=sys.stderr)
            return 1
        print(f"check ok: max |live - exported| = {worst:.3e}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
