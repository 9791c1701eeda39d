"""Score generated meshes against ground truth (Chamfer, F-score, normal
consistency): the port's counterpart of tools/eval_mesh.py.

Pairs files by stem: `--pred out/chair.ply` with `--gt data/chair.obj`, or
whole directories (each predicted file with the longest ground-truth stem
that prefixes its own: infer writes `<stem>_<i>[_<faces>f].ply`, so
`chair_0_1000f.ply` pairs with `chair.obj`). Prints one JSON line per pair,
then the aggregate.

    python -m edgerunner_tpu_torch.eval_mesh --gt data/ --pred out/ [--n 10000]
        [--tau 0.01] [--bound 0] [--seed 0] [--out metrics.json]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import List, Optional

import numpy as np

MESH_EXTS = (".obj", ".ply", ".glb", ".gltf", ".off", ".stl")


def collect(path: str) -> dict:
    """stem -> path of every mesh file at `path` (a file or a directory)."""
    if os.path.isfile(path):
        return {os.path.splitext(os.path.basename(path))[0]: path}
    out = {}
    for p in sorted(glob.glob(os.path.join(path, "*"))):
        if p.lower().endswith(MESH_EXTS):
            out[os.path.splitext(os.path.basename(p))[0]] = p
    return out


def match(pred_stem: str, gt_stems: list) -> Optional[str]:
    """The longest ground-truth stem that is the predicted stem or prefixes
    it before an underscore."""
    best = None
    for g in gt_stems:
        if pred_stem == g or pred_stem.startswith(g + "_"):
            if best is None or len(g) > len(best):
                best = g
    return best


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(prog="python -m edgerunner_tpu_torch.eval_mesh")
    ap.add_argument("--gt", required=True, help="ground-truth mesh file or directory")
    ap.add_argument("--pred", required=True, help="predicted mesh file or directory")
    ap.add_argument("--n", type=int, default=10000, help="surface samples")
    ap.add_argument("--tau", type=float, default=0.01, help="F-score radius")
    ap.add_argument("--bound", type=float, default=0.0,
                    help="renormalise both meshes to this bound before comparing "
                         "(0 compares them as they are)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    from edgerunner_tpu_torch.data.mesh_io import load_mesh, normalize_mesh
    from edgerunner_tpu_torch.eval import mesh_metrics

    gt = collect(args.gt)
    pred = collect(args.pred)
    if not gt or not pred:
        sys.exit(f"no meshes found (gt: {len(gt)}, pred: {len(pred)})")

    rows = []
    for pstem, ppath in pred.items():
        gstem = match(pstem, list(gt))
        if gstem is None:
            continue
        gv, gf = load_mesh(gt[gstem])
        pv, pf = load_mesh(ppath)
        if args.bound > 0:
            gv = normalize_mesh(gv, args.bound)
            if len(pv):
                pv = normalize_mesh(pv, args.bound)
        m = mesh_metrics(gv, gf, pv, pf, n=args.n, tau=args.tau, seed=args.seed)
        m["pred"] = os.path.basename(ppath)
        m["gt"] = os.path.basename(gt[gstem])
        rows.append(m)
        print(json.dumps(m))

    if not rows:
        sys.exit("no (pred, gt) pairs matched by stem")
    finite = [r for r in rows if np.isfinite(r["chamfer_l2"])]
    agg = {
        "pairs": len(rows),
        "degenerate": len(rows) - len(finite),
        "chamfer_l2_mean": (float(np.mean([r["chamfer_l2"] for r in finite]))
                            if finite else float("inf")),
        "fscore_mean": float(np.mean([r["fscore"] for r in rows])),
        "normal_consistency_mean": float(np.mean([r["normal_consistency"] for r in rows])),
    }
    print(json.dumps({"aggregate": agg}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "aggregate": agg}, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
