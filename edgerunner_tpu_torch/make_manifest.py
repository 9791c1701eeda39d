"""Scan a mesh directory and write its manifest.json ({relpath: faces}), the
index that `MeshFolderDataset` reads for its face-count filter without
parsing every mesh each run (the port of tools/make_manifest.py).

    python -m edgerunner_tpu_torch.make_manifest DATA_ROOT [--workers N] \\
        [--device cuda|cpu]

Every .obj and .ply under DATA_ROOT is read with the port's mesh reader
(data/mesh_io.py); a file that does not read is skipped with a line that
says so. The work is the host's; like every entry point of the port it
takes `--device` and raises without a card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from edgerunner_tpu_torch.data.mesh_io import load_mesh
from edgerunner_tpu_torch.infer import resolve_device
from edgerunner_tpu_torch.tool_common import add_device_args


def mesh_paths(root: str) -> List[str]:
    """Every .obj and .ply under `root`, each directory's files sorted."""
    paths = []
    for dirpath, _, files in os.walk(root):
        for fn in sorted(files):
            if os.path.splitext(fn)[1].lower() in (".obj", ".ply"):
                paths.append(os.path.join(dirpath, fn))
    return paths


def main(argv: Optional[List[str]] = None) -> str:
    ap = argparse.ArgumentParser(prog="python -m edgerunner_tpu_torch.make_manifest",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--workers", type=int, default=16)
    add_device_args(ap)
    args = ap.parse_args(argv)
    resolve_device(args.device)

    def count(path):
        try:
            _, f = load_mesh(path)
            return os.path.relpath(path, args.root), int(f.shape[0])
        except Exception as e:  # noqa: BLE001 - a file that does not read is skipped
            print(f"[skip] {path}: {e}")
            return None

    with ThreadPoolExecutor(args.workers) as pool:
        entries = [r for r in pool.map(count, mesh_paths(args.root)) if r is not None]

    out = os.path.join(args.root, "manifest.json")
    with open(out, "w") as fp:
        json.dump(dict(entries), fp, indent=0)
    print(f"wrote {out}: {len(entries)} meshes")
    return out


if __name__ == "__main__":
    main()
