"""A mesh's tokenizer traversal as a PLY with per-face colors (the port of
tools/visualize_traversal.py, itself a software stand-in for the
reference's nvdiffrast GUI).

    python -m edgerunner_tpu_torch.visualize_traversal mesh.obj out.ply \\
        [--mode order|type] [--backend LR_ABSCO] [--bins 512] [--steps N] \\
        [--decode] [--device cuda|cpu]

`--mode order` colors each face by its step in the traversal (blue to
red), `--mode type` by its op (L, R, BOM/E; S under CLERS); faces past
`--steps` are grey. `--decode` draws the mesh that the tokens decode to
instead of the input. The port's mesh reader and tokenizer
(data/mesh_io.py, tokenizer/) do the work on the host; like every entry
point of the port it takes `--device` and raises without a card unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from edgerunner_tpu_torch.data.mesh_io import load_mesh, normalize_mesh
from edgerunner_tpu_torch.infer import resolve_device
from edgerunner_tpu_torch.tokenizer import Engine
from edgerunner_tpu_torch.tool_common import add_device_args

OP_COLORS = {
    0: (66, 135, 245),   # L: blue
    1: (245, 167, 66),   # R: orange
    2: (235, 64, 52),    # BOM/E: red
    4: (52, 235, 140),   # S (CLERS): green
}


def save_ply_face_colors(path: str, verts, faces, colors):
    """A binary little-endian PLY of float vertices and faces with uchar
    colors."""
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(verts)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n".encode())
        f.write(b"property list uchar int vertex_indices\n")
        f.write(b"property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(b"end_header\n")
        f.write(np.ascontiguousarray(verts, "<f4").tobytes())
        for face, col in zip(np.asarray(faces, "<i4"), colors):
            f.write(bytes([3]) + face.tobytes() + bytes(col))


def face_colors(n_faces: int, face_order, face_type, order_pos, mode: str,
                steps: int) -> tuple:
    """(color per face, steps shown): faces past the first `steps` steps
    (all with -1) grey."""
    n_show = len(face_order) if steps < 0 else min(steps, len(face_order))
    colors = []
    for fi in range(n_faces):
        step = order_pos[fi]
        if step < 0 or step >= n_show:
            colors.append((90, 90, 90))
        elif mode == "order":
            t = step / max(n_show - 1, 1)
            colors.append((int(255 * t), 60, int(255 * (1 - t))))
        else:
            op = int(face_type[step]) if step < len(face_type) else 2
            colors.append(OP_COLORS.get(op, (200, 200, 200)))
    return colors, n_show


def main(argv: Optional[List[str]] = None) -> str:
    ap = argparse.ArgumentParser(prog="python -m edgerunner_tpu_torch.visualize_traversal",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("mesh")
    ap.add_argument("output")
    ap.add_argument("--mode", choices=["order", "type"], default="order")
    ap.add_argument("--backend", default="LR_ABSCO")
    ap.add_argument("--bins", type=int, default=512)
    ap.add_argument("--steps", type=int, default=-1,
                    help="show only the first N traversal steps")
    ap.add_argument("--decode", action="store_true",
                    help="visualize the decoded mesh instead of the input")
    add_device_args(ap)
    args = ap.parse_args(argv)
    resolve_device(args.device)

    v, f = load_mesh(args.mesh)
    v = normalize_mesh(v, 0.95)
    eng = Engine(args.bins, backend=args.backend)
    tokens, face_order, face_type = eng.encode(v, f)
    print(f"[viz] {len(f)} faces -> {len(tokens)} tokens "
          f"(ratio {100 * len(tokens) / (9 * len(f)):.1f}% of naive)")
    if args.decode:
        v, f, face_type = eng.decode(tokens)
        face_order = np.arange(len(f))
        order_pos = np.arange(len(f))
    else:
        order_pos = np.full(len(f), -1)
        for step, fi in enumerate(face_order):
            order_pos[fi] = step
    colors, n_show = face_colors(len(f), face_order, face_type, order_pos, args.mode,
                                 args.steps)
    save_ply_face_colors(args.output, v, f, colors)
    print(f"[viz] wrote {args.output} ({args.mode} coloring, {n_show} steps)")
    return args.output


if __name__ == "__main__":
    main()
