"""Triangle-mesh IO and cleanup in plain numpy (no trimesh dependency).

The port's copy of the JAX package's mesh IO; `load_mesh` also reads a
remote path (http, https, s3) through data/fetch.py's cache.

Covers what the reference uses trimesh/kiui for: OBJ/PLY load/save
(reference: core/utils.py:39-66), normalization (utils.py:69-75), vertex
merging / duplicate-face removal / winding repair (provider.py:52-58), and
degenerate-face cleanup (kiui clean_mesh usage, provider.py:374).
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np

from edgerunner_tpu_torch.data.fetch import fetch_to_local


# ----------------------------------------------------------------- loading --

def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    verts, faces = [], []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    idx.append(int(tok.split("/")[0]))
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                # triangulate polygon fans
                for j in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[j], idx[j + 1]])
    return (np.asarray(verts, np.float64),
            np.asarray(faces, np.int64).reshape(-1, 3))


def load_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """ASCII and binary-little-endian PLY with float vertex xyz properties."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        counts = {}
        props: dict[str, list] = {}
        cur = None
        for l in header:
            t = l.split()
            if not t:
                continue
            if t[0] == "element":
                cur = t[1]
                counts[cur] = int(t[2])
                props[cur] = []
            elif t[0] == "property" and cur is not None:
                props[cur].append(t[1:])

        nv = counts.get("vertex", 0)
        nf = counts.get("face", 0)

        type_map = {
            "float": ("f", 4), "float32": ("f", 4), "double": ("d", 8),
            "float64": ("d", 8), "uchar": ("B", 1), "uint8": ("B", 1),
            "char": ("b", 1), "int8": ("b", 1), "short": ("h", 2),
            "ushort": ("H", 2), "int": ("i", 4), "int32": ("i", 4),
            "uint": ("I", 4), "uint32": ("I", 4),
        }

        if fmt == "ascii":
            verts = np.empty((nv, 3), np.float64)
            names = [p[-1] for p in props["vertex"]]
            xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
            for i in range(nv):
                vals = f.readline().split()
                verts[i] = [float(vals[xi]), float(vals[yi]), float(vals[zi])]
            faces = []
            for _ in range(nf):
                vals = [int(x) for x in f.readline().split()]
                n, idx = vals[0], vals[1:]
                for j in range(1, n - 1):
                    faces.append([idx[0], idx[j], idx[j + 1]])
            return verts, np.asarray(faces, np.int64).reshape(-1, 3)

        assert fmt == "binary_little_endian", f"unsupported PLY format {fmt}"
        # vertex block
        vfmt, names = "", []
        for p in props["vertex"]:
            code, _ = type_map[p[0]]
            vfmt += code
            names.append(p[-1])
        vsize = struct.calcsize("<" + vfmt)
        raw = f.read(nv * vsize)
        arr = np.array([struct.unpack_from("<" + vfmt, raw, i * vsize) for i in range(nv)])
        xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
        verts = arr[:, [xi, yi, zi]].astype(np.float64)
        # face block (assume list-type first property)
        lp = props["face"][0]  # ['list', count_t, idx_t, name]
        cnt_code, cnt_sz = type_map[lp[1]]
        idx_code, idx_sz = type_map[lp[2]]
        faces = []
        for _ in range(nf):
            (n,) = struct.unpack("<" + cnt_code, f.read(cnt_sz))
            idx = struct.unpack(f"<{n}{idx_code}", f.read(n * idx_sz))
            for j in range(1, n - 1):
                faces.append([idx[0], idx[j], idx[j + 1]])
        return verts, np.asarray(faces, np.int64).reshape(-1, 3)


def load_mesh(path: str, bound: float | None = None) -> Tuple[np.ndarray, np.ndarray]:
    """(vertices, faces) of an .obj or .ply file; a remote path (http,
    https, s3) is fetched into the local cache first (data/fetch.py)."""
    path = fetch_to_local(path)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        v, f = load_obj(path)
    elif ext == ".ply":
        v, f = load_ply(path)
    else:
        raise ValueError(f"unsupported mesh format: {ext} (obj/ply supported)")
    if bound is not None:
        v = normalize_mesh(v, bound=bound)
    return v, f


# ------------------------------------------------------------------ saving --

def save_obj(path: str, verts: np.ndarray, faces: np.ndarray):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in faces:
            f.write(f"f {face[0]+1} {face[1]+1} {face[2]+1}\n")


def save_ply(path: str, verts: np.ndarray, faces: np.ndarray):
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(verts)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n".encode())
        f.write(b"property list uchar int vertex_indices\nend_header\n")
        f.write(np.ascontiguousarray(verts, "<f4").tobytes())
        fa = np.ascontiguousarray(faces, "<i4")
        block = np.empty((len(fa), 13), np.uint8)
        block[:, 0] = 3
        block[:, 1:] = fa.view(np.uint8).reshape(len(fa), 12)
        f.write(block.tobytes())


def save_mesh_file(path: str, verts: np.ndarray, faces: np.ndarray):
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        save_obj(path, verts, faces)
    elif ext == ".ply":
        save_ply(path, verts, faces)
    else:
        raise ValueError(f"unsupported mesh format: {ext}")


# ----------------------------------------------------------------- cleanup --

def normalize_mesh(vertices: np.ndarray, bound: float = 0.95) -> np.ndarray:
    vmin, vmax = vertices.min(0), vertices.max(0)
    center = (vmax + vmin) / 2
    scale = 2 * bound / np.max(vmax - vmin)
    return (vertices - center) * scale


def merge_vertices(verts: np.ndarray, faces: np.ndarray, decimals: int = 8):
    """Merge exactly-coincident vertices (tokenizer decode emits duplicates)."""
    key = np.round(verts, decimals)
    _, first, inverse = np.unique(key, axis=0, return_index=True, return_inverse=True)
    return verts[first], inverse[faces]


def remove_degenerate_faces(faces: np.ndarray) -> np.ndarray:
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return faces[ok]


def unique_faces(faces: np.ndarray) -> np.ndarray:
    """Drop duplicate faces irrespective of winding/rotation."""
    if len(faces) == 0:
        return faces
    key = np.sort(faces, axis=1)
    _, idx = np.unique(key, axis=0, return_index=True)
    return faces[np.sort(idx)]


def fix_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Make face windings consistent within each connected component by BFS
    over shared edges (software stand-in for trimesh.fix_normals)."""
    if len(faces) == 0:
        return faces
    from collections import defaultdict, deque

    edge_map = defaultdict(list)  # undirected edge -> [(face, oriented?)]
    for fi, (a, b, c) in enumerate(faces):
        for u, v in ((a, b), (b, c), (c, a)):
            edge_map[(min(u, v), max(u, v))].append((fi, u < v))

    flipped = np.zeros(len(faces), bool)
    seen = np.zeros(len(faces), bool)
    out = faces.copy()
    for seed in range(len(faces)):
        if seen[seed]:
            continue
        seen[seed] = True
        q = deque([seed])
        while q:
            fi = q.popleft()
            a, b, c = out[fi]
            for u, v in ((a, b), (b, c), (c, a)):
                key = (min(u, v), max(u, v))
                for fj, _ in edge_map[key]:
                    if fj == fi or seen[fj]:
                        continue
                    # consistent winding = neighbors traverse shared edge oppositely
                    fa, fb, fc = out[fj]
                    their_dirs = [(fa, fb), (fb, fc), (fc, fa)]
                    same_dir = (u, v) in their_dirs
                    if same_dir:
                        out[fj] = out[fj][::-1]
                        flipped[fj] = True
                    seen[fj] = True
                    q.append(fj)
    return out


def clean_mesh(verts: np.ndarray, faces: np.ndarray):
    """Post-decode cleanup: merge verts, drop degenerate + duplicate faces,
    repair winding (reference: provider.py:52-58)."""
    if len(verts) == 0 or len(faces) == 0:
        return verts, faces
    verts, faces = merge_vertices(verts, faces)
    faces = remove_degenerate_faces(faces)
    faces = unique_faces(faces)
    faces = fix_normals(verts, faces)
    # drop unreferenced vertices
    used = np.unique(faces) if len(faces) else np.empty(0, np.int64)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces] if len(faces) else faces
