"""Datasets, augmentation, collation and the host-side loader of the port
(edgerunner_tpu/data/dataset.py:39-549).

Host numpy code, copied with the same random draws in the same order: one
seed gives both packages bit-equal batches. Ported: the local mesh folder
(with or without `manifest.json`; point or image conditions, the image
from a render view beside the mesh or a point-splat render of it), the
synthetic procedural dataset,
`collate` with its bucketed lengths, and a thread-pool loader whose order
and position (`state()` / `restore_state()`) follow the JAX package's. Remote
roots and `MixedDataset` are not ported yet (config.validate refuses them).
"""

from __future__ import annotations

import collections
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

from edgerunner_tpu_torch.config import Options
from edgerunner_tpu_torch.data._procgen import icosphere
from edgerunner_tpu_torch.data.image_io import (
    find_render_views,
    load_image_cond,
    render_points_image,
)
from edgerunner_tpu_torch.data.mesh_io import clean_mesh, load_mesh, normalize_mesh
from edgerunner_tpu_torch.data.tokenize import tokenize_mesh
from edgerunner_tpu_torch.ops.pointops import sample_surface_points

# batches the loader keeps in flight ahead of the consumer
PREFETCH = 2


# ------------------------------------------------------------ augmentation --

def rotate_y(vertices: np.ndarray, azimuth_deg: float) -> np.ndarray:
    a = np.radians(-azimuth_deg)
    rot = np.array([
        [np.cos(a), 0, np.sin(a)],
        [0, 1, 0],
        [-np.sin(a), 0, np.cos(a)],
    ])
    return vertices @ rot.T


def decimate_qem(vertices: np.ndarray, faces: np.ndarray,
                 target_faces: int) -> tuple[np.ndarray, np.ndarray]:
    """Quadric-error-metric decimation via the metok C++ extension (the
    reference's decimater augmentation, provider.py:258-263)."""
    if len(faces) <= target_faces:
        return vertices, faces
    from edgerunner_tpu_torch.tokenizer import decimate

    v, f = decimate(vertices, faces, int(target_faces))
    if len(f) == 0:  # degenerate input; keep the original
        return vertices, faces
    return clean_mesh(v, f)


def decimate_vertex_cluster(vertices: np.ndarray, faces: np.ndarray,
                            target_faces: int) -> tuple[np.ndarray, np.ndarray]:
    """Decimation by uniform vertex clustering: the grid resolution whose
    clustering lands at or below target_faces."""
    if len(faces) <= target_faces:
        return vertices, faces
    lo, hi = 2, 256
    best = (vertices, faces)
    while lo <= hi:
        res = (lo + hi) // 2
        vmin, vmax = vertices.min(0), vertices.max(0)
        scale = (vmax - vmin).max() + 1e-9
        cell = np.floor((vertices - vmin) / scale * res).astype(np.int64)
        _, first, inverse = np.unique(cell, axis=0, return_index=True,
                                      return_inverse=True)
        new_faces = inverse[faces]
        ok = (new_faces[:, 0] != new_faces[:, 1]) & \
             (new_faces[:, 1] != new_faces[:, 2]) & \
             (new_faces[:, 0] != new_faces[:, 2])
        if int(ok.sum()) > target_faces:
            hi = res - 1
        else:
            best = (vertices[first], new_faces[ok])
            lo = res + 1
    return clean_mesh(*best)


# ----------------------------------------------------------------- dataset --

class MeshFolderDataset:
    """Meshes (.obj/.ply) from a local directory tree, or those a
    `manifest.json` at its root lists with their face counts, with the
    reference's augmentations and its retry-with-resample loop
    (reference: provider.py:150-315). In image mode the mesh turns to the
    azimuth of the render view it is paired with (`find_render_views`;
    view 0 in the test split), or, without one, to a random azimuth and is
    rendered as a point splat; there is no scale augmentation."""

    def __init__(self, opt: Options, training: bool = True, tokenizer=None,
                 root: Optional[str] = None):
        self.opt = opt
        self.training = training
        self.tokenizer = tokenizer
        # each sample's draws derive from (seed, epoch, idx); the loader sets epoch
        self.base_seed = opt.seed
        self.epoch = 0
        root = root or opt.data_root
        self.items: list[str] = []
        if os.path.exists(os.path.join(root, "manifest.json")):
            with open(os.path.join(root, "manifest.json")) as f:
                meta = json.load(f)
            for rel, nf in (meta.items() if isinstance(meta, dict) else meta):
                if nf < opt.max_face_length:
                    self.items.append(os.path.join(root, rel))
        else:
            for dirpath, _, files in os.walk(root):
                for fn in sorted(files):
                    if os.path.splitext(fn)[1].lower() in (".obj", ".ply"):
                        self.items.append(os.path.join(dirpath, fn))
        if training:
            self.items = self.items[: -opt.testset_size] or self.items
        else:
            self.items = self.items[-opt.testset_size:]

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> dict:
        opt = self.opt
        rng = np.random.default_rng(
            np.random.SeedSequence((self.base_seed, self.epoch, idx)))
        path = self.items[idx]
        for _ in range(64):  # resample on bad meshes (provider.py:300-304)
            try:
                if opt.use_scale_aug and self.training and opt.cond_mode != "image":
                    bound = rng.uniform(0.75, 0.95)
                else:
                    bound = 0.95
                # image mode: the mesh faces the camera of its render view
                # (reference: provider.py:209-220, 265-272)
                views = find_render_views(path) if opt.cond_mode == "image" else []
                img_view = None
                if views:
                    pick = int(rng.integers(0, len(views))) if self.training else 0
                    azimuth, img_view = views[pick]
                else:
                    azimuth = (float(rng.choice(np.arange(0, 360, 30))) if self.training
                               else 0.0)

                v, f = load_mesh(path)
                if f.shape[0] > opt.max_face_length:
                    raise ValueError(f"{f.shape[0]} exceeds face limit")
                if opt.use_decimate_aug and self.training and f.shape[0] >= 200 \
                        and rng.random() < 0.5:
                    target = rng.integers(max(100, f.shape[0] // 4), f.shape[0])
                    v, f = decimate_qem(v, f, int(target))
                if azimuth != 0:
                    v = rotate_y(v, azimuth)
                v = normalize_mesh(v, bound=bound)

                cond = np.zeros((0,), np.float32)
                if opt.cond_mode == "point":
                    pts = sample_surface_points(v, f, opt.point_num, rng)
                    if self.training and rng.random() < 0.5:
                        pts = pts + rng.normal(0, 0.01, pts.shape).astype(np.float32)
                    cond = pts.astype(np.float32)
                elif opt.cond_mode == "image":
                    if img_view is not None:
                        cond = load_image_cond(img_view, size=opt.clip_image_size)
                    else:
                        pts = sample_surface_points(v, f, opt.point_num, rng)
                        cond = render_points_image(pts, size=opt.clip_image_size)
                    cond = cond.astype(np.float32)

                coords = tokenize_mesh(v, f, opt.discrete_bins, self.tokenizer)
                if (coords - 3 < 0).any():
                    raise ValueError("token out of coding range")
                if coords.shape[0] > opt.max_seq_length:
                    raise ValueError(f"{coords.shape[0]} exceeds token limit")
                return {"cond": cond, "coords": coords.astype(np.int64),
                        "len": coords.shape[0], "num_faces": f.shape[0],
                        "azimuth": azimuth, "path": path}
            except Exception:
                idx = int(rng.integers(0, len(self.items)))
                path = self.items[idx]
        raise RuntimeError("dataset: too many consecutive bad samples")


def shard_items_for_host(items: list, rank: int, world: int) -> list:
    """Dp group `rank`'s disjoint share of `items` out of `world` groups
    (edgerunner_tpu/data/dataset.py:310-317): every `world`-th item from
    `rank`, trimmed so that every group holds the same count. One extra
    item could cross a batch boundary and give a group an extra step, which
    would wait forever for the others at the gradients' all-reduce."""
    n = len(items) // world
    return items[rank::world][:n]


class SyntheticMeshDataset:
    """Procedural meshes (jittered icospheres, boxes, fans) for tests and
    benchmarks without downloaded data. Training samples derive from
    (seed, epoch, idx); the test split, and every sample under
    `synthetic_static`, from (0, 0, idx)."""

    def __init__(self, opt: Options, size: int = 256, training: bool = True,
                 tokenizer=None):
        self.opt = opt
        self.size = size
        self.tokenizer = tokenizer
        self.training = training
        self.base_seed = opt.seed
        self.epoch = 0

    def __len__(self) -> int:
        return self.size

    def _make_mesh(self, rng: np.random.Generator):
        kind = int(rng.integers(0, 3))
        if kind == 0:
            v, f = icosphere(int(rng.integers(1, self.opt.synthetic_subdiv + 1)))
            v = v + rng.normal(0, 0.05, v.shape)
        elif kind == 1:
            v, f = _box_mesh()
            v = v * rng.uniform(0.4, 1.0, (3,))
        else:
            v, f = _fan_mesh(rng, int(rng.integers(6, 24)))
        return normalize_mesh(v, 0.95), f

    def __getitem__(self, idx: int) -> dict:
        opt = self.opt
        if not self.training or opt.synthetic_static:
            seed = (0, 0, idx)
        else:
            seed = (self.base_seed, self.epoch, idx)
        rng = np.random.default_rng(np.random.SeedSequence(seed))
        for _ in range(16):
            try:
                v, f = self._make_mesh(rng)
                cond = np.zeros((0,), np.float32)
                if opt.cond_mode == "point":
                    cond = sample_surface_points(v, f, opt.point_num, rng)
                elif opt.cond_mode == "image":
                    pts = sample_surface_points(v, f, opt.point_num, rng)
                    cond = render_points_image(pts, size=opt.clip_image_size)
                coords = tokenize_mesh(v, f, opt.discrete_bins, self.tokenizer)
                if (coords - 3 < 0).any() or coords.shape[0] > opt.max_seq_length:
                    raise ValueError("bad tokens")
                return {"cond": cond, "coords": coords.astype(np.int64),
                        "len": coords.shape[0], "num_faces": f.shape[0],
                        "azimuth": 0.0, "path": f"synthetic://{idx}"}
            except Exception:
                continue
        raise RuntimeError("synthetic dataset failed to build a mesh")


def _box_mesh():
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                  [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], float)
    f = np.array([[0, 1, 2], [0, 2, 3], [0, 4, 5], [0, 5, 1], [1, 5, 6],
                  [1, 6, 2], [2, 6, 7], [2, 7, 3], [3, 7, 4], [3, 4, 0],
                  [4, 7, 6], [4, 6, 5]])
    return v, f


def _fan_mesh(rng, n):
    angles = np.sort(rng.uniform(0, 2 * np.pi, n))
    ring = np.stack([np.cos(angles), np.sin(angles),
                     rng.uniform(-0.2, 0.2, n)], axis=1)
    v = np.concatenate([np.zeros((1, 3)), ring], axis=0)
    f = np.array([[0, 1 + i, 1 + (i + 1) % n] for i in range(n)])
    return v, f


# ----------------------------------------------------------------- collate --

def collate(batch: list[dict], opt: Options, bucket: Optional[int] = None) -> dict:
    """Pad and mask a list of samples into fixed arrays, the token length
    rounded up to a bucket (reference: provider.py:469-541).

    Returns conds [B,...], tokens [B,1+L+1], labels [B,C+1+L+1], lengths [B],
    num_faces [B], num_tokens [B], azimuths [B], paths.
    """
    bucket = bucket or min(opt.collate_bucket, opt.max_seq_length)
    C = opt.num_cond_tokens
    max_len = max(item["len"] for item in batch)
    max_len = min(-(-max_len // bucket) * bucket, opt.max_seq_length)

    tokens, labels, lengths = [], [], []
    for item in batch:
        L = item["len"]
        if max_len >= L:
            pad = max_len - L
            tokens.append(np.concatenate([
                [opt.bos_token_id], item["coords"], [opt.eos_token_id],
                np.full(pad, opt.pad_token_id)]))
            labels.append(np.concatenate([
                np.full(C + 1, -100), item["coords"], [opt.eos_token_id],
                np.full(pad, -100)]))
            lengths.append(C + 1 + L + 1)
        else:
            # truncate; EOS dropped (reference: provider.py:514-529)
            tokens.append(np.concatenate([
                [opt.bos_token_id], item["coords"][:max_len], [opt.pad_token_id]]))
            labels.append(np.concatenate([
                np.full(C + 1, -100), item["coords"][:max_len], [-100]]))
            lengths.append(C + 1 + max_len)

    return {
        "conds": np.stack([i["cond"] for i in batch]).astype(np.float32),
        "azimuths": np.asarray([i["azimuth"] for i in batch], np.int32),
        "tokens": np.stack(tokens).astype(np.int32),
        "labels": np.stack(labels).astype(np.int32),
        "lengths": np.asarray(lengths, np.int32),
        "num_tokens": np.asarray(lengths, np.int32),
        "num_faces": np.asarray([i["num_faces"] for i in batch], np.int32),
        "paths": [i["path"] for i in batch],
    }


def batch_checksum(batch: dict) -> torch.Tensor:
    """A cheap f64 fingerprint of a collated batch: position-weighted sums of
    its tokens and labels, and the sum of its points. Every sequence-parallel
    rank takes the same batches (dp = 1); the trainer compares this over the
    ranks on the first batch."""
    total = 0.0
    for key in ("tokens", "labels"):
        x = np.asarray(batch[key], np.float64)
        total += float((x * np.arange(1, x.shape[-1] + 1)).sum())
    total += float(np.asarray(batch["conds"], np.float64).sum())
    return torch.tensor(total, dtype=torch.float64)


# ------------------------------------------------------------------ loader --

class DataLoader:
    """Thread-pool loader: shuffled epochs, drop_last, a few batches
    prefetched. Deterministic and resumable: an epoch's order derives from
    (seed + epoch) and every sample from (seed, epoch, idx), so `state()`
    (epoch, batches already yielded) is enough to resume mid-epoch:
    `restore_state()` replays the order and skips the consumed prefix."""

    def __init__(self, dataset, opt: Options, batch_size: int, shuffle: bool = True,
                 num_workers: Optional[int] = None, drop_last: bool = True, seed: int = 0,
                 bucket: Optional[int] = None, collate_fn=None):
        self.collate_fn = collate_fn or collate
        self.dataset = dataset
        self.opt = opt
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.bucket = bucket
        self.num_workers = max(1, num_workers if num_workers is not None
                               else min(opt.num_workers, os.cpu_count() or 8))
        self.epoch = 0
        self._skip = 0      # batches to skip at the next __iter__ (resume)
        self._yielded = 0   # batches yielded in the current or last epoch

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def state(self) -> dict:
        """Position of the in-flight (or next) epoch; feed to restore_state."""
        return {"epoch": int(self.epoch), "batch_in_epoch": int(self._yielded)}

    def restore_state(self, state: dict):
        self.epoch = int(state.get("epoch", 0))
        self._skip = int(state.get("batch_in_epoch", 0))
        self._yielded = self._skip

    def _plan(self, epoch: int) -> list:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        return batches

    def __iter__(self) -> Iterator[dict]:
        skip, self._skip = self._skip, 0
        self._yielded = skip
        if hasattr(self.dataset, "epoch"):
            self.dataset.epoch = self.epoch
        plan = self._plan(self.epoch)[skip:]
        with ThreadPoolExecutor(self.num_workers) as pool:
            def submit(idxs):
                return [pool.submit(self.dataset.__getitem__, int(i)) for i in idxs]

            pending = collections.deque(submit(b) for b in plan[:PREFETCH])
            for nxt in range(PREFETCH, len(plan) + PREFETCH):
                items = [f.result() for f in pending.popleft()]
                if nxt < len(plan):
                    pending.append(submit(plan[nxt]))
                # count before handing out: a checkpoint taken while the
                # consumer holds this batch must not replay it on resume
                self._yielded += 1
                yield self.collate_fn(items, self.opt, self.bucket)
        self.epoch += 1
        self._yielded = 0
