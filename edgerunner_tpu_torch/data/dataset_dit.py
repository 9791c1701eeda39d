"""DiT dataset of the port: (image condition, surface points) pairs
(edgerunner_tpu/data/dataset_dit.py; reference: core/provider_dit.py:39-166).

Each mesh of a local folder may have render views beside it
(`image_io.find_render_views`); the mesh is turned to the chosen view's
azimuth. A mesh without renders, and every synthetic mesh, is rendered as
an orthographic point splat of its sampled surface points, so that the
image follows the geometry and a folder of meshes alone trains the whole
pipeline. Host numpy code with the JAX package's draws in the same order:
one seed gives both packages bit-equal samples.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from edgerunner_tpu_torch.config import Options
from edgerunner_tpu_torch.data.dataset import MeshFolderDataset, SyntheticMeshDataset, rotate_y
from edgerunner_tpu_torch.data.image_io import (
    find_render_views,
    load_image_cond,
    render_points_image,
)
from edgerunner_tpu_torch.data.mesh_io import load_mesh, normalize_mesh
from edgerunner_tpu_torch.ops.pointops import sample_surface_points


class DiTMeshDataset:
    """A mesh source as {'image': [H, W, 3], 'points': [N, 3], 'path'}.
    Training samples draw from (seed, epoch, idx), the loader setting
    `epoch`; eval samples from (0, 0, idx), with the 0-degree view."""

    def __init__(self, opt: Options, training: bool = True, image_size: int = 224,
                 root: Optional[str] = None):
        self.opt = opt
        self.training = training
        self.image_size = image_size
        self.base_seed = opt.seed
        self.epoch = 0
        root = root or opt.data_root
        if os.path.isdir(root):
            self.items = MeshFolderDataset(opt, training=training, root=root).items
            self.synthetic = None
        else:
            self.items = []
            size = opt.synthetic_size if training else max(opt.synthetic_size // 16, 4)
            self.synthetic = SyntheticMeshDataset(opt, size=size, training=training)

    def __len__(self) -> int:
        return len(self.items) if self.synthetic is None else len(self.synthetic)

    def __getitem__(self, idx: int) -> dict:
        opt = self.opt
        seed = (self.base_seed, self.epoch, idx) if self.training else (0, 0, idx)
        rng = np.random.default_rng(np.random.SeedSequence(seed))
        for _ in range(64):  # resample another index on a bad mesh
            try:
                img_path = None
                if self.synthetic is None:
                    path = self.items[idx]
                    v, f = load_mesh(path)
                    # the azimuth is the chosen render view's (reference:
                    # provider.py:209-220)
                    views = find_render_views(path)
                    if views:
                        pick = int(rng.integers(0, len(views))) if self.training else 0
                        azimuth, img_path = views[pick]
                    else:
                        azimuth = (float(rng.choice(np.arange(0, 360, 30)))
                                   if self.training else 0.0)
                    if azimuth:
                        v = rotate_y(v, azimuth)
                    v = normalize_mesh(v, 0.95)
                else:
                    v, f = self.synthetic._make_mesh(rng)
                    path = f"synthetic://{idx}"
                points = sample_surface_points(v, f, opt.point_num, rng)
                if img_path is not None:
                    image = load_image_cond(img_path, size=self.image_size)
                else:
                    image = render_points_image(points, self.image_size)
                return {"image": image.astype(np.float32), "points": points.astype(np.float32),
                        "path": path}
            except Exception:
                idx = int(rng.integers(0, max(len(self), 1)))
        raise RuntimeError("DiT dataset: too many bad samples")


def collate_dit(batch: list[dict], opt: Options, bucket=None) -> dict:
    """images [B, H, W, 3], points [B, N, 3], paths."""
    return {"images": np.stack([b["image"] for b in batch]),
            "points": np.stack([b["points"] for b in batch]),
            "paths": [b["path"] for b in batch]}
