"""Point-cloud helpers of the port: farthest-point sampling on the device,
surface sampling on the host (numpy)."""

from __future__ import annotations

import numpy as np
import torch


@torch.no_grad()
def farthest_point_sample(pts: torch.Tensor, k: int) -> torch.Tensor:
    """k indices per row by farthest-point sampling (edgerunner_tpu/ops/
    pointops.py:14-35, the reference's torch_cluster.fps): pts [B, N, 3];
    returns int64 [B, k]. Starts from point 0; each next point is the one
    farthest from those chosen, the first of equal maxima (as jnp.argmax
    takes it). The squared distance is summed in f32 as the JAX loop sums
    it, x then y then z, so that both packages choose the same points.
    Plain PyTorch, ~7 launches per chosen point: the JAX function is a
    fori_loop, not a Pallas kernel."""
    B, N, _ = pts.shape
    p = pts.float()
    rows = torch.arange(B, device=p.device)
    idx = torch.zeros((B, k), dtype=torch.int64, device=p.device)
    dists = torch.full((B, N), float("inf"), device=p.device)
    for i in range(1, k):
        diff = p - p[rows, idx[:, i - 1]][:, None]
        sq = diff * diff
        dists = torch.minimum(dists, sq[..., 0] + sq[..., 1] + sq[..., 2])
        idx[:, i] = dists.argmax(-1)
    return idx


def sample_surface_points(vertices, faces, n: int, rng) -> np.ndarray:
    """Uniform surface sampling on a triangle mesh (reference: provider.py:280).

    vertices [V,3], faces [F,3]; `rng` is a numpy Generator. Returns [n,3]
    float32, drawing the same numbers in the same order as the JAX package's
    sampler, so one seed gives both packages the same points.
    """
    v = np.asarray(vertices, dtype=np.float64)
    f = np.asarray(faces, dtype=np.int64)
    tri = v[f]  # [F, 3, 3]
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=1)
    total = area.sum()
    probs = np.full(len(f), 1.0 / len(f)) if total <= 0 else area / total
    choice = rng.choice(len(f), size=n, p=probs)
    u = rng.random(n)
    w = rng.random(n)
    flip = u + w > 1
    u[flip] = 1 - u[flip]
    w[flip] = 1 - w[flip]
    t = tri[choice]
    pts = t[:, 0] + u[:, None] * (t[:, 1] - t[:, 0]) + w[:, None] * (t[:, 2] - t[:, 0])
    return pts.astype(np.float32)
