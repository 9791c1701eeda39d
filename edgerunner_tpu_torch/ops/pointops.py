"""Point-cloud helpers of the port (host numpy)."""

from __future__ import annotations

import numpy as np


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
