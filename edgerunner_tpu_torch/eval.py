"""Mesh-quality evaluation of the port (edgerunner_tpu/eval.py).

Symmetric Chamfer distance, F-score at a distance threshold and normal
consistency between a generated and a ground-truth mesh, on uniform surface
samples, as the mesh-generation literature scores them (MeshGPT,
MeshAnything, PolyGen): host numpy and scipy, copied from the JAX package
with the same draws in the same order, so that both give the same numbers.
`generate_eval` is `main --eval_mode generate`: it decodes held-out
conditions through the port's `generate_tokens` and scores each mesh.

    from edgerunner_tpu_torch.eval import mesh_metrics
    m = mesh_metrics(gt_v, gt_f, pred_v, pred_f)   # dict of floats

CLI: python -m edgerunner_tpu_torch.eval_mesh --gt <file|dir> --pred <file|dir>
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


def _surface_samples(vertices: np.ndarray, faces: np.ndarray, n: int,
                     rng: np.random.Generator):
    """Uniform area-weighted surface samples with per-sample face normals.
    Returns (points [n,3] f32, normals [n,3] f32, unit length)."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    tri = v[f]
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=1)
    total = area.sum()
    probs = area / total if total > 0 else np.full(len(f), 1.0 / len(f))
    choice = rng.choice(len(f), size=n, p=probs)
    u = rng.random(n)
    w = rng.random(n)
    flip = u + w > 1
    u[flip] = 1 - u[flip]
    w[flip] = 1 - w[flip]
    t = tri[choice]
    pts = t[:, 0] + u[:, None] * (t[:, 1] - t[:, 0]) + w[:, None] * (t[:, 2] - t[:, 0])
    nrm = cross[choice]
    ln = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = np.divide(nrm, np.maximum(ln, 1e-12))
    return pts.astype(np.float32), nrm.astype(np.float32)


def _closest_point_on_tri(p, a, b, c):
    """Closest point on triangle (a,b,c) to p, all [..., 3] broadcastable
    (Ericson, Real-Time Collision Detection 5.1.5, vectorized)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = (ab * ap).sum(-1)
    d2 = (ac * ap).sum(-1)
    bp = p - b
    d3 = (ab * bp).sum(-1)
    d4 = (ac * bp).sum(-1)
    cp = p - c
    d5 = (ab * cp).sum(-1)
    d6 = (ac * cp).sum(-1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = np.where(vc + vb + va != 0, vc + vb + va, 1.0)
    v_in = vb / denom
    w_in = vc / denom
    inside = a + v_in[..., None] * ab + w_in[..., None] * ac

    v_ab = np.clip(np.divide(d1, np.where(d1 - d3 != 0, d1 - d3, 1.0)), 0, 1)
    on_ab = a + v_ab[..., None] * ab
    w_ac = np.clip(np.divide(d2, np.where(d2 - d6 != 0, d2 - d6, 1.0)), 0, 1)
    on_ac = a + w_ac[..., None] * ac
    num = d4 - d3
    den = (d4 - d3) + (d5 - d6)
    w_bc = np.clip(np.divide(num, np.where(den != 0, den, 1.0)), 0, 1)
    on_bc = b + w_bc[..., None] * (c - b)

    out = inside
    out = np.where((vc <= 0)[..., None] & (d1 >= 0)[..., None]
                   & (d3 <= 0)[..., None], on_ab, out)
    out = np.where((vb <= 0)[..., None] & (d2 >= 0)[..., None]
                   & (d6 <= 0)[..., None], on_ac, out)
    out = np.where((va <= 0)[..., None] & ((d4 - d3) >= 0)[..., None]
                   & ((d5 - d6) >= 0)[..., None], on_bc, out)
    out = np.where((d1 <= 0)[..., None] & (d2 <= 0)[..., None], a, out)
    out = np.where((d3 >= 0)[..., None] & (d4 <= d3)[..., None], b, out)
    out = np.where((d6 >= 0)[..., None] & (d5 <= d6)[..., None], c, out)
    return out


def point_mesh_distance(points: np.ndarray, vertices: np.ndarray,
                        faces: np.ndarray, k: int = 16) -> np.ndarray:
    """Distance from each point [N,3] to the mesh surface: the exact closest
    point on each of the k triangles with the nearest centroids (a KD-tree),
    the least over them. Exact when the nearest triangle is among those k,
    which k=16 makes so for evaluation meshes."""
    from scipy.spatial import cKDTree

    p = np.asarray(points, np.float64)
    tri = np.asarray(vertices, np.float64)[np.asarray(faces, np.int64)]
    k = min(k, len(tri))
    _, idx = cKDTree(tri.mean(1)).query(p, k=k)
    idx = idx.reshape(len(p), k)
    cand = tri[idx]                                    # [N, k, 3, 3]
    cp = _closest_point_on_tri(p[:, None], cand[:, :, 0], cand[:, :, 1],
                               cand[:, :, 2])          # [N, k, 3]
    d = np.linalg.norm(cp - p[:, None], axis=-1)
    return d.min(1)


def chamfer_l2(a: np.ndarray, b: np.ndarray) -> float:
    """Symmetric Chamfer distance (mean of squared nearest-neighbor
    distances, both directions) between point sets a [N,3], b [M,3]."""
    from scipy.spatial import cKDTree

    da, _ = cKDTree(b).query(a, k=1)
    db, _ = cKDTree(a).query(b, k=1)
    return float((da ** 2).mean() + (db ** 2).mean())


def fscore(a: np.ndarray, b: np.ndarray, tau: float = 0.01) -> float:
    """F-score at threshold tau between point sets a (predicted) and b
    (ground truth): the harmonic mean of precision (the share of a within
    tau of b) and recall (the other way round). Limited by the sampling;
    mesh_metrics takes the point-to-surface version for mesh pairs."""
    from scipy.spatial import cKDTree

    dp, _ = cKDTree(b).query(a, k=1)
    dr, _ = cKDTree(a).query(b, k=1)
    precision = float((dp < tau).mean())
    recall = float((dr < tau).mean())
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def normal_consistency(a_pts, a_nrm, b_pts, b_nrm) -> float:
    """Mean |cos| between each sample's normal and its nearest neighbor's
    normal in the other set, both ways; |cos| because the tokenizer's round
    trip does not keep the winding."""
    from scipy.spatial import cKDTree

    _, ia = cKDTree(b_pts).query(a_pts, k=1)
    _, ib = cKDTree(a_pts).query(b_pts, k=1)
    ca = np.abs((a_nrm * b_nrm[ia]).sum(1)).mean()
    cb = np.abs((b_nrm * a_nrm[ib]).sum(1)).mean()
    return float((ca + cb) / 2)


def mesh_metrics(gt_v, gt_f, pred_v, pred_f, *, n: int = 10000,
                 tau: float = 0.01, seed: int = 0) -> dict:
    """Every metric between a ground-truth and a predicted mesh, in a
    comparable normalisation (infer's outputs lie in the [-0.95, 0.95]
    bound of its inputs). A prediction without faces scores chamfer inf
    and F-score 0."""
    gt_f = np.asarray(gt_f)
    pred_f = np.asarray(pred_f)
    if len(pred_f) == 0 or len(gt_f) == 0:
        return {"chamfer_l2": float("inf"), "fscore": 0.0,
                "normal_consistency": 0.0,
                "num_faces_gt": int(len(gt_f)),
                "num_faces_pred": int(len(pred_f))}
    rng = np.random.default_rng(seed)
    gp, gn = _surface_samples(gt_v, gt_f, n, rng)
    pp, pn = _surface_samples(pred_v, pred_f, n, rng)
    # point-to-surface distances: identical meshes score 0 and 1.0 whatever
    # the sample count
    dp = point_mesh_distance(pp, gt_v, gt_f)
    dr = point_mesh_distance(gp, pred_v, pred_f)
    precision = float((dp < tau).mean())
    recall = float((dr < tau).mean())
    f = (2 * precision * recall / (precision + recall)
         if precision + recall else 0.0)
    return {
        "chamfer_l2": float((dp ** 2).mean() + (dr ** 2).mean()),
        "fscore": f,
        "precision": precision,
        "recall": recall,
        "normal_consistency": normal_consistency(pp, pn, gp, gn),
        "num_faces_gt": int(len(gt_f)),
        "num_faces_pred": int(len(pred_f)),
    }


def compute_dtype(opt) -> torch.dtype:
    """The run's compute dtype (edgerunner_tpu/utils/misc.py:41-43): bf16
    under --mixed_precision bf16, else f32."""
    return torch.bfloat16 if opt.mixed_precision == "bf16" else torch.float32


def decode_model(model, opt):
    """The model in the run's compute dtype, as the JAX package decodes
    (its LMM's dtype): `model` itself when its weights have that dtype, else
    a copy of them in it on the same device (the point basis and the MoE
    router stay f32; under ep, with the model's share of the experts)."""
    from edgerunner_tpu_torch.models.lmm import LMM

    p = next(model.parameters())
    dtype = compute_dtype(opt)
    if p.dtype == dtype:
        return model
    copy = LMM(opt, dtype=dtype, device=p.device, ep=getattr(model, "ep", None))
    copy.load_state_dict(model.state_dict())
    return copy.eval()


def generate_eval(model, test_loader, opt, *, tokenizer=None, epoch: int = 0,
                  workspace: Optional[str] = None, log=None) -> dict:
    """Generation-quality eval over held-out samples (--eval_mode generate;
    edgerunner_tpu/eval.py:154-224).

    Decodes `opt.eval_gen_samples` held-out conditions in chunks of
    `opt.test_batch_size` (the last chunk padded by repeating its last row,
    so that every chunk decodes at one shape), in the run's compute dtype
    (`decode_model`), and scores each generated mesh against its
    ground-truth token stream with chamfer and F-score; the first four are
    written as testgen_ep{epoch}_{i}.obj. A sample whose mesh or metrics
    fail is logged and left out. Deterministic under opt.seed: the loader
    is unshuffled and generate_tokens seeds its generator from opt.seed.
    Returns {"n", "chamfer_mean", "chamfer_std", "fscore_mean",
    "fscore_std", "scores"}.
    """
    from edgerunner_tpu_torch.data.tokenize import save_mesh
    from edgerunner_tpu_torch.generate import generate_tokens

    log = log or (lambda *_: None)
    n_target = max(1, opt.eval_gen_samples)
    C = opt.num_cond_tokens

    conds, gts = [], []
    for batch in test_loader:
        for j in range(len(batch["conds"])):
            if len(conds) >= n_target:
                break
            conds.append(np.asarray(batch["conds"][j]))
            n_tok = int(batch["num_tokens"][j])
            gts.append(np.asarray(batch["labels"][j])[C + 1:n_tok - 1])
        if len(conds) >= n_target:
            break
    n = len(conds)
    if n == 0:
        return {"n": 0, "scores": []}

    B = max(1, opt.test_batch_size)
    conds_arr = np.stack(conds)
    pad = (-n) % B
    if pad:
        conds_arr = np.concatenate([conds_arr, conds_arr[-1:].repeat(pad, 0)])
    decoder = decode_model(model, opt)
    tokens = np.concatenate([
        generate_tokens(decoder, conds_arr[i:i + B], num_faces=int(opt.test_num_face[0]))
        for i in range(0, len(conds_arr), B)])[:n]
    del decoder

    scores = []
    for i in range(n):
        out_path = (os.path.join(workspace, f"testgen_ep{epoch}_{i}.obj")
                    if workspace and i < 4 else None)
        try:
            pv, pf = save_mesh(tokens[i], opt, out_path, tokenizer=tokenizer)
            gv, gf = save_mesh(gts[i], opt, None, tokenizer=tokenizer)
            scores.append(mesh_metrics(gv, gf, pv, pf, n=2000))
        except Exception as e:  # noqa: BLE001 - the eval must not end training
            log(f"mesh metrics failed on sample {i}: {e}")

    ch = np.asarray([s["chamfer_l2"] for s in scores], np.float64)
    ch = ch[np.isfinite(ch)]
    fs = np.asarray([s["fscore"] for s in scores], np.float64)
    return {
        "n": len(scores),
        "chamfer_mean": float(ch.mean()) if len(ch) else float("inf"),
        "chamfer_std": float(ch.std()) if len(ch) else float("inf"),
        "fscore_mean": float(fs.mean()) if len(fs) else 0.0,
        "fscore_std": float(fs.std()) if len(fs) else 0.0,
        "scores": scores,
    }
