"""Mesh (de)tokenization glue (reference: core/provider.py:39-147).

Token streams carry a +3 special-token offset at the model layer
(0=PAD, 1=BOS, 2=EOS; reference: provider.py:108,115).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from edgerunner_tpu_torch.config import Options
from edgerunner_tpu_torch.data import mesh_io


def tokenize_mesh(vertices: np.ndarray, faces: np.ndarray, discrete_bins: int,
                  tokenizer=None) -> np.ndarray:
    """vertices [N,3] in [-1,1], faces [M,3] -> int tokens (with the +3
    offset), as edgerunner_tpu/data/tokenize.py:17-39 makes them."""
    if tokenizer is None:
        # naive scheme: canonical-sorted faces flattened to 9 coords each
        sort_inds = np.lexsort(vertices.T)
        vertices = vertices[sort_inds]
        vertices = vertices[:, [2, 1, 0]]  # xyz -> zyx
        inv_inds = np.argsort(sort_inds)
        faces = inv_inds[faces]
        start_inds = faces.argmin(axis=1)
        take = start_inds[:, None] + np.arange(3)[None, :]
        faces = np.take_along_axis(
            np.concatenate([faces, faces[:, :2]], axis=1), take, axis=1)
        faces = np.array(sorted(faces.tolist()))
        coords = (vertices[faces] + 1) * 0.5 * discrete_bins
        tokens = coords.clip(0, discrete_bins - 1).astype(np.int64).reshape(-1)
    else:
        tokens, _, _ = tokenizer.encode(vertices, faces)
    return tokens + 3


def detokenize_mesh(tokens: np.ndarray, discrete_bins: Optional[int] = None,
                    tokenizer=None) -> Tuple[np.ndarray, np.ndarray]:
    """Tokens (with the +3 offset) -> (vertices, faces); tolerates model-emitted noise
    (reference: provider.py:112-147)."""
    tokens = np.asarray(tokens, np.int64) - 3

    if tokenizer is None:
        if len(tokens) % 9 != 0:
            tokens = tokens[: -(len(tokens) % 9)] if len(tokens) >= 9 else tokens[:0]
        if len(tokens) == 0:
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
        invalid = (tokens < 0).reshape(-1, 9).any(axis=1)
        coords = tokens.reshape(-1, 3)
        if discrete_bins is None:
            vertices = coords / max(coords.max(), 1) * 2 - 1
        else:
            vertices = (coords + 0.5) / discrete_bins * 2 - 1
        faces = np.arange(len(vertices)).reshape(-1, 3)
        faces = faces[~invalid]
        vertices = vertices[:, [2, 1, 0]]  # zyx -> xyz
    else:
        vertices, faces, _ = tokenizer.decode(tokens)
    return vertices, faces


def save_mesh(tokens: np.ndarray, opt: Options, path: Optional[str] = None,
              tokenizer=None, clean: bool = True, verbose: bool = False):
    """Trim at EOS, detokenize, clean up, return (verts, faces) or write file
    (reference: provider.py:39-66)."""
    tokens = np.asarray(tokens)
    eos_idx = np.nonzero(tokens == opt.eos_token_id)[0]
    if len(eos_idx) > 0:
        tokens = tokens[: eos_idx[0]]

    vertices, faces = detokenize_mesh(tokens, opt.discrete_bins, tokenizer=tokenizer)
    if verbose:
        print(f"[INFO] vertices: {vertices.shape[0]}, faces: {faces.shape[0]}")

    if clean:
        vertices, faces = mesh_io.clean_mesh(vertices, faces)
        if verbose:
            print(f"[INFO] cleaned vertices: {vertices.shape[0]}, faces: {faces.shape[0]}")

    if path is None:
        return vertices, faces
    mesh_io.save_mesh_file(path, vertices, faces)
    return vertices, faces
