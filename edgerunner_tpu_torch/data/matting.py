"""Background removal for image conditioning, of the port
(edgerunner_tpu/data/matting.py).

The reference runs rembg (a u2net saliency model) on input photos before
recentring (reference: infer.py:61, infer_dit.py:75). Here, as the JAX
package's default: a classical segmentation, border-colour background
estimation, an Otsu threshold on the colour distance, border-connected
flood classification and morphological clean-up (scipy), for studio-style
product shots. The JAX package's hooks for another extractor are not ported.
"""

from __future__ import annotations

import numpy as np


def _otsu_threshold(values: np.ndarray, bins: int = 128) -> float:
    """Otsu: the threshold that maximises the between-class variance."""
    hist, edges = np.histogram(values, bins=bins)
    hist = hist.astype(np.float64)
    centers = (edges[:-1] + edges[1:]) / 2
    w0 = np.cumsum(hist)
    w1 = w0[-1] - w0
    mu_cum = np.cumsum(hist * centers)
    mu0 = np.where(w0 > 0, mu_cum / np.maximum(w0, 1), 0)
    mu1 = np.where(w1 > 0, (mu_cum[-1] - mu_cum) / np.maximum(w1, 1), 0)
    between = w0 * w1 * (mu0 - mu1) ** 2
    return float(centers[int(np.argmax(between))])


def classical_foreground(img: np.ndarray) -> np.ndarray:
    """Border-seeded background segmentation -> bool [H,W], True = foreground."""
    from scipy import ndimage

    H, W = img.shape[:2]
    bw = max(2, min(H, W) // 50)  # border band width
    border = np.concatenate([
        img[:bw].reshape(-1, 3), img[-bw:].reshape(-1, 3),
        img[:, :bw].reshape(-1, 3), img[:, -bw:].reshape(-1, 3)])
    bg_color = np.median(border, axis=0)

    dist = np.linalg.norm(img - bg_color, axis=-1)
    thr = max(_otsu_threshold(dist.ravel()), 0.08)
    bg_like = dist < thr

    # background = bg-coloured regions connected to the border; an object of
    # the background's colour floating in the middle stays foreground
    labels, _ = ndimage.label(bg_like)
    border_labels = np.unique(np.concatenate([
        labels[0], labels[-1], labels[:, 0], labels[:, -1]]))
    border_labels = border_labels[border_labels != 0]
    fg = ~np.isin(labels, border_labels)
    fg = ndimage.binary_fill_holes(fg)
    fg = ndimage.binary_opening(fg, iterations=max(1, bw // 2))
    if not fg.any():  # degenerate (a flat image): keep everything
        return np.ones((H, W), bool)
    # keep components of at least 1% of the largest (drops speckle)
    labels, n = ndimage.label(fg)
    if n > 1:
        sizes = ndimage.sum_labels(np.ones_like(labels), labels, index=np.arange(1, n + 1))
        keep = np.flatnonzero(sizes >= 0.01 * sizes.max()) + 1
        fg = np.isin(labels, keep)
    return fg
