"""Image conditioning IO of the port (edgerunner_tpu/data/image_io.py): load,
background removal, recenter on the foreground mask, white background
(reference: infer.py:61,71-83, rembg + kiui.op.recenter).

Images with an alpha channel use it as the mask; RGB photos go through
data/matting.py's classical foreground segmentation. PIL is imported inside the functions that read, resize or
write images, so that nothing else of the port needs it.
"""

from __future__ import annotations

import numpy as np


def _imread(path) -> np.ndarray:
    """An image file (a path or a binary file object) -> float32 in [0,1]."""
    from PIL import Image

    return np.asarray(Image.open(path)).astype(np.float32) / 255.0


def resize_bilinear(image: np.ndarray, h: int, w: int) -> np.ndarray:
    """[H, W, C] in [0,1] -> [h, w, C] through 8-bit PIL bilinear, as the
    JAX package resizes (and the reference's F.interpolate, bilinear)."""
    from PIL import Image

    img8 = Image.fromarray((np.clip(image, 0, 1) * 255).astype(np.uint8))
    return np.asarray(img8.resize((w, h), Image.BILINEAR)).astype(np.float32) / 255.0


def recenter(image: np.ndarray, mask: np.ndarray, border_ratio: float = 0.2) -> np.ndarray:
    """Crop to the mask's bounding box and paste it centred into a square
    canvas with a border (reference: kiui.op.recenter, infer.py:77)."""
    H, W = image.shape[:2]
    size = max(H, W)
    out = np.zeros((size, size, image.shape[2]), dtype=image.dtype)
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return image
    y0, y1 = ys.min(), ys.max() + 1
    x0, x1 = xs.min(), xs.max() + 1
    h, w = y1 - y0, x1 - x0
    desired = int(size * (1 - border_ratio))
    scale = desired / max(h, w)
    h2, w2 = int(h * scale), int(w * scale)
    oy, ox = (size - h2) // 2, (size - w2) // 2
    out[oy:oy + h2, ox:ox + w2] = resize_bilinear(image[y0:y1, x0:x1], h2, w2)
    return out


def render_points_image(points: np.ndarray, size: int = 224) -> np.ndarray:
    """Orthographic point-splat render with z-shading -> [size, size, 3] in
    [0,1]: a stand-in for a rendered view, correlated with the geometry."""
    img = np.ones((size, size), np.float32)
    xy = ((points[:, :2] * 0.45 + 0.5) * (size - 1)).astype(np.int64)
    z = points[:, 2]
    order = np.argsort(z)  # far to near; near splats overwrite
    shade = 0.25 + 0.5 * (z - z.min()) / max(float(np.ptp(z)), 1e-6)
    xs = np.clip(xy[order, 0], 0, size - 1)
    ys = np.clip(size - 1 - xy[order, 1], 0, size - 1)
    img[ys, xs] = shade[order]
    return np.stack([img] * 3, axis=-1)


def load_image_cond(path, size: int = 512, border_ratio: float = 0.2,
                    remove_bg: bool = True) -> np.ndarray:
    """An image file (path or binary file object) -> [size, size, 3] float32
    in [0,1], white background, recentred."""
    img = _imread(path)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[2] == 4:
        mask = img[..., 3] > 0.5
        img = recenter(img, mask, border_ratio)
        img = img[..., :3] * img[..., 3:4] + (1 - img[..., 3:4])  # white bg
    elif remove_bg:
        # background removal before recentring (reference: rembg, infer.py:61)
        from edgerunner_tpu_torch.data.matting import classical_foreground

        mask = classical_foreground(img[..., :3])
        img = np.concatenate([img[..., :3], mask[..., None].astype(np.float32)], axis=-1)
        img = recenter(img, mask, border_ratio)
        img = img[..., :3] * img[..., 3:4] + (1 - img[..., 3:4])  # white bg
    else:
        mask = img.mean(-1) < 0.99  # foreground on a white background
        img = recenter(img, mask, border_ratio)[..., :3]
    return resize_bilinear(img, size, size)
