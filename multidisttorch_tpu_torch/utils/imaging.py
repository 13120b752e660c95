"""Host-side image-grid dumps (PNG), replacing torchvision.utils.save_image.

A copy of ``multidisttorch_tpu/utils/imaging.py`` (numpy only). The
reference saves two artifact families per epoch: an input-vs-reconstruction
grid and a prior-sample grid (``vae-hpo.py:106-116,163-170``). This is pure
host I/O; PIL when available, ``.npy`` fallback otherwise, so the package
has no hard imaging dependency.
"""

from __future__ import annotations

import os

import numpy as np


def save_image_grid(
    images: np.ndarray, path: str, nrow: int = 8, image_hw: int | None = None
) -> str:
    """Tile images into a grid and save as PNG (or .npy without PIL).

    ``images``: (N, H*W) or (N, H, W) or (N, H, W, C), values in [0,1].
    Returns the path actually written (extension may change on fallback).
    """
    imgs = np.asarray(images, dtype=np.float32)
    if imgs.ndim == 2:
        hw = image_hw or int(round(imgs.shape[1] ** 0.5))
        if hw * hw == imgs.shape[1]:
            imgs = imgs.reshape(-1, hw, hw)
        else:  # flattened HWC (e.g. 32*32*3)
            c = 3
            hw = int(round((imgs.shape[1] / c) ** 0.5))
            imgs = imgs.reshape(-1, hw, hw, c)
    n = imgs.shape[0]
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    h, w = imgs.shape[1], imgs.shape[2]
    channels = imgs.shape[3] if imgs.ndim == 4 else 1
    grid = np.zeros((nrows * h, ncol * w, channels), np.float32)
    for i in range(n):
        r, c = divmod(i, ncol)
        tile = imgs[i] if imgs.ndim == 4 else imgs[i][:, :, None]
        grid[r * h : (r + 1) * h, c * w : (c + 1) * w] = tile

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = (np.clip(grid, 0, 1) * 255).astype(np.uint8)
    try:
        from PIL import Image

        img = Image.fromarray(arr.squeeze(-1) if channels == 1 else arr)
        img.save(path)
        return path
    except ImportError:
        alt = os.path.splitext(path)[0] + ".npy"
        np.save(alt, arr)
        return alt
