"""Tissue-mask and grid-tiling utilities (histopathology slides).

Capability parity with the reference's Otsu mask + tile extraction
(the reference's src/preprocessing/patch_preprocessing.py:13-53): grayscale
Otsu threshold on a slide thumbnail, tissue = gray < threshold, grid tiles
kept when tissue fraction >= 1 - background_thresh (0.8 default -> >=20%
tissue).

Redesign notes: Otsu is implemented directly on the numpy histogram (the
reference pulls in scikit-image, absent here); tiling is a pure function of
the mask + dimensions, so it is testable without OpenSlide. OpenSlide stays
an optional host-side dependency for real .svs files (I/O-bound, not device
work — SURVEY.md §2.6).

A copy of `gemm_gan_tpu/data/tiles.py` (host code: numpy, pandas and the
standard library; optional imports stay lazy), kept here so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# skimage's rgb2gray luminance weights (ITU-R BT.709)
_GRAY_W = np.array([0.2125, 0.7154, 0.0721], np.float64)


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8/float RGB -> [H, W] float64 gray in [0, 1]."""
    x = np.asarray(rgb, np.float64)
    if x.max() > 1.0:
        x = x / 255.0
    return x[..., :3] @ _GRAY_W


def otsu_threshold(gray: np.ndarray, nbins: int = 256) -> float:
    """Classic Otsu: maximize between-class variance over histogram splits."""
    g = np.asarray(gray, np.float64).ravel()
    lo, hi = float(g.min()), float(g.max())
    if hi <= lo:
        return lo
    hist, edges = np.histogram(g, bins=nbins, range=(lo, hi))
    centers = (edges[:-1] + edges[1:]) / 2.0
    hist = hist.astype(np.float64)
    w0 = np.cumsum(hist)
    w1 = w0[-1] - w0
    m0 = np.cumsum(hist * centers)
    mt = m0[-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        mu0 = m0 / w0
        mu1 = (mt - m0) / w1
        between = w0 * w1 * (mu0 - mu1) ** 2
    between[~np.isfinite(between)] = -1.0
    return float(centers[int(np.argmax(between))])


def otsu_mask(thumbnail_rgb: np.ndarray) -> np.ndarray:
    """Tissue mask: gray < otsu (tissue is darker than background on H&E)."""
    gray = rgb_to_gray(thumbnail_rgb)
    return (gray < otsu_threshold(gray)).astype(np.uint8)


def extract_tiles(mask: np.ndarray, full_dims: Tuple[int, int],
                  tile_size: int = 512, background_thresh: float = 0.8
                  ) -> List[Tuple[int, int, int, int]]:
    """Grid tiles (x0, y0, size_x, size_y) at level-0 coordinates whose
    tissue fraction in the (possibly downscaled) mask is >=
    1 - background_thresh. `full_dims` = (width, height) at level 0."""
    W, H = full_dims
    mh, mw = mask.shape
    scale_x = W / mw
    scale_y = H / mh
    min_tissue = 1.0 - background_thresh

    valid = []
    for y0 in range(0, H + 1, tile_size):
        for x0 in range(0, W + 1, tile_size):
            mx = int(x0 / scale_x)
            my = int(y0 / scale_y)
            tw = max(int(tile_size / scale_x), 0)
            th = max(int(tile_size / scale_y), 0)
            tile_mask = mask[my:my + th, mx:mx + tw]
            if tile_mask.size == 0:
                continue
            if np.count_nonzero(tile_mask) / tile_mask.size < min_tissue:
                continue
            valid.append((x0, y0, min(tile_size, W - x0), min(tile_size, H - y0)))
    return valid


def tiles_from_array(image_rgb: np.ndarray, tiles: Sequence[Tuple[int, int, int, int]],
                     tile_size: int) -> np.ndarray:
    """Crop tiles out of an in-memory RGB array, zero-padding edge tiles to
    the full tile_size (static shapes for the encoder batch)."""
    out = np.zeros((len(tiles), tile_size, tile_size, 3), image_rgb.dtype)
    for i, (x0, y0, sx, sy) in enumerate(tiles):
        out[i, :sy, :sx] = image_rgb[y0:y0 + sy, x0:x0 + sx]
    return out


def valid_patches_for_slide(thumbnail_rgb: np.ndarray,
                            full_dims: Tuple[int, int],
                            tile_sizes: Sequence[int] = (1024, 512, 256, 128),
                            background_thresh: float = 0.8
                            ) -> Dict[int, List[Tuple[int, int, int, int]]]:
    """The reference's multi-resolution valid_patches entry for one slide
    (patch_preprocessing.py:71-83)."""
    mask = otsu_mask(thumbnail_rgb)
    return {size: extract_tiles(mask, full_dims, size, background_thresh)
            for size in tile_sizes}


def save_valid_patches(index: Dict[str, Dict[int, list]], path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({case: {str(k): v for k, v in sizes.items()}
                   for case, sizes in index.items()}, f)


def load_valid_patches(path: str) -> Dict[str, Dict[int, list]]:
    with open(path) as f:
        raw = json.load(f)
    return {case: {int(k): [tuple(t) for t in v] for k, v in sizes.items()}
            for case, sizes in raw.items()}


# ------------------------------------------------------------- openslide IO
def open_slide(path: str):
    """Gated OpenSlide import (absent in this image; real .svs reads only)."""
    try:
        import openslide
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "openslide is required to read .svs slides; install it on the "
            "ingest host (tile extraction itself is numpy-only)") from e
    return openslide.OpenSlide(path)


def slide_thumbnail(slide, level: Optional[int] = None) -> np.ndarray:
    """RGB thumbnail at the given (or coarsest) level."""
    lvl = slide.level_count - 1 if level is None else level
    w, h = slide.level_dimensions[lvl]
    return np.asarray(slide.read_region((0, 0), lvl, (w, h)))[..., :3]


def read_tile(slide, x0: int, y0: int, size: int) -> np.ndarray:
    return np.asarray(slide.read_region((x0, y0), 0, (size, size)))[..., :3]
