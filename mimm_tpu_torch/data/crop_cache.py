"""The decoded-crop cache: decode each CXR once and keep only the pixels any
augmentation can touch (mimm_tpu/data/crop_cache.py counterpart).

A full-resolution MIMIC-CXR (~2544 x 3056) decodes in tens of ms, while
RandomAffine(deg <= 20, translate <= 10%) + CenterCrop(img_size) reads
only a bounded centre window of it (~1024 x 1085 px at 256).  The cache
keeps that window as a raw ``.npz``; a hit replaces the decode with one
read, and the transform of the window (transforms.
reference_transform_window) gives the full image's bits.

The layout is the JAX package's, so a cache that its
``cli/prebuild_cache.py`` wrote reads as hits here and back: one
``<cache_dir>/<img_id>.w<img_size>.npz`` per image with ``win`` (the
window in the source dtype) and ``meta`` = [oy, ox, h, w, version].
Writes go to a temporary file and are renamed, so loader threads may race
on a miss.
"""

from __future__ import annotations

import math
import os
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

# The reference's augmentation bounds (helpers.py:151-153).  The window is
# derived from them; changing them invalidates every entry (bump _VERSION).
DEGREES = 20.0
TRANSLATE = (0.1, 0.1)
_VERSION = 1


def support_window(h: int, w: int, out_size: int
                   ) -> Tuple[int, int, int, int]:
    """(oy, ox, wh, ww) of the source window that holds every pixel the
    affine + centre crop can sample, over all (angle, tx, ty) draws: output
    pixel centres lie within ``half_out`` of the centre, the inverse map is
    R⁻¹(p − c − t) + c with |t| <= translate·size (+0.5 for the round),
    so |src − c| <= cos·a + sin·b per axis, +1 px for the floor."""
    cos = math.cos(math.radians(DEGREES))
    sin = math.sin(math.radians(DEGREES))
    half_out = out_size / 2.0 + 1.5  # the crop offset's round + pixel centres
    max_tx = TRANSLATE[0] * w + 0.5
    max_ty = TRANSLATE[1] * h + 0.5
    half_x = cos * (half_out + max_tx) + sin * (half_out + max_ty) + 1.0
    half_y = sin * (half_out + max_tx) + cos * (half_out + max_ty) + 1.0
    cx, cy = w * 0.5, h * 0.5
    ox = max(0, int(math.floor(cx - half_x)))
    oy = max(0, int(math.floor(cy - half_y)))
    x1 = min(w, int(math.ceil(cx + half_x)) + 1)
    y1 = min(h, int(math.ceil(cy + half_y)) + 1)
    return oy, ox, y1 - oy, x1 - ox


def from_config(cfg) -> Optional["DecodedCropCache"]:
    """A cache iff ``cfg.decoded_crop_cache`` names a directory."""
    d = cfg.decoded_crop_cache
    return DecodedCropCache(d, cfg.img_size) if d else None


class DecodedCropCache:
    """A read-through cache over ``pipeline._imread``: ``read(img_dir,
    img_id)`` gives ``(win, oy, ox, h, w)`` or None for an unreadable
    source (the loader skips and counts it).  ``hits`` and ``misses``
    count the reads of every thread."""

    def __init__(self, cache_dir: str, img_size: int):
        self.cache_dir = cache_dir
        self.img_size = img_size
        os.makedirs(cache_dir, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self._lock = threading.Lock()

    def _path(self, img_id: str) -> str:
        return os.path.join(self.cache_dir, f"{img_id}.w{self.img_size}.npz")

    def valid(self, img_id: str) -> bool:
        """True iff a current-version entry exists (reads ``meta`` only)."""
        try:
            with np.load(self._path(img_id)) as z:
                return int(z["meta"][4]) == _VERSION
        except (OSError, KeyError, ValueError, IndexError):
            return False

    def _count(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self.hits += 1
            else:
                self.misses += 1

    def read(self, img_dir: str, img_id: str
             ) -> Optional[Tuple[np.ndarray, int, int, int, int]]:
        path = self._path(img_id)
        try:
            with np.load(path) as z:
                meta = z["meta"]
                if int(meta[4]) == _VERSION:
                    self._count(True)
                    return (z["win"], int(meta[0]), int(meta[1]),
                            int(meta[2]), int(meta[3]))
        except (OSError, KeyError, ValueError, IndexError):
            pass  # a miss: absent, another version or a torn write
        self._count(False)
        return self._build(img_dir, img_id, path)

    def _build(self, img_dir: str, img_id: str, path: str):
        from mimm_tpu_torch.data.pipeline import _imread
        img = _imread(os.path.join(img_dir, img_id))
        if img is None:
            return None
        if img.ndim == 3:
            img = img[..., 0]
        h, w = img.shape[:2]
        oy, ox, wh, ww = support_window(h, w, self.img_size)
        win = np.ascontiguousarray(img[oy:oy + wh, ox:ox + ww])
        write(path, win, (oy, ox, h, w))
        return win, oy, ox, h, w


def write(path: str, win: np.ndarray, geometry: Tuple[int, int, int, int]
          ) -> None:
    """One entry: ``win`` cut at (oy, ox) from an (h, w) source, written to
    a temporary file in the same directory and renamed over ``path``."""
    meta = np.array([*geometry, _VERSION], np.int64)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp.npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, win=win, meta=meta)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
