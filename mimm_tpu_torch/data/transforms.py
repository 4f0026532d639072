"""The image transform chain with reference parity
(mimm_tpu/data/transforms.py counterpart).

Reference chain (helpers.py:146-161, duplicated at main_utils.py:35-44):

    int16 cast -> ToPILImage -> RandomAffine(deg ±20, translate ±10%)
    -> CenterCrop(img_size) -> float32 -> divide by max(1e-3, img.max())

``affine_crop`` inverse-maps only the central ``img_size``² output grid of
the affined image (torchvision's matrix convention, nearest neighbour,
fill 0) instead of the whole ~2544 x 3056 CXR.  The draws are
torchvision's distributions from a numpy Generator, so a sample is a pure
function of (seed, epoch, index).

An 8- or 16-bit source goes through the port's host library
(data/native_ops.py, csrc/host/mimm_host.cpp), on the branches where the
JAX package takes its own (mimm_tpu/data/transforms.py:160-243): the
affine crop of the train path, raw or normalized, over a whole image or a
crop-cache window, and the center crop of the eval path.  The library
computes what ``affine_crop`` / ``center_crop`` + ``max_normalize`` do
here, bit for bit, without the GIL; a failed build raises.  The numpy
functions stay the plain version the tests hold the library against, and
the path of other dtypes, which take the reference's int16 cast (equal to
sampling an 8- or 16-bit source in its own dtype below 2^15, the range of
12-bit CXRs).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from mimm_tpu_torch.data import native_ops

_INTEGER = (np.uint8, np.uint16)


def sample_affine_params(rng: np.random.Generator, width: int, height: int,
                         degrees: Tuple[float, float] = (-20.0, 20.0),
                         translate: Tuple[float, float] = (0.1, 0.1)
                         ) -> Tuple[float, int, int]:
    """Draw (angle, tx, ty) as torchvision RandomAffine.get_params does."""
    angle = float(rng.uniform(degrees[0], degrees[1]))
    max_dx = translate[0] * width
    max_dy = translate[1] * height
    tx = int(round(float(rng.uniform(-max_dx, max_dx))))
    ty = int(round(float(rng.uniform(-max_dy, max_dy))))
    return angle, tx, ty


def _inverse_affine_matrix(center: Tuple[float, float], angle: float,
                           translate: Tuple[float, float]
                           ) -> Tuple[float, ...]:
    """The inverse affine matrix, torchvision's convention (scale 1, shear
    0): output (x, y) -> input coordinates."""
    rot = math.radians(angle)
    cx, cy = center
    tx, ty = translate
    a = math.cos(rot)
    b = math.sin(rot)
    # inverse of T(c+t) R(rot) T(-c):  R^{-1} = [[a, b], [-b, a]]
    m0, m1 = a, b
    m3, m4 = -b, a
    m2 = m0 * (-cx - tx) + m1 * (-cy - ty) + cx
    m5 = m3 * (-cx - tx) + m4 * (-cy - ty) + cy
    return m0, m1, m2, m3, m4, m5


def affine_crop(img: np.ndarray, angle: float, tx: int, ty: int,
                out_size: int, src_origin: Tuple[int, int] = (0, 0),
                full_shape: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """RandomAffine(NEAREST, fill=0) then CenterCrop, over the central
    ``out_size``² grid only.  ``src_origin`` / ``full_shape`` (the crop
    cache): ``img`` is a window cut at that origin from a ``full_shape``
    source; the geometry is the full image's and the integer origin is
    subtracted after the floor, so the result is the full image's."""
    h, w = full_shape if full_shape is not None else img.shape[:2]
    cx, cy = w * 0.5, h * 0.5
    m0, m1, m2, m3, m4, m5 = _inverse_affine_matrix((cx, cy), angle, (tx, ty))
    # CenterCrop's offsets (torchvision: round((H - out) / 2))
    top = int(round((h - out_size) / 2.0))
    left = int(round((w - out_size) / 2.0))
    ys, xs = np.meshgrid(np.arange(out_size) + top,
                         np.arange(out_size) + left, indexing="ij")
    # PIL samples at pixel centres (x + 0.5, y + 0.5), then floors
    fx = xs + 0.5
    fy = ys + 0.5
    sx = np.floor(m0 * fx + m1 * fy + m2).astype(np.int64)
    sy = np.floor(m3 * fx + m4 * fy + m5).astype(np.int64)
    oy0, ox0 = src_origin
    if oy0 or ox0 or full_shape is not None:
        sx -= ox0
        sy -= oy0
        # the window's bounds: the window covers the whole affine support
        # (crop_cache.support_window), so no in-image coordinate lies
        # outside it
        h, w = img.shape[:2]
    valid = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    out = img[np.clip(sy, 0, h - 1), np.clip(sx, 0, w - 1)]
    return np.where(valid, out, 0).astype(img.dtype)


def center_crop(img: np.ndarray, out_size: int) -> np.ndarray:
    """CenterCrop, zero-padded where the image is smaller (torchvision)."""
    h, w = img.shape[:2]
    if h < out_size or w < out_size:
        ph, pw = max(out_size - h, 0), max(out_size - w, 0)
        img = np.pad(img, ((ph // 2 + ph % 2, ph // 2),
                           (pw // 2 + pw % 2, pw // 2)))
        h, w = img.shape[:2]
    top = int(round((h - out_size) / 2.0))
    left = int(round((w - out_size) / 2.0))
    return img[top:top + out_size, left:left + out_size]


def max_normalize(img: np.ndarray) -> np.ndarray:
    """float32 cast, then a divide by max(1e-3, img.max())
    (helpers.py:156-159)."""
    img = img.astype(np.float32)
    return img / max(1e-3, float(img.max()))


def _source(img: np.ndarray) -> np.ndarray:
    """The array the chain samples: 8- and 16-bit sources as they are,
    others cast to int16 as the reference does."""
    return img if img.dtype in _INTEGER else img.astype(np.int16)


def _finish(out: np.ndarray, dtype, raw: bool) -> np.ndarray:
    """``raw`` (compact transfer) keeps an 8- or 16-bit crop as it is, for
    the step to normalize on the device (ops/image_norm.py); anything else
    is normalized here."""
    return np.ascontiguousarray(out) if raw and dtype in _INTEGER \
        else max_normalize(out)


def reference_transform(img: np.ndarray, rng: Optional[np.random.Generator],
                        img_size: int, train: bool = True,
                        raw: bool = False) -> np.ndarray:
    """The reference augmentation chain on one grayscale image: (img_size,
    img_size) float32 in [0, 1], or with ``raw`` the crop in the source's
    8- or 16-bit dtype.  ``train=False`` (or no ``rng``) skips the affine:
    CenterCrop only, the deterministic eval path.  An 8- or 16-bit source
    goes through the host library (a smaller image's zero-padded eval crop
    stays in numpy, as in JAX)."""
    if img.ndim == 3:
        img = img[..., 0]
    h, w = img.shape[:2]
    native = img.dtype in _INTEGER
    top = int(round((h - img_size) / 2.0))
    left = int(round((w - img_size) / 2.0))
    if train and rng is not None:
        angle, tx, ty = sample_affine_params(rng, w, h)
        if native:
            m = _inverse_affine_matrix((w * 0.5, h * 0.5), angle, (tx, ty))
            if raw:
                return native_ops.affine_crop_raw(img, m, top, left, img_size)
            return native_ops.affine_crop_norm(img, m, top, left, img_size)
        out = affine_crop(_source(img), angle, tx, ty, img_size)
    elif native and h >= img_size and w >= img_size:
        if raw:
            return native_ops.center_crop_raw(img, top, left, img_size)
        return native_ops.center_crop_norm(img, top, left, img_size)
    else:
        out = center_crop(_source(img), img_size)
    return _finish(out, img.dtype, raw)


def reference_transform_window(win: np.ndarray, src_origin: Tuple[int, int],
                               full_shape: Tuple[int, int],
                               rng: Optional[np.random.Generator],
                               img_size: int, train: bool = True,
                               raw: bool = False) -> np.ndarray:
    """``reference_transform`` over a crop-cache window (data/crop_cache.py):
    ``win`` is the affine-support window cut from a ``full_shape`` source at
    ``src_origin``.  Every draw and offset is the full image's, so the
    output is ``reference_transform``'s on the whole decoded image.  An 8-
    or 16-bit window goes through the host library, its eval crop as a
    center crop of the window at the full image's offsets less the
    origin."""
    if win.ndim == 3:
        win = win[..., 0]
    h, w = full_shape
    oy0, ox0 = src_origin
    top = int(round((h - img_size) / 2.0))
    left = int(round((w - img_size) / 2.0))
    if train and rng is not None:
        angle, tx, ty = sample_affine_params(rng, w, h)
        if win.dtype in _INTEGER:
            m = _inverse_affine_matrix((w * 0.5, h * 0.5), angle, (tx, ty))
            return native_ops.affine_crop_win(win, m, top, left, oy0, ox0,
                                              img_size, raw=raw)
        out = affine_crop(_source(win), angle, tx, ty, img_size,
                          src_origin=src_origin, full_shape=(h, w))
    elif h >= img_size and w >= img_size:
        # the window always covers the central crop
        if win.dtype in _INTEGER:
            crop = native_ops.center_crop_raw if raw \
                else native_ops.center_crop_norm
            return crop(win, top - oy0, left - ox0, img_size)
        out = _source(win)[top - oy0:top - oy0 + img_size,
                           left - ox0:left - ox0 + img_size]
    else:
        # a smaller image: the window is the whole image, zero-padded here
        out = center_crop(_source(win), img_size)
    return _finish(out, win.dtype, raw)
