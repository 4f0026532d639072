"""ctypes bindings for the port's host library, ``csrc/host/mimm_host.cpp``
(mimm_tpu/data/native_ops.py counterpart): the fused affine + crop (+
max-normalize) of the loader's transform and the WordPiece encoder.

The library is built with g++ at first use into
``build/mimm_tpu_torch/libmimm_host-<hash>.so`` (the hash covers the source
and the flags), under the same per-library lock as the CUDA kernels
(``ops/_build.py``).  It is compiled without ``-march=native`` and with
``-ffp-contract=off``: a fused multiply-add in ``m[0] * fx + base_x``
could move a floor by one pixel, and a library built for another host's
ISA could not fault mid-run.  A failed build raises with g++'s stderr:
nothing falls back to the numpy transforms or the Python encoder.

``ctypes.CDLL`` releases the GIL for the length of each call, so the
Loader's decode threads and the featurizer's threads run on several cores
at once.  The JAX package's own build of the library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import threading
from typing import List, Optional

import numpy as np

from mimm_tpu_torch.ops import _build

SOURCE = os.path.join(_build.CSRC, "host", "mimm_host.cpp")
NAME = "mimm_host"
GXX_FLAGS = ["-std=c++17", "-O3", "-fPIC", "-shared", "-ffp-contract=off"]
GXX = "g++"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_D = ctypes.POINTER(ctypes.c_double)
_F = ctypes.POINTER(ctypes.c_float)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_U16 = ctypes.POINTER(ctypes.c_uint16)
_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.c_int64
_PTR = {np.dtype(np.uint8): _U8, np.dtype(np.uint16): _U16}
_SUFFIX = {np.dtype(np.uint8): "u8", np.dtype(np.uint16): "u16"}


def _gxx() -> str:
    found = shutil.which(GXX)
    if found is None:
        raise RuntimeError(f"{GXX} not found on PATH: the host library "
                           f"(mimm_tpu_torch/csrc/host/mimm_host.cpp) is "
                           f"built with it at first use")
    return found


def library_path() -> str:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(_build.BUILD_DIR,
                        f"lib{NAME}-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the host library unless the current hash is built; returns
    its path.  A failed build raises with g++'s stderr."""
    out = library_path()
    _build.compile_locked(NAME, out,
                          lambda tmp: [_gxx(), *GXX_FLAGS, "-o", tmp, SOURCE])
    return out


def _declare(lib: ctypes.CDLL) -> None:
    for sfx, p in (("u8", _U8), ("u16", _U16)):
        getattr(lib, f"affine_crop_norm_{sfx}").argtypes = \
            [p, _I64, _I64, _D, _I64, _I64, _I64, _F]
        getattr(lib, f"affine_crop_raw_{sfx}").argtypes = \
            [p, _I64, _I64, _D, _I64, _I64, _I64, p]
        getattr(lib, f"affine_crop_norm_{sfx}_win").argtypes = \
            [p, _I64, _I64, _D, _I64, _I64, _I64, _I64, _I64, _F]
        getattr(lib, f"affine_crop_raw_{sfx}_win").argtypes = \
            [p, _I64, _I64, _D, _I64, _I64, _I64, _I64, _I64, p]
        getattr(lib, f"center_crop_norm_{sfx}").argtypes = \
            [p, _I64, _I64, _I64, _I64, _I64, _F]
        getattr(lib, f"center_crop_raw_{sfx}").argtypes = \
            [p, _I64, _I64, _I64, _I64, _I64, p]
    lib.mimm_wp_create.restype = ctypes.c_void_p
    lib.mimm_wp_create.argtypes = [ctypes.c_char_p]
    lib.mimm_wp_destroy.argtypes = [ctypes.c_void_p]
    lib.mimm_wp_encode.restype = _I64
    lib.mimm_wp_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, _I64,
                                   ctypes.c_int, _I32, _I64]


def get_lib() -> ctypes.CDLL:
    """The loaded host library, built on first use; raises if it cannot
    be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _declare(lib)
            _lib = lib
        return _lib


def _source(img: np.ndarray) -> np.ndarray:
    if img.dtype not in _PTR:
        raise TypeError(f"the host library takes uint8 or uint16 images, "
                        f"not {img.dtype}")
    return np.ascontiguousarray(img)


def affine_crop_norm(img: np.ndarray, matrix, top: int, left: int,
                     out_size: int) -> np.ndarray:
    """Fused affine + crop + max-normalize of a uint8/uint16 image to an
    (out_size, out_size) float32 crop.  ``matrix``: the 6-tuple of
    ``transforms._inverse_affine_matrix``."""
    img = _source(img)
    out = np.empty((out_size, out_size), np.float32)
    fn = getattr(get_lib(), f"affine_crop_norm_{_SUFFIX[img.dtype]}")
    fn(img.ctypes.data_as(_PTR[img.dtype]), img.shape[0], img.shape[1],
       (ctypes.c_double * 6)(*matrix), top, left, out_size,
       out.ctypes.data_as(_F))
    return out


def affine_crop_raw(img: np.ndarray, matrix, top: int, left: int,
                    out_size: int) -> np.ndarray:
    """Affine + crop without normalization, in the source's dtype (the
    compact host-to-device transfer: the step normalizes on the device,
    ops/image_norm.py)."""
    img = _source(img)
    ptr = _PTR[img.dtype]
    out = np.empty((out_size, out_size), img.dtype)
    fn = getattr(get_lib(), f"affine_crop_raw_{_SUFFIX[img.dtype]}")
    fn(img.ctypes.data_as(ptr), img.shape[0], img.shape[1],
       (ctypes.c_double * 6)(*matrix), top, left, out_size,
       out.ctypes.data_as(ptr))
    return out


def affine_crop_win(img: np.ndarray, matrix, top: int, left: int,
                    src_oy: int, src_ox: int, out_size: int,
                    raw: bool) -> np.ndarray:
    """Affine + crop over a crop-cache window (data/crop_cache.py): ``img``
    is cut from a larger source at origin (src_oy, src_ox); ``matrix``,
    ``top`` and ``left`` stay in the full image's frame.  ``raw=False``
    fuses the max-normalize."""
    img = _source(img)
    ptr = _PTR[img.dtype]
    kind = "raw" if raw else "norm"
    out = np.empty((out_size, out_size), img.dtype if raw else np.float32)
    fn = getattr(get_lib(), f"affine_crop_{kind}_{_SUFFIX[img.dtype]}_win")
    fn(img.ctypes.data_as(ptr), img.shape[0], img.shape[1],
       (ctypes.c_double * 6)(*matrix), top, left, src_oy, src_ox, out_size,
       out.ctypes.data_as(ptr if raw else _F))
    return out


def center_crop_raw(img: np.ndarray, top: int, left: int,
                    out_size: int) -> np.ndarray:
    """Center crop without normalization (the eval path's compact
    transfer)."""
    img = _source(img)
    ptr = _PTR[img.dtype]
    out = np.empty((out_size, out_size), img.dtype)
    fn = getattr(get_lib(), f"center_crop_raw_{_SUFFIX[img.dtype]}")
    fn(img.ctypes.data_as(ptr), img.shape[0], img.shape[1], top, left,
       out_size, out.ctypes.data_as(ptr))
    return out


def center_crop_norm(img: np.ndarray, top: int, left: int,
                     out_size: int) -> np.ndarray:
    """Center crop + max-normalize to float32 (the eval path)."""
    img = _source(img)
    out = np.empty((out_size, out_size), np.float32)
    fn = getattr(get_lib(), f"center_crop_norm_{_SUFFIX[img.dtype]}")
    fn(img.ctypes.data_as(_PTR[img.dtype]), img.shape[0], img.shape[1], top,
       left, out_size, out.ctypes.data_as(_F))
    return out


def wp_create(vocab_path: str) -> int:
    """Load ``vocab.txt`` into a native WordPiece handle.  The handle is
    read-only after creation, so ``wp_encode`` may run on many threads at
    once."""
    handle = get_lib().mimm_wp_create(os.fsencode(vocab_path))
    if not handle:
        raise FileNotFoundError(f"the host library could not read the "
                                f"vocabulary {vocab_path!r}")
    return handle


def wp_destroy(handle: int) -> None:
    if handle:
        get_lib().mimm_wp_destroy(handle)


def wp_encode(handle: int, text: str, do_lower_case: bool = True
              ) -> Optional[List[int]]:
    """Wordpiece ids of ``text`` (no [CLS]/[SEP]), or None when the text
    holds a non-ASCII byte: the C++ encoder implements the ASCII subset of
    BERT's basic tokenization only, and the Python encoder takes such a
    text."""
    data = text.encode("utf-8")
    buf = np.empty(len(data) + 8, np.int32)  # at most one id a byte
    n = get_lib().mimm_wp_encode(handle, data, len(data), int(do_lower_case),
                                 buf.ctypes.data_as(_I32), buf.shape[0])
    if n < 0:
        return None
    return buf[:n].tolist()
