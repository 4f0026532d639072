"""The port's host library (mimm_tpu_torch/csrc/host/mimm_host.cpp through
mimm_tpu_torch/data/native_ops.py, built here with g++) against the port's
numpy transforms and the JAX package's native_ops and
reference_transform / reference_transform_window, bit for bit.

* The entry points at the draws of tests/test_native_and_resume.py:20-66:
  ``affine_crop_norm`` / ``affine_crop_raw`` on a 300 x 280 uint8 and
  12-bit uint16 image at three (angle, tx, ty), ``center_crop_norm`` /
  ``center_crop_raw`` on a 200 x 180 image, and the windowed entry over a
  crop-cache window against the full-image entry (600 x 704, uint16).
* ``reference_transform`` over whole images and
  ``reference_transform_window`` over crop-cache windows (the shapes of
  tests/test_crop_cache.py:68-130, a 2544 x 3056 source among them, and
  images smaller than the crop), 8 draws each, uint8, 12-bit uint16 and
  uint16 over its full range, train and eval, raw and normalized: the
  port's output equals its numpy path's (``affine_crop`` /
  ``center_crop`` + ``max_normalize``, dtype included) and JAX's (with
  its native library loaded, as in its own tests), but for full-range
  uint16 on a smaller image's zero-padded eval crop, where JAX casts to
  int16.
* A build that fails raises with the compiler's message, for a g++ that
  cannot be found and for one that fails, and no read then takes numpy:
  ``reference_transform`` and ``reference_transform_window`` raise for
  an 8- and a 16-bit source on every path.
* The library is a ``ctypes.CDLL`` (calls drop the GIL), built under
  build/mimm_tpu_torch/, never the JAX package's build of it.

The JAX side runs in the pytest worker, the port side in a jax-free child
(tests/torch_port_child.py).
"""

import json
import os
import sys

import numpy as np
import pytest

SHAPES = [((600, 704), 256), ((704, 600), 256), ((300, 280), 128),
          ((256, 256), 256), ((180, 200), 256), ((2544, 3056), 256)]
SEEDS = 8
DTYPES = {"u8": (np.uint8, 256), "u16": (np.uint16, 4096),
          "u16full": (np.uint16, 65536)}
CASES = [f"{d}-{src}-{'train' if train else 'eval'}-{'raw' if raw else 'norm'}"
         for d in DTYPES for src in ("full", "window")
         for train in (True, False) for raw in (False, True)]
AFFINES = [(0.0, 0, 0), (17.3, 12, -9), (-20.0, -28, 30)]
ENTRY = ["affine_norm-u8", "affine_norm-u16", "affine_raw-u8",
         "affine_raw-u16", "center-u8", "window-u16"]


def _image(shape, dtype_key, seed=0):
    dtype, hi = DTYPES[dtype_key]
    return np.random.default_rng(seed).integers(0, hi, size=shape) \
        .astype(dtype)


def _window(support_window, img, out_size):
    oy, ox, wh, ww = support_window(img.shape[0], img.shape[1], out_size)
    return np.ascontiguousarray(img[oy:oy + wh, ox:ox + ww]), (oy, ox)


def _case(name):
    d, src, mode, kind = name.split("-")
    return d, src, mode == "train", kind == "raw"


def run_case(name, transforms, support_window, jax=False):
    """{key: output} of case ``name`` through ``transforms`` (either
    package's module)."""
    d, src, train, raw = _case(name)
    out = {}
    for (h, w), size in SHAPES:
        img = _image((h, w), d)
        win, origin = _window(support_window, img, size)
        if jax and d == "u16full" and not train and (h < size or w < size):
            continue      # JAX's zero-padded eval crop casts to int16
        for seed in range(SEEDS if train else 1):
            rng = np.random.default_rng(seed) if train else None
            key = f"{h}x{w}/{seed}"
            if src == "full":
                out[key] = transforms.reference_transform(
                    img, rng, size, train=train, raw=raw)
            else:
                out[key] = transforms.reference_transform_window(
                    win, origin, (h, w), rng, size, train=train, raw=raw)
    return out


def plain_case(name, transforms, support_window):
    """Case ``name`` through the port's numpy functions alone."""
    d, src, train, raw = _case(name)
    out = {}
    for (h, w), size in SHAPES:
        img = _image((h, w), d)
        win, origin = _window(support_window, img, size)
        for seed in range(SEEDS if train else 1):
            if train:
                rng = np.random.default_rng(seed)
                angle, tx, ty = transforms.sample_affine_params(rng, w, h)
                crop = transforms.affine_crop(img, angle, tx, ty, size) \
                    if src == "full" else transforms.affine_crop(
                        win, angle, tx, ty, size, src_origin=origin,
                        full_shape=(h, w))
            else:
                crop = transforms.center_crop(img, size)
            out[f"{h}x{w}/{seed}"] = np.ascontiguousarray(crop) if raw \
                else transforms.max_normalize(crop)
    return out


def run_entry(name, transforms, native_ops, support_window):
    """{key: output} of the entry-point case ``name``."""
    kind, d = name.split("-")
    out = {}
    if kind.startswith("affine"):
        dtype, hi = (np.uint8, 255) if d == "u8" else (np.uint16, 4095)
        img = np.random.default_rng(0).integers(0, hi, size=(300, 280)) \
            .astype(dtype)
        h, w = img.shape
        fn = native_ops.affine_crop_norm if kind == "affine_norm" \
            else native_ops.affine_crop_raw
        for i, (angle, tx, ty) in enumerate(AFFINES):
            m = transforms._inverse_affine_matrix((w * 0.5, h * 0.5), angle,
                                                  (tx, ty))
            top = int(round((h - 128) / 2.0))
            left = int(round((w - 128) / 2.0))
            out[f"{i}"] = fn(img, m, top, left, 128)
    elif kind == "center":
        img = np.random.default_rng(1).integers(0, 255, size=(200, 180)) \
            .astype(np.uint8)
        top, left = int(round((200 - 96) / 2.0)), int(round((180 - 96) / 2.0))
        out["norm"] = native_ops.center_crop_norm(img, top, left, 96)
        out["raw"] = native_ops.center_crop_raw(img, top, left, 96)
    else:
        img = _image((600, 704), "u16")
        win, (oy, ox) = _window(support_window, img, 256)
        m = transforms._inverse_affine_matrix((704 * 0.5, 600 * 0.5), -20.0,
                                              (70, -60))
        top, left = 172, 224        # CenterCrop's offsets in 600 x 704
        for raw in (False, True):
            out[f"win/{raw}"] = native_ops.affine_crop_win(
                win, m, top, left, oy, ox, 256, raw=raw)
        out["full/raw"] = native_ops.affine_crop_raw(img, m, top, left, 256)
        out["full/norm"] = native_ops.affine_crop_norm(img, m, top, left, 256)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from mimm_tpu.data import native_ops, transforms
    from mimm_tpu.data.crop_cache import support_window
    from tests.torch_port_child import run_child

    assert native_ops.get_lib() is not None, "JAX's native library"
    job = str(tmp_path_factory.mktemp("native_ops"))
    want = {}
    for case in CASES:
        want.update({f"case/{case}/{k}": v for k, v in run_case(
            case, transforms, support_window, jax=True).items()})
    for case in ENTRY:
        want.update({f"entry/{case}/{k}": v for k, v in run_entry(
            case, transforms, native_ops, support_window).items()})
    got, meta = run_child(__file__, job, timeout=600)
    return want, got, meta


def _first_diff(a, b):
    bad = np.argwhere(a != b)
    return f"{len(bad)} pixels differ, the first at {bad[0].tolist()}: " \
           f"{a[tuple(bad[0])]} against {b[tuple(bad[0])]}" if len(bad) \
        else "equal"


@pytest.mark.parametrize("case", CASES)
def test_transform_matches_numpy_and_jax(results, case):
    want, got, _ = results
    keys = sorted(k[len("port/"):] for k in got
                  if k.startswith(f"port/case/{case}/"))
    assert keys, case
    jax_keys = [k for k in keys if k in want]
    # JAX casts a full-range uint16 to int16 in its zero-padded eval crop
    assert len(jax_keys) == len(keys) or case.startswith("u16full"), case
    assert jax_keys, case
    for key in keys:
        port, plain = got[f"port/{key}"], got[f"plain/{key}"]
        assert port.dtype == plain.dtype, key
        assert np.array_equal(port, plain), (key, _first_diff(port, plain))
        if key in want:
            assert port.dtype == want[key].dtype, key
            assert np.array_equal(port, want[key]), \
                (key, _first_diff(port, want[key]))


@pytest.mark.parametrize("case", ENTRY)
def test_entry_points_match_jax(results, case):
    want, got, _ = results
    keys = sorted(k for k in want if k.startswith(f"entry/{case}/"))
    assert keys and keys == sorted(k[len("port/"):] for k in got
                                   if k.startswith(f"port/entry/{case}/"))
    for key in keys:
        port = got[f"port/{key}"]
        assert port.dtype == want[key].dtype, key
        assert np.array_equal(port, want[key]), \
            (key, _first_diff(port, want[key]))
    if case == "window-u16":
        assert np.array_equal(got[f"port/entry/{case}/win/True"],
                              got[f"port/entry/{case}/full/raw"])
        assert np.array_equal(got[f"port/entry/{case}/win/False"],
                              got[f"port/entry/{case}/full/norm"])


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_failed_build_raises_and_no_read_takes_numpy(results, compiler):
    meta = results[2]["failed_build"][compiler]
    assert meta["get_lib"].startswith("RuntimeError"), meta["get_lib"]
    assert meta["want_in_message"] in meta["get_lib"], meta["get_lib"]
    assert meta["reads"], meta
    for call, err in meta["reads"].items():
        assert err.startswith("RuntimeError"), (call, err)
    assert meta["built"] == [], meta["built"]


def test_library_is_a_ctypes_cdll(results):
    lib = results[2]["library"]
    assert lib["type"] == "CDLL", lib
    assert not lib["pythonapi"], lib          # ctypes releases the GIL
    assert lib["path"].startswith("build/mimm_tpu_torch/libmimm_host-"), lib
    assert lib["flags"] == ["-std=c++17", "-O3", "-fPIC", "-shared",
                            "-ffp-contract=off"], lib
    assert not any(m.endswith("libmimm_host.so") for m in lib["maps"]), lib


def _error_of(fn) -> str:
    try:
        fn()
    except Exception as e:    # noqa: BLE001 - the message is the result
        return f"{type(e).__name__}: {e}"
    return "no error"


def _child(job):
    import ctypes
    import stat
    import tempfile

    from mimm_tpu_torch.data import native_ops, transforms
    from mimm_tpu_torch.data.crop_cache import support_window
    from mimm_tpu_torch.ops import _build
    from tests.torch_port_child import REPO

    out, meta = {}, {}
    for case in CASES:
        out.update({f"port/case/{case}/{k}": v for k, v in run_case(
            case, transforms, support_window).items()})
        out.update({f"plain/case/{case}/{k}": v for k, v in plain_case(
            case, transforms, support_window).items()})
    for case in ENTRY:
        out.update({f"port/entry/{case}/{k}": v for k, v in run_entry(
            case, transforms, native_ops, support_window).items()})

    lib = native_ops.get_lib()
    with open("/proc/self/maps") as f:
        maps = sorted({line.split()[-1] for line in f if ".so" in line})
    meta["library"] = {
        "type": type(lib).__name__,
        "pythonapi": bool(lib._func_flags_ & ctypes._FUNCFLAG_PYTHONAPI),
        "path": os.path.relpath(lib._name, REPO),
        "flags": native_ops.GXX_FLAGS, "maps": maps}

    # ---- a build that fails: no g++, then a g++ that exits 1 -------------
    tmp = tempfile.mkdtemp(dir=job)
    fake = os.path.join(tmp, "bin")
    os.makedirs(fake)
    script = os.path.join(fake, "g++-failing")
    with open(script, "w") as f:
        f.write("#!/bin/sh\necho 'mimm_host.cpp:1: error: planted' >&2\n"
                "exit 1\n")
    os.chmod(script, os.stat(script).st_mode | stat.S_IEXEC)
    os.environ["PATH"] = fake + os.pathsep + os.environ["PATH"]
    real = native_ops.GXX, _build.BUILD_DIR, native_ops._lib
    u8 = _image((300, 280), "u8")
    u16 = _image((600, 704), "u16")
    win, origin = _window(support_window, u16, 256)
    reads = {
        "u8_train_norm": lambda: transforms.reference_transform(
            u8, np.random.default_rng(0), 128),
        "u8_train_raw": lambda: transforms.reference_transform(
            u8, np.random.default_rng(0), 128, raw=True),
        "u8_eval_norm": lambda: transforms.reference_transform(
            u8, None, 128, train=False),
        "u8_eval_raw": lambda: transforms.reference_transform(
            u8, None, 128, train=False, raw=True),
        "u16_window_train_norm": lambda: transforms.reference_transform_window(
            win, origin, u16.shape, np.random.default_rng(0), 256),
        "u16_window_train_raw": lambda: transforms.reference_transform_window(
            win, origin, u16.shape, np.random.default_rng(0), 256, raw=True),
        "u16_window_eval_norm": lambda: transforms.reference_transform_window(
            win, origin, u16.shape, None, 256, train=False),
        "u16_window_eval_raw": lambda: transforms.reference_transform_window(
            win, origin, u16.shape, None, 256, train=False, raw=True)}
    meta["failed_build"] = {}
    for compiler, gxx, want in (("missing", "g++-not-installed",
                                 "not found on PATH"),
                                ("failing", "g++-failing", "planted")):
        build_dir = os.path.join(tmp, compiler)
        native_ops.GXX, _build.BUILD_DIR = gxx, build_dir
        native_ops._lib = None
        try:
            meta["failed_build"][compiler] = {
                "get_lib": _error_of(native_ops.get_lib),
                "want_in_message": want,
                "reads": {k: _error_of(fn) for k, fn in reads.items()},
                "built": sorted(f for f in os.listdir(build_dir)
                                if f.endswith(".so"))
                if os.path.isdir(build_dir) else []}
        finally:
            native_ops.GXX, _build.BUILD_DIR, native_ops._lib = real
    np.savez(os.path.join(job, "out.npz"), **out)
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    _child(sys.argv[1])
