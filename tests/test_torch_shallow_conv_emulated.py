"""The shallow-conv CUDA source (mimm_tpu_torch/csrc/shallow_conv.cu),
compiled for the CPU with g++ against a stand-in for the CUDA runtime
(tests/cuda_cpu: a block's threads as cooperative fibers meeting at
__syncthreads, blocks one after another, bfloat16 as its 16 bits with
round-to-nearest-even, ``__fmul_rn`` / ``__fadd_rn`` never contracted), and
called through the port's own kernel wrappers (``fwd_kernel``,
``dw_kernel``, ``dx_kernel``) on CPU tensors.  Their outputs are held
against the plain versions on the same inputs.

This checks, without a card, the kernels' rolling row windows: the forward
and dW walk down equal shares of the row strips of all images (runs that
cross strips and images), dx up its 16-row strips; their vector loads and
stores (16 bytes of y or dy a lane: 8 pixels in bfloat16, 4 in float32;
dx 4) and the shuffled halo columns, at widths around those vectors and
their 32-lane strips (W = 1, 7, 9: no multiple of the 8-pixel vector; 4,
6 around the 4-pixel one; 8; 131, 257: a ragged last strip, no vector
path) and heights 1 and 3; dW's fixed grid of blocks (a shape whose row
strips fill it and split unevenly over its warps), its shuffle tree and
its fixed-order sums (two calls give the same bits); all four dtype pairs
of each entry point.
The card's compiler and every time come only from chip_smoke.py.  The
forward and dx round each product and each running sum as the plain
versions do, in their order, so they must agree to the bit in float32 and
in bfloat16; dW sums in another order: max |Δ| over max |plain| ≤ 1e-5.

The port side runs in a jax-free child (tests/torch_port_child.py); without
g++ the test skips.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

# (B, H, W, x / dx dtype, y / dy dtype)
CASES = {"tile": (2, 16, 64, "float32", "float32"),
         "ragged": (2, 17, 23, "float32", "float32"),
         "ragged_wide": (1, 40, 130, "float32", "float32"),
         "ragged_bf16": (2, 17, 23, "bfloat16", "bfloat16"),
         "mixed": (1, 33, 70, "float32", "bfloat16"),
         "mixed_bf16_f32": (1, 33, 70, "bfloat16", "float32"),
         # 6600 (float32) / 4400 (bfloat16) row strips: dW's whole fixed
         # grid of 264 blocks, 6.25 / 4.17 strips a warp
         "grid_remainder": (2, 1100, 260, "float32", "float32"),
         "grid_remainder_bf16": (2, 1100, 260, "bfloat16", "bfloat16")}
DTYPE_PAIRS = [(a, b) for a in ("float32", "bfloat16")
               for b in ("float32", "bfloat16")]
# the forward's and dW's vector widths: W around 8 pixels (1, 7, 8, 9) and
# 4 (4, 6), ragged 256- and 128-column strips (131, 257); H below any walk
CASES.update({f"w{w}_h{h}_{a}_{b}": (2, h, w, a, b)
              for w in (1, 4, 6, 7, 8, 9, 131, 257) for h in (1, 3)
              for a, b in DTYPE_PAIRS})
DW_TOL = 1e-5
# dx alone at widths around its 4-pixel vectors and 128-column strips (W =
# 1, 7: no full vector; 131, 257: a ragged last strip, no vector loads) and
# heights below its 16-row walk, in both dtypes: (B, H, W)
DX_SHAPES = [(2, h, w) for h in (1, 3) for w in (1, 7, 131, 257)]
DX_DTYPES = ("float32", "bfloat16")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from tests.torch_port_child import run_child

    job = str(tmp_path_factory.mktemp("shallow_conv_emulated"))
    _, meta = run_child(__file__, job, timeout=900)
    return meta


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_kernels_match_plain(results, case):
    if "skip" in results:
        pytest.skip(results["skip"])
    got = results["cases"][case]
    assert got["fwd_equal"] is True and got["dx_equal"] is True, got
    assert got["dw_err"] <= DW_TOL, got
    assert got["dw_same_bits"] is True, got


@pytest.mark.parametrize("dtype", DX_DTYPES)
@pytest.mark.parametrize("shape", DX_SHAPES, ids=str)
def test_emulated_dx_bit_equal_at_ragged_widths(results, shape, dtype):
    if "skip" in results:
        pytest.skip(results["skip"])
    assert results["dx_sweep"][f"{shape} {dtype}"] is True


def test_emulated_kernels_launch_once_per_call(results):
    if "skip" in results:
        pytest.skip(results["skip"])
    assert results["launches"] == {    # dW twice a case: the same bits
        "shallow_conv_fwd": len(CASES), "shallow_conv_dw": 2 * len(CASES),
        "shallow_conv_dx": len(CASES)}
    assert results["dx_sweep_launches"] == {
        "shallow_conv_dx": len(DX_SHAPES) * len(DX_DTYPES)}


def test_emulated_entry_points_refuse_other_widths(results):
    """The C entry points return cudaErrorInvalidValue for C ≠ 8, and the
    wrapper raises with the shape; nothing is counted."""
    if "skip" in results:
        pytest.skip(results["skip"])
    for kind, msg in results["refused"].items():
        assert msg.startswith("RuntimeError") and "cudaError_t 1" in msg \
            and "(2, 8, 8, 4)" in msg, (kind, msg)


def _child(job):
    import ctypes

    import torch

    from mimm_tpu_torch.ops import _build
    from mimm_tpu_torch.ops import shallow_conv as sc
    from tests.test_torch_train import _error_of
    from tests.torch_port_child import build_emulated

    meta = {}
    if shutil.which("g++") is None:
        meta["skip"] = "needs g++ to build the CUDA sources for the CPU"
    else:
        out = os.path.join(job, f"lib{sc.SOURCE}.so")
        build_emulated(os.path.join(_build.CSRC, f"{sc.SOURCE}.cu"), out)
        lib = ctypes.CDLL(out)
        _build.load = lambda name: lib      # this child only
        sc._launch = lambda fn, like, *args: fn(*args, None)
        sc.reset_launch_counts()
        meta["cases"] = {}
        for case, (b, h, w, xt, gt) in CASES.items():
            gen = torch.Generator().manual_seed(h * w)
            xdt, gdt = getattr(torch, xt), getattr(torch, gt)
            x = torch.rand(b, h, w, 1, generator=gen).to(xdt)
            weight = torch.randn(8, 1, 3, 3, generator=gen) * 0.5
            dy = torch.randn(b, 8, h, w, generator=gen).to(gdt)
            dw, want_dw = sc.dw_kernel(x, dy), sc.dw_plain(x, dy)
            meta["cases"][case] = {
                "fwd_equal": torch.equal(sc.fwd_kernel(x, weight, gdt),
                                         sc.fwd_plain(x, weight, gdt)),
                "dx_equal": torch.equal(sc.dx_kernel(dy, weight, xdt),
                                        sc.dx_plain(dy, weight, xdt)),
                "dw_err": ((dw - want_dw).abs().max()
                           / want_dw.abs().max()).item()
                if dw.shape == want_dw.shape else float("inf"),
                "dw_same_bits": torch.equal(sc.dw_kernel(x, dy), dw)}
        meta["launches"] = dict(sc.LAUNCHES)
        meta["kernels"] = list(sc.KERNELS.values())
        x, w4 = torch.zeros(2, 8, 8, 1), torch.zeros(4, 1, 3, 3)
        dy = torch.zeros(2, 4, 8, 8)
        meta["refused"] = {
            "fwd": _error_of(lambda: sc.fwd_kernel(x, w4, torch.float32)),
            "dw": _error_of(lambda: sc.dw_kernel(x, dy)),
            "dx": _error_of(lambda: sc.dx_kernel(dy, w4, torch.float32))}
        assert dict(sc.LAUNCHES) == meta["launches"]
        sc.reset_launch_counts()
        meta["dx_sweep"] = {}
        for shape in DX_SHAPES:
            for dt in DX_DTYPES:
                gen = torch.Generator().manual_seed(shape[1] * shape[2])
                weight = torch.randn(8, 1, 3, 3, generator=gen) * 0.5
                dy = torch.randn(shape[0], 8, *shape[1:], generator=gen)
                dy = dy.to(getattr(torch, dt))
                meta["dx_sweep"][f"{shape} {dt}"] = torch.equal(
                    sc.dx_kernel(dy, weight, dy.dtype),
                    sc.dx_plain(dy, weight, dy.dtype))
        meta["dx_sweep_launches"] = dict(sc.LAUNCHES)
    np.savez(os.path.join(job, "out.npz"))
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    _child(sys.argv[1])
