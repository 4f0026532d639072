"""The fused FFN's CUDA sources (mimm_tpu_torch/csrc/fused_ffn_{fwd,bwd}.cu
with fused_ffn.cuh), compiled for the CPU with g++ against a stand-in for
the CUDA runtime (tests/cuda_cpu: a block's threads as std::threads
meeting at __syncthreads, blocks one after another, bfloat16 as its 16
bits with round-to-nearest-even), and called through the port's own
kernel wrappers (``fwd_kernel``, ``bwd_a_kernel``, ``bwd_b1_kernel``,
``bwd_b2_kernel``) on CPU tensors.  Their outputs are held against the
plain versions (``fwd_plain``, ``bwd_a_plain``, ``bwd_b1_plain``,
``bwd_b2_plain``) on the same inputs.

This checks the kernels' indexing, the tail-row masks, the staging of both
weight layouts, the chaining of the two products through shared memory and
the fixed-order column sums without a card; the card's compiler, its
memory model and every time come only from chip_smoke.py.  Shapes (T, d,
f): one row tile, a sub-tile T, ragged T over several tiles with d = 256
(two column groups a thread), each in float32; in bfloat16, where the
forward is its own tensor-core kernel (the stand-in emulates mma.sync
m16n8k16, ldmatrix and cp.async), the ragged one, a sub-tile T with f =
384 (its last 256-column chunk half past f), the small shape of
chip_smoke.py's FFN_SHAPES (T = 100: no multiple of the 32-row tile) and
d = 1024 (its 16-deep w2 stages) with f = 128.  Weights are given as transposed views of (out, in) tensors (passed by
pointer) except in the ``row_major`` case (copied by the wrapper).

Tolerances, max |got − want| over max |want|: float32 1e-5 (the two sum
in another order, and the FMAs contract differently); bfloat16 outputs 2e-2
(a sum that lands near a rounding boundary may round the other way: one
bf16 ulp of the largest value is 2^-8 = 3.9e-3 relative, and a flipped g
or dh element moves the second product by about as much again), the
float32 weight gradients of bfloat16 inputs 1e-2 (flipped roundings of g
and dh).

The port side runs in a jax-free child (tests/torch_port_child.py); without
g++ the test skips.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

# (T, d, f, dtype, weights given row-major)
CASES = {"one_tile": (32, 128, 128, "float32", False),
         "sub_tile": (5, 128, 256, "float32", False),
         "ragged": (70, 256, 384, "float32", False),
         "row_major": (33, 128, 256, "float32", True),
         "ragged_bf16": (70, 256, 256, "bfloat16", False),
         "sub_tile_bf16": (5, 128, 384, "bfloat16", False),
         "small_bf16": (100, 256, 512, "bfloat16", False),
         "wide_bf16": (33, 1024, 128, "bfloat16", False)}
OUTPUTS = ("y", "h", "dx", "dh", "dw1", "db1", "dw2")
TOL = {"float32": dict.fromkeys(OUTPUTS, 1e-5),
       "bfloat16": {**dict.fromkeys(("y", "h", "dx", "dh"), 2e-2),
                    **dict.fromkeys(("dw1", "db1", "dw2"), 1e-2)}}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from tests.torch_port_child import run_child

    job = str(tmp_path_factory.mktemp("fused_ffn_emulated"))
    _, meta = run_child(__file__, job, timeout=900)
    return meta


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_kernels_match_plain(results, case):
    if "skip" in results:
        pytest.skip(results["skip"])
    errs = results["errors"][case]
    assert set(errs) == set(OUTPUTS)
    for name, err in errs.items():
        assert err <= TOL[CASES[case][3]][name], (case, name, err)


def test_emulated_kernels_launch_once_per_call(results):
    if "skip" in results:
        pytest.skip(results["skip"])
    assert results["launches"] == {n: len(CASES) for n in results["kernels"]}


def test_emulated_kernels_refuse_other_shapes(results):
    """The C entry points return cudaErrorInvalidValue (the wrapper raises)
    for a d past 1024; the wrappers raise a ValueError naming the shape for
    widths that are no multiples of 128."""
    if "skip" in results:
        pytest.skip(results["skip"])
    assert "1152" in results["refused"]["wide"]
    assert "(4, 96, 128)" in results["refused"]["lanes"]


def _child(job):
    import ctypes

    import torch

    from mimm_tpu_torch.ops import _build
    from mimm_tpu_torch.ops import fused_ffn as ff
    from tests.torch_port_child import build_emulated

    meta = {}
    if shutil.which("g++") is None:
        meta["skip"] = "needs g++ to build the CUDA sources for the CPU"
    else:
        libs = {}
        for name in (ff.FWD_SOURCE, ff.BWD_SOURCE):
            out = os.path.join(job, f"lib{name}.so")
            build_emulated(os.path.join(_build.CSRC, f"{name}.cu"), out)
            libs[name] = ctypes.CDLL(out)
        _build.load = libs.__getitem__      # this child only
        ff._launch = lambda fn, like, *args: fn(*args, None)
        ff.reset_launch_counts()
        meta["errors"] = {}
        for case, (t, d, f, dtype, row_major) in CASES.items():
            gen = torch.Generator().manual_seed(t)
            dt = getattr(torch, dtype)

            def draw(*shape, scale=1.0):
                return (scale * torch.randn(*shape, generator=gen)).to(dt)

            w1, w2 = draw(f, d, scale=0.05).t(), draw(d, f, scale=0.05).t()
            if row_major:
                w1, w2 = w1.contiguous(), w2.contiguous()
            x, b1, b2 = draw(t, d), draw(f, scale=0.05), draw(d, scale=0.05)
            dy = draw(t, d)
            y, h = ff.fwd_kernel(x, w1, b1, w2, b2)
            # the backward kernels on the plain h, so that a flipped
            # rounding of h does not count against them
            want_y, want_h = ff.fwd_plain(x, w1, b1, w2, b2)
            dx, dh = ff.bwd_a_kernel(dy, want_h, w1, w2)
            want_dx, want_dh = ff.bwd_a_plain(dy, want_h, w1, w2)
            got = [y, h, dx, dh, *ff.bwd_b1_kernel(x, want_dh),
                   ff.bwd_b2_kernel(dy, want_h)]
            want = [want_y, want_h, want_dx, want_dh,
                    *ff.bwd_b1_plain(x, want_dh), ff.bwd_b2_plain(dy, want_h)]
            meta["errors"][case] = {
                n: ((a.float() - b.float()).abs().max()
                    / b.float().abs().max().clamp_min(1e-30)).item()
                if a.shape == b.shape and a.dtype == b.dtype else float("inf")
                for n, a, b in zip(OUTPUTS, got, want)}
        meta["launches"] = dict(ff.LAUNCHES)
        meta["kernels"] = list(ff.KERNELS.values())
        meta["refused"] = {}
        for key, (t, d, f) in (("wide", (4, 1152, 128)),
                               ("lanes", (4, 96, 128))):
            try:
                ff.fwd(torch.zeros(t, d), torch.zeros(d, f), torch.zeros(f),
                       torch.zeros(f, d), torch.zeros(d))
                if key == "wide":       # the plain version takes it
                    ff.fwd_kernel(torch.zeros(t, d), torch.zeros(d, f),
                                  torch.zeros(f), torch.zeros(f, d),
                                  torch.zeros(d))
                meta["refused"][key] = "no error"
            except ValueError as e:
                meta["refused"][key] = str(e)
    np.savez(os.path.join(job, "out.npz"))
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    _child(sys.argv[1])
