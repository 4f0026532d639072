"""The fused FFN's CUDA sources (mimm_tpu_torch/csrc/fused_ffn_{fwd,bwd}.cu
with fused_ffn.cuh and fused_ffn_tc.cuh), compiled for the CPU with g++
against a stand-in for the CUDA runtime (tests/cuda_cpu: a block's threads as cooperative
fibers meeting at __syncthreads, blocks one after another, bfloat16 as its 16
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
forward and backward A are the tensor-core kernel of fused_ffn_tc.cuh
(the stand-in emulates mma.sync m16n8k16, ldmatrix with and without
.trans and cp.async), the ragged one, a sub-tile T with f = 384 (its last
256-column chunk half past f), the small shape of chip_smoke.py's
FFN_SHAPES (T = 100: no multiple of the 32-row tile) and d = 1024 (the
forward's 16-deep w2 stages) with f = 128.  Weights are given as transposed views of (out, in) tensors (passed by
pointer) except in the ``row_major`` case (copied by the wrapper).

The bfloat16 weight gradients B1 and B2 are fused_ffn_bwd.cu's
wgrad_kernel on wgmma m64n256k16 (both operands MN-major by descriptors in
the 128-byte swizzle, brought by 2-D TMA boxes on mbarriers, which the
stand-in emulates with zero fill past the matrix), over ranges of T whose
partials wgrad_reduce_kernel adds: ``ranges_bf16`` splits T = 805 into 3
ranges, the last ragged; ``wide_ranges_bf16`` runs d = 1024 over 2;
``ragged_d_bf16`` has d = 384, a 256-column tile half past d.  Every case
calls B1 and B2 a second time and must get the same bits, and a probe
holds one emulated wgmma against torch.matmul.

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
         "wide_bf16": (33, 1024, 128, "bfloat16", False),
         "ranges_bf16": (805, 256, 128, "bfloat16", False),
         "wide_ranges_bf16": (520, 1024, 128, "bfloat16", False),
         "ragged_d_bf16": (300, 384, 256, "bfloat16", False)}
# the SM count the child gives the wrapper: the H100's
SMS = 132
# splits of T the bfloat16 weight-gradient kernels take (the rest one):
# 13 stages of 64 rows in ranges of 5, 5, 3 (the last ragged: 805 = 12·64
# + 37), and 9 in ranges of 5, 4
SPLITS = {"ranges_bf16": 3, "wide_ranges_bf16": 2}
OUTPUTS = ("y", "h", "dx", "dh", "dw1", "db1", "dw2")
# the weight-gradient kernels' outputs, which a second call must give again
RERUN = ("dw1", "db1", "dw2")
# the bf16 wgmma probe: one warpgroup, 4 m64n256k16 steps (K = 64) on TMA
# boxes against torch.matmul of the same bf16 values in float32 (products
# exact, 64-term f32 sums in another order)
WGMMA_TOL = 1e-5
TOL = {"float32": dict.fromkeys(OUTPUTS, 1e-5),
       "bfloat16": {**dict.fromkeys(("y", "h", "dx", "dh"), 2e-2),
                    **dict.fromkeys(("dw1", "db1", "dw2"), 1e-2)}}


WGMMA_PROBE_SRC = r'''
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "wgmma_bf16.cuh"

// a: 64 x 64 (K x M), b: 64 x 256 (K x N), bf16, row-major, by their
// tensor maps.  One warpgroup: a as one panel and b as four, 2-D TMA
// boxes of 64 rows in the 128-byte swizzle on an mbarrier, then out (64 x
// 256, f32) = aᵀ·b by four wgmma m64n256k16 steps, both operands
// MN-major, as csrc/fused_ffn_bwd.cu's wgrad_kernel takes a stage.
constexpr unsigned PANEL_BYTES = 64 * wgmma_bf16::ROW_BYTES;

__global__ void probe_kernel(const __grid_constant__ CUtensorMap ta,
                             const __grid_constant__ CUtensorMap tb,
                             float* out) {
  extern __shared__ __align__(16) float smem[];
  unsigned char* tile = reinterpret_cast<unsigned char*>(smem) +
                        ((1024 - (smem_addr(smem) & 1023)) & 1023);
  uint64_t* bar = reinterpret_cast<uint64_t*>(tile + 5 * PANEL_BYTES);
  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, 5 * PANEL_BYTES);
    tma_load_2d(tile, &ta, 0, 0, bar);
    for (int p = 0; p < 4; ++p)
      tma_load_2d(tile + PANEL_BYTES * (1 + p), &tb, 64 * p, 0, bar);
  }
  mbar_wait(bar, 0);
  float d[128];
  for (int e = 0; e < 128; ++e) d[e] = 0.f;
  wgmma_fence();
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n256k16_bf16_mn(
        d,
        wgmma_bf16::desc_mn_sw128(tile + 2048 * kk, PANEL_BYTES),
        wgmma_bf16::desc_mn_sw128(tile + PANEL_BYTES + 2048 * kk,
                                  PANEL_BYTES));
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_fence_acc(d);
  const int r = 16 * (tid / 32) + g;
  for (int j = 0; j < 32; ++j)
    for (int e = 0; e < 4; ++e)
      out[(r + 8 * (e / 2)) * 256 + 8 * j + 2 * t + e % 2] = d[4 * j + e];
}

extern "C" int mimm_wgmma_bf16_probe(const void* a, const void* b,
                                     void* out) {
  CUtensorMap ta, tb;
  int err = tmap_2d_bf16(&ta, a, 64, 64, 64);
  if (err == 0) err = tmap_2d_bf16(&tb, b, 64, 256, 64);
  if (err != 0) return err;
  probe_kernel<<<1, 128, 1024 + 5 * PANEL_BYTES + 8, nullptr>>>(
      ta, tb, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
'''


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


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_weight_gradients_give_the_same_bits_twice(results, case):
    """B1 and B2 called again on the same inputs: the same bits (fixed-order
    sums, no atomics), and the bfloat16 kernels split T as SPLITS says."""
    if "skip" in results:
        pytest.skip(results["skip"])
    assert results["rerun_equal"][case] == dict.fromkeys(RERUN, True)
    want = SPLITS.get(case, 1) if CASES[case][3] == "bfloat16" else 0
    assert results["splits"][case] == want


def test_emulated_wgmma_bf16_probe(results):
    """The stand-in's wgmma m64n256k16 bf16 (both operands MN-major by
    128-byte-swizzled descriptors, brought by 2-D TMA boxes) against
    torch.matmul of the same values; run WGMMA_PROBE_SRC with nvcc and
    ``-I mimm_tpu_torch/csrc`` to hold the card's against the same."""
    if "skip" in results:
        pytest.skip(results["skip"])
    assert results["wgmma_probe"] <= WGMMA_TOL, results["wgmma_probe"]


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
        ff._sm_count = lambda like: SMS
        ff.reset_launch_counts()
        meta["errors"], meta["rerun_equal"], meta["splits"] = {}, {}, {}
        reruns = []
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
            ws = ff._workspace(x, t, d, f, SMS)
            meta["splits"][case] = 0 if dt != torch.bfloat16 else (
                1 if ws is None else ws.numel() // (f * d + f))
            reruns.append((case, x, dy, want_h, want_dh, got[4:]))
        meta["launches"] = dict(ff.LAUNCHES)
        for case, x, dy, h, dh, first in reruns:
            again = [*ff.bwd_b1_kernel(x, dh), ff.bwd_b2_kernel(dy, h)]
            meta["rerun_equal"][case] = {
                n: torch.equal(a, b) for n, a, b in zip(RERUN, first, again)}
        meta["wgmma_probe"] = _wgmma_probe(job)
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


def _wgmma_probe(job) -> float:
    """The probe's product, max |Δ| over max |reference|."""
    import ctypes

    import torch

    from mimm_tpu_torch.ops import _build
    from tests.torch_port_child import build_emulated

    work = os.path.join(job, "wgmma_probe")
    os.makedirs(work)
    for name in os.listdir(_build.CSRC):
        if name.endswith(".cuh"):
            shutil.copy(os.path.join(_build.CSRC, name), work)
    src = os.path.join(work, "probe.cu")
    with open(src, "w") as f:
        f.write(WGMMA_PROBE_SRC)
    build_emulated(src, os.path.join(work, "libprobe.so"))
    fn = ctypes.CDLL(os.path.join(work, "libprobe.so")).mimm_wgmma_bf16_probe
    fn.argtypes = [ctypes.c_void_p] * 3
    gen = torch.Generator().manual_seed(13)
    a = torch.randn(64, 64, generator=gen).to(torch.bfloat16)
    b = torch.randn(64, 256, generator=gen).to(torch.bfloat16)
    out = torch.zeros(64, 256)
    assert fn(a.data_ptr(), b.data_ptr(), out.data_ptr()) == 0
    want = a.float().t() @ b.float()
    return ((out - want).abs().max() / want.abs().max()).item()


if __name__ == "__main__":
    _child(sys.argv[1])
