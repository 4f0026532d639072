"""The pairwise critic's CUDA sources (mimm_tpu_torch/csrc/
pairwise_critic_{fwd,bwd}.cu), compiled for the CPU with g++ against a
stand-in for the CUDA runtime (tests/cuda_cpu/cuda_runtime.h: a block's
threads as std::threads meeting at __syncthreads, blocks one after
another), and called through the port's own wrappers
(``_forward_kernel`` and ``_backward_kernel``: ``bwd_img_kernel``,
``bwd_w_kernel``, ``bwd_txt_kernel``, ``bwd_reduce_kernel``) on CPU
tensors.  Their outputs are held against
``pair_scores_plain`` / ``pair_scores_bwd_plain`` on the same inputs.

The stand-in also emulates the warp-level primitives of row 6's
tensor-core kernels (mma.sync m16n8k8 tf32 from the PTX ISA's fragment
tables, cvt.rna.tf32.f32, cp.async as a synchronous copy); a probe holds
the emulated m16n8k8 against torch.matmul of TF32-rounded inputs and the
3xTF32 product against a float64 one.

This checks the kernels' indexing, ragged-edge masks (pair counts and
hidden widths that are no multiples of the 64-pair, 16-deep, 128- and
256-column tiles), shared-memory staging, the z2 bits that pass from
``bwd_img`` to ``bwd_w`` and ``bwd_txt`` (one flipped bit must move dh_txt
as it moves dh_txt computed from the same bits), and fixed-order sums (two calls, the same bits)
without a card, and row 6 over ranges of image rows (a bits budget cut
so that it takes several launches); the card's compiler, its
memory model and every time come only from chip_smoke.py.  Shapes: one
tile, ragged edges with H1 and H2 that are not multiples of the tiles, and
several tiles of every kernel with split ranges.  Values on a 2^-6 grid
make every product and the z2 sums exact, so the masks agree and S, dh and
the weight gradients match to 1e-6 of their largest value (f32 sums over
pairs in another order); random normal values match to 1e-5.

The port side runs in a jax-free child (tests/torch_port_child.py); without
g++ the test skips.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

# (B_img, B_txt, H1, H2, values on the 2^-6 grid); "flushes" runs bwd_w
# over one pair range (ONE_SPLIT) of 68 chunks, past its 32-chunk
# second-level sum twice
CASES = {"one_tile": (20, 12, 32, 16, True),
         "ragged": (11, 13, 21, 33, False),
         "tiles": (37, 29, 40, 136, True),
         "ragged_pairs": (33, 17, 40, 24, True),
         "ragged_pairs_normal": (20, 12, 40, 24, False),
         "flushes": (37, 29, 24, 16, True)}
ONE_SPLIT = ("flushes",)
OUTPUTS = ("S", "dh_img", "dh_txt", "db1", "dW2", "db2", "dw3", "db3")
# the cases whose backward runs twice: several text tiles a bwd_img block
RERUN = ("tiles", "ragged_pairs", "flushes")
# (case, image rows a bwd_img / bwd_w launch): BITS_BUDGET_BYTES cut to
# those rows' bits, so row 6 runs over ranges of image rows (the last
# ragged), bwd_w adding into the same partials
CHUNKED = {"chunked": ("tiles", 12), "chunked_normal": ("ragged_pairs_normal",
                                                        8)}
# bwd_chunk_rows at (B_img, B_txt, H2) under the default budget
BUDGET_ROWS = {(2048, 2048, 512): 2048, (4096, 4096, 512): 1024,
               (8192, 8192, 512): 512, (4099, 4096, 512): 1024,
               (5, 3, 24): 5, (3, 2 ** 30, 512): 3}
# the probe: one m16n8k8 on TF32-rounded operands against torch.matmul of
# the same rounded values (products exact, 8-term f32 sums), and 3xTF32
# against float64 (only lo·lo and f32 rounding left: ~2^-22)
PROBE_TOL = {"tf32": 1e-6, "3xtf32": 1e-6, "tf32_vs_f64": 1e-2}

PROBE_SRC = r'''
#include <cuda_runtime.h>

#include "warp_mma.cuh"

// a: 16 x 8, b: 8 x 8 float32, row-major.  one: a·b by one m16n8k8 on
// their tf32 roundings, fragments built here by the PTX ISA's table;
// three: a·b in 3xTF32 through mma_step, the critic backward's product
__global__ void probe_kernel(const float* a, const float* b, float* one,
                             float* three) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  const unsigned af[4] = {tf32_rna(a[g * 8 + t]), tf32_rna(a[(g + 8) * 8 + t]),
                          tf32_rna(a[g * 8 + t + 4]),
                          tf32_rna(a[(g + 8) * 8 + t + 4])};
  const unsigned bf[2] = {tf32_rna(b[t * 8 + g]), tf32_rna(b[(t + 4) * 8 + g])};
  float d1[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32_1688(d1, af, bf);
  float d3[1][1][4] = {};
  mma_step<1, 1, false, false>(
      d3,
      [&](int m, int k, unsigned& h, unsigned& l) {
        split_tf32(a[m * 8 + k], h, l);
      },
      [&](int k, int n, unsigned& h, unsigned& l) {
        split_tf32(b[k * 8 + n], h, l);
      },
      lane);
  for (int e = 0; e < 4; ++e) {
    one[(g + 8 * (e / 2)) * 8 + 2 * t + e % 2] = d1[e];
    three[(g + 8 * (e / 2)) * 8 + 2 * t + e % 2] = d3[0][0][e];
  }
}

extern "C" int mimm_tf32_probe(const void* a, const void* b, void* one,
                               void* three) {
  probe_kernel<<<1, 32, 0, nullptr>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(one), static_cast<float*>(three));
  return (int)cudaGetLastError();
}
'''


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from tests.torch_port_child import run_child

    job = str(tmp_path_factory.mktemp("critic_emulated"))
    _, meta = run_child(__file__, job, timeout=600)
    return meta


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_kernels_match_plain(results, case):
    if "skip" in results:
        pytest.skip(results["skip"])
    errs = results["errors"][case]
    tol = 1e-6 if CASES[case][4] else 1e-5
    assert set(errs) == set(OUTPUTS)
    for name, err in errs.items():
        assert err <= tol, (case, name, err)


def test_emulated_kernels_launch_once_per_call(results):
    if "skip" in results:
        pytest.skip(results["skip"])
    assert results["launches"] == {n: len(CASES)
                                   for n in results["kernels"]}


def test_emulated_tf32_probe(results):
    """The stand-in's m16n8k8 tf32 against torch.matmul of TF32-rounded
    (nearest, ties away) operands, and 3xTF32 against float64; one TF32
    product is far from float64, which is why row 6 takes three."""
    if "skip" in results:
        pytest.skip(results["skip"])
    for name, err in results["probe"].items():
        if name == "tf32_vs_f64":
            assert 1e-5 < err <= PROBE_TOL[name], results["probe"]
        else:
            assert err <= PROBE_TOL[name], results["probe"]


@pytest.mark.parametrize("case", list(CHUNKED))
def test_emulated_row_ranges_match_plain(results, case):
    """Past BITS_BUDGET_BYTES of z2 bits bwd_img, bwd_w and bwd_txt run
    once per range of image rows, bwd_w and bwd_txt adding into what the
    earlier ranges gave: the same gradients (dh_txt from only the last
    range fails), one launch of each a range, the same bits twice."""
    if "skip" in results:
        pytest.skip(results["skip"])
    got = results["chunked"][case]
    n_img, _, _, _, exact = CASES[CHUNKED[case][0]]
    ranges = -(-n_img // CHUNKED[case][1])
    assert ranges > 2
    for name, err in got["errors"].items():
        assert err <= (1e-6 if exact else 1e-5), (case, name, err)
    assert got["launches"] == {
        name: ranges if kind in ("bwd_img", "bwd_w", "bwd_txt") else 1
        for name, kind in results["kernel_kinds"].items()}
    assert got["rerun_equal"] is True


def test_emulated_bwd_txt_reads_each_pairs_bits(results):
    """bwd_txt on bwd_img's bits with one bit flipped (one pair, one H2
    column) matches dh_txt computed in float64 with that same mask, and the
    flip moves dh_txt far past the tolerance: the kernel reads each pair's
    and column's bit where bwd_img writes it."""
    if "skip" in results:
        pytest.skip(results["skip"])
    got = results["bits_probe"]
    assert got["flipped"] <= 1e-6, got
    assert got["flip_moves"] > 1e-3, got


def test_emulated_bwd_txt_adds_into_dh(results):
    """Given a dh_txt, bwd_txt adds its sums to it (the later ranges of
    image rows) instead of overwriting it."""
    if "skip" in results:
        pytest.skip(results["skip"])
    got = results["bits_probe"]
    assert got["added"] <= 1e-6, got
    assert got["given"] > 1e-1, got


def test_bits_budget_rows(results):
    """The default budget keeps 2048 x 2048 pairs at H2 = 512 in one
    launch and bounds the bits of larger batches to it."""
    if "skip" in results:
        pytest.skip(results["skip"])
    for key, rows in results["budget_rows"]:
        assert rows == BUDGET_ROWS[tuple(key)], (key, rows)


@pytest.mark.parametrize("case", RERUN)
def test_emulated_backward_gives_the_same_bits_twice(results, case):
    """Every sum of the backward runs in a fixed order (no float atomics),
    so a second call on the same inputs gives the same bits: what the remat
    and GradCache bit-equalities rest on."""
    if "skip" in results:
        pytest.skip(results["skip"])
    assert results["rerun_equal"][case] is True


def _child(job):
    import ctypes

    import torch

    from mimm_tpu_torch.ops import _build
    from mimm_tpu_torch.ops import pairwise_critic as pc
    from tests.torch_port_child import build_emulated

    meta = {}
    if shutil.which("g++") is None:
        meta["skip"] = "needs g++ to build the CUDA sources for the CPU"
    else:
        libs = {}
        for name in (pc.FWD_SOURCE, pc.BWD_SOURCE):
            out = os.path.join(job, f"lib{name}.so")
            build_emulated(os.path.join(_build.CSRC, f"{name}.cu"), out)
            libs[name] = ctypes.CDLL(out)
        _build.load = libs.__getitem__      # this child only
        pc._launch = lambda fn, like, *args: fn(*args, None)
        pc.reset_launch_counts()
        meta["errors"] = {}
        splits = pc.bwd_splits
        for case, (n_img, n_txt, h1, h2, exact) in CASES.items():
            pc.bwd_splits = (lambda ni, nj: 1) if case in ONE_SPLIT \
                else splits
            gen = torch.Generator().manual_seed(n_img)
            args = _draw(gen, exact, n_img, n_txt, h1, h2)
            got = [pc._forward_kernel(*args[:7]),
                   *pc._backward_kernel(*args[:6], args[7])]
            if case in RERUN:
                counted = dict(pc.LAUNCHES)
                again = pc._backward_kernel(*args[:6], args[7])
                meta.setdefault("rerun_equal", {})[case] = all(
                    torch.equal(a, b) for a, b in zip(got[1:], again))
                pc.LAUNCHES.clear()
                pc.LAUNCHES.update(counted)
            want = [pc.pair_scores_plain(*args[:7]),
                    *pc.pair_scores_bwd_plain(*args)]
            meta["errors"][case] = _errors(got, want)
        meta["launches"] = dict(pc.LAUNCHES)
        meta["kernels"] = list(pc.KERNELS.values())
        meta["bits_probe"] = _bits_probe(pc)
        meta["kernel_kinds"] = {k: n for n, k in pc.KERNELS.items()}
        meta["chunked"] = {}
        budget = pc.BITS_BUDGET_BYTES
        for case, (base, rows) in CHUNKED.items():
            n_img, n_txt, h1, h2, exact = CASES[base]
            gen = torch.Generator().manual_seed(n_img + 1)
            args = _draw(gen, exact, n_img, n_txt, h1, h2)
            pc.BITS_BUDGET_BYTES = rows * n_txt * -(-h2 // 32) * 4
            pc.reset_launch_counts()
            got = [pc._forward_kernel(*args[:7]),
                   *pc._backward_kernel(*args[:6], args[7])]
            launches = dict(pc.LAUNCHES)
            again = pc._backward_kernel(*args[:6], args[7])
            pc.BITS_BUDGET_BYTES = budget
            want = [pc.pair_scores_plain(*args[:7]),
                    *pc.pair_scores_bwd_plain(*args)]
            meta["chunked"][case] = {
                "errors": _errors(got, want), "launches": launches,
                "rerun_equal": all(torch.equal(a, b)
                                   for a, b in zip(got[1:], again))}
        meta["budget_rows"] = [(key, pc.bwd_chunk_rows(*key))
                               for key in BUDGET_ROWS]
        meta["probe"] = _probe(job, build_emulated)
    np.savez(os.path.join(job, "out.npz"))
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


def _draw(gen, exact, n_img, n_txt, h1, h2):
    """(h_img, h_txt, b1, W2, b2, w3, b3, g): on the 2^-6 grid if
    ``exact``, else normal."""
    import torch

    def draw(*shape, bound=1.0):
        if exact:
            n = int(64 * bound)
            return torch.randint(-n, n + 1, shape, generator=gen).float() / 64
        return bound * torch.randn(*shape, generator=gen)

    return (draw(n_img, h1, bound=2.0), draw(n_txt, h1, bound=2.0),
            draw(h1, bound=0.5), draw(h1, h2, bound=0.25),
            draw(h2, bound=0.5), draw(h2, 1, bound=0.5), draw(1),
            draw(n_img, n_txt))


def _dh_txt_from_bits(args, bits):
    """dh_txt in float64 with the z2 > 0 mask read from ``bits`` and the
    t > 0 mask from the float32 z1 = (h_img + h_txt) + b1 the kernels form."""
    import torch

    h_img, h_txt, b1, w2, _, w3, _, g = args
    n_img, n_txt, h2 = h_img.shape[0], h_txt.shape[0], w2.shape[1]
    shifts = torch.arange(32, dtype=torch.int32)
    mask = ((bits[..., None] >> shifts) & 1).reshape(n_img, n_txt, -1)
    t_pos = (h_img[:, None, :] + h_txt[None, :, :]) + b1 > 0
    dz2 = (g.double()[..., None] * w3.double().reshape(-1)) \
        * mask[..., :h2].double()
    return ((dz2 @ w2.double().T) * t_pos).sum(0)


def _bits_probe(pc) -> dict:
    """bwd_txt on the "tiles" case: with one bit of bwd_img's bits flipped
    (a pair and column where g and w3 are not 0), against
    ``_dh_txt_from_bits`` on the flipped bits ("flipped") and how far the
    flip moves it ("flip_moves"); and added into a given dh_txt ("added";
    "given": the given values against the sums alone), max |Δ| over max
    |reference|."""
    import torch

    n_img, n_txt, h1, h2, exact = CASES["tiles"]
    gen = torch.Generator().manual_seed(n_img + 2)
    args = _draw(gen, exact, n_img, n_txt, h1, h2)
    bargs = (*args[:6], args[7])
    bits = pc.bwd_img_kernel(bargs, torch.empty(n_img, h1), torch.empty(
        -(-n_img // pc._IMG_ROWS), 2 * h2 + 1))
    i = n_img // 2
    j = next(j for j in range(n_txt // 2, n_txt) if args[7][i, j] != 0)
    n = next(n for n in range(33, h2) if args[5][n, 0] != 0 and n % 32 != 31)
    flipped = bits.clone()
    flipped[i * n_txt + j, n // 32] ^= 1 << (n % 32)

    def scaled(got, want):
        return ((got.double() - want).abs().max()
                / want.abs().max()).item()

    want = _dh_txt_from_bits(args, flipped)
    plain = _dh_txt_from_bits(args, bits)
    given = torch.randn(n_txt, h1, generator=gen)
    return {"flipped": scaled(pc.bwd_txt_kernel(bargs, flipped), want),
            "flip_moves": scaled(plain, want),
            "added": scaled(pc.bwd_txt_kernel(bargs, bits, given.clone()),
                            given.double() + plain),
            "given": scaled(plain, given.double() + plain)}


def _errors(got, want) -> dict:
    """{output: max |got − want| over max |want|}."""
    return {n: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
            if a.shape == b.shape else float("inf")
            for n, a, b in zip(OUTPUTS, got, want)}


def _tf32(x):
    """float32 -> tf32 as cvt.rna.tf32.f32: nearest, ties away from 0."""
    import torch

    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = ((u + 0x1000) & 0xFFFFE000).to(torch.int64)
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)
    return u.view(torch.float32)


def _probe(job, build_emulated) -> dict:
    """The probe kernel's products, max |Δ| over max |reference|."""
    import ctypes

    import torch

    from mimm_tpu_torch.ops import _build

    work = os.path.join(job, "probe")
    os.makedirs(work)
    for name in os.listdir(_build.CSRC):
        if name.endswith(".cuh"):
            shutil.copy(os.path.join(_build.CSRC, name), work)
    src = os.path.join(work, "probe.cu")
    with open(src, "w") as f:
        f.write(PROBE_SRC)
    build_emulated(src, os.path.join(work, "libprobe.so"))
    fn = ctypes.CDLL(os.path.join(work, "libprobe.so")).mimm_tf32_probe
    fn.argtypes = [ctypes.c_void_p] * 4
    gen = torch.Generator().manual_seed(7)
    a = torch.randn(16, 8, generator=gen)
    b = torch.randn(8, 8, generator=gen)
    one, three = torch.zeros(16, 8), torch.zeros(16, 8)
    assert fn(a.data_ptr(), b.data_ptr(), one.data_ptr(),
              three.data_ptr()) == 0

    def scaled(got, want):
        return ((got.double() - want).abs().max()
                / want.abs().max()).item()

    exact = a.double() @ b.double()
    return {"tf32": scaled(one, (_tf32(a) @ _tf32(b)).double()),
            "3xtf32": scaled(three, exact),
            "tf32_vs_f64": scaled(one, exact)}


if __name__ == "__main__":
    _child(sys.argv[1])
