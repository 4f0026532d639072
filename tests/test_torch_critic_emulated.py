"""The pairwise critic's CUDA sources (mimm_tpu_torch/csrc/
pairwise_critic_{fwd,bwd}.cu), compiled for the CPU with g++ against a
stand-in for the CUDA runtime (tests/cuda_cpu/cuda_runtime.h: a block's
threads as std::threads meeting at __syncthreads, blocks one after
another), and called through the port's own wrappers
(``_forward_kernel``, ``bwd_rows_kernel``, ``bwd_w_kernel``,
``bwd_reduce_kernel``) on CPU tensors.  Their outputs are held against
``pair_scores_plain`` / ``pair_scores_bwd_plain`` on the same inputs.

This checks the kernels' indexing, ragged-edge masks, shared-memory
staging and fixed-order sums without a card; the card's compiler, its
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
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
# (B_img, B_txt, H1, H2, values on the 2^-6 grid)
CASES = {"one_tile": (20, 12, 32, 16, True),
         "ragged": (11, 13, 21, 33, False),
         "tiles": (37, 29, 40, 136, True)}
OUTPUTS = ("S", "dh_img", "dh_txt", "db1", "dW2", "db2", "dw3", "db3")


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


def _compile(source: str, out: str) -> None:
    """Rewrite the launches and dynamic shared memory for the stand-in
    runtime, then build a shared library with g++."""
    with open(source) as f:
        text = f.read()
    text = re.sub(r"extern __shared__ __align__\(16\) float (\w+)\[\];",
                  r"float* \1 = emu_dyn_smem();", text)
    text = re.sub(r"([\w:]+(?:<[^<>()]*>)?)<<<(.*?)>>>\(",
                  r"emu_launch(\1, \2, ", text, flags=re.S)
    cpp = out + ".cpp"
    with open(cpp, "w") as f:
        f.write(text)
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I",
         os.path.join(HERE, "cuda_cpu"), "-o", out, cpp],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {source}:\n{proc.stderr[-4000:]}")


def _child(job):
    import ctypes

    import torch

    from mimm_tpu_torch.ops import _build
    from mimm_tpu_torch.ops import pairwise_critic as pc

    meta = {}
    if shutil.which("g++") is None:
        meta["skip"] = "needs g++ to build the CUDA sources for the CPU"
    else:
        libs = {}
        for name in (pc.FWD_SOURCE, pc.BWD_SOURCE):
            out = os.path.join(job, f"lib{name}.so")
            _compile(os.path.join(_build.CSRC, f"{name}.cu"), out)
            libs[name] = ctypes.CDLL(out)
        _build.load = libs.__getitem__      # this child only
        pc._launch = lambda fn, like, *args: fn(*args, None)
        pc.reset_launch_counts()
        meta["errors"] = {}
        for case, (n_img, n_txt, h1, h2, exact) in CASES.items():
            gen = torch.Generator().manual_seed(n_img)

            def draw(*shape, bound=1.0):
                if exact:
                    n = int(64 * bound)
                    return torch.randint(-n, n + 1, shape,
                                         generator=gen).float() / 64
                return bound * torch.randn(*shape, generator=gen)

            args = (draw(n_img, h1, bound=2.0), draw(n_txt, h1, bound=2.0),
                    draw(h1, bound=0.5), draw(h1, h2, bound=0.25),
                    draw(h2, bound=0.5), draw(h2, 1, bound=0.5), draw(1),
                    draw(n_img, n_txt))
            got = [pc._forward_kernel(*args[:7]),
                   *pc._backward_kernel(*args[:6], args[7])]
            want = [pc.pair_scores_plain(*args[:7]),
                    *pc.pair_scores_bwd_plain(*args)]
            meta["errors"][case] = {
                n: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                .item() if a.shape == b.shape else float("inf")
                for n, a, b in zip(OUTPUTS, got, want)}
        meta["launches"] = dict(pc.LAUNCHES)
        meta["kernels"] = list(pc.KERNELS.values())
    np.savez(os.path.join(job, "out.npz"))
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    _child(sys.argv[1])
