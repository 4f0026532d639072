"""The port's ``shallow_conv3x3`` takes its image's layout from the caller:
an NHWC image (B, H, W, 1), as JAX's (mimm_tpu/ops/shallow_conv.py:178)
takes it, also where H = 1 or W = 1, so that the shape alone cannot tell
NHWC from NCHW.

JAX's ``shallow_conv3x3`` (Pallas in interpret mode on the CPU, as
tests/test_shallow_conv.py runs it) against the port's on CPU tensors (its
plain versions), at an image of H = 1, (2, 1, 23, 1), and one of W = 1,
(2, 17, 1, 1), from a float32 image with float32 output and from a
bfloat16 image with bfloat16 output (the way the bf16 model calls it).
The output shapes must be equal, (B, C, H, W), and the values within
tests/test_torch_shallow_conv.py's forward limits: 1e-6 of max |JAX| in
float32, one bf16 ulp (2^-8) of it in bfloat16.  The weight's gradient
through autograd against ``jax.grad`` to that file's autograd bounds (rtol
= atol = 1e-4).

The JAX side runs in the pytest worker, the port side in a jax-free child
(tests/torch_port_child.py).
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

C = 8
SHAPES = {"h1": (2, 1, 23), "w1": (2, 17, 1)}
DTYPES = ("float32", "bfloat16")
TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -8}


def _inputs():
    rng = np.random.default_rng(12)
    arrays = {"kernel": (rng.standard_normal((3, 3, 1, C)) * 0.3)
              .astype(np.float32)}
    for name, (b, h, w) in SHAPES.items():
        arrays[f"x_{name}"] = rng.random((b, h, w, 1)).astype(np.float32)
        arrays[f"r_{name}"] = rng.standard_normal((b, C, h, w)) \
            .astype(np.float32)
    return arrays


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from mimm_tpu.ops import shallow_conv as jsc
    from tests.torch_port_child import run_child

    job = str(tmp_path_factory.mktemp("shallow_conv_layout"))
    arrays = _inputs()
    kern = jnp.asarray(arrays["kernel"])
    want = {}
    for name in SHAPES:
        x = jnp.asarray(arrays[f"x_{name}"])
        for dt in DTYPES:
            jdt = getattr(jnp, dt)
            want[f"y_{name}_{dt}"] = np.asarray(jsc.shallow_conv3x3(
                x.astype(jdt), kern, out_dtype=jdt).astype(jnp.float32))
        r = jnp.asarray(arrays[f"r_{name}"])
        want[f"gk_{name}"] = np.asarray(jax.grad(lambda k: jnp.sum(
            jsc.shallow_conv3x3(x, k, out_dtype=jnp.float32) * r))(kern))
    np.savez(os.path.join(job, "in.npz"), **arrays)
    got, _ = run_child(__file__, job)
    shutil.rmtree(job)
    return want, got


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(SHAPES))
def test_nhwc_thin_image_matches_jax(results, case, dtype):
    want, got = results
    b, h, w = SHAPES[case]
    a, ref = got[f"y_{case}_{dtype}"], want[f"y_{case}_{dtype}"]
    assert ref.shape == (b, C, h, w)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    err = np.abs(a - ref).max() / np.abs(ref).max()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("case", list(SHAPES))
def test_nhwc_thin_image_weight_grad_matches_jax(results, case):
    want, got = results
    # the port's (C, 1, 3, 3) against flax's (3, 3, 1, C)
    np.testing.assert_allclose(got[f"gk_{case}"].transpose(2, 3, 1, 0),
                               want[f"gk_{case}"], rtol=1e-4, atol=1e-4)


def _child(job):
    import torch

    from mimm_tpu_torch.ops import shallow_conv as sc

    with np.load(os.path.join(job, "in.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    weight = torch.from_numpy(arrays["kernel"]).permute(3, 2, 0, 1) \
        .contiguous()
    out = {}
    for name in SHAPES:
        x = torch.from_numpy(arrays[f"x_{name}"])
        for dt in DTYPES:
            tdt = getattr(torch, dt)
            out[f"y_{name}_{dt}"] = sc.shallow_conv3x3(
                x.to(tdt), weight, tdt).float().numpy()
        kv = weight.clone().requires_grad_()
        y = sc.shallow_conv3x3(x, kv, torch.float32)
        (gk,) = torch.autograd.grad(
            (y * torch.from_numpy(arrays[f"r_{name}"])).sum(), (kv,))
        out[f"gk_{name}"] = gk.numpy()
    np.savez(os.path.join(job, "out.npz"), **out)
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump({}, f)


if __name__ == "__main__":
    _child(sys.argv[1])
