"""The port's flash_attention (mimm_tpu_torch/ops/flash_attention.py) against
the JAX package's Pallas kernel (interpret mode on the CPU).

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is held against that plain version on the card by
``chip_smoke.py`` and by the ``cuda``-marked test below.  The port side
runs in a jax-free child (tests/torch_port_child.py).
"""

import json
import os
import sys

import numpy as np
import pytest

B, H, L, D = 2, 3, 64, 16
PAD = (9, 24)  # padded keys per row: a different count in each


def _inputs():
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, H, L, D)).astype(np.float32)
               for _ in range(3))
    bias = np.zeros((B, L), np.float32)
    for b, n in enumerate(PAD):
        bias[b, L - n:] = -10000.0
    return q, k, v, bias


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax.numpy as jnp

    from mimm_tpu.ops.flash_attention import flash_attention
    from tests.torch_port_child import run_child

    job = str(tmp_path_factory.mktemp("flash"))
    q, k, v, bias = _inputs()
    np.savez(os.path.join(job, "in.npz"), q=q, k=k, v=v, bias=bias)
    seed = jnp.zeros((1, 1), jnp.int32)
    want = {}
    for ws in (False, True):
        for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            out = flash_attention(*(jnp.asarray(x, dt) for x in (q, k, v)),
                                  jnp.asarray(bias), seed, 0.0, ws)
            want[f"{name}_ws{int(ws)}"] = np.asarray(out.astype(jnp.float32))
    got, meta = run_child(__file__, job)
    return want, got, meta


@pytest.mark.parametrize("whole_sample", [0, 1])
def test_forward_f32_matches_jax(results, whole_sample):
    want, got, _ = results
    key = f"f32_ws{whole_sample}"
    np.testing.assert_allclose(got[key], want[key], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("whole_sample", [0, 1])
def test_forward_bf16_matches_jax(results, whole_sample):
    want, got, _ = results
    key = f"bf16_ws{whole_sample}"
    assert got[key + "_dtype"] == "torch.bfloat16"
    np.testing.assert_allclose(got[key], want[key], rtol=2e-2, atol=2e-2)


def test_cpu_path_launches_no_kernel(results):
    _, _, meta = results
    assert meta["launches"] == {}


def test_cuda_request_without_card_raises(results):
    _, _, meta = results
    if meta["cuda_available"]:
        pytest.skip("a card is present: the request does not raise")
    assert meta["cuda_request"].startswith("RuntimeError")


def test_unsupported_calls_raise(results):
    _, _, meta = results
    assert meta["rate"].startswith("ValueError")
    assert meta["dtype"].startswith("TypeError")
    assert meta["bias_shape"].startswith("ValueError")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(tmp_path):
    """The CUDA kernel against its plain version on the card, at D=64 (run
    there with ``python -m pytest --noconftest -m cuda
    tests/test_torch_flash_attention.py``).  The child decides whether a
    card is present; without one the test skips."""
    from tests.torch_port_child import run_child

    _, meta = run_child(__file__, str(tmp_path), "cuda")
    if "skip" in meta:
        pytest.skip(meta["skip"])
    assert meta["max_abs_err"]["float32"] <= 1e-4
    assert meta["max_abs_err"]["bfloat16"] <= 2e-2
    assert meta["launches"] == {"flash_attention_fwd_f32": 1,
                                "flash_attention_fwd_bf16": 1}


def _child_cuda(job):
    import torch

    from mimm_tpu_torch.ops import flash_attention as fa

    meta = {}
    if not torch.cuda.is_available():
        meta["skip"] = "needs a CUDA card: the kernel has no CPU mode"
    else:
        q, k, v, bias = (torch.from_numpy(x).cuda() for x in _inputs())
        q, k, v = (torch.cat([t] * 4, dim=-1).contiguous() for t in (q, k, v))
        fa.reset_launch_counts()
        meta["max_abs_err"] = {}
        for dt in (torch.float32, torch.bfloat16):
            args = [t.to(dt) for t in (q, k, v)] + [bias]
            got = fa.flash_attention(*args)
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(*args)
            meta["max_abs_err"][str(dt).split(".")[1]] = \
                (got.float() - want.float()).abs().max().item()
        meta["launches"] = dict(fa.LAUNCHES)
    np.savez(os.path.join(job, "out.npz"))
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


def _child(job):
    import torch

    from mimm_tpu_torch import resolve_device
    from mimm_tpu_torch.ops import flash_attention as fa

    with np.load(os.path.join(job, "in.npz")) as z:
        q, k, v, bias = (torch.from_numpy(z[n]) for n in ("q", "k", "v", "bias"))
    fa.reset_launch_counts()
    out = {}
    for ws in (False, True):
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            res = fa.flash_attention(q.to(dt), k.to(dt), v.to(dt), bias,
                                     None, 0.0, ws)
            out[f"{name}_ws{int(ws)}"] = res.float().numpy()
            out[f"{name}_ws{int(ws)}_dtype"] = np.asarray(str(res.dtype))

    def error_of(fn):
        try:
            fn()
        except Exception as e:  # the test reads the exception's type
            return f"{type(e).__name__}: {e}"
        return "no error"

    meta = {
        "launches": dict(fa.LAUNCHES),
        "cuda_available": torch.cuda.is_available(),
        "cuda_request": error_of(lambda: resolve_device("cuda")),
        "rate": error_of(lambda: fa.flash_attention(q, k, v, bias, None, 1.0)),
        "dtype": error_of(lambda: fa.flash_attention(
            q.half(), k.half(), v.half(), bias)),
        "bias_shape": error_of(lambda: fa.flash_attention(q, k, v, bias[:1])),
    }
    np.savez(os.path.join(job, "out.npz"), **out)
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    if sys.argv[2:] == ["cuda"]:
        _child_cuda(sys.argv[1])
    else:
        _child(sys.argv[1])
