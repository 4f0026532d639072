"""The port's training randomness and attention gradient
(mimm_tpu_torch/ops/{flash_attention,philox,dropout}.py).

* ``flash_attention`` forward and dq/dk/dv at dropout rate 0 against the
  JAX Pallas kernel in interpret mode, both grids, at the shapes of
  tests/test_flash_attention.py and its tolerances (forward rtol = atol =
  2e-5, gradients rtol 5e-4 / atol 5e-5).  On the CPU the port runs its
  plain version and autograd through it.
* The dropout mask: Random123's known-answer vectors of the torch
  Philox4x32-10; the keep rate within 3 sigma of 1 - rate; one seed, one
  output; and forward mask = backward mask, by ``gradcheck`` in float64 on
  the autograd function at rate 0.1 (its backward regenerates the mask
  from the seed).
* ``u8_dropout``, ``packed_dropout`` and ``dropout``: keep rates within 3
  sigma of their thresholds, scale 1/(1 - rate), determinism.

The random bits cannot match JAX's (another generator), so dropout is held
by its statistics.  The JAX side runs in the pytest worker, the port side
in a jax-free child (tests/torch_port_child.py).
"""

import json
import os
import sys

import numpy as np
import pytest

B, H, L, D = 2, 3, 64, 16        # tests/test_flash_attention.py
KEEP_SHAPE = (4, 12, 128, 128)   # one bucket-sized mask: 786432 draws
RATES = (0.1, 0.3)
# Random123 kat_vectors, Philox4x32-10: (counter, key) -> words
PHILOX_KAT = [((0, 0, 0, 0), (0, 0),
               (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
              ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
               (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
              ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
               (0xA4093822, 0x299F31D0),
               (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]


def _inputs():
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal((B, H, L, D)).astype(np.float32)
                   for _ in range(4))
    bias = np.zeros((B, L), np.float32)
    bias[1, 40:] = -10000.0          # padded keys on row 1
    return q, k, v, bias, do


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from mimm_tpu.ops.flash_attention import flash_attention
    from tests.torch_port_child import run_child

    job = str(tmp_path_factory.mktemp("dropout"))
    q, k, v, bias, do = _inputs()
    np.savez(os.path.join(job, "in.npz"), q=q, k=k, v=v, bias=bias, do=do)
    seed = jnp.zeros((1, 1), jnp.int32)
    want = {}
    for ws in (False, True):
        out, vjp = jax.vjp(
            lambda a, b, c: flash_attention(a, b, c, jnp.asarray(bias), seed,
                                            0.0, ws),
            *(jnp.asarray(x) for x in (q, k, v)))
        want[f"out_ws{int(ws)}"] = np.asarray(out)
        for name, g in zip(("dq", "dk", "dv"), vjp(jnp.asarray(do))):
            want[f"{name}_ws{int(ws)}"] = np.asarray(g)
    got, meta = run_child(__file__, job)
    return want, got, meta


@pytest.mark.parametrize("whole_sample", [0, 1])
def test_forward_matches_jax(results, whole_sample):
    want, got, _ = results
    np.testing.assert_allclose(got["out"], want[f"out_ws{whole_sample}"],
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("whole_sample", [0, 1])
@pytest.mark.parametrize("grad", ["dq", "dk", "dv"])
def test_gradients_match_jax(results, whole_sample, grad):
    want, got, _ = results
    np.testing.assert_allclose(got[grad], want[f"{grad}_ws{whole_sample}"],
                               rtol=5e-4, atol=5e-5)


def test_philox_known_answer_vectors(results):
    assert results[2]["philox"] == [list(w) for _, _, w in PHILOX_KAT]


@pytest.mark.parametrize("rate", RATES)
def test_mask_keep_rate(results, rate):
    n = int(np.prod(KEEP_SHAPE))
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(results[2]["keep_rate"][str(rate)] - (1 - rate)) <= 3 * sigma


def test_mask_is_a_function_of_the_seed(results):
    meta = results[2]
    assert meta["same_seed_equal"] is True
    assert meta["other_seed_differs"] is True
    # rows of one (b, h) and different heads draw different bits
    assert meta["heads_differ"] is True


def test_forward_mask_equals_backward_mask(results):
    """gradcheck: the backward (autograd through the plain version, mask
    regenerated from the saved seed) is the derivative of the forward."""
    assert results[2]["gradcheck"] is True


def test_dropout_scales_kept_probabilities(results):
    """At rate r every output is the rate-0 output's P·V with P's kept
    entries times 1/(1 - r): the plain formula on the same mask."""
    assert results[2]["masked_formula_err"] <= 1e-6


@pytest.mark.parametrize("fn", ["u8_dropout", "packed_dropout", "dropout"])
def test_dropout_statistics(results, fn):
    meta = results[2]["dropout"][fn]
    n = meta["n"]
    keep_p = 1 - round(0.1 * 256) / 256 if fn != "dropout" else 0.9
    sigma = (keep_p * (1 - keep_p) / n) ** 0.5
    assert abs(meta["keep"] - keep_p) <= 3 * sigma
    assert meta["kept_values"] == [pytest.approx(1 / 0.9, rel=1e-6)]
    assert meta["deterministic"] is True
    assert meta["same_generator_seed_equal"] is True
    assert meta["rate1_zero"] is True


def test_bad_calls_raise(results):
    meta = results[2]
    assert meta["no_seed"].startswith("ValueError")
    assert meta["rate_one"].startswith("ValueError")


@pytest.mark.cuda
def test_backward_kernel_matches_plain_on_card(tmp_path):
    """The CUDA forward and backward kernels against the plain version on
    the card at D=64, rate 0 and 0.1 (run there with ``python -m pytest
    --noconftest -m cuda tests/test_torch_dropout.py``).  The child decides
    whether a card is present; without one the test skips.  Tolerances as
    chip_smoke.py: forward 1e-4 / 2e-2 max abs, backward 1e-4 / 3e-2 of
    max |reference| (float32 / bfloat16)."""
    from tests.torch_port_child import run_child

    _, meta = run_child(__file__, str(tmp_path), "cuda")
    if "skip" in meta:
        pytest.skip(meta["skip"])
    for key, (fwd, bwd) in meta["errors"].items():
        f32 = key.startswith("float32")
        assert fwd <= (1e-4 if f32 else 2e-2), key
        assert bwd <= (1e-4 if f32 else 3e-2), key


def _child_cuda(job):
    import torch

    from mimm_tpu_torch.ops import flash_attention as fa

    meta = {}
    if not torch.cuda.is_available():
        meta["skip"] = "needs a CUDA card: the kernels have no CPU mode"
    else:
        q, k, v, bias, do = (torch.from_numpy(x).cuda() for x in _inputs())
        q, k, v, do = (torch.cat([t] * 4, dim=-1).contiguous()
                       for t in (q, k, v, do))
        seed = torch.tensor([5], dtype=torch.int32, device="cuda")
        meta["errors"] = {}
        for dt in (torch.float32, torch.bfloat16):
            for rate in (0.0, 0.1):
                args = [t.to(dt) for t in (q, k, v)] + [bias, seed, rate]
                fwd = (fa.flash_attention(*args).float()
                       - fa.flash_attention_plain(*args).float()).abs().max()
                got = fa.flash_attention_bwd(*args, do.to(dt))
                want = fa.flash_attention_bwd_plain(*args, do.to(dt))
                bwd = max(((g.float() - w.float()).abs().max()
                           / w.float().abs().max()).item()
                          for g, w in zip(got, want))
                meta["errors"][f"{str(dt)[6:]} rate {rate}"] = \
                    [fwd.item(), bwd]
    np.savez(os.path.join(job, "out.npz"))
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


def _error_of(fn):
    try:
        fn()
    except Exception as e:  # the test reads the exception's type
        return f"{type(e).__name__}: {e}"
    return "no error"


def _child(job):
    import torch

    from mimm_tpu_torch.ops import dropout as drop
    from mimm_tpu_torch.ops import flash_attention as fa
    from mimm_tpu_torch.ops.philox import attention_keep_mask, philox4x32

    with np.load(os.path.join(job, "in.npz")) as z:
        q, k, v, bias, do = (torch.from_numpy(z[n])
                             for n in ("q", "k", "v", "bias", "do"))
    out, meta = {}, {}
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    res = fa.flash_attention(*qkv, bias)
    out["out"] = res.detach().numpy()
    for name, g in zip(("dq", "dk", "dv"), torch.autograd.grad(res, qkv, do)):
        out[name] = g.numpy()

    meta["philox"] = [[int(w) for w in philox4x32(c, key)]
                      for c, key, _ in PHILOX_KAT]
    seed = torch.tensor([12345], dtype=torch.int32)
    meta["keep_rate"] = {
        str(r): attention_keep_mask(seed, *KEEP_SHAPE[:3], r).float()
        .mean().item() for r in RATES}
    a = fa.flash_attention(q, k, v, bias, seed, 0.1)
    meta["same_seed_equal"] = torch.equal(
        a, fa.flash_attention(q, k, v, bias, seed.clone(), 0.1))
    meta["other_seed_differs"] = not torch.equal(
        a, fa.flash_attention(q, k, v, bias, seed + 1, 0.1))
    m = attention_keep_mask(seed, B, H, L, 0.3)
    meta["heads_differ"] = not torch.equal(m[0, 0], m[0, 1]) \
        and not torch.equal(m[0, 0], m[1, 0])
    # the plain formula on the same mask
    p = torch.softmax(q @ k.transpose(-1, -2) / D ** 0.5
                      + bias[:, None, None, :], dim=-1)
    p = p * attention_keep_mask(seed, B, H, L, 0.1) / 0.9
    meta["masked_formula_err"] = (a - p @ v).abs().max().item()

    g = torch.Generator().manual_seed(0)
    small = [torch.randn(1, 2, 9, 8, generator=g, dtype=torch.float64,
                         requires_grad=True) for _ in range(3)]
    small_bias = torch.zeros(1, 9)
    small_bias[0, 7:] = -10000.0
    meta["gradcheck"] = torch.autograd.gradcheck(
        lambda a_, b_, c_: fa.flash_attention(a_, b_, c_, small_bias, seed,
                                              0.1), small)

    meta["dropout"] = {}
    x = torch.ones(1 << 20)
    for name in ("u8_dropout", "packed_dropout", "dropout"):
        fn = getattr(drop, name)
        y = fn(x, 0.1, torch.Generator().manual_seed(1))
        meta["dropout"][name] = {
            "n": x.numel(), "keep": (y != 0).float().mean().item(),
            "kept_values": sorted({round(float(t), 6)
                                   for t in y[y != 0].unique()}),
            "deterministic": torch.equal(
                fn(x, 0.1, None, deterministic=True), x)
            and torch.equal(fn(x, 0.0, None), x),
            "same_generator_seed_equal": torch.equal(
                y, fn(x, 0.1, torch.Generator().manual_seed(1))),
            "rate1_zero": torch.equal(fn(x, 1.0, None), torch.zeros_like(x)),
        }
    meta["no_seed"] = _error_of(lambda: fa.flash_attention(q, k, v, bias,
                                                           None, 0.1))
    meta["rate_one"] = _error_of(lambda: fa.flash_attention(q, k, v, bias,
                                                            seed, 1.0))
    np.savez(os.path.join(job, "out.npz"), **out)
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    if sys.argv[2:] == ["cuda"]:
        _child_cuda(sys.argv[1])
    else:
        _child(sys.argv[1])
