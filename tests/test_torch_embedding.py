"""The port's embedding lookup (mimm_tpu_torch/ops/embedding.py), whose
backward sums each row's gradient in a fixed order, against
``F.embedding``.

Cases: a small table, BERT's token-type table (2 rows, every position of
a (64, 96) batch, most of them row 0), a word table whose rows' tails are
padding (row 0), a one-row table, and 5000 indices over 3 rows (the
block reduction recurses three times, with runs across block boundaries).
For each, in float64, float32 and bfloat16:

* the forward equals ``F.embedding``'s bit for bit;
* float64: the gradient equals ``F.embedding``'s to 1e-12 of the sum of
  the absolute contributions;
* float32 and bfloat16: the gradient is the exact (float64) sum rounded
  once: within one unit in the last place of the result, where
  ``F.embedding`` in float32 drifts by up to many;
* two backward calls give the same bits.

The port side runs in a jax-free child (tests/torch_port_child.py).
"""

import json
import os
import sys

import numpy as np
import pytest

# (name, rows, index shape)
CASES = (("small", 30, (4, 7)), ("token_type", 2, (64, 96)),
         ("padded_words", 1000, (16, 96)), ("one_row", 1, (3, 5)),
         ("deep", 3, (5000,)))
DTYPES = ("float64", "float32", "bfloat16")
WIDTH = 24


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from tests.torch_port_child import run_child

    job = str(tmp_path_factory.mktemp("embedding"))
    np.savez(os.path.join(job, "in.npz"))
    _, meta = run_child(__file__, job, timeout=300)
    return meta


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_lookup_against_f_embedding(results, case, dtype):
    got = results[f"{case}/{dtype}"]
    assert got["forward_equal"], got
    assert got["same_bits_twice"], got
    if dtype == "float64":
        assert got["grad_vs_f_embedding"] <= 1e-12, got
    else:
        assert got["ulps_from_exact"] <= 1.0, got


def test_f_embedding_float32_drifts_where_the_lookup_does_not(results):
    """The control: on the long token-type sums, F.embedding's float32
    accumulation lands several units in the last place from the exact
    sum, which the one-ulp bound above would reject."""
    assert results["token_type/float32"]["f_embedding_ulps"] > 1.0


def _ulps(got, exact):
    """|got − exact| in units in the last place of ``got``'s dtype at
    |exact|."""
    import torch

    finfo = torch.finfo(got.dtype)
    mantissa = {torch.float32: 23, torch.bfloat16: 7}[got.dtype]
    e = exact.abs().clamp(min=finfo.tiny)
    ulp = torch.pow(2.0, torch.floor(torch.log2(e)) - mantissa)
    return ((got.double() - exact).abs() / ulp).max().item()


def _child(job):
    import torch
    import torch.nn.functional as F

    from mimm_tpu_torch.ops.embedding import embedding_lookup

    gen = torch.Generator().manual_seed(11)
    meta = {}
    for case, rows, shape in CASES:
        ids = torch.randint(0, rows, shape, generator=gen)
        if case == "padded_words":
            ids[:, 40:] = 0
        elif case == "token_type":
            ids[:, 70:] = 1
        weight = torch.randn(rows, WIDTH, generator=gen, dtype=torch.float64)
        dy = torch.randn(*shape, WIDTH, generator=gen, dtype=torch.float64)
        scale = torch.zeros(rows, WIDTH, dtype=torch.float64).index_add_(
            0, ids.reshape(-1), dy.reshape(-1, WIDTH).abs()).max().item()
        for name in DTYPES:
            dt = getattr(torch, name)
            w, g = weight.to(dt), dy.to(dt)
            exact_dt = torch.zeros(rows, WIDTH, dtype=torch.float64) \
                .index_add_(0, ids.reshape(-1), g.double().reshape(-1, WIDTH))
            grads = []
            for _ in range(2):
                leaf = w.clone().requires_grad_()
                out = embedding_lookup(ids, leaf)
                (grad,) = torch.autograd.grad(out, (leaf,), g)
                grads.append(grad)
            ref_leaf = w.clone().requires_grad_()
            ref = F.embedding(ids, ref_leaf)
            (ref_grad,) = torch.autograd.grad(ref, (ref_leaf,), g)
            rec = {"forward_equal": bool(torch.equal(out, ref)),
                   "same_bits_twice": bool(torch.equal(*grads)),
                   "grad_vs_f_embedding": (grads[0].double()
                                           - ref_grad.double()).abs().max()
                   .item() / scale}
            if name != "float64":
                rec["ulps_from_exact"] = _ulps(grads[0], exact_dt)
                rec["f_embedding_ulps"] = _ulps(ref_grad, exact_dt)
            meta[f"{case}/{name}"] = rec
    np.savez(os.path.join(job, "out.npz"))
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    _child(sys.argv[1])
