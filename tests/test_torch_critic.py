"""The port's pairwise critic on its kernel path (mimm_tpu_torch/ops/
pairwise_critic.py, ``force_kernel=True``) against JAX's Pallas kernels in
interpret mode (mimm_tpu/ops/pairwise_critic.py), on the same numpy inputs.

On the CPU the port's autograd function runs ``pair_scores_plain`` and
``pair_scores_bwd_plain``, the plain versions the CUDA kernels are held
against on the card.  Shapes: (20, 12) with the critic 32-16-1 in one
block, and (40, 35) with 16-8-1 and JAX's block sizes patched to (8, 16),
so the TPU kernels run a 5 x 3 grid with padded rows (as
tests/test_pallas_critic.py:100-134 does).  Tolerances are JAX's own:
scores rtol/atol 1e-5, gradients of emb_img, emb_txt, W1, b1, W2, b2, w3
and b3 rtol 2e-4 / atol 2e-5 (test_pallas_critic.py:32,55; float32 sums in
another order).  ``pair_scores_bwd_plain``, written out without autograd,
also matches autograd through ``pair_scores_plain`` in float64 to 1e-12.

The JAX side runs in the pytest worker, the port side in a jax-free child
(tests/torch_port_child.py).
"""

import json
import os
import sys

import numpy as np
import pytest

# name -> (B_img, B_txt, embedding width, critic hidden, JAX block sizes)
SHAPES = {"one_block": (20, 12, 16, (32, 16), None),
          "tiled": (40, 35, 8, (16, 8), (8, 16))}
GRADS = ("emb_img", "emb_txt", "w1", "b1", "w2", "b2", "w3", "b3")
PLAIN_GRADS = ("dh_img", "dh_txt", "db1", "dw2", "db2", "dw3", "db3")


def _inputs(name):
    """Embeddings, the critic's layers [(w, b)] and the cotangent, float32."""
    n_img, n_txt, d, hidden, _ = SHAPES[name]
    rng = np.random.default_rng(len(name))
    dims = [2 * d, *hidden, 1]
    layers = [(rng.standard_normal((a, b)) / np.sqrt(a),
               0.1 * rng.standard_normal(b)) for a, b in zip(dims, dims[1:])]
    out = {"emb_img": rng.standard_normal((n_img, d)),
           "emb_txt": rng.standard_normal((n_txt, d)),
           "cot": rng.standard_normal((n_img, n_txt))}
    for i, (w, b) in enumerate(layers):
        out[f"w{i + 1}"], out[f"b{i + 1}"] = w, b
    return {k: v.astype(np.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    import mimm_tpu.ops.pairwise_critic as pc
    from tests.torch_port_child import run_child

    job = str(tmp_path_factory.mktemp("critic"))
    arrays, want = {}, {}
    for name, (*_, blocks) in SHAPES.items():
        x = _inputs(name)
        arrays.update({f"{name}/{k}": v for k, v in x.items()})
        params = [{"w": jnp.asarray(x[f"w{i}"]), "b": jnp.asarray(x[f"b{i}"])}
                  for i in (1, 2, 3)]
        ei, et, cot = (jnp.asarray(x[k]) for k in ("emb_img", "emb_txt",
                                                   "cot"))
        with pytest.MonkeyPatch.context() as mp:
            if blocks:
                mp.setattr(pc, "MAX_BLOCK_I", blocks[0])
                mp.setattr(pc, "MAX_BLOCK_J", blocks[1])
            fn = lambda p, a, b: pc.pairwise_critic_scores_pallas(
                p, a, b, force_kernel=True)
            want[f"{name}/scores"] = np.asarray(fn(params, ei, et))
            gp, gi, gt = jax.grad(lambda p, a, b: jnp.sum(fn(p, a, b) * cot),
                                  argnums=(0, 1, 2))(params, ei, et)
        want[f"{name}/emb_img"], want[f"{name}/emb_txt"] = gi, gt
        for i, layer in enumerate(gp, 1):
            want[f"{name}/w{i}"], want[f"{name}/b{i}"] = layer["w"], layer["b"]
    np.savez(os.path.join(job, "in.npz"), **arrays)
    got, meta = run_child(__file__, job)
    return {k: np.asarray(v) for k, v in want.items()}, got, meta


@pytest.mark.parametrize("name", list(SHAPES))
def test_scores_match_jax_kernel(results, name):
    want, got, _ = results
    key = f"{name}/scores"
    assert got[key].shape == want[key].shape == SHAPES[name][:2]
    np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("grad", GRADS)
@pytest.mark.parametrize("name", list(SHAPES))
def test_gradients_match_jax_kernel(results, name, grad):
    want, got, _ = results
    key = f"{name}/{grad}"
    assert got[key].shape == np.shape(want[key]), key
    np.testing.assert_allclose(got[key], want[key], rtol=2e-4, atol=2e-5,
                               err_msg=key)


@pytest.mark.parametrize("grad", PLAIN_GRADS)
def test_plain_backward_matches_autograd_f64(results, grad):
    """``pair_scores_bwd_plain``'s formulas against autograd through
    ``pair_scores_plain``, float64, ragged (7, 5) pairs, H1=12, H2=6; the
    image rows also in blocks of 3 (the blocking chip_smoke.py uses)."""
    meta = results[2]
    assert meta["plain_bwd_err"][grad] <= 1e-12
    assert meta["plain_bwd_blocked_err"][grad] <= 1e-12


def test_cpu_path_launches_no_kernel(results):
    assert results[2]["launches"] == {}


@pytest.mark.cuda
def test_kernels_match_plain_on_card(tmp_path):
    """The CUDA kernels against their plain versions on the card at the
    (20, 12) shape and a tiled ragged one with the reference critic's
    widths (run there with ``python -m pytest --noconftest -m cuda
    tests/test_torch_critic.py``).  Without a card the test skips."""
    from tests.torch_port_child import run_child

    _, meta = run_child(__file__, str(tmp_path), "cuda")
    if "skip" in meta:
        pytest.skip(meta["skip"])
    for shape, errs in meta["errors"].items():
        assert max(errs.values()) <= 1e-4, (shape, errs)
    assert meta["launches"] == {n: 2 for n in meta["kernels"]}


def _child_cuda(job):
    import torch

    from mimm_tpu_torch.ops import pairwise_critic as pc

    meta = {}
    if not torch.cuda.is_available():
        meta["skip"] = "needs a CUDA card: the kernels have no CPU mode"
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        gen = torch.Generator(device="cuda").manual_seed(0)
        pc.reset_launch_counts()
        meta["errors"] = {}
        for n_img, n_txt in ((20, 12), (300, 129)):
            # values on a 2^-6 grid: z2 is exact in any summation order
            grid = lambda *s, b=1.0: torch.randint(
                -int(64 * b), int(64 * b) + 1, s, generator=gen,
                device="cuda").float() / 64
            args = (grid(n_img, 1024, b=2.0), grid(n_txt, 1024, b=2.0),
                    grid(1024, b=0.5), grid(1024, 512, b=0.25),
                    grid(512, b=0.5), grid(512, 1, b=0.5), grid(1),
                    grid(n_img, n_txt))
            got = [pc.pair_scores(*args[:7]), *pc.pair_scores_bwd(*args)]
            torch.cuda.synchronize()
            want = [pc.pair_scores_plain(*args[:7]),
                    *pc.pair_scores_bwd_plain(*args)]
            meta["errors"][f"{n_img}x{n_txt}"] = {
                n: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                .item() for n, a, b in zip(("S", *PLAIN_GRADS), got, want)}
        meta["launches"] = dict(pc.LAUNCHES)
        meta["kernels"] = list(pc.KERNELS.values())
    np.savez(os.path.join(job, "out.npz"))
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


def _child(job):
    import torch

    from mimm_tpu_torch.ops import pairwise_critic as pc

    with np.load(os.path.join(job, "in.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    pc.reset_launch_counts()
    out, meta = {}, {}
    for name in SHAPES:
        t = {k.split("/")[1]: torch.from_numpy(v) for k, v in arrays.items()
             if k.startswith(name + "/")}
        leaves = {k: t[k].clone().requires_grad_() for k in GRADS}
        params = [{"w": leaves[f"w{i}"], "b": leaves[f"b{i}"]}
                  for i in (1, 2, 3)]
        scores = pc.pairwise_critic_scores_pallas(
            params, leaves["emb_img"], leaves["emb_txt"], force_kernel=True)
        out[f"{name}/scores"] = scores.detach().numpy()
        grads = torch.autograd.grad((scores * t["cot"]).sum(),
                                    [leaves[k] for k in GRADS])
        for k, g in zip(GRADS, grads):
            out[f"{name}/{k}"] = g.numpy()

    # the written-out backward against autograd, float64
    rng = np.random.default_rng(7)
    n_img, n_txt, h1, h2 = 7, 5, 12, 6
    x = [torch.from_numpy(rng.standard_normal(s)) for s in (
        (n_img, h1), (n_txt, h1), (h1,), (h1, h2), (h2,), (h2, 1), (1,),
        (n_img, n_txt))]
    leaves = [v.clone().requires_grad_() for v in x[:7]]
    with torch.enable_grad():
        s = pc.pair_scores_plain(*leaves)
        auto = torch.autograd.grad((s * x[7]).sum(), leaves)
    # autograd's order: h_img, h_txt, b1, W2, b2, w3, b3
    auto = dict(zip(("dh_img", "dh_txt", "db1", "dw2", "db2", "dw3", "db3"),
                    auto))
    for key, rows in (("plain_bwd_err", None), ("plain_bwd_blocked_err", 3)):
        mine = dict(zip(PLAIN_GRADS, pc.pair_scores_bwd_plain(*x, rows=rows)))
        meta[key] = {n: (mine[n] - auto[n]).abs().max().item()
                     if mine[n].shape == auto[n].shape else float("inf")
                     for n in PLAIN_GRADS}
    meta["launches"] = dict(pc.LAUNCHES)
    np.savez(os.path.join(job, "out.npz"), **out)
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    if sys.argv[2:] == ["cuda"]:
        _child_cuda(sys.argv[1])
    else:
        _child(sys.argv[1])
