"""The port's ResNetAE and its train step (mimm_tpu_torch/models/
autoencoder.py, train/ae.py, checkpoint.ae_state_dict_from_flax) against
the JAX package's on the same weights and images.

A small AE (IMG 32, 3 levels, 1 residual block, z_dim 16, bottleneck 32,
multi-res skips: a 4x4x16 latent, so fc1 / fc2 re-wire a real NHWC/NCHW
flatten), JAX's random weights carried across by the port's
``ae_state_dict_from_flax``:

* the converter gives JAX's ``ae_state_dict_from_variables`` key for key
  and value for value, bit for bit;
* float64: ``encode`` and the whole AE in eval mode (random running
  statistics) and in train mode, and the running statistics after the
  train forward (flax's biased variance), to 1e-10;
* bfloat16 compute with float32 parameters, eval and train: the output
  to BF16_ATOL (a sigmoid in (0, 1); both sides round each layer to bf16
  and differ in the order of the convolutions' sums);
* a 5-step float64 trajectory of ``make_ae_train_step`` (B=4, Adam at
  1e-3) with ``chunks`` 1, 2 and 3 (3 does not divide 4: the single-pass
  step): the 5 losses to 1e-10, the running statistics after step 1 (the
  chunked step's mean over chunks) and every parameter and statistic
  after step 5 to TRAJ_ATOL; chunks 3 gives chunks 1's bits.

The JAX side runs in the pytest worker, the port side in a jax-free child
(tests/torch_port_child.py).
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

B = 4
IMG = 32
SMALL = dict(input_shape=(IMG, IMG, 1), n_residual_blocks=1, n_levels=3,
             z_dim=16, bottleneck_dim=32)
CONVERT = dict(n_levels=3, n_res=1, z_dim=16)
STEPS = 5
LR = 1e-3
CHUNKS = (1, 2, 3)
ATOL = 1e-10
TRAJ_ATOL = 1e-9
BF16_ATOL = 2e-2


def _images(rng, n):
    return rng.random((n, IMG, IMG, 1))


def _sd_arrays(sd, prefix):
    return {f"{prefix}{k}": np.asarray(v) for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


class _Jnp64:
    """jax.numpy whose float32 ``zeros`` are float64."""

    def __init__(self, jnp):
        self._jnp = jnp

    def __getattr__(self, name):
        return getattr(self._jnp, name)

    def zeros(self, shape, dtype=None):
        if dtype == self._jnp.float32:
            dtype = self._jnp.float64
        return self._jnp.zeros(shape, dtype)


def trajectories(model, tx, v64, batches, want):
    """JAX's ``make_ae_train_step`` for STEPS steps from ``v64`` with each
    of CHUNKS: the losses, the running statistics after step 1 and the
    whole state after the last, reference-keyed, into ``want``."""
    import jax
    import jax.numpy as jnp

    from mimm_tpu import checkpoint as ckpt
    from mimm_tpu.train.ae import AETrainState, make_ae_train_step

    def keyed(state, running_only=False):
        sd = ckpt.ae_state_dict_from_variables(jax.device_get(
            {"params": state.params, "batch_stats": state.batch_stats}),
            **CONVERT)
        return {k: v for k, v in sd.items()
                if not running_only or "running" in k}

    for k in CHUNKS:
        state = AETrainState(jax.tree.map(jnp.array, v64["params"]),
                             jax.tree.map(jnp.array, v64["batch_stats"]),
                             tx.init(v64["params"]), jnp.zeros([], jnp.int32))
        step = make_ae_train_step(model, tx, chunks=k)
        losses = []
        for n in range(STEPS):
            state, loss = step(state, jnp.asarray(batches[n % 3]))
            losses.append(float(loss))
            if n == 0:
                want.update(_sd_arrays(keyed(state, True), f"chunks{k}_step1/"))
        want[f"chunks{k}_losses"] = np.asarray(losses)
        want.update(_sd_arrays(keyed(state), f"chunks{k}_end/"))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from mimm_tpu import checkpoint as ckpt
    from mimm_tpu.models.autoencoder import ResNetAE
    from mimm_tpu.train import ae as jax_ae
    from mimm_tpu.train.optim import adam_torch
    from tests.torch_port_child import flatten_tree, run_child

    job = str(tmp_path_factory.mktemp("ae"))
    rng = np.random.default_rng(3)
    x = _images(rng, B)
    batches = [_images(rng, B) for _ in range(3)]
    arrays = {"x": x, **{f"batch{n}": b for n, b in enumerate(batches)}}
    want = {}

    # ---- bfloat16 compute, float32 parameters -----------------------------
    v32 = jax.device_get(ResNetAE(**SMALL).init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 1)), train=False))
    arrays.update(flatten_tree(v32, "v32/"))
    bf16 = ResNetAE(**SMALL, dtype=jnp.bfloat16)
    x32 = jnp.asarray(x, jnp.float32)
    want["bf16_eval"] = np.asarray(bf16.apply(v32, x32, train=False))
    want["bf16_train"] = np.asarray(bf16.apply(
        v32, x32, train=True, mutable=["batch_stats"])[0])

    with jax.enable_x64(True):
        up = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)
        v64 = up(v32)
        # eval mode reads running statistics: make them other than (0, 1)
        v64["batch_stats"] = jax.tree.map(
            lambda a: rng.uniform(0.5, 1.5, a.shape) if a.ndim else a,
            v64["batch_stats"])
        arrays.update(flatten_tree(v64, "v64/"))
        sd = ckpt.ae_state_dict_from_variables(v64, **CONVERT)
        want.update({f"sd/{k}": np.asarray(v) for k, v in sd.items()})
        model = ResNetAE(**SMALL, dtype=jnp.float64)
        xj = jnp.asarray(x)
        want["eval_encode"] = model.apply(v64, xj, train=False,
                                          method=ResNetAE.encode)
        want["eval_out"] = model.apply(v64, xj, train=False)
        want["train_encode"] = model.apply(
            v64, xj, train=True, method=ResNetAE.encode,
            mutable=["batch_stats"])[0]
        out, mutated = model.apply(v64, xj, train=True,
                                   mutable=["batch_stats"])
        want["train_out"] = out
        want.update(_sd_arrays(
            {k: v for k, v in ckpt.ae_state_dict_from_variables(
                {"params": v64["params"], **mutated}, **CONVERT).items()
             if "running" in k}, "train_stats/"))

        tx = adam_torch(LR)
        # JAX's chunked step carries the loss sum as float32
        # (mimm_tpu/train/ae.py:135), which lax.scan refuses beside a
        # float64 loss: the float64 run gets a float64 carry
        real_jnp = jax_ae.jnp
        jax_ae.jnp = _Jnp64(jnp)
        try:
            trajectories(model, tx, v64, batches, want)
        finally:
            jax_ae.jnp = real_jnp
    # the full-width configuration's keys and shapes (zeros: no compute)
    from mimm_tpu.config import TrainingConfig

    full = jax.eval_shape(
        lambda: jax_ae.build_ae_model(TrainingConfig(img_size=256)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 1)), train=False))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), full)
    want.update({f"full_shape/{k}": np.asarray(np.shape(v)) for k, v in
                 ckpt.ae_state_dict_from_variables(zeros).items()})
    want = {k: np.asarray(v) for k, v in want.items()}
    np.savez(os.path.join(job, "in.npz"), **arrays)
    got, _ = run_child(__file__, job, timeout=300)
    shutil.rmtree(job)
    return want, got


def test_converter_matches_jax_exporter(results):
    want, got = results
    keys = sorted(k for k in want if k.startswith("sd/"))
    assert keys == sorted(k for k in got if k.startswith("sd/"))
    for k in keys:
        assert want[k].dtype == got[k].dtype and np.array_equal(
            want[k], got[k]), k


@pytest.mark.parametrize("name", ["eval_encode", "eval_out", "train_encode",
                                  "train_out"])
def test_forward_float64(results, name):
    want, got = results
    assert want[name].shape == got[name].shape, name
    np.testing.assert_allclose(got[name], want[name], rtol=0, atol=ATOL)


def test_train_forward_running_stats(results):
    want, got = results
    keys = [k for k in want if k.startswith("train_stats/")]
    assert len(keys) == 2 * sum(1 for k in want
                                if k.startswith("sd/")
                                and k.endswith("running_var"))
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_forward_bfloat16(results, mode):
    want, got = results
    w = want[f"bf16_{mode}"].astype(np.float32)
    g = got[f"bf16_{mode}"]
    assert g.shape == w.shape and np.isfinite(g).all()
    assert np.abs(g - w).max() <= BF16_ATOL, np.abs(g - w).max()


@pytest.mark.parametrize("chunks", CHUNKS)
def test_trajectory_float64(results, chunks):
    want, got = results
    np.testing.assert_allclose(got[f"chunks{chunks}_losses"],
                               want[f"chunks{chunks}_losses"], rtol=0,
                               atol=ATOL)
    for stage in ("step1", "end"):
        keys = [k for k in want if k.startswith(f"chunks{chunks}_{stage}/")]
        assert keys
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=TRAJ_ATOL, err_msg=k)


def test_build_ae_model_is_the_reference_configuration(results):
    """``build_ae_model`` at img 256 (6 levels, 2 residual blocks, z_dim
    192, bottleneck 768, skips; ``output_channels`` as the input channel
    count) has the keys and shapes JAX's exporter writes for JAX's
    ``build_ae_model``."""
    want, got = results
    shapes = lambda d, p: {k[len(p):]: tuple(v) for k, v in d.items()
                           if k.startswith(p)}
    assert shapes(got, "full_shape/") == shapes(want, "full_shape/")
    assert len(shapes(got, "full_shape/")) > 300


def test_chunks_that_do_not_divide_take_the_single_pass(results):
    _, got = results
    for k in got:
        if k.startswith("chunks3_"):
            assert np.array_equal(got[k], got[k.replace("chunks3_",
                                                        "chunks1_")]), k
    assert not np.array_equal(got["chunks2_losses"], got["chunks1_losses"])


def _child(job):
    import torch

    from mimm_tpu_torch import checkpoint as ckpt
    from mimm_tpu_torch.config import TrainingConfig
    from mimm_tpu_torch.models.autoencoder import ResNetAE
    from mimm_tpu_torch.train import ae
    from tests.torch_port_child import unflatten_tree

    torch.backends.mkldnn.enabled = False
    with np.load(os.path.join(job, "in.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    tree = unflatten_tree({k: v for k, v in arrays.items() if "/" in k})
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    nhwc = lambda t: t.detach().permute(0, 2, 3, 1).float().numpy() \
        if t.dtype == torch.bfloat16 else t.detach().permute(0, 2, 3, 1) \
        .numpy()
    out = {}

    sd = ckpt.ae_state_dict_from_flax(tree["v64"], **CONVERT)
    out.update({f"sd/{k}": v.numpy() for k, v in sd.items()})

    def fresh(dtype, weights):
        model = ResNetAE(**SMALL, dtype=dtype)
        if dtype == torch.float64:
            model = model.double()
        model.load_state_dict(weights, strict=True)
        return model

    model = fresh(torch.float64, sd)
    x = nchw(arrays["x"])
    with torch.no_grad():
        out["eval_encode"] = model.encode(x).numpy()
        out["eval_out"] = nhwc(model(x))
        out["train_encode"] = fresh(torch.float64, sd).encode(
            x, train=True).numpy()
        out["train_out"] = nhwc(model(x, train=True))
    out.update({f"train_stats/{k}": v.numpy()
                for k, v in model.state_dict().items() if "running" in k})

    sd32 = ckpt.ae_state_dict_from_flax(tree["v32"], **CONVERT)
    x32 = x.float()
    with torch.no_grad():
        out["bf16_eval"] = nhwc(fresh(torch.bfloat16, sd32)(x32))
        out["bf16_train"] = nhwc(fresh(torch.bfloat16, sd32)(x32,
                                                              train=True))

    full = ae.build_ae_model(TrainingConfig(img_size=256), device="cpu")
    out.update({f"full_shape/{k}": np.asarray(tuple(v.shape))
                for k, v in full.state_dict().items()})
    del full
    cfg = TrainingConfig(init_lr=LR, compute_dtype="float32")
    for k in CHUNKS:
        model = fresh(torch.float64, sd)
        state = ae.create_ae_state(model, cfg, None, weights=sd)
        step = ae.make_ae_train_step(model, ae._ae_tx(cfg), chunks=k)
        losses = []
        for n in range(STEPS):
            state, loss = step(state, torch.from_numpy(arrays[f"batch{n % 3}"]))
            losses.append(float(loss))
            if n == 0:
                out.update({f"chunks{k}_step1/{kk}": v.numpy().copy()
                            for kk, v in model.state_dict().items()
                            if "running" in kk})
        out[f"chunks{k}_losses"] = np.asarray(losses)
        out.update({f"chunks{k}_end/{kk}": v.detach().numpy().copy()
                    for kk, v in model.state_dict().items()
                    if not kk.endswith("num_batches_tracked")})
    np.savez(os.path.join(job, "out.npz"), **out)
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump({}, f)


if __name__ == "__main__":
    _child(sys.argv[1])
