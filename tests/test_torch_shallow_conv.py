"""The port's shallow-conv stem (mimm_tpu_torch/ops/shallow_conv.py, the
``pallas_stem`` binding in models/resnet.py) against the JAX package's
(mimm_tpu/ops/shallow_conv.py, Pallas in interpret mode on the CPU, as
tests/test_shallow_conv.py runs it), on inputs made with numpy from a seed.

* The plain versions against JAX's three kernels, called as its custom VJP
  calls them, at (B, H, W) = (3, 32, 32), a ragged (2, 17, 23) and (2,
  256, 256), as max |Δ| over max |JAX|: the forward with float32 output and
  dx to 1e-6 (both sum the same f32 products in the same order, but XLA may
  contract a product and a sum into one FMA), the forward with bfloat16
  output to one bf16 ulp (2^-8: a sum within f32 noise of a rounding
  boundary may round the other way), dW to 1e-5 (up to 131 k-term f32 sums
  in another order).  The stem as the bf16 model calls it (the image
  rounded to bf16, the weight in f32, y in bf16) against JAX's
  ``shallow_conv3x3`` on the same: one ulp, and 99 % of the elements equal.
* ``shallow_conv3x3`` through autograd against ``jax.value_and_grad`` of
  JAX's (the counterpart of test_shallow_conv_vjp_matches_lax, its bounds:
  the loss to rtol 1e-5, both gradients to rtol = atol = 1e-4).
* ``ResNet256_6_2_1(pallas_stem=True)`` against JAX's on one set of
  weights (``checkpoint.resnet_state_dict_from_flax``), B=2 at 256²: in
  float32 eval mode the embedding to rtol 1e-4 / atol 1e-5 (f32
  convolutions in another summation order), in train mode the embedding
  and every updated BatchNorm statistic to rtol 2e-3 / atol 1e-4 (JAX's own
  bound for its stem against XLA's: f32 noise amplified through batch
  statistics); in bfloat16 the mean and largest |Δz| under 0.01 and 0.125
  in eval mode (tests/test_torch_train.py's bf16 eval bounds; |z| up to
  12.5 here, one bf16 ulp 0.0625; measured 0.0082, 0.0625) and under 0.05
  and 0.25 in train mode, where the canonical stem's gap is already 0.027
  and 0.156 (bf16 roundings of the convolutions amplified through batch
  statistics of 2 images; the kernel stem's measured 0.030, 0.141); the
  updated bf16 statistics to 2e-2 of max(1, max |JAX|) (measured 8.2e-3,
  a running variance of layer 6, whose batch holds 2 × 4 × 4 positions).
* The port's kernel stem against its canonical stem (JAX's
  test_resnet_pallas_stem_matches_canonical, its bound rtol 2e-3 / atol
  1e-4, in train mode), the same state-dict keys, and the image's gradient
  through the whole tower in eval mode (dx, row 14) against the canonical
  stem's to 1e-5 of its largest element (f32 sums through 31 layers in
  another order).  dx runs only there: a model step on data never
  computes it.
* Three float32 production-preset MI steps with ``pallas_stem`` (dropout 0,
  B=4, the full ResNet, tests/test_torch_fused_ffn.py's harness and per-
  step loss limits 1e-5, 5e-5, 3e-4; BatchNorm statistics to rtol 1e-4 /
  atol 1e-5 after the first step, 1e-3 after the third), and one GradCache
  step in 2 chunks against JAX ``grad_cache_body`` (loss 1e-5, statistics
  as after the first step).  The stem's forward runs once a direct step and
  twice a GradCache chunk (both passes), dW once a step or chunk, dx never.
* In the port alone, float64, dropout 0.1, two steps with the stem on:
  remat on equals off to the last bit.
* The wrapper refuses C_in ≠ 1, a kernel that is not 3x3, other dtypes and
  non-contiguous memory; ``s2d_stem`` with ``pallas_stem`` raises JAX's
  ValueError.

The JAX side runs in the pytest worker, the port side in a jax-free child
(tests/torch_port_child.py).
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

OP_SHAPES = ((3, 32, 32), (2, 17, 23), (2, 256, 256))
C = 8
SEQ = 16
VOCAB = 64
B = 4
STEPS = 3
STEPS_PER_EPOCH = 20
BERT = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=32, num_classes=1,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
DROP_BERT = dict(BERT, num_hidden_layers=1, hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1)
CFG = dict(batch_size=B, img_size=256, max_seq_length=SEQ,
           num_train_epochs=1, mi_estimator="dv", seed=0, pallas_stem=True)
LOSS_ATOL = (1e-5, 5e-5, 3e-4)        # per step
GC_CHUNKS = 2
BF16_ULP = 2.0 ** -8


def _op_inputs():
    rng = np.random.default_rng(0)
    arrays = {"kernel": (rng.standard_normal((3, 3, 1, C)) * 0.3)
              .astype(np.float32)}
    for b, h, w in OP_SHAPES:
        arrays[f"x{h}x{w}"] = rng.random((b, h, w, 1)).astype(np.float32)
        arrays[f"dy{h}x{w}"] = rng.standard_normal((b, C, h, w)) \
            .astype(np.float32)
    arrays["vjp_x"] = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    arrays["vjp_k"] = (rng.standard_normal((3, 3, 1, C)) * 0.2) \
        .astype(np.float32)
    arrays["vjp_r"] = rng.standard_normal((2, 16, 16, C)).astype(np.float32)
    arrays["tower_x"] = rng.random((2, 256, 256, 1)).astype(np.float32)
    return arrays


def _batches():
    rng = np.random.default_rng(1)
    out = []
    for n in range(STEPS):
        sids = np.arange(B, dtype=np.int64) + 10 * n
        if n == 1:
            sids[2] = sids[0]      # a same-study pair: excluded negatives
        out.append({
            "image": rng.random((B, 256, 256, 1)).astype(np.float32),
            "txt_ids": rng.integers(0, VOCAB, (B, SEQ)).astype(np.int32),
            "txt_masks": (np.arange(SEQ)[None] < rng.integers(
                4, SEQ + 1, (B, 1))).astype(np.int32),
            "txt_segments": (np.arange(SEQ)[None] >= 8).astype(np.int32)
            .repeat(B, 0),
            "study_id": sids})
    return out


def _key(h, w):
    return f"{h}x{w}"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from mimm_tpu import checkpoint as ckpt
    from mimm_tpu.config import TrainingConfig
    from mimm_tpu.models.bert import BertConfig
    from mimm_tpu.models.joint import ImageReportModel
    from mimm_tpu.models.resnet import ResNet256_6_2_1
    from mimm_tpu.ops import shallow_conv as jsc
    from mimm_tpu.train.mi import (create_mi_state, make_mi_train_step,
                                   make_optimizers)
    from tests.test_torch_train import _flat_state, _torch_keyed
    from tests.torch_port_child import run_child

    job = str(tmp_path_factory.mktemp("shallow_conv"))
    arrays, want = _op_inputs(), {}

    # ---- the three kernels, as the custom VJP calls them --------------------
    w9 = jnp.asarray(arrays["kernel"]).reshape(9, C)
    for b, h, w in OP_SHAPES:
        k = _key(h, w)
        xp = jnp.pad(jnp.asarray(arrays[f"x{k}"])[..., 0],
                     ((0, 0), (1, 1), (1, 1)))
        want[f"y_f32_{k}"] = jsc._fwd_call(xp, w9, jnp.float32)
        want[f"y_bf16_{k}"] = jsc._fwd_call(xp, w9, jnp.bfloat16) \
            .astype(jnp.float32)
        dxp, dw = jsc._core_bwd(jnp.float32, (xp, w9),
                                jnp.asarray(arrays[f"dy{k}"]))
        want[f"dx_{k}"] = dxp[:, 1:-1, 1:-1]
        want[f"dw_{k}"] = dw

    # ---- the op through value_and_grad --------------------------------------
    r = jnp.asarray(arrays["vjp_r"])

    def loss(x, kern):
        y = jsc.shallow_conv3x3(x, kern, out_dtype=jnp.float32) \
            .transpose(0, 2, 3, 1)
        return jnp.sum(y * r) + jnp.sum(jnp.square(y)) * 0.1

    val, (gx, gk) = jax.value_and_grad(loss, argnums=(0, 1))(
        jnp.asarray(arrays["vjp_x"]), jnp.asarray(arrays["vjp_k"]))
    want.update(vjp_loss=val, vjp_gx=gx, vjp_gk=gk)

    # ---- the stem as the bf16 model calls it --------------------------------
    x = jnp.asarray(arrays["tower_x"])
    want["stem_bf16"] = jsc.shallow_conv3x3(
        x.astype(jnp.bfloat16), jnp.asarray(arrays["kernel"]),
        out_dtype=jnp.bfloat16).astype(jnp.float32)

    # ---- the ResNet with the kernel stem ------------------------------------
    rng = np.random.default_rng(5)
    variables = jax.device_get(ResNet256_6_2_1(dtype=jnp.float32).init(
        jax.random.PRNGKey(3), x[:1], train=False))
    # running means around 0 and variances around 1: eval mode passes
    # signal through every ReLU
    variables = {"params": variables["params"],
                 "batch_stats": jax.tree_util.tree_map_with_path(
                     lambda path, a: (rng.normal(0, 0.1, a.shape)
                                      if path[-1].key == "mean" else
                                      rng.uniform(0.5, 1.5, a.shape))
                     .astype(np.float32), variables["batch_stats"])}
    arrays.update({f"tower_sd/{k}": np.asarray(v) for k, v in
                   ckpt.resnet_state_dict_from_variables(variables).items()})
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        want[f"canonical_train_z_{name}"] = np.asarray(ResNet256_6_2_1(
            dtype=dt).apply(variables, x, train=True,
                            mutable=["batch_stats"])[0][1], np.float32)
        net = ResNet256_6_2_1(dtype=dt, pallas_stem=True)
        want[f"eval_z_{name}"] = np.asarray(
            net.apply(variables, x, train=False)[1], np.float32)
        out, mutated = net.apply(variables, x, train=True,
                                 mutable=["batch_stats"])
        want[f"train_z_{name}"] = np.asarray(out[1], np.float32)
        want.update({f"train_bs_{name}/{k}": np.asarray(v) for k, v in
                     ckpt.resnet_state_dict_from_variables(
                         {"params": variables["params"],
                          "batch_stats": mutated["batch_stats"]}).items()
                     if "running" in k})

    # ---- 3 train steps, then one GradCache step from the same state ---------
    tcfg = TrainingConfig.production(compute_dtype="float32", **CFG)
    model = ImageReportModel(bert_config=BertConfig(**BERT), output_channels=1,
                             dtype=jnp.float32, pallas_stem=True)
    txs = make_optimizers(tcfg, steps_per_epoch=STEPS_PER_EPOCH)
    state = create_mi_state(model, tcfg, txs, jax.random.PRNGKey(0))
    init = jax.device_get(state)
    arrays.update(_flat_state(init.params, init.batch_stats,
                              init.critic_params, "init/"))
    batches = _batches()
    arrays.update({f"batch{n}/{k}": v for n, b in enumerate(batches)
                   for k, v in b.items()})
    step = make_mi_train_step(model, txs, tcfg)
    losses = []
    for n, b in enumerate(batches):
        state, loss_n = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(loss_n))
        if n in (0, STEPS - 1):
            want.update(_torch_keyed(state, "first/" if n == 0 else "final/",
                                     running_only=True))
    want["losses"] = np.array(losses)
    gcfg = tcfg.replace(grad_cache_chunks=GC_CHUNKS)
    gc_state, gc_loss = make_mi_train_step(model, txs, gcfg)(
        jax.device_put(init), {k: jnp.asarray(v)
                               for k, v in batches[0].items()})
    want["gc_loss"] = np.asarray(gc_loss)
    want.update(_torch_keyed(gc_state, "gc/", running_only=True))

    np.savez(os.path.join(job, "in.npz"), **arrays)
    got, meta = run_child(__file__, job, timeout=600)
    shutil.rmtree(job)        # the results are in memory now
    return {k: np.asarray(v) for k, v in want.items()}, got, meta


@pytest.mark.parametrize("shape", OP_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_versions_match_jax_kernels(results, shape):
    want, got, _ = results
    k = _key(*shape[1:])
    # the port's dw (C, 1, 3, 3) against JAX's (9, C)
    pairs = {"y_f32": (got[f"y_f32_{k}"], 1e-6),
             "y_bf16": (got[f"y_bf16_{k}"], BF16_ULP),
             "dx": (got[f"dx_{k}"], 1e-6),
             "dw": (got[f"dw_{k}"].reshape(C, 9).T, 1e-5)}
    for name, (a, tol) in pairs.items():
        b = want[f"{name}_{k}"]
        assert a.shape == b.shape, name
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= tol, (name, err)


def test_autograd_matches_jax_value_and_grad(results):
    want, got, _ = results
    np.testing.assert_allclose(got["vjp_loss"], want["vjp_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["vjp_gx"], want["vjp_gx"], rtol=1e-4,
                               atol=1e-4)
    # the port's (C, 1, 3, 3) against flax's (3, 3, 1, C)
    np.testing.assert_allclose(got["vjp_gk"].transpose(2, 3, 1, 0),
                               want["vjp_gk"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_resnet_pallas_stem_f32_matches_jax(results, mode):
    want, got, _ = results
    rtol, atol = (1e-4, 1e-5) if mode == "eval" else (2e-3, 1e-4)
    np.testing.assert_allclose(got[f"{mode}_z_f32"], want[f"{mode}_z_f32"],
                               rtol=rtol, atol=atol)
    if mode == "train":
        keys = [k for k in want if k.startswith("train_bs_f32/")]
        assert len(keys) == 2 * 31 and set(keys) <= set(got)
        for key in keys:
            np.testing.assert_allclose(got[key], want[key], rtol=2e-3,
                                       atol=1e-4, err_msg=key)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_resnet_pallas_stem_bf16_matches_jax(results, mode):
    """JAX's casts: the image rounded to bf16, then it and the float32
    weight in f32; y rounded once to bf16."""
    want, got, _ = results
    err = np.abs(got[f"{mode}_z_bf16"] - want[f"{mode}_z_bf16"])
    mean, largest = (0.01, 0.125) if mode == "eval" else (0.05, 0.25)
    assert err.mean() <= mean and err.max() <= largest, (err.mean(), err.max())
    if mode == "train":         # the updated BatchNorm statistics
        keys = [k for k in want if k.startswith("train_bs_bf16/")]
        assert len(keys) == 2 * 31 and set(keys) <= set(got)
        for key in keys:
            scale = max(1.0, float(np.abs(want[key]).max()))
            assert np.abs(got[key] - want[key]).max() <= 2e-2 * scale, key


def test_stem_bf16_casts_match_jax(results):
    want, got, _ = results
    err = np.abs(got["stem_bf16"] - want["stem_bf16"])
    assert err.max() <= BF16_ULP * np.abs(want["stem_bf16"]).max()
    assert (err == 0).mean() >= 0.99


def test_pallas_stem_matches_canonical_stem(results):
    want, got, meta = results
    np.testing.assert_allclose(got["train_z_f32"],
                               got["canonical_train_z_f32"], rtol=2e-3,
                               atol=1e-4)
    assert meta["same_keys"] is True


def test_image_gradient_runs_dx_and_matches_canonical(results):
    _, got, meta = results
    ref = got["canonical_tower_dx"]
    err = np.abs(got["tower_dx"] - ref).max() / np.abs(ref).max()
    assert err <= 1e-5, err
    assert meta["tower_calls"] == {"fwd": 1, "dw": 1, "dx": 1}


def test_train_steps_with_pallas_stem_match_jax(results):
    want, got, meta = results
    assert got["losses"].shape == (STEPS,)
    assert (np.abs(got["losses"] - want["losses"]) <= LOSS_ATOL).all(), \
        (got["losses"], want["losses"])
    for prefix, rtol, atol in (("first/", 1e-4, 1e-5), ("final/", 1e-3, 1e-3)):
        keys = [k for k in want if k.startswith(prefix)]
        assert len(keys) == 2 * 31 and set(keys) <= set(got)
        for key in keys:
            np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                       atol=atol, err_msg=key)
    # forward and dW once a step; the image is data: no dx
    assert meta["train_calls"] == {"fwd": STEPS, "dw": STEPS, "dx": 0}
    assert meta["config_reaches_stem"] is True


def test_grad_cache_step_with_pallas_stem_matches_jax(results):
    want, got, meta = results
    np.testing.assert_allclose(got["gc_loss"], want["gc_loss"], rtol=0,
                               atol=1e-5)
    keys = [k for k in want if k.startswith("gc/")]
    assert len(keys) == 2 * 31 and set(keys) <= set(got)
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-5,
                                   err_msg=key)
    # pass 1 and pass 2 run the forward for each chunk, pass 2 the backward
    assert meta["gc_calls"] == {"fwd": 2 * GC_CHUNKS, "dw": GC_CHUNKS,
                                "dx": 0}


def test_remat_bit_equal_with_pallas_stem(results):
    arm = results[2]["remat"]
    assert arm["losses_equal"] is True and arm["max_abs"] == 0.0, arm


@pytest.mark.parametrize("case", ["c_in", "kernel_size", "dtype",
                                  "non_contiguous", "s2d_and_pallas_stem"])
def test_refusals(results, case):
    msg = results[2]["refused"][case]
    want = {"c_in": "ValueError: the shallow conv takes C_in = 1",
            "kernel_size": "ValueError: the shallow conv takes a 3x3 kernel",
            "dtype": "TypeError: the shallow conv takes float32 or bfloat16",
            "non_contiguous": "ValueError: the shallow conv takes contiguous",
            "s2d_and_pallas_stem":
                "ValueError: s2d_stem and pallas_stem are exclusive"}[case]
    assert msg.startswith(want), msg


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    """The three kernels against their plain versions on a CUDA card, f32
    and bf16, aligned and ragged (chip_smoke.py STEM_TOL)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build here")
    from mimm_tpu_torch.ops import shallow_conv as sc

    gen = torch.Generator(device="cuda").manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        for b, h, w in ((2, 64, 64), (3, 257, 131)):
            x = torch.rand(b, h, w, 1, generator=gen, device="cuda").to(dt)
            weight = torch.randn(C, 1, 3, 3, generator=gen, device="cuda")
            dy = torch.randn(b, C, h, w, generator=gen, device="cuda").to(dt)
            assert torch.equal(sc.fwd(x, weight, dt),
                               sc.fwd_plain(x, weight, dt))
            assert torch.equal(sc.dx(dy, weight, dt),
                               sc.dx_plain(dy, weight, dt))
            got, want = sc.dw(x, dy, weight), sc.dw_plain(x, dy)
            assert ((got - want).abs().max() / want.abs().max()) <= 1e-5


def _child(job):
    import copy

    import torch

    from mimm_tpu_torch import checkpoint as ckpt
    from mimm_tpu_torch.config import TrainingConfig
    from mimm_tpu_torch.models.bert import BertConfig
    from mimm_tpu_torch.models.joint import ImageReportModel
    from mimm_tpu_torch.models.resnet import ResNet256_6_2_1
    from mimm_tpu_torch.ops import shallow_conv as sc
    from mimm_tpu_torch.train import mi
    from tests.test_torch_train import _error_of, _port_keyed
    from tests.torch_port_child import unflatten_tree

    torch.backends.mkldnn.enabled = False
    with np.load(os.path.join(job, "in.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    tree = unflatten_tree(arrays)
    out, meta = {}, {}
    t = lambda k: torch.from_numpy(arrays[k])
    # flax (3, 3, 1, C) -> torch (C, 1, 3, 3)
    weight = t("kernel").permute(3, 2, 0, 1).contiguous()

    # ---- the plain versions -------------------------------------------------
    for _, h, w in OP_SHAPES:
        k = _key(h, w)
        x, dy = t(f"x{k}"), t(f"dy{k}")
        out[f"y_f32_{k}"] = sc.fwd_plain(x, weight, torch.float32).numpy()
        out[f"y_bf16_{k}"] = sc.fwd_plain(x, weight, torch.bfloat16) \
            .float().numpy()
        out[f"dx_{k}"] = sc.dx_plain(dy, weight, torch.float32).numpy()
        out[f"dw_{k}"] = sc.dw_plain(x, dy).numpy()

    # ---- the op through autograd --------------------------------------------
    xv = t("vjp_x").requires_grad_()
    kv = t("vjp_k").permute(3, 2, 0, 1).contiguous().requires_grad_()
    y = sc.shallow_conv3x3(xv, kv, torch.float32).permute(0, 2, 3, 1)
    val = (y * t("vjp_r")).sum() + (y * y).sum() * 0.1
    gx, gk = torch.autograd.grad(val, (xv, kv))
    out.update(vjp_loss=val.detach().numpy(), vjp_gx=gx.numpy(),
               vjp_gk=gk.numpy())

    # ---- calls of the three wrappers, as the autograd function makes them ---
    calls = {k: 0 for k in ("fwd", "dw", "dx")}
    real = {k: getattr(sc, k) for k in calls}

    def counting(kind):
        def call(*a):
            calls[kind] += 1
            return real[kind](*a)
        return call

    for k in calls:
        setattr(sc, k, counting(k))

    def read_calls():
        got = dict(calls)
        calls.update(dict.fromkeys(calls, 0))
        return got

    # ---- the ResNet ---------------------------------------------------------
    sd = {k[len("tower_sd/"):]: torch.from_numpy(v) for k, v in arrays.items()
          if k.startswith("tower_sd/")}
    x = t("tower_x")
    out["stem_bf16"] = sc.shallow_conv3x3(
        x.to(torch.bfloat16), weight, torch.bfloat16).float().numpy()
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        canonical = ResNet256_6_2_1(dtype=dt)
        canonical.load_state_dict(sd, strict=True)
        with torch.no_grad():
            out[f"canonical_train_z_{name}"] = canonical(x, train=True)[1] \
                .float().numpy()
        net = ResNet256_6_2_1(dtype=dt, pallas_stem=True)
        net.load_state_dict(sd, strict=True)
        with torch.no_grad():
            out[f"eval_z_{name}"] = net.eval()(x)[1].float().numpy()
            out[f"train_z_{name}"] = net(x, train=True)[1].float().numpy()
        out.update({f"train_bs_{name}/{k}": v.numpy()
                    for k, v in net.state_dict().items() if "running" in k})
    meta["same_keys"] = list(ResNet256_6_2_1().state_dict()) == list(
        ResNet256_6_2_1(pallas_stem=True).state_dict())
    read_calls()
    for key, net in (("tower_dx", ResNet256_6_2_1(pallas_stem=True)),
                     ("canonical_tower_dx", ResNet256_6_2_1())):
        net.load_state_dict(sd, strict=True)
        xg = x.clone().requires_grad_()
        z = net(xg)[1]
        out[key] = torch.autograd.grad((z * z).sum(), xg)[0].numpy()
        if key == "tower_dx":
            meta["tower_calls"] = read_calls()

    # ---- 3 train steps and a GradCache step ---------------------------------
    init = tree["init"]
    weights = ckpt.mi_weights_from_flax(
        init["params"], init["batch_stats"],
        [init["critic"][str(i)] for i in range(len(init["critic"]))],
        BERT["num_hidden_layers"])
    tcfg = TrainingConfig.production(compute_dtype="float32", **CFG)
    meta["config_reaches_stem"] = mi.build_joint_model(
        tcfg, BertConfig(**BERT), device="cpu").image_model.pallas_stem
    model = mi.build_joint_model(tcfg, BertConfig(**BERT), device="cpu")
    txs = mi.make_optimizers(tcfg, steps_per_epoch=STEPS_PER_EPOCH)
    state = mi.create_mi_state(model, tcfg, txs, None,
                               weights=copy.deepcopy(weights))
    step = mi.make_mi_train_step(model, txs, tcfg)
    batch = lambda n: {k: torch.from_numpy(v)
                       for k, v in tree[f"batch{n}"].items()}
    losses = []
    read_calls()
    for n in range(STEPS):
        state, loss = step(state, batch(n))
        losses.append(loss.item())
        if n in (0, STEPS - 1):      # copies: the statistics change in place
            out.update({k: v.copy() for k, v in _port_keyed(
                state, "first/" if n == 0 else "final/",
                running_only=True).items()})
    meta["train_calls"] = read_calls()
    out["losses"] = np.array(losses)
    gcfg = tcfg.replace(grad_cache_chunks=GC_CHUNKS)
    model = mi.build_joint_model(gcfg, BertConfig(**BERT), device="cpu")
    state = mi.create_mi_state(model, gcfg, txs, None,
                               weights=copy.deepcopy(weights))
    state, loss = mi.make_mi_train_step(model, txs, gcfg)(state, batch(0))
    meta["gc_calls"] = read_calls()
    out["gc_loss"] = loss.numpy()
    out.update(_port_keyed(state, "gc/", running_only=True))
    for k in calls:
        setattr(sc, k, real[k])

    # ---- remat on = off, float64, dropout 0.1 -------------------------------
    pcfg = TrainingConfig.parity(**CFG)
    start = mi.create_mi_state(
        ImageReportModel(BertConfig(**DROP_BERT), dtype=torch.float64,
                         pallas_stem=True).double(), pcfg,
        mi.make_optimizers(pcfg, STEPS_PER_EPOCH),
        torch.Generator().manual_seed(11))
    start_weights = {
        "image_model": copy.deepcopy(start.model.image_model.state_dict()),
        "text_model": copy.deepcopy(start.model.text_model.state_dict()),
        "critic": [{k: v.detach().clone() for k, v in layer.items()}
                   for layer in start.critic_params]}

    def two_steps(bert_kw):
        m = ImageReportModel(BertConfig(**bert_kw), dtype=torch.float64,
                             pallas_stem=True).double()
        ptxs = mi.make_optimizers(pcfg, STEPS_PER_EPOCH)
        st = mi.create_mi_state(m, pcfg, ptxs, None,
                                weights=copy.deepcopy(start_weights))
        pstep = mi.make_mi_train_step(m, ptxs, pcfg)
        got = []
        for n in range(2):
            b = batch(n)
            b["image"] = b["image"].double()
            st, l_n = pstep(st, b)
            got.append(l_n.item())
        return got, _port_keyed(st, "")

    (l_a, s_a), (l_b, s_b) = two_steps(DROP_BERT), two_steps(
        dict(DROP_BERT, remat=True))
    meta["remat"] = {"losses_equal": l_a == l_b,
                     "max_abs": max(float(np.abs(s_a[k] - s_b[k]).max())
                                    for k in s_a)}

    # ---- what the wrapper refuses -------------------------------------------
    x4 = torch.zeros(2, 8, 8, 1)
    w8 = torch.zeros(C, 1, 3, 3)
    meta["refused"] = {
        "c_in": _error_of(lambda: sc.shallow_conv3x3(
            x4, torch.zeros(C, 2, 3, 3), torch.float32)),
        "kernel_size": _error_of(lambda: sc.shallow_conv3x3(
            x4, torch.zeros(C, 1, 5, 5), torch.float32)),
        "dtype": _error_of(lambda: sc.shallow_conv3x3(
            x4.half(), w8, torch.float32)),
        "non_contiguous": _error_of(lambda: sc.shallow_conv3x3(
            torch.zeros(2, 8, 16, 1)[:, :, ::2], w8, torch.float32)),
        "s2d_and_pallas_stem": _error_of(lambda: ResNet256_6_2_1(
            s2d_stem=True, pallas_stem=True))}
    np.savez(os.path.join(job, "out.npz"), **out)
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    _child(sys.argv[1])
