"""The port's MI train step (mimm_tpu_torch/train/mi.py, models/joint.py,
ResNet train mode, checkpoint.mi_weights_from_flax) against JAX
``make_mi_train_step`` on the same weights and batches.

* The 12-step float64 trajectory of tests/test_reference_step_parity.py
  (B=5, SEQ=16, a 2-layer BERT, the full ResNet, dropout 0, the parity
  preset, four batches of which one carries a duplicate study id): the
  first train-mode forward's embeddings agree to rtol 1e-9 / atol 1e-10
  and the 12 per-step losses to rtol 1e-5 / atol 1e-6, the bounds JAX's
  own golden holds itself to (test_reference_step_parity.py:180-197).
  The final parameters, critic and BatchNorm statistics agree to atol
  1e-9: f64 rounding differences carried through 12 steps of Adam, whose
  m̂/√v̂ amplifies them where |g| is small (measured on the CPU: losses
  3.5e-12 apart, final state 5.6e-11).
* ResNet256_6_2_1 in train mode alone, float64: the embeddings of two
  consecutive train-mode forwards and every running statistic after them
  (flax's BIASED running variance) to rtol 1e-9 / atol 1e-10.
* One float32 production-preset step (bf16 moments, tanh GELU, u8
  dropout at rate 0, the critic's size switch) with the flash gate open
  (``flash_min_seq_len=0``): JAX's Pallas kernel in interpret mode
  against the port's flash autograd function.  The loss agrees to atol
  1e-5 (a difference of two order-1 terms in f32 after 2 layers and the
  full ResNet; measured 2.1e-7) and the updated BatchNorm statistics to
  rtol 1e-4 / atol 1e-5 (f32 convolutions in another summation order;
  measured 2.1e-6).

The JAX side runs in the pytest worker, the port side in a jax-free child
(tests/torch_port_child.py).
"""

import json
import os
import sys

import numpy as np
import pytest

B = 5
SEQ = 16
STEPS = 12
N_BATCHES = 4
VOCAB = 64
STEPS_PER_EPOCH = 20      # warmup 2 of 20 steps
BERT = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=32, num_classes=1,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
CFG = dict(batch_size=B, img_size=256, max_seq_length=SEQ,
           num_train_epochs=1, mi_estimator="dv", init_lr=1e-3,
           bert_lr=2e-5, seed=0)
FLASH_BERT = dict(BERT, flash_attention=True, flash_min_seq_len=0,
                  gelu_tanh=True, u8_dropout=True)
FINAL_ATOL = 1e-9


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for n in range(N_BATCHES):
        sids = np.arange(B, dtype=np.int64) + 10 * n
        if n == 2:
            sids[1] = sids[0]      # a same-study pair: excluded negatives
        out.append({
            "image": rng.random((B, 256, 256, 1)),
            "txt_ids": rng.integers(0, VOCAB, (B, SEQ)).astype(np.int32),
            "txt_masks": (np.arange(SEQ)[None] < rng.integers(
                4, SEQ + 1, (B, 1))).astype(np.int32),
            "txt_segments": (np.arange(SEQ)[None] >= 8).astype(np.int32)
            .repeat(B, 0),
            "study_id": sids})
    return out


def _torch_keyed(state, prefix, running_only=False, num_layers=None):
    """A JAX MI state in the reference torch layout, through the JAX
    package's own exporters: ``image_model.*`` / ``text_model.*`` state
    dict keys and ``critic.<i>.<w|b>``; ``num_layers``: the BERT's depth
    (this file's by default)."""
    import jax

    from mimm_tpu import checkpoint as ckpt

    params, bstats, critic = (jax.device_get(x) for x in (
        state.params, state.batch_stats, state.critic_params))
    sds = {"image_model": ckpt.resnet_state_dict_from_variables(
        {"params": params["image_model"],
         "batch_stats": bstats["image_model"]}),
        "text_model": ckpt.bert_state_dict_from_variables(
            {"params": params["text_model"]},
            num_layers or BERT["num_hidden_layers"])}
    out = {f"{prefix}{tower}.{k}": np.asarray(v)
           for tower, sd in sds.items() for k, v in sd.items()
           if not k.endswith("num_batches_tracked")
           and (not running_only or "running" in k)}
    if not running_only:
        for i, layer in enumerate(critic):
            for k in ("w", "b"):
                out[f"{prefix}critic.{i}.{k}"] = np.asarray(layer[k])
    return out


def _port_keyed(state, prefix, running_only=False):
    """The port's state under the keys of ``_torch_keyed``."""
    out = {f"{prefix}{k}": v.detach().numpy()
           for k, v in state.model.state_dict().items()
           if not k.endswith("num_batches_tracked")
           and (not running_only or "running" in k)}
    if not running_only:
        for i, layer in enumerate(state.critic_params):
            for k in ("w", "b"):
                out[f"{prefix}critic.{i}.{k}"] = layer[k].detach().numpy()
    return out


def _flat_state(params, batch_stats, critic, prefix):
    from tests.torch_port_child import flatten_tree

    out = flatten_tree({"params": params, "batch_stats": batch_stats},
                       prefix)
    for i, layer in enumerate(critic):
        for k in ("w", "b"):
            out[f"{prefix}critic/{i}/{k}"] = np.asarray(layer[k])
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from mimm_tpu import checkpoint as ckpt
    from mimm_tpu.config import TrainingConfig
    from mimm_tpu.models.bert import BertConfig
    from mimm_tpu.models.joint import ImageReportModel
    from mimm_tpu.models.resnet import ResNet256_6_2_1
    from mimm_tpu.train.mi import (MITrainState, create_mi_state,
                                   make_mi_train_step, make_optimizers)
    from tests.torch_port_child import run_child

    job = str(tmp_path_factory.mktemp("train"))
    batches = _batches()
    arrays = {f"batch{n}/{k}": v for n, b in enumerate(batches)
              for k, v in b.items()}
    want = {}

    # ---- float32 production step, flash gate open --------------------------
    cfg = TrainingConfig.production(compute_dtype="float32", **CFG)
    model = ImageReportModel(bert_config=BertConfig(**FLASH_BERT),
                             output_channels=1, dtype=jnp.float32)
    txs = make_optimizers(cfg, steps_per_epoch=STEPS_PER_EPOCH)
    state = create_mi_state(model, cfg, txs, jax.random.PRNGKey(0))
    init = jax.device_get(state)
    compact = dict(batches[0], image=(batches[0]["image"] * 255)
                   .astype(np.uint8),
                   txt_ids=batches[0]["txt_ids"].astype(np.uint16),
                   txt_masks=batches[0]["txt_masks"].astype(np.uint8),
                   txt_segments=batches[0]["txt_segments"].astype(np.uint8))
    arrays.update({f"compact/{k}": v for k, v in compact.items()})
    new_state, loss = make_mi_train_step(model, txs, cfg)(
        state, {k: jnp.asarray(v) for k, v in compact.items()})
    want["f32_loss"] = np.asarray(loss)
    want.update(_torch_keyed(new_state, "f32_bs/", running_only=True))
    arrays.update(_flat_state(init.params, init.batch_stats,
                              init.critic_params, "f32_init/"))

    # ---- bfloat16 eval BatchNorm (queue C, PR 2) ----------------------------
    rng = np.random.default_rng(5)
    ev = {"params": init.params["image_model"], "batch_stats": jax.tree.map(
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32),
        init.batch_stats["image_model"])}
    arrays.update(_flat_state(ev["params"], ev["batch_stats"], [], "bf16/"))
    want["bf16_eval_z"] = np.asarray(ResNet256_6_2_1(dtype=jnp.bfloat16).apply(
        ev, jnp.asarray(batches[0]["image"], jnp.float32), train=False)[1]) \
        .astype(np.float32)

    with jax.enable_x64(True):
        cfg = TrainingConfig.parity(**CFG)
        model = ImageReportModel(bert_config=BertConfig(**BERT),
                                 output_channels=1, dtype=jnp.float64)
        txs = make_optimizers(cfg, steps_per_epoch=STEPS_PER_EPOCH)
        state = create_mi_state(model, cfg, txs, jax.random.PRNGKey(0))
        up = lambda t: jax.tree.map(
            lambda x: x.astype(jnp.float64)
            if hasattr(x, "dtype") and x.dtype == jnp.float32 else x, t)
        params, bstats, critic = (up(jax.device_get(x)) for x in (
            state.params, state.batch_stats, state.critic_params))
        state = MITrainState(
            params=params, batch_stats=bstats, critic_params=critic,
            img_opt=txs.img.init(params["image_model"]),
            mi_opt=txs.mi.init(critic),
            txt_opt=txs.txt.init(params["text_model"]), step=state.step)
        arrays.update(_flat_state(params, bstats, critic, "init/"))
        wide = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]

        # ---- first train-mode forward, and the ResNet alone --------------
        outs, _ = model.apply(
            {"params": params, "batch_stats": bstats},
            wide[0]["image"], wide[0]["txt_ids"], wide[0]["txt_masks"],
            wide[0]["txt_segments"], train=True,
            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        want["emb_img"], want["emb_txt"] = np.asarray(outs[0]), \
            np.asarray(outs[1])
        resnet = ResNet256_6_2_1(output_channels=1, dtype=jnp.float64)
        rv = {"params": params["image_model"],
              "batch_stats": bstats["image_model"]}
        for n in range(2):
            res, mutated = resnet.apply(rv, wide[n]["image"], train=True,
                                        mutable=["batch_stats"])
            rv = {"params": rv["params"],
                  "batch_stats": mutated["batch_stats"]}
            want[f"resnet_z{n}"] = np.asarray(res[1])
        want.update({f"resnet_bs/{k}": np.asarray(v) for k, v in
                     ckpt.resnet_state_dict_from_variables(
                         jax.device_get(rv)).items() if "running" in k})

        # ---- the 12-step trajectory --------------------------------------
        step = make_mi_train_step(model, txs, cfg)
        losses = []
        for s in range(STEPS):
            state, loss = step(state, wide[s % N_BATCHES])
            losses.append(float(loss))
        want["losses"] = np.array(losses)
        want.update(_torch_keyed(state, "final/"))

    np.savez(os.path.join(job, "in.npz"), **arrays)
    got, meta = run_child(__file__, job, timeout=420)
    return {k: np.asarray(v) for k, v in want.items()}, got, meta


def test_first_forward_embeddings_match_jax(results):
    want, got, _ = results
    for key in ("emb_img", "emb_txt"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9,
                                   atol=1e-10, err_msg=key)


@pytest.mark.parametrize("n", [0, 1])
def test_resnet_train_mode_embeddings_match_jax(results, n):
    want, got, _ = results
    np.testing.assert_allclose(got[f"resnet_z{n}"], want[f"resnet_z{n}"],
                               rtol=1e-9, atol=1e-10)


def test_resnet_running_statistics_match_jax(results):
    """Every BatchNorm running mean and (biased) variance after two
    train-mode forwards."""
    want, got, _ = results
    keys = [k for k in want if k.startswith("resnet_bs/")]
    assert len(keys) == 2 * 31          # 31 BatchNorms in ResNet256_6_2_1
    assert set(keys) <= set(got)
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9,
                                   atol=1e-10, err_msg=key)


def test_resnet_bf16_eval_norm_matches_jax(results):
    """bfloat16 eval BatchNorm runs its arithmetic in float32 and casts, as
    flax's does (its float32 statistics promote the input).  Rounding in
    bf16 instead, as the port did before, gives 4.7x the mean error and
    twice the largest (0.023 and 0.25 against 0.0049 and 0.0625, |z| up to
    16, whose bf16 ulp is 0.125)."""
    want, got, _ = results
    err = np.abs(got["bf16_eval_z"] - want["bf16_eval_z"])
    assert err.mean() <= 0.01 and err.max() <= 0.125, (err.mean(), err.max())


def test_trajectory_losses_match_jax(results):
    want, got, _ = results
    assert got["losses"].shape == (STEPS,)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("group", ["image_model", "text_model", "critic"])
def test_final_state_matches_jax(results, group):
    """Parameters, critic and BatchNorm running statistics after 12 steps."""
    want, got, _ = results
    keys = [k for k in want if k.startswith(f"final/{group}.")]
    assert keys and set(keys) <= set(got)
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=FINAL_ATOL, err_msg=key)


def test_production_f32_flash_step_matches_jax(results):
    want, got, meta = results
    np.testing.assert_allclose(got["f32_loss"], want["f32_loss"], rtol=0,
                               atol=1e-5)
    keys = [k for k in want if k.startswith("f32_bs/")]
    assert keys and set(keys) <= set(got)
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-5,
                                   err_msg=key)
    # the flash gate was open: one forward and one backward per layer
    assert meta["flash_calls"] == {"forward": BERT["num_hidden_layers"],
                                   "backward": BERT["num_hidden_layers"]}


def test_unported_knobs_raise(results):
    """Knobs of later slices raise; ``s2d_stem`` with ``pallas_stem`` raises
    JAX's ValueError (mimm_tpu/models/resnet.py:246-247)."""
    meta = results[2]
    for knob in ("zero1_optimizer_sharding", "mesh"):
        assert meta["raises"][knob].startswith("NotImplementedError"), knob
    assert meta["raises"]["s2d_and_pallas_stem"] == \
        "ValueError: s2d_stem and pallas_stem are exclusive"


def test_checkpoints_reload_strict(results):
    meta = results[2]
    assert meta["saved"] == ["config.json", "pytorch_MI_image_model.bin",
                             "pytorch_MI_text_model.bin",
                             "pytorch_model_epoch1.bin"]
    assert meta["reload_equal"] is True


def _error_of(fn):
    try:
        fn()
    except Exception as e:  # the test reads the exception's type
        return f"{type(e).__name__}: {e}"
    return "no error"


def _child(job):
    import copy

    import torch

    from mimm_tpu_torch import checkpoint as ckpt
    from mimm_tpu_torch.config import TrainingConfig
    from mimm_tpu_torch.models import bert as bert_mod
    from mimm_tpu_torch.models.bert import BertConfig
    from mimm_tpu_torch.models.joint import ImageReportModel
    from mimm_tpu_torch.ops import flash_attention as fa
    from mimm_tpu_torch.train import mi
    from tests.torch_port_child import unflatten_tree

    # torch's CPU oneDNN float32 convolution backward has corrupted the
    # heap in this project's CPU builds; its reference convolutions do not
    torch.backends.mkldnn.enabled = False
    with np.load(os.path.join(job, "in.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    tree = unflatten_tree(arrays)
    out, meta = {}, {}

    def weights(node):
        n = len(node["critic"])
        return ckpt.mi_weights_from_flax(
            node["params"], node["batch_stats"],
            [node["critic"][str(i)] for i in range(n)],
            BERT["num_hidden_layers"])

    def batch(n, dtype=torch.float64):
        b = {k: torch.from_numpy(v) for k, v in tree[f"batch{n}"].items()}
        b["image"] = b["image"].to(dtype)
        return b

    # ---- float32 production step, flash gate open --------------------------
    cfg = TrainingConfig.production(compute_dtype="float32", **CFG)
    model = mi.build_joint_model(cfg, BertConfig(**FLASH_BERT), device="cpu")
    txs = mi.make_optimizers(cfg, steps_per_epoch=STEPS_PER_EPOCH)
    state = mi.create_mi_state(model, cfg, txs, None,
                               weights=weights(tree["f32_init"]))
    calls = {"forward": 0, "backward": 0}
    real_flash, real_bwd = bert_mod.flash_attention, fa.flash_attention_bwd

    def counting_flash(*a, **kw):
        calls["forward"] += 1
        return real_flash(*a, **kw)

    def counting_bwd(*a, **kw):
        calls["backward"] += 1
        return real_bwd(*a, **kw)

    bert_mod.flash_attention, fa.flash_attention_bwd = counting_flash, \
        counting_bwd
    compact = {k: torch.from_numpy(v) for k, v in tree["compact"].items()}
    state, loss = mi.make_mi_train_step(model, txs, cfg)(state, compact)
    bert_mod.flash_attention, fa.flash_attention_bwd = real_flash, real_bwd
    meta["flash_calls"] = calls
    out["f32_loss"] = loss.numpy()
    out.update(_port_keyed(state, "f32_bs/", running_only=True))

    # ---- bfloat16 eval BatchNorm ---------------------------------------------
    from mimm_tpu_torch.models.resnet import ResNet256_6_2_1

    bf16 = ResNet256_6_2_1(dtype=torch.bfloat16).eval()
    bf16.load_state_dict(ckpt.resnet_state_dict_from_flax(tree["bf16"]),
                         strict=True)
    with torch.no_grad():
        out["bf16_eval_z"] = bf16(batch(0, torch.float32)["image"])[1] \
            .float().numpy()

    # ---- float64: forward golden, ResNet alone, trajectory -----------------
    cfg = TrainingConfig.parity(**CFG)
    model = ImageReportModel(BertConfig(**BERT), output_channels=1,
                             dtype=torch.float64).double()
    txs = mi.make_optimizers(cfg, steps_per_epoch=STEPS_PER_EPOCH)
    state = mi.create_mi_state(model, cfg, txs, None,
                               weights=weights(tree["init"]))
    b0 = batch(0)
    golden = copy.deepcopy(model)
    emb = golden(b0["image"], b0["txt_ids"], b0["txt_masks"],
                 b0["txt_segments"], train=True)
    out["emb_img"], out["emb_txt"] = (t.detach().numpy() for t in emb[:2])
    resnet = copy.deepcopy(model.image_model)
    with torch.no_grad():
        for n in range(2):
            out[f"resnet_z{n}"] = resnet(batch(n)["image"], train=True)[1] \
                .numpy()
    out.update({f"resnet_bs/{k}": v.numpy()
                for k, v in resnet.state_dict().items() if "running" in k})

    step = mi.make_mi_train_step(model, txs, cfg)
    losses = []
    for s in range(STEPS):
        state, loss = step(state, batch(s % N_BATCHES))
        losses.append(loss.item())
    out["losses"] = np.array(losses)
    out.update(_port_keyed(state, "final/"))

    meta["raises"] = {
        "zero1_optimizer_sharding": _error_of(lambda: mi.make_mi_train_step(
            model, txs, cfg.replace(zero1_optimizer_sharding=True))),
        "mesh": _error_of(lambda: mi.make_mi_train_step(model, txs, cfg,
                                                        mesh=object())),
        "s2d_and_pallas_stem": _error_of(lambda: mi.build_joint_model(
            cfg.replace(s2d_stem=True, pallas_stem=True), BertConfig(**BERT),
            device="cpu")),
    }
    save = os.path.join(job, "save")
    mi.save_mi_checkpoints(save, state, 1, BertConfig(**BERT))
    meta["saved"] = sorted(os.listdir(save))
    fresh = ImageReportModel(BertConfig(**BERT)).double()
    fresh.load_state_dict(ckpt.load_state_dict_bin(
        os.path.join(save, "pytorch_model_epoch1.bin")), strict=True)
    fresh.image_model.load_state_dict(ckpt.load_state_dict_bin(
        os.path.join(save, "pytorch_MI_image_model.bin")), strict=True)
    fresh.text_model.load_state_dict(ckpt.load_state_dict_bin(
        os.path.join(save, "pytorch_MI_text_model.bin")), strict=True)
    meta["reload_equal"] = all(
        torch.equal(a, b) for a, b in zip(fresh.state_dict().values(),
                                          model.state_dict().values()))
    np.savez(os.path.join(job, "out.npz"), **out)
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    _child(sys.argv[1])
