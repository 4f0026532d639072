"""The port's GradCache step (mimm_tpu_torch/train/mi.py ``grad_cache_body``,
``cfg.grad_cache_chunks``) and BERT remat (``BertConfig.remat``).

* Against JAX ``make_mi_train_step`` with ``grad_cache_chunks=4``: two
  float64 steps at dropout 0, B=8 in 4 chunks, the tiny 1-layer BERT of
  tests/test_grad_cache.py:22-24, the full ResNet at 256² (the port's fc1
  reads the 2x2 pooled map of a 256² image), the parity preset (so the
  factorized critic path, as in JAX), one batch with a duplicate study id.
  Losses to rtol 1e-9 / atol 1e-10; the final parameters, critic and
  BatchNorm running statistics (the mean of the chunks' updates) to atol
  1e-9, the bound tests/test_torch_train.py holds its 12-step trajectory
  to.
* Against the port's own direct autograd through the same chunked
  forward (the counterpart of tests/test_grad_cache.py:46-120): float64,
  dropout 0.1, the flash gate open (``flash_min_seq_len=0``), GradCache
  with remat against the oracle without, B=4 in 2 chunks, two steps.
  Losses and final state to 1e-10: the two differ only in the order in
  which a parameter's gradient sums its chunks.
* ``grad_cache_chunks`` of 1, and of 3 (which does not divide 4: a
  warning, then the direct body), give the direct step's losses and state
  exactly over two steps; so does the direct step with remat at dropout
  0.1.  Two steps, because the text tower's first AdamW update is 0 (the
  warmup), so a wrong text gradient shows only in the second.

The JAX side runs in the pytest worker, the port side in a jax-free child
(tests/torch_port_child.py).
"""

import json
import os
import sys

import numpy as np
import pytest

SEQ = 16
VOCAB = 64
STEPS = 2
STEPS_PER_EPOCH = 20
TINY_BERT = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=1,
                 num_attention_heads=2, intermediate_size=64,
                 max_position_embeddings=32, num_classes=1,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
# the port-only arms: dropout on, the flash path (plain on the CPU) on
DROP_BERT = dict(TINY_BERT, hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1, flash_attention=True,
                 flash_min_seq_len=0)
CFG = dict(img_size=256, max_seq_length=SEQ, num_train_epochs=1,
           mi_estimator="dv", init_lr=1e-3, bert_lr=2e-5, seed=0)
JAX_B, JAX_CHUNKS = 8, 4
PORT_B, PORT_CHUNKS = 4, 2
FINAL_ATOL = 1e-9
GROUPS = ("image_model", "text_model", "critic")


def _batches(b):
    rng = np.random.default_rng(b)
    out = []
    for n in range(STEPS):
        sids = np.arange(b, dtype=np.int64) + 10 * n
        if n == 1:
            sids[2] = sids[0]      # a same-study pair: excluded negatives
        out.append({
            "image": rng.random((b, 256, 256, 1)),
            "txt_ids": rng.integers(0, VOCAB, (b, SEQ)).astype(np.int32),
            "txt_masks": (np.arange(SEQ)[None] < rng.integers(
                4, SEQ + 1, (b, 1))).astype(np.int32),
            "txt_segments": (np.arange(SEQ)[None] >= 8).astype(np.int32)
            .repeat(b, 0),
            "study_id": sids})
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from mimm_tpu import checkpoint as ckpt
    from mimm_tpu.config import TrainingConfig
    from mimm_tpu.models.bert import BertConfig
    from mimm_tpu.models.joint import ImageReportModel
    from mimm_tpu.train.mi import (MITrainState, create_mi_state,
                                   make_mi_train_step, make_optimizers)
    from tests.torch_port_child import flatten_tree, run_child

    job = str(tmp_path_factory.mktemp("grad_cache"))
    arrays, want = {}, {}
    for b in (JAX_B, PORT_B):
        arrays.update({f"b{b}/batch{n}/{k}": v
                       for n, batch in enumerate(_batches(b))
                       for k, v in batch.items()})
    with jax.enable_x64(True):
        cfg = TrainingConfig.parity(batch_size=JAX_B,
                                    grad_cache_chunks=JAX_CHUNKS, **CFG)
        model = ImageReportModel(bert_config=BertConfig(**TINY_BERT),
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
        arrays.update(flatten_tree({"params": params, "batch_stats": bstats},
                                   "init/"))
        for i, layer in enumerate(critic):
            for k in ("w", "b"):
                arrays[f"init/critic/{i}/{k}"] = np.asarray(layer[k])
        step = make_mi_train_step(model, txs, cfg)
        losses = []
        for batch in _batches(JAX_B):
            state, loss = step(state, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
            losses.append(float(loss))
        want["losses"] = np.array(losses)
        params, bstats, critic = (jax.device_get(x) for x in (
            state.params, state.batch_stats, state.critic_params))
        sds = {"image_model": ckpt.resnet_state_dict_from_variables(
            {"params": params["image_model"],
             "batch_stats": bstats["image_model"]}),
            "text_model": ckpt.bert_state_dict_from_variables(
                {"params": params["text_model"]},
                TINY_BERT["num_hidden_layers"])}
        want.update({f"final/{tower}.{k}": np.asarray(v)
                     for tower, sd in sds.items() for k, v in sd.items()
                     if not k.endswith("num_batches_tracked")})
        for i, layer in enumerate(critic):
            for k in ("w", "b"):
                want[f"final/critic.{i}.{k}"] = np.asarray(layer[k])
    np.savez(os.path.join(job, "in.npz"), **arrays)
    got, meta = run_child(__file__, job, timeout=600)
    return {k: np.asarray(v) for k, v in want.items()}, got, meta


def test_grad_cache_losses_match_jax(results):
    want, got, _ = results
    assert got["losses"].shape == (STEPS,)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-9,
                               atol=1e-10)


@pytest.mark.parametrize("group", GROUPS)
def test_grad_cache_final_state_matches_jax(results, group):
    """Parameters, critic and the BatchNorm running statistics (each step
    the mean of the four chunks' updates) after two GradCache steps."""
    want, got, _ = results
    keys = [k for k in want if k.startswith(f"final/{group}.")]
    assert keys and set(keys) <= set(got)
    if group == "image_model":
        assert any("running_var" in k for k in keys)
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=FINAL_ATOL, err_msg=key)


def test_grad_cache_matches_direct_autograd_oracle(results):
    """GradCache with remat against one backward through the same chunked
    forward without remat: dropout 0.1 and the flash path, two steps."""
    _, got, meta = results
    np.testing.assert_allclose(got["gc_losses"], got["oracle_losses"],
                               rtol=0, atol=1e-10)
    assert meta["gc_vs_oracle_max_abs"] <= 1e-10
    # the masks were drawn: dropout changed the loss
    assert abs(got["gc_losses"][0] - got["direct_nodrop_loss"][0]) > 1e-6


@pytest.mark.parametrize("arm", ["chunks1", "chunks3_fallback",
                                 "remat_direct"])
def test_arms_equal_the_direct_step(results, arm):
    """``grad_cache_chunks`` of 1 and 3 (3 does not divide the batch of 4)
    take the direct body; remat on equals remat off at dropout 0.1."""
    _, got, meta = results
    np.testing.assert_array_equal(got[f"{arm}_loss"], got["direct_loss"])
    assert meta[f"{arm}_max_abs"] == 0.0
    if arm == "chunks3_fallback":
        assert "does not divide batch 4" in meta["fallback_warning"]


def test_grad_cache_port_launches_no_kernel_on_cpu(results):
    assert results[2]["launches"] == {}


def _child(job):
    import copy
    import logging

    import torch

    from mimm_tpu_torch import checkpoint as ckpt
    from mimm_tpu_torch.config import TrainingConfig
    from mimm_tpu_torch.models.bert import BertConfig
    from mimm_tpu_torch.models.joint import ImageReportModel
    from mimm_tpu_torch.objectives.critics import bound_from_scores
    from mimm_tpu_torch.objectives.pairing import pairwise_critic_scores
    from mimm_tpu_torch.ops import flash_attention as fa
    from mimm_tpu_torch.ops import pairwise_critic as pc
    from mimm_tpu_torch.train import mi
    from mimm_tpu_torch.train.optim import apply_updates
    from tests.torch_port_child import unflatten_tree

    torch.backends.mkldnn.enabled = False
    with np.load(os.path.join(job, "in.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    tree = unflatten_tree(arrays)
    init = tree["init"]
    weights = ckpt.mi_weights_from_flax(
        init["params"], init["batch_stats"],
        [init["critic"][str(i)] for i in range(len(init["critic"]))],
        TINY_BERT["num_hidden_layers"])
    out, meta = {}, {}
    fa.reset_launch_counts()
    pc.reset_launch_counts()

    def batches(b):
        return [{k: torch.from_numpy(v) for k, v in tree[f"b{b}"][
            f"batch{n}"].items()} for n in range(STEPS)]

    def fresh(bert_kw, **cfg_kw):
        cfg = TrainingConfig.parity(**CFG, **cfg_kw)
        model = ImageReportModel(BertConfig(**bert_kw), output_channels=1,
                                 dtype=torch.float64).double()
        txs = mi.make_optimizers(cfg, steps_per_epoch=STEPS_PER_EPOCH)
        state = mi.create_mi_state(model, cfg, txs, None,
                                   weights=copy.deepcopy(weights))
        return model, txs, cfg, state

    def flat(state):
        d = {k: v.detach().clone() for k, v in
             state.model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
        for i, layer in enumerate(state.critic_params):
            for k in ("w", "b"):
                d[f"critic.{i}.{k}"] = layer[k].detach().clone()
        return d

    def max_abs(a, b):
        return max((a[k] - b[k]).abs().max().item() for k in a)

    # ---- against JAX: 4 chunks of 2, dropout 0 --------------------------
    model, txs, cfg, state = fresh(TINY_BERT, batch_size=JAX_B,
                                   grad_cache_chunks=JAX_CHUNKS)
    step = mi.make_mi_train_step(model, txs, cfg)
    losses = []
    for batch in batches(JAX_B):
        state, loss = step(state, batch)
        losses.append(loss.item())
    out["losses"] = np.array(losses)
    out.update({f"final/{k}": v.numpy() for k, v in flat(state).items()})

    # ---- the port's own arms: dropout 0.1, the flash path ---------------
    def oracle_step(model, txs, cfg, state, batch, n):
        """One backward through the chunked forward: chunk c draws from
        chunk_generator(seed, step, c) and starts from the step's running
        statistics, which end as the chunks' mean."""
        size = batch["image"].shape[0] // n
        stats = list(state.batch_stats.values())
        start = [t.clone() for t in stats]
        total = [torch.zeros_like(t) for t in stats]
        embs = []
        for c in range(n):
            part = {k: v[c * size:(c + 1) * size] for k, v in batch.items()}
            for t, s in zip(stats, start):
                t.copy_(s)
            e = model(part["image"], part["txt_ids"], part["txt_masks"],
                      part["txt_segments"], train=True,
                      generator=mi.chunk_generator(cfg.seed, state.step, c,
                                                   "cpu"))
            embs.append(e[:2])
            for a, t in zip(total, stats):
                a.add_(t)
        for t, a in zip(stats, total):
            t.copy_(a / n)
        loss = bound_from_scores("dv", pairwise_critic_scores(
            state.critic_params, torch.cat([e[0] for e in embs]),
            torch.cat([e[1] for e in embs])), batch["study_id"])
        groups = [dict(model.image_model.named_parameters()),
                  dict(model.text_model.named_parameters()),
                  mi.critic_dict(state.critic_params)]
        names = [(gi, k) for gi, g in enumerate(groups) for k in g]
        tensors = [groups[gi][k] for gi, k in names]
        grads = [{}, {}, {}]
        for (gi, k), t, g in zip(names, tensors, torch.autograd.grad(
                loss, tensors, allow_unused=True)):
            grads[gi][k] = torch.zeros_like(t) if g is None else g
        upd, state.img_opt = txs.img.update(grads[0], state.img_opt, groups[0])
        apply_updates(groups[0], upd)
        upd, state.txt_opt = txs.txt.update(grads[1], state.txt_opt, groups[1])
        apply_updates(groups[1], upd)
        upd, state.mi_opt = txs.mi.update(grads[2], state.mi_opt, groups[2])
        apply_updates(groups[2], upd)
        state.step += 1
        return state, loss.detach()

    port_batches = batches(PORT_B)
    model, txs, cfg, state = fresh(dict(DROP_BERT, remat=True),
                                   batch_size=PORT_B,
                                   grad_cache_chunks=PORT_CHUNKS)
    step = mi.make_mi_train_step(model, txs, cfg)
    gc_losses = []
    for batch in port_batches:
        state, loss = step(state, batch)
        gc_losses.append(loss.item())
    gc_state = flat(state)
    model, txs, cfg, state = fresh(DROP_BERT, batch_size=PORT_B,
                                   grad_cache_chunks=PORT_CHUNKS)
    oracle_losses = []
    for batch in port_batches:
        state, loss = oracle_step(model, txs, cfg, state, batch, PORT_CHUNKS)
        oracle_losses.append(loss.item())
    out["gc_losses"], out["oracle_losses"] = np.array(gc_losses), \
        np.array(oracle_losses)
    meta["gc_vs_oracle_max_abs"] = max_abs(gc_state, flat(state))

    # ---- the direct step, and the arms that must equal it ---------------
    def two_steps(bert_kw, **cfg_kw):
        """Losses and final state; the text tower's first AdamW update is
        0 (warmup), so its gradients show only in the second step."""
        model, txs, cfg, state = fresh(bert_kw, batch_size=PORT_B, **cfg_kw)
        step = mi.make_mi_train_step(model, txs, cfg)
        losses = []
        for batch in port_batches:
            state, loss = step(state, batch)
            losses.append(loss.item())
        return np.array(losses), flat(state)

    out["direct_loss"], direct = two_steps(DROP_BERT)
    out["direct_nodrop_loss"], _ = two_steps(TINY_BERT)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger(mi.__name__).addHandler(handler)
    for arm, bert_kw, kw in (
            ("chunks1", DROP_BERT, dict(grad_cache_chunks=1)),
            ("chunks3_fallback", DROP_BERT, dict(grad_cache_chunks=3)),
            ("remat_direct", dict(DROP_BERT, remat=True), {})):
        out[f"{arm}_loss"], final = two_steps(bert_kw, **kw)
        meta[f"{arm}_max_abs"] = max_abs(final, direct)
    meta["fallback_warning"] = " ".join(r.getMessage() for r in records)
    meta["launches"] = {**fa.LAUNCHES, **pc.LAUNCHES}
    np.savez(os.path.join(job, "out.npz"), **out)
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    _child(sys.argv[1])
