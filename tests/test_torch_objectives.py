"""The port's MI objective and optimizers (mimm_tpu_torch/objectives/*,
ops/pairwise_critic.py, train/optim.py) against the JAX package's, on the
same numpy inputs.

* Critics, pairing and the critic's dispatch in float64 (the two sides
  then differ only in summation order): rtol 1e-10 / atol 1e-12; the
  matrix-form loss also equals the reference's pair loop
  (``brute_force_pair_logits``) with a duplicate study id.
* Ten optimizer steps of the same random gradients against optax /
  mimm_tpu.train.optim in float32: ``adam_torch`` (float32 and bfloat16
  moments), ``adamw_hf`` with ``bert_decay_mask`` under the warmup-linear
  schedule (float32 and bfloat16 moments), ``freeze`` with the trainable
  masks, and the schedule's values.  Parameters agree to rtol 1e-6 / atol
  1e-7 with float32 moments; with bfloat16 moments a moment may round to
  the neighbouring bf16 value (2^-8 relative) where the two sides' f32
  values straddle a rounding boundary, so atol 2e-5 at lr 1e-3.

The JAX side runs in the pytest worker, the port side in a jax-free child
(tests/torch_port_child.py).
"""

import json
import os
import sys

import numpy as np
import pytest

NB, DE = 6, 24                    # batch, embedding width per tower
CRITIC = [32, 16]
SIDS = np.array([3, 5, 3, 8, 9, 11], np.int64)   # rows 0 and 2 share a study
ESTIMATORS = ("dv", "infonce", "infonce_per_anchor")
STEPS = 10
# port parameter name -> (JAX tree path, shape); names decide the decay
# mask and the freezes on both sides
PARAMS = {
    "bert.encoder.layer.0.attention.self.query.weight":
        (("bert", "layer0", "attention", "query", "kernel"), (6, 6)),
    "bert.encoder.layer.0.attention.self.query.bias":
        (("bert", "layer0", "attention", "query", "bias"), (6,)),
    "bert.embeddings.LayerNorm.weight":
        (("bert", "embeddings_layernorm", "scale"), (6,)),
    "bert.embeddings.word_embeddings.weight":
        (("bert", "word_embeddings", "embedding"), (10, 6)),
    "classifier.weight": (("classifier", "kernel"), (6, 1)),
    "classifier.bias": (("classifier", "bias"), (1,)),
}
IMAGE_PARAMS = {"layer1.0.conv1.weight": (("layer1_block0", "conv1",
                                           "kernel"), (3, 3, 2, 4)),
                "layer6.1.bn2.bias": (("layer6_block1", "bn2", "bias"), (4,)),
                "fc1.weight": (("fc1", "kernel"), (8, 1))}
# case -> (param set, optimizer), built alike on both sides
CASES = ("adam_f32", "adam_bf16", "adamw_f32", "adamw_bf16",
         "freeze_text", "freeze_image")
SCHEDULE = dict(base_lr=1e-3, warmup_steps=3.0, t_total=STEPS)


def _nest(flat_paths, arrays):
    tree = {}
    for path, a in zip(flat_paths, arrays):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = a
    return tree


def _case_params(case):
    return IMAGE_PARAMS if case == "freeze_image" else PARAMS


def _optim_inputs():
    rng = np.random.default_rng(1)
    out = {}
    for case in CASES:
        for n, (_, shape) in _case_params(case).items():
            out[f"{case}/p/{n}"] = rng.standard_normal(shape).astype(np.float32)
            out[f"{case}/g/{n}"] = rng.standard_normal(
                (STEPS,) + shape).astype(np.float32)
    return out


def _jax_optimizers():
    import jax.numpy as jnp

    from mimm_tpu.train.optim import (adam_torch, adamw_hf, bert_decay_mask,
                                      bert_trainable_mask, freeze,
                                      resnet_trainable_mask,
                                      warmup_linear_schedule)
    sched = warmup_linear_schedule(**SCHEDULE)
    adamw = lambda md: adamw_hf(sched, eps=1e-6, weight_decay=0.1,
                                correct_bias=False, mask=bert_decay_mask,
                                moment_dtype=md)
    return {"adam_f32": adam_torch(1e-3),
            "adam_bf16": adam_torch(1e-3, moment_dtype=jnp.bfloat16),
            "adamw_f32": adamw(None), "adamw_bf16": adamw(jnp.bfloat16),
            "freeze_text": freeze(adamw(None), bert_trainable_mask),
            "freeze_image": freeze(adam_torch(1e-3), resnet_trainable_mask)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import optax

    from mimm_tpu.models.mlp import make_mlp
    from mimm_tpu.objectives import critics, pairing
    from mimm_tpu.ops.pairwise_critic import pairwise_critic_scores_pallas
    from mimm_tpu.train.optim import warmup_linear_schedule
    from tests.torch_port_child import run_child

    job = str(tmp_path_factory.mktemp("objectives"))
    rng = np.random.default_rng(0)
    arrays, want = {}, {}
    with jax.enable_x64(True):
        scores = rng.standard_normal((NB, NB))
        logits = rng.standard_normal(20)
        ei = rng.standard_normal((NB, DE))
        et = rng.standard_normal((NB, DE))
        critic = jax.tree.map(lambda x: np.asarray(x, np.float64), jax.device_get(
            make_mlp(jax.random.PRNGKey(0), 2 * DE, CRITIC)))
        arrays.update(scores=scores, logits=logits, ei=ei, et=et)
        for i, layer in enumerate(critic):
            arrays[f"critic/{i}/w"], arrays[f"critic/{i}/b"] = \
                layer["w"], layer["b"]
        s, sid = jnp.asarray(scores), jnp.asarray(SIDS)
        want["mask"] = critics.negative_pair_mask(sid)
        want["dv_scores"] = critics.dv_bound_from_scores(s, sid)
        want["infonce_scores"] = critics.infonce_bound_from_scores(s, sid)
        want["per_anchor"] = critics.infonce_per_anchor(s, sid)
        want["dv_vector"] = critics.dv_bound_loss(jnp.asarray(logits), 7)
        want["infonce_vector"] = critics.infonce_bound_loss(
            jnp.asarray(logits), 7)
        cp = jax.tree.map(jnp.asarray, critic)
        want["pair_scores"] = pairing.pairwise_critic_scores(
            cp, jnp.asarray(ei), jnp.asarray(et))
        want["pallas_dispatch"] = pairwise_critic_scores_pallas(
            cp, jnp.asarray(ei), jnp.asarray(et))
        want["brute"] = pairing.brute_force_pair_logits(
            cp, jnp.asarray(ei), jnp.asarray(et), SIDS)
        for est in ESTIMATORS:
            want[f"mi_{est}"] = pairing.mi_loss_from_embeddings(
                cp, jnp.asarray(ei), jnp.asarray(et), sid, estimator=est)

    # ---- optimizers (float32) ----------------------------------------------
    opt_in = _optim_inputs()
    arrays.update(opt_in)
    for case, tx in _jax_optimizers().items():
        spec = _case_params(case)
        paths = [spec[n][0] for n in spec]
        params = _nest(paths, [jnp.asarray(opt_in[f"{case}/p/{n}"])
                               for n in spec])
        state = tx.init(params)
        for t in range(STEPS):
            grads = _nest(paths, [jnp.asarray(opt_in[f"{case}/g/{n}"][t])
                                  for n in spec])
            upd, state = tx.update(grads, state, params)
            params = optax.apply_updates(params, upd)
        for n, (path, _) in spec.items():
            node = params
            for p in path:
                node = node[p]
            want[f"opt/{case}/{n}"] = node
    sched = warmup_linear_schedule(**SCHEDULE)
    want["schedule"] = np.array([sched(c) for c in range(STEPS + 1)])

    np.savez(os.path.join(job, "in.npz"), **arrays)
    got, meta = run_child(__file__, job)
    return {k: np.asarray(v) for k, v in want.items()}, got, meta


@pytest.mark.parametrize("key", ["mask", "dv_scores", "infonce_scores",
                                 "per_anchor", "dv_vector", "infonce_vector"])
def test_critics_match_jax(results, key):
    want, got, _ = results
    np.testing.assert_allclose(got[key], want[key], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("key", ["pair_scores", "pallas_dispatch", "brute",
                                 *(f"mi_{e}" for e in ESTIMATORS)])
def test_pairing_matches_jax(results, key):
    want, got, _ = results
    np.testing.assert_allclose(got[key], want[key], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("estimator", ["dv", "infonce"])
def test_matrix_loss_equals_reference_pair_loop(results, estimator):
    """The (B, B) masked loss equals the vector loss over the reference's
    enumerated pairs (positives first), with a duplicate study id."""
    _, got, _ = results
    np.testing.assert_allclose(got[f"mi_{estimator}"],
                               got[f"brute_{estimator}"], rtol=1e-10,
                               atol=1e-12)


def test_critic_dispatch_raises_past_the_switch(results):
    """Past JAX's 8 GiB switch the dispatch selects the kernels (raising
    only where JAX does): at H1 = 1024 the factorized path takes 1448²
    pairs (8,588 MB) and the kernels 1449², ``force_kernel`` always
    selects them (the plain versions on the CPU, equal to the factorized
    path), a 2-layer critic with ``force_kernel`` raises ValueError, and
    ``axis_name`` raises until the parallel slice."""
    meta = results[2]
    assert meta["switch"] == {"1448": False, "1449": True, "forced": True}
    assert meta["force_kernel"] == "no error"
    assert meta["force_kernel_err"] <= 1e-5
    assert meta["two_layer_force"].startswith("ValueError")
    assert meta["axis_name"].startswith("NotImplementedError")


@pytest.mark.parametrize("case", CASES)
def test_optimizer_matches_jax(results, case):
    want, got, _ = results
    atol = 2e-5 if case.endswith("bf16") else 1e-7
    for n in _case_params(case):
        key = f"opt/{case}/{n}"
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=atol,
                                   err_msg=key)


def test_frozen_parameters_do_not_move(results):
    """freeze(): the BERT trunk and the non-layer6 ResNet stay at their
    initial values; the classifier, layer6 and fc1 train."""
    _, got, meta = results
    assert meta["frozen_unchanged"] is True


def test_warmup_schedule_matches_jax(results):
    want, got, _ = results
    np.testing.assert_allclose(got["schedule"], want["schedule"], rtol=1e-6,
                               atol=1e-12)
    assert got["schedule"][0] == 0.0   # the first warmup update is 0


def test_bert_decay_mask_on_torch_names(results):
    assert results[2]["decay_mask"] == {
        n: n.endswith("weight") and "LayerNorm" not in n for n in PARAMS}


def _error_of(fn):
    try:
        fn()
    except Exception as e:  # the test reads the exception's type
        return f"{type(e).__name__}: {e}"
    return "no error"


def _child(job):
    import torch

    from mimm_tpu_torch.objectives import critics, pairing
    from mimm_tpu_torch.ops import pairwise_critic as pc
    from mimm_tpu_torch.train import optim
    from tests.torch_port_child import unflatten_tree

    with np.load(os.path.join(job, "in.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    out, meta = {}, {}
    tree = unflatten_tree(arrays)
    critic = [{k: torch.from_numpy(tree["critic"][str(i)][k])
               for k in ("w", "b")} for i in range(len(CRITIC) + 1)]
    s, sid = t["scores"], torch.from_numpy(SIDS)
    out["mask"] = critics.negative_pair_mask(sid).numpy()
    out["dv_scores"] = critics.dv_bound_from_scores(s, sid).numpy()
    out["infonce_scores"] = critics.infonce_bound_from_scores(s, sid).numpy()
    out["per_anchor"] = critics.infonce_per_anchor(s, sid).numpy()
    out["dv_vector"] = critics.dv_bound_loss(t["logits"], 7).numpy()
    out["infonce_vector"] = critics.infonce_bound_loss(t["logits"], 7).numpy()
    ei, et = t["ei"], t["et"]
    out["pair_scores"] = pairing.pairwise_critic_scores(critic, ei, et).numpy()
    out["pallas_dispatch"] = pc.pairwise_critic_scores_pallas(
        critic, ei, et).numpy()
    brute = pairing.brute_force_pair_logits(critic, ei, et, SIDS)
    out["brute"] = brute.numpy()
    out["brute_dv"] = critics.dv_bound_loss(brute, NB).numpy()
    out["brute_infonce"] = critics.infonce_bound_loss(brute, NB).numpy()
    for est in ESTIMATORS:
        out[f"mi_{est}"] = pairing.mi_loss_from_embeddings(
            critic, ei, et, sid, estimator=est).numpy()
    meta["force_kernel"] = _error_of(lambda: pc.pairwise_critic_scores_pallas(
        critic, ei, et, force_kernel=True))
    forced = pc.pairwise_critic_scores_pallas(critic, ei, et,
                                              force_kernel=True)
    meta["force_kernel_err"] = (forced.double() - torch.from_numpy(
        out["pair_scores"])).abs().max().item()
    meta["switch"] = {"1448": pc.uses_kernel(1448, 1448, 1024),
                      "1449": pc.uses_kernel(1449, 1449, 1024),
                      "forced": pc.uses_kernel(2, 2, 1024, force_kernel=True)}
    meta["two_layer_force"] = _error_of(lambda: pc.pairwise_critic_scores_pallas(
        critic[1:], ei, et, force_kernel=True))
    meta["axis_name"] = _error_of(lambda: pairing.mi_loss_from_embeddings(
        critic, ei, et, sid, axis_name="data"))

    sched = optim.warmup_linear_schedule(**SCHEDULE)
    adamw = lambda md: optim.adamw_hf(sched, eps=1e-6, weight_decay=0.1,
                                      correct_bias=False,
                                      mask=optim.bert_decay_mask,
                                      moment_dtype=md)
    txs = {"adam_f32": optim.adam_torch(1e-3),
           "adam_bf16": optim.adam_torch(1e-3, moment_dtype=torch.bfloat16),
           "adamw_f32": adamw(None), "adamw_bf16": adamw(torch.bfloat16),
           "freeze_text": optim.freeze(adamw(None), optim.bert_trainable_mask),
           "freeze_image": optim.freeze(optim.adam_torch(1e-3),
                                        optim.resnet_trainable_mask)}
    frozen_ok = True
    for case, tx in txs.items():
        names = list(_case_params(case))
        params = {n: t[f"{case}/p/{n}"].clone() for n in names}
        state = tx.init(params)
        for step in range(STEPS):
            grads = {n: t[f"{case}/g/{n}"][step] for n in names}
            upd, state = tx.update(grads, state, params)
            optim.apply_updates(params, upd)
        for n in names:
            out[f"opt/{case}/{n}"] = params[n].numpy()
            if case.startswith("freeze"):
                trains = (not n.startswith("bert.")) if case == "freeze_text" \
                    else n.startswith(("layer6", "fc"))
                moved = not torch.equal(params[n], t[f"{case}/p/{n}"])
                frozen_ok &= moved == trains
    meta["frozen_unchanged"] = frozen_ok
    out["schedule"] = np.array([sched(c) for c in range(STEPS + 1)])
    meta["decay_mask"] = optim.bert_decay_mask(dict.fromkeys(PARAMS))
    np.savez(os.path.join(job, "out.npz"), **out)
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    _child(sys.argv[1])
