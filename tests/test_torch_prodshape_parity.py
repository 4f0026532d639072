"""The port's production-shape trajectory gate (tests/test_prodshape_parity.py
counterpart): the port's float32 MI trajectory against the torch oracle
(tests/torch_reference.py), held inside a band measured from the oracle's
own rounding.

Why a band: in float32 the two implementations sum their convolutions and
matrix products in other orders, and the near-zero DV loss amplifies such
differences chaotically, so two exact implementations drift apart.  The
oracle runs twice, once exact and once with every weight perturbed by 1e-6
relative (``perturb_scale``); the running maximum of |exact - perturbed|
(the envelope) is how fast a rounding-sized difference grows, and the
port's loss must stay within ``max(10 * envelope, 5e-3 * max(1, |exact|))``
of the exact run at every step (JAX's rule, test_prodshape_parity.py:
172-185), with ``envelope[-1] > 0`` so that the band is not vacuous.

Setup, as JAX's gate: ``TrainingConfig.parity()`` with the DV bound,
init_lr 1e-4, bert_lr 2e-5, seed 0, dropout 0, flash off, ``t_total`` the
step count (warm-up 10 %); weights from JAX's ``create_mi_state``
(PRNGKey 0), to the oracle through the JAX package's ``.bin`` converters
(the critic's first layer re-wired by ``_flatten_perm(192, 2, 2)``) and to
the port through ``checkpoint.mi_weights_from_flax``; batches from
``np.random.default_rng(0)``, batch 2 with a duplicated study id.  The
port flattens its image embedding in JAX's NHWC order, so its first
train-mode forward is held against JAX's ``model.apply`` directly (atol
5e-3 / rtol 1e-2, JAX's tolerance) and against the oracle's embedding
through the permutation.

Cases:
* ``narrow`` (tier-1): B=8, L=16, the full ResNet at 256 px, a 2-layer
  BERT of width 32 with 2 heads, 12 steps over 4 batches.
* ``bert_base`` (JAX's case): B=16, L=128, BERT-base (12 layers, hidden
  768), 40 steps over 8 batches.  Opt-in: ``MIMM_RUN_TORCH_PRODSHAPE=1``
  (two single-threaded oracle runs side by side, the port on the other
  cores).

The three children are independent and start together: the two oracle
runs (a fresh interpreter each, as JAX's gate starts them) and the port's
trajectory in a jax-free child (tests/torch_port_child.py).  The JAX side
(initial state, converters, first forward) runs in the pytest worker.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

GATE_VAR = "MIMM_RUN_TORCH_PRODSHAPE"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(REPO, "tests", "torch_reference.py")
NARROW_BERT = dict(hidden_size=32, num_hidden_layers=2,
                   num_attention_heads=2, intermediate_size=64)
CASES = {
    "narrow": dict(batch=8, seq=16, steps=12, n_batches=4, bert=NARROW_BERT,
                   timeout=600),
    "bert_base": dict(batch=16, seq=128, steps=40, n_batches=8, bert={},
                      timeout=3600),
}
PERTURB = 1e-6
# the port's first train-mode forward against the oracle's, max |Δ| over
# max |oracle|: both torch float32 on the CPU, convolutions and products
# summed in other orders through 25 convolutions and 31 BatchNorms
# (measured on an 8-core CPU: z 6.2e-6 narrow, 2.2e-5 bert_base; the text
# embedding 1.6e-7, 2.0e-6), 50x tighter than JAX's cross-framework 5e-3;
# the oracle perturbed by 1e-6 reads z 2.9e-5 / et 2.8e-6 (narrow), 3.1e-5
# / 1.3e-5 (bert_base), the port's forward under bfloat16 autocast 8.2e-2
# / 3.8e-3, 8.1e-2 / 1.1e-2
ORACLE_FWD_REL = 1e-4


def skip_reason(case: str):
    """Why ``case`` does not run here, or None: the full-width case runs
    only with the gate's variable set."""
    if case == "narrow" or os.environ.get(GATE_VAR) == "1":
        return None
    return (f"set {GATE_VAR}=1 (BERT-base, 40 float32 steps: two "
            f"single-threaded oracle runs and the port's)")


def _oracle_env() -> dict:
    from tests.torch_port_child import child_env

    env = child_env()
    env["USE_TF"] = "0"
    return env


def _start_oracle(work: str):
    log = open(os.path.join(work, "oracle.log"), "w")
    proc = subprocess.Popen([sys.executable, ORACLE, work], env=_oracle_env(),
                            stdout=log, stderr=subprocess.STDOUT, cwd=REPO)
    log.close()
    return proc


def _finish_oracle(proc, work: str, timeout: float) -> dict:
    from tests.torch_port_child import _load_and_remove

    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    with open(os.path.join(work, "oracle.log")) as f:
        log = f.read()
    assert proc.returncode == 0, \
        f"torch oracle failed (rc={proc.returncode}):\n{log[-4000:]}"
    return _load_and_remove(os.path.join(work, "out.npz"))


def _batches(case: dict, vocab: int) -> list:
    """JAX's gate's batches (test_prodshape_parity.py:99-112)."""
    b, seq = case["batch"], case["seq"]
    rng = np.random.default_rng(0)
    out = []
    for n in range(case["n_batches"]):
        sids = np.arange(b, dtype=np.int64) + 100 * n
        if n == 2:      # a duplicated study id: the negative mask
            sids[1] = sids[0]
        out.append({
            "image": rng.random((b, 256, 256, 1)).astype(np.float32),
            "txt_ids": rng.integers(0, vocab, (b, seq)).astype(np.int32),
            "txt_masks": np.ones((b, seq), np.int32),
            "txt_segments": np.zeros((b, seq), np.int32),
            "study_id": sids})
    return out


@pytest.fixture(scope="module", params=sorted(CASES))
def results(request, tmp_path_factory):
    reason = skip_reason(request.param)
    if reason:
        pytest.skip(reason)
    import jax
    import jax.numpy as jnp

    from mimm_tpu import checkpoint as ckpt
    from mimm_tpu.checkpoint import _flatten_perm
    from mimm_tpu.config import TrainingConfig
    from mimm_tpu.models.bert import BertConfig
    from mimm_tpu.models.joint import ImageReportModel
    from mimm_tpu.train.mi import create_mi_state, make_optimizers
    from tests.test_torch_train import _flat_state
    from tests.torch_port_child import finish_child, remove_job, start_child

    case = CASES[request.param]
    b, seq, steps = case["batch"], case["seq"], case["steps"]
    job = str(tmp_path_factory.mktemp(f"prodshape_{request.param}"))
    cfg_kw = dict(batch_size=b, img_size=256, max_seq_length=seq,
                  num_train_epochs=1, mi_estimator="dv", init_lr=1e-4,
                  bert_lr=2e-5, seed=0)
    bert_kw = dict(num_classes=1, hidden_dropout_prob=0.0,
                   attention_probs_dropout_prob=0.0, flash_attention=False,
                   **case["bert"])
    cfg = TrainingConfig.parity().replace(**cfg_kw)
    bert_cfg = BertConfig(**bert_kw)
    model = ImageReportModel(bert_config=bert_cfg, output_channels=1,
                             dtype=jnp.float32)
    txs = make_optimizers(cfg, steps_per_epoch=steps)   # t_total = steps
    state = create_mi_state(model, cfg, txs, jax.random.PRNGKey(0))
    params, bstats, critic = (jax.device_get(x) for x in (
        state.params, state.batch_stats, state.critic_params))
    del state
    hidden = bert_cfg.hidden_size

    # ---- the oracle's inputs, written once and linked into each run --------
    shared = os.path.join(job, "shared")
    os.makedirs(shared)
    critic_sd = ckpt.mlp_state_dict_from_params(critic, sequential=True)
    perm = _flatten_perm(192, 2, 2)
    w0 = critic_sd["0.weight"].copy()
    w0[:, perm] = critic_sd["0.weight"][:, :768]
    critic_sd = dict(critic_sd, **{"0.weight": w0})
    np.savez(os.path.join(shared, "img_sd.npz"),
             **ckpt.resnet_state_dict_from_variables(
                 {"params": params["image_model"],
                  "batch_stats": bstats["image_model"]}))
    np.savez(os.path.join(shared, "txt_sd.npz"),
             **ckpt.bert_state_dict_from_variables(
                 {"params": params["text_model"]},
                 bert_cfg.num_hidden_layers))
    np.savez(os.path.join(shared, "critic_sd.npz"), **critic_sd)
    batches = _batches(case, bert_cfg.vocab_size)
    stack = lambda k: np.stack([x[k] for x in batches])   # noqa: E731
    np.savez(os.path.join(shared, "batch.npz"),
             image_nchw=np.transpose(stack("image"), (0, 1, 4, 2, 3)),
             txt_ids=stack("txt_ids"), txt_masks=stack("txt_masks"),
             txt_segments=stack("txt_segments"), study_id=stack("study_id"))
    oracle_cfg = {
        "output_channels": 1, "vocab_size": bert_cfg.vocab_size,
        "hidden_size": hidden, "num_hidden_layers":
            bert_cfg.num_hidden_layers,
        "num_attention_heads": bert_cfg.num_attention_heads,
        "intermediate_size": bert_cfg.intermediate_size,
        "max_position_embeddings": bert_cfg.max_position_embeddings,
        "critic_in": 768 + hidden, "critic_hidden": [1024, 512],
        "init_lr": cfg.init_lr, "bert_lr": cfg.bert_lr,
        "warmup": 0.1 * steps, "t_total": steps, "steps": steps,
        "dtype": "float32"}
    oracles, procs = {}, []
    try:
        for tag, scale in (("exact", 0.0), ("perturbed", PERTURB)):
            work = os.path.join(job, tag)
            os.makedirs(work)
            for name in ("img_sd", "txt_sd", "critic_sd", "batch"):
                os.symlink(os.path.join(shared, f"{name}.npz"),
                           os.path.join(work, f"{name}.npz"))
            with open(os.path.join(work, "config.json"), "w") as f:
                json.dump(dict(oracle_cfg, perturb_scale=scale), f)
            oracles[tag] = work
            procs.append(_start_oracle(work))

        # ---- the port's trajectory, on the cores the oracles leave -------
        port = os.path.join(job, "port")
        os.makedirs(port)
        np.savez(os.path.join(port, "in.npz"),
                 **_flat_state(params, bstats, critic, "init/"))
        with open(os.path.join(port, "spec.json"), "w") as f:
            json.dump({"cfg": cfg_kw, "bert": bert_kw, "steps": steps,
                       "batches": os.path.join(shared, "batch.npz"),
                       "threads": 1 if request.param == "narrow"
                       else max(1, (os.cpu_count() or 3) - 2)}, f)
        child = start_child(__file__, port)
        procs.append(child)

        # ---- JAX's first train-mode forward, meanwhile -------------------
        outs, _ = model.apply(
            {"params": params, "batch_stats": bstats},
            *(jnp.asarray(batches[0][k]) for k in (
                "image", "txt_ids", "txt_masks", "txt_segments")),
            train=True, rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        want = {"jax_z": np.asarray(outs[0]), "jax_et": np.asarray(outs[1])}
        got, meta = finish_child(child, port, timeout=case["timeout"])
        for proc, (tag, work) in zip(procs, oracles.items()):
            want[tag] = _finish_oracle(proc, work, case["timeout"])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    want["perm"] = perm
    yield want, got, meta
    remove_job(job)


def test_port_first_forward_matches_jax(results):
    want, got, _ = results
    np.testing.assert_allclose(got["emb_img"], want["jax_z"], atol=5e-3,
                               rtol=1e-2)
    np.testing.assert_allclose(got["emb_txt"], want["jax_et"], atol=5e-3,
                               rtol=1e-2)


def _oracle_fwd_rel(want: dict, img, txt) -> dict:
    """max |Δ| / max |exact oracle| of a first forward's two embeddings."""
    exact = want["exact"]
    pairs = {"z": (img, exact["z_fwd"][:, want["perm"]]),
             "et": (txt, exact["et_fwd"])}
    for k, (mine, ref) in pairs.items():
        assert mine.shape == ref.shape, k
    return {k: float(np.max(np.abs(mine - ref)) / np.max(np.abs(ref)))
            for k, (mine, ref) in pairs.items()}


def test_port_first_forward_matches_oracle(results):
    want, got, _ = results
    rel = _oracle_fwd_rel(want, got["emb_img"], got["emb_txt"])
    print(json.dumps({"oracle_fwd_rel": rel}))
    for k, r in rel.items():
        assert r <= ORACLE_FWD_REL, (k, r)


def test_oracle_bound_separates_a_bfloat16_forward(results):
    """The port's forward under bfloat16 autocast lies far outside the
    bound; the oracle's perturbed run (1e-6 of every weight) is printed
    beside it, a rounding-sized reading."""
    want, got, _ = results
    pert = want["perturbed"]
    rounding = _oracle_fwd_rel(want, pert["z_fwd"][:, want["perm"]],
                               pert["et_fwd"])
    bf16 = _oracle_fwd_rel(want, got["emb_img_bf16"], got["emb_txt_bf16"])
    print(json.dumps({"oracle_fwd_rel_perturbed": rounding,
                      "oracle_fwd_rel_bf16": bf16}))
    for k, r in bf16.items():
        assert r > 10 * ORACLE_FWD_REL, (k, r)


def test_port_losses_stay_in_the_oracle_band(results):
    want, got, meta = results
    port = got["losses"]
    exact = want["exact"]["losses"]
    assert port.shape == exact.shape and np.isfinite(port).all()
    band = np.abs(exact - want["perturbed"]["losses"])
    envelope = np.maximum.accumulate(band)
    allowed = np.maximum(10.0 * envelope,
                         5e-3 * np.maximum(1.0, np.abs(exact)))
    diff = np.abs(port - exact)
    print(json.dumps({"max_diff_over_allowed": float(np.max(diff / allowed)),
                      "envelope_last": float(envelope[-1]),
                      "port_seconds": meta["seconds"]}))
    bad = np.where(diff > allowed)[0]
    assert bad.size == 0, (
        f"the port left the oracle's band at steps {bad.tolist()}:\n"
        f"port={port[bad]}\nexact={exact[bad]}\nband={band[bad]}\n"
        f"allowed={allowed[bad]}")


def test_oracle_band_is_not_vacuous(results):
    want, _, _ = results
    exact, perturbed = want["exact"]["losses"], want["perturbed"]["losses"]
    assert np.isfinite(exact).all() and np.isfinite(perturbed).all()
    assert np.maximum.accumulate(np.abs(exact - perturbed))[-1] > 0


# ---- the port side ----------------------------------------------------------

def _child(job):
    import copy
    import time

    import torch

    from mimm_tpu_torch import checkpoint as ckpt
    from mimm_tpu_torch.config import TrainingConfig
    from mimm_tpu_torch.models.bert import BertConfig
    from mimm_tpu_torch.train import mi
    from tests.torch_port_child import unflatten_tree

    # torch's CPU oneDNN float32 convolution backward has corrupted the
    # heap in this project's CPU builds; its reference convolutions do not
    torch.backends.mkldnn.enabled = False
    with open(os.path.join(job, "spec.json")) as f:
        spec = json.load(f)
    torch.set_num_threads(spec["threads"])
    with np.load(os.path.join(job, "in.npz")) as z:
        init = unflatten_tree({k: z[k] for k in z.files})["init"]
    bert = BertConfig(**spec["bert"])
    weights = ckpt.mi_weights_from_flax(
        init["params"], init["batch_stats"],
        [init["critic"][str(i)] for i in range(len(init["critic"]))],
        bert.num_hidden_layers)
    del init
    with np.load(spec["batches"]) as z:
        raw = {k: z[k] for k in z.files}
    batches = [{
        "image": torch.from_numpy(np.ascontiguousarray(
            np.transpose(raw["image_nchw"][n], (0, 2, 3, 1)))),
        **{k: torch.from_numpy(raw[k][n]) for k in (
            "txt_ids", "txt_masks", "txt_segments", "study_id")}}
        for n in range(len(raw["txt_ids"]))]

    cfg = TrainingConfig.parity(**spec["cfg"])
    model = mi.build_joint_model(cfg, bert, device="cpu")
    txs = mi.make_optimizers(cfg, steps_per_epoch=spec["steps"])
    state = mi.create_mi_state(model, cfg, txs, None, weights=weights)
    del weights
    out = {}
    # the first train-mode forward, on a copy (its BatchNorm statistics)
    golden = copy.deepcopy(model)
    b0 = batches[0]
    with torch.no_grad():
        emb = golden(b0["image"], b0["txt_ids"], b0["txt_masks"],
                     b0["txt_segments"], train=True)
    out["emb_img"], out["emb_txt"] = (t.numpy() for t in emb[:2])
    # a control for the oracle bound: the same forward under bfloat16
    golden = copy.deepcopy(model)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        emb = golden(b0["image"], b0["txt_ids"], b0["txt_masks"],
                     b0["txt_segments"], train=True)
    out["emb_img_bf16"], out["emb_txt_bf16"] = (
        t.float().numpy() for t in emb[:2])
    del golden, emb

    step = mi.make_mi_train_step(model, txs, cfg)
    losses, t0 = [], time.time()
    for s in range(spec["steps"]):
        state, loss = step(state, batches[s % len(batches)])
        losses.append(loss.item())
    out["losses"] = np.array(losses)
    np.savez(os.path.join(job, "out.npz"), **out)
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump({"seconds": time.time() - t0}, f)


if __name__ == "__main__":
    _child(sys.argv[1])
