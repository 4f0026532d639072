"""The port's classifier trainer (mimm_tpu_torch/train/classifier.py), its
optimizers (train/optim.py ``sgd_torch``, ``exponential_epoch_schedule``)
and the validation metrics (metrics.py) against the JAX package's.

* The step: 6 float64 steps at dropout 0 with ``steps_per_epoch`` 2 (two
  epoch boundaries of the ExponentialLR schedule), Adam and SGD, against
  JAX's ``make_classifier_step`` from the same weights and batch: the
  losses to rtol 1e-7 (tests/test_reference_clf_parity.py:101).  A
  schedule read at the count after the update, not before it as optax
  reads it, moves the losses past that.
* ``ClassifierModelManager.train`` over an in-memory disease dataset (24
  images of 64², labels alternating; 18 train and 6 validation, B=4, the
  last validation batch ragged), embedded by a small ResNetAE (3 levels,
  1 residual block, z_dim 16, bottleneck 768) in float64 on the same
  random float64 weights, the MLP [16] in float64 from JAX's initial draw
  at dropout 0
  (JAX's ``BasicMLP`` swapped in this test for one with rate 0 and
  float64 parameters), Adam at 1e-2, 3 epochs: the split, every epoch's
  train and validation accuracy, loss and tallies, ``best_path``'s epoch
  and the best ``.bin`` (1e-6 / 1e-7, as tests/test_preempt.py:172).
* Preempted after step 6 (mid-epoch 2, ``preempt.request()``), then
  resumed, the port ends on the uninterrupted run's bits with dropout on
  (float32), with Adam and with SGD, with the same best accuracy,
  ``best_path`` and curves (JAX's tests/test_preempt.py:128).
* The ``.bin`` files cross both ways: JAX's (``mlp_state_dict_from_params``
  of its initial draw) loads ``strict=True`` into the port's ``BasicMLP``,
  and the port's best one goes through JAX's ``mlp_params_from_state_dict``,
  each giving the other side's outputs.
* The metrics copies (``roc_auc`` with ties, ``binary_classification_
  report`` with empty denominators, ``gdv_calculation``,
  ``Plot_Training_From_Logfile``, ``PrintModel``) equal JAX's.
* A mesh with a 'model' axis (the Manager's argument) runs, and
  ``cfg.mesh_shape`` with a 'pipe' axis of 2 asks one process for the
  ranks it lacks (``ValueError``); ``make_embedding_fn`` takes the
  world's 'data' mesh (lifted by the data-parallel slice, it runs and
  embeds as without it); ``tensorboard`` works (one epoch writes an event
  file under ``tb/classifier_Pneumonia/``; tests/test_torch_profiling.py
  checks what it holds).

The JAX side runs in the pytest worker, the port side in a jax-free child
started first and run beside it (tests/torch_port_child.py).
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

DIM, HIDDEN, B, STEPS, SPE, LR = 32, [24, 12], 16, 6, 2, 1e-2
IMG, N, BATCH, EPOCHS = 64, 24, 4, 3
AE = dict(n_residual_blocks=1, n_levels=3, z_dim=16, bottleneck_dim=768)
CONVERT = dict(n_levels=3, n_res=1, z_dim=16)
CFG = dict(batch_size=BATCH, seed=0, img_size=IMG, init_lr=LR,
           compute_dtype="float32", prefetch=1, data_loader_workers=0,
           disease_label="Pneumonia", num_train_epochs_classifier=EPOCHS)
VAL_FRACTION = 0.25
# None: the knob runs; else (the exception, a part of its message): a
# 'pipe' axis of 2 asks one process for the ranks it lacks
REFUSALS = {"mesh": None,
            "mesh_shape": ("ValueError", "needs 2 ranks, the world has 1"),
            "embedding_mesh": None,
            "schedule_with_moment_dtype": ("NotImplementedError", "queue C")}
STOP_STEP = 6
LOG = ("03-01 10:00 - x   Epoch 2 loss = 0.25000\n"
       "03-01 10:00 - x   Epoch 1 loss = -1.50000\n"
       "03-01 10:00 - x   Epoch 1 took 3.000 s\n")
REPORTS = {  # (labels, probs): ties, half to even, empty denominators
    "ties": ([0, 1, 1, 0, 1, 0, 1], [.2, .5, .5, .5, .9, .1, .2]),
    "all_negative": ([0, 0, 0], [.1, .7, .5]),
    "all_wrong": ([1, 0], [.2, .8]),
    "no_positive_pred": ([1, 1, 0], [.1, .4, .3]),
}


class FakeDiseaseDataset:
    """``n`` float images (H, W, 1) from seed 0, label ``idx % 2``."""

    def __init__(self, n=N, size=IMG):
        self.imgs = np.random.default_rng(0).random(
            (n, size, size, 1)).astype(np.float32)

    def __len__(self):
        return len(self.imgs)

    def load(self, idx, rng, train=True):
        return {"image": self.imgs[idx], "label": np.float32(idx % 2)}


def _metric_inputs():
    rng = np.random.default_rng(3)
    return rng.normal(0.5, 1.0, (12, 6)), rng.normal(-0.5, 1.0, (9, 6))


def _jsonl_epochs(save):
    with open(os.path.join(save, "classifier_Pneumonia.jsonl")) as f:
        return [r for r in map(json.loads, f) if "val_acc" in r]


def random_variables(module, x_shape, seed: int) -> dict:
    """Float64 flax variables of ``module`` (its shapes by
    ``jax.eval_shape``, nothing compiled): conv and dense kernels normal
    at variance 1/fan_in, BatchNorm scales near 1, biases and running
    means near 0, running variances in [0.5, 1.5]."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(lambda k: module.init(
        k, jnp.zeros(x_shape), train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        if name == "kernel":
            return rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * rng.standard_normal(shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape)
        return 0.1 * rng.standard_normal(shape)        # bias, mean

    return jax.tree_util.tree_map_with_path(
        fill, jax.tree.map(lambda a: a, shapes))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from mimm_tpu import checkpoint as jckpt
    from mimm_tpu import metrics as jm
    from mimm_tpu.config import TrainingConfig
    from mimm_tpu.models.autoencoder import ResNetAE
    from mimm_tpu.models.mlp import BasicMLP
    from mimm_tpu.train import classifier as jclf
    from mimm_tpu.train.optim import (adam_torch, exponential_epoch_schedule,
                                      sgd_torch)
    from tests.torch_port_child import (finish_child, flatten_tree,
                                        start_child)

    job = str(tmp_path_factory.mktemp("classifier"))
    want, arrays = {}, {}
    f64 = lambda t: jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), t)

    class MLP64(BasicMLP):
        """JAX's classifier MLP at dropout 0 with float64 parameters."""

        def __init__(self, input_dim, hidden_dims, output_dim=1,
                     dropout_rate=0.2):
            super().__init__(input_dim, hidden_dims, output_dim, 0.0)

        def init(self, key):
            return f64(super().init(key))

    with jax.enable_x64(True):
        # ---- the child's inputs, then the child, beside the JAX side --------
        step_params = MLP64(DIM, HIDDEN).init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(1)
        emb = rng.standard_normal((B, DIM))
        labels = (rng.random(B) > 0.5).astype(np.float64)
        arrays.update(flatten_tree(jckpt.mlp_state_dict_from_params(
            jax.device_get(step_params)), "step_sd/"))
        arrays.update({"step_emb": emb, "step_labels": labels})
        ae = ResNetAE(input_shape=(IMG, IMG, 1), **AE, dtype=jnp.float64)
        variables = random_variables(ae, (1, IMG, IMG, 1), 1)
        arrays.update(flatten_tree(variables, "ae/"))
        save = os.path.join(job, "jax")
        cfg = TrainingConfig(**CFG, save_directory=save)
        init = MLP64(768, [16]).init(jax.random.PRNGKey(cfg.seed))
        init_sd = jckpt.mlp_state_dict_from_params(jax.device_get(init))
        arrays.update(flatten_tree(init_sd, "init_sd/"))
        # JAX's .bin of its initial draw, for the port to load strict
        jckpt.save_state_dict_bin(os.path.join(job, "jax_init.bin"), init_sd)
        probe = np.random.default_rng(2).standard_normal((5, 768))
        arrays["probe"] = probe
        np.savez(os.path.join(job, "in.npz"), **arrays)
        with open(os.path.join(job, "train.log"), "w") as f:
            f.write(LOG)
        child = start_child(__file__, job)

        # ---- (a) the step, Adam and SGD --------------------------------------
        for name in ("Adam", "SGD"):
            sched = exponential_epoch_schedule(LR, 0.9, SPE)
            tx = adam_torch(sched) if name == "Adam" else sgd_torch(sched)
            own = jax.tree.map(jnp.array, step_params)  # the step donates it
            state = jclf.ClassifierTrainState(own, tx.init(own),
                                              jnp.zeros([], jnp.int32))
            step = jclf.make_classifier_step(MLP64(DIM, HIDDEN), tx, seed=0)
            losses = []
            for _ in range(STEPS):
                state, loss = step(state, jnp.asarray(emb),
                                   jnp.asarray(labels))
                losses.append(float(loss))
            want[f"step_{name}"] = losses

        # ---- (b) the Manager, from JAX's initial draw ------------------------
        want["init_probs"] = np.asarray(
            MLP64(768, [16]).apply(init, jnp.asarray(probe))[:, 0])
        real_mlp = jclf.BasicMLP
        jclf.BasicMLP = MLP64
        try:
            embed = jclf.make_embedding_fn("unimodal", ae, variables)
            mgr = jclf.ClassifierModelManager(cfg, embed, [16],
                                              dataset=FakeDiseaseDataset(),
                                              val_fraction=VAL_FRACTION)
            _, acc, best = mgr.train()
        finally:
            jclf.BasicMLP = real_mlp
        best_bin = os.path.basename(best).replace(
            "classifier_", "pytorch_image_classifier_").replace(".ckpt", ".bin")
        want["jax_bin"] = jckpt.load_state_dict_bin(os.path.join(save,
                                                                 best_bin))
        want["manager"] = {
            "epochs": _jsonl_epochs(save), "max_accuracy": acc,
            "best": os.path.basename(best),
            "val_indices": mgr.val_view.indices.tolist(),
            "files": sorted(os.listdir(save))}

    # ---- (e) the metrics --------------------------------------------------
    pos, neg = _metric_inputs()
    want["metrics"] = {
        "gdv": jm.gdv_calculation(pos, neg),
        "z": jm.z_scored_transform(pos).tolist(),
        "auc": {k: jm.roc_auc(*v) for k, v in REPORTS.items()},
        "report": {k: jm.binary_classification_report(*v)
                   for k, v in REPORTS.items()},
        "report_threshold": jm.binary_classification_report(
            *REPORTS["ties"], threshold=0.3),
        "log": jm.Plot_Training_From_Logfile(os.path.join(job, "train.log")),
        "count": jm.PrintModel(want["jax_bin"], print_values=False)}

    got, meta = finish_child(child, job, timeout=300)
    # the port's best .bin through JAX's reader, on the same probe
    with jax.enable_x64(True):
        port_sd = jckpt.load_state_dict_bin(os.path.join(
            job, "port", meta["manager"]["best_bin"]))
        want["port_bin_probs_by_jax"] = np.asarray(MLP64(768, [16]).apply(
            f64(jckpt.mlp_params_from_state_dict(port_sd)),
            jnp.asarray(probe))[:, 0])
    shutil.rmtree(job)
    return want, got, meta


@pytest.mark.parametrize("optimizer", ["Adam", "SGD"])
def test_step_and_schedule_match_jax(results, optimizer):
    want, _, meta = results
    np.testing.assert_allclose(meta["step"][optimizer],
                               want[f"step_{optimizer}"], rtol=1e-7,
                               atol=1e-10)


def test_manager_matches_jax(results):
    want, _, meta = results
    w, g = want["manager"], meta["manager"]
    assert g["val_indices"] == w["val_indices"]
    assert len(g["epochs"]) == len(w["epochs"]) == EPOCHS
    for a, b in zip(g["epochs"], w["epochs"]):
        for k in ("epoch", "train_acc", "val_acc", "total", "positive",
                  "negative", "tp", "tn", "fp", "fn"):
            assert a[k] == b[k], (k, a, b)
        for k in ("train_loss", "val_loss"):
            assert abs(a[k] - b[k]) <= 1e-7 + 1e-6 * abs(b[k]), (k, a, b)
    assert g["epochs"][0]["total"] == round(N * VAL_FRACTION)
    assert g["max_accuracy"] == w["max_accuracy"]
    assert g["best"] == w["best"]
    assert g["files"] == w["files"]


def test_best_bin_matches_jax(results):
    want, got, meta = results
    assert sorted(meta["manager"]["bin_keys"]) == sorted(want["jax_bin"])
    for k, v in want["jax_bin"].items():
        np.testing.assert_allclose(got[f"port_bin/{k}"], v, rtol=1e-6,
                                   atol=1e-7)


def test_bin_files_cross_both_ways(results):
    """JAX's .bin of its initial draw (``mlp_state_dict_from_params``)
    loads strict into the port's BasicMLP and gives JAX's outputs; the
    port's best .bin through ``mlp_params_from_state_dict`` gives the
    port's."""
    want, got, _ = results
    np.testing.assert_allclose(got["init_probs_by_port"],
                               want["init_probs"], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(want["port_bin_probs_by_jax"],
                               got["port_bin_probs"], rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("optimizer", ["Adam", "SGD"])
def test_preempt_then_resume_is_bit_equal(results, optimizer):
    p = results[2]["preempt"][optimizer]
    assert p["stopped_step"] == STOP_STEP and p["ckpt"] and p["sidecar"]
    assert p["jsonl_preempted"]
    assert p["resumed_step"] == p["full_step"] == \
        EPOCHS * ((N - round(N * VAL_FRACTION)) // BATCH)
    assert p["differ"] == [] and p["compared"] >= 8, p["differ"]
    assert p["same_accuracy"] and p["same_best"] and p["same_curves"]


@pytest.mark.parametrize("knob", list(REFUSALS))
def test_later_slice_knobs_raise(results, knob):
    err = results[2]["refusals"][knob]
    if REFUSALS[knob] is None:
        assert err == "no error", err
        return
    kind, part = REFUSALS[knob]
    assert err.startswith(kind), err
    assert part in err, err


@pytest.mark.parametrize("knob", ["tensorboard"])
def test_profiling_knobs_work(results, knob):
    """``tensorboard`` through one epoch of the trainer: no error, and one
    event file beside ``classifier_Pneumonia.jsonl``."""
    run = results[2]["profiling_knobs"][knob]
    assert run["error"] == "no error", run
    assert run["epochs"] == [1], run
    assert len([f for f in run["written"]
                if f.startswith("events.out.tfevents.")]) == 1, run


def test_training_dropout_needs_a_generator(results):
    """BasicMLP draws its training-mode dropout masks from a generator
    only; without one it raises."""
    err = results[2]["dropout_without_generator"]
    assert err.startswith("ValueError") and "generator" in err, err


@pytest.mark.parametrize("name", ["gdv", "z", "auc", "report",
                                  "report_threshold", "log", "count"])
def test_metrics_match_jax(results, name):
    want, _, meta = results
    a, b = meta["metrics"][name], want["metrics"][name]
    np.testing.assert_equal(json.loads(json.dumps(a)),
                            json.loads(json.dumps(b)))


def _child(job):
    import torch

    from mimm_tpu_torch import checkpoint as ckpt
    from mimm_tpu_torch import metrics as pm
    from mimm_tpu_torch import preempt
    from mimm_tpu_torch.config import TrainingConfig
    from mimm_tpu_torch.models.autoencoder import ResNetAE
    from mimm_tpu_torch.models.mlp import BasicMLP
    from mimm_tpu_torch.parallel.mesh import make_mesh
    from mimm_tpu_torch.train import classifier as clf
    from mimm_tpu_torch.train.optim import (adam_torch,
                                            exponential_epoch_schedule,
                                            sgd_torch)
    from tests.test_torch_train import _error_of
    from tests.torch_port_child import unflatten_tree

    torch.backends.mkldnn.enabled = False
    with np.load(os.path.join(job, "in.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    sd_of = lambda prefix, dt=torch.float64: {
        k[len(prefix):]: torch.from_numpy(v).to(dt)
        for k, v in arrays.items() if k.startswith(prefix)}
    meta, out = {}, {}

    # ---- (a) the step ---------------------------------------------------------
    emb = torch.from_numpy(arrays["step_emb"])
    labels = torch.from_numpy(arrays["step_labels"])
    meta["step"] = {}
    for name in ("Adam", "SGD"):
        mlp = BasicMLP(DIM, HIDDEN, dropout_rate=0.0).double()
        sched = exponential_epoch_schedule(LR, 0.9, SPE)
        tx = adam_torch(sched) if name == "Adam" else sgd_torch(sched)
        state = clf.create_classifier_state(mlp, tx, None,
                                            weights=sd_of("step_sd/"))
        step = clf.make_classifier_step(mlp, tx, seed=0)
        meta["step"][name] = [step(state, emb, labels)[1].item()
                              for _ in range(STEPS)]

    # ---- (b) the Manager, from JAX's initial draw -----------------------------
    ae = ResNetAE(input_shape=(IMG, IMG, 1), **AE, dtype=torch.float64)
    ae_sd = ckpt.ae_state_dict_from_flax(
        unflatten_tree({k[3:]: v for k, v in arrays.items()
                        if k.startswith("ae/")}), **CONVERT)
    embed = clf.make_embedding_fn("unimodal", ae.double(), ae_sd)

    class MLP64(BasicMLP):
        def __init__(self, input_dim, hidden_dims, output_dim=1,
                     dropout_rate=0.2):
            super().__init__(input_dim, hidden_dims, output_dim, 0.0)
            self.double()

    real_mlp = clf.BasicMLP
    clf.BasicMLP = MLP64
    try:
        save = os.path.join(job, "port")
        cfg = TrainingConfig(**CFG, save_directory=save)
        mgr = clf.ClassifierModelManager(cfg, embed, [16],
                                         dataset=FakeDiseaseDataset(),
                                         val_fraction=VAL_FRACTION,
                                         device="cpu",
                                         weights=sd_of("init_sd/"))
        _, acc, best = mgr.train()
    finally:
        clf.BasicMLP = real_mlp
    best_bin = os.path.basename(best).replace(
        "classifier_", "pytorch_image_classifier_").replace(".ckpt", ".bin")
    port_sd = ckpt.load_state_dict_bin(os.path.join(save, best_bin))
    out.update({f"port_bin/{k}": v.numpy() for k, v in port_sd.items()})
    meta["manager"] = {
        "epochs": _jsonl_epochs(save), "max_accuracy": acc,
        "best": os.path.basename(best), "best_bin": best_bin,
        "val_indices": mgr.val_view.indices.tolist(),
        "files": sorted(os.listdir(save)), "bin_keys": sorted(port_sd)}

    # ---- (d) the .bin files both ways -----------------------------------------
    probe = torch.from_numpy(arrays["probe"])
    jax_init = ckpt.load_state_dict_bin(os.path.join(job, "jax_init.bin"))
    for name, sd in (("init_probs_by_port", jax_init),
                     ("port_bin_probs", port_sd)):
        mlp = BasicMLP(768, [16]).double().eval()
        mlp.load_state_dict(sd, strict=True)
        with torch.no_grad():
            out[name] = mlp(probe)[:, 0].numpy()

    # ---- (c) preempted, then resumed, dropout on (float32) --------------------
    embed32 = clf.make_embedding_fn(
        "unimodal", ResNetAE(input_shape=(IMG, IMG, 1), **AE), ae_sd)
    real_step = clf.make_classifier_step
    stop = {"at": None}

    def step_with_stop(*a, **kw):
        step = real_step(*a, **kw)

        def run(state, emb, labels):
            state, loss = step(state, emb, labels)
            if state.step == stop["at"]:
                preempt.request()
            return state, loss
        return run

    clf.make_classifier_step = step_with_stop

    def run(save, optimizer, resume_from=None):
        mgr = clf.ClassifierModelManager(
            TrainingConfig(**CFG, save_directory=save, optimizer=optimizer),
            embed32, [16], dataset=FakeDiseaseDataset(),
            val_fraction=VAL_FRACTION, device="cpu")
        return mgr.train(resume_from=resume_from)

    def flat(state):
        tree = clf.classifier_state_tree(state)
        out = {f"model/{k}": v for k, v in tree["model"].items()}
        for part_, d in tree["opt_state"].items():
            out.update({f"{part_}/{k}": v for k, v in d.items()}
                       if isinstance(d, dict) else {part_: torch.tensor(d)})
        return out

    # a resumed epoch's train loss is the mean of its remaining steps, as
    # in JAX; the rest of the curves are the uninterrupted run's
    resumed_epoch = STOP_STEP // ((N - round(N * VAL_FRACTION)) // BATCH) + 1
    curves = lambda s: [{k: r[k] for k in ("train_loss", "train_acc",
                                           "val_loss", "val_acc")
                         if k != "train_loss" or r["epoch"] != resumed_epoch}
                        for r in _jsonl_epochs(s)]
    meta["preempt"] = {}
    for optimizer in ("Adam", "SGD"):
        full_dir = os.path.join(job, f"full_{optimizer}")
        save = os.path.join(job, f"stopped_{optimizer}")
        full = run(full_dir, optimizer)
        stop["at"] = STOP_STEP
        part = run(save, optimizer)
        stop["at"] = None
        ck = os.path.join(save, "classifier_Pneumonia_preempt.ckpt")
        has = os.path.exists(ck), os.path.exists(ck + ".json")
        with open(os.path.join(save, "classifier_Pneumonia.jsonl")) as f:
            preempted = any(json.loads(line).get("preempted") == 1
                            for line in f)
        preempt.clear()
        resumed = run(save, optimizer, resume_from=ck)
        a, b = flat(full[0]), flat(resumed[0])
        meta["preempt"][optimizer] = {
            "stopped_step": part[0].step, "ckpt": has[0], "sidecar": has[1],
            "jsonl_preempted": preempted, "resumed_step": resumed[0].step,
            "full_step": full[0].step, "compared": len(a),
            "differ": sorted(k for k in a if not torch.equal(a[k], b[k])),
            "same_accuracy": full[1] == resumed[1],
            "same_best": os.path.basename(full[2] or "")
            == os.path.basename(resumed[2] or ""),
            "same_curves": curves(full_dir) == curves(save)}
    clf.make_classifier_step = real_step

    # ---- the knobs of later slices --------------------------------------------
    cfg = TrainingConfig(**CFG, save_directory=os.path.join(job, "refused"))
    manager = lambda cfg, mesh=None: clf.ClassifierModelManager(
        cfg, embed32, [16], dataset=FakeDiseaseDataset(), device="cpu",
        mesh=mesh)
    meta["refusals"] = {
        "mesh": _error_of(lambda: manager(
            cfg, mesh=make_mesh({"data": 1, "model": 1}))),
        "mesh_shape": _error_of(lambda: manager(cfg.replace(
            mesh_shape=(("data", 1), ("pipe", 2))))),
        "embedding_mesh": _error_of(lambda: clf.make_embedding_fn(
            "unimodal", ResNetAE(input_shape=(IMG, IMG, 1), **AE),
            mesh=make_mesh())(torch.zeros(2, IMG, IMG, 1))),
        "schedule_with_moment_dtype": _error_of(lambda: adam_torch(
            lambda count: 1e-3, moment_dtype=torch.bfloat16))}
    save = os.path.join(job, "knob_tensorboard")
    err = _error_of(lambda: manager(cfg.replace(
        save_directory=save, tensorboard=True)).train(num_epochs=1))
    tb = os.path.join(save, "tb", "classifier_Pneumonia")
    meta["profiling_knobs"] = {"tensorboard": {
        "error": err, "epochs": [r["epoch"] for r in _jsonl_epochs(save)],
        "written": sorted(os.listdir(tb)) if os.path.isdir(tb) else []}}
    meta["dropout_without_generator"] = _error_of(
        lambda: BasicMLP(DIM, HIDDEN).train()(torch.zeros(2, DIM)))

    # ---- (e) the metrics ------------------------------------------------------
    pos, neg = _metric_inputs()
    meta["metrics"] = {
        "gdv": pm.gdv_calculation(pos, neg),
        "z": pm.z_scored_transform(pos).tolist(),
        "auc": {k: pm.roc_auc(*v) for k, v in REPORTS.items()},
        "report": {k: pm.binary_classification_report(*v)
                   for k, v in REPORTS.items()},
        "report_threshold": pm.binary_classification_report(
            *REPORTS["ties"], threshold=0.3),
        "log": pm.Plot_Training_From_Logfile(os.path.join(job, "train.log")),
        "count": pm.PrintModel(port_sd, print_values=False)}
    np.savez(os.path.join(job, "out.npz"), **out)
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    _child(sys.argv[1])
