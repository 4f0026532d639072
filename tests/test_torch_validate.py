"""The port's validation (mimm_tpu_torch/validate.py) and its two entry
points, ``mimm_tpu_torch.cli.train --stage classifier_um`` and
``mimm_tpu_torch.cli.validate``, against the JAX package's.

* ``validate_MultiModal`` and ``validate_UniModal`` with ``extended=True``
  over in-memory disease datasets of 10 images (B=4: the last batch
  ragged), on the same ``.bin`` files, in float64: a ResNet256_6_2_1 with
  planes (4, 4, 4, 4, 4, 8) at 256² (a 32-wide embedding, fc1 32 -> 1) and
  a ResNetAE of 3 levels, 1 residual block, z_dim 16 and a 40-wide
  bottleneck (fc1 1024 -> 40), each with a BasicMLP [16] classifier of
  its width.  Neither width is 768, and each fc1's input and output
  widths differ, so reading ``emb_dim`` from the wrong side of fc1 builds
  a classifier the ``.bin`` does not load into.  Accuracy and tallies
  equal JAX's exactly, GDV, AUC, precision, recall and F1 to 1e-9
  relative (NaN where JAX's is).  The weights are float32 values stored
  in float64, so each side computes in float64 on the same numbers.
* ``cli.train --stage classifier_um`` over a PNG corpus of 30 images
  (tests/test_torch_datasets.py ``write_corpus``) with
  ``disease_stats.csv`` labelling every study for both sweep diseases,
  the autoencoder's ``.bin`` in ``um_ae_epoch1`` (a small ResNetAE with a
  768 bottleneck swapped in for ``build_ae_model`` on both sides), 2
  epochs: both diseases' classifiers and logs land in ``um_ae_epoch1``;
  a run stopped after its first step (``preempt.request()``) leaves
  ``classifier_Cardiomegaly_preempt.ckpt`` and trains no second disease;
  the same command with ``--resume_from auto`` ends both diseases on the
  uninterrupted run's bits; ``--mesh_shape`` with a 'pipe' axis of 2
  asks one process for the ranks it lacks (``ValueError``) there and in
  ``cli.validate``; ``--help`` lists the
  stage.
* ``cli.validate --modality um --extended`` on those files prints JAX's
  ``cli/validate.py`` lines: the same keys in the same order, integers
  equal, the floats to 1e-9 relative (both in float64).

The JAX side runs in the pytest worker, the port side in a jax-free child
started first and run beside it (tests/torch_port_child.py).
"""

import contextlib
import functools
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tests.test_torch_classifier import random_variables
from tests.test_torch_datasets import write_corpus

PLANES = (4, 4, 4, 4, 4, 8)
AE_SMALL = dict(n_residual_blocks=1, n_levels=3, z_dim=16)
CONVERT = dict(n_levels=3, n_res=1, z_dim=16)
N, BATCH, HIDDEN = 10, 4, [16]
SIZES = {"mm": 256, "um": 64}
WIDTH = {"mm": PLANES[-1] * 4, "um": 40}
CLI_IMG, CLI_N, CLI_EPOCHS = 64, 30, 2
DISEASES = ("Cardiomegaly", "Pneumonia")
INTS = ("tp", "tn", "fp", "fn", "positives", "negatives")
FLOATS = ("accuracy", "separability", "auc", "precision", "recall", "f1")


class FakeDiseaseDataset:
    """``n`` float images from ``seed``, labels drawn from it (both
    classes)."""

    def __init__(self, size, n=N, seed=5):
        rng = np.random.default_rng(seed)
        self.imgs = rng.random((n, size, size, 1)).astype(np.float32)
        self.labels = np.arange(n) % 2
        rng.shuffle(self.labels)

    def __len__(self):
        return len(self.imgs)

    def load(self, idx, rng, train=True):
        return {"image": self.imgs[idx],
                "label": np.float32(self.labels[idx])}


def _f32_values(tree):
    """float32-representable float64 values."""
    import jax
    return jax.tree.map(lambda a: np.asarray(a, np.float32).astype(np.float64),
                        tree)


def _classifier_sd(width: int, seed: int) -> dict:
    """BasicMLP [16] weights, torch.nn.Linear's range x 3 (outputs spread
    on both sides of 0.5), float32 values in float64."""
    rng = np.random.default_rng(seed)
    dims, sd = [width, *HIDDEN, 1], {}
    for i in range(len(dims) - 1):
        bound = 3 / np.sqrt(dims[i])
        for name, shape in (("weight", (dims[i + 1], dims[i])),
                            ("bias", (dims[i + 1],))):
            sd[f"layers.{i}.{name}"] = rng.uniform(
                -bound, bound, shape).astype(np.float32).astype(np.float64)
    return sd


def _write_disease_stats(path: str, rows: list, seed: int) -> None:
    """Every study positive or negative for each of DISEASES, drawn from
    ``seed``; the two studies the trainer's split (seed 0) holds out are
    one of each, so every run's first epoch saves a classifier."""
    rng = np.random.default_rng(seed)
    studies = [r.split("_")[1][1:] for r in rows]
    held_out = np.random.default_rng(0).permutation(len(studies))[:2]
    with open(path, "w") as f:
        for disease in DISEASES:
            pos = rng.random(len(studies)) < 0.5
            pos[held_out] = (True, False)
            p = [s for s, x in zip(studies, pos) if x]
            n = [s for s, x in zip(studies, pos) if not x]
            f.write(f"{disease},{len(p)},\"{p}\"\n"
                    f"{disease}_negative,{len(n)},\"{n}\"\n")


def _cli_flags(paths: dict, save: str) -> list:
    return ["--save_directory", save, "--num_train_epochs", "1",
            "--batch_size", str(BATCH), "--img_size", str(CLI_IMG),
            "--seed", "0", "--image_dir", paths["images"],
            "--dataset_metadata", paths["metadata"],
            "--dataset_disease_stats", paths["stats"],
            "--data_loader_workers", "0", "--compact_transfer", "true"]


def _parse_lines(text: str) -> list:
    return [tuple(line.split(": ", 1)) for line in text.strip().splitlines()]


@contextlib.contextmanager
def _patched(obj, name, value):
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, real)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from cli import validate as jax_cli_validate
    from mimm_tpu import checkpoint as jckpt
    from mimm_tpu import validate as jval
    from mimm_tpu.config import TrainingConfig
    from mimm_tpu.models.autoencoder import ResNetAE
    from mimm_tpu.models.resnet import ResNet256_6_2_1
    from mimm_tpu.train import ae as jae
    from tests.torch_port_child import finish_child, start_child

    job = str(tmp_path_factory.mktemp("validate"))
    want = {}
    small_ae = lambda bottleneck, dtype: (
        lambda cfg: ResNetAE(input_shape=(cfg.img_size, cfg.img_size, 1),
                             **AE_SMALL, bottleneck_dim=bottleneck,
                             dtype=dtype))
    ae_vars = functools.partial(jckpt.ae_variables_from_state_dict, **CONVERT)
    resnet = functools.partial(ResNet256_6_2_1, planes=PLANES,
                               dtype=jnp.float64)
    with jax.enable_x64(True):
        # ---- the .bin files (weights float32 values in float64) -------------
        variables = {
            "mm": _f32_values(random_variables(
                resnet(), (1, SIZES["mm"], SIZES["mm"], 1), 11)),
            "um": _f32_values(random_variables(
                small_ae(WIDTH["um"], jnp.float64)(TrainingConfig(
                    img_size=SIZES["um"])), (1, SIZES["um"], SIZES["um"], 1),
                12))}
        for mod in ("mm", "um"):
            os.makedirs(os.path.join(job, mod))
        jckpt.save_state_dict_bin(
            os.path.join(job, "mm", "pytorch_MI_image_model.bin"),
            jckpt.resnet_state_dict_from_variables(variables["mm"]))
        jckpt.save_state_dict_bin(
            os.path.join(job, "um", "autoencoder_path_1.bin"),
            jckpt.ae_state_dict_from_variables(variables["um"], **CONVERT))
        for i, mod in enumerate(("mm", "um")):
            jckpt.save_state_dict_bin(os.path.join(
                job, mod, "pytorch_image_classifier_Pneumonia_epoch3.bin"),
                _classifier_sd(WIDTH[mod], 20 + i))
        # ---- the entry points' corpus and the AE it reads ------------------
        paths = write_corpus(os.path.join(job, "corpus"), CLI_N, CLI_IMG, 17,
                             sizes=((80, 70), (64, 96), (50, 60)))
        paths["stats"] = os.path.join(job, "corpus", "disease_stats.csv")
        _write_disease_stats(paths["stats"], paths["rows"], 18)
        cli_ae = _f32_values(random_variables(
            small_ae(768, jnp.float64)(TrainingConfig(img_size=CLI_IMG)),
            (1, CLI_IMG, CLI_IMG, 1), 13))
        jckpt.save_state_dict_bin(
            os.path.join(job, "cli_ae.bin"),
            jckpt.ae_state_dict_from_variables(cli_ae, **CONVERT))
        with open(os.path.join(job, "paths.json"), "w") as f:
            json.dump(paths, f)
        child = start_child(__file__, job)

        # ---- validate_MultiModal / validate_UniModal ------------------------
        cfg = lambda mod: TrainingConfig(
            batch_size=BATCH, seed=0, img_size=SIZES[mod],
            save_directory=os.path.join(job, mod))
        with _patched(jval, "ResNet256_6_2_1", resnet):
            want["mm"] = jval.validate_MultiModal(
                cfg("mm"), HIDDEN, "Pneumonia", extended=True,
                dataset=FakeDiseaseDataset(SIZES["mm"]))
        with _patched(jae, "build_ae_model",
                      small_ae(WIDTH["um"], jnp.float64)), \
                _patched(jckpt, "ae_variables_from_state_dict", ae_vars):
            want["um"] = jval.validate_UniModal(
                cfg("um"), HIDDEN, "Pneumonia", extended=True,
                dataset=FakeDiseaseDataset(SIZES["um"]))

        got, meta = finish_child(child, job, timeout=420)
        # ---- JAX's cli/validate.py on the files the port's sweep wrote ------
        buf = io.StringIO()
        argv = ["validate.py", "--modality", "um", "--extended",
                "--disease", "Pneumonia",
                *_cli_flags(paths, os.path.join(job, "cli_a"))]
        with _patched(jae, "build_ae_model", small_ae(768, jnp.float64)), \
                _patched(jckpt, "ae_variables_from_state_dict", ae_vars), \
                _patched(sys, "argv", argv), contextlib.redirect_stdout(buf):
            jax_cli_validate.main()
        want["cli_lines"] = _parse_lines(buf.getvalue())
    shutil.rmtree(job)
    return want, got, meta


@pytest.mark.parametrize("mod", ["mm", "um"])
def test_validation_report_matches_jax(results, mod):
    want, _, meta = results
    w, g = want[mod], meta["validate"][mod]
    for k in INTS:
        assert g[k] == w[k], (k, g, w)
    assert 0 < g["positives"] < N and g["tp"] + g["tn"] < N
    assert np.isfinite(w["auc"]) and np.isfinite(w["separability"])
    for k in FLOATS:     # precision is NaN where nothing is predicted 1
        np.testing.assert_allclose(g[k], w[k], rtol=1e-9, atol=0, err_msg=k)


def test_cli_train_classifier_um_run_directories(results):
    cli = results[2]["cli"]
    files = cli["files_a"]
    for disease in DISEASES:
        assert f"training_classifier_{disease}.log" in files
        assert f"classifier_{disease}.jsonl" in files
        assert any(f.startswith(f"pytorch_image_classifier_{disease}_epoch")
                   and f.endswith(".bin") for f in files), files
    assert cli["runs_a"] == len(DISEASES)
    assert cli["steps_a"] == [CLI_EPOCHS * cli["steps_per_epoch"]] * 2


def test_cli_resume_auto_ends_on_the_uninterrupted_bits(results):
    cli = results[2]["cli"]
    assert cli["runs_b"] == 1 and cli["stopped_step"] == 1
    assert cli["preempt_ckpt"] and not cli["b_trained_pneumonia"]
    assert cli["differ"] == {d: [] for d in DISEASES}, cli["differ"]
    assert cli["same_best"]


def test_cli_refuses_a_mesh_and_lists_its_flags(results):
    cli = results[2]["cli"]
    for refused in (cli["mesh"], cli["validate_mesh"]):   # a 'pipe' axis
        assert refused.startswith("ValueError"), refused
        assert "needs 2 ranks, the world has 1" in refused, refused
    assert cli["help_rc"] == 0
    for flag in ("--stage", "--device", "--num_train_epochs_classifier",
                 "--dataset_disease_stats"):
        assert flag in cli["help"], flag


def test_cli_validate_prints_jax_lines(results):
    want, _, meta = results
    got = [tuple(x) for x in meta["cli"]["lines"]]
    assert [k for k, _ in got] == [k for k, _ in want["cli_lines"]]
    assert len(got) == len(INTS) + len(FLOATS)
    for (key, g), (_, w) in zip(got, want["cli_lines"]):
        if key.lower() in INTS:
            assert g == w, (key, g, w)
        else:
            np.testing.assert_allclose(float(g), float(w), rtol=1e-9,
                                       err_msg=key)


def _child(job):
    import torch

    from mimm_tpu_torch import preempt
    from mimm_tpu_torch import validate as pval
    from mimm_tpu_torch.cli import train as cli_train
    from mimm_tpu_torch.cli import validate as cli_validate
    from mimm_tpu_torch.config import TrainingConfig
    from mimm_tpu_torch.models.autoencoder import ResNetAE
    from mimm_tpu_torch.models.resnet import ResNet256_6_2_1
    from mimm_tpu_torch.train import ae
    from mimm_tpu_torch.train import classifier as clf
    from tests.test_torch_train import _error_of

    torch.backends.mkldnn.enabled = False
    with open(os.path.join(job, "paths.json")) as f:
        paths = json.load(f)
    small_ae = lambda bottleneck, dtype: (
        lambda cfg, device="cuda": ResNetAE(
            input_shape=(cfg.img_size, cfg.img_size, 1), **AE_SMALL,
            bottleneck_dim=bottleneck, dtype=dtype).to(device))
    meta = {"validate": {}}

    # ---- validate_MultiModal / validate_UniModal ----------------------------
    cfg = lambda mod: TrainingConfig(
        batch_size=BATCH, seed=0, img_size=SIZES[mod],
        save_directory=os.path.join(job, mod), data_loader_workers=0)
    report = lambda r: {k: r[k] for k in (*INTS, *FLOATS)}
    with _patched(pval, "ResNet256_6_2_1", lambda output_channels=1:
                  ResNet256_6_2_1(output_channels, planes=PLANES,
                                  dtype=torch.float64)):
        meta["validate"]["mm"] = report(pval.validate_MultiModal(
            cfg("mm"), HIDDEN, "Pneumonia", extended=True,
            dataset=FakeDiseaseDataset(SIZES["mm"]), device="cpu"))
    with _patched(ae, "build_ae_model", small_ae(WIDTH["um"], torch.float64)):
        meta["validate"]["um"] = report(pval.validate_UniModal(
            cfg("um"), HIDDEN, "Pneumonia", extended=True,
            dataset=FakeDiseaseDataset(SIZES["um"]), device="cpu"))

    # ---- cli.train --stage classifier_um: A, B (stopped), C (resumed) ------
    for run in ("cli_a", "cli_bc"):
        os.makedirs(os.path.join(job, run, "um_ae_epoch1"))
        shutil.copy(os.path.join(job, "cli_ae.bin"), os.path.join(
            job, run, "um_ae_epoch1", "autoencoder_path_1.bin"))
    flags = lambda run, *extra: [
        "--stage", "classifier_um", "--device", "cpu",
        "--num_train_epochs_classifier", str(CLI_EPOCHS),
        *_cli_flags(paths, os.path.join(job, run)), *extra]
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

    flat = lambda st: {k: v.clone() for k, v in
                       clf.classifier_state_tree(st)["model"].items()} | {
        f"{p}/{k}": v.clone()
        for p in ("mu", "nu")
        for k, v in clf.classifier_state_tree(st)["opt_state"][p].items()}
    with _patched(ae, "build_ae_model", small_ae(768, torch.float32)), \
            _patched(clf, "make_classifier_step", step_with_stop):
        runs_a = cli_train.main(flags("cli_a"))
        stop["at"] = 1
        runs_b = cli_train.main(flags("cli_bc"))
        stop["at"] = None
        save_bc = os.path.join(job, "cli_bc", "um_ae_epoch1")
        files_b = sorted(os.listdir(save_bc))
        preempt.clear()        # a new process would start without the flag
        runs_c = cli_train.main(flags("cli_bc", "--resume_from", "auto"))
        mesh = _error_of(lambda: cli_train.main(
            flags("cli_mesh", "--mesh_shape", "data=1,pipe=2")))
    preempt.uninstall()
    save_a = os.path.join(job, "cli_a", "um_ae_epoch1")
    proc = subprocess.run([sys.executable, "-m", "mimm_tpu_torch.cli.train",
                           "--help"], capture_output=True, text=True,
                          timeout=120)
    meta["cli"] = {
        "files_a": sorted(os.listdir(save_a)), "runs_a": len(runs_a),
        "steps_a": [r[0].step for r in runs_a],
        "steps_per_epoch": (CLI_N - round(CLI_N * 0.05)) // BATCH,
        "runs_b": len(runs_b), "stopped_step": runs_b[0][0].step,
        "preempt_ckpt": "classifier_Cardiomegaly_preempt.ckpt" in files_b,
        "b_trained_pneumonia": any("Pneumonia" in f for f in files_b),
        "differ": {d: sorted(k for k, v in flat(a[0]).items()
                             if not torch.equal(v, flat(c[0])[k]))
                   for d, a, c in zip(DISEASES, runs_a, runs_c)},
        "same_best": [(r[1], os.path.basename(r[2] or "")) for r in runs_a]
        == [(r[1], os.path.basename(r[2] or "")) for r in runs_c],
        "mesh": mesh, "help_rc": proc.returncode, "help": proc.stdout}

    # ---- cli.validate --modality um --extended on those files ---------------
    buf = io.StringIO()
    with _patched(ae, "build_ae_model", small_ae(768, torch.float64)), \
            contextlib.redirect_stdout(buf):
        cli_validate.main(["--modality", "um", "--extended", "--disease",
                           "Pneumonia", "--device", "cpu",
                           *_cli_flags(paths, os.path.join(job, "cli_a"))])
    meta["cli"]["lines"] = _parse_lines(buf.getvalue())
    meta["cli"]["validate_mesh"] = _error_of(lambda: cli_validate.main(
        ["--device", "cpu", "--mesh_shape", "data=1,pipe=2",
         *_cli_flags(paths, os.path.join(job, "cli_a"))]))
    np.savez(os.path.join(job, "out.npz"))
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    _child(sys.argv[1])
