"""The port's autoencoder trainer from disk (mimm_tpu_torch/train/ae.py
``train_auto_encoder``, cli/uni_modal.py) against the JAX package's
(mimm_tpu/train/ae.py:153 with ``dataset=None``), and its preemption,
resume, pruning, entry point and refusals.

The corpus is tests/test_torch_datasets.py's ``write_corpus``: 9 PNGs at
sides around 64 (uint8 and 12-bit uint16), one unreadable, which the
loader skips.  Both trainers build their own ``CXRImageDataset`` over the
files through a crop cache each (compact transfer), B=4, img 64, Adam at
1e-3, 2 epochs of 2 steps.  Each side's ``build_ae_model`` is swapped for
a small ResNetAE (3 levels, 1 residual block, z_dim 16, bottleneck 32)
computing in float64 on float32 parameters (in float32, a bias ahead of a
BatchNorm, whose true gradient is 0, gets rounding noise that Adam scales
to ±lr, differently on each side), and JAX's ``.bin`` exporter is told
its depth; the port starts from JAX's initial weights (its
``create_ae_state`` swapped, in the child, for one that loads them).

* the per-epoch losses of ``ae.jsonl`` agree to LOSS_ATOL (measured
  1.6e-9 and 4.6e-9: the float32 parameters round the updates);
  ``fc1`` (measured 4.1e-7) and every tensor of the ``.bin`` files
  (measured 1.8e-6) after the run within the train-step limits of
  PERF.md §2 (max |Δ| ≤ 2.5·lr a step, the share of elements with |Δ| >
  1e-6 ≤ 1e-3); both write the same files, with the same keys in each
  ``.bin``;
* over a second corpus of 8 readable images (a resumed epoch substitutes
  zeros for an unreadable record where the uninterrupted one skips it,
  in JAX too), preempted after step 1 (``preempt.request()``) the port saves
  ``ae_preempt.ckpt``, writes ``preempted: 1`` and stops; resumed, it
  ends bit for bit where the run that was never stopped ends (JAX's
  tests/test_preempt.py:97, which holds ``fc1`` to 1e-6);
* 3 epochs with ``keep_checkpoints`` 1 leave ``ae_epoch3.ckpt`` alone,
  beside every epoch's ``.bin`` files, which reload ``strict=True``;
* the entry point, ``mimm_tpu_torch.cli.uni_modal.main`` (the small AE
  too: the full width's ``.bin`` files and checkpoints take ~1 GB an
  epoch; test_torch_autoencoder.py holds ``build_ae_model`` to the
  reference configuration): a run stopped after its first step, then the
  same command with ``--resume_from auto`` ends on the uninterrupted
  run's bits (JAX's tests/test_cli_resume.py:60); ``--help`` lists the
  flags;
* a mesh with a 'pipe' axis asks one process for the 2 ranks it lacks
  (``ValueError``), and the knobs the data-parallel and
  sharding slices lifted run (``checkpoint_format`` "orbax",
  ``bn_axis_name``, ZeRO-1, FSDP, a step on a mesh with a 'model' axis); ``profile_steps`` and ``tensorboard`` work (one
  epoch of 2 steps: a trace under ``profile/``, an event file under
  ``tb/ae/``; tests/test_torch_profiling.py checks what they hold).

The JAX side runs in the pytest worker, the port side in a jax-free child
(tests/torch_port_child.py).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tests.test_torch_datasets import write_corpus

IMG = 64
SMALL = dict(n_residual_blocks=1, n_levels=3, z_dim=16, bottleneck_dim=32)
CONVERT = dict(n_levels=3, n_res=1, z_dim=16)
LR = 1e-3
CFG = dict(batch_size=4, seed=0, img_size=IMG, compute_dtype="float32",
           num_train_epochs=2, init_lr=LR, prefetch=1, data_loader_workers=2)
EPOCHS = 2
STEPS = 4
LOSS_ATOL = 1e-7
SIZES = ((80, 70), (64, 96), (50, 60))
# None: lifted by the data-parallel slice (the knob runs); the meshes ask
# for a 'model' axis, which the sharding modes bring
# None: the knob runs (lifted by the data-parallel and the sharding slices);
# a 'pipe' axis of 2 raises ValueError on one process
REFUSALS = {"mesh_shape": "needs 2 ranks, the world has 1", "zero1_optimizer_sharding": None,
            "fsdp_parameter_sharding": None, "checkpoint_format": None,
            "bn_axis_name": None, "step_mesh": None}
# the profiling knobs -> (value, what they write)
PROFILING_KNOBS = {"profile_steps": (2, "profile", ".pt.trace.json"),
                   "tensorboard": (True, os.path.join("tb", "ae"),
                                   "events.out.tfevents.")}


def _epoch_losses(save):
    with open(os.path.join(save, "ae.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r["epoch_loss"] for r in recs if "epoch_loss" in r]


def _bins(save, epoch, load):
    """Epoch ``epoch``'s three ``.bin`` files as {file/key: array}, read by
    ``load`` (either package's ``load_state_dict_bin``)."""
    out = {}
    for name in ("autoencoder_path", "encoder", "decoder"):
        sd = load(os.path.join(save, f"{name}_{epoch}.bin"))
        out.update({f"{name}/{k}": np.asarray(v) for k, v in sd.items()})
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from mimm_tpu import checkpoint as jckpt
    from mimm_tpu.config import TrainingConfig
    from mimm_tpu.models.autoencoder import ResNetAE
    from mimm_tpu.parallel import mesh as mesh_lib
    from mimm_tpu.train import ae as jax_ae
    from tests.torch_port_child import flatten_tree, run_child

    job = str(tmp_path_factory.mktemp("ae_train"))
    paths = write_corpus(os.path.join(job, "corpus"), 9, IMG, 13,
                         sizes=SIZES, bad=(5,))
    clean = write_corpus(os.path.join(job, "clean"), 8, IMG, 14,
                         sizes=SIZES)
    save = os.path.join(job, "jax")
    cfg = TrainingConfig(**CFG, save_directory=save,
                         image_dir=paths["images"],
                         dataset_metadata=paths["metadata"],
                         decoded_crop_cache=os.path.join(job, "cache_jax"))
    small = lambda cfg: ResNetAE(input_shape=(cfg.img_size, cfg.img_size,
                                              cfg.output_channels),
                                 **SMALL, dtype=jnp.float64)
    real = jax_ae.build_ae_model, jckpt.ae_state_dict_from_variables
    jax_ae.build_ae_model = small
    jckpt.ae_state_dict_from_variables = \
        lambda v: real[1](v, **CONVERT)
    try:
        with jax.enable_x64(True):
            init = jax.device_get(jax_ae.create_ae_state(
                small(cfg), cfg, jax.random.PRNGKey(cfg.seed)))
            state = jax_ae.train_auto_encoder(
                cfg, mesh=mesh_lib.make_mesh({"data": 1}))
    finally:
        jax_ae.build_ae_model, jckpt.ae_state_dict_from_variables = real
    want = {"losses": _epoch_losses(save), "steps": int(state.step),
            "files": sorted(os.listdir(save))}
    arrays = flatten_tree({"params": init.params,
                           "batch_stats": init.batch_stats}, "init/")
    arrays.update({f"want/{k}": v for k, v in _bins(
        save, EPOCHS, jckpt.load_state_dict_bin).items()})
    with open(os.path.join(job, "paths.json"), "w") as f:
        json.dump({"corpus": paths, "clean": clean}, f)
    np.savez(os.path.join(job, "in.npz"), **arrays)
    got, meta = run_child(__file__, job, timeout=600)
    shutil.rmtree(job)
    return want, got, meta


def test_trainer_from_disk_matches_jax(results):
    want, _, meta = results
    got = meta["disk"]
    assert len(want["losses"]) == len(got["losses"]) == EPOCHS
    for a, b in zip(got["losses"], want["losses"]):
        assert abs(a - b) <= LOSS_ATOL, (got["losses"], want["losses"])
    assert got["steps"] == want["steps"] == STEPS
    assert got["files"] == want["files"]
    assert got["skipped"] == EPOCHS
    assert got["cache_hits"] > 0


def test_bin_files_match_jax(results):
    """The same keys in each ``.bin``; ``fc1`` and every other tensor
    within the train-step limits of JAX's."""
    _, got, meta = results
    keys = meta["disk"]["bin_keys"]
    assert keys == meta["disk"]["want_bin_keys"]
    fc1 = "autoencoder_path/fc1.weight"
    assert fc1 in keys
    np.testing.assert_allclose(got[f"got/{fc1}"], got[f"want/{fc1}"],
                               rtol=1e-5, atol=1e-6)
    for k in keys:
        d = np.abs(got[f"got/{k}"].astype(np.float64)
                   - got[f"want/{k}"].astype(np.float64))
        assert d.max() <= 2.5 * LR * STEPS, (k, d.max())
        assert (d > 1e-6).mean() <= 1e-3 or d.size < 1000 and \
            (d > 1e-6).sum() <= 1, (k, (d > 1e-6).mean())


def test_preempt_then_resume_is_bit_equal(results):
    _, _, meta = results
    p = meta["preempt"]
    assert p["stopped_steps"] == 1 and p["ckpt"] and p["jsonl_preempted"]
    assert p["resumed_steps"] == p["full_steps"] == STEPS
    assert p["differ"] == [] and p["compared"] > 50, p["differ"][:5]


def test_keep_checkpoints_prunes_the_epoch_checkpoints(results):
    _, _, meta = results
    files = meta["prune"]["files"]
    assert [f for f in files if f.endswith(".ckpt")] == ["ae_epoch3.ckpt"]
    for epoch in (1, 2, 3):
        for name in ("autoencoder_path", "encoder", "decoder"):
            assert f"{name}_{epoch}.bin" in files
    assert "autoencoder_training_loss.png" in files or \
        not meta["prune"]["matplotlib"]
    assert "training_AE.log" in files and "ae.jsonl" in files
    assert meta["prune"]["strict_reload"] is True


def test_cli_resume_auto_finishes_the_schedule(results):
    cli = results[2]["cli"]
    assert cli["full_steps"] == cli["resumed_steps"] == 2 * EPOCHS
    assert cli["stopped_steps"] == 1 and cli["preempt_ckpt"]
    assert cli["same_weights"] is True
    assert cli["resumed_epochs"] == [1, 2]
    assert cli["help_rc"] == 0
    for flag in ("--preset", "--resume_from", "--decoded_crop_cache",
                 "--image_dir", "--device"):
        assert flag in cli["help"], flag


@pytest.mark.parametrize("knob", list(REFUSALS))
def test_later_slice_knobs_raise(results, knob):
    err = results[2]["refusals"][knob]
    if REFUSALS[knob] is None:
        assert err == "no error", err
        return
    assert err.startswith("ValueError"), err
    assert REFUSALS[knob] in err, err


@pytest.mark.parametrize("knob", list(PROFILING_KNOBS))
def test_profiling_knobs_work(results, knob):
    """``profile_steps`` 2 and ``tensorboard`` each through one epoch of
    the trainer: no error, a finite loss, and the file the knob writes."""
    run = results[2]["profiling_knobs"][knob]
    assert run["error"] == "no error", run
    assert len(run["losses"]) == 1 and np.isfinite(run["losses"][0]), run
    _, subdir, marker = PROFILING_KNOBS[knob]
    assert len([f for f in run["written"] if marker in f]) == 1, run


def _child(job):
    import torch

    from mimm_tpu_torch import checkpoint as ckpt
    from mimm_tpu_torch import preempt
    from mimm_tpu_torch.cli import uni_modal
    from mimm_tpu_torch.config import TrainingConfig
    from mimm_tpu_torch.data import crop_cache
    from mimm_tpu_torch.models.autoencoder import ResNetAE
    from mimm_tpu_torch.parallel.mesh import make_mesh
    from mimm_tpu_torch.train import ae
    from tests.test_torch_train import _error_of
    from tests.torch_port_child import unflatten_tree

    torch.backends.mkldnn.enabled = False
    with open(os.path.join(job, "paths.json")) as f:
        corpora = json.load(f)
    with np.load(os.path.join(job, "in.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    tree = unflatten_tree({k[5:]: v for k, v in arrays.items()
                           if k.startswith("init/")})
    init_weights = ckpt.ae_state_dict_from_flax(tree, **CONVERT)
    meta, out = {}, {}

    def cfg_for(save, corpus="clean", **kw):
        paths = corpora[corpus]
        return TrainingConfig(**{**CFG, **kw}, save_directory=save,
                              image_dir=paths["images"],
                              dataset_metadata=paths["metadata"],
                              decoded_crop_cache=os.path.join(job, f"cache_{corpus}"))

    real_create = ae.create_ae_state
    real_step = ae.make_ae_train_step
    caches = []
    real_from_config = crop_cache.from_config

    def keep_cache(cfg):
        caches.append(real_from_config(cfg))
        return caches[-1]

    ae.crop_cache.from_config = keep_cache
    ae.build_ae_model = lambda cfg, device="cuda": ResNetAE(
        input_shape=(cfg.img_size, cfg.img_size, cfg.output_channels),
        **SMALL, dtype=torch.float64).to(device)
    ae.create_ae_state = lambda model, cfg, generator, weights=None: \
        real_create(model, cfg, None, weights=init_weights
                    if weights is None else weights)
    stop = {"at": None}

    def step_with_stop(*a, **kw):
        step = real_step(*a, **kw)

        def run(state, images):
            state, loss = step(state, images)
            if state.step == stop["at"]:
                preempt.request()
            return state, loss
        return run

    ae.make_ae_train_step = step_with_stop

    def flat(state):
        tree = ae.ae_state_tree(state)
        out = {f"model/{k}": v for k, v in tree["model"].items()}
        for part in ("mu", "nu"):
            out.update({f"{part}/{k}": v
                        for k, v in tree["opt_state"][part].items()})
        out["count"] = tree["opt_state"]["count"]
        out["step"] = tree["step"]
        return out

    def differ(a, b):
        return sorted(k for k in set(a) | set(b) if k not in a or k not in b
                      or not (torch.equal(a[k], b[k]) if torch.is_tensor(a[k])
                              else a[k] == b[k]))

    # ---- from disk, against JAX -------------------------------------------
    save = os.path.join(job, "disk")
    disk = ae.train_auto_encoder(cfg_for(save, "corpus"), device="cpu")
    with open(os.path.join(save, "ae.jsonl")) as f:
        skipped = [json.loads(line).get("skipped_records") for line in f]
    got_bins = _bins(save, EPOCHS, lambda p: {
        k: v.numpy() for k, v in ckpt.load_state_dict_bin(p).items()})
    out.update({f"got/{k}": v for k, v in got_bins.items()})
    out.update({k: v for k, v in arrays.items() if k.startswith("want/")})
    meta["disk"] = {
        "losses": _epoch_losses(save), "steps": disk.step,
        "files": sorted(os.listdir(save)),
        "skipped": max(s for s in skipped if s is not None),
        "cache_hits": sum(c.hits for c in caches),
        "bin_keys": sorted(got_bins),
        "want_bin_keys": sorted(k[5:] for k in arrays
                                if k.startswith("want/"))}

    # ---- preempted after step 1, resumed (no unreadable record: a resumed
    # epoch substitutes zeros for one, where the full run skips it) ---------
    full = ae.train_auto_encoder(cfg_for(os.path.join(job, "full")),
                                 device="cpu")
    save = os.path.join(job, "stopped")
    stop["at"] = 1
    part = ae.train_auto_encoder(cfg_for(save), device="cpu")
    stop["at"] = None
    with open(os.path.join(save, "ae.jsonl")) as f:
        preempted = any(json.loads(line).get("preempted") == 1 for line in f)
    has_ckpt = os.path.exists(os.path.join(save, "ae_preempt.ckpt"))
    preempt.clear()
    resumed = ae.train_auto_encoder(
        cfg_for(save), resume_from=os.path.join(save, "ae_preempt.ckpt"),
        device="cpu")
    a, b = flat(full), flat(resumed)
    meta["preempt"] = {"stopped_steps": part.step, "ckpt": has_ckpt,
                       "jsonl_preempted": preempted,
                       "resumed_steps": resumed.step, "full_steps": full.step,
                       "differ": differ(a, b), "compared": len(a)}

    # ---- 3 epochs, keep_checkpoints 1 --------------------------------------
    save = os.path.join(job, "prune")
    state = ae.train_auto_encoder(cfg_for(save, num_train_epochs=3,
                                          keep_checkpoints=1), device="cpu")
    fresh = ae.build_ae_model(cfg_for(save), device="cpu")
    ckpt.load_ae_from_bins(fresh, save, 3)
    try:
        import matplotlib  # noqa: F401
        has_mpl = True
    except ImportError:
        has_mpl = False
    meta["prune"] = {"files": sorted(os.listdir(save)), "matplotlib": has_mpl,
                     "strict_reload": all(
                         torch.equal(x, y) for x, y in zip(
                             fresh.state_dict().values(),
                             state.model.state_dict().values()))}

    # ---- the entry point ------------------------------------------------------
    flags = ["--device", "cpu", "--image_dir", corpora["clean"]["images"],
             "--dataset_metadata", corpora["clean"]["metadata"],
             "--decoded_crop_cache", os.path.join(job, "cache_clean"),
             *(x for k, v in CFG.items() for x in (f"--{k}", str(v)))]
    cli_full = uni_modal.main(flags + ["--save_directory",
                                       os.path.join(job, "cli_full")])
    save = os.path.join(job, "cli_stopped")
    stop["at"] = 1
    cli_part = uni_modal.main(flags + ["--save_directory", save])
    stop["at"] = None
    has_ckpt = os.path.exists(os.path.join(save, "ae_preempt.ckpt"))
    preempt.clear()          # a new process would start without the flag
    cli_res = uni_modal.main(flags + ["--save_directory", save,
                                      "--resume_from", "auto"])
    preempt.uninstall()
    proc = subprocess.run([sys.executable, "-m", "mimm_tpu_torch.cli.uni_modal",
                           "--help"], capture_output=True, text=True,
                          timeout=120)
    meta["cli"] = {"full_steps": cli_full.step, "stopped_steps": cli_part.step,
                   "preempt_ckpt": has_ckpt, "resumed_steps": cli_res.step,
                   "resumed_epochs": [r["epoch"] for r in (
                       json.loads(line) for line in open(os.path.join(
                           save, "ae.jsonl"))) if "epoch_loss" in r],
                   "same_weights": differ(flat(cli_full), flat(cli_res)) == [],
                   "help_rc": proc.returncode, "help": proc.stdout}

    # ---- refusals ------------------------------------------------------------
    cfg = cfg_for(os.path.join(job, "refused"))
    refusals = {knob: _error_of(lambda k=knob, v=v: ae.train_auto_encoder(
        cfg.replace(**{k: v}), device="cpu"))
        for knob, v in (("mesh_shape", (("data", 1), ("pipe", 2))),
                        ("zero1_optimizer_sharding", True),
                        ("fsdp_parameter_sharding", True),
                        ("checkpoint_format", "orbax"))}
    refusals["bn_axis_name"] = _error_of(
        lambda: ResNetAE(bn_axis_name="data"))
    refusals["step_mesh"] = _error_of(lambda: real_step(
        ResNetAE(**SMALL), ae._ae_tx(cfg),
        mesh=make_mesh({"data": 1, "model": 1})))
    meta["refusals"] = refusals
    meta["profiling_knobs"] = {}
    for knob, (value, subdir, _) in PROFILING_KNOBS.items():
        save = os.path.join(job, f"knob_{knob}")
        err = _error_of(lambda: ae.train_auto_encoder(
            cfg_for(save, num_train_epochs=1, **{knob: value}),
            device="cpu"))
        subdir = os.path.join(save, subdir)
        meta["profiling_knobs"][knob] = {
            "error": err, "losses": _epoch_losses(save),
            "written": sorted(os.listdir(subdir))
            if os.path.isdir(subdir) else []}
    np.savez(os.path.join(job, "out.npz"), **out)
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    _child(sys.argv[1])
