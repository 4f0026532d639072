"""The UM classifier on labels that follow the images: does the port's
``train_image_classifier`` call the classes JAX's calls?

Phase 14 of chip_smoke.py trains the UM classifier (the autoencoder's
768-wide embedding, the reference MLP of DEFAULT_CLASSIFIER_LAYERS with
dropout 0.2, Adam at the default 1e-4, B=64, 4 epochs) on windows whose
brightness sets the label, and the classifier reaches AUC 1.0 yet calls
one class.  Here JAX's ``cli/multi_modal.py`` ``train_image_classifier``
and the port's run that configuration in float32 over the same
synthesized crop-cache windows (512 studies of 32 px, 32 windows in two
brightness clusters, Pneumonia positive below the median brightness),
each embedding them with a small ResNetAE (3 levels, bottleneck 768) on
the same random weights.  Each side's classes are read from its last
epoch's validation tallies and from its final MLP's eval-mode
probabilities over every study; the same run at dropout 0 and at 10 x
the learning rate tells what moves them.  Both sides call one class in
phase 14's configuration, with dropout or without: 32 Adam steps at 1e-4
leave the 8-layer MLP's outputs in a band a few hundredths wide on the
side of 0.5 its initial draw put them on, ranked right (AUC 1.0) but not
yet across 0.5; at 1e-3 both sides call both classes.  JAX runs in the
pytest worker, the port in a jax-free child.
"""

import json
import os
import sys

import numpy as np
import pytest

IMG, STUDIES, WINDOWS, SOURCE = 32, 512, 32, (150, 160)
AE = dict(n_residual_blocks=1, n_levels=3, z_dim=16, bottleneck_dim=768)
CONVERT = dict(n_levels=3, n_res=1, z_dim=16)
CFG = dict(batch_size=64, seed=0, img_size=IMG, compute_dtype="float32",
           data_loader_workers=0, prefetch=1, compact_transfer=True,
           disease_label="Pneumonia", num_train_epochs_classifier=4)
# the phase-14 run, and the two that tell what moves its classes
ARMS = {"phase14": {}, "dropout0": {"dropout": 0.0},
        "lr1e-3": {"init_lr": 1e-3}}
# the width of the eval outputs' band at the default learning rate (both
# sides measure 0.01-0.04 over every study)
BAND = 0.1


def write_corpus(root: str, support_window) -> dict:
    """Crop-cache windows in two brightness clusters (the cache's layout:
    ``win`` and ``meta`` = [oy, ox, h, w, version 1]), one entry a study,
    and ``disease_stats.csv``: Pneumonia positive below the median
    brightness."""
    rng = np.random.default_rng(5)
    cache = os.path.join(root, "cache")
    for d in (cache, os.path.join(root, "images")):
        os.makedirs(d, exist_ok=True)
    h, w = SOURCE
    oy, ox, wh, ww = support_window(h, w, IMG)
    wins, bright = [], []
    amps = rng.permutation(np.linspace(32, 96, WINDOWS).round().astype(int))
    stripes = rng.permutation(np.concatenate([
        np.zeros(WINDOWS // 2), np.linspace(0.4, 0.6, WINDOWS // 2)]))
    for amp, share in zip(amps, stripes):
        win = (255 - rng.integers(0, amp + 1, (wh, ww))).astype(np.uint8)
        win[:, np.arange(ww) % 8 < round(8 * share)] = 0
        wins.append(win)
        bright.append(win.mean() / win.max())
    rows = [f"p{30000000 + i}_s{70000000 + i}_{i:08x}.jpg"
            for i in range(STUDIES)]
    for i, img_id in enumerate(rows):
        np.savez(os.path.join(cache, f"{img_id}.w{IMG}.npz"),
                 win=wins[i % WINDOWS],
                 meta=np.array([oy, ox, h, w, 1], np.int64))
    meta = os.path.join(root, "metadata.csv")
    with open(meta, "w") as f:
        f.write("mimic_id\n" + "".join(f"{r}\n" for r in rows))
    b = np.array([bright[i % WINDOWS] for i in range(STUDIES)])
    pos = b < np.median(b)
    ids = [r.split("_")[1][1:] for r in rows]
    stats = os.path.join(root, "disease_stats.csv")
    p = [s for s, x in zip(ids, pos) if x]
    n = [s for s, x in zip(ids, pos) if not x]
    with open(stats, "w") as f:
        f.write(f"Pneumonia,{len(p)},\"{p}\"\nPneumonia_negative,{len(n)},"
                f"\"{n}\"\n")
    return {"image_dir": os.path.join(root, "images"),
            "dataset_metadata": meta, "dataset_disease_stats": stats,
            "decoded_crop_cache": cache}


def classes(save: str, probs: np.ndarray, labels: np.ndarray) -> dict:
    """What a run called: its last epoch's validation tallies, and over
    every study the eval-mode probabilities' range, the classes above and
    below 0.5, and the AUC of the labels."""
    with open(os.path.join(save, "classifier_Pneumonia.jsonl")) as f:
        last = [r for r in map(json.loads, f) if "val_acc" in r][-1]
    order = np.argsort(probs, kind="stable")
    ranks = np.empty(len(probs))
    ranks[order] = np.arange(1, len(probs) + 1)
    npos = int(labels.sum())
    auc = (ranks[labels == 1].sum() - npos * (npos + 1) / 2) / (
        npos * (len(labels) - npos))
    return {"val_called_pos": last["tp"] + last["fp"],
            "val_called_neg": last["tn"] + last["fn"],
            "called_pos": int((probs > 0.5).sum()),
            "called_neg": int((probs <= 0.5).sum()),
            "min": float(probs.min()), "max": float(probs.max()),
            "auc": float(auc)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from cli.multi_modal import train_image_classifier
    from mimm_tpu.config import DEFAULT_CLASSIFIER_LAYERS, TrainingConfig
    from mimm_tpu.data import crop_cache
    from mimm_tpu.data.pipeline import CXRImageDiseaseDataset
    from mimm_tpu.models.autoencoder import ResNetAE
    from mimm_tpu.train import classifier as jclf
    from tests.test_torch_classifier import random_variables
    from tests.torch_port_child import (finish_child, flatten_tree,
                                        remove_job, start_child)

    job = str(tmp_path_factory.mktemp("um"))
    paths = write_corpus(job, crop_cache.support_window)
    ae = ResNetAE(input_shape=(IMG, IMG, 1), **AE)
    variables = jax.tree.map(lambda a: np.asarray(a, np.float32),
                             random_variables(ae, (1, IMG, IMG, 1), 1))
    np.savez(os.path.join(job, "in.npz"), **flatten_tree(variables, "ae/"))
    with open(os.path.join(job, "paths.json"), "w") as f:
        json.dump(paths, f)
    proc = start_child(__file__, job)

    embed = jclf.make_embedding_fn("unimodal", ae, variables)
    ds = CXRImageDiseaseDataset(paths["image_dir"], paths["dataset_metadata"],
                                "Pneumonia", paths["dataset_disease_stats"],
                                img_size=IMG, crop_cache=crop_cache
                                .DecodedCropCache(paths["decoded_crop_cache"],
                                                  IMG))
    emb = np.concatenate([np.asarray(embed(jnp.asarray(np.stack(
        [ds.load(i, None, train=False)["image"]
         for i in range(lo, min(lo + 64, len(ds)))]))))
        for lo in range(0, len(ds), 64)])
    labels = np.asarray(ds.labels)
    want = {}
    real = jclf.BasicMLP
    for arm, kw in ARMS.items():
        save = os.path.join(job, "jax", arm)
        os.makedirs(save)
        cfg = TrainingConfig(**CFG, **paths, save_directory=save).replace(
            **{k: v for k, v in kw.items() if k != "dropout"})
        rate = kw.get("dropout", 0.2)
        jclf.BasicMLP = lambda i, h, o=1, d=0.2: real(i, h, o, rate)
        try:
            state, _, _ = train_image_classifier(
                cfg, embed, list(DEFAULT_CLASSIFIER_LAYERS))
        finally:
            jclf.BasicMLP = real
        mlp = real(768, list(DEFAULT_CLASSIFIER_LAYERS))
        probs = np.asarray(jclf.make_predict(mlp)(state.params,
                                                  jnp.asarray(emb)))
        want[arm] = classes(save, probs, labels)
    _, got = finish_child(proc, job, timeout=400)
    yield want, got
    remove_job(job)


def _one_class(r: dict) -> bool:
    return min(r["called_pos"], r["called_neg"]) == 0 and \
        min(r["val_called_pos"], r["val_called_neg"]) == 0


@pytest.mark.parametrize("arm", ARMS)
def test_both_rank_the_studies(results, arm):
    """The labels follow the images: both sides' outputs rank them."""
    want, got = results
    assert want[arm]["auc"] > 0.9 and got[arm]["auc"] > 0.9


@pytest.mark.parametrize("arm", ["phase14", "dropout0"])
def test_both_call_one_class_at_the_default_lr(results, arm):
    """Phase 14's configuration, with its dropout or without: on both
    sides the eval outputs sit in a band narrower than BAND on one side
    of 0.5 (the side each one's initial draw put them on), so each calls
    one class: the port does what JAX does, and dropout is not why."""
    want, got = results
    for side in (want[arm], got[arm]):
        assert side["max"] - side["min"] < BAND, side
        assert _one_class(side), side


def test_ten_times_the_lr_calls_both_classes(results):
    """The same run at 10 x the learning rate moves the outputs across
    0.5 on both sides: each calls both classes, on its validation split
    and over every study."""
    want, got = results
    for side in (want["lr1e-3"], got["lr1e-3"]):
        assert min(side["called_pos"], side["called_neg"]) > 0, side
        assert min(side["val_called_pos"], side["val_called_neg"]) > 0, side


# ---- port side (jax-free child) ------------------------------------------

def _child(job):
    import torch

    from mimm_tpu_torch import checkpoint as ckpt
    from mimm_tpu_torch.cli.multi_modal import train_image_classifier
    from mimm_tpu_torch.config import (DEFAULT_CLASSIFIER_LAYERS,
                                       TrainingConfig)
    from mimm_tpu_torch.data import crop_cache
    from mimm_tpu_torch.data.pipeline import CXRImageDiseaseDataset
    from mimm_tpu_torch.models.autoencoder import ResNetAE
    from mimm_tpu_torch.train import classifier as clf
    from tests.torch_port_child import unflatten_tree

    torch.backends.mkldnn.enabled = False
    with np.load(os.path.join(job, "in.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(job, "paths.json")) as f:
        paths = json.load(f)
    ae_sd = ckpt.ae_state_dict_from_flax(
        unflatten_tree({k[3:]: v for k, v in arrays.items()
                        if k.startswith("ae/")}), **CONVERT)
    embed = clf.make_embedding_fn(
        "unimodal", ResNetAE(input_shape=(IMG, IMG, 1), **AE), ae_sd)
    ds = CXRImageDiseaseDataset(
        paths["image_dir"], paths["dataset_metadata"], "Pneumonia",
        paths["dataset_disease_stats"], img_size=IMG,
        crop_cache=crop_cache.DecodedCropCache(paths["decoded_crop_cache"],
                                               IMG))
    with torch.no_grad():
        emb = torch.cat([embed(torch.from_numpy(np.stack(
            [ds.load(i, None, train=False)["image"]
             for i in range(lo, min(lo + 64, len(ds)))])))
            for lo in range(0, len(ds), 64)])
    labels = np.asarray(ds.labels)
    out = {}
    real = clf.BasicMLP
    for arm, kw in ARMS.items():
        save = os.path.join(job, "port", arm)
        cfg = TrainingConfig(**CFG, **paths, save_directory=save).replace(
            **{k: v for k, v in kw.items() if k != "dropout"})
        rate = kw.get("dropout", 0.2)
        clf.BasicMLP = lambda i, h, o=1, d=0.2: real(i, h, o, rate)
        try:
            state, _, _ = train_image_classifier(
                cfg, embed, list(DEFAULT_CLASSIFIER_LAYERS), device="cpu")
        finally:
            clf.BasicMLP = real
        with torch.no_grad():
            probs = clf.make_predict(state.model)(emb).numpy()
        out[arm] = classes(save, probs, labels)
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(out, f)
    np.savez(os.path.join(job, "out.npz"))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    _child(sys.argv[1])
