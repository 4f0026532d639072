"""The port's ETL and host CLI (mimm_tpu_torch/data/etl.py,
cli/dataset_populate.py, cli/prebuild_cache.py, tools/corpus_check.py)
against the JAX package's over the same seeded, synthesized inputs.

The parent writes a MIMIC-CXR-like tree (two subfolders; metadata and
NegBio labels as ``.csv.gz``; reports with and without a FINDINGS:
section, with an IMPRESSION: or none, with header lines holding colons,
and some with nothing left to extract; most dicoms with an image file), a
directory of 16-bit PNGs with one junk file, and JAX's deliberate-
corruption corpus.  Each side gets its own copy: the JAX functions run in
the pytest worker, the port's in a jax-free child
(tests/torch_port_child.py), each function and then the CLI's stages.
The files they write must be equal byte for byte (a ``.gz`` file by its
contents: gzip stamps the write time in its header); the crop cache's
windows and geometry equal, with the same summary counts, the resume's
included; the corruption counts equal.  The port's
``download_full_dataset(download=False)`` must never call
``subprocess.run``.
"""

import gzip
import json
import os
import shutil
import sys

import numpy as np
import pytest

DISEASES = ("Atelectasis", "Cardiomegaly", "Edema", "Pneumonia")
WORDS = ("the", "heart", "size", "is", "normal", "no", "focal", "effusion",
         "lungs", "are", "clear", "mild", "cardiomegaly", "left", "lower",
         "lobe", "opacity", "tube", "in", "place")
STUDIES = 120
SUBFOLDERS = ("p10", "p11")
# the files the ETL writes, relative to its root
OUTPUTS = ("full_data_set/text/data_subfolder_p10.tsv",
           "full_data_set/text/data_subfolder_p11.tsv",
           "training_data/text/all_data.tsv",
           "training_data/text/training_data.tsv",
           "testing_data/text/testing_data.tsv",
           "training_data/training_label_negbio.csv",
           "testing_data/testing_label_negbio.csv",
           "training_data/disease_stats.csv",
           "testing_data/disease_stats.csv",
           "repair/all_data.tsv")
PNG_IDS = ("p10/a.png", "p10/b.png", "p11/c.png")


def write_tree(root: str, studies: int = STUDIES, seed: int = 0) -> None:
    """The MIMIC-like tree under ``root`` (DatasetConfig's layout)."""
    rng = np.random.default_rng(seed)
    full = os.path.join(root, "full_data_set")

    def sentence():
        return " ".join(rng.choice(WORDS, int(rng.integers(3, 9)))) \
            .capitalize() + "."

    meta = ["dicom_id,subject_id,study_id,"
            "PerformedProcedureStepDescription,ViewPosition"]
    labels = ["subject_id,study_id," + ",".join(DISEASES)]
    for i in range(studies):
        sub = SUBFOLDERS[i % 2]
        subject, study = f"{sub[1:]}{i:06d}", str(50000000 + i)
        for v in range(int(rng.integers(1, 4))):
            dicom = f"{i:08x}-{v}"
            view = ("PA", "AP", "LATERAL")[int(rng.integers(0, 3))]
            meta.append(f"{dicom},{subject},{study},CHEST,{view}")
            if rng.random() < 0.85:
                img = os.path.join(full, "images", sub,
                                   f"p{subject}_s{study}_{dicom}.jpg")
                os.makedirs(os.path.dirname(img), exist_ok=True)
                open(img, "wb").close()
        lines = ["FINAL REPORT", f"EXAMINATION: CHEST (PA AND LAT) {i}",
                 f"INDICATION: {sentence()}", ""]
        kind = i % 5
        if kind == 0:       # FINDINGS and IMPRESSION sections
            lines += ["FINDINGS: " + sentence(), sentence(), "",
                      "IMPRESSION:", sentence(), "Note: " + sentence()]
        elif kind == 1:     # paragraphs, a colon inside one
            lines += [sentence(), "", f"COMPARISON: {sentence()}",
                      sentence()]
        elif kind == 2:     # a paragraph, then an IMPRESSION
            lines += [sentence(), "", "IMPRESSION: " + sentence()]
        elif kind == 3:     # FINDINGS: alone on its line
            lines += ["FINDINGS:", sentence(), "time: 10:30 " + sentence()]
        # kind 4: headers only, nothing left to extract
        path = os.path.join(full, "text", sub, f"s{study}.txt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        cells = rng.choice(["1.0", "0.0", "-1.0", ""], len(DISEASES),
                           p=[0.3, 0.4, 0.1, 0.2])
        labels.append(f"{subject},{study}," + ",".join(cells))
    for name, rows in (("mimic-cxr-2.0.0-metadata.csv.gz", meta),
                       ("mimic-cxr-2.0.0-negbio.csv.gz", labels)):
        with gzip.open(os.path.join(full, name), "wt") as f:
            f.write("\n".join(rows) + "\n")
    # a label table naming one study that no report has
    with open(os.path.join(root, "labels.csv"), "w") as f:
        f.write("mimic_id,Atelectasis\n"
                "p10/p10000000_s50000000_a.jpg,1.0\n"
                "p10/p10999999_s31415926_b.jpg,0.0\n")


def dataset_config(root: str) -> dict:
    full = os.path.join(root, "full_data_set")
    cfg = {"data_dir": full, "image_storage_dir": os.path.join(full, "images"),
           "text_storage_dir": os.path.join(full, "text")}
    for k in ("training", "testing"):
        d = os.path.join(root, f"{k}_data")
        cfg.update({f"{k}_data_dir": d,
                    f"{k}_image_dir": os.path.join(d, "images"),
                    f"{k}_text_dir": os.path.join(d, "text"),
                    f"{k}_dataset_labeldata": os.path.join(
                        d, f"{k}_label_negbio.csv")})
    return cfg


def run_etl(etl, config_cls, root: str) -> dict:
    """Each ETL function over ``root`` (the same calls on either side);
    returns what they return."""
    cfg = config_cls(**dataset_config(root))
    full = cfg.data_dir
    out = {"reports": {}}
    for sub in SUBFOLDERS:
        d = os.path.join(cfg.text_storage_dir, sub)
        for name in sorted(os.listdir(d)):
            with open(os.path.join(d, name)) as f:
                out["reports"][name] = etl.extract_report_text(f.read())
    meta = os.path.join(full, "mimic-cxr-2.0.0-metadata.csv.gz")
    out["select"] = {sub: etl.select_studies(meta, sub) for sub in SUBFOLDERS}
    out["metadata_rows"] = len(list(etl.iter_metadata(meta)))
    synth = etl.synthesize_metadata_from_images(
        cfg.image_storage_dir, os.path.join(root, "synth", "meta.csv.gz"))
    with gzip.open(synth, "rt") as f:
        out["synthesized"] = f.read()
    out["tsv"] = [os.path.relpath(etl.download_full_dataset(cfg, sub), root)
                  for sub in SUBFOLDERS]
    etl.populate_all_data(cfg, ["p10"], out_dir=os.path.join(root, "repair"))
    out["repaired"] = etl.repair_all_data_from_subfolder(
        cfg, "p11", out_dir=os.path.join(root, "repair"))
    out["repaired_again"] = etl.repair_all_data_from_subfolder(
        cfg, "p11", out_dir=os.path.join(root, "repair"))
    all_data = etl.populate_all_data(cfg, list(SUBFOLDERS))
    out["missing"] = etl.find_missing_label_studies(
        all_data, os.path.join(root, "labels.csv"))
    etl.populate_subset_dataset(cfg, seed=0)
    out["stats"] = {d: list(etl.read_disease_stats(os.path.join(
        cfg.training_data_dir, "disease_stats.csv"), d)) for d in DISEASES}
    return out


def cli_argv(root: str) -> list:
    return [a for k, v in dataset_config(root).items()
            for a in (f"--{k}", v)] + ["--subfolders", ",".join(SUBFOLDERS)]


def run_prebuild(main, root: str) -> dict:
    """The build, a resume after deleting one entry, and every entry's
    window and geometry."""
    from contextlib import redirect_stdout
    import io

    argv = ["--image_dir", os.path.join(root, "pngs"), "--cache_dir",
            os.path.join(root, "cache"), "--img_size", "64",
            "--report_every", "0", "--workers", "2"]
    out = {}
    for run in ("first", "resume"):
        if run == "resume":
            os.remove(os.path.join(root, "cache", "p10", "a.png.w64.npz"))
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = main(argv)
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        out[run] = {"rc": rc, **{k: summary[k] for k in (
            "total", "built", "skipped_valid", "unreadable")}}
    for img_id in PNG_IDS:
        with np.load(os.path.join(root, "cache", f"{img_id}.w64.npz")) as z:
            out[img_id] = {"win": z["win"], "meta": z["meta"]}
    return out


def run_corpus_check(sweep, dataset_cls, features_cls, root: str) -> dict:
    """JAX's deliberate-corruption case: one good record, one corrupt
    image, one study without tokens."""
    L = 8
    tokens = features_cls(report_ids=np.array(["100", "200"]),
                          input_ids=np.ones((2, L), np.int32),
                          input_mask=np.ones((2, L), np.int32),
                          segment_ids=np.zeros((2, L), np.int32),
                          label_ids=np.zeros(2, np.int32))
    ds = dataset_cls(tokens, os.path.join(root, "corrupt"),
                     os.path.join(root, "corrupt", "meta.csv"), img_size=64)
    return sweep(ds)


def _write_inputs(root: str) -> None:
    import cv2

    write_tree(root)
    rng = np.random.default_rng(1)
    for img_id in PNG_IDS:
        path = os.path.join(root, "pngs", img_id)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        cv2.imwrite(path, rng.integers(0, 4096, (300, 320), np.uint16))
    with open(os.path.join(root, "pngs", "p11", "junk.png"), "w") as f:
        f.write("not a png")
    corrupt = os.path.join(root, "corrupt")
    os.makedirs(corrupt)
    cv2.imwrite(os.path.join(corrupt, "p1_s100_a.png"),
                rng.integers(0, 256, (80, 90), np.uint8))
    with open(os.path.join(corrupt, "p2_s200_b.png"), "w") as f:
        f.write("NOT AN IMAGE")
    shutil.copy(os.path.join(corrupt, "p1_s100_a.png"),
                os.path.join(corrupt, "p3_s300_c.png"))
    with open(os.path.join(corrupt, "meta.csv"), "w") as f:
        f.write("mimic_id,Atelectasis\n" + "".join(
            f"{n},1.0\n" for n in ("p1_s100_a.png", "p2_s200_b.png",
                                   "p3_s300_c.png")))


def _tree_files(root: str) -> dict:
    """{relpath: bytes} of every file under ``root`` (a .gz file by its
    contents)."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            opener = gzip.open if name.endswith(".gz") else open
            with opener(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from cli import dataset_populate, prebuild_cache
    from mimm_tpu.config import DatasetConfig
    from mimm_tpu.data import etl
    from mimm_tpu.data.features import TokenFeatureSet
    from mimm_tpu.data.pipeline import CXRImageReportDataset
    from tests.torch_port_child import finish_child, remove_job, start_child

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from corpus_check import sweep_dataset

    job = str(tmp_path_factory.mktemp("etl"))
    inputs = os.path.join(job, "inputs")
    _write_inputs(inputs)
    for side in ("jax", "port"):
        for run in ("etl", "cli"):
            shutil.copytree(inputs, os.path.join(job, side, run))
    proc = start_child(__file__, job)
    root = os.path.join(job, "jax")
    want = {"etl": run_etl(etl, DatasetConfig, os.path.join(root, "etl"))}
    for stage in ("download", "merge", "populate", "stats"):
        sys.argv = ["dataset_populate", "--stage", stage,
                    *cli_argv(os.path.join(root, "cli"))]
        dataset_populate.main()
    want["prebuild"] = run_prebuild(prebuild_cache.main,
                                    os.path.join(root, "etl"))
    want["corpus"] = run_corpus_check(sweep_dataset, CXRImageReportDataset,
                                      TokenFeatureSet,
                                      os.path.join(root, "etl"))
    _, meta = finish_child(proc, job, timeout=240)
    trees = {(side, run): _tree_files(os.path.join(job, side, run))
             for side in ("jax", "port") for run in ("etl", "cli")}
    with np.load(os.path.join(job, "windows.npz")) as z:
        windows = {k: z[k] for k in z.files}
    yield want, meta, trees, windows
    remove_job(job)


def test_extract_report_text_matches_jax(results):
    want, meta, _, _ = results
    got, ref = meta["etl"]["reports"], want["etl"]["reports"]
    assert got == ref
    # reports with text and reports with nothing left to extract
    assert 0 < sum(not t for t in ref.values()) < len(ref)


@pytest.mark.parametrize("key", ["select", "metadata_rows", "synthesized",
                                 "tsv", "repaired", "repaired_again",
                                 "missing", "stats"])
def test_etl_function_matches_jax(results, key):
    want, meta, _, _ = results
    ref = json.loads(json.dumps(want["etl"][key]))      # tuples as lists
    assert meta["etl"][key] == ref


def test_etl_found_the_planted_cases(results):
    want, _, _, _ = results
    assert want["etl"]["missing"] == ["31415926"]
    assert want["etl"]["repaired"] > 0 and want["etl"]["repaired_again"] == 0


@pytest.mark.parametrize("run,path", [
    (run, path) for run in ("etl", "cli") for path in OUTPUTS
    if run == "etl" or not path.startswith("repair/")])  # no CLI stage
def test_written_file_equals_jax(results, run, path):
    _, _, trees, _ = results
    got, ref = trees["port", run], trees["jax", run]
    assert path in ref and path in got
    assert got[path] == ref[path]


@pytest.mark.parametrize("run", ["etl", "cli"])
def test_whole_tree_equals_jax(results, run):
    """Every file either side wrote or kept, the cache's entries aside
    (their .npz zip headers carry write times; the windows are compared
    below)."""
    _, _, trees, _ = results
    keep = lambda t: {k: v for k, v in t.items() if not k.startswith(
        "cache" + os.sep)}
    got, ref = keep(trees["port", run]), keep(trees["jax", run])
    assert sorted(got) == sorted(ref)
    assert [k for k in ref if got[k] != ref[k]] == []


def test_download_without_fetch_never_runs_a_command(results):
    _, meta, _, _ = results
    assert meta["subprocess_calls"] == 0


@pytest.mark.parametrize("run", ["first", "resume"])
def test_prebuild_cache_counts_match_jax(results, run):
    want, meta, _, _ = results
    assert meta["prebuild"][run] == want["prebuild"][run]
    assert want["prebuild"][run]["unreadable"] == 1
    assert want["prebuild"]["resume"]["skipped_valid"] == 2


@pytest.mark.parametrize("img_id", PNG_IDS)
def test_prebuild_cache_windows_match_jax(results, img_id):
    want, _, _, windows = results
    ref = want["prebuild"][img_id]
    assert windows[f"{img_id}/win"].dtype == ref["win"].dtype == np.uint16
    np.testing.assert_array_equal(windows[f"{img_id}/win"], ref["win"])
    np.testing.assert_array_equal(windows[f"{img_id}/meta"], ref["meta"])


def test_corpus_check_counts_match_jax(results):
    want, meta, _, _ = results
    assert meta["corpus"] == want["corpus"]
    assert want["corpus"]["broken"] == 2 and \
        set(want["corpus"]["broken_ids"]) == {"200", "300"}


# ---- port side (jax-free child) ------------------------------------------

def _child(job):
    import subprocess

    from mimm_tpu_torch.cli import dataset_populate, prebuild_cache
    from mimm_tpu_torch.config import DatasetConfig
    from mimm_tpu_torch.data import etl
    from mimm_tpu_torch.data.features import TokenFeatureSet
    from mimm_tpu_torch.data.pipeline import CXRImageReportDataset
    from mimm_tpu_torch.tools.corpus_check import sweep_dataset

    calls = []
    real_run = subprocess.run
    subprocess.run = lambda *a, **k: calls.append(a) or real_run(*a, **k)
    root = os.path.join(job, "port")
    meta = {"etl": run_etl(etl, DatasetConfig, os.path.join(root, "etl"))}
    meta["subprocess_calls"] = len(calls)
    subprocess.run = real_run
    for stage in ("download", "merge", "populate", "stats"):
        dataset_populate.main(["--stage", stage,
                               *cli_argv(os.path.join(root, "cli"))])
    pre = run_prebuild(prebuild_cache.main, os.path.join(root, "etl"))
    meta["prebuild"] = {k: pre[k] for k in ("first", "resume")}
    meta["corpus"] = run_corpus_check(sweep_dataset, CXRImageReportDataset,
                                      TokenFeatureSet,
                                      os.path.join(root, "etl"))
    np.savez(os.path.join(job, "windows.npz"), **{
        f"{img_id}/{k}": pre[img_id][k] for img_id in PNG_IDS
        for k in ("win", "meta")})
    np.savez(os.path.join(job, "out.npz"))
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    _child(sys.argv[1])
