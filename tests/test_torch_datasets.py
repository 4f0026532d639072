"""The port's on-disk data (mimm_tpu_torch/data/{features,transforms,
crop_cache,pipeline,etl}.py, utils.py) against the JAX package's, on files
both read.

* A corpus synthesized here: PNGs written with cv2 (uint8 and 12-bit
  uint16, non-square, sides above and below ``img_size``), one file cv2
  cannot read, one study whose report is missing from the token set, a
  metadata CSV of ``mimic_id`` paths, ``disease_stats.csv``, a report TSV
  in the reference's layout and a vocabulary.
* All three datasets (``CXRImageDataset``, ``CXRImageReportDataset``,
  ``CXRImageDiseaseDataset``) give JAX's samples bit for bit, sample by
  sample with the loader's generators, with and without the crop cache,
  in train and eval, with ``compact`` on and off.  The port reads with the
  cache twice: over a fresh directory (every read a miss that builds the
  entry) and over the directory JAX's ``DecodedCropCache`` wrote, where
  every readable image is a hit.
* The token caches cross both ways: the port loads the
  ``cachedfeatures_train_seqlen-<L>.npz`` JAX wrote and JAX the one the
  port wrote, and the port's ``load_and_cache_examples`` (a forked pool of
  two) gives JAX's arrays over the same TSV and vocabulary.
* ``read_disease_stats`` and ``MimicID`` give JAX's answers.

The JAX side runs in the pytest worker, the port side in a jax-free child
(tests/torch_port_child.py).  Other port test files build their corpora
with ``write_corpus``.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

IMG = 64
SEQ = 24
SEED = 7
WORDS = ("opacity", "effusion", "pleural", "left", "right", "lower", "lobe",
         "no", "acute", "cardiopulmonary", "process", "heart", "size",
         "normal", "mild", "edema", "pneumothorax", "is", "seen", "the")
# a non-square image above img_size, one below, one straddling, per dtype
SIZES = ((80, 100), (50, 70), (64, 90), (96, 40))
DISEASE = "Pneumonia"
# (crop cache, train, compact)
CASES = {f"{'cache' if c else 'decode'}_{'train' if t else 'eval'}_"
         f"{'compact' if k else 'wide'}": (c, t, k)
         for c in (False, True) for t in (True, False) for k in (True, False)}


def write_vocab(path: str, words=WORDS, size: int = 0) -> list:
    """A BERT vocabulary: the specials, ``words``, a few wordpieces and,
    up to ``size`` entries, filler tokens.  Returns the list."""
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ".", ",", ":",
             *words, "##s", "##ed", "cardio", "##pulmonary", "1", "2"]
    vocab += [f"w{i:05d}" for i in range(max(0, size - len(vocab)))]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    return vocab


def write_corpus(root: str, n: int, img_size: int, seed: int,
                 sizes=SIZES, bad=(), missing=(), lengths=None,
                 words=WORDS, decorate=True) -> dict:
    """``n`` image-report pairs under ``root``: ``images/<mimic_id>.png``
    (cv2; even rows uint8, odd rows uint16 below 2^12), ``metadata.csv``
    (``mimic_id``), ``text/all_data.tsv`` (index, label, study id, image,
    report) and ``bert/vocab.txt``.  Rows in ``bad`` get a file cv2 cannot
    read; rows in ``missing`` get no report.  ``lengths``: each report's
    word count (default 3..30), each word one token; ``decorate`` adds
    capitals, punctuation and an unknown word to every third report.
    Returns the paths."""
    import cv2

    rng = np.random.default_rng(seed)
    paths = {k: os.path.join(root, k) for k in ("images", "text", "bert")}
    for p in paths.values():
        os.makedirs(p, exist_ok=True)
    write_vocab(os.path.join(paths["bert"], "vocab.txt"), words)
    rows, reports = [], []
    for i in range(n):
        study = 50000 + 7 * i
        img_id = f"p{1000 + i}_s{study}_d{i:04d}.png"
        path = os.path.join(paths["images"], img_id)
        if i in bad:
            with open(path, "wb") as f:
                f.write(b"not an image")
        else:
            h, w = sizes[i % len(sizes)]
            hi, dt = (256, np.uint8) if i % 2 == 0 else (4096, np.uint16)
            assert cv2.imwrite(path, rng.integers(0, hi, (h, w)).astype(dt))
        rows.append(img_id)
        if i in missing:
            continue
        count = int(lengths[i]) if lengths is not None \
            else int(rng.integers(3, 31))
        text = " ".join(str(rng.choice(words)) for _ in range(count))
        if decorate and i % 3 == 0:
            text = text.capitalize() + ", Opacities: NONE. xyzzy"
        reports.append(f"{i}\t{['0', '1', '2', '3', '-1'][i % 5]}\t{study}\t"
                       f"{img_id}\t{text}")
    paths["metadata"] = os.path.join(root, "metadata.csv")
    with open(paths["metadata"], "w") as f:
        f.write("mimic_id,label\n" + "".join(f"{r},{i % 2}\n"
                                             for i, r in enumerate(rows)))
    with open(os.path.join(paths["text"], "all_data.tsv"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(reports) + "\n")
    paths["rows"] = rows
    return paths


def _disease_stats(root: str, rows: list) -> str:
    """Positives: every third study from the first; negatives: every third
    from the third, less the last (the unreadable row 5 among them); the
    counts cap the rows read."""
    studies = [r.split("_")[1][1:] for r in rows]
    pos, neg = studies[::3], studies[2::3][:-1]
    path = os.path.join(root, "disease_stats.csv")
    with open(path, "w") as f:
        f.write(f"{DISEASE},{len(pos)},\"{pos}\"\n"
                f"{DISEASE}_negative,{len(neg)},\"{neg}\"\n"
                f"Edema,0,\n")
    return path


def build_datasets(pipeline, crop_cache, paths, features, stats, cache_dir,
                   case):
    """The three datasets of ``case`` over ``paths`` (``pipeline`` and
    ``crop_cache``: either package's modules)."""
    use_cache, _, compact = CASES[case]
    cache = crop_cache.DecodedCropCache(cache_dir, IMG) if use_cache else None
    kw = dict(img_size=IMG, compact=compact, crop_cache=cache)
    return cache, {
        "image": pipeline.CXRImageDataset(paths["images"], paths["metadata"],
                                          **kw),
        "report": pipeline.CXRImageReportDataset(
            features, paths["images"], paths["metadata"], **kw),
        "disease": pipeline.CXRImageDiseaseDataset(
            paths["images"], paths["metadata"], DISEASE, stats, **kw)}


def samples(datasets, case) -> tuple:
    """Every sample of every dataset, loaded with the loader's generator of
    (seed, epoch 1, index): {'<ds>/<i>/<key>': array} and the indices that
    gave None."""
    train = CASES[case][1]
    arrays, none = {}, {}
    for name, ds in datasets.items():
        none[name] = []
        for i in range(len(ds)):
            s = ds.load(i, np.random.default_rng((SEED, 1, i)), train=train)
            if s is None:
                none[name].append(i)
                continue
            arrays.update({f"{name}/{i}/{k}": np.asarray(v)
                           for k, v in s.items()})
        if name == "report":
            arrays["report/lengths"] = np.array(
                [ds.token_length(i) for i in range(len(ds))])
        else:
            arrays[f"{name}/len"] = np.array(len(ds))
    return arrays, none


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from mimm_tpu.data import crop_cache, pipeline
    from mimm_tpu.data.etl import read_disease_stats
    from mimm_tpu.data.features import TokenFeatureSet, load_and_cache_examples
    from mimm_tpu.data.tokenizer import NativeWordPieceTokenizer
    from mimm_tpu.utils import MimicID
    from tests.torch_port_child import run_child

    job = str(tmp_path_factory.mktemp("datasets"))
    paths = write_corpus(os.path.join(job, "corpus"), 12, IMG, SEED,
                         bad=(5,), missing=(8,))
    stats = _disease_stats(job, paths["rows"])
    text_port = os.path.join(job, "text_port")
    shutil.copytree(paths["text"], text_port)        # no cache there yet
    tok = NativeWordPieceTokenizer.from_pretrained(paths["bert"])
    features = load_and_cache_examples(paths["text"], SEQ, tok)
    want, none = {}, {}
    for case in CASES:
        cache_dir = os.path.join(job, "cache_jax")
        cache, datasets = build_datasets(pipeline, crop_cache, paths,
                                         features, stats, cache_dir, case)
        got, none[case] = samples(datasets, case)
        want.update({f"{case}/{k}": v for k, v in got.items()})
    want["features"] = {k: getattr(features, k) for k in (
        "report_ids", "input_ids", "input_mask", "segment_ids", "label_ids")}
    meta_want = {
        "stats": list(read_disease_stats(stats, DISEASE)),
        "edema": list(read_disease_stats(stats, "Edema")),
        "study": MimicID.get_study_id(paths["rows"][3]),
        "subject": MimicID.get_subject_id(paths["rows"][3]),
        "str": str(MimicID("1", "2", "abc"))}
    with open(os.path.join(job, "paths.json"), "w") as f:
        json.dump({**paths, "stats": stats, "text_port": text_port,
                   "jax_cache": os.path.join(job, "cache_jax")}, f)
    np.savez(os.path.join(job, "in.npz"))
    got, meta = run_child(__file__, job, timeout=300)
    # JAX reads the token cache the port wrote
    port_cache = os.path.join(text_port, f"cachedfeatures_train_seqlen-"
                                         f"{SEQ}.npz")
    back = TokenFeatureSet.load(port_cache)
    meta["jax_reads_port_cache"] = all(
        np.array_equal(getattr(back, k), getattr(features, k))
        for k in want["features"])
    shutil.rmtree(job)
    return want, none, meta_want, got, meta


@pytest.mark.parametrize("case", list(CASES))
def test_datasets_match_jax_bit_for_bit(results, case):
    want, none, _, got, meta = results
    for run in ("fresh", "jax_cache") if CASES[case][0] else ("decode",):
        assert meta["none"][f"{run}/{case}"] == none[case], run
        keys = sorted(k for k in want if k.startswith(f"{case}/"))
        port = sorted(k[len(run) + 1:] for k in got
                      if k.startswith(f"{run}/{case}/"))
        assert keys and keys == port, run
        for k in keys:
            a, b = got[f"{run}/{k}"], want[k]
            assert a.dtype == b.dtype and a.shape == b.shape, (run, k)
            np.testing.assert_array_equal(a, b, err_msg=f"{run} {k}")


def test_cases_reach_what_they_test(results):
    """Each dataset skips the unreadable image (row 5) and the report
    dataset the study without a report (row 8); compact crops keep the
    source's 8- and 16-bit dtypes, the wide ones are float32; the disease
    dataset holds fewer rows than the metadata."""
    want, none, _, _, _ = results
    case = "decode_train_compact"
    assert none[case]["image"] == [5]
    assert none[case]["report"] == [5, 8]
    dtypes = {want[f"{case}/image/{i}/image"].dtype for i in (0, 1)}
    assert dtypes == {np.dtype(np.uint8), np.dtype(np.uint16)}
    assert want[f"decode_eval_wide/image/1/image"].dtype == np.float32
    assert want[f"{case}/report/0/txt_ids"].dtype == np.uint16
    assert int(want[f"{case}/disease/len"]) < int(want[f"{case}/image/len"])
    assert want[f"{case}/report/lengths"][8] == 0


def test_port_reads_jax_crop_cache_as_hits(results):
    """Over JAX's cache directory every readable image is a hit; over a
    fresh one the first reads build the entries."""
    meta = results[4]
    for case, (use_cache, _, _) in CASES.items():
        if not use_cache:
            continue
        hits, misses = meta["cache_counts"][f"jax_cache/{case}"]
        assert misses == 3, (case, hits, misses)    # row 5, once a dataset
        assert hits > 0
    first = meta["cache_counts"][f"fresh/{next(c for c in CASES if CASES[c][0])}"]
    assert first[1] > 3


def test_token_caches_cross_both_ways(results):
    want, _, _, got, meta = results
    for k, v in want["features"].items():
        np.testing.assert_array_equal(got[f"from_jax_cache/{k}"], v,
                                      err_msg=k)
        np.testing.assert_array_equal(got[f"port_tokenized/{k}"], v,
                                      err_msg=k)
    assert meta["jax_reads_port_cache"] is True
    assert meta["pool_forked"] is True


def test_disease_stats_and_mimic_id_match_jax(results):
    _, _, meta_want, _, meta = results
    for k, v in meta_want.items():
        assert meta["ids"][k] == v, k


def _child(job):
    from mimm_tpu_torch.data import crop_cache, features, pipeline
    from mimm_tpu_torch.data.etl import read_disease_stats
    from mimm_tpu_torch.data.tokenizer import WordPieceTokenizer
    from mimm_tpu_torch.utils import MimicID

    with open(os.path.join(job, "paths.json")) as f:
        paths = json.load(f)
    out, meta = {}, {"none": {}, "cache_counts": {}}
    jax_cache = features.TokenFeatureSet.load(os.path.join(
        paths["text"], f"cachedfeatures_train_seqlen-{SEQ}.npz"))
    import multiprocessing

    forked, real_ctx = [], multiprocessing.get_context

    def spy(method=None):
        forked.append(method)
        return real_ctx(method)

    multiprocessing.get_context = spy
    ported = features.load_and_cache_examples(
        paths["text_port"], SEQ,
        WordPieceTokenizer.from_pretrained(paths["bert"]), num_workers=2)
    multiprocessing.get_context = real_ctx
    meta["pool_forked"] = forked == ["fork"] or (os.cpu_count() or 1) < 3
    for k in ("report_ids", "input_ids", "input_mask", "segment_ids",
              "label_ids"):
        out[f"from_jax_cache/{k}"] = getattr(jax_cache, k)
        out[f"port_tokenized/{k}"] = getattr(ported, k)
    runs = {"decode": None, "fresh": os.path.join(job, "cache_port"),
            "jax_cache": os.path.join(job, "cache_jax_copy")}
    shutil.copytree(paths["jax_cache"], runs["jax_cache"])
    for run, cache_dir in runs.items():
        for case, (use_cache, _, _) in CASES.items():
            if use_cache != (cache_dir is not None):
                continue
            cache, datasets = build_datasets(pipeline, crop_cache, paths,
                                             jax_cache, paths["stats"],
                                             cache_dir, case)
            got, meta["none"][f"{run}/{case}"] = samples(datasets, case)
            out.update({f"{run}/{case}/{k}": v for k, v in got.items()})
            if cache is not None:
                meta["cache_counts"][f"{run}/{case}"] = [cache.hits,
                                                         cache.misses]
    meta["ids"] = {
        "stats": [list(x) for x in read_disease_stats(paths["stats"],
                                                      DISEASE)],
        "edema": [list(x) for x in read_disease_stats(paths["stats"],
                                                      "Edema")],
        "study": MimicID.get_study_id(paths["rows"][3]),
        "subject": MimicID.get_subject_id(paths["rows"][3]),
        "str": str(MimicID("1", "2", "abc"))}
    np.savez(os.path.join(job, "out.npz"), **out)
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    _child(sys.argv[1])
