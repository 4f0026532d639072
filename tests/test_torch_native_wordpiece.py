"""The port's native WordPiece encoder (mimm_tpu_torch/csrc/host/
mimm_host.cpp ``mimm_wp_*`` through data/native_ops.py and
data/tokenizer.py ``NativeWordPieceTokenizer``) against the port's Python
encoder and the JAX package's native ids, the cases of
tests/test_native_wordpiece.py:

* a CRLF and a lone-CR vocab.txt give the Python path's keys and ids;
* adversarial ASCII strings (never-split literals, a word past 100
  characters, greedy-match stress, punctuation runs, control characters);
* non-ASCII text: ``wp_encode`` refuses it (None) and the tokenizer gives
  the Python encoder's ids;
* a report corpus with a vocabulary of its characters, their ``##``
  continuations and its 500 most frequent words (2000 reports written
  here from a clinical word list, with punctuation, capitals, numbers and
  a share of non-ASCII reports: the reference's corpus is not shipped);
* ``convert_examples_to_features`` with the native tokenizer equals it
  with the Python one, and on threads (4 workers, also with CUDA taken as
  initialized) equals it serially;
* pickling drops the raw handle and the copy loads its own, giving the
  same ids natively; the finalizer frees the vocabulary once;
* every id list equals JAX's native encoder's on the same text.

The JAX side runs in the pytest worker, the port side in a jax-free child
(tests/torch_port_child.py).
"""

import json
import os
import sys

import numpy as np
import pytest

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "the", "lungs", "are", "clear", "no", "acute", "cardio",
         "##pulmonary", "process", "heart", "size", "is", "normal",
         "pleural", "effusion", ",", ".", "-", "un", "##change", "##d",
         "a", "##b", "##c", "ab", "x"]

ADVERSARIAL = [
    "",
    " ",
    "\t\n\r ",
    "the lungs are clear.  no acute cardiopulmonary process.",
    "HEART SIZE IS NORMAL, UNCHANGED - NO PLEURAL EFFUSION.",
    "[CLS] the [MASK] is [SEP]",
    "[cls] not-a-special [UNKNOWN]",
    "a" * 101,
    "a" * 100,
    "abc abab xab ba",
    "..,,--..",
    "x.x,x-x",
    "the\x00lungs\x01are\x7fclear",
    "-leading and trailing- .",
    "word" + "." * 50,
]

NON_ASCII = ["café effusion", "lungs — clear", "x�y",
             "é", "effusion normal"]

WORDS = ("the lungs are clear no acute cardiopulmonary process heart size "
         "is normal pleural effusion unchanged mild moderate severe left "
         "right lower upper lobe opacity atelectasis pneumothorax "
         "consolidation edema cardiomegaly mediastinal contour stable "
         "compared prior study pa lateral views chest radiograph ap "
         "portable tube line catheter tip projects svc ett ng picc "
         "interval removal placement degenerative changes thoracic spine "
         "osseous structures intact").split()
PUNCT = [".", ",", "-", ":", ";", "(", ")", "/", "?"]
CORPUS = 2000
FEATURE_SEQ = 16


def _synthetic_reports(n=CORPUS, seed=0):
    rng = np.random.default_rng(seed)
    texts = []
    for i in range(n):
        words = []
        for _ in range(int(rng.integers(5, 60))):
            w = WORDS[int(rng.integers(len(WORDS)))]
            r = rng.random()
            if r < 0.1:
                w = w.upper()
            elif r < 0.2:
                w = w.capitalize()
            elif r < 0.25:
                w = f"{w}{int(rng.integers(1, 12))}"
            words.append(w)
            if rng.random() < 0.15:
                words.append(PUNCT[int(rng.integers(len(PUNCT)))])
        text = " ".join(words)
        if i % 50 == 7:
            text += " café"        # a non-ASCII report: the Python path
        texts.append(text)
    return texts


def write_vocabs(job, python_tokenizer):
    """The small vocab (LF, CRLF, lone CR) and the corpus vocab: the
    corpus's characters, their continuations and its 500 most frequent
    words (as tests/test_native_wordpiece.py builds it)."""
    paths = {}
    for name, sep in (("lf", "\n"), ("crlf", "\r\n"), ("cr", "\r")):
        paths[name] = os.path.join(job, f"vocab_{name}.txt")
        with open(paths[name], "wb") as f:
            f.write(sep.join(VOCAB).encode() + sep.encode())
    texts = _synthetic_reports()
    chars = sorted({c for t in texts for c in t.lower() if c.isalnum()})
    seed = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
            + chars + ["##" + c for c in chars])
    paths["corpus"] = os.path.join(job, "vocab_corpus.txt")
    with open(paths["corpus"], "w", encoding="utf-8") as f:
        f.write("\n".join(seed) + "\n")
    py = python_tokenizer.from_pretrained(paths["corpus"])
    freq = {}
    for t in texts:
        for w in py.basic.tokenize(t):
            freq[w] = freq.get(w, 0) + 1
    top = [w for w, _ in sorted(freq.items(), key=lambda kv: -kv[1])[:500]]
    with open(paths["corpus"], "w", encoding="utf-8") as f:
        f.write("\n".join(seed + top) + "\n")
    return paths, texts


TEXT_SETS = {"adversarial": ("lf", ADVERSARIAL),
             "crlf": ("crlf", ADVERSARIAL), "cr": ("cr", ADVERSARIAL)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from mimm_tpu.data import native_ops
    from mimm_tpu.data.tokenizer import WordPieceTokenizer
    from tests.torch_port_child import run_child

    job = str(tmp_path_factory.mktemp("wordpiece"))
    paths, texts = write_vocabs(job, WordPieceTokenizer)
    with open(os.path.join(job, "paths.json"), "w") as f:
        json.dump(paths, f)
    want = {}
    for name, (vocab, items) in {**TEXT_SETS,
                                 "corpus": ("corpus", texts)}.items():
        handle = native_ops.wp_create(paths[vocab])
        assert handle is not None, "JAX's native library"
        want[name] = [native_ops.wp_encode(handle, t) for t in items]
        native_ops.wp_destroy(handle)
    np.savez(os.path.join(job, "in.npz"))
    got, meta = run_child(__file__, job, timeout=600)
    return want, meta, len(texts)


@pytest.mark.parametrize("name", ["adversarial", "crlf", "cr", "corpus"])
def test_native_ids_match_jax(results, name):
    """JAX's native ids and the port's, text by text; None (a refusal)
    on the same texts."""
    want, meta, _ = results
    assert meta["native"][name] == want[name]


@pytest.mark.parametrize("vocab", ["crlf", "cr"])
def test_crlf_vocab_matches_python(results, vocab):
    meta = results[1]
    assert meta["native"][vocab] == meta["python"][vocab]
    assert meta["unk_free"][vocab], "real ids, not [UNK]s"


def test_native_matches_python_adversarial(results):
    meta = results[1]
    assert None not in meta["native"]["adversarial"]
    assert meta["native"]["adversarial"] == meta["python"]["adversarial"]


def test_native_refuses_non_ascii(results):
    meta = results[1]
    assert meta["non_ascii"]["wp_encode"] == [None] * len(NON_ASCII)
    assert meta["non_ascii"]["tokenizer"] == meta["non_ascii"]["python"]


def test_native_matches_python_fixture_corpus(results):
    _, meta, n = results
    native, python = meta["native"]["corpus"], meta["python"]["corpus"]
    encoded = [i for i, ids in enumerate(native) if ids is not None]
    assert len(encoded) >= 0.9 * n
    assert all(native[i] == python[i] for i in encoded)
    assert meta["tokenizer_corpus"] == python


def test_facade_and_features_parity(results):
    assert results[1]["features"]["native_equals_python"]


def test_threaded_featurization_matches_serial(results):
    f = results[1]["features"]
    assert f["threads_used"] == [True, True], f
    assert f["threaded_equals_serial"] == [True, True], f


def test_pickle_drops_native_handle(results):
    p = results[1]["pickle"]
    assert "_native_handle" not in p["state_keys"], p
    assert p["clone_has_own_handle"] and p["clone_gil_free"], p
    assert p["same_ids"], p


def test_native_handle_finalizer_releases(results):
    fin = results[1]["finalizer"]
    assert fin == {"alive_before": True, "alive_after": False,
                   "destroyed": 1}, fin


def _child(job):
    import concurrent.futures
    import gc
    import pickle

    import torch

    from mimm_tpu_torch.data import NativeWordPieceTokenizer, native_ops
    from mimm_tpu_torch.data import features
    from mimm_tpu_torch.data.features import (InputExample,
                                              convert_examples_to_features)
    from mimm_tpu_torch.data.tokenizer import WordPieceTokenizer

    with open(os.path.join(job, "paths.json")) as f:
        paths = json.load(f)
    texts = _synthetic_reports()
    meta = {"native": {}, "python": {}, "unk_free": {}}
    for name, (vocab, items) in {**TEXT_SETS,
                                 "corpus": ("corpus", texts)}.items():
        handle = native_ops.wp_create(paths[vocab])
        py = WordPieceTokenizer.from_pretrained(paths[vocab])
        meta["native"][name] = [native_ops.wp_encode(handle, t)
                                for t in items]
        meta["python"][name] = [py.encode_wordpiece_ids(t) for t in items]
        meta["unk_free"][name] = py.vocab["[UNK]"] not in \
            py.encode_wordpiece_ids("the lungs are clear. heart size is "
                                    "normal, unchanged.")
        native_ops.wp_destroy(handle)
    tok = NativeWordPieceTokenizer.from_pretrained(paths["corpus"])
    meta["tokenizer_corpus"] = [tok.encode_wordpiece_ids(t) for t in texts]

    tok = NativeWordPieceTokenizer.from_pretrained(paths["lf"])
    py = WordPieceTokenizer.from_pretrained(paths["lf"])
    handle = native_ops.wp_create(paths["lf"])
    meta["non_ascii"] = {
        "wp_encode": [native_ops.wp_encode(handle, t) for t in NON_ASCII],
        "tokenizer": [tok.encode_wordpiece_ids(t) for t in NON_ASCII],
        "python": [py.encode_wordpiece_ids(t) for t in NON_ASCII]}
    native_ops.wp_destroy(handle)

    # ---- features: native = python, threaded = serial --------------------
    examples = [InputExample(report_id=str(i), guid=f"dev-{i}", text_a=t,
                             labels="-1")
                for i, t in enumerate(ADVERSARIAL + NON_ASCII)]
    a = convert_examples_to_features(examples, FEATURE_SEQ, tok)
    b = convert_examples_to_features(examples, FEATURE_SEQ, py)
    corpus_tok = NativeWordPieceTokenizer.from_pretrained(paths["corpus"])
    corpus_examples = [InputExample(report_id=str(i), guid=f"dev-{i}",
                                    text_a=t, labels="-1")
                       for i, t in enumerate(texts[:256])]
    used = []
    real_pool, real_count = concurrent.futures.ThreadPoolExecutor, \
        features.os.cpu_count
    real_init = torch.cuda.is_initialized

    class Pool(real_pool):
        def __init__(self, *args, **kw):
            used[-1] = True
            super().__init__(*args, **kw)

    concurrent.futures.ThreadPoolExecutor = Pool
    features.os.cpu_count = lambda: 8      # the thread branch on any host
    threaded = []
    try:
        serial = convert_examples_to_features(corpus_examples, 64,
                                              corpus_tok, num_workers=0)
        for cuda in (False, True):
            # with CUDA initialized the process pool is refused; the
            # threads are not
            torch.cuda.is_initialized = lambda c=cuda: c
            used.append(False)
            threaded.append(convert_examples_to_features(
                corpus_examples, 64, corpus_tok, num_workers=4) == serial)
    finally:
        concurrent.futures.ThreadPoolExecutor = real_pool
        features.os.cpu_count = real_count
        torch.cuda.is_initialized = real_init
    meta["features"] = {"native_equals_python": a == b,
                        "threads_used": used,
                        "threaded_equals_serial": threaded}

    # ---- pickling and the finalizer ----------------------------------------
    state = tok.__getstate__()
    clone = pickle.loads(pickle.dumps(tok))
    text = "the lungs are clear."
    meta["pickle"] = {
        "state_keys": sorted(state),
        "clone_has_own_handle": bool(clone._native_handle)
        and clone._native_handle != tok._native_handle,
        "clone_gil_free": clone.native_gil_free,
        "same_ids": clone.encode_wordpiece_ids(text)
        == tok.encode_wordpiece_ids(text)
        == native_ops.wp_encode(clone._native_handle, text)}
    destroyed = []
    real_destroy = native_ops.wp_destroy
    native_ops.wp_destroy = lambda h: (destroyed.append(h), real_destroy(h))
    try:
        tok = NativeWordPieceTokenizer.from_pretrained(paths["lf"])
    finally:
        native_ops.wp_destroy = real_destroy
    fin = tok._finalizer
    alive = fin.alive
    del tok
    gc.collect()
    meta["finalizer"] = {"alive_before": alive, "alive_after": fin.alive,
                         "destroyed": len(destroyed)}
    np.savez(os.path.join(job, "out.npz"))
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    _child(sys.argv[1])
