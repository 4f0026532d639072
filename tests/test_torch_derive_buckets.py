"""The port's tools/derive_buckets.py against the JAX package's over a
synthesized TSV corpus (the reference's 5-column ``data_subfolder_*.tsv``):
the token lengths, each candidate set's shares, the conservative shift and
the whole report (percentiles, shares, the expected and conservative step
times from ``--per_bucket_ms``, the recommendation) must be equal, with a
vocab (WordPiece lengths, the port's tokenizer against JAX's) and without
one (JAX's x1.15 approximation).  The port runs in a jax-free child."""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest

WORDS = ("the", "heart", "is", "normal", "in", "size", "no", "focal",
         "consolidation", "pneumothorax", "cardiomegaly", "effusion", "mild",
         "unseenword", "lungs", "are", "clear")
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "heart", "is",
         "normal", "in", "size", "no", "focal", "consolidation", "pneumo",
         "##thorax", "card", "##io", "##megaly", "effusion", "mild", "lungs",
         "are", "clear", ".", ","]
PER_BUCKET_MS = json.dumps({"64": 20.0, "128": 31.5, "192": 44.0,
                            "320": 80.0})
MODES = ("approx", "vocab", "scored")


def write_corpus(root: str) -> str:
    """Three subfolder TSVs of seeded reports (lengths spread over the
    buckets, punctuation, an out-of-vocabulary word, empty reports)."""
    rng = np.random.default_rng(4)
    for sub in ("p10", "p11", "p12"):
        rows = []
        for i in range(150):
            n = int(rng.choice([rng.integers(1, 40), rng.integers(40, 140),
                                rng.integers(140, 300)]))
            words = [str(w) for w in rng.choice(WORDS, n)]
            for j in rng.integers(0, n, n // 7):
                words[j] += rng.choice([".", ","])
            text = "" if i % 37 == 0 else " ".join(words)
            rows.append(f"{i}\t{10000000 + i}\t{50000000 + i}\t"
                        f"p{10000000 + i}_s{50000000 + i}_x\t{text}")
        with open(os.path.join(root, f"data_subfolder_{sub}.tsv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(VOCAB) + "\n")
    return os.path.join(root, "data_subfolder_*.tsv")


def argv_for(mode: str, root: str) -> list:
    argv = ["--tsv_glob", os.path.join(root, "data_subfolder_*.tsv"),
            "--max_seq_length", "256"]
    if mode in ("vocab", "scored"):
        argv += ["--vocab", os.path.join(root, "vocab.txt")]
    if mode == "scored":
        argv += ["--per_bucket_ms", PER_BUCKET_MS,
                 "--candidates", "64,128,256;64,96,192,256;128,256"]
    return argv


def run_side(mod, root: str, main) -> dict:
    out = {}
    for mode in MODES:
        vocab = os.path.join(root, "vocab.txt") if mode == "vocab" else None
        lengths = mod.token_lengths(os.path.join(root, "data_subfolder_*.tsv"),
                                    256, vocab)
        shares = mod.shares_for(lengths, (64, 96, 128, 192, 256))
        out[mode] = {"lengths": lengths,
                     "shares": {str(k): v for k, v in shares.items()},
                     "conservative": {str(k): v for k, v in
                                      mod.conservative_shares(shares).items()},
                     "report": json.loads(main(argv_for(mode, root)))}
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from tests.torch_port_child import remove_job, run_child

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    import derive_buckets

    def jax_main(argv):
        buf = io.StringIO()
        old = sys.argv
        sys.argv = ["derive_buckets", *argv]
        try:
            with contextlib.redirect_stdout(buf):
                derive_buckets.main()
        finally:
            sys.argv = old
        return buf.getvalue()

    job = str(tmp_path_factory.mktemp("buckets"))
    write_corpus(job)
    want = run_side(derive_buckets, job, jax_main)
    _, got = run_child(__file__, job)
    yield want, got
    remove_job(job)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("part", ["lengths", "shares", "conservative",
                                  "report"])
def test_derive_buckets_matches_jax(results, mode, part):
    want, got = results
    assert got[mode][part] == want[mode][part]


def test_corpus_exercises_the_tokenizer(results):
    """WordPiece splits the vocab's words into pieces: the two length
    rules give different mixes over this corpus."""
    want, _ = results
    assert want["vocab"]["lengths"] != want["approx"]["lengths"]
    assert want["scored"]["report"]["recommended_seq_buckets"]


# ---- port side (jax-free child) ------------------------------------------

def _child(job):
    from mimm_tpu_torch.tools import derive_buckets

    def port_main(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            derive_buckets.main(argv)
        return buf.getvalue()

    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(run_side(derive_buckets, job, port_main), f)
    np.savez(os.path.join(job, "out.npz"))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    _child(sys.argv[1])
