"""Derive sequence-bucket boundaries + shares from a report corpus
(tools/derive_buckets.py counterpart).

The production MI config buckets reports by token length
(``cfg.seq_buckets``); training runs one step shape per bucket.  This tool
computes the corpus's length mix from the TSV corpus so the deployed
bucket set is derived from data, not hard-coded:

    python -m mimm_tpu_torch.tools.derive_buckets \
        --tsv_glob 'full_data_set/text/data_subfolder_*.tsv'
    python -m mimm_tpu_torch.tools.derive_buckets --vocab bert_dir/vocab.txt

With a vocab file the lengths are the port's WordPiece token counts (+2
for [CLS]/[SEP]); without one, the JAX tool's approximation (basic
tokenization x 1.15 WordPiece expansion + 2).  With ``--per_bucket_ms``
(JSON {bucket: ms} of measured step times) it also scores candidate
bucket sets by expected weighted step time.

Prints one JSON object: percentiles, shares for each candidate set, and
the recommended ``--seq_buckets`` string.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import re
from typing import Optional, Sequence

DEFAULT_CANDIDATES = (
    (64, 96, 128, 160, 192, 256, 320),
    (64, 96, 128, 160, 192, 320),
    (64, 96, 128, 192, 320),
    (48, 64, 96, 128, 192, 320),
    (64, 80, 96, 128, 192, 320),
    (64, 128, 192, 320),
)


def token_lengths(tsv_glob: str, max_seq_length: int, vocab: Optional[str]):
    """The sorted token lengths (capped at ``max_seq_length``) of every
    report (column 5) of the TSVs ``tsv_glob`` matches."""
    tokenize = None
    if vocab and os.path.exists(vocab):
        from mimm_tpu_torch.data.tokenizer import WordPieceTokenizer
        tok = WordPieceTokenizer.from_pretrained(vocab)
        tokenize = lambda text: len(tok.tokenize(text)) + 2  # [CLS]/[SEP]
    lengths = []
    for tsv in sorted(glob.glob(tsv_glob)):
        with open(tsv) as f:
            for row in csv.reader(f, delimiter="\t"):
                if len(row) >= 5 and row[4].strip():
                    if tokenize is not None:
                        n = tokenize(row[4])
                    else:
                        basic = len(re.findall(r"\w+|[^\w\s]", row[4]))
                        n = int(round(basic * 1.15)) + 2
                    lengths.append(min(n, max_seq_length))
    return sorted(lengths)


def shares_for(lengths, buckets):
    """Each bucket's share of ``lengths`` (a length goes to the first
    bucket that holds it, the largest takes the tail)."""
    counts = {b: 0 for b in buckets}
    top = buckets[-1]
    for n in lengths:
        counts[next((b for b in buckets if n <= b), top)] += 1
    return {b: c / len(lengths) for b, c in counts.items()}


def conservative_shares(shares):
    """The robustness bound: every length class shifted ONE bucket longer
    (the largest absorbs the tail).  A denser bucket grid makes this bound
    tighter."""
    buckets = sorted(shares)
    shifted = {b: 0.0 for b in buckets}
    for i, b in enumerate(buckets):
        shifted[buckets[min(i + 1, len(buckets) - 1)]] += shares[b]
    return shifted


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--tsv_glob",
                   default=os.path.join(os.path.dirname(os.path.dirname(
                       os.path.dirname(os.path.abspath(__file__)))),
                       "full_data_set/text/data_subfolder_*.tsv"))
    p.add_argument("--vocab", default=None,
                   help="vocab.txt for exact WordPiece lengths")
    p.add_argument("--max_seq_length", type=int, default=320)
    p.add_argument("--per_bucket_ms", default=None,
                   help="JSON dict {bucket: ms} of measured step times; "
                        "scores candidates by expected weighted step time "
                        "(missing buckets interpolate linearly)")
    p.add_argument("--candidates", default=None,
                   help="semicolon-separated candidate sets, e.g. "
                        "'64,96,320;64,128,320'")
    args = p.parse_args(argv)

    lengths = token_lengths(args.tsv_glob, args.max_seq_length, args.vocab)
    if not lengths:
        raise SystemExit(f"no reports matched {args.tsv_glob}")
    n = len(lengths)
    pct = lambda q: lengths[min(n - 1, int(n * q))]

    candidates = DEFAULT_CANDIDATES
    if args.candidates:
        candidates = tuple(tuple(int(x) for x in c.split(","))
                           for c in args.candidates.split(";"))
    candidates = tuple(tuple(sorted(set(c) | {args.max_seq_length}))
                       for c in candidates)

    cost = None
    if args.per_bucket_ms:
        ms = {int(k): float(v) for k, v in
              json.loads(args.per_bucket_ms).items()}
        xs, ys = zip(*sorted(ms.items()))

        def cost(L):  # piecewise-linear in L, clamped at the ends
            if L <= xs[0]:
                return ys[0]
            for (x0, y0), (x1, y1) in zip(zip(xs, ys), zip(xs[1:], ys[1:])):
                if L <= x1:
                    return y0 + (y1 - y0) * (L - x0) / (x1 - x0)
            return ys[-1]

    report = {
        "n_reports": n,
        "percentiles": {"p50": pct(0.5), "p90": pct(0.9), "p99": pct(0.99),
                        "max": lengths[-1]},
        "candidates": [],
    }
    for buckets in candidates:
        shares = shares_for(lengths, buckets)
        entry = {"buckets": list(buckets),
                 "shares": {str(b): round(s, 4) for b, s in shares.items()}}
        if cost:
            entry["expected_step_ms"] = round(
                sum(s * cost(b) for b, s in shares.items()), 3)
            entry["conservative_step_ms"] = round(
                sum(s * cost(b)
                    for b, s in conservative_shares(shares).items()), 3)
        report["candidates"].append(entry)
    # rank by the conservative bound, with the expected mix as tiebreaker
    best = min(report["candidates"],
               key=lambda e: (e["conservative_step_ms"],
                              e["expected_step_ms"])) \
        if cost else report["candidates"][0]
    report["recommended_seq_buckets"] = ",".join(str(b)
                                                 for b in best["buckets"])
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
