"""Corpus integrity sweep (tools/corpus_check.py counterpart) — the
productionized version of the reference's manual ``test_dataloader``
(dataset_populate.py:679-777): walk every training record, verify the
image reads and the study has token features, and REPORT broken study ids
(the loader skips and counts them at train time; this tool finds them
before training).

Usage:
    python -m mimm_tpu_torch.tools.corpus_check \
        --metadata <label_negbio.csv> --image_dir <imgdir> \
        --text_dir <dir with all_data.tsv> --vocab_dir <dir with vocab.txt> \
        [--max_seq_length 320] [--decoded_crop_cache <dir>]

``--decoded_crop_cache`` (not in the JAX tool) reads the images through
the decoded-crop cache, as the trainer does with that setting; a machine
without cv2 can then check a corpus whose cache is complete.

Importable: ``sweep_dataset(dataset)`` runs the same check over any
dataset exposing ``__len__`` + ``load(idx, rng, train)`` (returns None for
a broken record), with a per-part diagnosis for a
``CXRImageReportDataset``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence


def sweep_dataset(dataset) -> dict:
    """Check every record; returns {'total', 'broken', 'broken_ids',
    'missing_tokens', 'unreadable_images'}."""
    from mimm_tpu_torch.data.pipeline import CXRImageReportDataset, _imread
    from mimm_tpu_torch.utils import MimicID

    broken_ids = []
    missing_tokens = unreadable_images = 0
    paired = isinstance(dataset, CXRImageReportDataset)
    for idx in range(len(dataset)):
        sample = dataset.load(idx, None, train=False)
        if sample is not None:
            continue
        if paired:
            row = dataset.rows[idx]
            img_id = row[dataset.data_key]
            study = MimicID.get_study_id(img_id)
            broken_ids.append(study)
            if dataset.tokens is None or dataset.tokens.lookup(study) is None:
                missing_tokens += 1
            if dataset.crop_cache is not None:
                unreadable = dataset.crop_cache.read(dataset.img_dir,
                                                     img_id) is None
            else:
                unreadable = _imread(os.path.join(dataset.img_dir,
                                                  img_id)) is None
            unreadable_images += unreadable
        else:
            broken_ids.append(str(idx))
    return {
        "total": len(dataset),
        "broken": len(broken_ids),
        "broken_ids": broken_ids,
        "missing_tokens": missing_tokens,
        "unreadable_images": unreadable_images,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--metadata", required=True,
                    help="label CSV with a mimic_id column")
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--text_dir", required=True,
                    help="directory containing all_data.tsv")
    ap.add_argument("--vocab_dir", required=True,
                    help="directory containing vocab.txt")
    ap.add_argument("--max_seq_length", type=int, default=320)
    ap.add_argument("--decoded_crop_cache", default="",
                    help="read the images through this decoded-crop cache")
    args = ap.parse_args(argv)

    from mimm_tpu_torch.data.crop_cache import DecodedCropCache
    from mimm_tpu_torch.data.features import load_and_cache_examples
    from mimm_tpu_torch.data.pipeline import CXRImageReportDataset
    from mimm_tpu_torch.data.tokenizer import \
        NativeWordPieceTokenizer as WordPieceTokenizer

    tokenizer = WordPieceTokenizer.from_pretrained(args.vocab_dir)
    feats = load_and_cache_examples(args.text_dir, args.max_seq_length,
                                    tokenizer)
    cache = DecodedCropCache(args.decoded_crop_cache, 256) \
        if args.decoded_crop_cache else None
    ds = CXRImageReportDataset(feats, args.image_dir, args.metadata,
                               crop_cache=cache)
    report = sweep_dataset(ds)

    print(f"total records:      {report['total']}")
    print(f"broken records:     {report['broken']}")
    print(f"  missing tokens:   {report['missing_tokens']}")
    print(f"  unreadable images:{report['unreadable_images']}")
    if report["broken_ids"]:
        print("broken study ids:", report["broken_ids"])
    return 1 if report["broken"] else 0


if __name__ == "__main__":
    sys.exit(main())
