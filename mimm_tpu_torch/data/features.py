"""Text featurization: TSV examples -> fixed-length token features
(mimm_tpu/data/features.py counterpart).

Reference parity (model_utils.py:341-544): reads ``all_data.tsv`` (5
columns: index, label, study_id, img_path, findings text), WordPiece-
tokenizes with [CLS]/[SEP], truncates to ``max_seq_length``, zero-pads ids,
mask and segments, maps labels "0"-"3" (and "-1" for unlabeled), and caches
the features on disk keyed by sequence length.

The cache is JAX's: ``cachedfeatures_train_seqlen-<L>.npz`` in the text
directory, members ``report_ids``, ``input_ids``, ``input_mask``,
``segment_ids`` and ``label_ids``, written to a temporary name and
renamed, so a cache either package wrote loads in the other.
"""

from __future__ import annotations

import csv
import logging
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

LABEL_LIST = ["0", "1", "2", "3"]  # reference get_labels (model_utils.py:455-457)


@dataclass
class InputExample:
    """One report (reference model_utils.py:384-403)."""
    report_id: str
    guid: str
    text_a: str
    text_b: Optional[str] = None
    labels: Optional[str] = None


@dataclass
class InputFeatures:
    """A tokenized report (reference model_utils.py:373-381)."""
    input_ids: List[int]
    input_mask: List[int]
    segment_ids: List[int]
    label_id: int
    report_id: str


def read_tsv(path: str) -> List[List[str]]:
    with open(path, encoding="utf-8") as f:
        return [line for line in csv.reader(f, delimiter="\t")]


def create_examples_from_tsv(path: str, set_type: str = "dev"
                             ) -> List[InputExample]:
    """Reference ClassificationDataProcessor._create_examples
    (model_utils.py:459-471): text = last column, label = column 1,
    report_id = column 2 (the study id)."""
    return [InputExample(report_id=line[2], guid=f"{set_type}-{i}",
                         text_a=line[-1], labels=line[1])
            for i, line in enumerate(read_tsv(path))]


def convert_example_to_feature(example: InputExample,
                               label_map: Dict[str, int],
                               max_seq_length: int, tokenizer
                               ) -> InputFeatures:
    """Reference convert_example_to_feature (model_utils.py:474-528).  A
    tokenizer with ``encode_wordpiece_ids`` (the port's WordPieceTokenizer)
    takes the one-call ids path; any other keeps the reference's tokenize +
    convert_tokens_to_ids.  The same ids either way."""
    if hasattr(tokenizer, "encode_wordpiece_ids"):
        ids_a = tokenizer.encode_wordpiece_ids(example.text_a)
        ids_a = ids_a[: max_seq_length - 2]
        cls_id, sep_id = tokenizer.convert_tokens_to_ids(["[CLS]", "[SEP]"])
        input_ids = [cls_id] + ids_a + [sep_id]
    else:
        tokens_a = tokenizer.tokenize(example.text_a)[: max_seq_length - 2]
        input_ids = tokenizer.convert_tokens_to_ids(
            ["[CLS]"] + tokens_a + ["[SEP]"])
    segment_ids = [0] * len(input_ids)
    input_mask = [1] * len(input_ids)
    pad = [0] * (max_seq_length - len(input_ids))
    return InputFeatures(input_ids=input_ids + pad,
                         input_mask=input_mask + pad,
                         segment_ids=segment_ids + pad,
                         label_id=label_map[example.labels],
                         report_id=example.report_id)


_POOL_STATE: Dict = {}


def _pool_init(label_map, max_seq_length, tokenizer):
    _POOL_STATE.update(label_map=label_map, max_seq_length=max_seq_length,
                       tokenizer=tokenizer)


def _pool_convert(example: InputExample) -> InputFeatures:
    return convert_example_to_feature(example, _POOL_STATE["label_map"],
                                      _POOL_STATE["max_seq_length"],
                                      _POOL_STATE["tokenizer"])


def convert_examples_to_features(examples: Sequence[InputExample],
                                 max_seq_length: int, tokenizer,
                                 num_workers: int = 0
                                 ) -> List[InputFeatures]:
    """Tokenize ``examples``; with ``num_workers`` > 1 in parallel.  A
    tokenizer whose encoder drops the GIL (``native_gil_free``: the host
    library's, tokenizer.NativeWordPieceTokenizer) fans out over threads,
    in chunks cut by hand (an executor's per-item dispatch would cost more
    than the encode), also once CUDA is initialized.  Any other tokenizer
    takes a forked process pool like the reference's (model_utils.py:
    539-543): pure-Python WordPiece holds the GIL, so threads cannot help;
    that pool is not started once CUDA is initialized in this process (a
    forked child cannot use the parent's CUDA context; entry points
    tokenize before they build the model).  Both keep the order, so the
    list equals the serial one.  Serial when there are few examples or one
    core."""
    label_map = {label: i for i, label in enumerate(LABEL_LIST)}
    label_map["-1"] = -1  # unlabeled (model_utils.py:536)
    workers = min(int(num_workers), max(1, (os.cpu_count() or 1) - 1))
    convert = lambda part: [convert_example_to_feature(
        e, label_map, max_seq_length, tokenizer) for e in part]
    if workers > 1 and len(examples) >= 4 * workers:
        chunk = max(16, len(examples) // (8 * workers))
        if getattr(tokenizer, "native_gil_free", False):
            from concurrent.futures import ThreadPoolExecutor
            parts = [examples[i:i + chunk]
                     for i in range(0, len(examples), chunk)]
            with ThreadPoolExecutor(workers) as pool:
                return [f for part in pool.map(convert, parts) for f in part]
        if torch.cuda.is_initialized():
            logger.info("tokenizing serially: CUDA is initialized in this "
                        "process, and a forked pool would inherit its "
                        "context")
        else:
            from multiprocessing import get_context
            with get_context("fork").Pool(
                    workers, initializer=_pool_init,
                    initargs=(label_map, max_seq_length, tokenizer)) as pool:
                return pool.map(_pool_convert, examples, chunksize=chunk)
    return convert(examples)


class TokenFeatureSet:
    """Dense token features keyed by report id (the reference's
    ``{report_id: list}`` dicts, model_utils.py:111-113)."""

    def __init__(self, report_ids: np.ndarray, input_ids: np.ndarray,
                 input_mask: np.ndarray, segment_ids: np.ndarray,
                 label_ids: np.ndarray):
        self.report_ids = report_ids                    # (N,) str
        self.input_ids = input_ids.astype(np.int32)     # (N, L)
        self.input_mask = input_mask.astype(np.int32)
        self.segment_ids = segment_ids.astype(np.int32)
        self.label_ids = label_ids.astype(np.int32)
        self.index = {str(r): i for i, r in enumerate(report_ids)}

    def __len__(self):
        return len(self.report_ids)

    def lookup(self, report_id: str):
        """(ids, mask, segments) of ``report_id``, or None."""
        i = self.index.get(str(report_id))
        if i is None:
            return None
        return self.input_ids[i], self.input_mask[i], self.segment_ids[i]

    @classmethod
    def from_features(cls, features: Sequence[InputFeatures]
                      ) -> "TokenFeatureSet":
        return cls(report_ids=np.array([f.report_id for f in features]),
                   input_ids=np.array([f.input_ids for f in features]),
                   input_mask=np.array([f.input_mask for f in features]),
                   segment_ids=np.array([f.segment_ids for f in features]),
                   label_ids=np.array([f.label_id for f in features]))

    def save(self, path: str) -> None:
        np.savez_compressed(path, report_ids=self.report_ids,
                            input_ids=self.input_ids,
                            input_mask=self.input_mask,
                            segment_ids=self.segment_ids,
                            label_ids=self.label_ids)

    @classmethod
    def load(cls, path: str) -> "TokenFeatureSet":
        with np.load(path, allow_pickle=False) as z:
            return cls(z["report_ids"], z["input_ids"], z["input_mask"],
                       z["segment_ids"], z["label_ids"])


def load_and_cache_examples(text_data_dir: str, max_seq_length: int,
                            tokenizer, tsv_name: str = "all_data.tsv",
                            num_workers: int = 0) -> TokenFeatureSet:
    """Reference load_and_cache_examples (model_utils.py:341-370) over the
    ``.npz`` cache, written atomically (a temporary name, then a rename),
    so concurrent runs may race on it."""
    cache = os.path.join(text_data_dir,
                         f"cachedfeatures_train_seqlen-{max_seq_length}.npz")
    if os.path.exists(cache):
        logger.info("Loading features from cached file %s", cache)
        return TokenFeatureSet.load(cache)
    logger.info("Creating features from dataset file at %s", text_data_dir)
    examples = create_examples_from_tsv(os.path.join(text_data_dir, tsv_name))
    features = convert_examples_to_features(examples, max_seq_length,
                                            tokenizer,
                                            num_workers=num_workers)
    fs = TokenFeatureSet.from_features(features)
    tmp = f"{cache}.tmp.{os.getpid()}.npz"  # np.savez appends .npz otherwise
    fs.save(tmp)
    os.replace(tmp, cache)
    return fs
