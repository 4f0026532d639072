"""Host input pipeline: the on-disk datasets, the deterministic loader,
scan chunks and the device prefetch (mimm_tpu/data/pipeline.py
counterpart, :41-569).

* The datasets are index -> sample functions over the reference's on-disk
  contracts: a metadata CSV keyed by the ``mimic_id`` path column, images
  under ``img_dir`` (decoded by cv2, imported at the read) or their
  crop-cache windows (data/crop_cache.py), token features by study id
  (data/features.py), ``disease_stats.csv`` filters (data/etl.py).  A
  sample is a pure function of (seed, epoch, index): bit-equal to the JAX
  package's over the same files.
* ``Loader`` batches a dataset (``len`` and ``load(idx, rng, train)``;
  ``token_length(idx)`` for bucketing), deterministic per (seed, epoch):
  the epoch's shuffle comes from ``default_rng((seed, epoch))`` and each
  sample's augmentation from ``default_rng((seed, epoch, idx))``, so the
  batch stream is bit-equal to the JAX package's for the same dataset.
  Bad records (``load`` returns None) are skipped and counted in
  ``loader.skipped``.  ``num_workers`` threads decode ahead and are
  consumed in submission order.
* ``scan_chunks`` groups same-shape batches into stacked super-batches for
  ``make_mi_multi_step``; ``resume_chunks`` gives the rest of an epoch
  whose first steps ran as such chunks, in the uninterrupted order.
* ``device_prefetch`` copies batches to the card ``size`` batches ahead of
  their use: pinned host memory and ``non_blocking=True`` copies, issued on
  the consuming thread (JAX measured a transfer thread slower, :562-568).

Multi-process slicing (``process_count`` > 1) comes with the parallel
slice and raises.
"""

from __future__ import annotations

import collections
import csv
import hashlib
import logging
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Collection, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from mimm_tpu_torch import resolve_device
from mimm_tpu_torch.data import transforms
from mimm_tpu_torch.data.etl import read_disease_stats
from mimm_tpu_torch.utils import MimicID

logger = logging.getLogger(__name__)

_PARALLEL = ("comes with the parallel slice (ROADMAP.md queue A, "
             "\"parallel/mesh.py and parallel/pipeline.py\")")


def _imread(path: str) -> Optional[np.ndarray]:
    """A grayscale read at the file's own depth (the reference's
    cv2.imread(..., IMREAD_ANYDEPTH), model_utils.py:80); None if cv2
    cannot read it."""
    import cv2
    return cv2.imread(path, cv2.IMREAD_ANYDEPTH)


def _read_transformed(img_dir: str, img_id: str, img_size: int,
                      rng: Optional[np.random.Generator], train: bool,
                      raw: bool, crop_cache) -> Optional[np.ndarray]:
    """Decode (or read from the crop cache) and transform one image."""
    if crop_cache is not None:
        got = crop_cache.read(img_dir, img_id)
        if got is None:
            return None
        win, oy, ox, h, w = got
        return transforms.reference_transform_window(
            win, (oy, ox), (h, w), rng, img_size, train=train, raw=raw)
    img = _imread(os.path.join(img_dir, img_id))
    if img is None:
        return None
    return transforms.reference_transform(img, rng, img_size, train=train,
                                          raw=raw)


def study_id_to_int(study_id: str) -> int:
    try:
        return int(study_id)
    except (TypeError, ValueError):
        # stable across processes (the builtin hash() is salted per process)
        digest = hashlib.md5(str(study_id).encode()).digest()
        return int.from_bytes(digest[:8], "little") % (2 ** 62)


def _read_metadata_csv(path: str) -> List[Dict[str, str]]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


class CXRImageDataset:
    """Images only (reference CXRImageDataset, model_utils.py:41-89): a
    metadata CSV whose ``data_key`` column holds image paths under
    ``img_dir``.  ``compact``: the crop in its 8- or 16-bit source dtype,
    normalized on the device (ops/image_norm.py)."""

    def __init__(self, img_dir: str, dataset_metadata: str,
                 img_size: int = 256, data_key: str = "mimic_id",
                 compact: bool = False, crop_cache=None):
        self.img_dir = img_dir
        self.img_size = img_size
        self.rows = _read_metadata_csv(dataset_metadata)
        self.data_key = data_key
        self.compact = compact
        self.crop_cache = crop_cache

    def __len__(self):
        return len(self.rows)

    def load(self, idx: int, rng: Optional[np.random.Generator],
             train: bool = True) -> Optional[Dict[str, np.ndarray]]:
        img = _read_transformed(self.img_dir, self.rows[idx][self.data_key],
                                self.img_size, rng, train, self.compact,
                                self.crop_cache)
        if img is None:
            return None
        return {"image": img[..., None]}  # HWC, C = 1


class CXRImageReportDataset:
    """Image and tokenized report pairs (reference model_utils.py:92-230):
    the report of the image's study from ``token_features`` (a
    TokenFeatureSet); a study without one is an unreadable record.
    ``compact``: the integer crop, uint16 ids (where the vocabulary fits),
    uint8 masks and segments; the step widens them on the device."""

    def __init__(self, token_features, img_dir: str, dataset_metadata: str,
                 img_size: int = 256, data_key: str = "mimic_id",
                 compact: bool = False, crop_cache=None):
        self.tokens = token_features
        self.img_dir = img_dir
        self.img_size = img_size
        self.rows = _read_metadata_csv(dataset_metadata)
        self.crop_cache = crop_cache
        self.data_key = data_key
        self.compact = compact
        self._narrow_ids = bool(compact) and \
            int(token_features.input_ids.max(initial=0)) < 2 ** 16

    def __len__(self):
        return len(self.rows)

    def token_length(self, idx: int) -> int:
        """The report's true token count (its mask's sum; 0 without a
        report): what sequence bucketing reads."""
        study_id = MimicID.get_study_id(self.rows[idx][self.data_key])
        tok = self.tokens.lookup(study_id)
        return 0 if tok is None else int(tok[1].sum())

    def load(self, idx: int, rng: Optional[np.random.Generator],
             train: bool = True) -> Optional[Dict[str, np.ndarray]]:
        img_id = self.rows[idx][self.data_key]
        study_id = MimicID.get_study_id(img_id)
        tok = self.tokens.lookup(study_id)
        if tok is None:
            return None
        img = _read_transformed(self.img_dir, img_id, self.img_size, rng,
                                train, self.compact, self.crop_cache)
        if img is None:
            return None
        ids, mask, segments = tok
        if self.compact:
            if self._narrow_ids:
                ids = ids.astype(np.uint16)
            mask = mask.astype(np.uint8)
            segments = segments.astype(np.uint8)
        return {"image": img[..., None], "txt_ids": ids, "txt_masks": mask,
                "txt_segments": segments,
                "study_id": np.int64(study_id_to_int(study_id))}


class CXRImageDiseaseDataset:
    """One disease's classification set (reference model_utils.py:232-337):
    the metadata rows of its positive and negative studies from
    ``disease_stats.csv``, in file order, until the recorded counts are
    reached."""

    def __init__(self, img_dir: str, dataset_metadata: str, disease: str,
                 disease_stats: str, img_size: int = 256,
                 data_key: str = "mimic_id", compact: bool = False,
                 crop_cache=None):
        pos, neg = read_disease_stats(disease_stats, disease)
        pos_set, neg_set = set(pos), set(neg)
        self.img_dir = img_dir
        self.img_size = img_size
        self.data_key = data_key
        self.compact = compact
        self.crop_cache = crop_cache
        self.rows: List[Dict[str, str]] = []
        self.labels: List[int] = []
        cap = len(pos) + len(neg)
        for row in _read_metadata_csv(dataset_metadata):
            study = MimicID.get_study_id(row[data_key])
            if study in pos_set:
                self.rows.append(row)
                self.labels.append(1)
            elif study in neg_set:
                self.rows.append(row)
                self.labels.append(0)
            if len(self.rows) >= cap:
                break

    def __len__(self):
        return len(self.rows)

    def load(self, idx: int, rng: Optional[np.random.Generator],
             train: bool = True) -> Optional[Dict[str, np.ndarray]]:
        img = _read_transformed(self.img_dir, self.rows[idx][self.data_key],
                                self.img_size, rng, train, self.compact,
                                self.crop_cache)
        if img is None:
            return None
        return {"image": img[..., None],
                "label": np.float32(self.labels[idx])}


class Loader:
    """Deterministic shuffling batcher for training (samples loaded with
    ``train=True``, every epoch shuffled, the remainder dropped) with
    skip-and-count, sequence bucketing (``bucket_lengths``: samples grouped
    by their true token length into the smallest bucket that fits, text
    arrays sliced to the bucket length) and a background producer thread
    ``QUEUE_BATCHES`` batches ahead."""

    QUEUE_BATCHES = 2

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 bucket_lengths: Optional[Sequence[int]] = None,
                 num_workers: int = 0,
                 process_count: int = 1, process_index: int = 0):
        if process_count != 1 or process_index != 0:
            raise NotImplementedError(
                f"multi-process input slicing {_PARALLEL}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.bucket_lengths = sorted(bucket_lengths) if bucket_lengths else None
        self._template = None  # zeros of a readable record (resumed epochs)
        # threads decode concurrently and are consumed in submission order,
        # so the composition does not depend on the count; capped at
        # cpu_count - 1, as in JAX (no spare core: pure overhead)
        self.num_workers = max(0, min(num_workers, (os.cpu_count() or 1) - 1))
        self.skipped = 0
        self._skip_lock = threading.Lock()
        self._batches_per_epoch: Optional[int] = None

    def _count_skip(self, idx: int, substituted: bool = False) -> None:
        with self._skip_lock:
            self.skipped += 1
        if substituted:
            logger.warning("substituting zeros for unreadable record %d "
                           "(a resumed epoch keeps its batch composition)",
                           idx)
        else:
            logger.warning("skipping unreadable record %d", idx)

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def batches_per_epoch(self) -> int:
        """Batches yielded per epoch (less skipped records).  With
        bucketing each bucket drops its own remainder, so this is below
        ``len(loader)`` in general; the schedule's t_total uses it."""
        if self.bucket_lengths is None:
            return len(self)
        if self._batches_per_epoch is None:
            counts = {b: 0 for b in self.bucket_lengths}
            for idx in range(len(self.dataset)):
                counts[self._bucket_of(idx)] += 1
            self._batches_per_epoch = sum(c // self.batch_size
                                          for c in counts.values())
        return self._batches_per_epoch

    def _bucket_of(self, idx: int) -> int:
        length = self.dataset.token_length(idx)
        for b in self.bucket_lengths:
            if length <= b:
                return b
        return self.bucket_lengths[-1]

    def _order(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.dataset))
        np.random.default_rng((self.seed, epoch)).shuffle(order)
        return order

    def _index_batches(self, order: np.ndarray):
        """(text length or None, indices) of each batch, composed from
        index metadata alone (no record decoded)."""
        if self.bucket_lengths is None:
            group: List[int] = []
            for idx in order:
                group.append(int(idx))
                if len(group) == self.batch_size:
                    yield None, group
                    group = []
            return
        buckets: Dict[int, List[int]] = {b: [] for b in self.bucket_lengths}
        for idx in order:
            b = self._bucket_of(int(idx))
            buckets[b].append(int(idx))
            if len(buckets[b]) == self.batch_size:
                yield b, buckets[b]
                buckets[b] = []

    def batch_lengths(self, epoch: int) -> list:
        """The bucket length (None without bucketing) of each batch of
        ``epoch``'s index-composed stream, decoding nothing."""
        return [b for b, _ in self._index_batches(self._order(epoch))]

    def epoch(self, epoch: int, start_batch: int = 0,
              skip_batches: Collection[int] = ()
              ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield stacked numpy batches for one epoch.  ``start_batch``:
        yield only batches ``start_batch:`` of the epoch's index-composed
        stream (a mid-epoch resume); ``skip_batches``: leave out these
        positions of that stream too.  The left-out records are never
        decoded, and a bad record in a composed stream is replaced by
        zeros, keeping the composition."""
        if start_batch < 0:
            raise ValueError(f"start_batch {start_batch} must be >= 0")
        skip_batches = frozenset(skip_batches)
        order = self._order(epoch)

        def sample_rng(idx):
            return np.random.default_rng((self.seed, epoch, int(idx)))

        def load(idx):
            return self.dataset.load(int(idx), sample_rng(idx), train=True)

        def iter_samples():
            """(idx, sample) in ``order``; a bounded window of decodes in
            flight on the thread pool when num_workers > 0."""
            if self.num_workers <= 0:
                for idx in order:
                    yield int(idx), load(idx)
                return
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                pending = collections.deque()
                it = iter(order)
                for i in it:
                    pending.append((int(i), pool.submit(load, i)))
                    if len(pending) >= 4 * self.num_workers:
                        break
                for i in it:
                    idx, f = pending.popleft()
                    yield idx, f.result()
                    pending.append((int(i), pool.submit(load, i)))
                while pending:
                    idx, f = pending.popleft()
                    yield idx, f.result()

        def load_or_substitute(idx: int):
            s = load(idx)
            if s is None:
                self._count_skip(idx, substituted=True)
                if self._template is None:
                    for probe in range(len(self.dataset)):
                        if probe == idx:
                            continue
                        t = load(probe)
                        if t is not None:
                            self._template = t
                            break
                    else:
                        raise RuntimeError("no readable record in the whole "
                                           "dataset")
                s = {k: np.zeros_like(v) for k, v in self._template.items()}
            elif self._template is None:
                self._template = s
            return s

        def producer_resumed(out_q: queue.Queue):
            """Batches ``start_batch:`` of the index-composed stream."""
            pool = ThreadPoolExecutor(max_workers=self.num_workers) \
                if self.num_workers > 0 else None
            try:
                for composed, (seq_len, group) in enumerate(
                        self._index_batches(order)):
                    if composed < start_batch or composed in skip_batches:
                        continue
                    if pool is not None and self._template is not None:
                        samples = list(pool.map(load_or_substitute, group))
                    else:  # serially until a template exists
                        samples = [load_or_substitute(i) for i in group]
                    out_q.put(_stack(samples, seq_len=seq_len))
            except Exception as e:  # surface in the consumer
                out_q.put(e)
            finally:
                if pool is not None:
                    pool.shutdown()
                out_q.put(None)

        def producer(out_q: queue.Queue):
            try:
                if self.bucket_lengths is None:
                    batch: List[Dict[str, np.ndarray]] = []
                    for idx, s in iter_samples():
                        if s is None:
                            self._count_skip(idx)
                            continue
                        batch.append(s)
                        if len(batch) == self.batch_size:
                            out_q.put(_stack(batch))
                            batch = []
                    return
                # bucketed: batches leave each bucket as it fills, so the
                # stream interleaves buckets in shuffled-index order
                buckets: Dict[int, List[Dict[str, np.ndarray]]] = \
                    {b: [] for b in self.bucket_lengths}
                for idx, s in iter_samples():
                    b = self._bucket_of(idx)
                    if s is None:
                        self._count_skip(idx)
                        continue
                    buckets[b].append(s)
                    if len(buckets[b]) == self.batch_size:
                        out_q.put(_stack(buckets[b], seq_len=b))
                        buckets[b] = []
            except Exception as e:  # surface in the consumer
                out_q.put(e)
            finally:
                out_q.put(None)

        q: queue.Queue = queue.Queue(maxsize=self.QUEUE_BATCHES)
        target = producer_resumed if start_batch > 0 or skip_batches \
            else producer
        t = threading.Thread(target=target, args=(q,), daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            yield item


_TEXT_KEYS = ("txt_ids", "txt_masks", "txt_segments")


def _stack(samples: List[Dict[str, np.ndarray]],
           seq_len: Optional[int] = None) -> Dict[str, np.ndarray]:
    out = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    if seq_len is not None:
        for k in _TEXT_KEYS:
            if k in out:
                out[k] = out[k][:, :seq_len]
    return out


def scan_chunks(batches: Iterator[Dict[str, np.ndarray]],
                k: int) -> Iterator[Dict[str, np.ndarray]]:
    """Group a batch stream into stacked super-batches of ``k`` batches of
    one text length (leading axis k).  Grouping reorders batches within the
    epoch; each is still used once.  Leftovers at the end come as single
    batches (``image.ndim`` 5 for a chunk, 4 for a batch)."""
    if k <= 1:
        yield from batches
        return
    pending: Dict[int, List[Dict[str, np.ndarray]]] = {}
    for b in batches:
        key = b["txt_ids"].shape[1] if "txt_ids" in b else 0
        group = pending.setdefault(key, [])
        group.append(b)
        if len(group) == k:
            yield {kk: np.stack([g[kk] for g in group]) for kk in group[0]}
            pending[key] = []
    for group in pending.values():
        yield from group


def scan_plan(keys: Sequence, k: int) -> List[List[int]]:
    """The dispatches ``scan_chunks(stream, k)`` makes of a stream whose
    batches have the grouping keys ``keys`` (text lengths): lists of batch
    positions, in the order they are yielded."""
    plan: List[List[int]] = []
    pending: Dict = {}
    for pos, key in enumerate(keys):
        group = pending.setdefault(key, [])
        group.append(pos)
        if len(group) == max(1, k):
            plan.append(group)
            pending[key] = []
    for group in pending.values():
        plan.extend([p] for p in group)
    return plan


def resume_chunks(loader: "Loader", epoch: int, steps_done: int, k: int,
                  max_len: Optional[int] = None
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """The rest of ``epoch`` after its first ``steps_done`` steps ran as
    ``scan_chunks(loader.epoch(epoch), k)`` dispatches: the dispatches the
    uninterrupted epoch makes after them, in its order, the consumed
    batches neither decoded nor yielded.  Grouping reorders batches, so the
    consumed ones are not a prefix of the stream, and ``start_batch`` alone
    would train on other batches than the run that was never stopped.
    ``max_len``: the samples' text width, where a bucket is wider (its
    batches then group with the next bucket's, as ``scan_chunks`` keys on
    the array width).  Raises ValueError at once if ``steps_done`` does not
    end a dispatch."""
    keys = [b if b is None or max_len is None else min(b, max_len)
            for b in loader.batch_lengths(epoch)]
    plan = scan_plan(keys, k)
    done, used = 0, 0
    while done < steps_done and used < len(plan):
        done += len(plan[used])
        used += 1
    if done != steps_done:
        raise ValueError(f"{steps_done} steps do not end a dispatch of "
                         f"scan_steps {k} in epoch {epoch}")
    consumed = {p for d in plan[:used] for p in d}
    return _dispatches(
        plan[used:],
        zip((p for p in range(len(keys)) if p not in consumed),
            loader.epoch(epoch, skip_batches=consumed)))


def _dispatches(plan, stream) -> Iterator[Dict[str, np.ndarray]]:
    """Each dispatch of ``plan`` from (position, batch) pairs: a chunk
    stacked on a leading axis, a single batch as it is."""
    ready: Dict[int, Dict[str, np.ndarray]] = {}
    for dispatch in plan:
        while not all(p in ready for p in dispatch):
            pos, batch = next(stream)
            ready[pos] = batch
        group = [ready.pop(p) for p in dispatch]
        yield group[0] if len(group) == 1 else \
            {kk: np.stack([g[kk] for g in group]) for kk in group[0]}


def _to_device(batch: Dict[str, np.ndarray], device: torch.device) -> dict:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            # pinned, so the copy is asynchronous; the host allocator keeps
            # the pinned block until the copy has run
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def device_prefetch(batches: Iterator[Dict], size: int = 2,
                    device="cuda") -> Iterator[dict]:
    """Torch tensors of each batch on ``device``, the copies issued
    ``size`` batches ahead of their use, inline on the consuming thread."""
    dev = resolve_device(device)
    buf = collections.deque()
    it = iter(batches)
    for b in it:
        buf.append(_to_device(b, dev))
        if len(buf) >= size:
            break
    while buf:
        out = buf.popleft()
        nxt = next(it, None)
        if nxt is not None:
            buf.append(_to_device(nxt, dev))
        yield out
