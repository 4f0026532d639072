"""Host input pipeline: the deterministic loader, scan chunks and the
device prefetch (mimm_tpu/data/pipeline.py counterpart, :70, :218-569).

* ``Loader`` batches an index -> sample dataset (``len`` and
  ``load(idx, rng, train)``; ``token_length(idx)`` for bucketing),
  deterministic per (seed, epoch): the epoch's shuffle comes from
  ``default_rng((seed, epoch))`` and each sample's augmentation from
  ``default_rng((seed, epoch, idx))``, so the batch stream is bit-equal to
  the JAX package's for the same dataset.  Bad records (``load`` returns
  None) are skipped and counted in ``loader.skipped``.  ``num_workers``
  threads decode ahead and are consumed in submission order.
* ``scan_chunks`` groups same-shape batches into stacked super-batches for
  ``make_mi_multi_step``.
* ``device_prefetch`` copies batches to the card ``size`` batches ahead of
  their use: pinned host memory and ``non_blocking=True`` copies, issued on
  the consuming thread (JAX measured a transfer thread slower, :562-568).

The on-disk datasets (JPEG decode, transforms, the crop cache) come with a
later slice (ROADMAP.md queue A, item 4); the loader takes any object with
the dataset interface.  Multi-process slicing (``process_count`` > 1)
comes with the parallel slice (item 9) and raises.
"""

from __future__ import annotations

import collections
import hashlib
import logging
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from mimm_tpu_torch import resolve_device

logger = logging.getLogger(__name__)


def study_id_to_int(study_id: str) -> int:
    try:
        return int(study_id)
    except (TypeError, ValueError):
        # stable across processes (the builtin hash() is salted per process)
        digest = hashlib.md5(str(study_id).encode()).digest()
        return int.from_bytes(digest[:8], "little") % (2 ** 62)


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
                "multi-process input slicing comes with the parallel slice "
                "(ROADMAP.md queue A, item 9)")
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

    def epoch(self, epoch: int, start_batch: int = 0
              ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield stacked numpy batches for one epoch.  ``start_batch``:
        yield only batches ``start_batch:`` of the epoch's index-composed
        stream (a mid-epoch resume), decoding none of the skipped records;
        a bad record there is replaced by zeros, keeping the composition."""
        if start_batch < 0:
            raise ValueError(f"start_batch {start_batch} must be >= 0")
        n = len(self.dataset)
        order = np.arange(n)
        np.random.default_rng((self.seed, epoch)).shuffle(order)

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

        def index_batches():
            """The batch composition from index metadata alone."""
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
                for composed, (seq_len, group) in enumerate(index_batches()):
                    if composed < start_batch:
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
        target = producer_resumed if start_batch > 0 else producer
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
