"""Run logging, the metric writer, the training-curve plots and the
validation metrics (mimm_tpu/metrics.py counterpart).

``PrintModel`` (:68), ``Plot_Training_From_Logfile`` (:93), the GDV
separability (``gdv_calculation`` :148 with its helpers :119-145),
``roc_auc`` (:163) and ``binary_classification_report`` (:193) are numpy
copies of the JAX package's functions, the reference's quirks included
(GDV divides by the ELEMENT count, reference validate.py:16-49).

``MetricWriter`` writes scalars to ``<save_dir>/<name>.jsonl``, mirrors
epoch summaries into a reference-format log file (``Epoch N loss = ...``)
and, with ``tensorboard=True``, every numeric scalar into TensorBoard event
files under ``<save_dir>/tb/<name>/`` (tbevents.py).  ``Plot_Training``
draws with matplotlib, imported at
the call; where matplotlib is not installed it logs a warning and writes
no PNG (a host artifact; nothing reads it back).
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import time
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def Plot_Training(xlabel: str, ylabel: str, title: str,
                  data: Sequence[Sequence[float]],
                  dataLabel: Sequence[str], out_image_file: str) -> None:
    """A multi-series training-curve PNG (reference utils.py:29-40), drawn
    on its own Figure."""
    try:
        import matplotlib
    except ImportError:
        logger.warning("matplotlib is not installed: %s not written",
                       out_image_file)
        return
    matplotlib.use("Agg")
    from matplotlib.figure import Figure

    fig = Figure(figsize=(8.0, 5.0))
    ax = fig.subplots()
    for series, label in zip(data, dataLabel):
        ax.plot(list(series), label=str(label))
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    if len(dataLabel):
        ax.legend()
    fig.tight_layout()
    fig.savefig(out_image_file)


def PrintModel(params, logger: Optional[logging.Logger] = None,
               print_values: bool = True) -> int:
    """Log every parameter (name, shape, dtype and by default the values),
    the reference's weight dump (utils.py:21-26), and return the total
    parameter count.  ``params``: an ``nn.Module`` (its parameters) or a
    state dict of tensors or arrays."""
    log = (logger or logging.getLogger("mimm_tpu_torch.model")).info
    items = params.named_parameters() if hasattr(params, "named_parameters") \
        else params.items()
    total = 0
    for name, leaf in items:
        arr = leaf.detach().cpu().numpy() if hasattr(leaf, "detach") \
            else np.asarray(leaf)
        total += int(arr.size)
        if print_values:
            log("%s %s %s\n%s", name, arr.shape, arr.dtype, arr)
        else:
            log("%s %s %s", name, arr.shape, arr.dtype)
    log("total parameters: %d", total)
    return total


def Plot_Training_From_Logfile(log_file: str,
                               out_image_file: Optional[str] = None):
    """The ``Epoch N loss = X`` lines of a reference-format log, sorted by
    epoch, as a list of losses; with ``out_image_file``, their curve."""
    losses = []
    pat = re.compile(r"Epoch (\d+) loss = (-?[0-9.]+)")
    with open(log_file) as f:
        for line in f:
            m = pat.search(line)
            if m:
                losses.append((int(m.group(1)), float(m.group(2))))
    losses.sort()
    series = [v for _, v in losses]
    if out_image_file and series:
        Plot_Training("Epochs", "Value for Loss",
                      os.path.basename(log_file), [series], ["train loss"],
                      out_image_file)
    return series


# ---- GDV separability (reference validate.py:16-49) ------------------------

def z_scored_transform(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    mean = x.mean(axis=0)
    std = x.std(axis=0)
    std = np.where(std == 0.0, 1.0, std)
    return (x - mean) / std


def _pairwise_euclidean(a: np.ndarray,
                        b: Optional[np.ndarray] = None) -> np.ndarray:
    b = a if b is None else b
    aa = (a * a).sum(1)[:, None]
    bb = (b * b).sum(1)[None, :]
    d2 = np.maximum(aa + bb - 2.0 * (a @ b.T), 0.0)
    return np.sqrt(d2)


def mean_intra_class_distance(items: np.ndarray) -> float:
    d = _pairwise_euclidean(items)
    total_items = items.shape[0] * items.shape[1]  # reference: element count
    return float(d.sum() * 2 / (total_items * (total_items - 1)))


def mean_inter_class_distance(source: np.ndarray, dest: np.ndarray) -> float:
    d = _pairwise_euclidean(source, dest)
    ts = source.shape[0] * source.shape[1]
    td = dest.shape[0] * dest.shape[1]
    return float(d.sum() / (ts * td))


def gdv_calculation(positive_embeddings, negative_embeddings) -> float:
    """Generalised discrimination value (reference validate.py:37-49)."""
    pos = z_scored_transform(np.asarray(positive_embeddings))
    neg = z_scored_transform(np.asarray(negative_embeddings))
    pos_intra = mean_intra_class_distance(pos)
    neg_intra = mean_intra_class_distance(neg)
    inter = mean_inter_class_distance(pos, neg)
    dim_inv = 1.0 / math.sqrt(len(pos) + len(neg))
    return dim_inv * ((pos_intra + neg_intra) / 2.0 - inter)


# ---- extended binary-classification metrics ---------------------------------

def roc_auc(labels, scores) -> float:
    """Area under the ROC curve by the rank statistic (Mann-Whitney U),
    ties at their midrank; NaN when only one class is present."""
    labels = np.asarray(labels).astype(bool).ravel()
    scores = np.asarray(scores, np.float64).ravel()
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(scores.size, np.float64)
    ranks[order] = np.arange(1, scores.size + 1)
    sorted_scores = scores[order]
    i = 0
    while i < sorted_scores.size:
        j = i
        while j + 1 < sorted_scores.size and \
                sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    u = ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def binary_classification_report(labels, probs,
                                 threshold: float = 0.5) -> dict:
    """Accuracy, AUC, precision, recall, F1 and the confusion counts of a
    sigmoid classifier.  At threshold 0.5 the predictions are
    ``np.round`` (half to even, as the reference's validate.py:143), else
    ``probs >= threshold``; the standard fp/fn (the reference's per-epoch
    tallies swap them, main_utils.py:504-505); an empty denominator gives
    NaN, F1 0 for an all-wrong classifier."""
    labels = np.asarray(labels, np.float64).ravel()
    probs = np.asarray(probs, np.float64).ravel()
    pred = np.round(probs) if threshold == 0.5 \
        else (probs >= threshold).astype(np.float64)
    tp = float(((pred == 1) & (labels == 1)).sum())
    tn = float(((pred == 0) & (labels == 0)).sum())
    fp = float(((pred == 1) & (labels == 0)).sum())
    fn = float(((pred == 0) & (labels == 1)).sum())
    total = labels.size

    def _ratio(num, den):
        return float(num / den) if den > 0 else float("nan")

    return {
        "accuracy": _ratio(tp + tn, total),
        "auc": roc_auc(labels, probs),
        "precision": _ratio(tp, tp + fp),
        "recall": _ratio(tp, tp + fn),
        "f1": _ratio(2 * tp, 2 * tp + fp + fn),
        "tp": int(tp), "tn": int(tn), "fp": int(fp), "fn": int(fn),
        "positives": int(labels.sum()),
        "negatives": int(total - labels.sum()),
    }


_LOG_FORMAT = logging.Formatter("%(asctime)s - %(name)s %(message)s",
                                datefmt="%m-%d %H:%M")


def configure_run_logging(filename: str) -> None:
    """Point the root logger's file output at this run's log file: earlier
    root FileHandlers are removed (``logging.basicConfig`` would keep the
    first run's file for every later run)."""
    root = logging.getLogger()
    for h in list(root.handlers):
        if isinstance(h, logging.FileHandler):
            root.removeHandler(h)
            h.close()
    handler = logging.FileHandler(filename, mode="w")
    handler.setFormatter(_LOG_FORMAT)
    root.addHandler(handler)
    root.setLevel(logging.INFO)


class MetricWriter:
    """Scalars to ``<save_directory>/<name>.jsonl``; epoch summaries also
    to the logger ``mimm_tpu_torch.<name>``, and to ``log_filename`` in the
    save directory when given.  ``tensorboard=True`` mirrors every numeric
    scalar of each record as a TensorBoard event under
    ``<save_directory>/tb/<name>/`` (tbevents.TBEventWriter), at the
    record's ``step``, else its ``epoch``, else one past the last step
    written."""

    def __init__(self, save_directory: str, name: str = "metrics",
                 log_filename: Optional[str] = None,
                 tensorboard: bool = False):
        os.makedirs(save_directory, exist_ok=True)
        self.save_directory = save_directory
        self.jsonl_path = os.path.join(save_directory, f"{name}.jsonl")
        self._fh = open(self.jsonl_path, "a")
        self._tb = None
        if tensorboard:
            from mimm_tpu_torch.tbevents import TBEventWriter
            self._tb = TBEventWriter(os.path.join(save_directory, "tb", name))
        self._tb_step = 0  # the ordinal of a record without a step
        self.logger = logging.getLogger(f"mimm_tpu_torch.{name}")
        self._handler = None
        if log_filename is not None:
            self._handler = logging.FileHandler(
                os.path.join(save_directory, log_filename))
            self._handler.setFormatter(_LOG_FORMAT)
            self.logger.addHandler(self._handler)
            self.logger.setLevel(logging.INFO)

    def write(self, step: Optional[int] = None, **scalars) -> None:
        rec = {"time": time.time()}
        if step is not None:
            rec["step"] = step
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in scalars.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._tb is not None:
            # an epoch record (epoch_summary) carries its ordinal as the
            # 'epoch' scalar, not as the step
            tb_step = step if step is not None else \
                int(rec.get("epoch", self._tb_step))
            self._tb_step = tb_step + 1
            for k, v in rec.items():
                # 'epoch' is the record's ordinal, not a metric
                if k not in ("time", "step", "epoch") and \
                        isinstance(v, (int, float)):
                    self._tb.scalar(k, v, tb_step, wall_time=rec["time"])
            self._tb.flush()

    def epoch_summary(self, epoch: int, loss: float, seconds: float,
                      checkpoint_path: Optional[str] = None) -> None:
        """Reference log-line format (main_utils.py:251-253)."""
        self.logger.info(f"  Epoch {epoch} loss = {loss:.5f}")
        self.logger.info(f"  Epoch {epoch} took {seconds:.3f} s")
        if checkpoint_path:
            self.logger.info(f"  Epoch {epoch} checkpoint saved in "
                             f"{checkpoint_path}")
        self.write(epoch=epoch, epoch_loss=loss, epoch_seconds=seconds)

    def close(self) -> None:
        self._fh.close()
        if self._tb is not None:
            self._tb.close()
        if self._handler is not None:
            # detached, so a second run in this process logs only to its own
            self.logger.removeHandler(self._handler)
            self._handler.close()
            self._handler = None
