"""Run logging, the metric writer and the training-curve plot
(mimm_tpu/metrics.py counterpart, :33, :238, :258).

``MetricWriter`` writes scalars to ``<save_dir>/<name>.jsonl`` and mirrors
epoch summaries into a reference-format log file (``Epoch N loss = ...``).
The TensorBoard mirror comes with the profiling slice (ROADMAP.md queue A,
"profiling.py and tbevents.py") and raises.  ``Plot_Training`` draws with matplotlib, imported at
the call; where matplotlib is not installed it logs a warning and writes
no PNG (a host artifact; nothing reads it back).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional, Sequence

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
    save directory when given."""

    def __init__(self, save_directory: str, name: str = "metrics",
                 log_filename: Optional[str] = None,
                 tensorboard: bool = False):
        if tensorboard:
            raise NotImplementedError("the TensorBoard mirror comes with the "
                                      "profiling slice (ROADMAP.md queue A, "
                                      "\"profiling.py and tbevents.py\")")
        os.makedirs(save_directory, exist_ok=True)
        self.save_directory = save_directory
        self.jsonl_path = os.path.join(save_directory, f"{name}.jsonl")
        self._fh = open(self.jsonl_path, "a")
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
        if self._handler is not None:
            # detached, so a second run in this process logs only to its own
            self.logger.removeHandler(self._handler)
            self._handler.close()
            self._handler = None
