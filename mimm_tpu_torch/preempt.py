"""Preemption: catch SIGTERM, checkpoint at the next step boundary, resume
mid-epoch (mimm_tpu/preempt.py counterpart).

A scheduler that evicts a job sends SIGTERM and waits a grace window.
The Manager reads ``should_stop()`` after every dispatch (a host-side flag
read, no device work); on a pending signal it saves the whole train state
(``<save_directory>/mi_preempt.ckpt``), writes ``preempted=1`` to its
metrics and returns.  ``resume_from`` that file continues mid-epoch: the
loader rebuilds the epoch's batch composition from index metadata and
skips the consumed batches without decoding them.

The collective form across processes (``sync=True``) comes with the
parallel slice; one process reads its own flag.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
from typing import Optional

import torch

logger = logging.getLogger(__name__)

_flag = threading.Event()
_installed: dict = {}   # signum -> the handler before install()


def install(signals=(signal.SIGTERM,)) -> None:
    """Install handlers that set the flag; idempotent, and chaining the
    handler that was there before, so an embedding application keeps its
    own shutdown logic.  Entry points call it once; a library user who
    handles signals can call :func:`request` from their own handler."""
    for sig in signals:
        if sig in _installed:
            continue
        previous = signal.getsignal(sig)

        def _handler(signum, frame, _prev=previous):
            logger.warning("signal %d received — checkpoint-and-exit at the "
                           "next step boundary", signum)
            _flag.set()
            if callable(_prev) and _prev not in (signal.SIG_IGN,
                                                 signal.SIG_DFL):
                _prev(signum, frame)

        _installed[sig] = previous
        signal.signal(sig, _handler)


def uninstall() -> None:
    """Restore the handlers :func:`install` replaced."""
    for sig, prev in _installed.items():
        signal.signal(sig, prev)
    _installed.clear()


def request() -> None:
    """Ask for a preemption save without a signal."""
    _flag.set()


def clear() -> None:
    _flag.clear()


def resolve_resume(cfg, ckpt_name: str) -> Optional[str]:
    """``cfg.resume_from`` for a trainer whose preemption checkpoint is
    ``<save_directory>/<ckpt_name>``: "" -> None (a fresh run), "auto" ->
    that checkpoint if it exists, else None; anything else is a path."""
    resume = cfg.resume_from or None
    if resume == "auto":
        candidate = os.path.join(cfg.save_directory, ckpt_name)
        resume = candidate if os.path.exists(candidate) else None
    return resume


def requested() -> bool:
    """The flag, free to read every step."""
    return _flag.is_set()


def should_stop(sync: bool = False) -> bool:
    """True if a preemption is pending.  ``sync=True`` asks every process
    of a group to agree, which one process does trivially; across
    processes it comes with the parallel slice."""
    if sync and torch.distributed.is_available() \
            and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        raise NotImplementedError(
            "should_stop(sync=True) across processes comes with the "
            "parallel slice (ROADMAP.md queue A, \"parallel/mesh.py and "
            "parallel/pipeline.py\")")
    return requested()
