"""Tracing, step profiling and runtime checks (mimm_tpu/profiling.py
counterpart).

* ``trace(logdir)``: a context that records host and device activity with
  ``torch.profiler`` (CPU, and CUDA where a card is present) and writes a
  Chrome-trace JSON into ``logdir`` through
  ``torch.profiler.tensorboard_trace_handler`` (it needs no
  ``tensorboard`` package; the file opens in TensorBoard's profiler
  plugin, Perfetto or chrome://tracing).
* ``annotate(name)``: a named span in such a trace (``record_function``).
* ``StepProfiler``: traces the first N dispatches of a trainer's loop
  (``cfg.profile_steps``) into ``<save_directory>/profile/``.
* ``StepTimer``: per-step wall timing with pairs/s over a window.
* ``debug_mode()``: autograd's anomaly mode with its NaN check.

JAX's ``enable_fast_rng`` selects the TPU's hardware PRNG for dropout
masks; it has no counterpart on the H100, where every mask comes from a
torch generator seeded per step (config.py ``rng_impl``), so it is not
defined here.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _start(logdir: str) -> torch.profiler.profile:
    """A profiler recording into a trace file in ``logdir``, started.  It
    attaches to the card first (a warm-up cycle whose events are dropped),
    waits for the card, and only then opens the window the file keeps:
    kernels launched just after the attach can be missing from a trace
    that opens at once."""
    prof = torch.profiler.profile(
        activities=_activities(),
        schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    prof.start()
    _sync()
    prof.step()
    return prof


def _sync(value=None) -> None:
    """A data-dependent read of ``value`` (a step's loss), then the card's
    whole queue: the traced device work has ended when this returns."""
    if torch.is_tensor(value):
        value.detach().cpu()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Record host and device activity while the context is open into a
    trace file in ``logdir``."""
    prof = _start(logdir)
    try:
        yield prof
    finally:
        _sync()
        prof.stop()


def annotate(name: str):
    """A span named ``name`` in the trace of an enclosing profiler."""
    return torch.profiler.record_function(name)


class StepProfiler:
    """Trace the first ``steps`` dispatches of a trainer's loop into
    ``logdir`` (``cfg.profile_steps``; the MI Manager and the autoencoder
    trainer run it).

    ``start()`` begins the trace (the trainers call it before an epoch's
    first dispatch; it does nothing once the N dispatches are traced).
    ``step(value)`` counts one dispatch (a ``scan_steps`` chunk counts as
    one), starting the trace if ``start`` was not called; on the Nth it
    reads ``value`` (that dispatch's loss) back from the device, waits for
    the card and stops, so the traced steps' device work is in the file.
    ``close()`` stops early, when the epoch ran out of dispatches or the
    run was preempted.  ``trace_path`` names the file written.

    JAX's StepProfiler starts on the first ``step``, after the first
    dispatch was queued, and its trace still holds that dispatch's device
    work; torch.profiler records a kernel only if it was launched while it
    runs, hence ``start``."""

    def __init__(self, logdir: str, steps: int):
        self.logdir = logdir
        self.remaining = int(steps)
        self.trace_path: Optional[str] = None
        self._prof: Optional[torch.profiler.profile] = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        if self._prof is None and self.remaining > 0:
            self._prof = _start(self.logdir)

    def step(self, sync_value) -> None:
        if self.remaining <= 0:
            return
        self.start()
        self.remaining -= 1
        if self.remaining == 0:
            self.close(sync_value)

    def close(self, sync_value=None) -> None:
        if self._prof is None:
            return
        _sync(sync_value)
        self._prof.stop()
        self.trace_path = _newest_trace(self.logdir)
        self._prof = None
        self.remaining = 0


def _newest_trace(logdir: str) -> Optional[str]:
    names = [os.path.join(logdir, f) for f in os.listdir(logdir)
             if f.endswith(".pt.trace.json")] if os.path.isdir(logdir) else []
    return max(names, key=os.path.getmtime) if names else None


@contextlib.contextmanager
def debug_mode(nan_checks: bool = True) -> Iterator[None]:
    """Autograd's anomaly mode with ``check_nan``: a backward function
    that returns a NaN raises, naming the forward operation that made it.

    JAX's ``jax_debug_nans`` checks the output of every primitive, forward
    and backward; here a NaN is caught where it reaches a gradient (a NaN
    that stays in the forward, as a masked or unused value, does not
    raise), and the forward runs slower while the mode records each
    operation's stack."""
    with torch.autograd.set_detect_anomaly(nan_checks, check_nan=nan_checks):
        yield


class StepTimer:
    """Per-step timing with throughput accounting.

    Measures wall time between ``tick()`` calls; as dispatch is
    asynchronous, a step's time is only meaningful across a window, so the
    window's median is reported."""

    def __init__(self, batch_size: int, writer=None, window: int = 50):
        self.batch_size = batch_size
        self.writer = writer
        self.window = window
        self._times = []
        self._last: Optional[float] = None
        self.steps = 0

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        self.steps += 1
        if self.writer is not None and self.steps % self.window == 0:
            self.writer.write(step=self.steps,
                              pairs_per_sec=self.pairs_per_sec())

    def step_ms(self) -> float:
        if not self._times:
            return float("nan")
        s = sorted(self._times)
        return 1e3 * s[len(s) // 2]

    def pairs_per_sec(self) -> float:
        ms = self.step_ms()
        return self.batch_size / (ms / 1e3) if ms == ms and ms > 0 \
            else float("nan")
