"""The port's profiling and TensorBoard mirror (mimm_tpu_torch/profiling.py,
tbevents.py, metrics.py ``MetricWriter(tensorboard=True)``) and the
trainers' ``profile_steps`` / ``tensorboard`` knobs, against the JAX
package's (mimm_tpu/profiling.py, tbevents.py, metrics.py:263-290).

* ``StepProfiler`` through the MI Manager (tests/test_torch_manager.py's
  tiny BERT and image size, 12 pairs of B=4 in one epoch: with
  ``scan_steps`` 2 that is a chunk of 2 steps, then one step) at
  ``profile_steps`` 1: the trace under ``<save>/profile/`` holds the
  chunk's two steps and not the third (a chunk counts as one dispatch);
  through the autoencoder trainer (a small ResNetAE, 3 steps) at
  ``profile_steps`` 5: the epoch ends first, and the trace holds its 3
  steps.  Each step body runs inside an ``annotate`` span, which the
  trace names.
* ``StepProfiler.close()`` stops early (2 of 5 steps, after
  ``start()``), and does nothing before a start; ``trace`` writes a file
  naming an ``annotate`` span.
* ``StepTimer`` passes tests/test_native_and_resume.py:97's check, and on
  a scripted clock gives JAX's ``step_ms`` and ``pairs_per_sec``.
* ``debug_mode`` raises on a NaN gradient (sqrt at 0 times 0), and the
  same backward outside it, or with ``nan_checks=False``, does not.
* The port's ``TBEventWriter`` and JAX's, given the same scalars and wall
  times, write the same bytes after the file-version record; both files
  decode through tensorboard's ``EventAccumulator`` and through the
  port's ``read_scalars`` (which checks every CRC) to the same tags,
  steps and values.
* ``tensorboard=True`` through the Manager, the autoencoder trainer and
  the classifier trainer: the event files under ``<save>/tb/<name>/``
  decode (``EventAccumulator``) to every numeric scalar of the run's
  JSONL, at its step, else its epoch.

The JAX side runs in the pytest worker, the port side in a jax-free child
(tests/torch_port_child.py).
"""

import glob
import json
import os
import sys

import numpy as np
import pytest

# (tag, value, step, wall time)
SCALARS = [("loss", 0.25, 0, 1000.0), ("loss", -1.5, 1, 1001.5),
           ("pairs_per_sec", 512.0, 1, 1001.5),
           ("epoch_loss", 3.0e-7, 7, 1e9), ("big", -2.0 ** 40, 2 ** 40, 0.0)]
CLOCK = [0.0, 0.011, 0.023, 0.030, 0.052, 0.061, 0.075]
STEP_SPAN = "test_profiling_step"
TRAINERS = ["manager", "ae", "classifier"]


def _write_events(writer_cls, logdir):
    w = writer_cls(logdir)
    for tag, value, step, wall in SCALARS:
        w.scalar(tag, value, step, wall_time=wall)
    w.close()
    return w.path


def _accumulate(path):
    """{(tag, step): value} of an event file or directory, read by
    tensorboard's EventAccumulator."""
    from tensorboard.backend.event_processing import event_accumulator
    acc = event_accumulator.EventAccumulator(path)
    acc.Reload()
    return {(tag, e.step): e.value for tag in acc.Tags()["scalars"]
            for e in acc.Scalars(tag)}


def _jsonl_scalars(path):
    """{(tag, step): value} that MetricWriter's rule makes of a JSONL."""
    out, ordinal = {}, 0
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            step = rec.get("step", rec.get("epoch", ordinal))
            ordinal = step + 1
            out.update({(k, step): v for k, v in rec.items()
                        if k not in ("time", "step", "epoch")
                        and isinstance(v, (int, float))})
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from mimm_tpu import profiling as jprof
    from mimm_tpu import tbevents as jtb
    from tests.torch_port_child import run_child

    job = str(tmp_path_factory.mktemp("profiling"))
    jax_events = _write_events(jtb.TBEventWriter,
                               os.path.join(job, "jax_events"))
    ticks = iter(CLOCK)
    real = jprof.time.perf_counter
    jprof.time.perf_counter = lambda: next(ticks)
    try:
        timer = jprof.StepTimer(batch_size=64, window=4)
        for _ in CLOCK:
            timer.tick()
    finally:
        jprof.time.perf_counter = real
    np.savez(os.path.join(job, "in.npz"))
    with open(os.path.join(job, "jax.json"), "w") as f:
        json.dump({"events": jax_events}, f)
    got, meta = run_child(__file__, job, timeout=600)
    want = {"timer": [timer.step_ms(), timer.pairs_per_sec(), timer.steps],
            "events": jax_events,
            "accumulated": {"jax": _accumulate(jax_events),
                            "port": _accumulate(meta["port_events"])},
            "trainer_events": {
                name: (_accumulate(os.path.join(run["save"], "tb",
                                                run["name"])),
                       _jsonl_scalars(os.path.join(run["save"],
                                                   f"{run['name']}.jsonl")))
                for name, run in meta["trainers"].items()}}
    return want, meta


def _spans(trace_path):
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return sum(e.get("name") == STEP_SPAN and e.get("cat") == "user_annotation"
               for e in events)


@pytest.mark.parametrize("trainer,spans", [("manager", 2), ("ae", 3)])
def test_step_profiler_writes_trace(results, trainer, spans):
    run = results[1]["trainers"][trainer]
    traces = glob.glob(os.path.join(run["save"], "profile", "*.pt.trace.json"))
    assert len(traces) == 1, traces
    assert run["trace_path"] == traces[0]
    assert _spans(traces[0]) == spans
    assert run["steps"] == 3


def test_step_profiler_close_stops_early(results):
    unit = results[1]["unit"]
    assert unit["before_start"] == {"active": False, "trace_path": None,
                                    "files": []}, unit
    assert unit["after_close"]["active"] is False
    assert unit["after_close"]["remaining"] == 0
    assert _spans(unit["after_close"]["trace_path"]) == 2
    assert unit["later_steps_ignored"], unit


def test_trace_writes_annotated_span(results):
    path = results[1]["unit"]["trace"]
    assert path.endswith(".pt.trace.json")
    assert _spans(path) == 1


def test_step_timer_matches_jax(results):
    want, meta = results
    timer = meta["timer"]
    assert timer["steps"] == 5
    assert 64 / 0.1 < timer["pairs_per_sec"] < 64 / 0.005
    assert meta["scripted_timer"] == want["timer"]


def test_debug_mode_raises_on_nan_gradient(results):
    nan = results[1]["debug_mode"]
    assert nan["on"].startswith("RuntimeError") and "nan" in nan["on"], nan
    assert nan["off"] == nan["disabled"] == "no error", nan


def test_tb_events_match_jax(results):
    want, meta = results
    with open(want["events"], "rb") as f:
        jax_bytes = f.read()
    with open(meta["port_events"], "rb") as f:
        port_bytes = f.read()
    # the version record holds its own wall time: compare after it
    first = 8 + 4 + int.from_bytes(jax_bytes[:8], "little") + 4
    assert len(port_bytes) == len(jax_bytes)
    assert port_bytes[first:] == jax_bytes[first:]
    acc = want["accumulated"]
    assert acc["port"] == acc["jax"]
    assert sorted(acc["port"]) == sorted((t, s) for t, _, s, _ in SCALARS)
    for reader in ("port_read", "jax_read"):
        got = meta[reader]
        assert [(t, s) for _, s, t, _ in got] == \
            [(t, s) for t, _, s, _ in SCALARS]
        assert [w for w, *_ in got] == [w for *_, w in SCALARS]
        assert [v for *_, v in got] == [float(np.float32(v))
                                        for _, v, _, _ in SCALARS]
    assert meta["bad_crc"].startswith("ValueError"), meta["bad_crc"]


@pytest.mark.parametrize("trainer", TRAINERS)
def test_metric_writer_mirrors_jsonl(results, trainer):
    events, jsonl = results[0]["trainer_events"][trainer]
    assert jsonl and sorted(events) == sorted(jsonl), (events, jsonl)
    for key, value in jsonl.items():
        assert events[key] == pytest.approx(value, rel=1e-6, abs=1e-30), key
    assert results[1]["trainers"][trainer]["port_read_equal"]


class ImageDataset:
    """tests/test_train.py:19's image dataset: 12 float images of 64²."""

    def __init__(self, n=12, size=64):
        self.imgs = np.random.default_rng(0).random(
            (n, size, size, 1)).astype(np.float32)

    def __len__(self):
        return len(self.imgs)

    def load(self, idx, rng, train=True):
        return {"image": self.imgs[idx]}


def _error_of(fn) -> str:
    try:
        fn()
    except Exception as e:    # noqa: BLE001 - the message is the result
        return f"{type(e).__name__}: {e}".splitlines()[0]
    return "no error"


def _child(job):
    import time

    import torch

    from mimm_tpu_torch import profiling, tbevents
    from mimm_tpu_torch.config import TrainingConfig
    from mimm_tpu_torch.models.autoencoder import ResNetAE
    from mimm_tpu_torch.models.bert import BertConfig
    from mimm_tpu_torch.ops.image_norm import device_normalize
    from mimm_tpu_torch.train import ae, classifier as clf, mi
    from tests.test_torch_ae_train import SMALL
    from tests.test_torch_classifier import FakeDiseaseDataset
    from tests.test_torch_manager import BERT, CFG, FakePairedDataset

    torch.backends.mkldnn.enabled = False
    meta = {"trainers": {}}
    with open(os.path.join(job, "jax.json")) as f:
        jax_events = json.load(f)["events"]

    # ---- the event writer ------------------------------------------------
    meta["port_events"] = _write_events(tbevents.TBEventWriter,
                                        os.path.join(job, "port_events"))
    meta["port_read"] = tbevents.read_scalars(meta["port_events"])
    meta["jax_read"] = tbevents.read_scalars(jax_events)
    with open(meta["port_events"], "rb") as f:
        data = bytearray(f.read())
    data[-5] ^= 1             # a flipped bit in the last record's data
    bad = os.path.join(job, "bad.tfevents")
    with open(bad, "wb") as f:
        f.write(bytes(data))
    meta["bad_crc"] = _error_of(lambda: tbevents.read_scalars(bad))

    # ---- StepTimer, StepProfiler, trace, debug_mode ------------------------
    timer = profiling.StepTimer(batch_size=64, window=4)
    for _ in range(5):
        timer.tick()
        time.sleep(0.01)
    meta["timer"] = {"steps": timer.steps,
                     "pairs_per_sec": timer.pairs_per_sec()}
    ticks = iter(CLOCK)
    real_clock = profiling.time.perf_counter
    profiling.time.perf_counter = lambda: next(ticks)
    try:
        scripted = profiling.StepTimer(batch_size=64, window=4)
        for _ in CLOCK:
            scripted.tick()
    finally:
        profiling.time.perf_counter = real_clock
    meta["scripted_timer"] = [scripted.step_ms(), scripted.pairs_per_sec(),
                              scripted.steps]

    def toy_step():
        with profiling.annotate(STEP_SPAN):
            x = torch.randn(8, 8, requires_grad=True)
            loss = (x @ x).square().sum()
            loss.backward()
        return loss

    logdir = os.path.join(job, "unit_profile")
    sp = profiling.StepProfiler(logdir, 5)
    sp.close()
    before = {"active": sp.active, "trace_path": sp.trace_path,
              "files": os.listdir(logdir) if os.path.isdir(logdir) else []}
    sp.start()
    for _ in range(2):
        sp.step(toy_step())
    sp.close()
    after = {"active": sp.active, "remaining": sp.remaining,
             "trace_path": sp.trace_path}
    sp.step(toy_step())
    meta["unit"] = {"before_start": before, "after_close": after,
                    "later_steps_ignored": not sp.active
                    and len(os.listdir(logdir)) == 1}
    with profiling.trace(os.path.join(job, "trace")) as _:
        toy_step()
    meta["unit"]["trace"] = profiling._newest_trace(os.path.join(job,
                                                                 "trace"))

    def nan_backward():
        x = torch.zeros(3, requires_grad=True)
        (torch.sqrt(x) * 0).sum().backward()

    def under(mode):
        def run():
            with profiling.debug_mode(mode):
                nan_backward()
        return run

    meta["debug_mode"] = {"on": _error_of(under(True)),
                          "off": _error_of(nan_backward),
                          "disabled": _error_of(under(False))}

    # ---- the trainers, each step body inside an annotate span -------------
    real_body = mi.make_mi_step_body

    def spanned_body(*a, **kw):
        body = real_body(*a, **kw)

        def step(state, batch):
            with profiling.annotate(STEP_SPAN):
                return body(state, batch)
        return step

    def record(name, save, jsonl_name, steps, profiler=None):
        tb_dir = os.path.join(save, "tb", jsonl_name)
        (events,) = glob.glob(os.path.join(tb_dir, "events.out.tfevents.*"))
        read = {(t, s): v for _, s, t, v in tbevents.read_scalars(events)}
        want = {k: float(np.float32(v)) for k, v in _jsonl_scalars(
            os.path.join(save, f"{jsonl_name}.jsonl")).items()}
        meta["trainers"][name] = {
            "save": save, "name": jsonl_name, "steps": steps,
            "trace_path": profiler.trace_path if profiler else None,
            "port_read_equal": read == want}

    profilers = []
    real_profiler = profiling.StepProfiler

    class KeptProfiler(real_profiler):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            profilers.append(self)

    mi.make_mi_step_body = spanned_body
    mi.StepProfiler = ae.StepProfiler = KeptProfiler
    try:
        save = os.path.join(job, "manager")
        cfg = TrainingConfig(save_directory=save, **dict(
            CFG, num_train_epochs=1, scan_steps=2, profile_steps=1,
            tensorboard=True, pallas_stem=False))
        mgr = mi.MultiModalManager(cfg, bert_config=BertConfig(**BERT),
                                   load_pretrained_bert=False, device="cpu")
        state = mgr.train(None, dataset=FakePairedDataset(n=12))
        record("manager", save, "mi", state.step, profilers[-1])

        real_build = ae.build_ae_model
        real_ae_step = ae.make_ae_train_step

        def spanned_ae_step(*a, **kw):
            step = real_ae_step(*a, **kw)

            def run(state, images):
                with profiling.annotate(STEP_SPAN):
                    return step(state, images)
            return run

        ae.build_ae_model = lambda cfg, device: ResNetAE(
            input_shape=(cfg.img_size, cfg.img_size, 1), **SMALL).to(device)
        ae.make_ae_train_step = spanned_ae_step
        try:
            save = os.path.join(job, "ae")
            cfg = TrainingConfig(
                save_directory=save, batch_size=4, seed=0, img_size=64,
                compute_dtype="float32", num_train_epochs=1, init_lr=1e-3,
                prefetch=1, profile_steps=5, tensorboard=True)
            state = ae.train_auto_encoder(cfg, dataset=ImageDataset(),
                                          device="cpu")
            record("ae", save, "ae", state.step, profilers[-1])
        finally:
            ae.build_ae_model, ae.make_ae_train_step = real_build, \
                real_ae_step
    finally:
        mi.make_mi_step_body = real_body
        mi.StepProfiler = ae.StepProfiler = real_profiler

    proj = torch.randn(64 * 64, 768,
                       generator=torch.Generator().manual_seed(0)) / 64
    embed = lambda images: device_normalize(images).reshape(
        len(images), -1) @ proj
    save = os.path.join(job, "classifier")
    cfg = TrainingConfig(save_directory=save, batch_size=4, seed=0,
                         img_size=64, init_lr=1e-2, compute_dtype="float32",
                         prefetch=1, disease_label="Pneumonia",
                         num_train_epochs_classifier=2, tensorboard=True)
    mgr = clf.ClassifierModelManager(cfg, embed, [16],
                                     dataset=FakeDiseaseDataset(n=24),
                                     device="cpu")
    state, _, _ = mgr.train()
    record("classifier", save, "classifier_Pneumonia", state.step)
    np.savez(os.path.join(job, "out.npz"))
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    _child(sys.argv[1])
