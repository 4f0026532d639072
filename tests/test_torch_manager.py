"""The port's input pipeline and epoch loop (mimm_tpu_torch/data/
pipeline.py, metrics.py, train/mi.py ``MultiModalManager``) against the
JAX package's (mimm_tpu/data/pipeline.py, mimm_tpu/train/mi.py:633-859).

* ``Loader``: the same batch stream, bit for bit, over an in-memory paired
  dataset (uint8 images with per-sample noise from the loader's rng, token
  lengths for bucketing, a non-numeric study id, an unreadable record):
  bucketing on with 0 and 3 decode threads, a second epoch, a resumed
  epoch (``start_batch``, where the unreadable record becomes zeros), no
  bucketing, ``scan_chunks`` grouping, ``batches_per_epoch`` and the
  skipped-record counts.
* ``MultiModalManager.train(None, dataset=...)`` over the paired dataset
  of tests/test_train.py:32 (img 256, a tiny BERT at dropout 0, B=4, f32,
  ``pallas_stem``), JAX on a one-device mesh, the port from JAX's initial
  weights (its ``create_mi_state`` swapped, in the child, for one that
  loads them).  4 epochs of schedule, a checkpoint every 2, stopped after
  3.  The image and critic learning rate is 1e-5 (Adam steps of ±lr whose
  sign a gradient near zero may flip grow an f32 gap from step to step, as
  in tests/test_torch_fused_ffn.py); the tiny BERT's is 1e-3, so that its
  schedule's t_total shows in the losses.  The per-epoch losses of
  ``mi.jsonl`` (sums of two steps' DV bounds: 1.19e-3, -2.41e-3, -8.62e-3
  on the CPU) agree to LOSS_ATOL, 1e-5 / 5e-5 / 1e-4 (measured 4.0e-7,
  3.6e-6, 1.5e-5).  Three faults planted in the port's Manager leave it
  (measured gaps at epochs 2 and 3): the third step's optimizer updates
  skipped (6.7e-4, 3.0e-3), epoch 0's order in every epoch (3.5e-3,
  8.2e-3), t_total off by one step an epoch (1.6e-4, 6.3e-4).  The written
  files are JAX's but its native ``mi_epoch<N>.ckpt`` (a later slice); the
  ``.bin`` files reload ``strict=True``.
* The port with ``pallas_stem`` on against off from one state: the same
  epoch losses to STEM_ATOL, 1e-5 / 1e-4 / 4e-4 (the canonical stem's
  convolution sums in another order than the nine shifted products, and
  six BatchNorms amplify it, so the gap starts larger than against JAX's
  stem, which rounds as the port's does; measured 4.2e-7, 1.9e-5,
  1.5e-4).  The planted faults leave it too (at epoch 2: 6.6e-4, 3.5e-3,
  1.4e-4).
* Every knob of a later slice raises ``NotImplementedError`` naming its
  queue item, before anything is written.

The JAX side runs in the pytest worker, the port side in a jax-free child
(tests/torch_port_child.py).
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

BUCKETS = (8, 16, 24)
LOADER_B = 4
# (bucketed, num_workers, epoch, start_batch, scan chunk)
STREAMS = {"w0": (True, 0, 0, 0, 1), "w3": (True, 3, 0, 0, 1),
           "epoch1": (True, 0, 1, 0, 1), "resumed": (True, 3, 1, 2, 1),
           "plain": (False, 0, 0, 0, 1), "chunks": (True, 0, 0, 0, 2)}
SEQ = 16
VOCAB = 64
BERT = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=32, num_classes=1,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
CFG = dict(batch_size=4, seed=0, img_size=256, compute_dtype="float32",
           num_train_epochs=4, init_lr=1e-5, bert_lr=1e-3,
           prefetch=1, max_seq_length=SEQ,
           mi_estimator="dv", checkpoint_every_epochs=2, pallas_stem=True)
EPOCHS, STOP_AFTER = 4, 3
LOSS_ATOL = (1e-5, 5e-5, 1e-4)
STEM_ATOL = (1e-5, 1e-4, 4e-4)
FAULTS = ("skipped_update", "epoch0_order", "t_total")
NATIVE = "mi_epoch"       # JAX's native checkpoints, a later slice's


class PairedDataset:
    """In-memory paired samples: uint8 images XOR per-sample noise drawn
    from the loader's rng, reports of varied token length, a non-numeric
    study id (``to_int`` maps ids as the package under test does) and one
    unreadable record."""

    def __init__(self, to_int, n=43, img=8, seq=24, bad=(9,)):
        rng = np.random.default_rng(3)
        self.imgs = rng.integers(0, 256, (n, img, img, 1)).astype(np.uint8)
        self.lengths = rng.integers(2, seq + 1, n)
        self.ids = rng.integers(1, 1000, (n, seq)).astype(np.uint16)
        self.sids = [str(40000 + i) if i % 7 else f"s{i}x" for i in range(n)]
        self.to_int, self.seq, self.bad = to_int, seq, set(bad)

    def __len__(self):
        return len(self.imgs)

    def token_length(self, idx):
        return int(self.lengths[idx])

    def load(self, idx, rng, train=True):
        if idx in self.bad:
            return None
        noise = rng.integers(0, 8, self.imgs[idx].shape).astype(np.uint8)
        mask = (np.arange(self.seq) < self.lengths[idx]).astype(np.uint8)
        return {"image": self.imgs[idx] ^ noise,
                "txt_ids": self.ids[idx] * mask, "txt_masks": mask,
                "txt_segments": np.zeros(self.seq, np.uint8),
                "study_id": np.int64(self.to_int(self.sids[idx]))}


class FakePairedDataset:
    """tests/test_train.py:32's paired dataset."""

    def __init__(self, n=8, img=256, seq=SEQ, vocab=VOCAB):
        rng = np.random.default_rng(1)
        self.imgs = rng.random((n, img, img, 1)).astype(np.float32)
        self.ids = rng.integers(0, vocab, size=(n, seq)).astype(np.int32)
        self.n, self.seq = n, seq

    def __len__(self):
        return self.n

    def load(self, idx, rng, train=True):
        return {"image": self.imgs[idx], "txt_ids": self.ids[idx],
                "txt_masks": np.ones(self.seq, np.int32),
                "txt_segments": np.zeros(self.seq, np.int32),
                "study_id": np.int64(50000 + idx)}


def streams(pipeline) -> tuple:
    """Every case of STREAMS through ``pipeline``'s Loader: the batches
    as {'<case>/<i>/<key>': array}, and the counts."""
    arrays, counts = {}, {}
    for case, (bucketed, workers, epoch, start, chunk) in STREAMS.items():
        loader = pipeline.Loader(
            PairedDataset(pipeline.study_id_to_int), LOADER_B, seed=5,
            bucket_lengths=BUCKETS if bucketed else None,
            num_workers=workers)
        stream = loader.epoch(epoch, start_batch=start)
        for i, batch in enumerate(pipeline.scan_chunks(stream, chunk)):
            arrays.update({f"{case}/{i}/{k}": v for k, v in batch.items()})
        counts[case] = {"batches_per_epoch": loader.batches_per_epoch(),
                        "skipped": loader.skipped}
    return arrays, counts


def _epoch_losses(save):
    with open(os.path.join(save, "mi.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r["epoch_loss"] for r in recs if "epoch_loss" in r]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax

    from mimm_tpu.config import TrainingConfig
    from mimm_tpu.data import pipeline
    from mimm_tpu.models.bert import BertConfig
    from mimm_tpu.parallel import mesh as mesh_lib
    from mimm_tpu.train.mi import (MultiModalManager, build_joint_model,
                                   create_mi_state, make_optimizers)
    from tests.test_torch_train import _flat_state
    from tests.torch_port_child import run_child

    job = str(tmp_path_factory.mktemp("manager"))
    arrays, counts = streams(pipeline)
    arrays = {f"stream/{k}": v for k, v in arrays.items()}

    save = os.path.join(job, "jax")
    cfg = TrainingConfig(save_directory=save, **CFG)
    bert = BertConfig(**BERT)
    # the Manager's initial state: create_mi_state(PRNGKey(seed)) on the
    # Manager's model
    init = jax.device_get(create_mi_state(
        build_joint_model(cfg, bert), cfg, make_optimizers(cfg, 2),
        jax.random.PRNGKey(cfg.seed)))
    arrays.update(_flat_state(init.params, init.batch_stats,
                              init.critic_params, "init/"))
    mgr = MultiModalManager(cfg, bert_config=bert, load_pretrained_bert=False)
    state = mgr.train(None, dataset=FakePairedDataset(),
                      mesh=mesh_lib.make_mesh({"data": 1}),
                      num_epochs=EPOCHS, stop_after_epoch=STOP_AFTER)
    want = {"losses": _epoch_losses(save), "steps": int(state.step),
            "files": sorted(f for f in os.listdir(save)
                            if not f.startswith(NATIVE)),
            "counts": counts}
    np.savez(os.path.join(job, "in.npz"), **arrays)
    got, meta = run_child(__file__, job, timeout=600)
    shutil.rmtree(job)        # the results are in memory now
    return want, {k: v for k, v in arrays.items()
                  if k.startswith("stream/")}, got, meta


@pytest.mark.parametrize("case", list(STREAMS))
def test_loader_stream_matches_jax(results, case):
    _, want, got, meta = results
    keys = sorted(k for k in want if k.startswith(f"stream/{case}/"))
    assert keys and keys == sorted(k for k in got
                                   if k.startswith(f"stream/{case}/"))
    for key in keys:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert meta["counts"][case] == results[0]["counts"][case]


def test_loader_cases_reach_what_they_test(results):
    """The resumed epoch substitutes the unreadable record; the others
    skip it; scan chunks stack two batches; bucketing drops remainders."""
    want, arrays, _, _ = results
    counts = want["counts"]
    assert counts["w0"]["skipped"] == counts["plain"]["skipped"] == 1
    assert counts["resumed"]["skipped"] == 1
    assert arrays["stream/chunks/0/image"].ndim == 5
    resumed = [img for k, batch in arrays.items()
               if k.startswith("stream/resumed/") and k.endswith("/image")
               for img in batch]
    assert sum(not img.any() for img in resumed) == 1


def test_manager_epoch_losses_match_jax(results):
    want, _, _, meta = results
    got = meta["stem_on"]["losses"]
    assert len(want["losses"]) == len(got) == STOP_AFTER
    for epoch, (a, b, tol) in enumerate(zip(got, want["losses"], LOSS_ATOL)):
        assert abs(a - b) <= tol, (epoch + 1, a, b)
    assert meta["stem_on"]["steps"] == want["steps"] == 2 * STOP_AFTER


@pytest.mark.parametrize("fault", FAULTS)
def test_manager_loss_limits_catch_faults(results, fault):
    """A stem-on Manager with a planted fault leaves LOSS_ATOL against JAX
    and STEM_ATOL against the stem-off run at some epoch: the third step's
    three optimizer updates skipped, epoch 0's order reused in every epoch,
    or the schedule's t_total off by one step an epoch."""
    want, _, _, meta = results
    losses = meta["faults"][fault]
    assert len(losses) == STOP_AFTER
    for ref, limits in ((want["losses"], LOSS_ATOL),
                        (meta["stem_off"]["losses"], STEM_ATOL)):
        gaps = [abs(a - b) for a, b in zip(losses, ref)]
        assert any(g > tol for g, tol in zip(gaps, limits)), (gaps, limits)


def test_manager_writes_jax_files_and_reloads_strict(results):
    """A checkpoint every 2 epochs and at the stop after 3: epochs 2 and 3,
    not 1 and not 4 (checkpoint_every_epochs, stop_after_epoch)."""
    want, _, _, meta = results
    assert meta["stem_on"]["files"] == want["files"]
    assert "pytorch_model_epoch2.bin" in want["files"]
    assert "pytorch_model_epoch3.bin" in want["files"]
    assert "pytorch_model_epoch1.bin" not in want["files"]
    assert meta["stem_on"]["strict_reload"] is True
    assert meta["stem_on"]["stem_launches"] == {}     # the CPU: plain versions


def test_manager_stem_on_agrees_with_off(results):
    meta = results[3]
    for a, b, tol in zip(meta["stem_on"]["losses"], meta["stem_off"]["losses"],
                         STEM_ATOL):
        assert abs(a - b) <= tol, (a, b)
    assert meta["stem_calls"] == {"on": 2 * STOP_AFTER, "off": 0}


def test_run_logging_moves_to_each_run_file(results):
    """``configure_run_logging`` replaces the root logger's file: a second
    run's records do not land in the first run's file."""
    assert results[3]["run_logs"] == [["run one"], ["run two"]]


@pytest.mark.parametrize("knob", ["dataset", "mesh", "resume_from",
                                  "auto_resume", "keep_checkpoints",
                                  "checkpoint_format", "profile_steps",
                                  "tensorboard"])
def test_later_slice_knobs_raise(results, knob):
    msg, wrote = results[3]["raises"][knob]
    assert msg.startswith("NotImplementedError") and "queue A, item" in msg, \
        msg
    assert wrote == [], wrote


def _child(job):
    import torch

    from mimm_tpu_torch import checkpoint as ckpt
    from mimm_tpu_torch.config import TrainingConfig
    from mimm_tpu_torch.data import pipeline
    from mimm_tpu_torch.models import resnet
    from mimm_tpu_torch.models.bert import BertConfig
    from mimm_tpu_torch.models.joint import ImageReportModel
    from mimm_tpu_torch.ops import shallow_conv as sc
    from mimm_tpu_torch.train import mi
    from tests.test_torch_train import _error_of
    from tests.torch_port_child import unflatten_tree

    torch.backends.mkldnn.enabled = False
    with np.load(os.path.join(job, "in.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    tree = unflatten_tree({k: v for k, v in arrays.items()
                           if k.startswith("init/")})["init"]
    out, meta = {}, {}
    got, meta["counts"] = streams(pipeline)
    out.update({f"stream/{k}": v for k, v in got.items()})

    weights = ckpt.mi_weights_from_flax(
        tree["params"], tree["batch_stats"],
        [tree["critic"][str(i)] for i in range(len(tree["critic"]))],
        BERT["num_hidden_layers"])
    real_create = mi.create_mi_state

    def create_from_jax(model, cfg, txs, generator, **kw):
        return real_create(model, cfg, txs, None, weights=weights, **kw)

    mi.create_mi_state = create_from_jax
    calls = {"n": 0}
    real_stem = resnet.shallow_conv3x3

    def counting_stem(*a):
        calls["n"] += 1
        return real_stem(*a)

    resnet.shallow_conv3x3 = counting_stem
    meta["stem_calls"] = {}
    for arm, stem in (("stem_on", True), ("stem_off", False)):
        save = os.path.join(job, arm)
        cfg = TrainingConfig(save_directory=save, **dict(CFG,
                                                         pallas_stem=stem))
        sc.reset_launch_counts()
        calls["n"] = 0
        mgr = mi.MultiModalManager(cfg, bert_config=BertConfig(**BERT),
                                   load_pretrained_bert=False, device="cpu")
        state = mgr.train(None, dataset=FakePairedDataset(),
                          num_epochs=EPOCHS, stop_after_epoch=STOP_AFTER)
        meta["stem_calls"]["on" if stem else "off"] = calls["n"]
        fresh = ImageReportModel(BertConfig(**BERT))
        fresh.load_state_dict(ckpt.load_state_dict_bin(os.path.join(
            save, f"pytorch_model_epoch{STOP_AFTER}.bin")), strict=True)
        fresh.image_model.load_state_dict(ckpt.load_state_dict_bin(
            os.path.join(save, "pytorch_MI_image_model.bin")), strict=True)
        fresh.text_model.load_state_dict(ckpt.load_state_dict_bin(
            os.path.join(save, "pytorch_MI_text_model.bin")), strict=True)
        meta[arm] = {
            "losses": _epoch_losses(save), "steps": state.step,
            "files": sorted(os.listdir(save)),
            "stem_launches": dict(sc.LAUNCHES),
            "strict_reload": all(torch.equal(a, b) for a, b in zip(
                fresh.state_dict().values(),
                state.model.state_dict().values()))}
    resnet.shallow_conv3x3 = real_stem

    # planted faults, each in one stem-on run; their losses must leave
    # LOSS_ATOL (test_manager_loss_limits_catch_faults)
    real_apply, real_loader, real_opts = (mi.apply_updates, mi.Loader,
                                          mi.make_optimizers)
    applied = {"n": 0}

    def skip_third_update(group, upd):
        # three groups a step (image, text, critic): step 3, epoch 2's first
        applied["n"] += 1
        if not 7 <= applied["n"] <= 9:
            real_apply(group, upd)

    class FirstOrderLoader(real_loader):
        def epoch(self, epoch, start_batch=0):
            return super().epoch(0, start_batch)

    planted = {"skipped_update": ("apply_updates", skip_third_update),
              "epoch0_order": ("Loader", FirstOrderLoader),
              "t_total": ("make_optimizers",
                          lambda cfg, steps_per_epoch, num_epochs=None:
                          real_opts(cfg, steps_per_epoch + 1, num_epochs))}
    meta["faults"] = {}
    for fault in FAULTS:
        name, patch = planted[fault]
        save = os.path.join(job, f"fault_{fault}")
        setattr(mi, name, patch)
        try:
            mgr = mi.MultiModalManager(
                TrainingConfig(save_directory=save, **CFG),
                bert_config=BertConfig(**BERT), load_pretrained_bert=False,
                device="cpu")
            mgr.train(None, dataset=FakePairedDataset(), num_epochs=EPOCHS,
                      stop_after_epoch=STOP_AFTER)
        finally:
            mi.apply_updates, mi.Loader, mi.make_optimizers = (
                real_apply, real_loader, real_opts)
        meta["faults"][fault] = _epoch_losses(save)
    mi.create_mi_state = real_create

    def refused(knob):
        save = os.path.join(job, f"raises_{knob}")
        cfg = TrainingConfig(save_directory=save, **CFG)
        kw = {"dataset": FakePairedDataset(n=4, img=256)}
        if knob == "dataset":
            kw["dataset"] = None
        elif knob in ("mesh", "resume_from"):
            kw[knob] = object() if knob == "mesh" else os.path.join(save, "x")
        else:
            cfg = cfg.replace(**{
                "auto_resume": {"resume_from": "auto"},
                "keep_checkpoints": {"keep_checkpoints": 2},
                "checkpoint_format": {"checkpoint_format": "orbax"},
                "profile_steps": {"profile_steps": 2},
                "tensorboard": {"tensorboard": True}}[knob])
        mgr = mi.MultiModalManager(cfg, bert_config=BertConfig(**BERT),
                                   load_pretrained_bert=False, device="cpu")
        msg = _error_of(lambda: mgr.train(None, num_epochs=1, **kw))
        return msg, sorted(os.listdir(save)) if os.path.exists(save) else []

    import logging

    from mimm_tpu_torch.metrics import configure_run_logging

    logs = [os.path.join(job, f"run{i}.log") for i in (1, 2)]
    for path, text in zip(logs, ("run one", "run two")):
        configure_run_logging(path)
        logging.getLogger("test_torch_manager").info(text)
    for h in logging.getLogger().handlers:
        h.flush()
    meta["run_logs"] = [[line.split(" ", 4)[-1].strip() for line in open(p)]
                        for p in logs]

    meta["raises"] = {k: refused(k) for k in (
        "dataset", "mesh", "resume_from", "auto_resume", "keep_checkpoints",
        "checkpoint_format", "profile_steps", "tensorboard")}
    np.savez(os.path.join(job, "out.npz"), **out)
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    _child(sys.argv[1])
