"""Preemption, resume and pruning in the port (mimm_tpu_torch/preempt.py,
checkpoint.py's resume envelope, train/mi.py ``MultiModalManager``): the
port's own counterpart of tests/test_preempt.py:172 and :221.

Every run trains from disk (tests/test_torch_datasets.py's corpus, read
through a crop cache), float32, B=4, img 256, a tiny BERT at dropout 0.1
(the masks come from generators seeded by (seed, step), so a resumed step
draws the uninterrupted run's masks), ``pallas_stem``, in the CPU child.

* Chunked: ``seq_buckets`` (8, 16) and ``scan_steps`` 2 over 16 pairs, 4
  steps an epoch in two chunks of one bucket each, which reorder the
  stream.  ``preempt.request()`` after step 1 stops the run after its
  chunk, at step 2 of 4, with ``mi_preempt.ckpt`` and ``preempted: 1`` in
  ``mi.jsonl``; resuming it, and resuming the uninterrupted run's
  ``mi_epoch1.ckpt`` at the epoch boundary, both end where the run that
  was never stopped ends: every parameter, buffer, optimizer moment and
  count bit-equal.  A control resumes batches ``2:`` of the stream instead
  (JAX's ``start_batch``, which skips other batches than the chunk
  consumed) and must differ.
* Plain: no buckets, ``scan_steps`` 1, 8 pairs, 3 epochs, a real SIGTERM
  to the process after step 3 (``preempt.install()``'s handler);
  resumed with ``keep_checkpoints`` 1 it ends bit-equal to the
  uninterrupted run, and leaves ``mi_epoch3.ckpt`` as the only epoch
  checkpoint, beside ``mi_preempt.ckpt`` and every ``.bin``.
* ``resolve_resume``'s "" / "auto" / path contract; ``load_checkpoint``
  refuses a newer envelope version; ``prune_checkpoints`` with keep 0
  keeps everything; the handler chains the one it replaced and ``install``
  is idempotent.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

from tests.test_torch_datasets import write_corpus

SEQ = 16
BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=32, num_classes=1,
            hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
CFG = dict(batch_size=4, seed=0, img_size=256, compute_dtype="float32",
           init_lr=1e-4, bert_lr=1e-3, prefetch=1, max_seq_length=SEQ,
           pallas_stem=True, data_loader_workers=2)
ARMS = {"chunked": dict(seq_buckets=(8, 16), scan_steps=2,
                        num_train_epochs=2),
        "plain": dict(num_train_epochs=3)}
SIZES = ((300, 280), (256, 320), (240, 300))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from tests.torch_port_child import run_child

    job = str(tmp_path_factory.mktemp("preempt"))
    np.savez(os.path.join(job, "in.npz"))
    _, meta = run_child(__file__, job, timeout=600)
    shutil.rmtree(job)
    return meta


def test_request_stops_at_the_chunk_boundary(results):
    b = results["chunked"]["preempted"]
    assert b["steps"] == 2 and b["ckpt"] and b["jsonl_preempted"], b
    assert b["epoch_ckpts"] == []


def test_preempt_then_resume_is_bit_equal(results):
    for arm, case in (("chunked", "resumed"), ("chunked", "from_epoch1"),
                      ("plain", "resumed")):
        got = results[arm][case]
        assert got["steps"] == results[arm]["full_steps"], (arm, case)
        assert got["differ"] == [], (arm, case, got["differ"][:5])
        assert got["compared"] > 50, (arm, case)


def test_resume_without_the_chunk_plan_differs(results):
    """The control: batches 2: of the stream, as JAX's Manager resumes,
    train on another batch than the one left, so the state differs."""
    got = results["chunked"]["start_batch_control"]
    assert got["steps"] == results["chunked"]["full_steps"]
    assert got["differ"], got


def test_sigterm_stops_and_resume_prunes(results):
    plain = results["plain"]
    assert plain["preempted"]["steps"] == 3
    assert plain["preempted"]["ckpt"] and plain["preempted"]["jsonl_preempted"]
    files = plain["resumed"]["files"]
    assert [f for f in files if f.startswith("mi_epoch")] == ["mi_epoch3.ckpt"]
    assert "mi_preempt.ckpt" in files
    for epoch in (2, 3):       # the .bin exports of the resumed epochs
        assert f"pytorch_model_epoch{epoch}.bin" in files
    assert {"pytorch_MI_image_model.bin", "pytorch_MI_text_model.bin",
            "pytorch_model_epoch1.bin"} <= set(files)


def test_resolve_resume_contract(results):
    assert results["resolve"] == {"fresh": None, "auto_absent": None,
                                  "auto_present": True,
                                  "path": "/some/explicit.ckpt"}


def test_envelope_and_pruning_helpers(results):
    h = results["helpers"]
    assert h["newer"].startswith("ValueError") and "v2" in h["newer"], h
    assert h["keep0"] == [] and h["left"] == ["mi_epoch1.ckpt",
                                              "mi_epoch2.ckpt",
                                              "mi_epoch3.ckpt"]
    assert h["keep2"] == ["mi_epoch1.ckpt"]
    assert h["chained"] == 1 and h["flag"] is True


def _flat(state) -> dict:
    from mimm_tpu_torch.train.mi import mi_state_tree

    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(f"{prefix}/{i}", v)
        else:
            out[prefix] = node
    walk("", mi_state_tree(state))
    return out


def _diff(a, b) -> list:
    import torch

    keys = sorted(set(a) | set(b))
    return [k for k in keys if k not in a or k not in b or (
        not torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] != b[k])]


def _child(job):
    import signal

    import torch

    from mimm_tpu_torch import checkpoint as ckpt
    from mimm_tpu_torch import preempt
    from mimm_tpu_torch.config import TrainingConfig
    from mimm_tpu_torch.data import pipeline
    from mimm_tpu_torch.data.features import load_and_cache_examples
    from mimm_tpu_torch.data.tokenizer import WordPieceTokenizer
    from mimm_tpu_torch.models.bert import BertConfig
    from mimm_tpu_torch.train import mi
    from tests.test_torch_train import _error_of

    torch.backends.mkldnn.enabled = False
    meta = {}
    rng = np.random.default_rng(4)
    # bucket 8: 3-6 words (+[CLS], [SEP]); bucket 16: 7-14, alternating
    lengths = [int(rng.integers(3, 7)) if i % 2 else int(rng.integers(7, 15))
               for i in range(16)]
    corpora = {"chunked": write_corpus(os.path.join(job, "c16"), 16, 256, 5,
                                       sizes=SIZES, lengths=lengths,
                                       decorate=False),
               "plain": write_corpus(os.path.join(job, "c8"), 8, 256, 6,
                                     sizes=SIZES, decorate=False)}
    real_body = mi.make_mi_step_body
    stop = {"at": None, "how": None}

    def body_with_stop(*a, **kw):
        body = real_body(*a, **kw)

        def run(state, batch):
            state, loss = body(state, batch)
            if state.step == stop["at"]:
                if stop["how"] == "signal":
                    os.kill(os.getpid(), signal.SIGTERM)
                else:
                    preempt.request()
            return state, loss
        return run

    mi.make_mi_step_body = body_with_stop

    def train(arm, name, resume_from=None, keep=0, save=None):
        paths = corpora[arm]
        save = save or os.path.join(job, f"{arm}_{name}")
        cfg = TrainingConfig(**CFG, **ARMS[arm], save_directory=save,
                             image_dir=paths["images"],
                             text_data_dir=paths["text"],
                             dataset_metadata=paths["metadata"],
                             decoded_crop_cache=os.path.join(job, f"cache_"
                                                             f"{arm}"),
                             keep_checkpoints=keep)
        feats = load_and_cache_examples(
            paths["text"], SEQ, WordPieceTokenizer.from_pretrained(
                paths["bert"]))
        mgr = mi.MultiModalManager(cfg, bert_config=BertConfig(**BERT),
                                   load_pretrained_bert=False, device="cpu")
        state = mgr.train(feats, resume_from=resume_from)
        preempt.clear()
        with open(os.path.join(save, "mi.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        files = sorted(os.listdir(save))
        return save, state, {
            "steps": state.step, "files": files,
            "ckpt": "mi_preempt.ckpt" in files,
            "jsonl_preempted": any(r.get("preempted") == 1 for r in recs),
            "epoch_ckpts": [f for f in files if f.startswith("mi_epoch")]}

    def compare(full, state, info):
        a, b = _flat(full), _flat(state)
        info.update(differ=_diff(a, b), compared=len(a))
        return info

    # ---- chunked: request() after step 1, the check after its chunk -------
    res = meta["chunked"] = {}
    full_save, full, info = train("chunked", "full")
    res["full_steps"] = info["steps"]
    stop.update(at=1, how="request")
    save, _, res["preempted"] = train("chunked", "stopped")
    stop["at"] = None
    preempt_ckpt = os.path.join(save, "mi_preempt.ckpt")
    _, st, info = train("chunked", "resumed", resume_from=preempt_ckpt)
    res["resumed"] = compare(full, st, info)
    _, st, info = train("chunked", "from_epoch1", resume_from=os.path.join(
        full_save, "mi_epoch1.ckpt"))
    res["from_epoch1"] = compare(full, st, info)
    real_resume = mi.resume_chunks

    def no_plan(*a, **kw):
        raise ValueError("the control resumes without the plan")

    mi.resume_chunks = no_plan
    _, st, info = train("chunked", "control", resume_from=preempt_ckpt)
    mi.resume_chunks = real_resume
    res["start_batch_control"] = compare(full, st, info)

    # ---- plain: a real SIGTERM after step 3, then resume with pruning -------
    res = meta["plain"] = {}
    _, full, info = train("plain", "full")
    res["full_steps"] = info["steps"]
    chained = []
    signal.signal(signal.SIGTERM, lambda s, f: chained.append(s))
    preempt.install()
    preempt.install()                  # idempotent: one handler, one chain
    stop.update(at=3, how="signal")
    save, _, res["preempted"] = train("plain", "stopped")
    stop["at"] = None
    _, st, info = train("plain", "stopped", save=save, keep=1,
                        resume_from=os.path.join(save, "mi_preempt.ckpt"))
    res["resumed"] = compare(full, st, info)
    preempt.uninstall()

    # ---- the helpers ---------------------------------------------------------
    cfg = TrainingConfig(save_directory=os.path.join(job, "resolve"))
    os.makedirs(cfg.save_directory)
    resolved = {"fresh": preempt.resolve_resume(cfg, "mi_preempt.ckpt"),
                "auto_absent": preempt.resolve_resume(
                    cfg.replace(resume_from="auto"), "mi_preempt.ckpt")}
    with open(os.path.join(cfg.save_directory, "mi_preempt.ckpt"), "wb"):
        pass
    resolved["auto_present"] = preempt.resolve_resume(
        cfg.replace(resume_from="auto"), "mi_preempt.ckpt") == os.path.join(
        cfg.save_directory, "mi_preempt.ckpt")
    resolved["path"] = preempt.resolve_resume(
        cfg.replace(resume_from="/some/explicit.ckpt"), "mi_preempt.ckpt")
    meta["resolve"] = resolved
    d = os.path.join(job, "prune")
    for e in (1, 2, 3):
        ckpt.save_checkpoint(os.path.join(d, f"mi_epoch{e}.ckpt"), {"e": e})
    newer = os.path.join(job, "newer.ckpt")
    torch.save({"__mimm_ckpt__": 2, "tree": {}}, newer)
    meta["helpers"] = {
        "newer": _error_of(lambda: ckpt.load_checkpoint(newer)),
        "keep0": ckpt.prune_checkpoints(d, "mi_epoch", 0),
        "left": sorted(os.listdir(d)),
        "keep2": [os.path.basename(p) for p in
                  ckpt.prune_checkpoints(d, "mi_epoch", 2)],
        "chained": len(chained), "flag": preempt.requested() is False}
    assert pipeline.resume_chunks is real_resume
    np.savez(os.path.join(job, "out.npz"))
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    _child(sys.argv[1])
