"""The port's MI pretraining entry point (mimm_tpu_torch/cli/multi_modal.py,
cli/multi_modal.py's counterpart) on the CPU over a corpus synthesized with
tests/test_torch_datasets.py's ``write_corpus`` (8 PNGs around 256 px, a
report TSV, a vocabulary and a tiny BERT's ``bert_config.json``, no
pretrained weights).

``main([... "--device", "cpu"])`` with ``--preset production`` (bfloat16,
``seq_buckets``, ``scan_steps`` 8, compact transfer) and the flags that cut
it to the test's size, 2 epochs of 2 steps through a crop cache:

* one run uninterrupted: it writes ``training_MI.log`` (the reference's
  epoch lines), ``mi.jsonl``, ``mi_epoch1.ckpt`` / ``mi_epoch2.ckpt``,
  ``config.json`` and the ``.bin`` files, and the token cache in the text
  directory;
* one run preempted after its first step (``preempt.request()``), then the
  same command with ``--resume_from auto``: it finds ``mi_preempt.ckpt``,
  finishes the schedule at the uninterrupted run's step count and ends on
  its weights, bit for bit.
* ``python -m mimm_tpu_torch.cli.multi_modal --help`` lists the flags.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tests.test_torch_datasets import write_corpus

BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=32, num_classes=1)
FLAGS = ["--preset", "production", "--device", "cpu", "--batch_size", "4",
         "--img_size", "256", "--max_seq_length", "16",
         "--num_train_epochs", "2", "--pallas_stem", "true",
         "--data_loader_workers", "2", "--prefetch", "1"]
SIZES = ((300, 280), (256, 320), (240, 300))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from tests.torch_port_child import run_child

    job = str(tmp_path_factory.mktemp("cli_mi"))
    np.savez(os.path.join(job, "in.npz"))
    _, meta = run_child(__file__, job, timeout=600)
    shutil.rmtree(job)
    return meta


def test_entry_point_writes_the_run_files(results):
    files = results["full"]["files"]
    for name in ("training_MI.log", "mi.jsonl", "mi_epoch1.ckpt",
                 "mi_epoch2.ckpt", "config.json", "pytorch_MI_image_model.bin",
                 "pytorch_MI_text_model.bin", "pytorch_model_epoch2.bin"):
        assert name in files, name
    assert results["full"]["log_epochs"] == ["1", "2"]
    assert results["full"]["steps"] == 4
    assert results["token_cache"] is True


def test_resume_auto_finishes_the_schedule(results):
    assert results["stopped"]["steps"] == 1
    assert results["stopped"]["preempt_ckpt"] is True
    resumed = results["resumed"]
    assert resumed["steps"] == results["full"]["steps"]
    assert resumed["epochs"] == [1, 2]
    assert resumed["same_weights"] is True


def test_module_help_lists_the_flags(results):
    assert results["help_rc"] == 0
    for flag in ("--preset", "--resume_from", "--decoded_crop_cache",
                 "--image_dir", "--device"):
        assert flag in results["help"], flag


def _child(job):
    import torch

    from mimm_tpu_torch import preempt
    from mimm_tpu_torch.cli import multi_modal
    from mimm_tpu_torch.train import mi

    torch.backends.mkldnn.enabled = False
    paths = write_corpus(os.path.join(job, "corpus"), 8, 256, 9,
                         sizes=SIZES)
    with open(os.path.join(paths["bert"], "bert_config.json"), "w") as f:
        json.dump(BERT, f)

    def flags(save):
        return FLAGS + ["--image_dir", paths["images"],
                        "--text_data_dir", paths["text"],
                        "--dataset_metadata", paths["metadata"],
                        "--bert_pretrained_dir", paths["bert"],
                        "--decoded_crop_cache", os.path.join(job, "cache"),
                        "--save_directory", save]

    def summary(save, state):
        with open(os.path.join(save, "mi.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        with open(os.path.join(save, "training_MI.log")) as f:
            log = [line.split("Epoch ")[1].split()[0] for line in f
                   if " loss = " in line]
        return {"steps": state.step, "files": sorted(os.listdir(save)),
                "epochs": [r["epoch"] for r in recs if "epoch_loss" in r],
                "preempt_ckpt": os.path.exists(os.path.join(
                    save, "mi_preempt.ckpt")),
                "log_epochs": log}

    meta = {}
    save = os.path.join(job, "full")
    _, full = multi_modal.main(flags(save))
    meta["full"] = summary(save, full)
    meta["token_cache"] = os.path.exists(os.path.join(
        paths["text"], "cachedfeatures_train_seqlen-16.npz"))

    real_body = mi.make_mi_step_body

    def stop_after_first(*a, **kw):
        body = real_body(*a, **kw)

        def run(state, batch):
            state, loss = body(state, batch)
            if state.step == 1:
                preempt.request()
            return state, loss
        return run

    mi.make_mi_step_body = stop_after_first
    save = os.path.join(job, "stopped")
    _, state = multi_modal.main(flags(save))
    meta["stopped"] = summary(save, state)
    mi.make_mi_step_body = real_body
    preempt.clear()          # a new process would start without the flag
    _, state = multi_modal.main(flags(save) + ["--resume_from", "auto"])
    meta["resumed"] = summary(save, state)
    meta["resumed"]["same_weights"] = all(
        torch.equal(a, b) for a, b in zip(full.model.state_dict().values(),
                                          state.model.state_dict().values())
    ) and all(torch.equal(a[k], b[k]) for a, b in zip(full.critic_params,
                                                     state.critic_params)
              for k in a)
    preempt.uninstall()
    proc = subprocess.run([sys.executable, "-m",
                           "mimm_tpu_torch.cli.multi_modal", "--help"],
                          capture_output=True, text=True, timeout=120)
    meta["help_rc"], meta["help"] = proc.returncode, proc.stdout
    np.savez(os.path.join(job, "out.npz"))
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    _child(sys.argv[1])
