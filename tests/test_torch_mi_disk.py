"""The port's ``MultiModalManager`` trained from disk against the JAX
package's (mimm_tpu/train/mi.py:633-859 with ``dataset=None``): each
Manager builds its own ``CXRImageReportDataset`` over the same files (a
corpus of tests/test_torch_datasets.py's ``write_corpus``: 9 PNGs at sides
around 256, one unreadable, which the loader skips; the token cache JAX
wrote), the port from JAX's initial weights (its ``create_mi_state``
swapped, in the child, for one that loads them).

The setup of tests/test_torch_manager.py: a tiny BERT at dropout 0, img
256, B=4, float32, ``pallas_stem``, compact transfer, image and critic
learning rate 1e-5, BERT's 1e-3; two epochs of two steps.  Two arms:
``grad_cache_chunks`` 1 reading through the crop cache (each Manager its
own, built on the first read), and ``grad_cache_chunks`` 2 decoding every
image (GradCache's two passes through the Manager; JAX tests that only
through tests/test_grad_cache.py:171).  The per-epoch losses of
``mi.jsonl`` agree to that file's LOSS_ATOL (1e-5, 5e-5; measured 4.0e-7
and 6.8e-6 through the cache, 3.7e-7 and 2.5e-7 with GradCache); the written
files are JAX's, the resume checkpoints ``mi_epoch<N>.ckpt`` included,
and the ``.bin`` files reload ``strict=True``.

The JAX side runs in the pytest worker, the port side in a jax-free child
(tests/torch_port_child.py).
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

from tests.test_torch_datasets import write_corpus

SEQ = 16
VOCAB = 64
BERT = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=32, num_classes=1,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
CFG = dict(batch_size=4, seed=0, img_size=256, compute_dtype="float32",
           num_train_epochs=2, init_lr=1e-5, bert_lr=1e-3, prefetch=1,
           max_seq_length=SEQ, mi_estimator="dv", pallas_stem=True,
           data_loader_workers=2)
EPOCHS = 2
LOSS_ATOL = (1e-5, 5e-5)
# arm -> (grad_cache_chunks, through the crop cache)
ARMS = {"direct_cached": (1, True), "grad_cache_2": (2, False)}
SIZES = ((300, 280), (256, 320), (240, 300))


def cfg_kw(paths: dict, save: str, arm: str, cache: str) -> dict:
    chunks, cached = ARMS[arm]
    return dict(CFG, save_directory=save, image_dir=paths["images"],
                text_data_dir=paths["text"],
                dataset_metadata=paths["metadata"],
                decoded_crop_cache=cache if cached else "",
                grad_cache_chunks=chunks)


def _epoch_losses(save):
    with open(os.path.join(save, "mi.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r["epoch_loss"] for r in recs if "epoch_loss" in r]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax

    from mimm_tpu.config import TrainingConfig
    from mimm_tpu.data.features import load_and_cache_examples
    from mimm_tpu.data.tokenizer import NativeWordPieceTokenizer
    from mimm_tpu.models.bert import BertConfig
    from mimm_tpu.parallel import mesh as mesh_lib
    from mimm_tpu.train.mi import (MultiModalManager, build_joint_model,
                                   create_mi_state, make_optimizers)
    from tests.test_torch_train import _flat_state
    from tests.torch_port_child import run_child

    job = str(tmp_path_factory.mktemp("mi_disk"))
    paths = write_corpus(os.path.join(job, "corpus"), 9, 256, 11,
                         sizes=SIZES, bad=(4,))
    features = load_and_cache_examples(
        paths["text"], SEQ,
        NativeWordPieceTokenizer.from_pretrained(paths["bert"]))
    bert = BertConfig(**BERT)
    base = TrainingConfig(**cfg_kw(paths, job, "direct_cached", ""))
    init = jax.device_get(create_mi_state(
        build_joint_model(base, bert), base, make_optimizers(base, 2),
        jax.random.PRNGKey(base.seed)))
    arrays = _flat_state(init.params, init.batch_stats, init.critic_params,
                         "init/")
    want = {}
    for arm in ARMS:
        save = os.path.join(job, f"jax_{arm}")
        cfg = TrainingConfig(**cfg_kw(paths, save, arm,
                                      os.path.join(job, "cache_jax")))
        state = MultiModalManager(cfg, bert_config=bert,
                                  load_pretrained_bert=False).train(
            features, mesh=mesh_lib.make_mesh({"data": 1}),
            num_epochs=EPOCHS)
        want[arm] = {"losses": _epoch_losses(save), "steps": int(state.step),
                     "files": sorted(os.listdir(save))}
    with open(os.path.join(job, "paths.json"), "w") as f:
        json.dump(paths, f)
    np.savez(os.path.join(job, "in.npz"), **arrays)
    _, meta = run_child(__file__, job, timeout=600)
    shutil.rmtree(job)
    return want, meta


@pytest.mark.parametrize("arm", list(ARMS))
def test_manager_from_disk_matches_jax(results, arm):
    want, meta = results
    got = meta[arm]["losses"]
    assert len(want[arm]["losses"]) == len(got) == EPOCHS
    for epoch, (a, b, tol) in enumerate(zip(got, want[arm]["losses"],
                                            LOSS_ATOL)):
        assert abs(a - b) <= tol, (arm, epoch + 1, a, b)
    assert meta[arm]["steps"] == want[arm]["steps"] == 2 * EPOCHS


@pytest.mark.parametrize("arm", list(ARMS))
def test_manager_from_disk_writes_jax_files(results, arm):
    """The same file names as JAX's Manager, the resume checkpoints
    included; the ``.bin`` files reload strict; the skipped record is
    counted; the GradCache arm ran GradCache's chunks (two a step, in each
    pass) and the cached arm read through its crop cache."""
    want, meta = results
    assert meta[arm]["files"] == want[arm]["files"]
    assert "mi_epoch2.ckpt" in want[arm]["files"]
    assert meta[arm]["strict_reload"] is True
    assert meta[arm]["skipped"] == EPOCHS
    chunks, cached = ARMS[arm]
    assert meta[arm]["chunk_generators"] == (
        0 if chunks == 1 else 2 * chunks * 2 * EPOCHS)
    assert (meta[arm]["cache_hits"] > 0) == cached


def _child(job):
    import torch

    from mimm_tpu_torch import checkpoint as ckpt
    from mimm_tpu_torch.config import TrainingConfig
    from mimm_tpu_torch.data import crop_cache
    from mimm_tpu_torch.data.features import TokenFeatureSet
    from mimm_tpu_torch.models.bert import BertConfig
    from mimm_tpu_torch.models.joint import ImageReportModel
    from mimm_tpu_torch.train import mi
    from tests.torch_port_child import unflatten_tree

    torch.backends.mkldnn.enabled = False
    with open(os.path.join(job, "paths.json")) as f:
        paths = json.load(f)
    with np.load(os.path.join(job, "in.npz")) as z:
        tree = unflatten_tree({k: z[k] for k in z.files})["init"]
    weights = ckpt.mi_weights_from_flax(
        tree["params"], tree["batch_stats"],
        [tree["critic"][str(i)] for i in range(len(tree["critic"]))],
        BERT["num_hidden_layers"])
    real_create, real_chunk = mi.create_mi_state, mi.chunk_generator
    mi.create_mi_state = lambda model, cfg, txs, generator, **kw: \
        real_create(model, cfg, txs, None, weights=weights, **kw)
    counts = {"chunks": 0, "caches": []}

    def counting_chunk(*a):
        counts["chunks"] += 1
        return real_chunk(*a)

    mi.chunk_generator = counting_chunk
    real_from_config = crop_cache.from_config

    def keep_cache(cfg):
        cache = real_from_config(cfg)
        counts["caches"].append(cache)
        return cache

    mi.crop_cache.from_config = keep_cache
    features = TokenFeatureSet.load(os.path.join(
        paths["text"], f"cachedfeatures_train_seqlen-{SEQ}.npz"))
    meta = {}
    for arm in ARMS:
        save = os.path.join(job, f"port_{arm}")
        counts["chunks"], counts["caches"] = 0, []
        cfg = TrainingConfig(**cfg_kw(paths, save, arm,
                                      os.path.join(job, "cache_port")))
        mgr = mi.MultiModalManager(cfg, bert_config=BertConfig(**BERT),
                                   load_pretrained_bert=False, device="cpu")
        state = mgr.train(features, num_epochs=EPOCHS)
        fresh = ImageReportModel(BertConfig(**BERT))
        fresh.load_state_dict(ckpt.load_state_dict_bin(os.path.join(
            save, f"pytorch_model_epoch{EPOCHS}.bin")), strict=True)
        with open(os.path.join(save, "mi.jsonl")) as f:
            skipped = [json.loads(line).get("skipped_records") for line in f]
        (cache,) = counts["caches"]
        meta[arm] = {
            "losses": _epoch_losses(save), "steps": state.step,
            "files": sorted(os.listdir(save)),
            "skipped": max(s for s in skipped if s is not None),
            "chunk_generators": counts["chunks"],
            "cache_hits": 0 if cache is None else cache.hits,
            "strict_reload": all(torch.equal(a, b) for a, b in zip(
                fresh.state_dict().values(),
                state.model.state_dict().values()))}
    np.savez(os.path.join(job, "out.npz"))
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    _child(sys.argv[1])
