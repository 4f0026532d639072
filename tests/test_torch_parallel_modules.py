"""The port's data-parallel modules (parallel/mesh.py and what uses it)
as a world of 2 gloo ranks on the CPU, each rank a jax-free child, against
one process on the same inputs.

* Sync-BN: ResNet256_6_2_1 and a small ResNetAE in train mode with
  ``bn_axis_name`` over the world, float64, B=4: every rank's rows of the
  output, the running statistics and the gradients of a loss of the
  gathered outputs (summed over the ranks) equal one process's at the
  global batch within 1e-10.
* Two autoencoder steps (``make_ae_train_step(mesh=)``, float64): the
  losses and running statistics within 1e-10, every weight within 1e-10
  but the biases of the convolutions ahead of a BatchNorm, whose true
  gradient is 0 and whose rounding noise Adam turns into steps of ±lr
  (held to 2·lr after 2 steps).
* The classifier (``ClassifierModelManager`` over a frozen autoencoder
  whose pass ``make_embedding_fn(mesh=)`` splits over the ranks, 2
  epochs) and validation (``validate._run_validation``): the MLP's
  weights, the best accuracy and every report entry equal one process's.
* ``should_stop(sync=True, sync_every=3)`` with the flag set on rank 1
  only: both ranks see it at the third call, and not before.
* The Loader's slices (``process_count``/``process_index``) equal the JAX
  package's, bit for bit, in the cases of tests/test_multihost_input.py:
  with and without bucketing, an unreadable record substituted, a resumed
  epoch, and a batch the processes do not divide.
* ``make_mesh``'s validation (a data axis the world does not match, a
  ``dcn_mesh_shape`` without or beyond ``mesh_shape``); the knobs of the
  sharding modes on one process (a 'model' axis, ZeRO-1, FSDP, sequence
  parallelism, the TP placements, a placed state) work, and a 'pipe' axis
  asks one process for the 2 ranks it lacks (``ValueError``);
  ``initialize_distributed`` is a no-op for one process and for a group
  that already exists.  tests/test_torch_tensor_parallel.py and
  tests/test_torch_zero.py hold the modes in worlds of ranks.
"""

import json
import os
import sys

import numpy as np
import pytest

WORLD_TIMEOUT = 300
TOL = 1e-10
LR = 1e-3
AE_SMALL = dict(n_residual_blocks=1, n_levels=3, z_dim=16, bottleneck_dim=32)
AE_768 = dict(n_residual_blocks=1, n_levels=3, z_dim=16, bottleneck_dim=768)
SLICE2 = "slice 2"
# what each knob of the sharding modes gives on one process (a 'pipe'
# axis of 2 lacks its ranks)
SHARDING_KNOBS = {
    "model_axis": "{'data': 1, 'model': 1}", "pipe_axis": "needs 2 ranks, the world has 1",
    "zero1": "no error", "fsdp": "no error", "sequence_parallel": "no error",
    "bert_tp": "query 0, attention output 1, output 1, LayerNorm None",
    "critic_tp": "[{'w': 1, 'b': 0}, {'w': 0, 'b': None}, "
                 "{'w': None, 'b': None}]",
    "seq_sharding": "None 1", "shard_state_zero1": "no error",
    "ae_zero1": "no error"}
LOADER_CASES = ("plain", "buckets", "bad", "resumed")


class PairedDS:
    """tests/test_multihost_input.py's dataset (numpy only)."""

    def __init__(self, n=24, seq=32, bad=()):
        rng = np.random.default_rng(0)
        self.imgs = rng.integers(0, 255, (n, 16, 16, 1)).astype(np.uint8)
        self.ids = rng.integers(1, 60, (n, seq)).astype(np.int32)
        self.lengths = rng.integers(4, seq + 1, n).astype(np.int32)
        self.mask = np.zeros((n, seq), np.int32)
        for i, length in enumerate(self.lengths):
            self.mask[i, :length] = 1
        self.n = n
        self.bad = set(bad)

    def __len__(self):
        return self.n

    def token_length(self, idx):
        return int(self.lengths[idx])

    def load(self, idx, rng, train=True):
        if idx in self.bad:
            return None
        return {"image": self.imgs[idx], "txt_ids": self.ids[idx],
                "txt_masks": self.mask[idx],
                "txt_segments": np.zeros_like(self.mask[idx]),
                "study_id": np.int64(100 + idx)}


class DiseaseDS:
    """``n`` float images (64, 64, 1) from seed 0, label ``idx % 2``."""

    def __init__(self, n=24):
        self.imgs = np.random.default_rng(0).random(
            (n, 64, 64, 1)).astype(np.float32)

    def __len__(self):
        return len(self.imgs)

    def load(self, idx, rng, train=True):
        return {"image": self.imgs[idx], "label": np.float32(idx % 2)}


def loader_slices(Loader, case: str) -> dict:
    """{'<pi>/<batch>/<key>': array} of process ``pi`` of 2 in ``case``."""
    kw = dict(batch_size=4, seed=3)
    ds = PairedDS(n=24, bad=(5,) if case == "bad" else ())
    if case == "buckets":
        kw["bucket_lengths"] = [16, 32]
    out = {}
    for pi in (0, 1):
        loader = Loader(ds, process_count=2, process_index=pi, **kw)
        stream = loader.epoch(1, start_batch=2) if case == "resumed" \
            else loader.epoch(0)
        for n, batch in enumerate(stream):
            out.update({f"{pi}/{n}/{k}": v for k, v in batch.items()})
        out[f"{pi}/skipped"] = np.array(loader.skipped)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from mimm_tpu.data.pipeline import Loader
    from tests.torch_port_child import (finish_child, finish_world, remove_job,
                                        start_child, start_world)

    job = str(tmp_path_factory.mktemp("parallel_modules"))
    dirs = {name: os.path.join(job, name) for name in ("w2", "w1")}
    for d in dirs.values():
        os.makedirs(d)
    w2 = start_world(__file__, dirs["w2"], 2)
    w1 = start_child(__file__, dirs["w1"])
    want = {case: loader_slices(Loader, case) for case in LOADER_CASES}
    try:
        Loader(PairedDS(), batch_size=5, process_count=2, process_index=0)
        want_indivisible = "no error"
    except ValueError as e:
        want_indivisible = f"ValueError: {e}"
    got = {"w1": finish_child(w1, dirs["w1"], timeout=WORLD_TIMEOUT),
           "w2": finish_world(w2, dirs["w2"], timeout=WORLD_TIMEOUT)}
    yield want, want_indivisible, got
    remove_job(job)


def _part(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("module", ["resnet", "ae"])
def test_sync_bn_equals_the_global_batch(results, module):
    _, _, got = results
    one = _part(got["w1"][0], f"{module}/")
    assert len(one) > 10
    for arrays, _ in got["w2"]:
        two = _part(arrays, f"{module}/")
        assert sorted(two) == sorted(one)
        for key in one:
            np.testing.assert_allclose(two[key], one[key], rtol=0, atol=TOL,
                                       err_msg=key)


def test_ae_steps_world2_equal_world1(results):
    _, _, got = results
    one = _part(got["w1"][0], "ae_step/")
    free = set(got["w1"][1]["ae_bias_before_bn"])
    assert free and len(one) > len(free)
    for arrays, _ in got["w2"]:
        two = _part(arrays, "ae_step/")
        assert sorted(two) == sorted(one)
        for key in one:
            tol = 2 * 2 * LR if key in free else TOL
            np.testing.assert_allclose(two[key], one[key], rtol=0, atol=tol,
                                       err_msg=key)


def test_classifier_and_validation_world2_equal_world1(results):
    _, _, got = results
    one, meta1 = got["w1"]
    for arrays, meta in got["w2"]:
        for key, v in _part(one, "clf/").items():
            np.testing.assert_allclose(arrays[f"clf/{key}"], v, rtol=0,
                                       atol=1e-6, err_msg=key)
        assert meta["clf_best"] == meta1["clf_best"]
        assert meta["report"].keys() == meta1["report"].keys()
        for key, v in meta1["report"].items():
            np.testing.assert_allclose(meta["report"][key], v, rtol=1e-6,
                                       err_msg=key)
    # the world's classifier checkpoint is the sharded directory
    assert got["w2"][0][1]["clf_ckpt_is_dir"]
    assert not meta1["clf_ckpt_is_dir"]


def test_preemption_is_agreed_on_every_third_call(results):
    _, _, got = results
    for rank, (_, meta) in enumerate(got["w2"]):
        assert meta["should_stop"] == [False, False, True, False, False,
                                       True], (rank, meta["should_stop"])
    # one process reads its own flag
    assert got["w1"][1]["should_stop"] == [True] * 6


@pytest.mark.parametrize("case", LOADER_CASES)
def test_loader_slices_match_jax(results, case):
    want, _, got = results
    port = _part(got["w1"][0], f"loader/{case}/")
    assert sorted(port) == sorted(want[case])
    for key, v in want[case].items():
        assert port[key].dtype == v.dtype, key
        assert np.array_equal(port[key], v), key


def test_loader_refuses_a_batch_the_processes_do_not_divide(results):
    _, want, got = results
    assert want.startswith("ValueError")
    assert got["w1"][1]["loader_indivisible"] == want


def test_mesh_validation(results):
    _, _, got = results
    meta = got["w2"][0][1]
    assert meta["mesh"] == {"data": 2} and meta["dcn_mesh"] == {"data": 2}
    for key in ("data3", "dcn_alone", "dcn_unknown", "indivisible_batch"):
        assert meta["errors"][key].startswith("ValueError"), (key, meta)
    assert meta["initialize_again"] is True
    one = got["w1"][1]
    assert one["initialize"] is False and one["mesh"] == {"data": 1}


@pytest.mark.parametrize("knob", ["model_axis", "pipe_axis", "zero1", "fsdp",
                                  "sequence_parallel", "bert_tp",
                                  "critic_tp", "seq_sharding",
                                  "shard_state_zero1", "ae_zero1"])
def test_sharding_modes_refuse_naming_slice2(results, knob):
    """The sharding modes run (one process); the 'pipe' axis is checked
    against the world like any axis, naming no slice."""
    _, _, got = results
    res = got["w1"][1]["refusals"][knob]
    if knob == "pipe_axis":
        assert res.startswith("ValueError") and SLICE2 not in res
    assert SHARDING_KNOBS[knob] in res, res


def _error_of(fn) -> str:
    try:
        fn()
    except Exception as e:   # noqa: BLE001 - the message is the result
        return f"{type(e).__name__}: {e}"
    return "no error"


def _child(job):
    import copy

    import torch

    from mimm_tpu_torch import preempt
    from mimm_tpu_torch import validate
    from mimm_tpu_torch.config import TrainingConfig
    from mimm_tpu_torch.data.pipeline import Loader
    from mimm_tpu_torch.models.autoencoder import ResNetAE
    from mimm_tpu_torch.models.bert import BertConfig
    from mimm_tpu_torch.models.resnet import ResNet256_6_2_1
    from mimm_tpu_torch.parallel import mesh as mesh_lib
    from mimm_tpu_torch.train import ae, classifier, mi

    torch.backends.mkldnn.enabled = False
    meta = {"initialize": mesh_lib.initialize_distributed(device="cpu")}
    mesh = mesh_lib.make_mesh()
    world = mesh.size
    meta["mesh"] = mesh.shape
    out = {}
    dev = torch.device("cpu")

    def world_grads(module, loss):
        """The gradients of ``loss`` summed over the ranks."""
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(module.parameters(), torch.autograd.grad(
                     loss, list(module.parameters()), allow_unused=True))]
        mesh_lib.all_reduce_(grads, mesh)
        return {n: g.numpy() for (n, _), g in zip(module.named_parameters(),
                                                  grads)}

    # ---- sync-BN: ResNet and autoencoder -----------------------------------
    torch.manual_seed(0)
    resnet = ResNet256_6_2_1(dtype=torch.float64,
                             bn_axis_name=mesh).double()
    x = torch.from_numpy(np.random.default_rng(1).random((4, 256, 256, 1)))
    z = resnet(x[mesh_lib.local_rows(mesh, 4)], train=True)[1]
    zg = mesh_lib.gather_rows(z, mesh)
    out["resnet/z"] = zg.detach().numpy()
    out.update({f"resnet/grad/{k}": v for k, v in world_grads(
        resnet, (zg * zg).mean()).items()})
    out.update({f"resnet/{k}": v.numpy() for k, v in
                resnet.state_dict().items() if "running" in k})
    torch.manual_seed(0)
    auto = ResNetAE(input_shape=(64, 64, 1), dtype=torch.float64,
                    bn_axis_name=mesh, **AE_SMALL).double()
    xa = torch.from_numpy(np.random.default_rng(2).random((4, 1, 64, 64)))
    y = mesh_lib.gather_rows(
        auto(xa[mesh_lib.local_rows(mesh, 4)], train=True), mesh)
    out["ae/y"] = y.detach().numpy()
    out.update({f"ae/grad/{k}": v for k, v in world_grads(
        auto, ((y - xa) ** 2).mean()).items()})
    out.update({f"ae/{k}": v.numpy() for k, v in auto.state_dict().items()
                if "running" in k})

    # ---- two autoencoder steps ----------------------------------------------
    torch.manual_seed(0)
    auto = ResNetAE(input_shape=(64, 64, 1), dtype=torch.float64,
                    **AE_SMALL).double()
    cfg = TrainingConfig().replace(init_lr=LR, batch_size=4)
    state = ae.create_ae_state(auto, cfg, torch.Generator().manual_seed(0))
    step = ae.make_ae_train_step(auto, ae._ae_tx(cfg), mesh=mesh)
    for s in range(2):
        imgs = torch.from_numpy(np.random.default_rng(10 + s).random(
            (4, 64, 64, 1)))
        state, loss = step(state, imgs[mesh_lib.local_rows(mesh, 4)])
        out[f"ae_step/loss{s}"] = loss.numpy()
    out.update({f"ae_step/{k}": v.numpy() for k, v in
                auto.state_dict().items()
                if not k.endswith("num_batches_tracked")})
    meta["ae_bias_before_bn"] = sorted(
        f"{name}.0.bias" for name, m in auto.named_modules()
        if isinstance(m, torch.nn.Sequential) and len(m) > 1
        and isinstance(m[1], torch.nn.BatchNorm2d)
        and getattr(m[0], "bias", None) is not None)

    # ---- the classifier and validation ---------------------------------------
    torch.manual_seed(0)
    encoder = ResNetAE(input_shape=(64, 64, 1), **AE_768)
    save = os.path.join(os.path.dirname(job), f"clf-{os.path.basename(job)}")
    cfg = TrainingConfig().replace(
        save_directory=save, batch_size=4, seed=0, prefetch=1,
        num_train_epochs_classifier=2, disease_label="Pneumonia",
        init_lr=1e-3, data_loader_workers=0)
    embed = classifier.make_embedding_fn("unimodal", encoder, mesh=mesh)
    manager = classifier.ClassifierModelManager(
        cfg, embed, [32, 16], dataset=DiseaseDS(), val_fraction=0.25,
        mesh=mesh, device="cpu")
    clf_state, best, best_path = manager.train()
    out.update({f"clf/{k}": v.detach().numpy()
                for k, v in clf_state.model.state_dict().items()})
    meta["clf_best"] = best
    meta["clf_ckpt_is_dir"] = os.path.isdir(best_path)
    loader = Loader(DiseaseDS(), 4, seed=0, train=False, drop_last=False)
    report = validate._run_validation(embed, clf_state.model, loader, dev)
    meta["report"] = {k: float(v) for k, v in report.items()}

    # ---- preemption agreed on across the ranks ---------------------------------
    preempt.clear()
    preempt._sync_calls = 0     # the classifier's epochs above called it
    if mesh.rank == world - 1:
        preempt.request()
    meta["should_stop"] = [preempt.should_stop(sync=True, sync_every=3)
                           for _ in range(6)]
    preempt.clear()

    # ---- mesh validation and refusals -----------------------------------------
    errors = {}
    if world > 1:
        meta["initialize_again"] = mesh_lib.initialize_distributed(
            device="cpu")
        meta["dcn_mesh"] = mesh_lib.make_mesh({"data": 1},
                                              {"data": 2}).shape
        errors["data3"] = _error_of(lambda: mesh_lib.make_mesh({"data": 3}))
        errors["dcn_alone"] = _error_of(
            lambda: mesh_lib.make_mesh(None, {"data": 2}))
        errors["dcn_unknown"] = _error_of(
            lambda: mesh_lib.make_mesh({"data": 2}, {"other": 2}))
        errors["indivisible_batch"] = _error_of(lambda: mesh_lib.shard_batch(
            mesh, {"x": np.zeros((3, 2))}))
    meta["errors"] = errors
    if world == 1:
        for case in LOADER_CASES:
            out.update({f"loader/{case}/{k}": v
                        for k, v in loader_slices(Loader, case).items()})
        meta["loader_indivisible"] = _error_of(lambda: Loader(
            PairedDS(), batch_size=5, process_count=2, process_index=0))
        tiny = BertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                          num_attention_heads=2, intermediate_size=64,
                          max_position_embeddings=32, num_classes=1)
        base = TrainingConfig().replace(compute_dtype="float32")
        model = mi.build_joint_model(base, tiny, device="cpu")
        txs = mi.make_optimizers(base, steps_per_epoch=2)
        state = mi.create_mi_state(model, base, txs,
                                   torch.Generator().manual_seed(0))
        tp_mesh = mesh_lib.make_mesh({"data": 1, "model": 1})
        text = state.params["text_model"]
        layer0 = "bert.encoder.layer.0."

        def bert_tp():
            d = mesh_lib.bert_tp_shardings(tp_mesh, text)
            return (f"query {d[layer0 + 'attention.self.query.weight']}, "
                    f"attention output "
                    f"{d[layer0 + 'attention.output.dense.weight']}, "
                    f"output {d[layer0 + 'output.dense.weight']}, "
                    f"LayerNorm {d[layer0 + 'output.LayerNorm.weight']}")

        def ae_zero1():
            small = ResNetAE(input_shape=(64, 64, 1), dtype=torch.float64,
                             **AE_SMALL).double()
            placed = mesh_lib.shard_ae_state(mesh, ae.create_ae_state(
                small, base, torch.Generator().manual_seed(0)), zero1=True)
            ae.make_ae_train_step(small, ae._ae_tx(base), mesh=mesh)(
                placed, torch.zeros((2, 64, 64, 1), dtype=torch.float64))

        meta["refusals"] = {
            "model_axis": str(tp_mesh.shape),
            "pipe_axis": _error_of(lambda: mesh_lib.make_mesh({"pipe": 2})),
            "zero1": _error_of(lambda: mi.make_mi_train_step(
                model, txs, base.replace(zero1_optimizer_sharding=True))),
            "fsdp": _error_of(lambda: mi.make_mi_train_step(
                model, txs, base.replace(fsdp_parameter_sharding=True))),
            "sequence_parallel": _error_of(lambda: mi.build_joint_model(
                base.replace(sequence_parallel=True), tiny, device="cpu")),
            "bert_tp": bert_tp(),
            "critic_tp": str(mesh_lib.critic_tp_shardings(
                tp_mesh, state.critic_params)),
            "seq_sharding": f"{mesh_lib.seq_sharding(mesh)} "
                            f"{mesh_lib.seq_sharding(tp_mesh)}",
            "shard_state_zero1": _error_of(lambda: mesh_lib.shard_mi_state(
                mesh, copy.copy(state), zero1=True)),
            "ae_zero1": _error_of(ae_zero1),
        }
    suffix = f"-rank{mesh.rank}" if world > 1 else ""
    np.savez(os.path.join(job, f"out{suffix}.npz"), **out)
    with open(os.path.join(job, f"out{suffix}.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    _child(sys.argv[1])
