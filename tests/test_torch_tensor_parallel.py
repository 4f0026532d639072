"""The port's tensor and sequence parallelism (parallel/mesh.py,
models/bert.py, objectives/pairing.py, train/mi.py) as worlds of gloo
ranks on the CPU, each rank a jax-free child process, against one rank.

* A world of 2 on ``{'model': 2}`` (a 2-layer BERT of hidden 64, 4 heads,
  intermediate 128; 256 px images, L=16, B=8), float64 with dropout off,
  two MI steps: TP, TP + sequence parallelism, and TP under GradCache (2
  chunks) equal one rank within 1e-10 in the losses and every parameter,
  critic tensor, BatchNorm statistic and optimizer moment (gathered).
* The same world at dropout 0.1 on the plain attention path (the masks of
  the attention probabilities are a rank's heads of the whole mask, the
  hidden dropouts the whole mask or, under SP, a rank's tokens of it):
  TP and TP + SP equal one rank within 1e-10.  The plain
  ``attention_keep_mask`` at head offset h0 equals the whole mask's head
  slice, bit for bit.
* The critic alone, TP on the factorized path (JAX's
  ``test_critic_tensor_parallel_matches_replicated``, tests/
  test_sharding.py:434): the scores and their gradients equal the
  replicated critic's in float64 within 1e-10, and JAX's scores to its
  tolerance (rtol 1e-5 / atol 1e-5).
* A world of 4 on ``{'data': 2, 'model': 2}`` with SP, ZeRO-1 and FSDP,
  float64: equals one rank at the global batch within 1e-10.  The same
  world in float32 from JAX's initial state, TP and TP + SP, against
  JAX's step on the same mesh (tests/test_sharding.py:302, :337): the
  loss to rtol 1e-5 / atol 1e-6, the second step's to 5e-4 / 5e-5.
* The fused FFN under TP (intermediate columns per rank, b2 once after
  the sum): one layer's output and gradients equal the unsharded layer's
  within 1e-10 in float64.
* ``--mesh_shape data=2,model=2`` with ``--sequence_parallel``,
  ``--zero1_optimizer_sharding`` and ``--fsdp_parameter_sharding`` parse
  and reach the trainers of ``cli.multi_modal`` and ``cli.uni_modal``,
  whose mesh then asks for the 4 ranks a single process lacks.
* GPipe's knobs reach the mesh and the step: a 'pipe' axis asks one
  process for the 2 ranks it lacks, and ``pipeline_microbatches`` builds
  the step (tests/test_torch_pipeline.py runs them in worlds).
"""

import json
import os
import sys

import numpy as np
import pytest

B, IMG, SEQ = 8, 256, 16
TINY = dict(vocab_size=64, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=32, num_classes=1,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
CFG = dict(batch_size=B, img_size=IMG, max_seq_length=SEQ,
           compute_dtype="float32", num_train_epochs=1,
           use_pallas_critic=False, flash_attention=False, seed=0)
TOL64 = 1e-10
WORLD_TIMEOUT = 400
RUNS = ("plain", "sp", "gc", "drop", "drop_sp")


def _batch(b=B, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.random((b, IMG, IMG, 1), np.float32),
        "txt_ids": rng.integers(0, 64, (b, SEQ)).astype(np.int32),
        "txt_masks": (np.arange(SEQ)[None] < rng.integers(
            4, SEQ + 1, (b, 1))).astype(np.int32),
        "txt_segments": np.zeros((b, SEQ), np.int32),
        "study_id": np.arange(b, dtype=np.int64)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax
    from jax.sharding import NamedSharding

    from mimm_tpu.config import TrainingConfig
    from mimm_tpu.models.bert import BertConfig
    from mimm_tpu.models.mlp import make_mlp
    from mimm_tpu.objectives.pairing import pairwise_critic_scores
    from mimm_tpu.parallel import mesh as mesh_lib
    from mimm_tpu.train.mi import (build_joint_model, create_mi_state,
                                   make_mi_train_step, make_optimizers)
    from tests.test_torch_train import _flat_state
    from tests.torch_port_child import (finish_child, finish_world, remove_job,
                                        start_child, start_world)

    job = str(tmp_path_factory.mktemp("tensor_parallel"))
    cfg = TrainingConfig().replace(**CFG)
    model = build_joint_model(cfg, BertConfig(**TINY))
    txs = make_optimizers(cfg, steps_per_epoch=2)
    init = jax.device_get(create_mi_state(model, cfg, txs,
                                          jax.random.PRNGKey(0)))
    batch = _batch()
    arrays = _flat_state(init.params, init.batch_stats, init.critic_params,
                         "init/")
    arrays.update({f"batch/{k}": v for k, v in batch.items()})
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    critic = jax.device_get(make_mlp(k1, 64, [32, 16]))
    ei, et = (np.asarray(jax.random.normal(k, (8, 32))) for k in (k2, k3))
    for i, layer in enumerate(critic):
        for k in ("w", "b"):
            arrays[f"tpcritic/{i}/{k}"] = np.asarray(layer[k])
    arrays["tpcritic_in/img"], arrays["tpcritic_in/txt"] = ei, et
    np.savez(os.path.join(job, "in.npz"), **arrays)

    jobs = {}
    for name, n in (("tp2", 2), ("dm4", 4)):
        d = os.path.join(job, name)
        os.makedirs(d)
        os.symlink(os.path.join(job, "in.npz"), os.path.join(d, "in.npz"))
        jobs[name] = (d, start_world(__file__, d, n, name))
    d1 = os.path.join(job, "one")
    os.makedirs(d1)
    os.symlink(os.path.join(job, "in.npz"), os.path.join(d1, "in.npz"))
    one = start_child(__file__, d1, "one")

    # ---- JAX: the data x model mesh (tests/test_sharding.py:302, :337) ----
    want = {}
    mesh = mesh_lib.make_mesh({"data": 2, "model": 2})
    for name, c in (("tp", cfg), ("sp", cfg.replace(sequence_parallel=True))):
        m = build_joint_model(c, BertConfig(**TINY),
                              mesh=mesh if name == "sp" else None)
        step = make_mi_train_step(m, txs, c)
        s = mesh_lib.shard_mi_state(mesh, create_mi_state(
            m, c, txs, jax.random.PRNGKey(0)))
        b = mesh_lib.shard_batch(mesh, batch)
        s, l1 = step(s, b)
        _, l2 = step(s, b)
        want[f"jax_{name}"] = np.array([float(l1), float(l2)])
    specs = mesh_lib.critic_tp_shardings(mesh, critic)
    sharded = jax.device_put(critic, jax.tree.map(
        lambda s: NamedSharding(mesh, s), specs,
        is_leaf=lambda x: type(x).__name__ == "PartitionSpec"))
    want["critic_scores"] = np.asarray(jax.jit(pairwise_critic_scores)(
        sharded, ei, et))

    got = {name: finish_world(procs, d, timeout=WORLD_TIMEOUT)
           for name, (d, procs) in jobs.items()}
    got["one"] = [finish_child(one, d1, timeout=WORLD_TIMEOUT)]
    yield want, got
    remove_job(job)


def _part(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def _max_diff(a: dict, b: dict) -> tuple:
    keys = sorted(a)
    assert keys == sorted(b), set(keys) ^ set(b)
    worst = max(keys, key=lambda k: float(np.max(np.abs(a[k] - b[k])))
                if a[k].size else 0.0)
    return float(np.max(np.abs(a[worst] - b[worst]))), worst


@pytest.mark.parametrize("run", RUNS)
def test_model2_world_equals_one_rank_f64(results, run):
    _, got = results
    ref = "drop" if run.startswith("drop") else "gc" if run == "gc" \
        else "plain"
    one = _part(got["one"][0][0], ref + "/")
    assert len(one) > 100
    for arrays, _ in got["tp2"]:
        diff, key = _max_diff(_part(arrays, run + "/"), one)
        assert diff <= TOL64, (run, key, diff)
    # both ranks gather the same state, bit for bit
    a, b = (_part(r[0], run + "/") for r in got["tp2"])
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_model2_runs_really_shard(results):
    """The TP pieces are halves of the whole tensors, and SP was active."""
    _, got = results
    for _, meta in got["tp2"]:
        assert meta["query_rows"] == TINY["hidden_size"] // 2
        assert meta["critic_w1_cols"] == 512
        assert meta["sp_active"] is True


def test_keep_mask_at_a_head_offset_is_the_whole_masks_slice(results):
    _, got = results
    assert got["one"][0][1]["mask_slices"] == [True, True]


def test_critic_tp_matches_replicated_and_jax(results):
    want, got = results
    for arrays, _ in got["tp2"]:
        one = got["one"][0][0]
        for key in ("scores", "grad_img", "grad_txt", "grad_w1", "grad_b1",
                    "grad_w2", "grad_b2", "grad_w3"):
            diff = np.max(np.abs(arrays[f"critic/{key}"]
                                 - one[f"critic/{key}"]))
            assert diff <= TOL64, (key, diff)
        np.testing.assert_allclose(arrays["critic/scores"],
                                   want["critic_scores"], rtol=1e-5,
                                   atol=1e-5)


def test_data2_model2_sp_zero1_fsdp_equals_one_rank_f64(results):
    _, got = results
    one = _part(got["one"][0][0], "plain/")
    for arrays, _ in got["dm4"]:
        diff, key = _max_diff(_part(arrays, "zsf/"), one)
        assert diff <= TOL64, (key, diff)


@pytest.mark.parametrize("run", ["tp", "sp"])
def test_data2_model2_matches_jax_mesh(results, run):
    want, got = results
    for arrays, _ in got["dm4"]:
        losses = arrays[f"jax_{run}"]
        np.testing.assert_allclose(losses[0], want[f"jax_{run}"][0],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(losses[1], want[f"jax_{run}"][1],
                                   rtol=5e-4, atol=5e-5)


def test_fused_ffn_under_tp_equals_unsharded(results):
    _, got = results
    one = _part(got["one"][0][0], "ffn/")
    assert len(one) == 7
    for arrays, _ in got["tp2"]:
        diff, key = _max_diff(_part(arrays, "ffn/"), one)
        assert diff <= TOL64, (key, diff)


KNOBS = {"mesh_shape": [["data", 2], ["model", 2]], "sequence_parallel": True,
         "zero1_optimizer_sharding": True, "fsdp_parameter_sharding": True}


@pytest.mark.parametrize("entry", ["multi_modal", "uni_modal"])
def test_cli_knobs_reach_the_trainers(results, entry):
    meta = results[1]["one"][0][1]["cli"][entry]
    assert meta["cfg"] == KNOBS, meta
    assert meta["error"].startswith("ValueError") \
        and "needs 4 ranks" in meta["error"], meta


@pytest.mark.parametrize("what", ["pipe_axis", "pipeline_microbatches"])
def test_gpipe_raises_naming_slice3(results, what):
    err = results[1]["one"][0][1]["gpipe"][what]
    if what == "pipe_axis":
        assert err.startswith("ValueError") and "needs 2 ranks" in err, err
    else:
        assert err == "no error", err


# ---- the port side ----------------------------------------------------------

def _error_of(fn) -> str:
    try:
        fn()
    except Exception as e:   # noqa: BLE001 - the message is the result
        return f"{type(e).__name__}: {e}"
    return "no error"


def _flat(tree, prefix):
    """mi_state_tree's tensors as {'<prefix>a/b': array}."""
    import torch

    out = {}

    def walk(node, key):
        if torch.is_tensor(node):
            if not key.endswith("num_batches_tracked"):
                out[prefix + key] = node.detach().cpu().numpy()
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{key}/{k}" if key else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{key}/{i}" if key else str(i))
    walk(tree, "")
    return out


def _ffn_layer(mesh, torch):
    """One BertLayer with the fused FFN (hidden 128, intermediate 512,
    tanh GELU), float64, forward and backward; under a 'model' axis the
    layer is cut to its TP pieces and its gradients gathered."""
    from mimm_tpu_torch.models.bert import (BertConfig, BertLayer,
                                            set_tensor_parallel)
    from mimm_tpu_torch.parallel import mesh as mesh_lib

    cfg = BertConfig(hidden_size=128, num_attention_heads=2,
                     intermediate_size=512, gelu_tanh=True, fused_ffn=True,
                     hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    torch.manual_seed(3)
    layer = BertLayer(cfg).double()
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 8, 128, generator=gen, dtype=torch.float64)
    bias = torch.zeros(2, 1, 1, 8, dtype=torch.float64)
    params = dict(layer.named_parameters())
    dims = mesh_lib.bert_tp_shardings(mesh, {"l." + n: p
                                             for n, p in params.items()})
    dims = {n[2:]: d for n, d in dims.items()}
    if mesh is not None:
        with torch.no_grad():
            for n, p in params.items():
                p.data = mesh_lib.shard_leaf(p.data, dims[n], mesh, "model")
        set_tensor_parallel(layer, mesh)
    x.requires_grad_()
    y = layer(x, bias)
    names = ["intermediate.dense.weight", "intermediate.dense.bias",
             "output.dense.weight", "output.dense.bias",
             "output.LayerNorm.weight"]
    grads = torch.autograd.grad((y * y).sum(), [x] + [params[n]
                                                     for n in names])
    out = {"ffn/y": y.detach().numpy(), "ffn/dx": grads[0].numpy()}
    for n, g in zip(names, grads[1:]):
        out[f"ffn/{n}"] = mesh_lib.gather_leaf(g, dims[n], mesh,
                                               "model").numpy() \
            if mesh is not None else g.numpy()
    return out


def _cli_knobs(job) -> dict:
    """The knobs of the sharding modes through the two training entry
    points, on one process: what reached each trainer, and its error."""
    from mimm_tpu_torch.cli import multi_modal as cli_mm
    from mimm_tpu_torch.cli import uni_modal as cli_um
    from mimm_tpu_torch.train import ae, mi

    seen = {}

    def recorded(name, fn):
        def wrapper(*args, **kw):
            cfg = args[0].cfg if name == "multi_modal" else args[0]
            seen[name] = {k: [list(p) for p in v] if k == "mesh_shape" else v
                          for k, v in ((k, getattr(cfg, k)) for k in KNOBS)}
            return fn(*args, **kw)
        return wrapper

    mi.MultiModalManager.train = recorded("multi_modal",
                                          mi.MultiModalManager.train)
    ae.train_auto_encoder = recorded("uni_modal", ae.train_auto_encoder)
    # no vocabulary here: the featurization is not under test
    cli_mm.NativeWordPieceTokenizer = type(
        "NoTokenizer", (), {"from_pretrained": staticmethod(lambda d: None)})
    cli_mm.load_and_cache_examples = lambda *a, **k: []
    flags = ["--mesh_shape", "data=2,model=2", "--sequence_parallel", "true",
             "--zero1_optimizer_sharding", "true",
             "--fsdp_parameter_sharding", "true", "--device", "cpu"]
    out = {}
    for name, main in (("multi_modal", cli_mm.main), ("uni_modal",
                                                      cli_um.main)):
        err = _error_of(lambda: main(flags + [
            "--save_directory", os.path.join(job, f"cli_{name}")]))
        out[name] = {"cfg": seen.get(name), "error": err}
    return out


def _child(job, mode):
    import torch

    from mimm_tpu_torch import checkpoint as ckpt
    from mimm_tpu_torch.config import TrainingConfig
    from mimm_tpu_torch.models.bert import BertConfig
    from mimm_tpu_torch.models.joint import ImageReportModel
    from mimm_tpu_torch.objectives.pairing import pairwise_critic_scores
    from mimm_tpu_torch.ops.philox import attention_keep_mask
    from mimm_tpu_torch.parallel import mesh as mesh_lib
    from mimm_tpu_torch.train import mi
    from tests.torch_port_child import unflatten_tree

    torch.backends.mkldnn.enabled = False
    mesh_lib.initialize_distributed(device="cpu")
    out, meta = {}, {}
    with np.load(os.path.join(job, "in.npz")) as z:
        tree = unflatten_tree({k: z[k] for k in z.files})
    batch_np = {k: torch.from_numpy(v) for k, v in tree["batch"].items()}

    def run(name, mesh, shape=None, steps=2, f64=True, dtype_cfg=None,
            **knobs):
        """``steps`` MI steps from the same weights; the gathered final
        state and the losses under ``name/``."""
        bert = BertConfig(**dict(TINY, **(dtype_cfg or {})))
        c = TrainingConfig().replace(**CFG, **knobs)
        model = mi.build_joint_model(c, bert, device="cpu")
        txs = mi.make_optimizers(c, steps_per_epoch=2)
        if f64:
            model = ImageReportModel(bert, output_channels=1,
                                     dtype=torch.float64).double()
            state = mi.create_mi_state(model, c, txs,
                                       torch.Generator().manual_seed(0))
        else:
            init = tree["init"]
            weights = ckpt.mi_weights_from_flax(
                init["params"], init["batch_stats"],
                [init["critic"][str(i)] for i in range(len(init["critic"]))],
                TINY["num_hidden_layers"])
            state = mi.create_mi_state(model, c, txs, None, weights=weights)
        state = mesh_lib.shard_mi_state(
            mesh, state, zero1=c.zero1_optimizer_sharding,
            fsdp=c.fsdp_parameter_sharding,
            sequence_parallel=c.sequence_parallel)
        step = mi.make_mi_train_step(model, txs, c, mesh=mesh)
        b = {k: v.double() if f64 and k == "image" else v
             for k, v in batch_np.items()}
        b = mesh_lib.shard_batch(mesh, b)
        losses = []
        for _ in range(steps):
            state, loss = step(state, b)
            losses.append(loss.item())
        out[f"{name}/losses"] = np.array(losses)
        if f64:
            out.update(_flat(mi.mi_state_tree(state), name + "/"))
        return state, model

    drop = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    if mode == "one":
        mesh = None
        run("plain", None)
        run("gc", None, grad_cache_chunks=2)
        run("drop", None, dtype_cfg=drop)
        out.update(_ffn_layer(None, torch))
        seed = torch.tensor([9], dtype=torch.int32)
        meta["mask_slices"] = [bool(torch.equal(
            attention_keep_mask(seed, 2, 2, 12, 0.3, head_offset=h0,
                                heads_total=6),
            attention_keep_mask(seed, 2, 6, 12, 0.3)[:, h0:h0 + 2]))
            for h0 in (0, 4)]
        meta["cli"] = _cli_knobs(job)
        meta["gpipe"] = {
            "pipe_axis": _error_of(lambda: mesh_lib.make_mesh({"pipe": 2})),
            "pipeline_microbatches": _error_of(lambda: mi.make_mi_train_step(
                None, None, TrainingConfig().replace(
                    pipeline_microbatches=4)))}
    elif mode == "tp2":
        mesh = mesh_lib.make_mesh({"model": 2})
        state, model = run("plain", mesh)
        meta["query_rows"] = int(model.text_model.bert.encoder.layer[0]
                                 .attention.self.query.weight.shape[0])
        meta["critic_w1_cols"] = int(state.critic_params[0]["w"].shape[1])
        _, model = run("sp", mesh, sequence_parallel=True)
        meta["sp_active"] = bool(model.text_model.bert.sequence_parallel)
        run("gc", mesh, grad_cache_chunks=2)
        run("drop", mesh, dtype_cfg=drop)
        run("drop_sp", mesh, dtype_cfg=drop, sequence_parallel=True)
        out.update(_ffn_layer(mesh, torch))
    else:   # dm4
        mesh = mesh_lib.make_mesh({"data": 2, "model": 2})
        run("zsf", mesh, sequence_parallel=True,
            zero1_optimizer_sharding=True, fsdp_parameter_sharding=True)
        for name, knobs in (("tp", {}), ("sp", dict(sequence_parallel=True))):
            run(f"j{name}", mesh, f64=False, **knobs)
            out[f"jax_{name}"] = out[f"j{name}/losses"]

    # the critic alone: TP against replicated, float64
    if mode in ("one", "tp2"):
        critic = [{k: torch.from_numpy(tree["tpcritic"][str(i)][k])
                   .double().requires_grad_() for k in ("w", "b")}
                  for i in range(len(tree["tpcritic"]))]
        ei = torch.from_numpy(tree["tpcritic_in"]["img"]).double() \
            .requires_grad_()
        et = torch.from_numpy(tree["tpcritic_in"]["txt"]).double() \
            .requires_grad_()
        dims = mesh_lib.critic_tp_shardings(mesh, critic)
        local = [{k: mesh_lib.shard_leaf(t.detach(), dims[i][k], mesh,
                                         "model").requires_grad_()
                  for k, t in layer.items()} for i, layer in enumerate(critic)]
        s = pairwise_critic_scores(local, ei, et, mesh)
        g = torch.autograd.grad((s * s).sum(), [ei, et] + [
            local[0]["w"], local[0]["b"], local[1]["w"], local[1]["b"],
            local[2]["w"]])
        whole = [mesh_lib.gather_leaf(t, d, mesh, "model") for t, d in zip(
            g[2:], (dims[0]["w"], dims[0]["b"], dims[1]["w"], dims[1]["b"],
                    dims[2]["w"]))]
        out["critic/scores"] = s.detach().numpy()
        for key, t in zip(("grad_img", "grad_txt", "grad_w1", "grad_b1",
                           "grad_w2", "grad_b2", "grad_w3"),
                          list(g[:2]) + whole):
            out[f"critic/{key}"] = t.numpy()

    suffix = f"-rank{mesh_lib.world_rank()}" \
        if os.environ.get("MIMM_NUM_PROCESSES") else ""
    np.savez(os.path.join(job, f"out{suffix}.npz"), **out)
    with open(os.path.join(job, f"out{suffix}.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    args = [a for a in sys.argv[2:] if a != "--rank" and not a.isdigit()]
    _child(sys.argv[1], args[0])
