"""The port's GPipe pipeline parallelism (parallel/pipeline.py, the 'pipe'
axis of parallel/mesh.py, train/mi.py) as worlds of gloo ranks on the CPU,
each rank a jax-free child process, against one rank and against JAX's
``pipelined_textbert_apply`` / pipelined MI step on the same mesh shapes
(tests/test_pipeline_parallel.py), JAX running in the pytest process on its
8 CPU devices.

* The text tower (JAX's BERT4: 4 layers, h = 32; B = 8, L = 16) on
  ``{'pipe': 2}`` at M = 2 and M = 4, ``{'pipe': 4}`` at M = 4 and
  ``{'data': 2, 'pipe': 2}`` at M = 4: the pooled output and the logits
  equal JAX's pipelined forward in float32 (rtol 1e-5, atol 1e-6: JAX's
  own) and the port's one rank in float64 (1e-10); the gradients of
  sum(pooled²) + sum(logits²), gathered from the stages, equal one rank's
  in float64 (1e-10) and JAX's pipelined gradients in float32 (rtol 2e-4,
  atol 1e-5).  At dropout 0.1 two runs give the same bits, and remat on
  equals off.
* Two MI steps (a 2-layer BERT, 256 px, B = 8, dropout 0): ``{'pipe': 2}``
  at M = 2, ``{'data': 2, 'pipe': 2}`` at M = 4 and GradCache (2 chunks)
  under ``{'pipe': 2}`` equal one rank in float64 within 1e-10 in the
  losses and every parameter, critic tensor, BatchNorm statistic and
  optimizer moment (gathered); the ``{'data': 2, 'pipe': 2}`` world from
  JAX's initial state takes JAX's pipelined steps on the same mesh shape
  (the loss to rtol 1e-5 / atol 1e-6, the second step's to 5e-4 / 5e-5).
  With ZeRO-1 + FSDP the world gives the same bits, and each rank's
  resident text parameters and moments are its stage's layers plus the
  replicated rest.  ``freeze_text_encoder`` leaves the stages' layers
  unchanged while the image tower trains.
* Checkpoints hold the plain ``layer0 .. layer{n-1}`` tree: a
  ``{'pipe': 2}`` world's state after one step resumes on one rank, and
  one rank's on ``{'pipe': 2}``, each second step within 1e-10 of the
  uninterrupted run.  ``cli.multi_modal --mesh_shape data=2,pipe=2
  --pipeline_microbatches 2`` trains 2 epochs from disk; its last
  checkpoint is the world's gathered state bit for bit, in the plain
  layout; the world resumed from its first checkpoint ends on the same
  bits; the converter's ``.bin`` files load ``strict=True``.
* The AE step and the classifier's embedding pass and step on
  ``{'data': 2, 'pipe': 2}`` equal the ``{'data': 2}`` world bit for bit
  (the pipe ranks are replicas of their data index).
* ``ValueError``: S not dividing the layers, M not dividing the rows, and
  a mesh with 'model' and 'pipe' both larger than 1.
"""

import json
import os
import sys
import time

import numpy as np
import pytest

B, L, IMG = 8, 16, 256
BERT4 = dict(vocab_size=64, hidden_size=32, num_hidden_layers=4,
             num_attention_heads=2, intermediate_size=64,
             max_position_embeddings=32, num_classes=1)
MI_BERT = dict(BERT4, num_hidden_layers=2, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
CFG = dict(batch_size=B, img_size=IMG, max_seq_length=L,
           compute_dtype="float32", num_train_epochs=1,
           use_pallas_critic=False, flash_attention=False, seed=0)
# (name, mesh shape, microbatches) of the text forward cases
TEXT_CASES = {"p2m2": ({"pipe": 2}, 2), "p2m4": ({"pipe": 2}, 4),
              "p4m4": ({"pipe": 4}, 4), "d2p2m4": ({"data": 2, "pipe": 2}, 4)}
JAX_GRAD_CASE = "d2p2m4"
AE_SMALL = dict(n_residual_blocks=1, n_levels=3, z_dim=16, bottleneck_dim=32)
CLI_BERT = dict(MI_BERT, max_position_embeddings=32)
CLI_PAIRS = 8
TOL64 = 1e-10
WORLD_TIMEOUT = 400
WAIT_S = 300            # a rank waiting for another process's checkpoint


def _text_inputs():
    """JAX's ``_text_inputs(8, 16)`` (tests/test_pipeline_parallel.py)."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, (B, L)).astype(np.int32)
    masks = (rng.random((B, L)) < 0.9).astype(np.int32)
    masks[:, 0] = 1
    return ids, masks, np.zeros((B, L), np.int32)


def _mi_batch():
    rng = np.random.default_rng(1)
    ids, masks, segs = _text_inputs()
    return {"image": rng.random((B, IMG, IMG, 1), np.float32),
            "txt_ids": ids, "txt_masks": masks, "txt_segments": segs,
            "study_id": np.arange(B, dtype=np.int64)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from mimm_tpu import checkpoint as jckpt
    from mimm_tpu.config import TrainingConfig
    from mimm_tpu.models.bert import BertConfig, TextBert
    from mimm_tpu.parallel import mesh as jmesh
    from mimm_tpu.parallel.pipeline import pipelined_textbert_apply
    from mimm_tpu.train.mi import (build_joint_model, create_mi_state,
                                   make_mi_train_step, make_optimizers)
    from tests.test_torch_datasets import write_corpus
    from tests.test_torch_train import _flat_state
    from tests.torch_port_child import (finish_child, finish_world,
                                        flatten_tree, remove_job, start_child,
                                        start_world)

    job = str(tmp_path_factory.mktemp("pipeline"))
    bert4 = BertConfig(**BERT4)
    text_params = TextBert(bert4, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((2, L), jnp.int32))["params"]
    cfg = TrainingConfig().replace(**CFG)
    model = build_joint_model(cfg, BertConfig(**MI_BERT))
    txs = make_optimizers(cfg, steps_per_epoch=2)
    init = jax.device_get(create_mi_state(model, cfg, txs,
                                          jax.random.PRNGKey(0)))
    ids, masks, segs = _text_inputs()
    batch = _mi_batch()
    arrays = flatten_tree(jax.device_get(text_params), "text/")
    arrays.update(_flat_state(init.params, init.batch_stats,
                              init.critic_params, "init/"))
    arrays.update({f"batch/{k}": v for k, v in batch.items()})
    np.savez(os.path.join(job, "in.npz"), **arrays)
    paths = write_corpus(os.path.join(job, "corpus"), CLI_PAIRS, 256, 13,
                         sizes=((300, 280), (256, 320)))
    with open(os.path.join(paths["bert"], "bert_config.json"), "w") as f:
        json.dump(CLI_BERT, f)
    with open(os.path.join(job, "paths.json"), "w") as f:
        json.dump(paths, f)

    procs = {}
    for name, n in (("w2", 2), ("w4", 4)):
        d = os.path.join(job, name)
        os.makedirs(d)
        procs[name] = (d, start_world(__file__, d, n, name, job))
    d1 = os.path.join(job, "one")
    os.makedirs(d1)
    procs["one"] = (d1, start_child(__file__, d1, "one", job))

    # ---- JAX: the pipelined text tower and MI step on the same meshes ----
    want = {}

    def loss_pp(p, mesh, m):
        pooled, logits = pipelined_textbert_apply(
            bert4, p, mesh, ids, segs, masks, num_microbatches=m,
            deterministic=True)
        return jnp.sum(pooled ** 2) + jnp.sum(logits ** 2), (pooled, logits)

    for name, (shape, m) in TEXT_CASES.items():
        mesh = jmesh.make_mesh(shape)
        if name == JAX_GRAD_CASE:
            (_, (pooled, logits)), g = jax.jit(jax.value_and_grad(
                lambda p: loss_pp(p, mesh, m), has_aux=True))(text_params)
            sd = jckpt.bert_state_dict_from_variables(
                {"params": jax.device_get(g)}, BERT4["num_hidden_layers"])
            want["grads"] = {k: np.asarray(v) for k, v in sd.items()}
        else:
            pooled, logits = jax.jit(lambda p: loss_pp(p, mesh, m)[1])(
                text_params)
        want[name] = (np.asarray(pooled), np.asarray(logits))
    mesh = jmesh.make_mesh({"data": 2, "pipe": 2})
    c = cfg.replace(pipeline_microbatches=4)
    step = make_mi_train_step(model, txs, c, mesh=mesh)
    s = jmesh.shard_mi_state(mesh, create_mi_state(model, c, txs,
                                                   jax.random.PRNGKey(0)))
    b = jmesh.shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
    s, l1 = step(s, b)
    _, l2 = step(s, b)
    want["mi_losses"] = np.array([float(l1), float(l2)])

    got = {name: finish_world(p, d, timeout=WORLD_TIMEOUT)
           for name, (d, p) in procs.items() if name != "one"}
    got["one"] = [finish_child(procs["one"][1], d1, timeout=WORLD_TIMEOUT)]
    yield want, got
    remove_job(job)


def _part(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def _max_diff(a: dict, b: dict) -> tuple:
    keys = sorted(b)
    assert sorted(a) == keys, set(a) ^ set(keys)
    worst = max(keys, key=lambda k: float(np.max(np.abs(a[k] - b[k])))
                if b[k].size else 0.0)
    return float(np.max(np.abs(a[worst] - b[worst]))), worst


def _world_of(case: str) -> str:
    return "w2" if TEXT_CASES[case][0] == {"pipe": 2} else "w4"


@pytest.mark.parametrize("case", sorted(TEXT_CASES))
def test_pp_text_forward_matches_jax(results, case):
    want, got = results
    for arrays, _ in got[_world_of(case)]:
        for i, key in enumerate(("pooled", "logits")):
            np.testing.assert_allclose(arrays[f"text32/{case}/{key}"],
                                       want[case][i], rtol=1e-5, atol=1e-6,
                                       err_msg=key)


@pytest.mark.parametrize("case", sorted(TEXT_CASES))
def test_pp_text_forward_and_grads_equal_one_rank_f64(results, case):
    _, got = results
    one = _part(got["one"][0][0], "text64/")
    assert len(one) == 2 + 16 * BERT4["num_hidden_layers"] + 9
    for arrays, _ in got[_world_of(case)]:
        diff, key = _max_diff(_part(arrays, f"text64/{case}/"), one)
        assert diff <= TOL64, (case, key, diff)


def test_pp_text_grads_match_jax(results):
    want, got = results
    for arrays, _ in got[_world_of(JAX_GRAD_CASE)]:
        mine = _part(arrays, f"text32/{JAX_GRAD_CASE}/grad/")
        assert sorted(mine) == sorted(want["grads"])
        for k, v in want["grads"].items():
            np.testing.assert_allclose(mine[k], v, rtol=2e-4, atol=1e-5,
                                       err_msg=k)


def test_pp_dropout_reruns_and_remat_give_the_same_bits(results):
    _, got = results
    for _, meta in got["w2"]:
        assert meta["dropout"] == {"rerun_equal": True, "remat_equal": True,
                                   "differs_from_rate0": True}, meta


@pytest.mark.parametrize("run", ["p2", "d2p2", "gc"])
def test_pp_mi_steps_equal_one_rank_f64(results, run):
    _, got = results
    world, ref = {"p2": ("w2", "plain"), "d2p2": ("w4", "plain"),
                  "gc": ("w2", "gc")}[run]
    one = _part(got["one"][0][0], f"mi/{ref}/")
    assert len(one) > 100
    for arrays, _ in got[world]:
        diff, key = _max_diff(_part(arrays, f"mi/{run}/"), one)
        assert diff <= TOL64, (run, key, diff)
    a, b = (_part(r[0], f"mi/{run}/") for r in got[world][:2])
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_data2_pipe2_matches_jax_pipeline(results):
    want, got = results
    for arrays, _ in got["w4"]:
        losses = arrays["jax32/losses"]
        np.testing.assert_allclose(losses[0], want["mi_losses"][0],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(losses[1], want["mi_losses"][1],
                                   rtol=5e-4, atol=5e-5)


def test_zero1_fsdp_under_pp_give_the_same_bits(results):
    _, got = results
    for arrays, _ in got["w4"]:
        a, b = _part(arrays, "mi/d2p2/"), _part(arrays, "mi/zsf/")
        assert sorted(a) == sorted(b) and len(a) > 100
        bad = [k for k in a if not np.array_equal(a[k], b[k])]
        assert not bad, bad[:5]


@pytest.mark.parametrize("world", ["w2", "w4"])
def test_resident_text_bytes_follow_the_stage_rule(results, world):
    _, got = results
    for rank, (_, meta) in enumerate(got[world]):
        for mode, rest in meta["resident"].items():
            assert rest["counted"] == rest["predicted"], (rank, mode, rest)
            # a stage holds 1/S of the layers, not S full copies
            assert rest["layers_held"] == rest["layers_total"] // rest[
                "stages"], (rank, mode, rest)
            assert rest["other_layers_empty"], (rank, mode, rest)


def test_freeze_text_encoder_keeps_the_stages_layers(results):
    _, got = results
    for _, meta in got["w2"]:
        assert meta["freeze"] == {"loss_finite": True, "layers_equal": True,
                                  "image_changed": True}, meta["freeze"]


@pytest.mark.parametrize("direction", ["pp_to_one", "one_to_pp"])
def test_resume_across_pp_and_one_rank(results, direction):
    """The checkpoint of a pipelined state is the plain layout, and each
    side resumes from the other's: the second step within 1e-10."""
    _, got = results
    if direction == "pp_to_one":
        arrays, meta = got["one"][0]
        mine = _part(arrays, "resume/pp_to_one/")
        ref = _part(got["w2"][0][0], "mi/p2/")
    else:
        arrays, meta = got["w2"][0]
        mine = _part(arrays, "resume/one_to_pp/")
        ref = _part(got["one"][0][0], "mi/plain/")
    assert meta["resume"][direction]["plain_layout"], meta["resume"]
    assert meta["resume"][direction]["step"] == 2
    diff, key = _max_diff(mine, ref)
    assert diff <= TOL64, (key, diff)


def test_manager_cli_trains_and_resumes_on_data2_pipe2(results):
    _, got = results
    for rank, (_, meta) in enumerate(got["w4"]):
        cli = meta["cli"]
        assert cli["steps"] == {"A": 4, "C": 4}, cli
        assert cli["microbatches"] == 2 and cli["stages"] == 2, cli
        assert cli["c_equals_a"] == [], cli["c_equals_a"][:5]
        if rank == 0:
            assert cli["ckpt_differs"] == [] and cli["ckpt_entries"] > 100
            assert cli["plain_layout"], cli
            assert cli["bins_strict"] == ["pytorch_MI_image_model.bin",
                                          "pytorch_MI_text_model.bin",
                                          "pytorch_model_epoch2.bin"]


@pytest.mark.parametrize("what", ["ae", "classifier"])
def test_data2_pipe2_replicas_equal_the_data2_world(results, what):
    _, got = results
    ref = _part(got["w2"][0][0], f"{what}/")
    assert len(ref) > 3
    for arrays, _ in got["w4"]:
        mine = _part(arrays, f"{what}/")
        assert sorted(mine) == sorted(ref)
        bad = [k for k in ref if not np.array_equal(mine[k], ref[k])]
        assert not bad, bad[:5]


@pytest.mark.parametrize("what", ["layers", "microbatches", "model_and_pipe"])
def test_pp_refusals_are_value_errors(results, what):
    err = results[1]["one"][0][1]["errors"][what]
    assert err.startswith("ValueError"), err
    want = {"layers": "not divisible by pipeline stages",
            "microbatches": "not divisible by microbatches",
            "model_and_pipe": "'model' 2 and 'pipe' 2"}[what]
    assert want in err, err


# ---- the port side ----------------------------------------------------------

def _error_of(fn) -> str:
    try:
        fn()
    except Exception as e:   # noqa: BLE001 - the message is the result
        return f"{type(e).__name__}: {e}"
    return "no error"


def _flat(tree, prefix):
    """mi_state_tree's tensors as {'<prefix>a/b': float64 array}, copies
    (the live parameters are updated in place)."""
    import torch

    out = {}

    def walk(node, key):
        if torch.is_tensor(node):
            if not key.endswith("num_batches_tracked"):
                out[prefix + key] = np.array(node.detach().double().cpu())
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{key}/{k}" if key else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{key}/{i}" if key else str(i))
    walk(tree, "")
    return out


def _wait_for(path: str) -> None:
    deadline = time.monotonic() + WAIT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {WAIT_S} s")
        time.sleep(0.2)


def _text_pass(torch, tree, mesh, m, dtype, dropout=False, remat=False,
               key=0):
    """The text tower (BERT4 from JAX's weights) on ``mesh`` at M = ``m``
    (one rank's plain forward with ``mesh`` None): pooled, logits (all
    rows) and the whole gradients of sum(pooled²) + sum(logits²)."""
    from mimm_tpu_torch import checkpoint as ckpt
    from mimm_tpu_torch.models.bert import BertConfig, TextBert
    from mimm_tpu_torch.parallel import mesh as mesh_lib
    from mimm_tpu_torch.parallel.pipeline import pipelined_textbert_apply

    rates = {} if dropout else dict(hidden_dropout_prob=0.0,
                                    attention_probs_dropout_prob=0.0)
    cfg = BertConfig(**dict(BERT4, remat=remat, **rates))
    tm = TextBert(cfg, dtype=dtype).to(dtype)
    sd = ckpt.bert_state_dict_from_flax({"params": tree["text"]},
                                        BERT4["num_hidden_layers"])
    tm.load_state_dict(sd, strict=True)
    ids, masks, segs = (torch.from_numpy(a) for a in _text_inputs())
    params = dict(tm.named_parameters())
    if mesh is None:
        gen = torch.Generator().manual_seed(key)
        pooled, logits = tm(ids, segs, masks, deterministic=not dropout,
                            generator=gen)
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(
            (pooled ** 2).sum() + (logits ** 2).sum(),
            [params[n] for n in names], allow_unused=True)))
        grads = {n: g if g is not None else torch.zeros_like(params[n])
                 for n, g in grads.items()}
        return pooled, logits, grads
    layout = mesh_lib.GroupLayout(
        pipe=mesh_lib.pipe_shardings(mesh, params),
        shapes={n: tuple(p.shape) for n, p in params.items()})
    mesh_lib.place_group(params, None, layout, mesh)
    rows = mesh_lib.local_rows(mesh, B)
    pooled, logits, run = pipelined_textbert_apply(
        tm, mesh, ids[rows], segs[rows], masks[rows], num_microbatches=m,
        deterministic=not dropout, key=key)
    names = list(params)
    got = torch.autograd.grad((pooled ** 2).sum() + (logits ** 2).sum(),
                              [params[n] for n in names] + [run.cls],
                              allow_unused=True)
    grads = {n: g if g is not None else torch.zeros_like(params[n])
             for n, g in zip(names, got)}
    grads.update(run.backward(got[-1]))
    # who sums what (parallel/mesh.py): 'data' sums every share, stage 0's
    # embeddings go to its pipe line
    mesh_lib.all_reduce_(grads.values(), mesh)
    mesh_lib.broadcast_([g for n, g in grads.items()
                         if n.startswith("bert.embeddings.")], mesh, src=0,
                        axis=mesh_lib.PIPE_AXIS)
    grads = mesh_lib.gather_stages(grads, layout.pipe, layout.shapes, mesh)
    return (mesh_lib.gather_rows(pooled.detach(), mesh),
            mesh_lib.gather_rows(logits.detach(), mesh), grads)


def _text_out(prefix, pooled, logits, grads):
    out = {f"{prefix}pooled": pooled.detach().double().numpy(),
           f"{prefix}logits": logits.detach().double().numpy()}
    out.update({f"{prefix}grad/{n}": g.detach().double().numpy()
                for n, g in grads.items()})
    return out


def _resident(state, mesh) -> dict:
    """This rank's bytes of text parameters and moments, counted and by
    the stage rule (its stage's layers and the replicated rest, whole)."""
    from mimm_tpu_torch.parallel import mesh as mesh_lib

    layout = state.layout.groups["text_model"]
    params = dict(state.model.text_model.named_parameters())
    opt = state.txt_opt
    counted = sum(p.numel() * p.element_size() for p in params.values())
    counted += sum(t.numel() * t.element_size()
                   for part in (opt.mu, opt.nu) for t in part.values())
    predicted = 0
    for n, p in params.items():
        stage = layout.pipe[n]
        numel = int(np.prod(layout.shapes[n])) \
            if stage in (None, mesh.pipe_rank) else 0
        predicted += numel * (p.element_size()
                              + opt.mu[n].element_size()
                              + opt.nu[n].element_size())
    layers = {n.split(".")[3] for n in params if ".layer." in n}
    held = {n.split(".")[3] for n, p in params.items()
            if ".layer." in n and p.numel()}
    return {"counted": counted, "predicted": predicted,
            "layers_held": len(held), "layers_total": len(layers),
            "stages": mesh_lib.pipe_size(mesh),
            "other_layers_empty": all(
                p.numel() == 0 for n, p in params.items()
                if layout.pipe[n] not in (None, mesh.pipe_rank))}


def _child(job, mode, root):
    import torch

    from mimm_tpu_torch import checkpoint as ckpt
    from mimm_tpu_torch.config import TrainingConfig
    from mimm_tpu_torch.models.bert import BertConfig
    from mimm_tpu_torch.models.joint import ImageReportModel
    from mimm_tpu_torch.parallel import mesh as mesh_lib
    from mimm_tpu_torch.parallel.pipeline import pipelined_textbert_apply
    from mimm_tpu_torch.train import mi
    from tests.torch_port_child import unflatten_tree

    torch.backends.mkldnn.enabled = False
    mesh_lib.initialize_distributed(device="cpu")
    out, meta = {}, {}
    with np.load(os.path.join(root, "in.npz")) as z:
        tree = unflatten_tree({k: z[k] for k in z.files})
    batch_np = {k: torch.from_numpy(v) for k, v in tree["batch"].items()}
    rank = mesh_lib.world_rank()

    def mi_setup(mesh, f64=True, weights=None, restore=None, **knobs):
        c = TrainingConfig().replace(**CFG, **knobs)
        bert = BertConfig(**MI_BERT)
        txs = mi.make_optimizers(c, steps_per_epoch=2)
        dt = torch.float64 if f64 else torch.float32
        model = ImageReportModel(bert, output_channels=1, dtype=dt).to(dt)
        if restore is not None:
            state = mi.restore_mi_state(model, c, txs, restore)
        else:
            state = mi.create_mi_state(model, c, txs,
                                       torch.Generator().manual_seed(0),
                                       weights=weights)
        state = mesh_lib.shard_mi_state(
            mesh, state, zero1=c.zero1_optimizer_sharding,
            fsdp=c.fsdp_parameter_sharding)
        return c, model, txs, state

    def mi_batch(mesh, f64=True):
        b = {k: v.double() if f64 and k == "image" else v
             for k, v in batch_np.items()}
        return mesh_lib.shard_batch(mesh, b)

    def mi_run(name, mesh, steps=2, f64=True, save_after=None, **kw):
        """``steps`` MI steps; the losses and the gathered state under
        ``name/``; ``save_after``: (step, path) of a resume checkpoint."""
        c, model, txs, state = mi_setup(mesh, f64=f64, **kw)
        step = mi.make_mi_train_step(model, txs, c, mesh=mesh)
        losses = []
        for s in range(steps):
            state, loss = step(state, mi_batch(mesh, f64))
            losses.append(loss.item())
            if save_after is not None and state.step == save_after[0]:
                ckpt.save_checkpoint(save_after[1], mi.mi_state_tree(state))
                if rank == 0:
                    open(save_after[1] + ".done", "w").close()
        out[f"{name}/losses"] = np.array(losses)
        if f64:
            out.update(_flat(mi.mi_state_tree(state), f"mi/{name}/"))
        return state, model

    def resume(name, mesh, path, direction, **knobs):
        """One step from the checkpoint at ``path`` (``mi_state_tree``'s
        plain tree) on ``mesh``: the state under ``resume/<direction>/``."""
        _wait_for(path + ".done")
        saved = ckpt.load_checkpoint(path)
        text = saved["text_model"]
        layers = {k.split(".")[3] for k in text if ".layer." in k}
        plain = len(layers) == MI_BERT["num_hidden_layers"] and all(
            t.numel() > 0 for t in text.values())
        c, model, txs, state = mi_setup(mesh, restore=saved, **knobs)
        state, _ = mi.make_mi_train_step(model, txs, c, mesh=mesh)(
            state, mi_batch(mesh))
        out.update(_flat(mi.mi_state_tree(state), f"resume/{direction}/"))
        meta.setdefault("resume", {})[direction] = {
            "plain_layout": plain, "step": state.step}

    one_ckpt = os.path.join(root, "one_step1.ckpt")
    pp_ckpt = os.path.join(root, "pp_step1.ckpt")
    if mode == "one":
        mi_run("plain", None, save_after=(1, one_ckpt))
        mi_run("gc", None, grad_cache_chunks=2)
        out.update(_text_out("text64/", *_text_pass(torch, tree, None, 0,
                                                    torch.float64)))
        bert4 = BertConfig(**BERT4)
        from mimm_tpu_torch.models.bert import TextBert
        tm = TextBert(bert4)
        ids, masks, segs = (torch.from_numpy(a) for a in _text_inputs())
        meta["errors"] = {
            "layers": _error_of(lambda: pipelined_textbert_apply(
                tm, mesh_lib.Mesh(pipe=8, axis_names=("pipe",)), ids, segs,
                masks, deterministic=True)),
            "microbatches": _error_of(lambda: pipelined_textbert_apply(
                tm, mesh_lib.Mesh(pipe=4, axis_names=("pipe",)), ids, segs,
                masks, num_microbatches=3, deterministic=True)),
            "model_and_pipe": _error_of(lambda: mesh_lib.make_mesh(
                {"model": 2, "pipe": 2}))}
        resume("pp_to_one", None, pp_ckpt, "pp_to_one")
    elif mode == "w2":
        mesh = mesh_lib.make_mesh({"pipe": 2})
        state, _ = mi_run("p2", mesh, pipeline_microbatches=2,
                          save_after=(1, pp_ckpt))
        meta["resident"] = {"p2": _resident(state, mesh)}
        del state
        mi_run("gc", mesh, grad_cache_chunks=2)
        for case in ("p2m2", "p2m4"):
            m = TEXT_CASES[case][1]
            out.update(_text_out(f"text64/{case}/", *_text_pass(
                torch, tree, mesh, m, torch.float64)))
            out.update(_text_out(f"text32/{case}/", *_text_pass(
                torch, tree, mesh, m, torch.float32)))
        # dropout 0.1: a rerun, and remat, give the same bits
        runs = [_text_pass(torch, tree, mesh, 4, torch.float64, dropout=True,
                           remat=r, key=7) for r in (False, False, True)]
        same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a[:2], b[:2])) \
            and all(torch.equal(a[2][n], b[2][n]) for n in a[2])
        rate0 = _text_pass(torch, tree, mesh, 4, torch.float64)
        meta["dropout"] = {"rerun_equal": same(runs[0], runs[1]),
                           "remat_equal": same(runs[0], runs[2]),
                           "differs_from_rate0": not same(runs[0], rate0)}
        # freeze_text_encoder: the stages' layers stay, the image trains
        c, model, txs, state = mi_setup(mesh, freeze_text_encoder=True)
        before = _flat(mi.mi_state_tree(state), "")      # copies
        state, loss = mi.make_mi_train_step(model, txs, c, mesh=mesh)(
            state, mi_batch(mesh))
        after = _flat(mi.mi_state_tree(state), "")
        layers = [k for k in after if k.startswith("text_model/")
                  and ".layer." in k]
        meta["freeze"] = {
            "loss_finite": bool(np.isfinite(loss.item())),
            "layers_equal": len(layers) == 32 and all(
                np.array_equal(before[k], after[k]) for k in layers),
            "image_changed": not np.array_equal(
                before["image_model/conv1.weight"],
                after["image_model/conv1.weight"])}
        resume("one_to_pp", mesh, one_ckpt, "one_to_pp",
               pipeline_microbatches=2)
        _replicas(torch, mesh_lib.make_mesh({"data": 2}), out)
    else:   # w4
        mesh = mesh_lib.make_mesh({"pipe": 4})
        for dt, tag in ((torch.float64, "text64"), (torch.float32, "text32")):
            out.update(_text_out(f"{tag}/p4m4/", *_text_pass(
                torch, tree, mesh, 4, dt)))
        mesh = mesh_lib.make_mesh({"data": 2, "pipe": 2})
        for dt, tag in ((torch.float64, "text64"), (torch.float32, "text32")):
            out.update(_text_out(f"{tag}/d2p2m4/", *_text_pass(
                torch, tree, mesh, 4, dt)))
        state, _ = mi_run("d2p2", mesh, pipeline_microbatches=4)
        meta["resident"] = {"d2p2": _resident(state, mesh)}
        state, _ = mi_run("zsf", mesh, pipeline_microbatches=4,
                          zero1_optimizer_sharding=True,
                          fsdp_parameter_sharding=True)
        meta["resident"]["zsf"] = _resident(state, mesh)
        del state
        init = tree["init"]
        weights = ckpt.mi_weights_from_flax(
            init["params"], init["batch_stats"],
            [init["critic"][str(i)] for i in range(len(init["critic"]))],
            MI_BERT["num_hidden_layers"])
        mi_run("j32", mesh, f64=False, weights=weights,
               pipeline_microbatches=4)
        out["jax32/losses"] = out["j32/losses"]
        _replicas(torch, mesh, out)
        meta["cli"] = _cli(torch, mesh, root)
    suffix = f"-rank{rank}" if os.environ.get("MIMM_NUM_PROCESSES") else ""
    np.savez(os.path.join(job, f"out{suffix}.npz"), **out)
    with open(os.path.join(job, f"out{suffix}.json"), "w") as f:
        json.dump(meta, f)


def _replicas(torch, mesh, out):
    """Two float64 steps of a small AE, and the classifier's embedding
    pass (the full-width image encoder) and one MLP step in float32, on
    ``mesh``."""
    from mimm_tpu_torch.config import DEFAULT_CLASSIFIER_LAYERS, \
        TrainingConfig
    from mimm_tpu_torch.models.autoencoder import ResNetAE
    from mimm_tpu_torch.models.mlp import BasicMLP
    from mimm_tpu_torch.models.resnet import ResNet256_6_2_1
    from mimm_tpu_torch.parallel import mesh as mesh_lib
    from mimm_tpu_torch.train import ae, classifier
    from mimm_tpu_torch.train.optim import adam_torch

    torch.manual_seed(0)
    model = ResNetAE(input_shape=(64, 64, 1), dtype=torch.float64,
                     **AE_SMALL).double()
    c = TrainingConfig().replace(init_lr=1e-3, batch_size=4)
    state = mesh_lib.shard_ae_state(mesh, ae.create_ae_state(
        model, c, torch.Generator().manual_seed(0)))
    step = ae.make_ae_train_step(model, ae._ae_tx(c), mesh=mesh)
    for s in range(2):
        imgs = torch.from_numpy(np.random.default_rng(20 + s).random(
            (4, 64, 64, 1)))
        state, loss = step(state, imgs[mesh_lib.local_rows(mesh, 4)])
        out[f"ae/loss{s}"] = loss.numpy()
    out.update(_flat(ae.ae_state_tree(state), "ae/"))
    torch.manual_seed(1)
    embed = classifier.make_embedding_fn("multimodal", ResNet256_6_2_1(),
                                         mesh=mesh)
    images = torch.from_numpy(np.random.default_rng(30).integers(
        0, 255, (4, IMG, IMG, 1)).astype(np.uint8))
    emb = embed(images)
    mlp = BasicMLP(emb.shape[1], DEFAULT_CLASSIFIER_LAYERS)
    tx = adam_torch(1e-3)
    st = classifier.create_classifier_state(
        mlp, tx, torch.Generator().manual_seed(2))
    st, loss = classifier.make_classifier_step(mlp, tx, seed=3)(
        st, emb, torch.tensor([0.0, 1.0, 1.0, 0.0]))
    out["classifier/emb"] = emb.numpy()
    out["classifier/loss"] = loss.numpy()
    out.update({f"classifier/{n}": p.detach().numpy()
                for n, p in mlp.named_parameters()})


def _cli(torch, mesh, root) -> dict:
    """``cli.multi_modal --mesh_shape data=2,pipe=2
    --pipeline_microbatches 2`` in this world: run A 2 epochs from disk,
    run C resumed from A's first checkpoint; the converter on rank 0."""
    from mimm_tpu_torch import checkpoint as ckpt
    from mimm_tpu_torch.cli import multi_modal
    from mimm_tpu_torch.models.bert import BertConfig, TextBert
    from mimm_tpu_torch.models.resnet import ResNet256_6_2_1
    from mimm_tpu_torch.parallel import mesh as mesh_lib
    from mimm_tpu_torch.tools import convert_checkpoint
    from mimm_tpu_torch.train import mi

    with open(os.path.join(root, "paths.json")) as f:
        paths = json.load(f)
    flags = ["--preset", "production", "--device", "cpu",
             "--compute_dtype", "float32", "--batch_size", "4",
             "--img_size", "256", "--max_seq_length", "16",
             "--num_train_epochs", "2", "--scan_steps", "1",
             "--mesh_shape", "data=2,pipe=2", "--pipeline_microbatches", "2",
             "--data_loader_workers", "1", "--prefetch", "1",
             "--image_dir", paths["images"], "--text_data_dir", paths["text"],
             "--dataset_metadata", paths["metadata"],
             "--bert_pretrained_dir", paths["bert"],
             "--decoded_crop_cache", os.path.join(root, "cache")]
    save_a, save_c = (os.path.join(root, f"cli_{r}") for r in "ac")
    seen = {}
    real = mi.make_mi_step_body

    def observed(model, txs, cfg, data_shards=1, mesh=None):
        seen["microbatches"] = int(cfg.pipeline_microbatches)
        seen["stages"] = mesh_lib.pipe_size(mesh)
        return real(model, txs, cfg, data_shards=data_shards, mesh=mesh)

    mi.make_mi_step_body = observed
    _, state_a = multi_modal.main(flags + ["--save_directory", save_a])
    tree_a = _flat(mi.mi_state_tree(state_a), "")
    _, state_c = multi_modal.main(flags + [
        "--save_directory", save_c, "--resume_from",
        os.path.join(save_a, "mi_epoch1.ckpt")])
    tree_c = _flat(mi.mi_state_tree(state_c), "")
    mi.make_mi_step_body = real
    info = {"steps": {"A": state_a.step, "C": state_c.step},
            "c_equals_a": [k for k in tree_a
                           if not np.array_equal(tree_a[k], tree_c[k])],
            **seen}
    if mesh_lib.world_rank() == 0:
        last = os.path.join(save_a, "mi_epoch2.ckpt")
        saved = _flat(ckpt.load_checkpoint(last), "")
        info["ckpt_entries"] = len(saved)
        info["ckpt_differs"] = sorted(
            set(saved) ^ set(tree_a)) + [k for k in tree_a if k in saved
                                         and not np.array_equal(saved[k],
                                                                tree_a[k])]
        info["plain_layout"] = all(
            f"text_model/bert.encoder.layer.{i}.output.dense.weight" in saved
            and saved[f"text_model/bert.encoder.layer.{i}.output.dense."
                      "weight"].shape == (32, 64)
            for i in range(CLI_BERT["num_hidden_layers"]))
        bins = os.path.join(root, "bins")
        written = convert_checkpoint.main(["--kind", "mi", "--ckpt", last,
                                           "--out", bins])
        TextBert(BertConfig(**CLI_BERT)).load_state_dict(
            ckpt.load_state_dict_bin(os.path.join(
                bins, "pytorch_MI_text_model.bin")), strict=True)
        ResNet256_6_2_1().load_state_dict(ckpt.load_state_dict_bin(
            os.path.join(bins, "pytorch_MI_image_model.bin")), strict=True)
        info["bins_strict"] = sorted(os.path.basename(p) for p in written)
    mesh_lib.barrier(mesh)
    return info


if __name__ == "__main__":
    args = [a for a in sys.argv[2:] if a != "--rank"]
    if os.environ.get("MIMM_NUM_PROCESSES"):
        args = args[1:]         # the rank's number
    _child(sys.argv[1], args[0], args[1])
