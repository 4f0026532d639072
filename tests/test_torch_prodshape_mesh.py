"""The port's production-shape mesh gate (tests/test_prodshape_mesh.py
counterpart): JAX's three parallel lanes, each as a gloo CPU world of 8
jax-free ranks bootstrapped through ``MIMM_COORDINATOR_ADDRESS`` /
``MIMM_NUM_PROCESSES`` / ``MIMM_PROCESS_ID`` (parallel/mesh.py
``initialize_distributed``).  One world runs every lane in turn, one MI
train step each:

1. ``{'data': 4, 'model': 2}`` with sequence parallelism;
2. ``{'data': 4, 'pipe': 2}`` with ZeRO-1, one microbatch a stage
   (``pipeline_microbatches=0``), the text layers stage-resident;
3. ``{'data': 8}`` with ZeRO-1 + FSDP, then pure data parallelism with the
   bfloat16 gradient all-reduce from a fresh replicated state.

JAX's gate asserts a finite loss.  This one also holds every lane against
the port's one-rank step at the same global batch and the same initial
weights, JAX's ``create_mi_state(PRNGKey(0))`` (one reference process for
all lanes: the lanes change placement, not math): every rank's loss is the
same and finite, and each rank's resting pieces of every parameter, Adam
moment and BatchNorm statistic after the step are held against the same
pieces of the one-rank state (``parallel.mesh.place_group`` cuts the
reference as the lane's layout cuts the state, so no rank gathers the
whole state).  The moments are the step's record of the gradient: Adam's
first step moves a parameter by lr·g/(|g| + eps), within ±lr whatever g
is, and the text tower's learning rate is 0 at warm-up step 0, so the
parameters after one step only catch a sign flip.  The moments are held
against the one-rank step in float64, and that step against JAX's
unsharded ``make_mi_train_step`` in float64, which holds every lane to
JAX.  A control shows what the moment bounds separate: the one-rank step
on a ``'data': 8`` rank's 2 rows alone, the gradient a lane would keep
without its all-reduce.  BERT's dropout is 0, where JAX's gate keeps 0.1:
a world draws its masks per data index, one rank per step, so only
dropout 0 compares.

Cases:
* ``narrow`` (tier-1), float64: B=16, L=16, the full ResNet at 256 px, a
  2-layer BERT of width 32, 2 heads, intermediate 64; every lane within
  1e-10 of one rank (tests/test_torch_tensor_parallel.py,
  test_torch_pipeline.py, test_torch_zero.py), the bfloat16 all-reduce
  lane's loss and BatchNorm statistics within 1e-10 and its moments
  within ``REL_BF16`` (bfloat16 rounding).
* ``bert_base`` (JAX's case), float32: B=16, L=128, BERT-base; the loss and
  the BatchNorm statistics within 1e-5 of the float32 one-rank step, the
  moments within ``REL32`` of the float64 one (``REL_BF16`` in the
  bfloat16 lane); each rank's peak RSS is printed, and their sum.  JAX's
  step runs beside the one-rank references, the world after both (their
  memory does not add up).  Opt-in: ``MIMM_RUN_TORCH_PRODSHAPE_MESH=1``.

In both cases the float64 one-rank step equals JAX's float64 step: the
loss to rtol 1e-5 / atol 1e-6, parameters and statistics to atol 1e-9
(tests/test_torch_train.py's bounds), the moments to ``JAX64_REL``.
Every moment bound is max |Δ| over a group / max |reference| of the group.
"""

import json
import os
import sys

import numpy as np
import pytest

GATE_VAR = "MIMM_RUN_TORCH_PRODSHAPE_MESH"
B, IMG, WORLD = 16, 256, 8
NARROW_BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                   num_attention_heads=2, intermediate_size=64,
                   max_position_embeddings=32)
CASES = {
    "narrow": dict(seq=16, f64=True, bert=NARROW_BERT, timeout=600),
    "bert_base": dict(seq=128, f64=False, bert={}, timeout=3600),
}
# lane -> (mesh shape, knobs)
LANES = {
    "dp4_tp2_sp": ({"data": 4, "model": 2}, dict(sequence_parallel=True)),
    "dp4_pp2_zero1": ({"data": 4, "pipe": 2}, dict(
        zero1_optimizer_sharding=True, pipeline_microbatches=0)),
    "dp8_zero1_fsdp": ({"data": 8}, dict(zero1_optimizer_sharding=True,
                                         fsdp_parameter_sharding=True)),
    "dp8_bf16_allreduce": ({"data": 8}, dict(grad_allreduce_dtype="bfloat16")),
}
BF16_LANE = "dp8_bf16_allreduce"
TOL64 = 1e-10
GROUPS = ("image_model", "text_model", "critic")
MOMENTS = ("mu", "nu")
# each group's moments against the float64 one-rank step, max |Δ| /
# max |reference|.  Float32 (bert_base): at JAX's init this loss has ReLU
# inputs within float32 rounding of 0, so a float32 step moves a group's
# moments by steps where a kink flips, not by rounding: the float64 step
# from weights moved by up to 2^-24 of themselves steps by 1.9e-3 in the
# image tower (6e-6 elsewhere; the narrow case's by up to 1.1e-2), and the
# float32 steps read up to 7.3e-3 (image tower; 1.6e-6 to 2.7e-3 in the
# other groups).
# REL32 is the geometric middle of those and the control's least reading,
# 3.3 (image mu; the narrow case's 4.7): 20x from each.  The bfloat16
# all-reduce lane (both cases): its gradient shares are rounded to 8 bits
# and summed in bfloat16 (the narrow case reads mu 1.02e-2, nu 1.30e-2 at
# most; g² doubles a relative error).
REL32 = {"mu": 0.15, "nu": 0.15}
REL_BF16 = {"mu": 2e-2, "nu": 4e-2}
# the float64 one-rank step against JAX's (2.0e-13 at most in both cases)
JAX64_REL = 1e-10
PERTURB = 2.0 ** -24    # float32's unit roundoff
PERTURB_SEEDS = (1, 2, 3)
CONTROL_ROWS = B // 8   # a 'data': 8 rank's rows
WAIT_S = 3000           # a rank waiting for the one-rank reference


def skip_reason(case: str):
    """Why ``case`` does not run here, or None: the full-width case runs
    only with the gate's variable set."""
    if case == "narrow" or os.environ.get(GATE_VAR) == "1":
        return None
    return (f"set {GATE_VAR}=1 (BERT-base float32 on 8 gloo ranks: "
            f"~50 GB of host RAM)")


def _cfg_kw(case: dict) -> dict:
    """JAX's gate's ``_cfg`` (test_prodshape_mesh.py:55-60)."""
    return dict(batch_size=B, img_size=IMG, max_seq_length=case["seq"],
                compute_dtype="float32", num_train_epochs=1,
                use_pallas_critic=False, flash_attention=False, seed=0)


def _bert_kw(case: dict) -> dict:
    return dict(num_classes=1, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0, flash_attention=False,
                **case["bert"])


def global_batch(seq: int, vocab: int) -> dict:
    """JAX's gate's ``_batch`` (test_prodshape_mesh.py:41-52)."""
    rng = np.random.default_rng(0)
    return {
        "image": rng.random((B, IMG, IMG, 1)).astype(np.float32),
        "txt_ids": rng.integers(0, vocab, (B, seq)).astype(np.int32),
        "txt_masks": np.ones((B, seq), np.int32),
        "txt_segments": np.zeros((B, seq), np.int32),
        "study_id": np.arange(B, dtype=np.int64),
    }


def _adam_moments(opt_state):
    """(mu, nu) of an optax state: the first node that holds both."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state.mu, opt_state.nu
    for inner in opt_state if isinstance(opt_state, tuple) else ():
        found = _adam_moments(inner)
        if found is not None:
            return found
    return None


def _jax_moments(state, num_layers: int) -> dict:
    """JAX's Adam moments keyed as the port's reference files
    (``<group>.mu.<name>``, ``<group>.nu.<name>``), through the same
    exporters as the parameters (transposes only)."""
    import jax

    from mimm_tpu import checkpoint as ckpt

    bstats = jax.device_get(state.batch_stats)["image_model"]
    out = {}
    for i, kind in enumerate(MOMENTS):
        img, txt, critic = (jax.device_get(_adam_moments(s)[i]) for s in (
            state.img_opt, state.txt_opt, state.mi_opt))
        sds = {"image_model": ckpt.resnet_state_dict_from_variables(
            {"params": img, "batch_stats": bstats}),
            "text_model": ckpt.bert_state_dict_from_variables(
                {"params": txt}, num_layers)}
        for tower, sd in sds.items():
            out.update({f"{tower}.{kind}.{k}": np.asarray(v)
                        for k, v in sd.items() if "running" not in k
                        and not k.endswith("num_batches_tracked")})
        for j, layer in enumerate(critic):
            for k in ("w", "b"):
                out[f"critic.{kind}.{j}.{k}"] = np.asarray(layer[k])
    return out


def _jax_step(case: dict, job: str, started) -> dict:
    """JAX's unsharded step in float64 from ``create_mi_state(PRNGKey(0))``,
    whose float32 values go to the port as ``init.npz`` (``started()`` is
    called once it is written): the loss and the state after it, keyed as
    the port's reference files, the Adam moments included."""
    import jax
    import jax.numpy as jnp

    from mimm_tpu.config import TrainingConfig
    from mimm_tpu.models.bert import BertConfig
    from mimm_tpu.models.joint import ImageReportModel
    from mimm_tpu.train.mi import (MITrainState, create_mi_state,
                                   make_mi_train_step, make_optimizers)
    from tests.test_torch_train import _flat_state, _torch_keyed

    cfg = TrainingConfig().replace(**_cfg_kw(case))
    bert = BertConfig(**_bert_kw(case))
    with jax.enable_x64(True):
        model = ImageReportModel(bert_config=bert, output_channels=1,
                                 dtype=jnp.float64)
        txs = make_optimizers(cfg, steps_per_epoch=2)
        state = create_mi_state(model, cfg, txs, jax.random.PRNGKey(0))
        init = jax.device_get(state)
        del state
        np.savez(os.path.join(job, "init.npz"), **_flat_state(
            init.params, init.batch_stats, init.critic_params, ""))
        started()
        up = lambda t: jax.tree.map(      # noqa: E731
            lambda x: x.astype(jnp.float64)
            if hasattr(x, "dtype") and x.dtype == jnp.float32 else x, t)
        params, bstats, critic = (up(x) for x in (
            init.params, init.batch_stats, init.critic_params))
        state = MITrainState(
            params=params, batch_stats=bstats, critic_params=critic,
            img_opt=txs.img.init(params["image_model"]),
            mi_opt=txs.mi.init(critic),
            txt_opt=txs.txt.init(params["text_model"]), step=init.step)
        del init, params, bstats, critic
        batch = {k: jnp.asarray(v) for k, v in
                 global_batch(case["seq"], bert.vocab_size).items()}
        state, loss = make_mi_train_step(model, txs, cfg)(state, batch)
        want = _torch_keyed(state, "", num_layers=bert.num_hidden_layers)
        want.update(_jax_moments(state, bert.num_hidden_layers))
        want["loss"] = np.asarray(float(loss))
    return want


@pytest.fixture(scope="module", params=sorted(CASES))
def results(request, tmp_path_factory):
    reason = skip_reason(request.param)
    if reason:
        pytest.skip(reason)
    from tests.torch_port_child import (finish_child, finish_world, remove_job,
                                        start_child, start_world)

    case = CASES[request.param]
    job = str(tmp_path_factory.mktemp(f"prodshape_mesh_{request.param}"))
    with open(os.path.join(job, "spec.json"), "w") as f:
        json.dump({"case": request.param}, f)
    procs = []

    def start():
        procs.append(start_child(__file__, job, "ref"))
        if case["f64"]:     # small: the world beside the reference
            procs.extend(start_world(__file__, job, WORLD, "world"))

    try:
        want = _jax_step(case, job, start)
        finish_child(procs[0], job, timeout=case["timeout"])
        if not case["f64"]:     # BERT-base: its memory after JAX's and ref's
            procs.extend(start_world(__file__, job, WORLD, "world"))
        ranks = finish_world(procs[1:], job, timeout=case["timeout"])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ref_dir, f64_dir = _ref_dirs(case, job)
    with open(os.path.join(ref_dir, "ref.json")) as f:
        one = json.load(f)
    with open(os.path.join(ref_dir, "readings.json")) as f:
        readings = json.load(f)
    metas = [meta for _, meta in ranks]
    peaks = [m["peak_rss_mb"] for m in metas]
    print(json.dumps({"case": request.param, "peak_rss_mb": peaks,
                      "peak_rss_mb_sum": sum(peaks),
                      "worker_peak_rss_mb": _peak_rss_mb(),
                      "one_rank_seconds": one["seconds"],
                      "lane_seconds": {lane: max(m[lane]["seconds"]
                                                 for m in metas)
                                       for lane in LANES},
                      "readings": readings}))
    yield request.param, want, one, readings, metas, f64_dir
    remove_job(job)


def _rel(gaps: list, group: str, kind: str) -> float:
    """max |Δ| of ``group``'s ``kind`` over the ranks / max |reference|."""
    ref = max(g[f"{group}/{kind}_ref"] for g in gaps)
    assert ref > 0, (group, kind, "the reference moments are all 0")
    return max(g[f"{group}/{kind}"] for g in gaps) / ref


@pytest.mark.parametrize("lane", sorted(LANES))
def test_every_rank_reports_the_same_finite_loss(results, lane):
    metas = results[4]
    losses = [m[lane]["loss"] for m in metas]
    assert len(losses) == WORLD and len(set(losses)) == 1, losses
    assert np.isfinite(losses[0])


@pytest.mark.parametrize("lane", sorted(LANES))
def test_lane_equals_one_rank(results, lane):
    case, _, one, _, metas, _ = results
    f64 = CASES[case]["f64"]
    gaps = [m[lane]["gaps"] for m in metas]
    loss_gap = abs(metas[0][lane]["loss"] - one["loss"])
    rel = {f"{group}/{kind}": _rel(gaps, group, kind)
           for group in GROUPS for kind in MOMENTS}
    print(json.dumps({"case": case, "lane": lane, "loss_gap": loss_gap,
                      "gaps": {key: max(g[key] for g in gaps)
                               for key in gaps[0]
                               if not key.endswith(("_key", "_ref"))},
                      "moments_rel": rel}))
    assert loss_gap <= (TOL64 if f64 else 1e-5), loss_gap
    for rank, g in enumerate(gaps):
        assert g["bn"] <= (TOL64 if f64 else 1e-5), (rank, g["bn_key"])
        for group in GROUPS:
            # float32 or a rounded gradient: a check of the step's sign
            # (Adam's first step is within ±lr whatever the gradient)
            lr = one["lr"][group]
            if lane == BF16_LANE:
                bound = 5 * lr
            else:
                bound = TOL64 if f64 else 2.5 * lr
            assert g[f"{group}/param"] <= bound, (
                rank, group, g[f"{group}/param"], g[f"{group}/param_key"])
            if f64 and lane != BF16_LANE:
                for kind in MOMENTS:
                    assert g[f"{group}/{kind}"] <= TOL64, (
                        rank, group, kind, g[f"{group}/{kind}_key"])
            assert g[f"{group}/count"] == one["count"][group]
    if f64 and lane != BF16_LANE:
        return
    limits = REL_BF16 if lane == BF16_LANE else REL32
    for key, r in rel.items():
        assert r <= limits[key.split("/")[1]], (key, r)


def test_moment_bounds_separate_the_local_gradient(results):
    """The one-rank step on one rank's rows alone (a lane that kept its
    gradient without the all-reduce) lies far outside every moment bound,
    while the float64 step from weights moved by float32's rounding, and
    the float32 one-rank step (bert_base), lie inside."""
    case, _, _, readings, _, _ = results
    for key, r in readings["local_rows"].items():
        kind = key.split("/")[1]
        assert r > 10 * max(REL_BF16[kind], REL32[kind]), (key, r)
    inside = ["perturbed"] + ([] if CASES[case]["f64"] else ["one_rank"])
    for name in inside:
        for key, r in readings[name].items():
            assert r <= REL32[key.split("/")[1]], (name, key, r)


@pytest.mark.parametrize("lane", sorted(LANES))
def test_lane_really_shards(results, lane):
    """Each lane's layout is the one it names: TP halves and SP on, the
    stages' text layers resident, ZeRO-1 moments and FSDP parameters
    split over 'data', the bfloat16 lane replicated."""
    case, metas = results[0], results[4]
    hidden = CASES[case]["bert"].get("hidden_size", 768)
    for m in metas:
        s = m[lane]["sharding"]
        if lane == "dp4_tp2_sp":
            assert s["query_rows"] == hidden // 2 and s["sp"] is True, s
            assert s["critic_w1_cols"] == 512, s
        elif lane == "dp4_pp2_zero1":
            assert s["min_layer_numel"] == 0 < s["max_layer_numel"], s
            assert s["split_moments"] > 0, s
        elif lane == "dp8_zero1_fsdp":
            assert s["split_params"] > 0 and s["split_moments"] > 0, s
        else:
            assert s["split_params"] == s["split_moments"] == 0, s


def _key_kind(key: str):
    """(group, kind) of a reference key: param, bn, mu or nu."""
    group, rest = key.split(".", 1)
    head = rest.split(".", 1)[0]
    if head in MOMENTS:
        return group, head
    return group, "bn" if "running" in rest else "param"


def test_one_rank_step_matches_jax(results):
    """The port's float64 one-rank step against JAX's, in both cases."""
    case, want, _, _, _, f64_dir = results
    with open(os.path.join(f64_dir, "ref.json")) as f:
        loss = json.load(f)["loss"]
    worst = {}      # (group, kind) -> [max |Δ|, max |JAX|]
    keys = [k for k in want if k != "loss"]
    for key in keys:
        mine = np.load(_ref_file(f64_dir, key))
        assert mine.dtype == np.float64 and mine.shape == want[key].shape, key
        group, kind = _key_kind(key)
        if kind in ("param", "bn"):
            np.testing.assert_allclose(mine, want[key], rtol=0, atol=1e-9,
                                       err_msg=key)
        w = worst.setdefault((group, kind), [0.0, 0.0])
        if mine.size:
            w[0] = max(w[0], float(np.max(np.abs(mine - want[key]))))
            w[1] = max(w[1], float(np.max(np.abs(want[key]))))
    rel = {f"{g}/{k}": w[0] / w[1] for (g, k), w in worst.items() if w[1]}
    print(json.dumps({"case": case, "jax_loss_gap": abs(loss - float(
        want["loss"])), "jax_rel": rel}))
    assert len(keys) > 100
    assert {kind for _, kind in worst} == {"param", "bn", *MOMENTS}
    np.testing.assert_allclose(loss, want["loss"], rtol=1e-5, atol=1e-6)
    for (group, kind), (_, r) in worst.items():
        assert r > 0, (group, kind)
        if kind in MOMENTS:
            assert rel[f"{group}/{kind}"] <= JAX64_REL, (group, kind)


def test_peak_rss_is_reported(results):
    metas = results[4]
    assert all(m["peak_rss_mb"] > 0 for m in metas)


# ---- the port side ----------------------------------------------------------

def _setup(case: dict, job: str, **knobs):
    """A fresh model, optimizers and state from JAX's initial weights
    (``init.npz``), in the case's dtype."""
    import torch

    from mimm_tpu_torch import checkpoint as ckpt
    from mimm_tpu_torch.config import TrainingConfig
    from mimm_tpu_torch.models.bert import BertConfig
    from mimm_tpu_torch.models.joint import ImageReportModel
    from mimm_tpu_torch.train import mi
    from tests.torch_port_child import unflatten_tree

    cfg = TrainingConfig().replace(**_cfg_kw(case), **knobs)
    bert = BertConfig(**_bert_kw(case))
    txs = mi.make_optimizers(cfg, steps_per_epoch=2)
    if case["f64"]:
        model = ImageReportModel(bert, output_channels=1,
                                 dtype=torch.float64).double()
    else:
        model = mi.build_joint_model(cfg, bert, device="cpu")
    with np.load(os.path.join(job, "init.npz")) as z:
        init = unflatten_tree({k: z[k] for k in z.files})
    weights = ckpt.mi_weights_from_flax(
        init["params"], init["batch_stats"],
        [init["critic"][str(i)] for i in range(len(init["critic"]))],
        bert.num_hidden_layers)
    del init
    state = mi.create_mi_state(model, cfg, txs, None, weights=weights)
    del weights
    batch = {k: torch.from_numpy(v) for k, v in
             global_batch(case["seq"], bert.vocab_size).items()}
    if case["f64"]:
        batch["image"] = batch["image"].double()
    return cfg, model, txs, state, batch


def _groups(state):
    """(name, {param name: tensor}, optimizer state) of each group."""
    from mimm_tpu_torch.train.mi import critic_dict

    return (("image_model", dict(state.model.image_model.named_parameters()),
             state.img_opt),
            ("text_model", dict(state.model.text_model.named_parameters()),
             state.txt_opt),
            ("critic", critic_dict(state.critic_params), state.mi_opt))


def _ref_file(ref_dir: str, key: str) -> str:
    return os.path.join(ref_dir, f"{key}.npy")


def _write_reference(state, cfg, loss: float, seconds: float,
                     ref_dir: str):
    """The one-rank state after its step as one ``.npy`` a tensor
    (``<group>.<name>``, ``<group>.mu.<name>``, ``<group>.nu.<name>``;
    BatchNorm statistics ``image_model.<buffer>``), then ``ref.json``
    (the loss, the optimizers' counts and each group's learning rate)."""
    from mimm_tpu_torch.train.optim import state_to_tree

    os.makedirs(ref_dir, exist_ok=True)
    count = {}
    for group, params, opt in _groups(state):
        tree = state_to_tree(opt)
        count[group] = tree["count"]
        for n, p in params.items():
            np.save(_ref_file(ref_dir, f"{group}.{n}"), p.detach().numpy())
            for kind in ("mu", "nu"):
                np.save(_ref_file(ref_dir, f"{group}.{kind}.{n}"),
                        tree[kind][n].numpy())
    for n, t in state.model.image_model.named_buffers():
        np.save(_ref_file(ref_dir, f"image_model.{n}"), t.numpy())
    with open(os.path.join(ref_dir, "ref.json.tmp"), "w") as f:
        json.dump({"loss": loss, "count": count, "seconds": seconds,
                   "lr": {"image_model": cfg.init_lr, "critic": cfg.init_lr,
                          "text_model": cfg.bert_lr}}, f)
    os.replace(os.path.join(ref_dir, "ref.json.tmp"),
               os.path.join(ref_dir, "ref.json"))


def _ref_dirs(case: dict, job: str):
    """(the one-rank step in the case's dtype, the one in float64): one
    directory in a float64 case."""
    ref_dir = os.path.join(job, "ref")
    return ref_dir, ref_dir if case["f64"] else os.path.join(job, "ref64")


def _gaps(state, ref_dir: str, moments_dir: str) -> dict:
    """Max |rank's resting piece − the same piece of the one-rank state| of
    each group's parameters and BatchNorm statistics (``ref_dir``) and Adam
    moments (``moments_dir``), one tensor at a time;
    ``<group>/<kind>_ref``: the largest |value| of the reference's pieces."""
    import torch

    from mimm_tpu_torch.parallel import mesh as mesh_lib
    from mimm_tpu_torch.train.mi import _layout
    from mimm_tpu_torch.train.optim import AdamState, state_to_tree

    mesh = None if state.layout is None else state.layout.mesh
    load = lambda d, key: torch.from_numpy(      # noqa: E731
        np.load(_ref_file(d, key)))
    out = {}

    def worst(name: str, key: str, diff: float) -> None:
        if diff >= out.get(name, -1.0):
            out[name], out[name + "_key"] = diff, key

    for group, params, opt in _groups(state):
        layout = _layout(state, group)
        tree = state_to_tree(opt)
        out[f"{group}/count"] = tree["count"]
        for kind in ("param", "mu", "nu"):
            out[f"{group}/{kind}"] = out[f"{group}/{kind}_ref"] = 0.0
        for n, p in params.items():
            ref_p = {n: load(ref_dir, f"{group}.{n}")}
            placed = AdamState(0, {n: load(moments_dir, f"{group}.mu.{n}")},
                               {n: load(moments_dir, f"{group}.nu.{n}")})
            if layout is not None:      # a replicated state rests whole
                placed = mesh_lib.place_group(ref_p, placed, layout, mesh)
            pairs = (("param", p.detach(), ref_p[n]),
                     ("mu", tree["mu"][n], placed.mu[n]),
                     ("nu", tree["nu"][n], placed.nu[n]))
            for kind, mine, theirs in pairs:
                assert mine.shape == theirs.shape, (group, kind, n)
                if not mine.numel():
                    continue
                worst(f"{group}/{kind}", n, float(
                    (mine.double() - theirs.double()).abs().max()))
                out[f"{group}/{kind}_ref"] = max(
                    out[f"{group}/{kind}_ref"], float(theirs.abs().max()))
    out["bn"] = 0.0
    for n, t in state.model.image_model.named_buffers():
        worst("bn", n, float((t.double() - load(ref_dir, f"image_model.{n}")
                              .double()).abs().max()))
    return out


def _moments_rel(gaps: dict) -> dict:
    """Each group's moments in one rank's ``_gaps``, max |Δ| / max |ref|."""
    return {f"{g}/{k}": gaps[f"{g}/{k}"] / gaps[f"{g}/{k}_ref"]
            for g in GROUPS for k in MOMENTS}


def _sharding(lane: str, state, full: dict) -> dict:
    """What the lane's layout did to this rank's tensors: the TP pieces'
    widths, the resident layers' sizes, and the count of parameters and
    moments resting split (against ``full``, the whole shapes)."""
    from mimm_tpu_torch.train.optim import state_to_tree

    text = state.model.text_model
    s = {"split_params": 0, "split_moments": 0}
    for group, params, opt in _groups(state):
        mu = state_to_tree(opt)["mu"]
        for n, p in params.items():
            if lane == "dp4_pp2_zero1" and group == "text_model":
                continue        # the stage layout, counted below
            s["split_params"] += tuple(p.shape) != full[group][n]
            s["split_moments"] += tuple(mu[n].shape) != full[group][n]
    if lane == "dp4_tp2_sp":
        s["query_rows"] = int(text.bert.encoder.layer[0].attention.self
                              .query.weight.shape[0])
        s["sp"] = bool(text.bert.sequence_parallel)
        s["critic_w1_cols"] = int(state.critic_params[0]["w"].shape[1])
    if lane == "dp4_pp2_zero1":
        sizes = [p.numel() for n, p in text.named_parameters()
                 if ".layer." in n]
        s["min_layer_numel"], s["max_layer_numel"] = min(sizes), max(sizes)
    return s


def _reference(job: str) -> None:
    """The one-rank step at the global batch (every lane's reference), in
    the case's dtype and in float64, then ``readings.json``: each group's
    moments against the float64 step's (``_moments_rel``) of
    * ``local_rows``, the control: the step on a 'data': 8 rank's rows
      alone, in the case's dtype;
    * ``perturbed``: the float64 step from weights moved by up to
      ``PERTURB`` of themselves, the most over ``PERTURB_SEEDS``;
    * ``one_rank`` (float32 cases): the float32 step."""
    import gc
    import time

    import torch

    from mimm_tpu_torch.train import mi

    torch.backends.mkldnn.enabled = False
    with open(os.path.join(job, "spec.json")) as f:
        case = CASES[json.load(f)["case"]]
    ref_dir, f64_dir = _ref_dirs(case, job)
    readings = {}

    def step(f64: bool, rows: int = B, seed: int = 0):
        cfg, model, txs, state, batch = _setup(dict(case, f64=f64), job)
        if seed:
            gen = torch.Generator().manual_seed(seed)
            with torch.no_grad():
                for p in [*model.parameters(),
                          *(t for layer in state.critic_params
                            for t in layer.values())]:
                    p.mul_(1 + PERTURB * (2 * torch.rand(
                        p.shape, generator=gen, dtype=p.dtype) - 1))
        t0 = time.time()
        state, loss = mi.make_mi_train_step(model, txs, cfg)(
            state, {k: v[:rows] for k, v in batch.items()})
        return cfg, state, loss.item(), time.time() - t0

    dtypes = [True] if case["f64"] else [True, False]
    for f64 in dtypes:      # float64 first: the float32 step reads it
        cfg, state, loss, seconds = step(f64)
        _write_reference(state, cfg, loss, seconds,
                         f64_dir if f64 else ref_dir)
        if not f64:
            readings["one_rank"] = _moments_rel(
                _gaps(state, ref_dir, f64_dir))
        del state
        gc.collect()
    for name, f64, rows, seed in (
            *(("perturbed", True, B, seed) for seed in PERTURB_SEEDS),
            ("local_rows", case["f64"], CONTROL_ROWS, 0)):
        _, state, _, _ = step(f64, rows, seed)
        rel = _moments_rel(_gaps(state, ref_dir, f64_dir))
        readings[name] = {k: max(r, readings.get(name, {}).get(k, 0.0))
                          for k, r in rel.items()}
        del state
        gc.collect()
    with open(os.path.join(ref_dir, "readings.json"), "w") as f:
        json.dump(readings, f)
    np.savez(os.path.join(job, "out.npz"))


def _peak_rss_mb() -> float:
    """This process's peak resident set (VmHWM).  ``getrusage``'s
    ``ru_maxrss`` would not do for a rank: a child started by fork and
    exec starts from its parent's peak, the pytest process holding JAX's
    step."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) / 1024
    raise RuntimeError("no VmHWM in /proc/self/status")


def _rank(job: str) -> None:
    """One rank of the 8-rank world: every lane in turn, each from a fresh
    state, held against the one-rank reference once it is written."""
    import gc
    import time

    import torch

    from mimm_tpu_torch.parallel import mesh as mesh_lib
    from mimm_tpu_torch.train import mi

    torch.backends.mkldnn.enabled = False
    assert mesh_lib.initialize_distributed(device="cpu", backend="gloo")
    assert mesh_lib.world_size() == WORLD
    with open(os.path.join(job, "spec.json")) as f:
        case = CASES[json.load(f)["case"]]
    ref_dir, f64_dir = _ref_dirs(case, job)
    meta = {}
    for lane, (shape, knobs) in LANES.items():
        mesh = mesh_lib.make_mesh(shape)
        cfg, model, txs, state, batch = _setup(case, job, **knobs)
        full = {group: {n: tuple(p.shape) for n, p in params.items()}
                for group, params, _ in _groups(state)}
        state = mesh_lib.shard_mi_state(
            mesh, state, zero1=cfg.zero1_optimizer_sharding,
            fsdp=cfg.fsdp_parameter_sharding,
            sequence_parallel=cfg.sequence_parallel)
        step = mi.make_mi_train_step(model, txs, cfg, mesh=mesh)
        t0 = time.time()
        state, loss = step(state, mesh_lib.shard_batch(mesh, batch))
        rec = {"loss": loss.item(), "seconds": time.time() - t0,
               "sharding": _sharding(lane, state, full),
               "peak_rss_mb": _peak_rss_mb()}
        deadline = time.monotonic() + WAIT_S
        while not os.path.exists(os.path.join(ref_dir, "ref.json")):
            assert time.monotonic() < deadline, "no one-rank reference"
            time.sleep(0.2)
        rec["gaps"] = _gaps(state, ref_dir, f64_dir)
        meta[lane] = rec
        del cfg, model, txs, state, batch, step
        gc.collect()
        mesh_lib.barrier(mesh)
    meta["peak_rss_mb"] = _peak_rss_mb()
    with open(os.path.join(job, f"out-rank{mesh_lib.world_rank()}.json"),
              "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    if sys.argv[2:3] == ["ref"]:
        _reference(sys.argv[1])
    else:
        _rank(sys.argv[1])
