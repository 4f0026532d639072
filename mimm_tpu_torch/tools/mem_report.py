"""Device-free per-rank memory accounting for a mesh / parallelism config
(tools/mem_report.py counterpart).

Answers "what rests in each rank's card memory for THIS config?" without
any device: the train state is built on ``torch.device("meta")`` (shapes
and dtypes, no storage: the counterpart of ``jax.eval_shape``), the
at-rest placement comes from the SAME rules the trainers use
(parallel/mesh.py ``mi_state_layouts`` / ``ae_state_layout``: TP over
'model' by ``bert_tp_shardings`` and ``critic_tp_shardings``, the stage
layout over 'pipe' by ``pipe_shardings``, the ZeRO-1 / FSDP ladder over
'data' by ``zero1_shardings``), on a mesh that holds only the axis sizes,
and each tensor's per-rank share is the piece those rules leave rank 0
(another stage's layers: nothing).

Usage (all TrainingConfig flags apply):
    python -m mimm_tpu_torch.tools.mem_report --mesh_shape data=8 \
        --zero1_optimizer_sharding true --fsdp_parameter_sharding true
    python -m mimm_tpu_torch.tools.mem_report --mesh_shape data=4,pipe=2
    python -m mimm_tpu_torch.tools.mem_report --trainer ae \
        --mesh_shape data=4 --zero1_optimizer_sharding true

Prints a per-group table (global vs per-rank MB) and one JSON line.  The
groups are the JAX tool's; an optimizer group counts its moments (the
port keeps the step count on the host).
"""

from __future__ import annotations

import json
import math
import sys
from typing import Dict, Optional, Sequence

import torch


def mesh_stub(cfg):
    """A ``parallel.mesh.Mesh`` of ``cfg.mesh_shape``'s axis sizes and no
    process groups, at rank 0 of every axis (all 'data' at size 1 without
    a shape)."""
    from mimm_tpu_torch.parallel import mesh as mesh_lib

    sizes = dict(cfg.mesh_shape) or {mesh_lib.DATA_AXIS: 1}
    return mesh_lib.Mesh(data=sizes.get(mesh_lib.DATA_AXIS, 1),
                         model=sizes.get(mesh_lib.MODEL_AXIS, 1),
                         pipe=sizes.get(mesh_lib.PIPE_AXIS, 1),
                         axis_names=tuple(sizes)), sizes


def abstract_mi_state(cfg, bert_config=None):
    """The MI train state of ``cfg`` on the meta device: the joint model,
    the critic's layers and the three optimizers' moments."""
    from mimm_tpu_torch.train import mi

    bert = bert_config or mi.load_bert_config(cfg)
    with torch.device("meta"):
        model = mi.build_joint_model(cfg, bert, device="meta")
        dtype = next(model.parameters()).dtype
        dims = [model.image_model.fc1.in_features + bert.hidden_size,
                *mi.CRITIC_HIDDEN, 1]
        critic = [{"w": torch.empty(dims[i], dims[i + 1], dtype=dtype),
                   "b": torch.empty(dims[i + 1], dtype=dtype)}
                  for i in range(len(dims) - 1)]
        txs = mi.make_optimizers(cfg, steps_per_epoch=100)
        return mi.MITrainState(
            model=model, critic_params=critic,
            img_opt=txs.img.init(dict(model.image_model.named_parameters())),
            mi_opt=txs.mi.init(mi.critic_dict(critic)),
            txt_opt=txs.txt.init(dict(model.text_model.named_parameters())))


def abstract_ae_state(cfg):
    """The AE train state of ``cfg`` on the meta device."""
    from mimm_tpu_torch.train import ae

    with torch.device("meta"):
        model = ae.build_ae_model(cfg, device="meta")
        return ae.AETrainState(model, ae._ae_tx(cfg).init(
            dict(model.named_parameters())))


def _moments(opt_state) -> Dict[str, torch.Tensor]:
    """An optimizer state's moment tensors, keyed '<moment>/<name>' by
    the parameter they belong to."""
    from mimm_tpu_torch.parallel import mesh as mesh_lib

    out, k = {}, [0]

    def take(m: dict) -> dict:
        out.update({(k[0], n): t for n, t in m.items()})
        k[0] += 1
        return m
    mesh_lib._map_moments(opt_state, take)
    return out


def rank_numel(name: str, shape, layout, mesh, moment: bool) -> int:
    """Elements of tensor ``name`` (whole ``shape``) that rank 0 keeps
    under ``layout`` (a ``GroupLayout``, None: replicated): nothing of
    another stage's layer, else its TP piece and, for a moment under
    ZeRO-1 or a parameter under FSDP, its 'data' slice."""
    if layout is None:
        return math.prod(shape)
    stage = (layout.pipe or {}).get(name)
    if stage is not None and stage != mesh.pipe_rank:
        return 0
    shape = list(shape)
    for dim, n, axis in (((layout.tp or {}).get(name), mesh.model, "model"),
                         (((layout.zero if moment else layout.fsdp) or {})
                          .get(name), mesh.data, "data")):
        if dim is None or n == 1:
            continue
        if shape[dim] % n:
            raise ValueError(f"{name} of shape {tuple(shape)} does not split "
                             f"along dim {dim} over the {n}-rank {axis!r} "
                             f"axis")
        shape[dim] //= n
    return math.prod(shape)


def _group(tensors: dict, layout, mesh, moment: bool) -> dict:
    g = p = 0
    for key, t in tensors.items():
        name = key[1] if moment else key
        g += t.numel() * t.element_size()
        p += rank_numel(name, t.shape, layout, mesh, moment) \
            * t.element_size()
    return {"global_bytes": g, "per_rank_bytes": p}


def report(cfg, bert_config=None, trainer: str = "mi") -> dict:
    """{'groups': {name: {'global_mb', 'per_rank_mb', 'global_bytes',
    'per_rank_bytes'}}, 'total_*', 'mesh': {...}} for cfg's mesh / ZeRO /
    pipe / TP knobs (JAX's layout, with a rank for a chip and the bytes
    beside the MB).  ``trainer``: 'mi' (the joint model) or 'ae' (the
    autoencoder)."""
    from mimm_tpu_torch.parallel import mesh as mesh_lib
    from mimm_tpu_torch.train import mi

    zero1 = getattr(cfg, "zero1_optimizer_sharding", False)
    fsdp = getattr(cfg, "fsdp_parameter_sharding", False)
    mesh, sizes = mesh_stub(cfg)
    if trainer == "ae":
        state = abstract_ae_state(cfg)
        layout = mesh_lib.ae_state_layout(mesh, state, zero1, fsdp)
        groups = {
            "params": (dict(state.model.named_parameters()), layout, False),
            "batch_stats": (
                {n: b for n, b in state.model.named_buffers()
                 if not n.endswith("num_batches_tracked")}, None, False),
            "opt_state": (_moments(state.opt_state), layout, True),
        }
    elif trainer == "mi":
        state = abstract_mi_state(cfg, bert_config)
        lay = mesh_lib.mi_state_layouts(mesh, state, zero1, fsdp) or {}
        groups = {
            "params/image_model": (state.params["image_model"],
                                   lay.get("image_model"), False),
            "params/text_model": (state.params["text_model"],
                                  lay.get("text_model"), False),
            "critic_params": (mi.critic_dict(state.critic_params),
                              lay.get("critic"), False),
            "batch_stats": (state.batch_stats, None, False),
            "img_opt": (_moments(state.img_opt), lay.get("image_model"),
                        True),
            "mi_opt": (_moments(state.mi_opt), lay.get("critic"), True),
            "txt_opt": (_moments(state.txt_opt), lay.get("text_model"),
                        True),
        }
    else:
        raise ValueError(f"unknown trainer: {trainer}")
    out = {}
    for name, (tensors, layout, moment) in groups.items():
        b = _group(tensors, layout, mesh, moment)
        out[name] = {"global_mb": round(b["global_bytes"] / 2 ** 20, 2),
                     "per_rank_mb": round(b["per_rank_bytes"] / 2 ** 20, 2),
                     **b}
    total = lambda key: sum(v[key] for v in out.values())
    return {
        "trainer": trainer,
        "mesh": sizes,
        "zero1": bool(zero1),
        "fsdp": bool(fsdp),
        "groups": out,
        "total_global_mb": round(total("global_mb"), 2),
        "total_per_rank_mb": round(total("per_rank_mb"), 2),
        "total_global_bytes": total("global_bytes"),
        "total_per_rank_bytes": total("per_rank_bytes"),
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from mimm_tpu_torch.config import construct_training_parameters

    argv = list(sys.argv[1:] if argv is None else argv)
    trainer = "mi"
    if "--trainer" in argv:
        i = argv.index("--trainer")
        trainer = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    cfg = construct_training_parameters(argv)
    r = report(cfg, trainer=trainer)
    print(f"trainer={trainer} mesh={r['mesh']} zero1={r['zero1']} "
          f"fsdp={r['fsdp']}")
    print(f"{'group':24s} {'global MB':>10s} {'per-rank MB':>12s}")
    for name, v in r["groups"].items():
        print(f"{name:24s} {v['global_mb']:>10.2f} {v['per_rank_mb']:>12.2f}")
    print(f"{'TOTAL':24s} {r['total_global_mb']:>10.2f} "
          f"{r['total_per_rank_mb']:>12.2f}")
    print(json.dumps(r))
    return r


if __name__ == "__main__":
    main()
