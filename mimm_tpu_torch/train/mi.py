"""The multimodal mutual-information train step (mimm_tpu/train/mi.py
counterpart, the direct step body :277-370).

One step: the joint ResNet + BERT forward to 768-d embeddings, the (B, B)
critic scores, the DV (or InfoNCE) bound over the diagonal positives and
the study-id-masked negatives, the backward, and three optimizer updates:
Adam on the image tower, Adam on the critic, pytorch_transformers AdamW
with warmup-linear on the text tower (reference main_utils.py:151-230).

Entry points, as the JAX bench drives them: ``create_mi_state`` ->
``make_mi_train_step`` / ``make_mi_multi_step`` -> ``save_mi_checkpoints``.
The state's modules and critic tensors are updated in place.  Randomness
comes from one ``torch.Generator`` per step on the model's device, seeded
from (cfg.seed, step), the counterpart of ``fold_in(key(seed), step)``.

Left to later slices, and raising ``NotImplementedError`` when asked for:
the mesh and parallel modes (pp, ZeRO-1, FSDP, sequence parallelism, bf16
gradient all-reduce, per-shard negatives), GradCache, and the native
resume checkpoint.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import Callable, List, NamedTuple, Optional

import torch

from mimm_tpu_torch import checkpoint as ckpt
from mimm_tpu_torch import resolve_device
from mimm_tpu_torch.models.bert import BertConfig
from mimm_tpu_torch.models.joint import ImageReportModel
from mimm_tpu_torch.models.mlp import make_mlp
from mimm_tpu_torch.objectives.critics import bound_from_scores
from mimm_tpu_torch.objectives.pairing import pairwise_critic_scores
from mimm_tpu_torch.ops.image_norm import decompact_batch
from mimm_tpu_torch.ops.pairwise_critic import pairwise_critic_scores_pallas
from mimm_tpu_torch.train.optim import (GradientTransformation, adam_torch,
                                        adamw_hf, apply_updates,
                                        bert_decay_mask, bert_trainable_mask,
                                        freeze, resnet_trainable_mask,
                                        warmup_linear_schedule)

logger = logging.getLogger(__name__)

CRITIC_HIDDEN = (1024, 512)  # reference main_utils.py:77
_PARALLEL = "comes with the parallel slice (ROADMAP.md queue A)"


@dataclasses.dataclass
class MITrainState:
    """The joint model (its parameters, and the BatchNorm running
    statistics as buffers), the critic's ``[{'w', 'b'}]`` layers, the
    three optimizer states and the number of steps taken."""

    model: ImageReportModel
    critic_params: List[dict]
    img_opt: object
    mi_opt: object
    txt_opt: object
    step: int = 0

    @property
    def params(self) -> dict:
        return {"image_model": dict(self.model.image_model.named_parameters()),
                "text_model": dict(self.model.text_model.named_parameters())}

    @property
    def batch_stats(self) -> dict:
        return {n: b for n, b in self.model.image_model.named_buffers()
                if not n.endswith("num_batches_tracked")}


class MIOptimizers(NamedTuple):
    img: GradientTransformation
    mi: GradientTransformation
    txt: GradientTransformation


def critic_dict(critic_params: List[dict]) -> dict:
    """``{'<layer>.w': tensor, '<layer>.b': tensor}`` view of the critic."""
    return {f"{i}.{k}": layer[k] for i, layer in enumerate(critic_params)
            for k in ("w", "b")}


def load_bert_config(cfg) -> BertConfig:
    """``bert_config.json`` of ``cfg.bert_pretrained_dir`` (BERT-base
    defaults where there is none) with the step's knobs."""
    path = os.path.join(cfg.bert_pretrained_dir, cfg.bert_config_name)
    overrides = dict(num_classes=cfg.output_channels,
                     flash_attention=cfg.flash_attention,
                     gelu_tanh=cfg.gelu_tanh, u8_dropout=cfg.u8_dropout,
                     fused_ffn=cfg.fused_ffn)
    if os.path.exists(path):
        return BertConfig.from_json_file(path, **overrides)
    logger.warning("No bert config at %s — using bert-base defaults", path)
    return BertConfig(**overrides)


def build_joint_model(cfg, bert_config: Optional[BertConfig] = None,
                      mesh=None, device="cuda") -> ImageReportModel:
    """The joint model in the config's compute dtype, on ``device``.
    ``s2d_stem`` is a TPU schedule of the same function and runs as the
    plain stem; ``pallas_stem`` needs kernel rows 12-14 and raises."""
    if mesh is not None or cfg.sequence_parallel:
        raise NotImplementedError(f"a mesh / sequence parallelism {_PARALLEL}")
    if cfg.pallas_stem:
        raise NotImplementedError("pallas_stem needs the shallow-conv kernels "
                                  "(ROADMAP.md queue B rows 12-14)")
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    model = ImageReportModel(bert_config or load_bert_config(cfg),
                             output_channels=cfg.output_channels, dtype=dtype)
    return model.to(resolve_device(device))


def make_optimizers(cfg, steps_per_epoch: int,
                    num_epochs: Optional[int] = None) -> MIOptimizers:
    """The reference's three optimizers (main_utils.py:151-172); the
    warmup-linear schedule spans ``num_epochs`` (default
    ``cfg.num_train_epochs``) of ``steps_per_epoch``."""
    total = int((num_epochs or cfg.num_train_epochs) * steps_per_epoch)
    sched = warmup_linear_schedule(cfg.bert_lr,
                                   warmup_steps=cfg.warmup_fraction * total,
                                   t_total=total)
    bf16 = lambda name: torch.bfloat16 if name == "bfloat16" else None
    img = adam_torch(cfg.init_lr, moment_dtype=bf16(cfg.adam_moment_dtype))
    txt = adamw_hf(sched, eps=1e-6, weight_decay=0.1, correct_bias=False,
                   mask=bert_decay_mask,
                   moment_dtype=bf16(cfg.adamw_moment_dtype))
    if cfg.freeze_image_encoder:
        img = freeze(img, resnet_trainable_mask)
    if cfg.freeze_text_encoder:
        txt = freeze(txt, bert_trainable_mask)
    return MIOptimizers(img=img, txt=txt,
                        mi=adam_torch(cfg.init_lr,
                                      moment_dtype=bf16(cfg.adam_moment_dtype)))


@torch.no_grad()
def init_joint_params(model: ImageReportModel,
                      generator: torch.Generator) -> None:
    """Random weights with the JAX package's initializers (the same
    distributions, other bits): convs He-normal over fan-out, BatchNorm
    (1, 0), ``fc1`` torch.nn.Linear's U(±1/√fan_in) with a zero bias, BERT
    matrices and tables N(0, initializer_range) with zero biases,
    LayerNorms (1, 0).  Drawn on the CPU, then copied to the device."""
    std = model.bert_config.initializer_range
    for name, t in model.state_dict().items():
        if name.endswith(("running_mean", "num_batches_tracked")):
            x = torch.zeros(t.shape)
        elif name.endswith("running_var"):
            x = torch.ones(t.shape)
        elif t.dim() == 4:
            fan_out = t.shape[0] * t.shape[2] * t.shape[3]
            x = torch.randn(t.shape, generator=generator) \
                * math.sqrt(2.0 / fan_out)
        elif name == "image_model.fc1.weight":
            bound = t.shape[1] ** -0.5
            x = torch.empty(t.shape).uniform_(-bound, bound,
                                              generator=generator)
        elif t.dim() == 2:
            x = torch.randn(t.shape, generator=generator) * std
        elif name.endswith("weight"):      # BatchNorm / LayerNorm scale
            x = torch.ones(t.shape)
        else:
            x = torch.zeros(t.shape)
        t.copy_(x)


def create_mi_state(model: ImageReportModel, cfg, txs: MIOptimizers,
                    generator: Optional[torch.Generator],
                    weights: Optional[dict] = None) -> MITrainState:
    """A fresh state on the model's device.  The joint model's and the
    critic's weights are random from ``generator`` (a CPU generator), or
    ``weights`` = ``{'image_model': sd, 'text_model': sd, 'critic':
    [{'w', 'b'}]}`` (``checkpoint.mi_weights_from_flax``), loaded with
    ``strict=True``.  The critic's input width is the two embedding
    widths.  (JAX's ``bert_variables``, a pretrained BERT, comes with the
    Manager slice.)"""
    del cfg  # the JAX signature; the port's model carries what it reads
    device = next(model.parameters()).device
    dtype = next(model.parameters()).dtype
    if weights is None:
        init_joint_params(model, generator)
        critic_in = model.image_model.fc1.in_features \
            + model.bert_config.hidden_size
        critic = make_mlp(critic_in, list(CRITIC_HIDDEN), generator=generator)
    else:
        model.image_model.load_state_dict(weights["image_model"], strict=True)
        model.text_model.load_state_dict(weights["text_model"], strict=True)
        critic = weights["critic"]
    critic = [{k: torch.as_tensor(t).to(device=device, dtype=dtype)
               .requires_grad_() for k, t in layer.items()} for layer in critic]
    return MITrainState(
        model=model, critic_params=critic,
        img_opt=txs.img.init(dict(model.image_model.named_parameters())),
        mi_opt=txs.mi.init(critic_dict(critic)),
        txt_opt=txs.txt.init(dict(model.text_model.named_parameters())))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's generator: seeded from (seed, step), one stream per step
    (the counterpart of ``fold_in(key(seed), step)``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(((seed & 0x7FFFFFFF) << 32) | (step & 0xFFFFFFFF))
    return gen


def _check_slice(cfg, data_shards: int, mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(f"a mesh (pp, tp, data parallel) {_PARALLEL}")
    if not cfg.global_negatives and data_shards > 1:
        raise NotImplementedError(f"per-shard negatives {_PARALLEL}")
    for knob in ("zero1_optimizer_sharding", "fsdp_parameter_sharding",
                 "sequence_parallel"):
        if getattr(cfg, knob):
            raise NotImplementedError(f"{knob} {_PARALLEL}")
    if cfg.grad_allreduce_dtype not in ("float32", ""):
        raise NotImplementedError(f"grad_allreduce_dtype {_PARALLEL}")
    if cfg.grad_cache_chunks > 1:
        raise NotImplementedError(
            "grad_cache_chunks > 1 comes with the GradCache slice (ROADMAP.md "
            "queue A), with the critic kernels and remat")


def make_mi_step_body(model: ImageReportModel, txs: MIOptimizers, cfg,
                      data_shards: int = 1, mesh=None) -> Callable:
    """(state, batch) -> (state, loss): forward, pair scores, bound,
    backward and the three optimizer updates.  ``batch``: the compact
    layout (uint8/uint16 images, uint16 ids, uint8 masks and segments,
    int64 ``study_id``) or already wide tensors, on the model's device."""
    _check_slice(cfg, data_shards, mesh)
    estimator = cfg.mi_estimator
    score_fn = pairwise_critic_scores_pallas if cfg.use_pallas_critic \
        else pairwise_critic_scores

    def step_body(state: MITrainState, batch: dict):
        device = next(model.parameters()).device
        gen = step_generator(cfg.seed, state.step, device)
        wide = decompact_batch(batch)
        emb_img, emb_txt, _, _ = model(
            wide["image"], wide["txt_ids"], wide["txt_masks"],
            wide["txt_segments"], train=True, generator=gen)
        loss = bound_from_scores(
            estimator, score_fn(state.critic_params, emb_img, emb_txt),
            batch["study_id"])
        params = state.params
        groups = [params["image_model"], params["text_model"],
                  critic_dict(state.critic_params)]
        names = [(gi, n) for gi, g in enumerate(groups) for n in g]
        flat = [groups[gi][n] for gi, n in names]
        grads = [{}, {}, {}]
        # parameters off the loss's path (BERT classifier, ResNet fc1) get
        # zeros, as JAX hands optax: adamw_hf still decays them
        for (gi, n), t, g in zip(names, flat, torch.autograd.grad(
                loss, flat, allow_unused=True)):
            grads[gi][n] = torch.zeros_like(t) if g is None else g
        img_g, txt_g, mi_g = grads
        img_u, state.img_opt = txs.img.update(img_g, state.img_opt, groups[0])
        txt_u, state.txt_opt = txs.txt.update(txt_g, state.txt_opt, groups[1])
        mi_u, state.mi_opt = txs.mi.update(mi_g, state.mi_opt, groups[2])
        for group, upd in zip(groups, (img_u, txt_u, mi_u)):
            apply_updates(group, upd)
        state.step += 1
        return state, loss.detach()

    return step_body


def make_mi_train_step(model: ImageReportModel, txs: MIOptimizers, cfg,
                       data_shards: int = 1, mesh=None) -> Callable:
    """One train step; see ``make_mi_step_body``."""
    return make_mi_step_body(model, txs, cfg, data_shards=data_shards,
                             mesh=mesh)


def make_mi_multi_step(model: ImageReportModel, txs: MIOptimizers, cfg,
                       data_shards: int = 1, mesh=None) -> Callable:
    """(state, batches) -> (state, losses[K]): K sequential steps over a
    batch dict stacked on a leading axis of K (JAX runs them as one
    ``lax.scan`` dispatch; here a loop)."""
    body = make_mi_step_body(model, txs, cfg, data_shards=data_shards,
                             mesh=mesh)

    def multi_step(state: MITrainState, batches: dict):
        k = next(iter(batches.values())).shape[0]
        losses = []
        for i in range(k):
            state, loss = body(state, {n: t[i] for n, t in batches.items()})
            losses.append(loss)
        return state, torch.stack(losses)

    return multi_step


def save_mi_checkpoints(save_dir: str, state: MITrainState, epoch: int,
                        bert_config: BertConfig,
                        export_torch_bins: bool = True) -> str:
    """``config.json`` and the reference ``.bin`` contracts (model.py:
    557-595): ``pytorch_MI_image_model.bin``, ``pytorch_MI_text_model.bin``
    and the joint ``pytorch_model_epoch<N>.bin``.  Returns ``save_dir``.
    The native resume checkpoint comes with ROADMAP.md queue A item 2."""
    os.makedirs(save_dir, exist_ok=True)
    bert_config.to_json_file(os.path.join(save_dir, "config.json"))
    if export_torch_bins:
        img_sd = state.model.image_model.state_dict()
        txt_sd = state.model.text_model.state_dict()
        ckpt.save_state_dict_bin(
            os.path.join(save_dir, "pytorch_MI_image_model.bin"), img_sd)
        ckpt.save_state_dict_bin(
            os.path.join(save_dir, "pytorch_MI_text_model.bin"), txt_sd)
        ckpt.save_joint_state_dict_bin(
            os.path.join(save_dir, f"pytorch_model_epoch{epoch}.bin"),
            img_sd, txt_sd)
    return save_dir
