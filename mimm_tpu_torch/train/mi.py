"""The multimodal mutual-information train step (mimm_tpu/train/mi.py
counterpart, the direct step body :277-370).

One step: the joint ResNet + BERT forward to 768-d embeddings, the (B, B)
critic scores, the DV (or InfoNCE) bound over the diagonal positives and
the study-id-masked negatives, the backward, and three optimizer updates:
Adam on the image tower, Adam on the critic, pytorch_transformers AdamW
with warmup-linear on the text tower (reference main_utils.py:151-230).

Entry points: ``mimm_tpu_torch.cli.multi_modal`` (pretraining from disk),
``MultiModalManager(cfg).train(token_features)``, the epoch loop it runs
(:633-859: the on-disk dataset, the resume checkpoint, preemption,
pruning), and beneath it, as the JAX bench drives them,
``create_mi_state`` -> ``make_mi_train_step`` / ``make_mi_multi_step`` ->
``save_mi_checkpoints``.
The state's modules and critic tensors are updated in place.  Randomness
comes from one ``torch.Generator`` per step on the model's device, seeded
from (cfg.seed, step), the counterpart of ``fold_in(key(seed), step)``.

``cfg.grad_cache_chunks`` > 1 takes the GradCache body (mi.py:478-557):
a chunked forward without gradients that keeps only the embeddings, the
full-batch critic scores and bound with the gradients of the critic and of
the embeddings, then a chunked re-forward that pulls the embeddings'
gradients back to the towers' parameters one chunk at a time.  The (B, B)
negative pool spans the whole batch while the towers' activations are
those of one chunk: B=2048 trains on one card in 32 chunks of 64, where
the critic's size switch takes the pairwise-critic kernels.

The Manager traces its first ``cfg.profile_steps`` dispatches into
``<save_directory>/profile/`` (profiling.StepProfiler) and with
``cfg.tensorboard`` mirrors ``mi.jsonl`` into ``tb/mi/``.

Data parallelism (``mesh``: parallel/mesh.py, the world as a 'data' axis):
a world of N ranks, each given B/N rows, trains as one rank at batch B.
Each rank embeds its rows with BatchNorm's statistics taken over the world
(sync-BN), gathers every rank's embeddings and study ids in rank order,
and computes the bound of the whole batch, the same on every rank; the
gather hands each rank its own rows of the embedding gradient, so the
towers' parameter gradients are each rank's share, summed over the world
in float32 (or in bfloat16 with ``cfg.grad_allreduce_dtype``), while the
critic's gradient, which every rank computed in full, is taken from rank
0.  With ``cfg.global_negatives`` False each rank's rows are its own
blocks of negatives and the loss is the mean over the world's blocks.
GradCache in a world runs ``grad_cache_chunks`` / N chunks of the global
batch on each rank, chunk c of rank r being the global batch's chunk r ·
(chunks / N) + c, so its statistics, masks and gradients are those of one
rank.  Dropout: rank r of a world of several draws its own rows' masks
from ``rank_generator(seed, step, r)`` (JAX's fold of ``axis_index``);
one rank draws ``step_generator(seed, step)``'s, so a world equals one
rank with dropout off, as JAX's sharded tests compare them.

A 'model' mesh axis (``cfg.mesh_shape`` such as ``{'data': 2, 'model':
2}``): ``parallel.mesh.shard_mi_state`` cuts the text tower and the critic
to their TP layouts, and the towers, the critic and the bound run as
tensor-parallel ranks (models/bert.py, objectives/pairing.py); with
``cfg.sequence_parallel`` the text tower's elementwise regions split the
tokens too.  The ranks of one data row get the same rows and draw the
same masks, each applying its part of them, so a world at dropout 0.1
draws one rank's masks.  ``cfg.zero1_optimizer_sharding`` rests the
optimizer moments and ``cfg.fsdp_parameter_sharding`` the parameters
'data'-split (``state.layout``); the update runs on the slices
(``parallel.mesh.sharded_update``) and gives the replicated update's bits.
The resume checkpoint holds the whole tensors whatever the mode
(``mi_state_tree`` gathers them), so a run resumes under another mode or
on one rank.

A 'pipe' mesh axis (``{'pipe': S}`` or ``{'data': D, 'pipe': S}``; GPipe,
parallel/pipeline.py): ``shard_mi_state`` leaves each stage the text
layers [s·n/S, (s+1)·n/S) and their moments, and the step runs the text
tower through ``pipelined_textbert_apply`` in
``cfg.pipeline_microbatches`` microbatches (0: one per stage) while every
pipe rank runs the image tower, the critic and the bound whole on its data
index's rows.  After the backward of the loss, which ends at the replicated
[CLS] rows, each stage pulls their gradient back through its layers
(``StageRun.backward``); the embeddings' gradients, stage 0's, are
broadcast over 'pipe'.  Dropout draws per (step, data index or GradCache
chunk, layer, microbatch) from ``pipe_key``, so a pipeline equals one rank
at dropout 0, as JAX's tests compare them.  GradCache pipelines each
chunk's passes.  Checkpoints hold the plain ``layer0 .. layer{n-1}`` tree
(``mi_state_tree`` gathers the stages), so a pipelined run and a plain
one resume from each other.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from mimm_tpu_torch import checkpoint as ckpt
from mimm_tpu_torch import preempt, resolve_device
from mimm_tpu_torch.data import crop_cache
from mimm_tpu_torch.data.pipeline import (CXRImageReportDataset, Loader,
                                          device_prefetch, resume_chunks,
                                          scan_chunks)
from mimm_tpu_torch.metrics import MetricWriter, Plot_Training
from mimm_tpu_torch.models.bert import BertConfig
from mimm_tpu_torch.models.joint import ImageReportModel
from mimm_tpu_torch.models.mlp import make_mlp
from mimm_tpu_torch.objectives.critics import bound_from_scores
from mimm_tpu_torch.objectives.pairing import (pairwise_critic_scores,
                                               tp_critic_scores)
from mimm_tpu_torch.profiling import StepProfiler
from mimm_tpu_torch.ops.image_norm import decompact_batch
from mimm_tpu_torch.ops.pairwise_critic import pairwise_critic_scores_pallas
from mimm_tpu_torch.models.resnet import set_bn_axis
from mimm_tpu_torch.parallel import mesh as mesh_lib
from mimm_tpu_torch.parallel import pipeline
from mimm_tpu_torch.train.optim import (GradientTransformation, adam_torch,
                                        adamw_hf, apply_updates,
                                        bert_decay_mask, bert_trainable_mask,
                                        freeze, resnet_trainable_mask,
                                        state_from_tree, state_to_tree,
                                        warmup_linear_schedule)

logger = logging.getLogger(__name__)

CRITIC_HIDDEN = (1024, 512)  # reference main_utils.py:77


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
    layout: Optional[mesh_lib.StateLayout] = None

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
                      device="cuda") -> ImageReportModel:
    """The joint model in the config's compute dtype, on ``device`` (this
    rank's card in a world: ``parallel.mesh.rank_device``).  ``s2d_stem``
    is a TPU schedule of the canonical stem and runs as it;
    ``pallas_stem`` runs the stem on the shallow-conv kernels (the two are
    exclusive, as in JAX).  The text tower runs tensor- and
    sequence-parallel once ``parallel.mesh.shard_mi_state`` has placed it
    (JAX's ``sp_sharding``); the parameters are the same either way."""
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    model = ImageReportModel(bert_config or load_bert_config(cfg),
                             output_channels=cfg.output_channels, dtype=dtype,
                             s2d_stem=cfg.s2d_stem,
                             pallas_stem=cfg.pallas_stem)
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
                    weights: Optional[dict] = None,
                    bert_state_dict: Optional[dict] = None) -> MITrainState:
    """A fresh state on the model's device.  The joint model's and the
    critic's weights are random from ``generator`` (a CPU generator), or
    ``weights`` = ``{'image_model': sd, 'text_model': sd, 'critic':
    [{'w', 'b'}]}`` (``checkpoint.mi_weights_from_flax``), loaded with
    ``strict=True``.  ``bert_state_dict`` (JAX's ``bert_variables``: a
    pretrained BERT from ``checkpoint.load_bert_pytorch_bin``) then
    overwrites the text tower's entries it names (``bert.*``, and
    ``classifier.*`` if present).  The critic's input width is the two
    embedding widths."""
    del cfg  # the JAX signature; the port's model carries what it reads
    device = next(model.parameters()).device
    dtype = next(model.parameters()).dtype
    unknown = sorted(set(bert_state_dict or ())
                     - set(model.text_model.state_dict()))
    if unknown:     # before anything is loaded
        raise KeyError(f"pretrained BERT keys the text tower lacks: "
                       f"{unknown[:5]}")
    if weights is None:
        init_joint_params(model, generator)
        critic_in = model.image_model.fc1.in_features \
            + model.bert_config.hidden_size
        critic = make_mlp(critic_in, list(CRITIC_HIDDEN), generator=generator)
    else:
        model.image_model.load_state_dict(weights["image_model"], strict=True)
        model.text_model.load_state_dict(weights["text_model"], strict=True)
        critic = weights["critic"]
    if bert_state_dict is not None:
        model.text_model.load_state_dict(
            {**model.text_model.state_dict(), **bert_state_dict}, strict=True)
    # copies: the state's critic is updated in place and must not be the
    # caller's ``weights``
    critic = [{k: torch.as_tensor(t).to(device=device, dtype=dtype,
                                        copy=True).requires_grad_()
               for k, t in layer.items()} for layer in critic]
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


_MASK64 = (1 << 64) - 1


def chunk_generator(seed: int, step: int, chunk: int,
                    device) -> torch.Generator:
    """The generator of chunk ``chunk`` of a GradCache step: the step's
    seed and the chunk through splitmix64, a stream apart from the direct
    step's (the counterpart of ``fold_in(step_key, chunk)``).  Pass 2 makes
    it again, so a chunk's re-forward draws pass 1's masks."""
    x = ((((seed & 0x7FFFFFFF) << 32) | (step & 0xFFFFFFFF))
         + (chunk + 1) * 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    gen = torch.Generator(device=device)
    gen.manual_seed(x ^ (x >> 31))
    return gen


def rank_generator(seed: int, step: int, rank: int,
                   device) -> torch.Generator:
    """The direct step's generator on rank ``rank`` of a world of several:
    the step's seed folded with the rank through splitmix64, a stream
    apart from ``step_generator``'s and ``chunk_generator``'s (JAX folds
    ``axis_index`` into the step's key)."""
    x = ((((seed & 0x7FFFFFFF) << 32) | (step & 0xFFFFFFFF))
         ^ ((rank + 1) * 0xD1B54A32D192ED03)) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    gen = torch.Generator(device=device)
    gen.manual_seed(x ^ (x >> 31))
    return gen


def pipe_key(seed: int, step: int, index: int, chunk: bool) -> int:
    """The key of a pipelined text forward's draws
    (``parallel.pipeline.stream_generator``): the step's seed with the data
    index (the direct step) or the GradCache chunk (``chunk``), so the
    ranks of a pipe line draw alike and a chunk's re-forward draws its
    first pass's masks."""
    return pipeline.splitmix64(
        ((seed & 0x7FFFFFFF) << 32) | (step & 0xFFFFFFFF), 1 + int(chunk),
        index)


def make_mi_step_body(model: ImageReportModel, txs: MIOptimizers, cfg,
                      data_shards: int = 1, mesh=None) -> Callable:
    """(state, batch) -> (state, loss): forward, pair scores, bound,
    backward and the three optimizer updates, directly or, with
    ``cfg.grad_cache_chunks`` > 1, in GradCache's two passes.  ``batch``:
    the compact layout (uint8/uint16 images, uint16 ids, uint8 masks and
    segments, int64 ``study_id``) or already wide tensors, on the model's
    device; in a world (``mesh``), this rank's rows of the global batch.
    ``data_shards`` > 1 with ``cfg.global_negatives`` False: negatives
    only within each of that many contiguous blocks of the global batch,
    the loss the mean over the blocks (JAX mi.py:189-199).  A 'pipe' axis
    pipelines the text tower (the module's doc); the state must be placed
    by ``parallel.mesh.shard_mi_state``."""
    estimator = cfg.mi_estimator
    score_fn = pairwise_critic_scores_pallas if cfg.use_pallas_critic \
        else pairwise_critic_scores
    chunks = max(1, int(cfg.grad_cache_chunks))
    world = mesh_lib.mesh_size(mesh)        # the 'data' axis
    tp = mesh is not None and mesh.tp
    pp = pipeline.pipeline_stage_count(mesh) > 1
    if pp:      # the configuration's errors before any step
        pipeline.stage_layers(model.bert_config.num_hidden_layers, mesh)
        microbatches = pipeline.microbatch_count(cfg.pipeline_microbatches,
                                                 mesh)
    if tp:
        score_fn = lambda p, a, b: tp_critic_scores(  # noqa: E731
            p, a, b, mesh, use_pallas=cfg.use_pallas_critic)
    blocks = 1 if cfg.global_negatives else max(1, int(data_shards))
    if blocks > 1 and blocks % world:
        logger.warning(
            "global_negatives=False with %d data shards does not divide "
            "over %d ranks — computing GLOBAL negatives instead", blocks,
            world)
        blocks = 1
    rank_blocks = blocks // world
    gad = cfg.grad_allreduce_dtype
    reduce_dtype = None
    if gad not in ("float32", ""):
        # composes with zero1 / fsdp, not with tp / sp (JAX mi.py:384-405)
        if gad == "bfloat16" and world > 1 and not tp and not pp \
                and chunks == 1 and blocks == 1 \
                and not cfg.sequence_parallel:
            reduce_dtype = torch.bfloat16
        else:
            logger.warning(
                "grad_allreduce_dtype=%s requested but unsupported with "
                "this mesh/knob combination (needs a 'data' mesh without "
                "tp/pp/sp, global negatives, no grad-cache; zero1/fsdp "
                "are fine) — keeping the float32 all-reduce", gad)

    def loss_from_embeddings(critic_params, emb_img, emb_txt, sids):
        """Embeddings -> (the objective to differentiate, the step's loss),
        shared by both bodies (mi.py:217-235).  Global negatives: the
        world's embeddings gathered, one bound of the whole batch on every
        rank.  Local negatives: this rank's blocks; the loss is the mean
        over the world's blocks, and this rank differentiates its 1/N
        share of it."""
        if blocks > 1:
            n, rows = rank_blocks, emb_img.shape[0]
            if rows % n == 0:
                b = rows // n
                local = torch.stack([bound_from_scores(
                    estimator, score_fn(critic_params, emb_img[i * b:(i + 1) * b],
                                        emb_txt[i * b:(i + 1) * b]),
                    sids[i * b:(i + 1) * b]) for i in range(n)]).mean()
                if world == 1:
                    return local, local
                loss = local.detach().clone()
                mesh_lib.all_reduce_([loss], mesh)
                return local / world, loss / world
            logger.warning(
                "global_negatives=False requested but batch %d is not "
                "divisible by %d blocks — computing GLOBAL negatives "
                "instead", rows, n)
        emb_img = mesh_lib.gather_rows(emb_img, mesh)
        emb_txt = mesh_lib.gather_rows(emb_txt, mesh)
        with torch.no_grad():
            sids = mesh_lib.gather_rows(sids, mesh)
        loss = bound_from_scores(estimator,
                                 score_fn(critic_params, emb_img, emb_txt),
                                 sids)
        return loss, loss

    def sync_grads(tower_grads: list, critic_grads: list) -> None:
        """The gradients over the 'data' axis: the towers' shares summed;
        the critic's, computed in full on every data index, taken from
        data index 0 (summed and averaged in bfloat16 with the bfloat16
        all-reduce, as JAX's pmean; summed with local negatives, where
        each rank holds a share).  Nothing is summed over 'model' here
        (parallel/mesh.py's rule)."""
        if world == 1:
            return
        if blocks > 1:
            mesh_lib.all_reduce_(tower_grads + critic_grads, mesh)
            return
        mesh_lib.all_reduce_(tower_grads, mesh, dtype=reduce_dtype)
        if reduce_dtype is not None:
            mesh_lib.all_reduce_(critic_grads, mesh, dtype=reduce_dtype,
                                 scale=world)
        else:
            mesh_lib.broadcast_(critic_grads, mesh, axis=mesh_lib.DATA_AXIS)

    def sync_stage0(text_grads: dict) -> None:
        """Under a pipeline: the embeddings' gradients, which stage 0 alone
        computes, from stage 0 to its pipe line (after the 'data' sum)."""
        if pp:
            mesh_lib.broadcast_(
                [g for n, g in text_grads.items()
                 if n.startswith("bert.embeddings.")], mesh, src=0,
                axis=mesh_lib.PIPE_AXIS)

    def embed(batch, generator, key: int):
        """One towers' forward in train mode; decompacts here so that a
        GradCache chunk widens only its own images.  Returns the two
        embeddings and, under a pipeline, the stage's ``StageRun`` (the
        text tower's draws keyed on ``key``), else None."""
        wide = decompact_batch(batch)
        if not pp:
            emb_img, emb_txt, _, _ = model(
                wide["image"], wide["txt_ids"], wide["txt_masks"],
                wide["txt_segments"], train=True, generator=generator)
            return emb_img, emb_txt, None
        # every pipe rank runs the image tower whole (JAX replicates it
        # over 'pipe'); the text tower runs the schedule
        _, emb_img, _, _, _ = model.image_model(wide["image"], train=True)
        emb_txt, _, run = pipeline.pipelined_textbert_apply(
            model.text_model, mesh, wide["txt_ids"], wide["txt_segments"],
            wide["txt_masks"], num_microbatches=microbatches,
            deterministic=False, key=key)
        return emb_img, emb_txt, run

    def check_placed(state: MITrainState) -> None:
        layout = _layout(state, "text_model")
        if pp and (layout is None or layout.pipe is None):
            raise ValueError("a 'pipe' mesh needs the state placed by "
                             "parallel.mesh.shard_mi_state (the stages' "
                             "text layers)")

    def groups_of(state: MITrainState) -> list:
        """The three parameter groups, whole (FSDP slices gathered)."""
        params = state.params
        groups = [params["image_model"], params["text_model"],
                  critic_dict(state.critic_params)]
        for g, name in zip(groups, GROUPS):
            mesh_lib.gather_params(g, _layout(state, name), mesh)
        return groups

    def finish_step(state: MITrainState, loss, groups, grads):
        """The three optimizer updates (main_utils.py:226-230), on the
        'data' slices of a placed state."""
        img_g, txt_g, mi_g = grads
        apply = lambda p, u: apply_updates(p, u)  # noqa: E731 - late bound
        state.img_opt = mesh_lib.sharded_update(
            txs.img, img_g, state.img_opt, groups[0],
            _layout(state, "image_model"), mesh, apply)
        state.txt_opt = mesh_lib.sharded_update(
            txs.txt, txt_g, state.txt_opt, groups[1],
            _layout(state, "text_model"), mesh, apply)
        state.mi_opt = mesh_lib.sharded_update(
            txs.mi, mi_g, state.mi_opt, groups[2], _layout(state, "critic"),
            mesh, apply)
        state.step += 1
        return state, loss.detach()

    def step_body(state: MITrainState, batch: dict):
        check_placed(state)
        device = next(model.parameters()).device
        groups = groups_of(state)
        # BatchNorm over the 'data' axis, as one rank's over the global batch
        set_bn_axis(model.image_model, mesh if world > 1 else None)
        # the ranks of a data row share their masks (each applies its part)
        gen = step_generator(cfg.seed, state.step, device) if world == 1 \
            else rank_generator(cfg.seed, state.step, mesh.data_rank, device)
        emb_img, emb_txt, run = embed(
            batch, gen, pp and pipe_key(cfg.seed, state.step, mesh.data_rank,
                                        chunk=False))
        objective, loss = loss_from_embeddings(
            state.critic_params, emb_img, emb_txt, batch["study_id"])
        names = [(gi, n) for gi, g in enumerate(groups) for n in g]
        flat = [groups[gi][n] for gi, n in names]
        grads = [{}, {}, {}]
        got = torch.autograd.grad(objective, flat + ([run.cls] if pp else []),
                                  allow_unused=True)
        # parameters off the loss's path (BERT classifier, ResNet fc1) get
        # zeros, as JAX hands optax: adamw_hf still decays them
        for (gi, n), t, g in zip(names, flat, got):
            grads[gi][n] = torch.zeros_like(t) if g is None else g
        if pp:      # the reverse pipeline from the [CLS] rows' gradient
            grads[1].update(run.backward(got[-1]))
        sync_grads([g for gi in (0, 1) for g in grads[gi].values()],
                   list(grads[2].values()))
        sync_stage0(grads[1])
        return finish_step(state, loss, groups, grads)

    # GradCache over the world: each rank runs its share of the global
    # batch's chunks (their indices offset by the rank)
    local_chunks = chunks
    if chunks > 1 and world > 1:
        if chunks % world:
            logger.warning(
                "grad_cache_chunks=%d is not a multiple of the %d-rank "
                "world — each rank runs %d chunks of its rows, so the "
                "BatchNorm statistics differ from one rank's", chunks, world,
                max(1, chunks // world))
        local_chunks = max(1, chunks // world)
    first_chunk = 0 if mesh is None else mesh.data_rank * local_chunks

    def grad_cache_body(state: MITrainState, batch: dict):
        """GradCache (Gao et al. 2021), JAX's grad_cache_body: chunk c
        draws from ``chunk_generator(seed, step, c)`` in both passes and
        sees the step's BatchNorm running statistics, which end as the
        mean of the chunks' updates (a data-parallel replica's semantics)."""
        check_placed(state)
        size = batch["image"].shape[0]
        if size % local_chunks:
            logger.warning(
                "grad_cache_chunks=%d does not divide batch %d — falling "
                "back to the direct (single-pass) step for this batch "
                "shape", local_chunks, size)
            return step_body(state, batch)
        device = next(model.parameters()).device
        groups = groups_of(state)
        # each chunk's statistics are its own rows', as on one rank
        set_bn_axis(model.image_model, None)
        rows = [slice(c * size // local_chunks, (c + 1) * size // local_chunks)
                for c in range(local_chunks)]
        parts = [{k: v[r] for k, v in batch.items()} for r in rows]
        # a fresh generator per chunk and pass: pass 2 draws pass 1's masks
        gens = lambda: (chunk_generator(cfg.seed, state.step, first_chunk + c,
                                        device)
                        for c in range(local_chunks))
        keys = [pp and pipe_key(cfg.seed, state.step, first_chunk + c,
                                chunk=True) for c in range(local_chunks)]
        # _norm updates the running buffers in place where JAX returns new
        # ones: reset them before each chunk, then set them to the mean
        stats = list(state.batch_stats.values())
        start = [t.clone() for t in stats]
        total = [torch.zeros_like(t) for t in stats]

        # pass 1: embeddings only, no graph kept
        embs = []
        with torch.no_grad():
            for part, gen, key in zip(parts, gens(), keys):
                for t, s in zip(stats, start):
                    t.copy_(s)
                embs.append(embed(part, gen, key)[:2])
                for tot, t in zip(total, stats):
                    tot.add_(t)
        mesh_lib.all_reduce_(total, mesh)
        for t, tot in zip(stats, total):
            t.copy_(tot / (local_chunks * world))
        mean = [t.clone() for t in stats]
        emb_img = torch.cat([e[0] for e in embs]).requires_grad_()
        emb_txt = torch.cat([e[1] for e in embs]).requires_grad_()
        del embs

        # the bound over the whole batch: critic and embedding gradients
        # (this rank's rows of the latter)
        objective, loss = loss_from_embeddings(
            state.critic_params, emb_img, emb_txt, batch["study_id"])
        *critic_g, g_img, g_txt = torch.autograd.grad(
            objective, [*groups[2].values(), emb_img, emb_txt])

        # pass 2: each chunk's re-forward takes its rows of the embedding
        # gradients back to the towers' parameters, into one set of buffers
        tower = [(gi, n, t) for gi in (0, 1) for n, t in groups[gi].items()]
        acc = [torch.zeros_like(t) for _, _, t in tower]
        text_acc = {n: a for (gi, n, _), a in zip(tower, acc) if gi == 1}
        for r, part, gen, key in zip(rows, parts, gens(), keys):
            ei, et, run = embed(part, gen, key)
            for t, m in zip(stats, mean):   # pass 1 set the statistics
                t.copy_(m)
            got = torch.autograd.grad(
                (ei, et), [t for _, _, t in tower] + ([run.cls] if pp else []),
                grad_outputs=(g_img[r].to(ei.dtype), g_txt[r].to(et.dtype)),
                allow_unused=True)
            for a, g in zip(acc, got):
                if g is not None:   # off the path: stays zero, as in JAX
                    a.add_(g)
            if pp:      # this chunk's reverse pipeline
                for n, g in run.backward(got[-1]).items():
                    text_acc[n].add_(g)
            del ei, et, run
        sync_grads(acc, critic_g)
        sync_stage0(text_acc)
        grads = [{}, {}, dict(zip(groups[2], critic_g))]
        for (gi, n, _), a in zip(tower, acc):
            grads[gi][n] = a
        return finish_step(state, loss, groups, grads)

    return grad_cache_body if chunks > 1 else step_body


GROUPS = ("image_model", "text_model", "critic")


def _layout(state: MITrainState, group: str):
    return None if state.layout is None else state.layout.groups.get(group)


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


def mi_state_tree(state: MITrainState) -> dict:
    """What a step needs to continue bit for bit: the towers' state dicts
    (BatchNorm running statistics included), the critic, the three
    optimizer states (moments in their own dtypes) and ``step``.  No
    generator state: a step's generators are seeded from (seed, step)
    (``step_generator``, ``chunk_generator``) and the loader's from (seed,
    epoch, index).  The whole tensors whatever the state's placement: TP
    pieces, ZeRO-1 moments, FSDP parameters and the pipeline stages'
    layers are gathered, so the tree is the plain one (every rank of a
    world calls it)."""
    mesh = None if state.layout is None else state.layout.mesh
    tree = {"step": int(state.step)}
    for name, module, opt in (
            ("image_model", state.model.image_model, "img_opt"),
            ("text_model", state.model.text_model, "txt_opt"),
            ("critic", None, "mi_opt")):
        params = critic_dict(state.critic_params) if module is None \
            else dict(module.named_parameters())
        full, tree[opt] = mesh_lib.full_group(params, getattr(state, opt),
                                              _layout(state, name), mesh)
        tree[opt] = state_to_tree(tree[opt])
        if module is None:
            tree[name] = [{k: full[f"{i}.{k}"] for k in layer}
                          for i, layer in enumerate(state.critic_params)]
        else:
            sd = module.state_dict()
            tree[name] = {k: full.get(k, v) for k, v in sd.items()}
    return tree


def restore_mi_state(model: ImageReportModel, cfg, txs: MIOptimizers,
                     tree: dict) -> MITrainState:
    """A state on ``model`` from ``mi_state_tree``'s tree (a resume
    checkpoint's): the weights loaded ``strict=True``, the optimizer states
    and ``step`` as saved."""
    state = create_mi_state(model, cfg, txs, None, weights=tree)
    device = next(model.parameters()).device
    state.img_opt = state_from_tree(tree["img_opt"], device)
    state.mi_opt = state_from_tree(tree["mi_opt"], device)
    state.txt_opt = state_from_tree(tree["txt_opt"], device)
    state.step = int(tree["step"])
    return state


def save_mi_checkpoints(save_dir: str, state: MITrainState, epoch: int,
                        bert_config: BertConfig,
                        export_torch_bins: bool = True,
                        ckpt_format: str = "pickle") -> str:
    """The resume checkpoint ``mi_epoch<N>.ckpt`` (``mi_state_tree``, in
    ``ckpt_format``; a world of several ranks writes the sharded
    directory, every rank its share), ``config.json`` (rank 0) and the
    reference ``.bin`` contracts (model.py:557-595):
    ``pytorch_MI_image_model.bin``, ``pytorch_MI_text_model.bin`` and the
    joint ``pytorch_model_epoch<N>.bin``, which a world of several ranks
    leaves to ``tools/convert_checkpoint.py``.  Returns the resume
    checkpoint's path."""
    os.makedirs(save_dir, exist_ok=True)
    path = ckpt.save_checkpoint(os.path.join(save_dir,
                                             f"mi_epoch{epoch}.ckpt"),
                                mi_state_tree(state), format=ckpt_format)
    if mesh_lib.world_rank() == 0:
        # the converter reads the BERT's depth from it
        bert_config.to_json_file(os.path.join(save_dir, "config.json"))
    if export_torch_bins and mesh_lib.world_size() > 1:
        logger.warning(".bin export skipped on a world of %d ranks — "
                       "write them from %s with python -m "
                       "mimm_tpu_torch.tools.convert_checkpoint --kind mi",
                       mesh_lib.world_size(), path)
        export_torch_bins = False
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
    return path


def _check_manager(cfg) -> None:
    """The Manager's knobs raise before anything is written."""
    if cfg.checkpoint_format not in ckpt.FORMATS:
        raise ValueError(f"checkpoint_format {cfg.checkpoint_format!r} is "
                         f"not one of {ckpt.FORMATS}")


def _epoch_loss(step_losses: list) -> float:
    """The sum of an epoch's step losses, read from the device once, added
    as JAX adds them (each dispatch's sum, then over dispatches)."""
    if not step_losses:
        return 0.0
    flat = torch.cat([t.reshape(-1) for t in step_losses]).cpu().numpy()
    parts = np.split(flat, np.cumsum([t.numel() for t in step_losses])[:-1])
    return float(sum(np.sum(p) for p in parts))


class MultiModalManager:
    """The reference-shaped trainer (main_utils.py:53-78; JAX
    mimm_tpu/train/mi.py:633-859): the joint model on ``device`` and, with
    ``load_pretrained_bert``, the pytorch_transformers BERT of
    ``cfg.bert_pretrained_dir`` over its text tower."""

    def __init__(self, cfg, bert_config: Optional[BertConfig] = None,
                 load_pretrained_bert: bool = True, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.bert_config = bert_config or load_bert_config(cfg)
        self.model = build_joint_model(cfg, self.bert_config,
                                       device=self.device)
        self.bert_state_dict = None
        if load_pretrained_bert:
            self.bert_state_dict = ckpt.load_bert_pytorch_bin(
                cfg.bert_pretrained_dir)
            if self.bert_state_dict is None:
                logger.warning("No pretrained BERT weights found in %s — "
                               "random init", cfg.bert_pretrained_dir)

    def train(self, token_features, dataset=None, mesh=None,
              num_epochs: Optional[int] = None,
              export_torch_bins: bool = True,
              resume_from: Optional[str] = None,
              stop_after_epoch: Optional[int] = None) -> MITrainState:
        """``num_epochs`` epochs (default ``cfg.num_train_epochs``) over
        ``dataset`` (the paired-dataset interface of data/pipeline.py), by
        default the on-disk ``CXRImageReportDataset`` of
        ``token_features`` (a TokenFeatureSet), ``cfg.image_dir`` and
        ``cfg.dataset_metadata``, through the crop cache
        ``cfg.decoded_crop_cache`` names.  Per epoch: the loader's stream,
        grouped into ``cfg.scan_steps`` chunks, copied to the card
        ``cfg.prefetch`` batches ahead; the step losses stay on the device
        and are read once at the epoch's end.  Checkpoints
        (``save_mi_checkpoints``) every ``cfg.checkpoint_every_epochs``
        epochs, after the last, and when ``stop_after_epoch`` ends the run
        early while the schedule keeps ``num_epochs``; with
        ``cfg.keep_checkpoints`` > 0 only that many ``mi_epoch<N>.ckpt``
        stay.  After every dispatch a pending preemption
        (``preempt.should_stop()``) saves ``mi_preempt.ckpt``, writes
        ``preempted=1`` to ``mi.jsonl`` and returns.  ``resume_from``: a
        resume checkpoint, continued at its step, mid-epoch with the
        epoch's remaining dispatches in the uninterrupted run's order.

        ``mesh`` (default ``make_mesh(cfg.mesh_shape,
        cfg.dcn_mesh_shape)``, the world): each data index decodes its
        slice of every global batch of ``cfg.batch_size`` rows (the ranks
        of one data index over 'model' and 'pipe' the same rows), rank 0's
        state is broadcast and placed (``shard_mi_state``: TP with a
        'model' axis, the stages' text layers with a 'pipe' axis,
        ``cfg.zero1_optimizer_sharding``,
        ``cfg.fsdp_parameter_sharding``; ``cfg.sequence_parallel``),
        preemption is agreed on every 8 dispatches
        (``should_stop(sync=True)``), saves are the sharded format every
        rank writes (the whole tensors), and rank 0 alone writes metrics,
        ``config.json``, the plot and prunes."""
        cfg = self.cfg
        _check_manager(cfg)
        mesh = mesh or mesh_lib.make_mesh(dict(cfg.mesh_shape) or None,
                                          dict(cfg.dcn_mesh_shape) or None)
        primary = mesh.rank == 0
        os.makedirs(cfg.save_directory, exist_ok=True)
        writer = MetricWriter(cfg.save_directory, name="mi",
                              log_filename="training_MI.log",
                              tensorboard=cfg.tensorboard)
        num_epochs = num_epochs or cfg.num_train_epochs
        if dataset is None:
            dataset = CXRImageReportDataset(
                token_features, cfg.image_dir, cfg.dataset_metadata,
                img_size=cfg.img_size, compact=cfg.compact_transfer,
                crop_cache=crop_cache.from_config(cfg))
        buckets = list(cfg.seq_buckets or ()) or None
        if buckets and max(buckets) < cfg.max_seq_length:
            # a longer report would be cut to the largest bucket; a bucket
            # of max_seq_length keeps its tokens
            logger.warning(
                "seq_buckets max %d < max_seq_length %d: adding a %d "
                "bucket so longer reports keep their full tokens",
                max(buckets), cfg.max_seq_length, cfg.max_seq_length)
            buckets.append(cfg.max_seq_length)
        loader = Loader(dataset, batch_size=cfg.batch_size, seed=cfg.seed,
                        bucket_lengths=buckets,
                        num_workers=cfg.data_loader_workers,
                        process_count=mesh.data,
                        process_index=mesh.data_rank)
        logger.info("Total number of training image-report pairs: %d",
                    len(dataset))
        # under bucketing each bucket drops its own remainder: the
        # schedule's t_total and the resumed epoch count the batches the
        # loader yields
        steps_per_epoch = max(1, loader.batches_per_epoch())
        txs = make_optimizers(cfg, steps_per_epoch=steps_per_epoch,
                              num_epochs=num_epochs)
        start_epoch, start_batch = 0, 0
        if resume_from is None:
            state = create_mi_state(self.model, cfg, txs,
                                    torch.Generator().manual_seed(cfg.seed),
                                    bert_state_dict=self.bert_state_dict)
        else:
            state = restore_mi_state(self.model, cfg, txs,
                                     ckpt.load_checkpoint(resume_from))
            start_epoch, start_batch = divmod(state.step, steps_per_epoch)
            logger.info("Resumed from %s at step %d (epoch %d, batch %d)",
                        resume_from, state.step, start_epoch, start_batch)
        state = mesh_lib.shard_mi_state(
            mesh, state, zero1=cfg.zero1_optimizer_sharding,
            fsdp=cfg.fsdp_parameter_sharding,
            sequence_parallel=cfg.sequence_parallel)
        data_shards = 1 if cfg.global_negatives else mesh.data
        train_step = make_mi_train_step(self.model, txs, cfg,
                                        data_shards=data_shards, mesh=mesh)
        scan_steps = max(1, int(cfg.scan_steps))
        multi_step = make_mi_multi_step(self.model, txs, cfg,
                                        data_shards=data_shards, mesh=mesh) \
            if scan_steps > 1 else None
        fmt = cfg.checkpoint_format
        preempt_sync = mesh.size > 1

        training_loss = []
        profiler = StepProfiler(os.path.join(cfg.save_directory, "profile"),
                                cfg.profile_steps if primary else 0)
        for epoch in range(start_epoch, num_epochs):
            start = time.time()
            step_losses = []
            stream = self._epoch_stream(loader, epoch, scan_steps,
                                        start_batch if epoch == start_epoch
                                        else 0)
            profiler.start()
            for batch in device_prefetch(stream, size=cfg.prefetch,
                                         device=self.device):
                if batch["image"].dim() == 5:       # a stacked scan chunk
                    state, loss = multi_step(state, batch)
                else:
                    state, loss = train_step(state, batch)
                step_losses.append(loss)
                profiler.step(loss)
                if preempt.should_stop(sync=preempt_sync):
                    # SIGTERM: the whole state, and stop; resume_from this
                    # file continues mid-epoch
                    profiler.close()
                    path = ckpt.save_checkpoint(
                        os.path.join(cfg.save_directory, "mi_preempt.ckpt"),
                        mi_state_tree(state), format=fmt)
                    logger.warning("preemption requested — saved %s at step "
                                   "%d and stopping", path, state.step)
                    writer.write(step=state.step, preempted=1)
                    writer.close()
                    ckpt.wait_for_async_saves()
                    return state
            profiler.close(step_losses[-1] if step_losses else None)
            epoch_loss = _epoch_loss(step_losses)
            training_loss.append(epoch_loss)

            every = max(1, int(cfg.checkpoint_every_epochs))
            stopping = stop_after_epoch is not None \
                and epoch + 1 >= stop_after_epoch
            path = None
            if (epoch + 1) % every == 0 or epoch + 1 == num_epochs or stopping:
                path = save_mi_checkpoints(cfg.save_directory, state,
                                           epoch + 1, self.bert_config,
                                           export_torch_bins=export_torch_bins,
                                           ckpt_format=fmt)
                if int(cfg.keep_checkpoints) > 0:
                    ckpt.wait_for_async_saves()    # never prune in flight
                    if primary:
                        ckpt.prune_checkpoints(cfg.save_directory, "mi_epoch",
                                               int(cfg.keep_checkpoints))
            writer.epoch_summary(epoch + 1, epoch_loss, time.time() - start,
                                 path)
            if loader.skipped:
                writer.write(epoch=epoch + 1, skipped_records=loader.skipped)
            if stopping:
                logger.info("stop_after_epoch=%d reached (schedule t_total "
                            "stays %d epochs) — checkpointed and stopping",
                            stop_after_epoch, num_epochs)
                break

        if primary:
            Plot_Training("Epochs", "Value for Loss", "MI training",
                          [training_loss], ["train loss"],
                          os.path.join(cfg.save_directory,
                                       "mutual_information_training.png"))
        writer.close()
        ckpt.wait_for_async_saves()
        return state

    def _epoch_stream(self, loader: Loader, epoch: int, scan_steps: int,
                      steps_done: int):
        """The epoch's dispatches: the loader's stream in ``scan_steps``
        chunks, or after ``steps_done`` steps of a resumed epoch the rest
        in the uninterrupted order (``resume_chunks``).  A checkpoint that
        does not end a dispatch of this ``scan_steps`` (written with
        another) resumes as JAX's Manager does: batches ``steps_done:`` of
        the stream, chunked anew."""
        if steps_done:
            try:
                return resume_chunks(loader, epoch, steps_done, scan_steps,
                                     max_len=self.cfg.max_seq_length)
            except ValueError as e:
                logger.warning("%s: resuming at batch %d of the stream",
                               e, steps_done)
                stream = loader.epoch(epoch, start_batch=steps_done)
        else:
            stream = loader.epoch(epoch)
        return scan_chunks(stream, scan_steps) if scan_steps > 1 else stream
