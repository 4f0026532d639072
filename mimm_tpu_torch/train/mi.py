"""The multimodal mutual-information train step (mimm_tpu/train/mi.py
counterpart, the direct step body :277-370).

One step: the joint ResNet + BERT forward to 768-d embeddings, the (B, B)
critic scores, the DV (or InfoNCE) bound over the diagonal positives and
the study-id-masked negatives, the backward, and three optimizer updates:
Adam on the image tower, Adam on the critic, pytorch_transformers AdamW
with warmup-linear on the text tower (reference main_utils.py:151-230).

Entry points: ``MultiModalManager(cfg).train(None, dataset=...)``, the
epoch loop a user trains with (:633-859), and beneath it, as the JAX bench
drives them, ``create_mi_state`` -> ``make_mi_train_step`` /
``make_mi_multi_step`` -> ``save_mi_checkpoints``.
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

Left to later slices, and raising ``NotImplementedError`` when asked for:
the mesh and parallel modes (pp, ZeRO-1, FSDP, sequence parallelism, bf16
gradient all-reduce, per-shard negatives), the native resume checkpoint
and what rests on it (resume, pruning, other formats), the on-disk
datasets, and the profiler and TensorBoard hooks of the Manager.
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
from mimm_tpu_torch import resolve_device
from mimm_tpu_torch.data.pipeline import Loader, device_prefetch, scan_chunks
from mimm_tpu_torch.metrics import MetricWriter, Plot_Training
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
_PARALLEL = "comes with the parallel slice (ROADMAP.md queue A, item 9)"


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
    ``s2d_stem`` is a TPU schedule of the canonical stem and runs as it;
    ``pallas_stem`` runs the stem on the shallow-conv kernels (the two are
    exclusive, as in JAX)."""
    if mesh is not None or cfg.sequence_parallel:
        raise NotImplementedError(f"a mesh / sequence parallelism {_PARALLEL}")
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


def make_mi_step_body(model: ImageReportModel, txs: MIOptimizers, cfg,
                      data_shards: int = 1, mesh=None) -> Callable:
    """(state, batch) -> (state, loss): forward, pair scores, bound,
    backward and the three optimizer updates, directly or, with
    ``cfg.grad_cache_chunks`` > 1, in GradCache's two passes.  ``batch``:
    the compact layout (uint8/uint16 images, uint16 ids, uint8 masks and
    segments, int64 ``study_id``) or already wide tensors, on the model's
    device."""
    _check_slice(cfg, data_shards, mesh)
    estimator = cfg.mi_estimator
    score_fn = pairwise_critic_scores_pallas if cfg.use_pallas_critic \
        else pairwise_critic_scores
    chunks = max(1, int(cfg.grad_cache_chunks))

    def loss_from_embeddings(critic_params, emb_img, emb_txt, sids):
        """Embeddings -> bound, shared by both bodies (mi.py:217-235)."""
        return bound_from_scores(
            estimator, score_fn(critic_params, emb_img, emb_txt), sids)

    def embed(batch, generator):
        """One towers' forward in train mode; decompacts here so that a
        GradCache chunk widens only its own images."""
        wide = decompact_batch(batch)
        emb_img, emb_txt, _, _ = model(
            wide["image"], wide["txt_ids"], wide["txt_masks"],
            wide["txt_segments"], train=True, generator=generator)
        return emb_img, emb_txt

    def groups_of(state: MITrainState) -> list:
        params = state.params
        return [params["image_model"], params["text_model"],
                critic_dict(state.critic_params)]

    def finish_step(state: MITrainState, loss, groups, grads):
        """The three optimizer updates (main_utils.py:226-230)."""
        img_g, txt_g, mi_g = grads
        img_u, state.img_opt = txs.img.update(img_g, state.img_opt, groups[0])
        txt_u, state.txt_opt = txs.txt.update(txt_g, state.txt_opt, groups[1])
        mi_u, state.mi_opt = txs.mi.update(mi_g, state.mi_opt, groups[2])
        for group, upd in zip(groups, (img_u, txt_u, mi_u)):
            apply_updates(group, upd)
        state.step += 1
        return state, loss.detach()

    def step_body(state: MITrainState, batch: dict):
        device = next(model.parameters()).device
        emb_img, emb_txt = embed(batch, step_generator(cfg.seed, state.step,
                                                       device))
        loss = loss_from_embeddings(state.critic_params, emb_img, emb_txt,
                                    batch["study_id"])
        groups = groups_of(state)
        names = [(gi, n) for gi, g in enumerate(groups) for n in g]
        flat = [groups[gi][n] for gi, n in names]
        grads = [{}, {}, {}]
        # parameters off the loss's path (BERT classifier, ResNet fc1) get
        # zeros, as JAX hands optax: adamw_hf still decays them
        for (gi, n), t, g in zip(names, flat, torch.autograd.grad(
                loss, flat, allow_unused=True)):
            grads[gi][n] = torch.zeros_like(t) if g is None else g
        return finish_step(state, loss, groups, grads)

    def grad_cache_body(state: MITrainState, batch: dict):
        """GradCache (Gao et al. 2021), JAX's grad_cache_body: chunk c
        draws from ``chunk_generator(seed, step, c)`` in both passes and
        sees the step's BatchNorm running statistics, which end as the
        mean of the chunks' updates (a data-parallel replica's semantics)."""
        size = batch["image"].shape[0]
        if size % chunks:
            logger.warning(
                "grad_cache_chunks=%d does not divide batch %d — falling "
                "back to the direct (single-pass) step for this batch "
                "shape", chunks, size)
            return step_body(state, batch)
        device = next(model.parameters()).device
        rows = [slice(c * size // chunks, (c + 1) * size // chunks)
                for c in range(chunks)]
        parts = [{k: v[r] for k, v in batch.items()} for r in rows]
        # a fresh generator per chunk and pass: pass 2 draws pass 1's masks
        gens = lambda: (chunk_generator(cfg.seed, state.step, c, device)
                        for c in range(chunks))
        # _norm updates the running buffers in place where JAX returns new
        # ones: reset them before each chunk, then set them to the mean
        stats = list(state.batch_stats.values())
        start = [t.clone() for t in stats]
        total = [torch.zeros_like(t) for t in stats]

        # pass 1: embeddings only, no graph kept
        embs = []
        with torch.no_grad():
            for part, gen in zip(parts, gens()):
                for t, s in zip(stats, start):
                    t.copy_(s)
                embs.append(embed(part, gen))
                for tot, t in zip(total, stats):
                    tot.add_(t)
        for t, tot in zip(stats, total):
            t.copy_(tot / chunks)
        mean = [t.clone() for t in stats]
        emb_img = torch.cat([e[0] for e in embs]).requires_grad_()
        emb_txt = torch.cat([e[1] for e in embs]).requires_grad_()
        del embs

        # the bound over the whole batch: critic and embedding gradients
        groups = groups_of(state)
        loss = loss_from_embeddings(state.critic_params, emb_img, emb_txt,
                                    batch["study_id"])
        *critic_g, g_img, g_txt = torch.autograd.grad(
            loss, [*groups[2].values(), emb_img, emb_txt])

        # pass 2: each chunk's re-forward takes its rows of the embedding
        # gradients back to the towers' parameters, into one set of buffers
        tower = [(gi, n, t) for gi in (0, 1) for n, t in groups[gi].items()]
        acc = [torch.zeros_like(t) for _, _, t in tower]
        for r, part, gen in zip(rows, parts, gens()):
            ei, et = embed(part, gen)
            for t, m in zip(stats, mean):   # pass 1 set the statistics
                t.copy_(m)
            for a, g in zip(acc, torch.autograd.grad(
                    (ei, et), [t for _, _, t in tower],
                    grad_outputs=(g_img[r].to(ei.dtype),
                                  g_txt[r].to(et.dtype)),
                    allow_unused=True)):
                if g is not None:   # off the path: stays zero, as in JAX
                    a.add_(g)
            del ei, et
        grads = [{}, {}, dict(zip(groups[2], critic_g))]
        for (gi, n, _), a in zip(tower, acc):
            grads[gi][n] = a
        return finish_step(state, loss, groups, grads)

    return grad_cache_body if chunks > 1 else step_body


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
    The native resume checkpoint is a later slice (ROADMAP.md queue A,
    the `checkpoint.py` item)."""
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


_RESUME = ("comes with the native resume checkpoint (ROADMAP.md queue A, "
           "item 5)")


def _check_manager(cfg, dataset, mesh, resume_from) -> None:
    """The Manager's knobs of later slices raise before anything is
    written."""
    if dataset is None:
        raise NotImplementedError(
            "the on-disk datasets (CXRImageReportDataset, the transforms, the "
            "crop cache) come with a later slice (ROADMAP.md queue A, item "
            "4); pass dataset=")
    if mesh is not None or cfg.mesh_shape:
        raise NotImplementedError(f"a mesh {_PARALLEL}")
    if resume_from is not None or cfg.resume_from:
        raise NotImplementedError(f"resume_from / preemption {_RESUME}")
    if cfg.keep_checkpoints > 0:
        raise NotImplementedError(f"keep_checkpoints {_RESUME}")
    if cfg.checkpoint_format != "pickle":
        raise NotImplementedError(f"checkpoint_format "
                                  f"{cfg.checkpoint_format!r} {_RESUME}")
    if cfg.profile_steps > 0 or cfg.tensorboard:
        raise NotImplementedError("profile_steps and tensorboard come with "
                                  "the profiling slice (ROADMAP.md queue A, "
                                  "item 10)")


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
        ``dataset`` (the paired-dataset interface of data/pipeline.py).
        Per epoch: the loader's stream, grouped into ``cfg.scan_steps``
        chunks, copied to the card ``cfg.prefetch`` batches ahead; the step
        losses stay on the device and are read once at the epoch's end.
        Checkpoints (``save_mi_checkpoints``) every
        ``cfg.checkpoint_every_epochs`` epochs, after the last, and when
        ``stop_after_epoch`` ends the run early while the schedule keeps
        ``num_epochs``.  ``token_features`` feeds the on-disk dataset of a
        later slice and is not read."""
        del token_features
        cfg = self.cfg
        _check_manager(cfg, dataset, mesh, resume_from)
        os.makedirs(cfg.save_directory, exist_ok=True)
        writer = MetricWriter(cfg.save_directory, name="mi",
                              log_filename="training_MI.log",
                              tensorboard=cfg.tensorboard)
        num_epochs = num_epochs or cfg.num_train_epochs
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
                        num_workers=cfg.data_loader_workers)
        logger.info("Total number of training image-report pairs: %d",
                    len(dataset))
        # under bucketing each bucket drops its own remainder: the
        # schedule's t_total counts the batches the loader yields
        steps_per_epoch = max(1, loader.batches_per_epoch())
        txs = make_optimizers(cfg, steps_per_epoch=steps_per_epoch,
                              num_epochs=num_epochs)
        state = create_mi_state(self.model, cfg, txs,
                                torch.Generator().manual_seed(cfg.seed),
                                bert_state_dict=self.bert_state_dict)
        train_step = make_mi_train_step(self.model, txs, cfg)
        scan_steps = max(1, int(cfg.scan_steps))
        multi_step = make_mi_multi_step(self.model, txs, cfg) \
            if scan_steps > 1 else None

        training_loss = []
        for epoch in range(num_epochs):
            start = time.time()
            step_losses = []
            stream = loader.epoch(epoch)
            if scan_steps > 1:
                stream = scan_chunks(stream, scan_steps)
            for batch in device_prefetch(stream, size=cfg.prefetch,
                                         device=self.device):
                if batch["image"].dim() == 5:       # a stacked scan chunk
                    state, loss = multi_step(state, batch)
                else:
                    state, loss = train_step(state, batch)
                step_losses.append(loss)
            epoch_loss = _epoch_loss(step_losses)
            training_loss.append(epoch_loss)

            every = max(1, int(cfg.checkpoint_every_epochs))
            stopping = stop_after_epoch is not None \
                and epoch + 1 >= stop_after_epoch
            path = None
            if (epoch + 1) % every == 0 or epoch + 1 == num_epochs or stopping:
                path = save_mi_checkpoints(cfg.save_directory, state,
                                           epoch + 1, self.bert_config,
                                           export_torch_bins=export_torch_bins)
            writer.epoch_summary(epoch + 1, epoch_loss, time.time() - start,
                                 path)
            if loader.skipped:
                writer.write(epoch=epoch + 1, skipped_records=loader.skipped)
            if stopping:
                logger.info("stop_after_epoch=%d reached (schedule t_total "
                            "stays %d epochs) — checkpointed and stopping",
                            stop_after_epoch, num_epochs)
                break

        Plot_Training("Epochs", "Value for Loss", "MI training",
                      [training_loss], ["train loss"],
                      os.path.join(cfg.save_directory,
                                   "mutual_information_training.png"))
        writer.close()
        return state
