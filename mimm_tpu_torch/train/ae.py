"""The unimodal autoencoder trainer (mimm_tpu/train/ae.py counterpart,
the reference's UniModalManager, main_utils.py:594-703).

ResNetAE (2 residual blocks, 6 levels, z_dim 192, bottleneck 768,
multi-res skips), the MSE reconstruction loss, one Adam at ``init_lr``,
per-epoch checkpoints named ``encoder_<N>.bin`` / ``decoder_<N>.bin`` /
``autoencoder_path_<N>.bin`` beside the port's resume checkpoint
``ae_epoch<N>.ckpt``, the epoch losses in ``ae.jsonl`` and
``training_AE.log``, and the loss plot at the end.

Entry points: ``mimm_tpu_torch.cli.uni_modal`` (training from disk), and
beneath it ``train_auto_encoder(cfg)`` and, as the JAX tests drive them,
``build_ae_model`` -> ``create_ae_state`` -> ``make_ae_train_step`` ->
``save_ae_checkpoint``.  The state's module (parameters and BatchNorm
running statistics) is updated in place.

``cfg.grad_cache_chunks`` > 1 accumulates the gradient over equal chunks
of the batch (the MSE loss decomposes per sample): every chunk starts
from the same running statistics, and the new ones are the mean over the
chunks of each chunk's update; a batch the chunks do not divide takes the
single-pass step, with a warning.

The trainer traces its first ``cfg.profile_steps`` steps into
``<save_directory>/profile/`` (profiling.StepProfiler) and with
``cfg.tensorboard`` mirrors ``ae.jsonl`` into ``tb/ae/``.

In a world of ranks (``mesh``: parallel/mesh.py) each rank trains on its
rows of every global batch with BatchNorm's statistics over the world
(sync-BN), the gradient and the loss the world's means, so N ranks train
as one rank at N × the batch; with ``grad_cache_chunks`` a multiple of N
each rank runs its share of the global batch's chunks, each chunk's
statistics its own, as on one rank.  Saves are the sharded format, the
``.bin`` files then come from ``tools/convert_checkpoint.py``.  A 'model'
or a 'pipe' mesh axis replicates the trainer over its ranks, which take
their data index's rows.  ``cfg.zero1_optimizer_sharding`` rests the Adam moments and
``cfg.fsdp_parameter_sharding`` the parameters 'data'-split
(``parallel.mesh.shard_ae_state``); the update on the slices gives the
replicated update's bits, and the resume checkpoint holds the whole
tensors.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from mimm_tpu_torch import checkpoint as ckpt
from mimm_tpu_torch import preempt, resolve_device
from mimm_tpu_torch.data import crop_cache
from mimm_tpu_torch.data.pipeline import (CXRImageDataset, Loader,
                                          device_prefetch)
from mimm_tpu_torch.metrics import MetricWriter, Plot_Training
from mimm_tpu_torch.models.autoencoder import ResNetAE
from mimm_tpu_torch.models.resnet import set_bn_axis
from mimm_tpu_torch.ops.image_norm import device_normalize
from mimm_tpu_torch.parallel import mesh as mesh_lib
from mimm_tpu_torch.profiling import StepProfiler
from mimm_tpu_torch.train.optim import (GradientTransformation, adam_torch,
                                        state_from_tree, state_to_tree)

logger = logging.getLogger(__name__)

@dataclasses.dataclass
class AETrainState:
    """The model (its parameters, and the BatchNorm running statistics as
    buffers), the Adam state and the number of steps taken."""

    model: ResNetAE
    opt_state: object
    step: int = 0
    layout: Optional[mesh_lib.StateLayout] = None

    @property
    def params(self) -> dict:
        return dict(self.model.named_parameters())


def _running_stats(model: torch.nn.Module) -> dict:
    return {n: b for n, b in model.named_buffers()
            if not n.endswith("num_batches_tracked")}


def build_ae_model(cfg, device="cuda") -> ResNetAE:
    """The reference configuration (main_utils.py:600-605) in the config's
    compute dtype, on ``device``.  The reference uses ``output_channels``
    as the AE's INPUT channel count (default 1, grayscale); kept."""
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32
    model = ResNetAE(input_shape=(cfg.img_size, cfg.img_size,
                                  cfg.output_channels),
                     n_residual_blocks=2, n_levels=6, z_dim=192,
                     bottleneck_dim=192 * 4, use_multi_res_skips=True,
                     dtype=dtype)
    return model.to(resolve_device(device))


def _ae_tx(cfg) -> GradientTransformation:
    """The trainer's single Adam (reference main_utils.py:638), the moments
    in bfloat16 with ``cfg.adam_moment_dtype`` "bfloat16"."""
    mom = torch.bfloat16 if cfg.adam_moment_dtype == "bfloat16" else None
    return adam_torch(cfg.init_lr, moment_dtype=mom)


@torch.no_grad()
def init_ae_params(model: ResNetAE, generator: torch.Generator) -> None:
    """Random weights with the JAX package's initializers (the same
    distributions, other bits): conv and transposed-conv kernels
    lecun-normal (a normal truncated at ±2σ, variance 1/fan_in), BatchNorm
    (1, 0) with running statistics (0, 1), ``fc1`` / ``fc2``
    torch.nn.Linear's U(±1/√fan_in), every bias 0.  Drawn on the CPU, then
    copied to the device."""
    for name, t in model.state_dict().items():
        if name.endswith(("running_mean", "num_batches_tracked")):
            x = torch.zeros(t.shape)
        elif name.endswith("running_var"):
            x = torch.ones(t.shape)
        elif t.dim() == 4:
            # fan_in = input channels x k x k: dim 1 of a Conv2d weight
            # (O, I, k, k), dim 0 of a ConvTranspose2d weight (I, O, k, k)
            module = model.get_submodule(name.rsplit(".", 1)[0])
            cin = t.shape[0] if isinstance(module, torch.nn.ConvTranspose2d) \
                else t.shape[1]
            # flax's truncated normal: unit variance after truncation
            std = math.sqrt(1.0 / (cin * t.shape[2] * t.shape[3])) \
                / 0.87962566103423978
            x = torch.nn.init.trunc_normal_(torch.empty(t.shape), 0.0, std,
                                            -2 * std, 2 * std,
                                            generator=generator)
        elif t.dim() == 2:
            bound = t.shape[1] ** -0.5
            x = torch.empty(t.shape).uniform_(-bound, bound,
                                              generator=generator)
        elif name.endswith("weight"):      # BatchNorm scale
            x = torch.ones(t.shape)
        else:
            x = torch.zeros(t.shape)
        t.copy_(x)


def create_ae_state(model: ResNetAE, cfg,
                    generator: Optional[torch.Generator],
                    weights: Optional[dict] = None) -> AETrainState:
    """A fresh state on the model's device: weights random from
    ``generator`` (a CPU generator), or ``weights`` (a reference-keyed
    state dict, e.g. ``checkpoint.ae_state_dict_from_flax``) loaded
    ``strict=True``."""
    if weights is None:
        init_ae_params(model, generator)
    else:
        model.load_state_dict(weights, strict=True)
    return AETrainState(model, _ae_tx(cfg).init(
        dict(model.named_parameters())))


def make_ae_train_step(model: ResNetAE, tx: GradientTransformation,
                       chunks: int = 1, mesh=None):
    """``step(state, images) -> (state, loss)``: images (B, H, W, C), integer
    crops (normalized on the device, per chunk) or floats.  ``chunks`` > 1:
    the gradient and the loss are the mean over ``chunks`` equal chunks,
    each a forward and backward from the same running statistics, and the
    running statistics become the mean of the chunks' updates; activation
    memory is that of one chunk.  ``mesh``: ``images`` are this data
    index's rows of the global batch (see the module's docstring).  The
    step follows the state's placement (``shard_ae_state``: ZeRO-1 /
    FSDP)."""
    world = mesh_lib.mesh_size(mesh)
    if chunks > 1 and world > 1:
        if chunks % world:
            logger.warning("grad_cache_chunks=%d is not a multiple of the "
                           "%d-rank world — each rank runs %d chunks of its "
                           "rows", chunks, world, max(1, chunks // world))
        chunks = max(1, chunks // world)
    total_chunks = chunks * world
    warned = set()

    def loss_fn(images):
        x = device_normalize(images).permute(0, 3, 1, 2)
        out = model(x, train=True)
        return torch.mean((out - x) ** 2)

    def train_step(state: AETrainState, images: torch.Tensor):
        layout = None if state.layout is None \
            else state.layout.groups["model"]
        params = state.params
        mesh_lib.gather_params(params, layout, mesh)    # FSDP
        names = list(params)
        plist = [params[n] for n in names]
        b = images.shape[0]
        chunked = chunks > 1 and b % chunks == 0
        # one chunk's statistics are its own; a whole batch's the world's
        set_bn_axis(model, mesh if world > 1 and not chunked else None)
        if chunked:
            stats = _running_stats(model)
            start = {n: s.clone() for n, s in stats.items()}
            g_sum = [torch.zeros_like(p) for p in plist]
            loss_sum = 0
            after = []
            for chunk in images.reshape(chunks, b // chunks,
                                        *images.shape[1:]):
                with torch.no_grad():
                    for n, s in stats.items():
                        s.copy_(start[n])
                loss = loss_fn(chunk)
                g = torch.autograd.grad(loss, plist)
                torch._foreach_add_(g_sum, g)
                loss_sum = loss_sum + loss.detach()
                after.append({n: s.clone() for n, s in stats.items()})
            if world == 1:
                grads = torch._foreach_div(g_sum, chunks)
                loss = loss_sum / chunks
                with torch.no_grad():
                    for n, s in stats.items():
                        s.copy_(torch.stack([a[n] for a in after]).mean(0))
            else:
                loss = loss_sum.clone()
                sums = {n: torch.stack([a[n] for a in after]).sum(0)
                        for n in stats}
                mesh_lib.all_reduce_(g_sum + [loss] + list(sums.values()),
                                     mesh)
                grads = torch._foreach_div(g_sum, total_chunks)
                loss = loss / total_chunks
                with torch.no_grad():
                    for n, s in stats.items():
                        s.copy_(sums[n] / total_chunks)
        else:
            if chunks > 1 and tuple(images.shape) not in warned:
                warned.add(tuple(images.shape))
                logger.warning("grad_cache_chunks=%d does not divide AE batch "
                               "%d — single-pass step for this batch shape",
                               chunks, b)
            loss = loss_fn(images)
            grads = torch.autograd.grad(loss, plist)
            loss = loss.detach()
            if world > 1:      # the means over the world's rows
                loss = loss.clone()
                grads = list(grads)
                mesh_lib.all_reduce_(grads + [loss], mesh)
                grads = torch._foreach_div(grads, world)
                loss = loss / world
        state.opt_state = mesh_lib.sharded_update(
            tx, dict(zip(names, grads)), state.opt_state, params, layout,
            mesh)
        state.step += 1
        return state, loss

    return train_step


def ae_state_tree(state: AETrainState) -> dict:
    """What a step needs to continue bit for bit: the model's state dict
    (running statistics included), the Adam state (moments in their own
    dtype) and ``step``: the whole tensors, gathered from a ZeRO-1 / FSDP
    placement (every rank of a world calls it)."""
    layout = None if state.layout is None else state.layout.groups["model"]
    full, opt = mesh_lib.full_group(
        dict(state.model.named_parameters()), state.opt_state, layout,
        None if state.layout is None else state.layout.mesh)
    return {"model": {k: full.get(k, v)
                      for k, v in state.model.state_dict().items()},
            "opt_state": state_to_tree(opt),
            "step": int(state.step)}


def restore_ae_state(model: ResNetAE, cfg, tree: dict) -> AETrainState:
    """A state on ``model`` from ``ae_state_tree``'s tree (a resume
    checkpoint's), the weights loaded ``strict=True``."""
    state = create_ae_state(model, cfg, None, weights=tree["model"])
    state.opt_state = state_from_tree(tree["opt_state"],
                                      next(model.parameters()).device)
    state.step = int(tree["step"])
    return state


def save_ae_checkpoint(save_dir: str, state: AETrainState, epoch: int,
                       export_torch_bins: bool = True,
                       ckpt_format: str = "pickle") -> str:
    """The resume checkpoint ``ae_epoch<N>.ckpt`` (in ``ckpt_format``; the
    sharded directory in a world of several ranks) and the reference-named
    ``.bin`` exports (main_utils.py:683-689): ``autoencoder_path_<N>.bin``
    (the whole model), ``encoder_<N>.bin`` and ``decoder_<N>.bin`` (each
    tower's keys without its prefix), which a world of several ranks
    leaves to ``tools/convert_checkpoint.py``."""
    path = ckpt.save_checkpoint(os.path.join(save_dir,
                                             f"ae_epoch{epoch}.ckpt"),
                                ae_state_tree(state), format=ckpt_format)
    if export_torch_bins and mesh_lib.world_size() > 1:
        logger.warning(".bin export skipped on a world of %d ranks — "
                       "write them from %s with python -m "
                       "mimm_tpu_torch.tools.convert_checkpoint --kind ae",
                       mesh_lib.world_size(), path)
        export_torch_bins = False
    if export_torch_bins:
        sd = state.model.state_dict()
        ckpt.save_state_dict_bin(
            os.path.join(save_dir, f"autoencoder_path_{epoch}.bin"), sd)
        for tower in ("encoder", "decoder"):
            ckpt.save_state_dict_bin(
                os.path.join(save_dir, f"{tower}_{epoch}.bin"),
                {k[len(tower) + 1:]: v for k, v in sd.items()
                 if k.startswith(tower + ".")})
    return path


def _check_config(cfg) -> None:
    """A knob the trainer refuses raises before anything is written."""
    if cfg.checkpoint_format not in ckpt.FORMATS:
        raise ValueError(f"checkpoint_format {cfg.checkpoint_format!r} is "
                         f"not one of {ckpt.FORMATS}")


def train_auto_encoder(cfg, dataset=None, num_epochs: Optional[int] = None,
                       mesh=None, export_torch_bins: bool = True,
                       resume_from: Optional[str] = None,
                       device="cuda") -> AETrainState:
    """The reference's UniModalManager.train (main_utils.py:610-703) on
    ``device``: ``num_epochs`` epochs (default ``cfg.num_train_epochs``)
    over ``dataset`` (``len`` and ``load(idx, rng, train)``), by default
    the on-disk ``CXRImageDataset`` of ``cfg.image_dir`` and
    ``cfg.dataset_metadata`` through the crop cache
    ``cfg.decoded_crop_cache`` names.  Per epoch: the loader's batches,
    copied to the card ``cfg.prefetch`` ahead; the step losses stay on the
    device and are read once at the epoch's end.  Checkpoints
    (``save_ae_checkpoint``) every ``cfg.checkpoint_every_epochs`` epochs
    and after the last; with ``cfg.keep_checkpoints`` > 0 only that many
    ``ae_epoch<N>.ckpt`` stay.  After every step a pending preemption
    (``preempt.should_stop()``) saves ``ae_preempt.ckpt``, writes
    ``preempted=1`` to ``ae.jsonl`` and returns.  ``resume_from``: a
    resume checkpoint, continued at its step: epoch ``step //
    len(loader)``, from batch ``step % len(loader)`` of that epoch's
    stream.  ``mesh`` (default ``make_mesh(cfg.mesh_shape,
    cfg.dcn_mesh_shape)``, the world): each rank decodes its rows of every
    global batch of ``cfg.batch_size``, preemption is agreed on across the
    ranks, and rank 0 alone writes metrics, prunes and plots."""
    _check_config(cfg)
    mesh = mesh or mesh_lib.make_mesh(dict(cfg.mesh_shape) or None,
                                      dict(cfg.dcn_mesh_shape) or None)
    primary = mesh.rank == 0
    device = resolve_device(device)
    os.makedirs(cfg.save_directory, exist_ok=True)
    writer = MetricWriter(cfg.save_directory, name="ae",
                          log_filename="training_AE.log",
                          tensorboard=cfg.tensorboard)
    num_epochs = num_epochs or cfg.num_train_epochs
    if dataset is None:
        dataset = CXRImageDataset(cfg.image_dir, cfg.dataset_metadata,
                                  img_size=cfg.img_size,
                                  compact=cfg.compact_transfer,
                                  crop_cache=crop_cache.from_config(cfg))
    loader = Loader(dataset, batch_size=cfg.batch_size, seed=cfg.seed,
                    num_workers=cfg.data_loader_workers,
                    process_count=mesh.data, process_index=mesh.data_rank)
    logger.info("Total number of training images %d", len(dataset))

    model = build_ae_model(cfg, device)
    start_epoch, start_batch = 0, 0
    if resume_from is None:
        state = create_ae_state(model, cfg,
                                torch.Generator().manual_seed(cfg.seed))
    else:
        state = restore_ae_state(model, cfg, ckpt.load_checkpoint(resume_from))
        # a mid-epoch (preemption) checkpoint: the resumed epoch's stream
        # skips the batches already consumed
        start_epoch, start_batch = divmod(state.step, max(1, len(loader)))
        logger.info("Resumed from %s at step %d (epoch %d, batch %d)",
                    resume_from, state.step, start_epoch, start_batch)
    state = mesh_lib.shard_ae_state(
        mesh, state, zero1=cfg.zero1_optimizer_sharding,
        fsdp=cfg.fsdp_parameter_sharding)
    train_step = make_ae_train_step(model, _ae_tx(cfg),
                                    chunks=max(1, int(cfg.grad_cache_chunks)),
                                    mesh=mesh)
    fmt = cfg.checkpoint_format
    preempt_sync = mesh.size > 1

    training_loss = []
    profiler = StepProfiler(os.path.join(cfg.save_directory, "profile"),
                            cfg.profile_steps if primary else 0)
    for epoch in range(start_epoch, num_epochs):
        start = time.time()
        step_losses = []
        stream = loader.epoch(epoch, start_batch=start_batch
                              if epoch == start_epoch else 0)
        profiler.start()
        for batch in device_prefetch(stream, size=cfg.prefetch,
                                     device=device):
            state, loss = train_step(state, batch["image"])
            step_losses.append(loss)
            profiler.step(loss)
            if preempt.should_stop(sync=preempt_sync):
                # SIGTERM: the whole state, and stop; resume_from this
                # file continues mid-epoch
                profiler.close()
                path = ckpt.save_checkpoint(
                    os.path.join(cfg.save_directory, "ae_preempt.ckpt"),
                    ae_state_tree(state), format=fmt)
                logger.warning("preemption requested — saved %s at step %d "
                               "and stopping", path, state.step)
                writer.write(step=state.step, preempted=1)
                writer.close()
                ckpt.wait_for_async_saves()
                return state
        profiler.close(step_losses[-1] if step_losses else None)
        # one read of the epoch's losses from the device
        epoch_loss = float(np.sum(torch.stack(step_losses).cpu().numpy())) \
            if step_losses else 0.0
        training_loss.append(epoch_loss)

        every = max(1, int(cfg.checkpoint_every_epochs))
        path = None
        if (epoch + 1) % every == 0 or epoch + 1 == num_epochs:
            path = save_ae_checkpoint(cfg.save_directory, state, epoch + 1,
                                      export_torch_bins=export_torch_bins,
                                      ckpt_format=fmt)
            if int(cfg.keep_checkpoints) > 0:
                ckpt.wait_for_async_saves()        # never prune in flight
                if primary:
                    ckpt.prune_checkpoints(cfg.save_directory, "ae_epoch",
                                           int(cfg.keep_checkpoints))
        writer.epoch_summary(epoch + 1, epoch_loss, time.time() - start, path)
        if loader.skipped:
            writer.write(epoch=epoch + 1, skipped_records=loader.skipped)

    if primary:
        Plot_Training("Epochs", "Value for Loss",
                      "Training stats AutoEncoder", [training_loss],
                      ["Training loss"],
                      os.path.join(cfg.save_directory,
                                   "autoencoder_training_loss.png"))
    writer.close()
    ckpt.wait_for_async_saves()
    return state
