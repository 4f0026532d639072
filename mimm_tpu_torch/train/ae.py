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

Left to later slices, raising ``NotImplementedError`` when asked for: the
mesh, ZeRO-1 and FSDP sharding, cross-replica BatchNorm and the "orbax"
checkpoint formats.
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
from mimm_tpu_torch.ops.image_norm import device_normalize
from mimm_tpu_torch.profiling import StepProfiler
from mimm_tpu_torch.train.optim import (GradientTransformation, adam_torch,
                                        apply_updates, state_from_tree,
                                        state_to_tree)

logger = logging.getLogger(__name__)

_PARALLEL = ("comes with the parallel slice (ROADMAP.md queue A, "
             "\"parallel/mesh.py and parallel/pipeline.py\")")


@dataclasses.dataclass
class AETrainState:
    """The model (its parameters, and the BatchNorm running statistics as
    buffers), the Adam state and the number of steps taken."""

    model: ResNetAE
    opt_state: object
    step: int = 0

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
                       chunks: int = 1, mesh=None, zero1: bool = False,
                       fsdp: bool = False):
    """``step(state, images) -> (state, loss)``: images (B, H, W, C), integer
    crops (normalized on the device, per chunk) or floats.  ``chunks`` > 1:
    the gradient and the loss are the mean over ``chunks`` equal chunks,
    each a forward and backward from the same running statistics, and the
    running statistics become the mean of the chunks' updates; activation
    memory is that of one chunk."""
    if mesh is not None or zero1 or fsdp:
        raise NotImplementedError(f"a mesh, zero1_optimizer_sharding and "
                                  f"fsdp_parameter_sharding {_PARALLEL}")
    warned = set()

    def loss_fn(images):
        x = device_normalize(images).permute(0, 3, 1, 2)
        out = model(x, train=True)
        return torch.mean((out - x) ** 2)

    def train_step(state: AETrainState, images: torch.Tensor):
        params = state.params
        names = list(params)
        plist = [params[n] for n in names]
        b = images.shape[0]
        if chunks > 1 and b % chunks == 0:
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
            grads = torch._foreach_div(g_sum, chunks)
            loss = loss_sum / chunks
            with torch.no_grad():
                for n, s in stats.items():
                    s.copy_(torch.stack([a[n] for a in after]).mean(0))
        else:
            if chunks > 1 and tuple(images.shape) not in warned:
                warned.add(tuple(images.shape))
                logger.warning("grad_cache_chunks=%d does not divide AE batch "
                               "%d — single-pass step for this batch shape",
                               chunks, b)
            loss = loss_fn(images)
            grads = torch.autograd.grad(loss, plist)
            loss = loss.detach()
        updates, state.opt_state = tx.update(dict(zip(names, grads)),
                                             state.opt_state, params)
        apply_updates(params, updates)
        state.step += 1
        return state, loss

    return train_step


def ae_state_tree(state: AETrainState) -> dict:
    """What a step needs to continue bit for bit: the model's state dict
    (running statistics included), the Adam state (moments in their own
    dtype) and ``step``."""
    return {"model": state.model.state_dict(),
            "opt_state": state_to_tree(state.opt_state),
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
                       export_torch_bins: bool = True) -> str:
    """The resume checkpoint ``ae_epoch<N>.ckpt`` and the reference-named
    ``.bin`` exports (main_utils.py:683-689): ``autoencoder_path_<N>.bin``
    (the whole model), ``encoder_<N>.bin`` and ``decoder_<N>.bin`` (each
    tower's keys without its prefix)."""
    path = ckpt.save_checkpoint(os.path.join(save_dir,
                                             f"ae_epoch{epoch}.ckpt"),
                                ae_state_tree(state))
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


def _check_config(cfg, mesh) -> None:
    """The knobs of later slices raise before anything is written."""
    if mesh is not None or cfg.mesh_shape:
        raise NotImplementedError(f"a mesh {_PARALLEL}")
    for knob in ("zero1_optimizer_sharding", "fsdp_parameter_sharding"):
        if getattr(cfg, knob):
            raise NotImplementedError(f"{knob} {_PARALLEL}")
    if cfg.checkpoint_format != "pickle":
        raise NotImplementedError(
            f"checkpoint_format {cfg.checkpoint_format!r}: sharded "
            f"multi-rank saves {_PARALLEL}")


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
    stream."""
    _check_config(cfg, mesh)
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
                    num_workers=cfg.data_loader_workers)
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
    train_step = make_ae_train_step(model, _ae_tx(cfg),
                                    chunks=max(1, int(cfg.grad_cache_chunks)))

    training_loss = []
    profiler = StepProfiler(os.path.join(cfg.save_directory, "profile"),
                            cfg.profile_steps)
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
            if preempt.should_stop():
                # SIGTERM: the whole state, and stop; resume_from this
                # file continues mid-epoch
                profiler.close()
                path = ckpt.save_checkpoint(
                    os.path.join(cfg.save_directory, "ae_preempt.ckpt"),
                    ae_state_tree(state))
                logger.warning("preemption requested — saved %s at step %d "
                               "and stopping", path, state.step)
                writer.write(step=state.step, preempted=1)
                writer.close()
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
                                      export_torch_bins=export_torch_bins)
            ckpt.prune_checkpoints(cfg.save_directory, "ae_epoch",
                                   int(cfg.keep_checkpoints))
        writer.epoch_summary(epoch + 1, epoch_loss, time.time() - start, path)
        if loader.skipped:
            writer.write(epoch=epoch + 1, skipped_records=loader.skipped)

    Plot_Training("Epochs", "Value for Loss", "Training stats AutoEncoder",
                  [training_loss], ["Training loss"],
                  os.path.join(cfg.save_directory,
                               "autoencoder_training_loss.png"))
    writer.close()
    return state
