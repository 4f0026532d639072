"""The per-disease classifier trainer on a frozen encoder
(mimm_tpu/train/classifier.py counterpart, the reference's
ClassifierModelManager, main_utils.py:271-591).

* The frozen encoder gives the embedding, in eval mode and without a
  graph, after ``device_normalize``: ``multimodal`` is the ResNet's slot 1
  (``z``, flattened in JAX's NHWC order), ``unimodal`` is
  ``ResNetAE.encode`` (``make_embedding_fn``).
* ``BasicMLP`` (ReLU + Dropout(0.2), sigmoid head) and BCE on
  ``clamp(p, 1e-7, 1 - 1e-7)``, averaged over the batch; Adam or SGD
  (weight decay 1e-8, Nesterov momentum 9e-4) at ``init_lr · 0.9^epoch``,
  the schedule read at the count before each update, as optax does.  Step
  k's dropout masks come from a generator seeded from (seed, k), so they
  do not depend on how the run got to step k.
* The 95/5 split is ``default_rng(seed).permutation(n)``; the train loader
  is ``Loader(..., seed=seed)``, the validation loader ``train=False,
  drop_last=False``.  Predictions are ``np.round`` on the host (half to
  even).  Train accuracy reuses the epoch's own embeddings; a resumed
  epoch makes a fresh full pass.
* The best validation accuracy writes ``classifier_<label>_epoch<N>.ckpt``
  (the port's envelope) and ``pytorch_image_classifier_<label>_epoch<N>.bin``
  (``layers.N.weight`` / ``.bias``, the reference layout); loss and
  accuracy plots every 20 epochs and at the end; the metrics in
  ``classifier_<label>.jsonl`` and ``training_classifier_<label>.log``.
* After every step a pending preemption saves
  ``classifier_<label>_preempt.ckpt`` and its ``.json`` sidecar (the best
  accuracy, its path and the four curves) and returns; ``resume_from``
  continues mid-epoch.

* ``cfg.tensorboard`` mirrors the metrics as TensorBoard events
  (tbevents.py).
* In a world of ranks (``mesh``: parallel/mesh.py; JAX :56-96) every rank
  reads every batch, the frozen-encoder pass is split over the ranks
  (each embeds its rows, then every rank gathers all of them; a batch the
  world does not divide is embedded whole on every rank), the MLP's step
  and the evaluation run the same on every rank, preemption is agreed on
  across the ranks, saves are the sharded format (the ``.bin`` then comes
  from ``tools/convert_checkpoint.py``), and rank 0 alone writes metrics,
  sidecars and plots.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mimm_tpu_torch import checkpoint as ckpt
from mimm_tpu_torch import preempt, resolve_device
from mimm_tpu_torch.data import crop_cache
from mimm_tpu_torch.data.pipeline import (CXRImageDiseaseDataset, Loader,
                                          device_prefetch)
from mimm_tpu_torch.metrics import MetricWriter, Plot_Training
from mimm_tpu_torch.models.mlp import BasicMLP
from mimm_tpu_torch.ops.image_norm import device_normalize
from mimm_tpu_torch.parallel import mesh as mesh_lib
from mimm_tpu_torch.train.optim import (GradientTransformation, adam_torch,
                                        apply_updates,
                                        exponential_epoch_schedule, sgd_torch,
                                        state_from_tree, state_to_tree)

logger = logging.getLogger(__name__)

@dataclasses.dataclass
class ClassifierTrainState:
    """The MLP (its parameters), the optimizer state and the number of
    steps taken."""

    model: BasicMLP
    opt_state: object
    step: int = 0

    @property
    def params(self) -> dict:
        return dict(self.model.named_parameters())


def make_embedding_fn(kind: str, model: torch.nn.Module, state_dict=None,
                      mesh=None) -> Callable:
    """``embed(images) -> (B, D)``: the frozen encoder ``model`` (with
    ``state_dict`` loaded ``strict=True`` when given) in eval mode, no
    graph; images (B, H, W, C) on the model's device, integer crops or
    floats.  ``kind``: "multimodal" (ResNet256_6_2_1's ``z``) or
    "unimodal" (``ResNetAE.encode``).  ``mesh``: each data index embeds
    its rows of the batch and every rank gets all of them (a batch the
    'data' axis does not divide: every rank embeds it whole, the same
    result); the ranks of one data index, which a 'model' or a 'pipe'
    axis adds, embed the same rows with the frozen encoder replicated, as JAX's pass."""
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    model.eval()
    if kind == "multimodal":
        def embed(images):
            with torch.no_grad():
                return model(device_normalize(images), train=False)[1]
    elif kind == "unimodal":
        def embed(images):
            with torch.no_grad():
                return model.encode(
                    device_normalize(images).permute(0, 3, 1, 2),
                    train=False)
    else:
        raise ValueError(f"unknown encoder kind: {kind}")
    if mesh_lib.mesh_size(mesh) == 1:
        return embed

    def sharded_embed(images):
        rows = images.shape[0]
        if rows % mesh.data:
            return embed(images)
        with torch.no_grad():
            return mesh_lib.gather_rows(
                embed(images[mesh_lib.local_rows(mesh, rows)]), mesh)

    return sharded_embed


@torch.no_grad()
def init_mlp_params(mlp: BasicMLP, generator: torch.Generator) -> None:
    """torch.nn.Linear's U(±1/√fan_in) for every weight and bias, drawn on
    the CPU from ``generator`` and copied to the device."""
    for layer in mlp.layers:
        bound = layer.weight.shape[1] ** -0.5
        for p in (layer.weight, layer.bias):
            p.copy_(torch.empty(p.shape, dtype=p.dtype).uniform_(
                -bound, bound, generator=generator))


def create_classifier_state(mlp: BasicMLP, tx: GradientTransformation,
                            generator: Optional[torch.Generator],
                            weights: Optional[dict] = None
                            ) -> ClassifierTrainState:
    """A fresh state on the MLP's device: weights random from ``generator``
    (a CPU generator), or ``weights`` (a ``layers.N.weight``-keyed state
    dict, e.g. ``checkpoint.mlp_state_dict_from_flax``) loaded
    ``strict=True``."""
    if weights is None:
        init_mlp_params(mlp, generator)
    else:
        mlp.load_state_dict(weights, strict=True)
    return ClassifierTrainState(mlp, tx.init(dict(mlp.named_parameters())))


def _dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """Step ``step``'s dropout generator, seeded from (seed, step) alone
    (JAX folds the step into its key, mimm_tpu/train/classifier.py:103)."""
    word = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(word >> np.uint64(1)))


def make_classifier_step(mlp: BasicMLP, tx: GradientTransformation,
                         seed: int):
    """``step(state, emb, labels) -> (state, loss)``: BCE on the clamped
    sigmoid output in training mode (dropout from ``_dropout_generator``),
    the gradient of the MLP alone, ``tx``'s update in place.  The loss
    stays on the device."""

    def train_step(state: ClassifierTrainState, emb: torch.Tensor,
                   labels: torch.Tensor):
        params = state.params
        names = list(params)
        mlp.train()
        gen = _dropout_generator(seed, state.step, emb.device) \
            if mlp.dropout_rate > 0.0 else None
        p = torch.clamp(mlp(emb, generator=gen)[:, 0], 1e-7, 1 - 1e-7)
        loss = -torch.mean(labels * torch.log(p)
                           + (1 - labels) * torch.log1p(-p))
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        updates, state.opt_state = tx.update(dict(zip(names, grads)),
                                             state.opt_state, params)
        apply_updates(params, updates)
        state.step += 1
        return state, loss.detach()

    return train_step


def make_predict(mlp: BasicMLP) -> Callable:
    """``predict(emb) -> (B,)`` sigmoid outputs in eval mode, no graph."""

    def predict(emb: torch.Tensor) -> torch.Tensor:
        mlp.eval()
        with torch.no_grad():
            return mlp(emb)[:, 0]

    return predict


def evaluate(mlp: BasicMLP, embed: Callable, loader: Loader, epoch: int,
             predict: Optional[Callable] = None, cached_batches=None):
    """(accuracy, mean batch loss, tallies) over ``loader``'s epoch
    ``epoch`` (its batches copied to the MLP's device), or over
    ``cached_batches``, (embedding, label) pairs already there.  One read
    from the device for the whole pass; the arithmetic is numpy's on the
    host, as JAX's."""
    predict = predict or make_predict(mlp)
    if cached_batches is None:
        device = next(mlp.parameters()).device
        cached_batches = [(embed(b["image"]), b["label"]) for b in
                          device_prefetch(loader.epoch(epoch), device=device)]
    probs, labels = [], []
    for emb, y in cached_batches:
        probs.append(predict(emb))
        labels.append(y)
    count = total = tp = tn = fp = fn = pos = neg = 0
    losses = []
    if probs:
        sizes = [len(y) for y in labels]
        all_p = torch.cat(probs).cpu().numpy()
        all_y = torch.cat(labels).cpu().numpy()
        bounds = np.cumsum([0, *sizes])
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            p, y = all_p[lo:hi], all_y[lo:hi]
            pred = np.round(p)
            pc = np.clip(p, 1e-7, 1 - 1e-7)
            losses.append(float(-np.mean(y * np.log(pc)
                                         + (1 - y) * np.log1p(-pc))))
            count += int((pred == y).sum())
            total += len(y)
            pos += int((y == 1).sum())
            neg += int((y == 0).sum())
            tp += int(np.logical_and(pred == 1, y == 1).sum())
            tn += int(np.logical_and(pred == 0, y == 0).sum())
            fp += int(np.logical_and(pred == 1, y == 0).sum())
            fn += int(np.logical_and(pred == 0, y == 1).sum())
    acc = count / max(1, total)
    return acc, (float(np.mean(losses)) if losses else 0.0), dict(
        total=total, positive=pos, negative=neg, tp=tp, tn=tn, fp=fp, fn=fn)


def classifier_state_tree(state: ClassifierTrainState) -> dict:
    """What a step needs to continue bit for bit: the MLP's state dict, the
    optimizer state and ``step``."""
    return {"model": state.model.state_dict(),
            "opt_state": state_to_tree(state.opt_state),
            "step": int(state.step)}


def restore_classifier_state(mlp: BasicMLP, tx: GradientTransformation,
                             tree: dict) -> ClassifierTrainState:
    """A state on ``mlp`` from ``classifier_state_tree``'s tree, the
    weights loaded ``strict=True``."""
    state = create_classifier_state(mlp, tx, None, weights=tree["model"])
    state.opt_state = state_from_tree(tree["opt_state"],
                                      next(mlp.parameters()).device)
    state.step = int(tree["step"])
    return state


class ClassifierModelManager:
    """The reference-shaped trainer (main_utils.py:276-316): ``embed_fn``
    (``make_embedding_fn``) gives the frozen encoder's embeddings of the
    images of ``dataset`` (``len`` and ``load(idx, rng, train)`` giving
    ``image`` and ``label``), by default the on-disk
    ``CXRImageDiseaseDataset`` of ``cfg.disease_label`` through the crop
    cache ``cfg.decoded_crop_cache`` names.  ``weights``: the MLP's initial
    state dict, instead of random weights from ``cfg.seed``.  ``mesh``
    (default ``make_mesh(cfg.mesh_shape, cfg.dcn_mesh_shape)``, the
    world): the data-parallel run of the module's docstring; build
    ``embed_fn`` with the same mesh."""

    def __init__(self, cfg, embed_fn: Callable, mlp_hidden_layers,
                 dataset=None, val_fraction: float = 0.05, mesh=None,
                 device="cuda", weights: Optional[dict] = None):
        self.mesh = mesh or mesh_lib.make_mesh(
            dict(cfg.mesh_shape) or None, dict(cfg.dcn_mesh_shape) or None)
        self.cfg = cfg
        self.embed = embed_fn
        self.device = resolve_device(device)
        self.weights = weights
        self.mlp = BasicMLP(768, list(mlp_hidden_layers)).to(self.device)
        if dataset is None:
            dataset = CXRImageDiseaseDataset(
                img_dir=cfg.image_dir, dataset_metadata=cfg.dataset_metadata,
                disease=cfg.disease_label,
                disease_stats=cfg.dataset_disease_stats,
                img_size=cfg.img_size, compact=cfg.compact_transfer,
                crop_cache=crop_cache.from_config(cfg))
        n = len(dataset)
        order = np.random.default_rng(cfg.seed).permutation(n)
        n_val = max(1, int(round(n * val_fraction)))
        self.train_view = _Subset(dataset, order[n_val:])
        self.val_view = _Subset(dataset, order[:n_val])
        workers = cfg.data_loader_workers
        self.train_loader = Loader(self.train_view, cfg.batch_size,
                                   seed=cfg.seed, num_workers=workers)
        self.val_loader = Loader(self.val_view, cfg.batch_size, seed=cfg.seed,
                                 num_workers=workers, train=False,
                                 drop_last=False)

    def train(self, num_epochs: Optional[int] = None,
              export_torch_bins: bool = True,
              resume_from: Optional[str] = None):
        """``num_epochs`` (default ``cfg.num_train_epochs_classifier``)
        epochs; returns (state, best validation accuracy, the path of its
        checkpoint).  ``resume_from``: a ``classifier_<label>_preempt.ckpt``;
        the MLP, the optimizer and the best-accuracy bookkeeping (its
        ``.json``) are restored and the run continues mid-epoch."""
        cfg = self.cfg
        num_epochs = num_epochs or cfg.num_train_epochs_classifier
        label = cfg.disease_label
        os.makedirs(cfg.save_directory, exist_ok=True)
        writer = MetricWriter(
            cfg.save_directory, name=f"classifier_{label}",
            log_filename=f"training_classifier_{label}.log",
            tensorboard=cfg.tensorboard)
        steps_per_epoch = max(1, len(self.train_loader))
        sched = exponential_epoch_schedule(cfg.init_lr, 0.9, steps_per_epoch)
        tx = adam_torch(sched) if cfg.optimizer == "Adam" \
            else sgd_torch(sched)
        tr_losses, tr_accs, va_losses, va_accs = [], [], [], []
        max_accuracy, best_path = 0.0, None
        start_epoch, resume_start_batch = 0, 0
        if resume_from is None:
            state = create_classifier_state(
                self.mlp, tx, torch.Generator().manual_seed(cfg.seed),
                weights=self.weights)
        else:
            state = restore_classifier_state(self.mlp, tx,
                                             ckpt.load_checkpoint(resume_from))
            aux_path = resume_from.rstrip("/") + ".json"
            if os.path.exists(aux_path):
                with open(aux_path) as f:
                    aux = json.load(f)
                max_accuracy = aux.get("max_accuracy", 0.0)
                best_path = aux.get("best_path")
                tr_losses = aux.get("tr_losses", [])
                tr_accs = aux.get("tr_accs", [])
                va_losses = aux.get("va_losses", [])
                va_accs = aux.get("va_accs", [])
            start_epoch, resume_start_batch = divmod(state.step,
                                                     steps_per_epoch)
            logger.info("Resumed classifier from %s at step %d (epoch %d, "
                        "batch %d)", resume_from, state.step, start_epoch,
                        resume_start_batch)
        mesh_lib.replicate(self.mesh, self.mlp)
        step_fn = make_classifier_step(self.mlp, tx, cfg.seed)
        predict = make_predict(self.mlp)
        primary = self.mesh.rank == 0
        preempt_sync = self.mesh.size > 1

        for epoch in range(start_epoch, num_epochs):
            start = time.time()
            start_batch = resume_start_batch if epoch == start_epoch else 0
            step_losses, epoch_embs = [], []
            stream = self.train_loader.epoch(epoch, start_batch=start_batch)
            for batch in device_prefetch(stream, size=cfg.prefetch,
                                         device=self.device):
                emb = self.embed(batch["image"])
                epoch_embs.append((emb, batch["label"]))
                state, loss = step_fn(state, emb, batch["label"])
                step_losses.append(loss)
                if preempt.should_stop(sync=preempt_sync):
                    # SIGTERM: the state and the bookkeeping, and stop;
                    # resume_from this file continues mid-epoch
                    path = ckpt.save_checkpoint(
                        os.path.join(cfg.save_directory,
                                     f"classifier_{label}_preempt.ckpt"),
                        classifier_state_tree(state),
                        format=cfg.checkpoint_format)
                    if primary:
                        with open(path + ".json", "w") as f:
                            json.dump({"max_accuracy": max_accuracy,
                                       "best_path": best_path,
                                       "tr_losses": tr_losses,
                                       "tr_accs": tr_accs,
                                       "va_losses": va_losses,
                                       "va_accs": va_accs}, f)
                    logger.warning("preemption requested — saved %s at step "
                                   "%d and stopping", path, state.step)
                    writer.write(step=state.step, preempted=1)
                    writer.close()
                    ckpt.wait_for_async_saves()
                    return state, max_accuracy, best_path
            # one read of the epoch's losses from the device
            tr_loss = float(np.mean(torch.stack(step_losses).cpu().numpy())) \
                if step_losses else 0.0
            # a mid-epoch-resumed epoch embedded only its remaining
            # batches: train accuracy then takes a fresh full pass
            tr_acc, _, _ = evaluate(self.mlp, self.embed, self.train_loader,
                                    epoch, predict=predict,
                                    cached_batches=epoch_embs
                                    if start_batch == 0 else None)
            va_acc, va_loss, tallies = evaluate(
                self.mlp, self.embed, self.val_loader, epoch, predict=predict)
            tr_losses.append(tr_loss)
            tr_accs.append(tr_acc)
            va_losses.append(va_loss)
            va_accs.append(va_acc)

            if va_acc > max_accuracy:
                max_accuracy = va_acc
                best_path = self.save(state, f"{label}_epoch{epoch + 1}",
                                      export_torch_bins)
            dt = time.time() - start
            writer.logger.info(
                f"Label: {label},  Epoch {epoch + 1} took {dt:.3f} s, "
                f"training loss = {tr_loss:.5f}, validation_loss = "
                f"{va_loss:.5f}, validation accuracy={va_acc:.5f}")
            writer.logger.info(
                f"  Total validation samples = {tallies['total']}, "
                f"total positive={tallies['positive']}, total negative="
                f"{tallies['negative']} ,tp_count={tallies['tp']}, "
                f"tn_count={tallies['tn']}, fp_count={tallies['fp']}, "
                f"fn_count={tallies['fn']}")
            writer.write(epoch=epoch + 1, train_loss=tr_loss,
                         train_acc=tr_acc, val_loss=va_loss, val_acc=va_acc,
                         **tallies)
            if (epoch + 1) % 20 == 0 and primary:
                self._plots(tr_losses, va_losses, tr_accs, va_accs,
                            suffix=f"_epoch{epoch + 1}")

        if primary:
            self._plots(tr_losses, va_losses, tr_accs, va_accs, suffix="")
        writer.close()
        ckpt.wait_for_async_saves()
        return state, max_accuracy, best_path

    def save(self, state: ClassifierTrainState, label: str,
             export_torch_bins: bool = True) -> str:
        """``classifier_<label>.ckpt`` (``cfg.checkpoint_format``; sharded in
        a world of several ranks) and, with ``export_torch_bins``,
        ``pytorch_image_classifier_<label>.bin`` (left to
        ``tools/convert_checkpoint.py`` in such a world); returns the
        former."""
        cfg = self.cfg
        path = ckpt.save_checkpoint(
            os.path.join(cfg.save_directory, f"classifier_{label}.ckpt"),
            classifier_state_tree(state), format=cfg.checkpoint_format)
        if export_torch_bins and self.mesh.size > 1:
            logger.warning(".bin export skipped on a world of %d ranks — "
                           "write it from %s with python -m "
                           "mimm_tpu_torch.tools.convert_checkpoint --kind "
                           "classifier --label %s", self.mesh.size, path,
                           label)
            export_torch_bins = False
        if export_torch_bins:
            ckpt.save_state_dict_bin(
                os.path.join(cfg.save_directory,
                             f"pytorch_image_classifier_{label}.bin"),
                state.model.state_dict())
        return path

    def _plots(self, tr_l, va_l, tr_a, va_a, suffix: str) -> None:
        d = self.cfg.disease_label
        out = lambda kind: os.path.join(
            self.cfg.save_directory,
            f"image_classifier_training_{kind}_{d}{suffix}.png")
        Plot_Training("Epochs", "Value for Loss",
                      f"Training stats for disease {d}", [tr_l, va_l],
                      ["Training loss", "Validation loss"], out("loss"))
        Plot_Training("Epochs", "Value for Accuracy",
                      f"Training stats for disease {d}", [tr_a, va_a],
                      ["training accuracy", "validation accuracy"],
                      out("accuracy"))


class _Subset:
    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def load(self, idx, rng, train=True):
        return self.dataset.load(int(self.indices[idx]), rng, train=train)
