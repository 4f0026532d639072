"""The training sweeps (cli/train.py counterpart, the reference's train.py):
MI models, the autoencoder, and the per-disease classifiers on either
frozen encoder.

    python -m mimm_tpu_torch.cli.train --stage classifier_mm \
        --save_directory <dir> --num_train_epochs <N> --image_dir <dir> \
        --dataset_metadata <csv> --dataset_disease_stats <csv> \
        [--decoded_crop_cache <dir>] [--resume_from auto] [--device cuda]

``--stage``: ``mi`` (``<save>/mm_<critic>_epoch<N>``), ``ae``
(``<save>/um_ae_epoch<N>``), ``classifier_mm`` (the MI image encoder of
``mm_<critic>_epoch<N>``, or of the round-1 layout ``<critic>_epoch<N>``,
``pytorch_MI_image_model.bin``) or ``classifier_um`` (the autoencoder of
``um_ae_epoch<N>``, ``autoencoder_path_<N>.bin``); the classifiers are
written beside their encoder, one run per point of the sweep lists
below.  The encoders are built as JAX builds them: the ResNet in float32
with the canonical stem, the autoencoder by ``build_ae_model`` in the
config's compute dtype.  SIGTERM checkpoints the running trainer at its
next step boundary, and the sweep stops before its next point;
``--resume_from auto`` picks the checkpoint up.  It runs on the card
unless the caller asks for the CPU.

A world of ranks (parallel/mesh.py): start one process per rank with
``MIMM_COORDINATOR_ADDRESS`` (``host:port``, or a ``file://`` path),
``MIMM_NUM_PROCESSES`` and ``MIMM_PROCESS_ID`` set, or under a launcher
with ``MIMM_DISTRIBUTED=1`` (``torchrun``'s ``env://``);
``initialize_distributed`` runs first, and ``--mesh_shape`` (``data=<D>``,
``model=<M>``, ``pipe=<S>``, ``data=<D>,model=<M>`` or
``data=<D>,pipe=<S>``; 'model' and 'pipe' together raise) /
``--dcn_mesh_shape`` are checked against the world.  A 'model' or a 'pipe' axis replicates the
frozen encoders over its ranks, which embed their data index's rows.
``--dist_backend`` overrides the process group's backend (by default
NCCL for CUDA tensors, gloo for CPU tensors).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from mimm_tpu_torch import checkpoint as ckpt
from mimm_tpu_torch import preempt
from mimm_tpu_torch.config import (DEFAULT_CLASSIFIER_LAYERS,
                                   construct_training_parameters)

CRITICS = ["dv"]                                     # reference train.py:17
TRAINING_EPOCHS = [20]                               # train.py:18
BATCH_SIZES = [64]                                   # train.py:19
DISEASES = ["Cardiomegaly", "Pneumonia"]             # train.py:50
MLP_LAYERS = [list(DEFAULT_CLASSIFIER_LAYERS)]       # train.py:52
OPTIMIZERS = ["Adam"]                                # train.py:53
LEARNING_RATES = [5e-4]                              # train.py:54


def mm_run_dir(cfg) -> str:
    """``<save>/mm_<critic>_epoch<N>``, or the round-1 ``<critic>_epoch<N>``
    where only that exists."""
    run_dir = os.path.join(cfg.save_directory,
                           f"mm_{cfg.mi_estimator}_epoch{cfg.num_train_epochs}")
    if not os.path.isdir(run_dir):
        legacy = os.path.join(cfg.save_directory,
                              f"{cfg.mi_estimator}_epoch{cfg.num_train_epochs}")
        run_dir = legacy if os.path.isdir(legacy) else run_dir
    return run_dir


def um_run_dir(cfg) -> str:
    return os.path.join(cfg.save_directory,
                        f"um_ae_epoch{cfg.num_train_epochs}")


def train_MI_models(base_cfg, device="cuda") -> list:
    from mimm_tpu_torch.cli.multi_modal import train_mutual_information

    out = []
    for critic in CRITICS:
        for epochs in TRAINING_EPOCHS:
            for batch in BATCH_SIZES:
                if preempt.requested():
                    return out   # the grace window: stop the sweep cleanly
                cfg = base_cfg.replace(
                    mi_estimator=critic, num_train_epochs=epochs,
                    batch_size=batch,
                    save_directory=os.path.join(
                        base_cfg.save_directory,
                        f"mm_{critic}_epoch{epochs}"))
                out.append(train_mutual_information(cfg, device))
    return out


def train_AE_models(base_cfg, device="cuda"):
    from mimm_tpu_torch.train.ae import train_auto_encoder

    cfg = base_cfg.replace(save_directory=um_run_dir(base_cfg))
    os.makedirs(cfg.save_directory, exist_ok=True)
    return train_auto_encoder(cfg, resume_from=preempt.resolve_resume(
        cfg, "ae_preempt.ckpt"), device=device)


def build_frozen_encoder(base_cfg, is_multi_modal: bool, device="cuda",
                         mesh=None):
    """(run directory, ``embed`` function) of the MI image encoder or the
    autoencoder that ``base_cfg`` names, loaded ``strict=True``; ``mesh``:
    the encoder pass split over the world."""
    from mimm_tpu_torch import resolve_device
    from mimm_tpu_torch.models.resnet import ResNet256_6_2_1
    from mimm_tpu_torch.train import classifier
    from mimm_tpu_torch.train.ae import build_ae_model

    if is_multi_modal:
        run_dir = mm_run_dir(base_cfg)
        model = ResNet256_6_2_1(output_channels=base_cfg.output_channels)
        sd = ckpt.load_resnet_from_bin(
            os.path.join(run_dir, "pytorch_MI_image_model.bin"))
        return run_dir, classifier.make_embedding_fn(
            "multimodal", model.to(resolve_device(device)), sd, mesh=mesh)
    run_dir = um_run_dir(base_cfg)
    model = build_ae_model(base_cfg, device)
    sd = ckpt.load_state_dict_bin(os.path.join(
        run_dir, f"autoencoder_path_{base_cfg.num_train_epochs}.bin"))
    return run_dir, classifier.make_embedding_fn("unimodal", model, sd,
                                                 mesh=mesh)


def train_Classifier(base_cfg, isMultiModal: bool, device="cuda") -> list:
    """One classifier per disease, layer list, optimizer and learning
    rate, on the frozen encoder; returns each run's (state, best
    accuracy, its checkpoint's path)."""
    from mimm_tpu_torch.cli.multi_modal import train_image_classifier
    from mimm_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dict(base_cfg.mesh_shape) or None,
                     dict(base_cfg.dcn_mesh_shape) or None)
    run_dir, embed = build_frozen_encoder(base_cfg, isMultiModal, device,
                                          mesh=mesh)
    out = []
    for disease in DISEASES:
        for layers in MLP_LAYERS:
            for opt in OPTIMIZERS:
                for lr in LEARNING_RATES:
                    if preempt.requested():
                        # the grace window: the stopped run has saved its
                        # checkpoint; the next point would not finish
                        return out
                    cfg = base_cfg.replace(
                        save_directory=run_dir, disease_label=disease,
                        optimizer=opt, init_lr=lr)
                    out.append(train_image_classifier(cfg, embed, layers,
                                                      mesh=mesh,
                                                      device=device))
    return out


def main(argv: Optional[Sequence[str]] = None):
    from mimm_tpu_torch.cli.multi_modal import start_world, world_args

    own = argparse.ArgumentParser(add_help=False, parents=[world_args()])
    own.add_argument("--stage", default="classifier_um",
                     choices=["mi", "ae", "classifier_mm", "classifier_um"])
    known = start_world(own, argv)
    cfg = construct_training_parameters(argv, parents=(own,))
    # SIGTERM (eviction) -> the running trainer checkpoints and returns
    preempt.install()
    if known.stage == "mi":
        return train_MI_models(cfg, known.device)
    if known.stage == "ae":
        return train_AE_models(cfg, known.device)
    return train_Classifier(cfg, known.stage == "classifier_mm",
                            known.device)


if __name__ == "__main__":
    main()
