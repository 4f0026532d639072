"""Held-out validation: accuracy and GDV (cli/validate.py counterpart, the
reference's validate.py).

    python -m mimm_tpu_torch.cli.validate --save_directory <dir> \
        --num_train_epochs <N> --disease Pneumonia --modality mm|um \
        [--classifier_epoch <N>] [--ae_epoch <N>] [--extended] \
        --image_dir <dir> --dataset_metadata <csv> \
        --dataset_disease_stats <csv> [--device cuda]

``--modality mm`` validates the MI image encoder of
``<save>/mm_<critic>_epoch<N>`` (or the round-1 ``<critic>_epoch<N>``),
``um`` the autoencoder of ``<save>/um_ae_epoch<N>`` (or ``<save>`` itself
when that is absent), each with the disease's classifier beside it.
Prints ``Accuracy: ...`` and ``Separability: ...``, or with
``--extended`` also the AUC, precision, recall, F1 and the confusion
counts, one ``Key: value`` line each, as JAX's entry point does.  It runs
on the card unless the caller asks for the CPU.

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
NCCL for CUDA tensors, gloo for CPU tensors).  Every rank prints the
same report.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from mimm_tpu_torch.cli.train import mm_run_dir, um_run_dir
from mimm_tpu_torch.config import (DEFAULT_CLASSIFIER_LAYERS,
                                   construct_training_parameters)
from mimm_tpu_torch.cli.multi_modal import start_world, world_args
from mimm_tpu_torch.parallel.mesh import make_mesh
from mimm_tpu_torch.validate import validate_MultiModal, validate_UniModal

MLP_LAYER = list(DEFAULT_CLASSIFIER_LAYERS)  # reference validate.py:155
EXTENDED_KEYS = ("accuracy", "separability", "auc", "precision", "recall",
                 "f1", "tp", "tn", "fp", "fn", "positives", "negatives")


def main(argv: Optional[Sequence[str]] = None):
    own = argparse.ArgumentParser(add_help=False, parents=[world_args()])
    own.add_argument("--disease", default="Pneumonia")
    own.add_argument("--classifier_epoch", type=int, default=None)
    own.add_argument("--modality", choices=("mm", "um"), default="mm",
                     help="mm: the MI image encoder; um: the autoencoder")
    own.add_argument("--ae_epoch", type=int, default=None)
    own.add_argument("--extended", action="store_true",
                     help="also report AUC-ROC, precision, recall, F1 and "
                          "the confusion counts")
    known = start_world(own, argv)
    cfg = construct_training_parameters(argv, parents=(own,))
    mesh = make_mesh(dict(cfg.mesh_shape) or None,
                     dict(cfg.dcn_mesh_shape) or None)
    if known.modality == "mm":
        result = validate_MultiModal(
            cfg.replace(save_directory=mm_run_dir(cfg)), MLP_LAYER,
            known.disease, classifier_epoch=known.classifier_epoch,
            extended=known.extended, mesh=mesh, device=known.device)
    else:
        run_dir = um_run_dir(cfg)
        if os.path.isdir(run_dir):
            cfg = cfg.replace(save_directory=run_dir)
        result = validate_UniModal(
            cfg, MLP_LAYER, known.disease,
            classifier_epoch=known.classifier_epoch, ae_epoch=known.ae_epoch,
            extended=known.extended, mesh=mesh, device=known.device)
    if known.extended:
        for key in EXTENDED_KEYS:
            print(f"{key.capitalize()}: {result[key]}")
        return result
    accuracy, separability = result
    print(f"Accuracy: {accuracy}")
    print(f"Separability: {separability}")
    return accuracy, separability


if __name__ == "__main__":
    main()
