"""MI pretraining from disk (cli/multi_modal.py counterpart).

    python -m mimm_tpu_torch.cli.multi_modal --preset production \
        --image_dir <dir> --text_data_dir <dir> --dataset_metadata <csv> \
        --bert_pretrained_dir <dir> --save_directory <dir> \
        [--decoded_crop_cache <dir>] [--resume_from auto] [--device cuda]

``train_mutual_information`` tokenizes the report corpus
(``<text_data_dir>/all_data.tsv``, cached as JAX caches it), builds the
joint Manager and trains; the log goes to
``<save_directory>/training_MI.log`` as the reference's does
(multi_modal.py:27-34).  SIGTERM checkpoints at the next step boundary
(``mi_preempt.ckpt``) and returns; ``--resume_from auto`` picks that file
up.  ``train_image_classifier`` trains one disease's classifier on a frozen
encoder's embeddings (``mimm_tpu_torch.cli.train`` sweeps it), its log in
``training_classifier_<disease>.log``, resuming from
``classifier_<disease>_preempt.ckpt`` under ``--resume_from auto``.  Both
run on the card unless the caller asks for the CPU.

A world of ranks (parallel/mesh.py): start one process per rank with
``MIMM_COORDINATOR_ADDRESS`` (``host:port``, or a ``file://`` path),
``MIMM_NUM_PROCESSES`` and ``MIMM_PROCESS_ID`` set, or under a launcher
with ``MIMM_DISTRIBUTED=1`` (``torchrun``'s ``env://``);
``initialize_distributed`` runs first, and ``--mesh_shape`` (``data=<D>``,
``model=<M>``, ``pipe=<S>``, ``data=<D>,model=<M>`` or
``data=<D>,pipe=<S>``; 'model' and 'pipe' together raise) /
``--dcn_mesh_shape`` are checked against the world.  A 'model' axis runs BERT and the critic
tensor-parallel (``--sequence_parallel`` splits the tokens too); a
'pipe' axis of S ranks pipelines the text tower's layers over S stages
in ``--pipeline_microbatches`` microbatches (GPipe; 0: one per stage),
each stage holding its n/S layers and their moments;
``--zero1_optimizer_sharding`` and ``--fsdp_parameter_sharding`` rest the
moments and the parameters 'data'-split.  ``--dist_backend`` overrides
the process group's backend (by default NCCL for CUDA tensors, gloo for
CPU tensors).  Each data index trains on its rows of every global batch
of ``--batch_size``; the saves are the sharded format, and ``python -m
mimm_tpu_torch.tools.convert_checkpoint`` writes the ``.bin`` files from
them.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence

from mimm_tpu_torch import preempt
from mimm_tpu_torch.config import TrainingConfig, construct_training_parameters
from mimm_tpu_torch.data.features import load_and_cache_examples
from mimm_tpu_torch.data.tokenizer import NativeWordPieceTokenizer
from mimm_tpu_torch.metrics import configure_run_logging
from mimm_tpu_torch.parallel.mesh import initialize_distributed
from mimm_tpu_torch.train.mi import MultiModalManager


def train_mutual_information(cfg: TrainingConfig, device="cuda"):
    """Tokenize, build the Manager on ``device`` and train, resuming from
    ``preempt.resolve_resume(cfg, "mi_preempt.ckpt")``.  Returns (manager,
    state)."""
    os.makedirs(cfg.save_directory, exist_ok=True)
    configure_run_logging(os.path.join(cfg.save_directory, "training_MI.log"))
    logger = logging.getLogger(__name__)
    logger.info("args: %s", cfg)
    # the host library's encoder: featurization runs on threads, without
    # the GIL (data/features.py)
    tokenizer = NativeWordPieceTokenizer.from_pretrained(
        cfg.bert_pretrained_dir)
    features = load_and_cache_examples(cfg.text_data_dir, cfg.max_seq_length,
                                       tokenizer,
                                       num_workers=cfg.data_loader_workers)
    logger.info("tokens features: %d", len(features))
    preempt.install()
    manager = MultiModalManager(cfg, device=device)
    state = manager.train(token_features=features,
                          resume_from=preempt.resolve_resume(
                              cfg, "mi_preempt.ckpt"))
    return manager, state


def train_image_classifier(cfg: TrainingConfig, embed_fn, mlp_hidden_layers,
                           mesh=None, device="cuda"):
    """``ClassifierModelManager(cfg, embed_fn, mlp_hidden_layers).train``
    on ``device`` for ``cfg.disease_label``, resuming from
    ``preempt.resolve_resume(cfg, "classifier_<label>_preempt.ckpt")``.
    Returns (state, best validation accuracy, its checkpoint's path)."""
    from mimm_tpu_torch.train.classifier import ClassifierModelManager

    os.makedirs(cfg.save_directory, exist_ok=True)
    configure_run_logging(os.path.join(
        cfg.save_directory, f"training_classifier_{cfg.disease_label}.log"))
    manager = ClassifierModelManager(cfg, embed_fn, mlp_hidden_layers,
                                     mesh=mesh, device=device)
    return manager.train(resume_from=preempt.resolve_resume(
        cfg, f"classifier_{cfg.disease_label}_preempt.ckpt"))


def world_args() -> argparse.ArgumentParser:
    """The entry points' own flags: ``--device`` and ``--dist_backend``."""
    own = argparse.ArgumentParser(add_help=False)
    own.add_argument("--device", default="cuda",
                     help="the torch device to run on (default: cuda; this "
                          "rank's card in a world)")
    own.add_argument("--dist_backend", default=None,
                     help="the process group's backend in a world (default: "
                          "NCCL for CUDA tensors, gloo for CPU tensors)")
    return own


def start_world(own: argparse.ArgumentParser, argv) -> argparse.Namespace:
    """The entry point's own flags, after ``initialize_distributed`` has
    started the world the ``MIMM_*`` variables describe (nothing for one
    process)."""
    known = own.parse_known_args(argv)[0]
    initialize_distributed(device=known.device, backend=known.dist_backend)
    return known


def main(argv: Optional[Sequence[str]] = None):
    own = world_args()
    known = start_world(own, argv)
    cfg = construct_training_parameters(argv, parents=(own,))
    return train_mutual_information(cfg, device=known.device)


if __name__ == "__main__":
    main()
