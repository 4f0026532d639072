"""Unimodal autoencoder pretraining from disk (cli/uni_modal.py
counterpart).

    python -m mimm_tpu_torch.cli.uni_modal --preset production \
        --image_dir <dir> --dataset_metadata <csv> --save_directory <dir> \
        [--decoded_crop_cache <dir>] [--resume_from auto] [--device cuda]

``train_auto_encoder`` trains ResNetAE over the images the metadata CSV
lists (train/ae.py): ``ae.jsonl`` and ``training_AE.log`` in the save
directory, ``ae_epoch<N>.ckpt`` and the reference's ``encoder_<N>.bin`` /
``decoder_<N>.bin`` / ``autoencoder_path_<N>.bin`` each saved epoch.
SIGTERM checkpoints at the next step boundary (``ae_preempt.ckpt``) and
returns; ``--resume_from auto`` picks that file up.  It runs on the card
unless the caller asks for the CPU.

A world of ranks (parallel/mesh.py): start one process per rank with
``MIMM_COORDINATOR_ADDRESS`` (``host:port``, or a ``file://`` path),
``MIMM_NUM_PROCESSES`` and ``MIMM_PROCESS_ID`` set, or under a launcher
with ``MIMM_DISTRIBUTED=1`` (``torchrun``'s ``env://``);
``initialize_distributed`` runs first, and ``--mesh_shape`` (``data=<D>``,
``model=<M>``, ``pipe=<S>``, ``data=<D>,model=<M>`` or
``data=<D>,pipe=<S>``; 'model' and 'pipe' together raise) /
``--dcn_mesh_shape`` are checked against the world.  A 'model' or a 'pipe' axis replicates the
trainer over its ranks; ``--zero1_optimizer_sharding`` and ``--fsdp_parameter_sharding``
rest the Adam moments and the parameters 'data'-split.  ``--dist_backend``
overrides the process group's backend (by default NCCL for CUDA tensors,
gloo for CPU tensors).
"""

from __future__ import annotations

from typing import Optional, Sequence

from mimm_tpu_torch import preempt
from mimm_tpu_torch.cli.multi_modal import start_world, world_args
from mimm_tpu_torch.config import TrainingConfig, construct_training_parameters
from mimm_tpu_torch.train import ae


def train_auto_encoder(cfg: TrainingConfig, device="cuda"):
    """Train on ``device``, resuming from ``preempt.resolve_resume(cfg,
    "ae_preempt.ckpt")``; returns the state."""
    # SIGTERM (eviction) -> checkpoint-and-exit at a step boundary
    preempt.install()
    return ae.train_auto_encoder(cfg, resume_from=preempt.resolve_resume(
        cfg, "ae_preempt.ckpt"), device=device)


def main(argv: Optional[Sequence[str]] = None):
    own = world_args()
    known = start_world(own, argv)
    cfg = construct_training_parameters(argv, parents=(own,))
    return train_auto_encoder(cfg, device=known.device)


if __name__ == "__main__":
    main()
