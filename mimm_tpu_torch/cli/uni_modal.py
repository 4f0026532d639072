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
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from mimm_tpu_torch import preempt
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
    own = argparse.ArgumentParser(add_help=False)
    own.add_argument("--device", default="cuda",
                     help="the torch device to train on (default: cuda)")
    cfg = construct_training_parameters(argv, parents=(own,))
    return train_auto_encoder(cfg,
                              device=own.parse_known_args(argv)[0].device)


if __name__ == "__main__":
    main()
