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
up.  It runs on the card unless the caller asks for the CPU.  The image
classifier's entry point comes with the classifier slice.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence

from mimm_tpu_torch import preempt
from mimm_tpu_torch.config import TrainingConfig, construct_training_parameters
from mimm_tpu_torch.data.features import load_and_cache_examples
from mimm_tpu_torch.data.tokenizer import WordPieceTokenizer
from mimm_tpu_torch.metrics import configure_run_logging
from mimm_tpu_torch.train.mi import MultiModalManager


def train_mutual_information(cfg: TrainingConfig, device="cuda"):
    """Tokenize, build the Manager on ``device`` and train, resuming from
    ``preempt.resolve_resume(cfg, "mi_preempt.ckpt")``.  Returns (manager,
    state)."""
    os.makedirs(cfg.save_directory, exist_ok=True)
    configure_run_logging(os.path.join(cfg.save_directory, "training_MI.log"))
    logger = logging.getLogger(__name__)
    logger.info("args: %s", cfg)
    # before the model: the tokenizing pool forks, and a fork after CUDA
    # is initialized falls back to serial (data/features.py)
    tokenizer = WordPieceTokenizer.from_pretrained(cfg.bert_pretrained_dir)
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


def main(argv: Optional[Sequence[str]] = None):
    own = argparse.ArgumentParser(add_help=False)
    own.add_argument("--device", default="cuda",
                     help="the torch device to train on (default: cuda)")
    cfg = construct_training_parameters(argv, parents=(own,))
    return train_mutual_information(
        cfg, device=own.parse_known_args(argv)[0].device)


if __name__ == "__main__":
    main()
