"""CLI: dataset acquisition + population (cli/dataset_populate.py
counterpart; the reference's dataset_populate.py).

    python -m mimm_tpu_torch.cli.dataset_populate --stage merge \
        --subfolders p10,p11 --text_storage_dir ... --training_text_dir ...

Stages:
  download  — per-subfolder fetch/parse -> data_subfolder_<pN>.tsv
  merge     — merge subfolder TSVs -> all_data.tsv
  populate  — train/test split + label CSVs + disease stats
  stats     — (re)build disease_stats.csv for a label CSV

Every other flag is a ``DatasetConfig`` field (config.py).  Network
fetches are OFF unless --download true (without it the stage parses
already-downloaded files).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from mimm_tpu_torch.config import construct_dataset_parameters
from mimm_tpu_torch.data import etl


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--stage", default="populate",
                        choices=["download", "merge", "populate", "stats"])
    parser.add_argument("--download", default="false")
    parser.add_argument("--subfolders", default="")
    known, rest = parser.parse_known_args(argv)
    cfg = construct_dataset_parameters(rest)
    subfolders = known.subfolders.split(",") if known.subfolders \
        else [cfg.sub_folder]

    if known.stage == "download":
        for sub in subfolders:
            etl.download_full_dataset(
                cfg, sub, download=known.download.lower() == "true")
    elif known.stage == "merge":
        etl.populate_all_data(cfg, subfolders)
    elif known.stage == "populate":
        etl.populate_subset_dataset(cfg)
    elif known.stage == "stats":
        etl.parsing_csv_meta_data_for_label_stats(
            cfg.training_dataset_labeldata, cfg.training_data_dir)


if __name__ == "__main__":
    main()
