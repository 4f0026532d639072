"""The reader half of the ETL (mimm_tpu/data/etl.py:420-435 counterpart):
``disease_stats.csv`` into exact positive / negative study-id lists.  The
populate half comes with the CLI and ETL slice (ROADMAP.md queue A)."""

from __future__ import annotations

import ast
import csv
import sys
from typing import List, Tuple


def read_disease_stats(disease_stats_path: str, disease: str
                       ) -> Tuple[List[str], List[str]]:
    """Rows ``<label>, <count>, [<study ids>]`` and ``<label>_negative,
    ...``: the positive and negative study ids of ``disease``."""
    csv.field_size_limit(sys.maxsize)
    pos: List[str] = []
    neg: List[str] = []
    with open(disease_stats_path, "rt") as f:
        for row in csv.reader(f, lineterminator="\n"):
            if not row:
                continue
            if row[0] == disease:
                pos = ast.literal_eval(row[2]) if row[2] else []
            elif row[0] == disease + "_negative":
                neg = ast.literal_eval(row[2]) if row[2] else []
    return [str(s) for s in pos], [str(s) for s in neg]
