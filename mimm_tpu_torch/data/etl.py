"""ETL: MIMIC-CXR acquisition, report-section extraction, dataset
population (mimm_tpu/data/etl.py counterpart, the same functions, files and
bytes; host code, no tensors).

* ``extract_report_text`` — the FINDINGS/IMPRESSION section parser of the
  reference ``dataset_populate.py:200-260``: a FINDINGS: header's section,
  else the last paragraph before a blank line, else the second-last, with
  the IMPRESSION section appended.  The reference's quirk is kept for
  output parity: any non-empty line holding a ':' loses everything through
  its first colon.
* ``download_full_dataset`` — metadata-driven enumeration (PA/AP views,
  one dicom per study, per-pXX subfolder) writing the 5-column
  ``data_subfolder_<pN>.tsv`` (index, subject, study, mimic-id, text),
  flushed every 10 studies.  Fetches use wget as the reference does and
  are OFF by default (``download=False`` parses local files only).
* ``populate_all_data`` / ``repair_all_data_from_subfolder`` /
  ``find_missing_label_studies`` — merge subfolder TSVs into
  ``all_data.tsv`` and repair or audit a partial download.
* ``populate_subset_dataset`` — the seeded 1-in-20 study-level test split:
  training/testing 5-column TSVs, the ``*_label_negbio.csv`` tables and
  ``disease_stats.csv`` (``parsing_csv_meta_data_for_label_stats``), whose
  reader is ``read_disease_stats``.
"""

from __future__ import annotations

import ast
import csv
import gzip
import logging
import os
import subprocess
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from mimm_tpu_torch.utils import MimicID

logger = logging.getLogger(__name__)

META_FILENAME = "mimic-cxr-2.0.0-metadata.csv.gz"
LABEL_FILENAME = "mimic-cxr-2.0.0-negbio.csv.gz"
JPG_BASE_URL = "mimic-cxr-jpg/2.1.0/"
CXR_BASE_URL = "mimic-cxr/2.1.0/"


# ---------------------------------------------------------------------------
# Report parsing
# ---------------------------------------------------------------------------

def extract_report_text(report: str) -> str:
    """Extract the FINDINGS(+IMPRESSION) text from a raw radiology report.

    Returns the space-joined extracted lines ('' when nothing matched).
    """
    findings: List[str] = []
    has_findings = False
    impression: List[str] = []
    has_impression = False
    second_last_para: List[str] = []
    last_para: List[str] = []
    seen_blank = False

    for raw in report.splitlines():
        line = raw.strip()
        if "FINDINGS:" in line:
            if line != "FINDINGS:" and line.startswith("FINDINGS:"):
                findings.append(line[line.index("FINDINGS:") + 9:].strip())
            has_findings = True
            continue
        if "IMPRESSION:" in line:
            if line != "IMPRESSION:" and line.startswith("IMPRESSION:"):
                impression.append(line[line.index("IMPRESSION:") + 11:].strip())
            has_impression = True
            continue

        if line:
            if ":" in line:  # reference strips any 'Header:' prefix (see module doc)
                line = line[line.index(":") + 1:].strip()
            if has_findings:
                findings.append(line)
            elif has_impression:
                impression.append(line)
            elif seen_blank:
                last_para.append(line)
        else:
            seen_blank = True
            if not has_impression:
                second_last_para = last_para
                last_para = []

    if findings:
        extracted = findings
    elif last_para:
        extracted = last_para
    else:
        extracted = second_last_para
    if impression:
        extracted = extracted + impression
    return " ".join(extracted)


# ---------------------------------------------------------------------------
# Metadata enumeration + subfolder TSV construction
# ---------------------------------------------------------------------------

def iter_metadata(metadata_path: str) -> Iterable[Tuple[str, str, str, str]]:
    """Yield (dicom_id, subject_id, study_id, view_position) rows."""
    opener = gzip.open if metadata_path.endswith(".gz") else open
    with opener(metadata_path, "rt") as f:
        for i, line in enumerate(f):
            if i == 0:
                continue
            parts = line.rstrip("\r\n").split(",")
            yield parts[0], parts[1], parts[2], parts[4]


def synthesize_metadata_from_images(image_storage_dir: str, out_path: str,
                                    view: str = "PA") -> str:
    """Build a minimal ``mimic-cxr-2.0.0-metadata.csv.gz`` from image files
    named ``p<subj>_s<study>_<dicom>.jpg`` — for smoke runs and tests when
    the real PhysioNet metadata isn't available (the reference repo itself
    ships images + reports but not the metadata file)."""
    rows = []
    for sub in sorted(os.listdir(image_storage_dir)):
        subdir = os.path.join(image_storage_dir, sub)
        if not os.path.isdir(subdir):
            continue
        for fn in sorted(os.listdir(subdir)):
            if not fn.endswith(".jpg"):
                continue
            stem = fn[:-4]
            try:
                psubj, sstudy, dicom = stem.split("_", 2)
            except ValueError:
                continue
            rows.append([dicom, psubj[1:], sstudy[1:], "", view])
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    opener = gzip.open if out_path.endswith(".gz") else open
    with opener(out_path, "wt", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["dicom_id", "subject_id", "study_id", "PerformedProcedureStepDescription",
                    "ViewPosition"])
        w.writerows(rows)
    return out_path


def select_studies(metadata_path: str, subfolder: str
                   ) -> List[Tuple[str, str, str]]:
    """PA/AP views in the given pXX subfolder, first dicom per study
    (reference dataset_populate.py:160-176)."""
    seen = set()
    out = []
    for dicom, subject, study, view in iter_metadata(metadata_path):
        if view not in ("PA", "AP"):
            continue
        if f"p{subject[:2]}" != subfolder:
            continue
        if study in seen:
            continue
        seen.add(study)
        out.append((dicom, subject, study))
    return out


def _wget(url_path: str, base: str, dest: str, user: str, password: str) -> None:
    cmd = ["wget", "-r", "-N", "-c", "-np", "-nH", "--cut-dirs", "10",
           "--user", user, "--password", password,
           f"https://physionet.org/files/{base}{url_path}", "-P", dest]
    subprocess.run(cmd, check=False)


def download_full_dataset(cfg, subfolder: str, download: bool = False,
                          flush_every: int = 10) -> str:
    """Build ``data_subfolder_<subfolder>.tsv`` from local (or fetched)
    reports.  Returns the TSV path.  Reference dataset_populate.py:118-297.
    """
    meta_path = os.path.join(cfg.data_dir, META_FILENAME)
    text_sub = os.path.join(cfg.text_storage_dir, subfolder)
    os.makedirs(text_sub, exist_ok=True)
    tsv_path = os.path.join(cfg.text_storage_dir, f"data_subfolder_{subfolder}.tsv")

    rows: List[List] = []
    count = 0
    with open(tsv_path, "w", encoding="utf8", newline="") as tsv_file:
        writer = csv.writer(tsv_file, delimiter="\t", lineterminator="\n")
        for dicom, subject, study in select_studies(meta_path, subfolder):
            report_path = os.path.join(text_sub, f"s{study}.txt")
            if not os.path.isfile(report_path):
                if not download:
                    continue
                _wget(f"files/{subfolder}/p{subject}/s{study}.txt", CXR_BASE_URL,
                      text_sub, cfg.download_user, cfg.download_password)
                if not os.path.isfile(report_path):
                    continue
            with open(report_path, encoding="utf-8") as f:
                text = extract_report_text(f.read())
            if not text:
                continue
            mimic_id = f"p{subject}_s{study}_{dicom}"
            if download:
                img_dest = os.path.join(cfg.image_storage_dir, f"p{subject[:2]}",
                                        mimic_id + ".jpg")
                if not os.path.isfile(img_dest):
                    _wget(f"files/{subfolder}/p{subject}/s{study}/{dicom}.jpg",
                          JPG_BASE_URL, os.path.dirname(img_dest),
                          cfg.download_user, cfg.download_password)
            rows.append([count, subject, study, mimic_id, text])
            count += 1
            if len(rows) >= flush_every:
                writer.writerows(rows)
                rows = []
        writer.writerows(rows)
    logger.info("wrote %d studies to %s", count, tsv_path)
    return tsv_path


def populate_all_data(cfg, subfolders: Sequence[str], out_dir: Optional[str] = None
                      ) -> str:
    """Merge per-subfolder TSVs into ``all_data.tsv`` (reference
    populate_all_data_from_subfolder_download, dataset_populate.py:613-647)."""
    out_dir = out_dir or cfg.training_text_dir
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "all_data.tsv")
    i = 0
    with open(out_path, "w", encoding="utf8", newline="") as out:
        writer = csv.writer(out, delimiter="\t", lineterminator="\n")
        for sub in subfolders:
            src = os.path.join(cfg.text_storage_dir, f"data_subfolder_{sub}.tsv")
            if not os.path.exists(src):
                continue
            with open(src, encoding="utf-8") as f:
                # all_data row contract (dataset_populate.py:637): index,
                # label '-1' (unlabeled), study_id, subfolder, text.
                for line in csv.reader(f, delimiter="\t"):
                    writer.writerow([i, -1, line[2], sub, line[-1]])
                    i += 1
    logger.info("all_data.tsv: %d rows", i)
    return out_path


def _all_data_study_ids(all_data_path: str) -> set:
    with open(all_data_path, encoding="utf-8") as f:
        return {line[2] for line in csv.reader(f, delimiter="\t") if len(line) > 2}


def find_missing_label_studies(all_data_path: str, label_csv_path: str
                               ) -> List[str]:
    """Detection pass after a partial download: study ids present in the
    label CSV (``mimic_id,<14 labels>`` rows) but absent from
    ``all_data.tsv`` (reference
    fix_missing_studies_for_training_label_negbio_from_download,
    dataset_populate.py:521-566).  Returns the missing study ids."""
    have = _all_data_study_ids(all_data_path)
    missing: List[str] = []
    with open(label_csv_path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            if i == 0:
                continue  # header
            mimic_id = line.split(",", 1)[0]
            file_id = os.path.basename(mimic_id)
            study = MimicID.get_study_id(file_id)
            if study not in have:
                missing.append(study)
    logger.info("label CSV studies missing from all_data: %d", len(missing))
    return missing


def repair_all_data_from_subfolder(cfg, subfolder: str,
                                   out_dir: Optional[str] = None) -> int:
    """Repair flow for resumed/partial downloads: append any studies found
    in a subfolder TSV but missing from ``all_data.tsv`` (reference
    fix_missing_studies_for_all_data_from_download,
    dataset_populate.py:568-610; same appended-row contract:
    index, -1, study_id, subfolder, text).  Returns the row count added."""
    out_dir = out_dir or cfg.training_text_dir
    all_data = os.path.join(out_dir, "all_data.tsv")
    src = os.path.join(cfg.text_storage_dir, f"data_subfolder_{subfolder}.tsv")
    if not os.path.exists(src):
        logger.warning("no subfolder TSV at %s — nothing to repair", src)
        return 0
    have = _all_data_study_ids(all_data) if os.path.exists(all_data) else set()

    added = 0
    with open(src, encoding="utf-8") as f, \
            open(all_data, "a", encoding="utf8", newline="") as out:
        writer = csv.writer(out, delimiter="\t", lineterminator="\n")
        for line in csv.reader(f, delimiter="\t"):
            study = line[2]
            if study in have:
                continue
            writer.writerow([added, -1, study, subfolder, line[-1]])
            have.add(study)
            added += 1
    logger.info("repaired all_data.tsv: +%d studies from %s", added, subfolder)
    return added


# ---------------------------------------------------------------------------
# Train/test split + label tables + stats
# ---------------------------------------------------------------------------

def populate_subset_dataset(cfg, seed: int = 0) -> None:
    """Split all_data into training/testing TSVs + label CSVs + stats
    (reference populate_subset_dataset, dataset_populate.py:307-463).

    Deterministic: the 1-in-20 test assignment uses a seeded generator
    (the reference's is unseeded — distribution parity, not sample parity).
    """
    rng = np.random.default_rng(seed)

    all_data = os.path.join(cfg.training_text_dir, "all_data.tsv")
    study_text: Dict[str, str] = {}
    with open(all_data, encoding="utf-8") as f:
        for line in csv.reader(f, delimiter="\t"):
            if line[-1]:
                study_text[line[2]] = line[-1]

    train_imgs: Dict[str, str] = {}
    test_imgs: Dict[str, str] = {}
    meta_path = os.path.join(cfg.data_dir, META_FILENAME)
    # the 1-in-20 draw is made once per STUDY, not per metadata row: the
    # reference draws per row (dataset_populate.py:350-353), so a study
    # with several dicoms on disk could land in BOTH splits — leaking the
    # held-out set.  Intent (a disjoint study-level split) is preserved;
    # the per-study draw is an intentional difference like the seeding.
    assigned: Dict[str, bool] = {}  # study -> goes_to_test
    for dicom, subject, study, _ in iter_metadata(meta_path):
        img_rel = os.path.join(f"p{subject[:2]}", f"p{subject}_s{study}_{dicom}.jpg")
        if study not in study_text:
            continue
        if not os.path.isfile(os.path.join(cfg.image_storage_dir, img_rel)):
            continue
        if study not in assigned:
            assigned[study] = int(rng.integers(0, 20)) == 10
        if assigned[study]:
            test_imgs[study] = img_rel
        else:
            train_imgs[study] = img_rel

    def write_split(tsv_path, imgs):
        os.makedirs(os.path.dirname(tsv_path), exist_ok=True)
        with open(tsv_path, "w", encoding="utf8", newline="") as f:
            writer = csv.writer(f, delimiter="\t", lineterminator="\n")
            for i, (study, img) in enumerate(imgs.items()):
                writer.writerow([i, 0, study, img, study_text[study]])

    write_split(os.path.join(cfg.training_text_dir, "training_data.tsv"), train_imgs)
    write_split(os.path.join(cfg.testing_text_dir, "testing_data.tsv"), test_imgs)

    # label tables: header mimic_id,<diseases>; rows keyed by image path
    label_path = os.path.join(cfg.data_dir, LABEL_FILENAME)
    train_rows, test_rows = [], []
    with gzip.open(label_path, "rt") as f:
        for i, line in enumerate(f):
            cells = line.strip("\n").split(",")
            if i == 0:
                header = ["mimic_id"] + cells[2:]
                train_rows.append(header)
                test_rows.append(header)
                continue
            study = cells[1]
            if study in train_imgs:
                train_rows.append([train_imgs[study]] + cells[2:])
            elif study in test_imgs:
                test_rows.append([test_imgs[study]] + cells[2:])

    for path, rows in ((cfg.training_dataset_labeldata, train_rows),
                       (cfg.testing_dataset_labeldata, test_rows)):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", newline="") as f:
            csv.writer(f).writerows(rows)

    parsing_csv_meta_data_for_label_stats(cfg.training_dataset_labeldata,
                                          cfg.training_data_dir)
    parsing_csv_meta_data_for_label_stats(cfg.testing_dataset_labeldata,
                                          cfg.testing_data_dir)


def parsing_csv_meta_data_for_label_stats(metadata: str, data_dir: str) -> str:
    """Write ``disease_stats.csv`` (reference dataset_populate.py:465-519):
    per disease, a row ``disease,count,[study_ids]`` and a
    ``disease_negative`` counterpart, driven by '1.0'/'0.0' cells."""
    result: Dict[str, List[str]] = {}
    labels: List[str] = []
    with open(metadata, "rt") as f:
        for i, row in enumerate(csv.reader(f, lineterminator="\n")):
            if i == 0:
                labels = row[1:]
                for label in labels:
                    result[label] = []
                    result[label + "_negative"] = []
                continue
            study = row[0].split("_")[1][1:]
            for idx, x in enumerate(row[1:]):
                if x == "1.0":
                    result[labels[idx]].append(study)
                elif x == "0.0":
                    result[labels[idx] + "_negative"].append(study)

    os.makedirs(data_dir, exist_ok=True)
    out = os.path.join(data_dir, "disease_stats.csv")
    with open(out, "w", newline="") as f:
        writer = csv.writer(f)
        for label in labels:
            writer.writerow([label, len(result[label]), result[label]])
            writer.writerow([label + "_negative", len(result[label + "_negative"]),
                             result[label + "_negative"]])
    return out


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
