"""Pre-build the decoded-crop cache ahead of epoch 1 (cli/prebuild_cache.py
counterpart).

The decoded-crop cache (data/crop_cache.py) makes later epochs cheap, but
a run's FIRST epoch still pays the full-resolution decode on every miss.
This tool performs that decode + window write AHEAD of training with a
thread pool (cv2 and the host library release the GIL, so threads scale
across cores), so the run's epoch 1 reads the cache like every later
epoch.  The cache's files are the JAX package's: either side's build
serves the other.

Resumable: already-valid entries are detected with a cheap metadata peek
(``DecodedCropCache.valid``) and skipped, so an interrupted build
continues where it stopped; cache writes are atomic (tmp + rename), so a
killed build never leaves torn files.  cv2 is imported only to decode a
miss: a build whose entries are all valid needs no image codec.

Usage:
    python -m mimm_tpu_torch.cli.prebuild_cache --image_dir IMGS \
        --cache_dir CACHE [--metadata training_label_negbio.csv] \
        [--workers N]

Prints one JSON summary line (counts, wall time, ms/image, and with
--target_rate the host cores the build removes from epoch 1); exits 0, or
1 if any image was unreadable.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import csv
import json
import os
import sys
import time


def collect_image_ids(image_dir, metadata, data_key):
    """Image ids to build: the metadata CSV's ``data_key`` column (what
    the datasets will actually load), else every *.jpg under image_dir."""
    if metadata:
        with open(metadata, newline="") as f:
            ids = [row[data_key] for row in csv.DictReader(f)]
        # preserve order, drop duplicates (multi-view studies)
        return list(dict.fromkeys(ids))
    ids = []
    for root, _, files in os.walk(image_dir):
        rel = os.path.relpath(root, image_dir)
        for name in sorted(files):
            if name.lower().endswith((".jpg", ".jpeg", ".png")):
                ids.append(name if rel == "." else os.path.join(rel, name))
    return ids


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Pre-build the decoded-crop cache before epoch 1")
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--cache_dir", required=True)
    ap.add_argument("--img_size", type=int, default=256)
    ap.add_argument("--metadata", default="",
                    help="dataset metadata CSV; default: scan --image_dir")
    ap.add_argument("--data_key", default="mimic_id")
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--report_every", type=int, default=500)
    ap.add_argument("--target_rate", type=float, default=0.0,
                    help="pairs/s for the cores-needed projection "
                         "(default: skip the projection)")
    args = ap.parse_args(argv)

    from mimm_tpu_torch.data.crop_cache import DecodedCropCache

    ids = collect_image_ids(args.image_dir, args.metadata, args.data_key)
    cache = DecodedCropCache(args.cache_dir, args.img_size)
    counts = {"total": len(ids), "built": 0, "skipped_valid": 0,
              "unreadable": 0}
    t0 = time.time()

    def build_one(img_id):
        # any escaping exception (unexpected cv2/OS error) must not kill
        # the whole resumable build mid-iteration — count it unreadable
        try:
            if cache.valid(img_id):
                return "skipped_valid"
            if cache.read(args.image_dir, img_id) is None:
                return "unreadable"
            return "built"
        except Exception as e:  # noqa: BLE001 — per-image fault isolation
            print(f"error on {img_id}: {e!r}", file=sys.stderr)
            return "unreadable"

    with concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, args.workers)) as pool:
        for n, outcome in enumerate(pool.map(build_one, ids), 1):
            counts[outcome] += 1
            if args.report_every and n % args.report_every == 0:
                rate = n / (time.time() - t0)
                print(f"{n}/{len(ids)} ({rate:.1f} img/s, "
                      f"eta {(len(ids) - n) / max(rate, 1e-9):.0f}s)",
                      file=sys.stderr)

    wall = time.time() - t0
    decoded = counts["built"] + counts["unreadable"]
    summary = dict(counts, wall_seconds=round(wall, 2),
                   workers=args.workers,
                   ms_per_decoded_image=round(1e3 * wall / decoded, 2)
                   if decoded else None)
    if args.target_rate and decoded:
        # inline cost this build removes from epoch 1: one decode per
        # pair at target_rate pairs/s, on cores this fast
        summary["epoch1_cores_without_prebuild"] = round(
            args.target_rate * (wall / decoded) * args.workers, 1)
    print(json.dumps(summary))
    return 0 if counts["unreadable"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
