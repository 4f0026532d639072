"""On-device image normalization and compact-batch widening
(mimm_tpu/ops/image_norm.py counterpart).

Integer crops (uint8/uint16) are cast to float32 and divided by
max(1e-3, per-image max) on the device; float inputs are already
normalized and pass through.  Integer sources <= 65535 are exact in
float32, so the result is bit-identical to the JAX function's.
"""

from __future__ import annotations

import torch


def device_normalize(images: torch.Tensor) -> torch.Tensor:
    """float32 cast + per-image divide by max(1e-3, image max); the
    per-image axes are the trailing three (H, W, C)."""
    if images.is_floating_point():
        return images
    x = images.to(torch.float32)
    m = x.amax(dim=(-3, -2, -1), keepdim=True)
    return x / torch.clamp(m, min=1e-3)


# token arrays widen to torch's index type (the JAX package widens to int32)
_WIDEN = ("txt_ids", "txt_masks", "txt_segments")


def decompact_batch(batch: dict) -> dict:
    """Widen a compact-transfer batch (mimm_tpu/ops/image_norm.py:43
    ``decompact_batch``): integer images are normalized with
    ``device_normalize``, narrow token arrays (uint16 ids, uint8 masks and
    segments) become int64.  Exact; a no-op on already-wide batches."""
    out = dict(batch)
    if "image" in out:
        out["image"] = device_normalize(out["image"])
    for key in _WIDEN:
        if key in out and out[key].dtype != torch.int64:
            out[key] = out[key].to(torch.int64)
    return out
