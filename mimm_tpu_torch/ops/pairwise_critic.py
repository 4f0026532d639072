"""The pairwise critic's dispatch (mimm_tpu/ops/pairwise_critic.py:401-448
``pairwise_critic_scores_pallas``).

JAX takes its XLA factorized path whenever the (B_img·B_txt, H1) f32
intermediate fits in 8 GiB, and its Pallas kernels (queue B rows 5-7)
only beyond that, about B = 1450 at H1 = 1024.  The port reproduces that
switch: under it, the plain factorized path of objectives/pairing.py, as
JAX does; past it, or with ``force_kernel=True``, it raises until the
kernels are ported with the GradCache slice.
"""

from __future__ import annotations

import logging
from typing import List

import torch

from mimm_tpu_torch.objectives.pairing import pairwise_critic_scores

logger = logging.getLogger(__name__)

MATERIALIZE_LIMIT_BYTES = 8 * 1024 ** 3
_KERNELS = ("the pairwise critic kernels (ROADMAP.md queue B rows 5-7) come "
            "with the GradCache slice")


def pairwise_critic_scores_pallas(params: List[dict], emb_img: torch.Tensor,
                                  emb_txt: torch.Tensor, *,
                                  force_kernel: bool = False) -> torch.Tensor:
    """Scores of the reference's 3-layer critic (W1, W2, w3)."""
    pairs = emb_img.shape[0] * emb_txt.shape[0]
    if len(params) != 3:
        if force_kernel:
            raise ValueError(f"pairwise critic kernel supports exactly 3 "
                             f"layers, got {len(params)} (force_kernel=True)")
        logger.warning("pairwise critic kernel supports exactly 3 layers "
                       "(got %d); using the factorized path, whose %d x H1 "
                       "intermediate materializes", len(params), pairs)
        return pairwise_critic_scores(params, emb_img, emb_txt)
    h1 = params[0]["w"].shape[1]
    if not force_kernel and pairs * h1 * 4 <= MATERIALIZE_LIMIT_BYTES:
        return pairwise_critic_scores(params, emb_img, emb_txt)
    raise NotImplementedError(
        f"{pairs} pairs x H1={h1} is past the 8 GiB switch (or "
        f"force_kernel=True): {_KERNELS}")
