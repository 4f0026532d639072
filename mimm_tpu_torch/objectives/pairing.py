"""Pairwise critic scoring (mimm_tpu/objectives/pairing.py counterpart).

``S[i, j] = MLP([img_i ; txt_j])`` for every pair at once.  The first
layer factorizes over the concatenation, ``W1·[x; y] = W1_img·x +
W1_txt·y``, so it costs two (B, 768) x (768, H1) products and no
(B², 1536) tensor exists; the later layers run on the (B, B, H1) pair
activations.  The reference's pair loop (main_utils.py:80-110) is kept
only as ``brute_force_pair_logits``, for tests.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from mimm_tpu_torch.models.mlp import mlp_apply
from mimm_tpu_torch.objectives.critics import bound_from_scores


def pairwise_critic_scores(params: List[dict], emb_img: torch.Tensor,
                           emb_txt: torch.Tensor) -> torch.Tensor:
    """(B_img, B_txt) scores of the make_mlp critic ``params`` (layer 0's
    input is emb_img's width + emb_txt's)."""
    d_img = emb_img.shape[-1]
    w1, b1 = params[0]["w"], params[0]["b"]
    h_img = emb_img @ w1[:d_img]                       # (B_i, H1)
    h_txt = emb_txt @ w1[d_img:]                       # (B_t, H1)
    h = F.relu(h_img[:, None, :] + h_txt[None, :, :] + b1)
    for layer in params[1:-1]:
        h = F.relu(h @ layer["w"] + layer["b"])
    return (h @ params[-1]["w"] + params[-1]["b"])[..., 0]


def brute_force_pair_logits(params: List[dict], emb_img: torch.Tensor,
                            emb_txt: torch.Tensor, study_ids) -> torch.Tensor:
    """The reference's pair vector (create_mi_pairs, main_utils.py:88-108):
    the B positives, then for gap 1..B-1 and i = 0..B-1 the wrapped pair
    (i, (i + gap) % B) where the study ids differ.  Tests only: O(B²)."""
    sids = [str(s) for s in study_ids]
    b = len(sids)
    rows = [torch.cat([emb_img[i], emb_txt[i]]) for i in range(b)]
    for gap in range(1, b):
        for i in range(b):
            j = (i + gap) % b
            if sids[i] != sids[j]:
                rows.append(torch.cat([emb_img[i], emb_txt[j]]))
    return mlp_apply(params, torch.stack(rows))[:, 0]


def mi_loss_from_embeddings(params: List[dict], emb_img: torch.Tensor,
                            emb_txt: torch.Tensor, study_ids: torch.Tensor,
                            estimator: str = "dv",
                            axis_name: Optional[str] = None,
                            use_pallas: bool = False) -> torch.Tensor:
    """The MI objective from embeddings.  ``use_pallas`` routes the scores
    through ops/pairwise_critic.py's size switch, as in JAX."""
    if axis_name is not None:
        raise NotImplementedError(
            "axis_name (negatives gathered across ranks) comes with the "
            "parallel slice (ROADMAP.md queue A, \"parallel/mesh.py and "
            "parallel/pipeline.py\")")
    if use_pallas:
        from mimm_tpu_torch.ops.pairwise_critic import \
            pairwise_critic_scores_pallas
        scores = pairwise_critic_scores_pallas(params, emb_img, emb_txt)
    else:
        scores = pairwise_critic_scores(params, emb_img, emb_txt)
    return bound_from_scores(estimator, scores, study_ids)
