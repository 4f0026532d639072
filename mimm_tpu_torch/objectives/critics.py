"""Variational mutual-information bounds, DV and InfoNCE
(mimm_tpu/objectives/critics.py counterpart).

* Vector form (reference mi_critics.py:3-23): a flat logits vector whose
  first ``pos_size`` entries score positive pairs and the rest negatives.
* Matrix form: a (B, B) score matrix ``S[i, j] = critic(img_i, txt_j)``
  with the diagonal as positives and the pairs of different study ids as
  negatives.  It is the same set the reference's pair loop enumerates
  (main_utils.py:80-110), and ``mean`` and ``logsumexp`` do not depend on
  order, so the loss is the same.
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


def dv_bound_loss(discriminator_logits: torch.Tensor,
                  pos_size: int) -> torch.Tensor:
    """Donsker-Varadhan loss: logsumexp(neg) − log(N_neg) − mean(pos)."""
    logits = discriminator_logits.reshape(-1)
    neg = logits[pos_size:]
    return torch.logsumexp(neg, dim=0) - math.log(neg.shape[0]) \
        - logits[:pos_size].mean()


def infonce_bound_loss(discriminator_logits: torch.Tensor,
                       pos_size: int) -> torch.Tensor:
    """The reference's 'infonce': DV without the log(N_neg) term."""
    logits = discriminator_logits.reshape(-1)
    return torch.logsumexp(logits[pos_size:], dim=0) - logits[:pos_size].mean()


def negative_pair_mask(study_ids: torch.Tensor) -> torch.Tensor:
    """(B, B) bool: True iff the two rows' study ids differ (which excludes
    the diagonal and same-report pairs, main_utils.py:105)."""
    sid = study_ids.reshape(-1)
    return sid[:, None] != sid[None, :]


def _masked_logsumexp(scores, mask):
    return torch.logsumexp(
        torch.where(mask, scores, scores.new_tensor(_NEG_INF)).reshape(-1),
        dim=0)


def dv_bound_from_scores(scores: torch.Tensor,
                         study_ids: torch.Tensor) -> torch.Tensor:
    mask = negative_pair_mask(study_ids)
    n_neg = mask.sum().to(scores.dtype)
    return _masked_logsumexp(scores, mask) - torch.log(n_neg) \
        - torch.diagonal(scores).mean()


def infonce_bound_from_scores(scores: torch.Tensor,
                              study_ids: torch.Tensor) -> torch.Tensor:
    mask = negative_pair_mask(study_ids)
    return _masked_logsumexp(scores, mask) - torch.diagonal(scores).mean()


def infonce_per_anchor(scores: torch.Tensor,
                       study_ids: torch.Tensor) -> torch.Tensor:
    """Textbook per-anchor InfoNCE over the batch:
    −mean_i [S_ii − logsumexp_j(S_ij over j valid or j == i)]."""
    eye = torch.eye(scores.shape[0], dtype=torch.bool, device=scores.device)
    keep = negative_pair_mask(study_ids) | eye
    masked = torch.where(keep, scores, scores.new_tensor(_NEG_INF))
    return -(torch.diagonal(scores) - torch.logsumexp(masked, dim=1)).mean()


def bound_from_scores(estimator: str, scores: torch.Tensor,
                      study_ids: torch.Tensor) -> torch.Tensor:
    """The ``mi_estimator`` named in the config."""
    if estimator == "dv":
        return dv_bound_from_scores(scores, study_ids)
    if estimator == "infonce":
        return infonce_bound_from_scores(scores, study_ids)
    if estimator == "infonce_per_anchor":
        return infonce_per_anchor(scores, study_ids)
    raise ValueError(f"unknown mi estimator: {estimator}")
