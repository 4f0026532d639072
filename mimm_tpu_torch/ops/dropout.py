"""Dropout with explicit generators (mimm_tpu/ops/dropout.py counterpart).

Three forms, picked by the BERT config as ``mimm_tpu/models/bert.py:34-37``
``_dropout`` picks them:

* ``dropout`` — flax ``nn.Dropout``: Bernoulli(1 - rate) per element, kept
  values scaled by 1/(1 - rate);
* ``u8_dropout`` — one random byte per element, keep iff byte >=
  round(rate·256) (the production preset's text-tower dropout; keep
  probability resolution 1/256);
* ``packed_dropout`` — four bytes of one uint32 draw per four elements,
  the same threshold.

``torch.nn.functional.dropout`` draws from the default generator; these
take a ``torch.Generator`` on the tensor's device, so a step's masks are a
function of the step's seed.  The bits differ from JAX's (another
generator): tests hold these by their statistics.
"""

from __future__ import annotations

import torch


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            deterministic: bool = False) -> torch.Tensor:
    if deterministic or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.empty(x.shape, device=x.device).bernoulli_(
        keep_prob, generator=generator).bool()
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def _byte_threshold(rate: float) -> int:
    return min(255, int(round(rate * 256.0)))


def u8_dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
               deterministic: bool = False) -> torch.Tensor:
    if deterministic or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    bits = torch.randint(0, 256, x.shape, dtype=torch.uint8, device=x.device,
                         generator=generator)
    return torch.where(bits >= _byte_threshold(rate), x / (1.0 - rate),
                       torch.zeros_like(x))


def packed_dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
                   deterministic: bool = False) -> torch.Tensor:
    if deterministic or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    n = x.numel()
    words = torch.randint(0, 2 ** 32, ((n + 3) // 4,), dtype=torch.int64,
                          device=x.device, generator=generator)
    bytes4 = torch.stack([(words >> (8 * k)) & 0xFF for k in range(4)], dim=1)
    keep = (bytes4.reshape(-1)[:n] >= _byte_threshold(rate)).reshape(x.shape)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dropout_fn(config):
    """The dropout a BERT config selects (``u8_dropout`` first, then
    ``packed_dropout``, else ``nn.Dropout``)."""
    if getattr(config, "u8_dropout", False):
        return u8_dropout
    return packed_dropout if config.packed_dropout else dropout
