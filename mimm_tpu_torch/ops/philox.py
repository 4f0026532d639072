"""Philox4x32-10 in plain PyTorch, and the flash-attention dropout mask.

The counter-based generator of Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3" (SC'11), as Random123 defines it: ten rounds of two
32x32->64-bit products, with the key bumped by the Weyl constants between
rounds.  ``csrc/flash_attention_{fwd,bwd}.cu`` carry the same function in
CUDA; this copy is the plain version the tests and ``chip_smoke.py`` hold
the kernels against.

torch has no uint32 type with a multiply-high, and a 32x32 product in
int64 overflows past 2^63, so values live in int64 tensors in [0, 2^32)
and each product is taken in 16-bit limbs of the constant multiplier.
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57      # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85      # key bump (Weyl) constants
_MASK32 = 0xFFFFFFFF
ROUNDS = 10


def _mulhilo(m: int, a: torch.Tensor):
    """(hi, lo) 32-bit halves of the 64-bit product m·a, a in [0, 2^32)."""
    t = a * (m & 0xFFFF)                 # < 2^48
    u = a * (m >> 16)                    # < 2^48
    lo = (t + ((u & 0xFFFF) << 16)) & _MASK32
    hi = ((t >> 16) + u) >> 16
    return hi, lo


def philox4x32(counter, key, rounds: int = ROUNDS):
    """Philox4x32 on broadcastable int64 tensors (or ints) holding uint32
    values: ``counter`` = (c0, c1, c2, c3), ``key`` = (k0, k1).  Returns
    the four output words as int64 tensors in [0, 2^32)."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for r in range(rounds):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(rate: float) -> int:
    """Keep iff the uint32 draw >= this (the TPU kernel's threshold,
    mimm_tpu/ops/flash_attention.py:58, capped at 2^32 - 1)."""
    return min(_MASK32, int(rate * 4294967296.0))


def attention_keep_mask(seed: torch.Tensor, B: int, H: int, L: int,
                        rate: float, device=None) -> torch.Tensor:
    """Boolean (B, H, L, L) keep mask of the flash kernels' dropout.

    Element (b, h, i, j) takes word j % 4 of Philox4x32-10 with counter
    (j // 4, i, b·H + h, 0) and key (seed, 0), and is kept iff that word
    >= ``keep_threshold(rate)``.  It is a pure function of (seed, b·H+h,
    i, j), independent of any tiling, so the forward kernel, the backward
    kernel and this plain version draw the same bits.  ``seed``: an int32
    tensor of one element (read on its own device, no host sync)."""
    device = seed.device if device is None else device
    seed = seed.reshape(()).to(device=device, dtype=torch.int64) & _MASK32
    ar = lambda n: torch.arange(n, device=device, dtype=torch.int64)
    words = philox4x32(
        (ar((L + 3) // 4)[None, None, :], ar(L)[None, :, None],
         ar(B * H)[:, None, None], 0), (seed, 0))
    bits = torch.stack(words, dim=-1).reshape(B * H, L, -1)[..., :L]
    return (bits >= keep_threshold(rate)).reshape(B, H, L, L)
