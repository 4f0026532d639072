"""The pairwise critic: its dispatch (mimm_tpu/ops/pairwise_critic.py:401-448
``pairwise_critic_scores_pallas``) and its kernels (queue B rows 5-7).

JAX takes its XLA factorized path whenever the (B_img·B_txt, H1) f32
intermediate fits in 8 GiB, and its Pallas kernels only beyond that, about
B = 1450 at H1 = 1024, or with ``force_kernel=True``.  The port keeps that
switch (``uses_kernel``): under it, the plain factorized path of
objectives/pairing.py; past it, ``h_img = emb_img·W1[:d]`` and ``h_txt =
emb_txt·W1[d:]`` as plain products under autograd, then ``_PairScores``, a
``torch.autograd.Function`` over (h_img, h_txt, b1, W2, b2, w3, b3), all in
float32 as JAX casts them.

For CUDA tensors its forward launches ``csrc/pairwise_critic_fwd.cu`` and
its backward the four kernels of ``csrc/pairwise_critic_bwd.cu`` (dh_img,
dh_txt, the weight-gradient partials, their fixed-order sums); no buffer of
B_img·B_txt·H1 elements exists on that path.  For CPU tensors they are
``pair_scores_plain`` and ``pair_scores_bwd_plain``, the same two functions
in plain PyTorch, the backward written out with the kernels' formulas.
There is no fallback from CUDA to the plain versions: a CUDA call launches
the kernels or raises.
"""

from __future__ import annotations

import collections
import ctypes
import logging
from typing import List, Optional

import torch
import torch.nn.functional as F

from mimm_tpu_torch.objectives.pairing import pairwise_critic_scores

logger = logging.getLogger(__name__)

MATERIALIZE_LIMIT_BYTES = 8 * 1024 ** 3
# launches of each kernel since the last reset_launch_counts(); a wrapper
# adds one exactly where it launches its kernel
LAUNCHES: collections.Counter = collections.Counter()
FWD_SOURCE = "pairwise_critic_fwd"    # csrc/pairwise_critic_fwd.cu
BWD_SOURCE = "pairwise_critic_bwd"    # csrc/pairwise_critic_bwd.cu
KERNELS = {"fwd": "pairwise_critic_fwd",            # row 5
           "bwd_img": "pairwise_critic_bwd_img",    # row 6: dh_img
           "bwd_w": "pairwise_critic_bwd_w",        # row 6: dW2, db2, dw3
           "bwd_reduce": "pairwise_critic_bwd_reduce",  # row 6: the sums
           "bwd_txt": "pairwise_critic_bwd_txt"}    # row 7: dh_txt
MAX_H1 = 1024
MAX_H2 = 512
MAX_SPLITS = 16           # pair ranges of the dW2 kernel (scratch per split)
_W_TILE_PAIRS = 256


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def uses_kernel(n_img: int, n_txt: int, h1: int,
                force_kernel: bool = False) -> bool:
    """JAX's switch: the kernels once the factorized path's (n_img·n_txt,
    h1) float32 intermediate passes 8 GiB, or when forced."""
    return force_kernel or n_img * n_txt * h1 * 4 > MATERIALIZE_LIMIT_BYTES


def _row_blocks(n: int, rows: Optional[int]):
    step = rows or n
    return [slice(s, min(n, s + step)) for s in range(0, n, step)]


def pair_scores_plain(h_img, h_txt, b1, w2, b2, w3, b3,
                      rows: Optional[int] = None) -> torch.Tensor:
    """S (B_img, B_txt) = relu(relu(h_img[i] + h_txt[j] + b1)·W2 + b2)·w3
    + b3 in plain PyTorch, ``rows`` image rows at a time (all by
    default)."""
    out = []
    for blk in _row_blocks(h_img.shape[0], rows):
        t = F.relu(h_img[blk, None, :] + h_txt[None, :, :] + b1)
        t2 = F.relu(t @ w2 + b2)
        out.append((t2 @ w3.reshape(-1, 1))[..., 0] + b3)
    return torch.cat(out)


def pair_scores_bwd_plain(h_img, h_txt, b1, w2, b2, w3, b3, g,
                          rows: Optional[int] = None):
    """The gradients of ``pair_scores_plain`` for the cotangent g (B_img,
    B_txt), written out with the kernels' formulas (no autograd):
    dz2 = (g·w3)∘[z2 > 0], dt = dz2·W2ᵀ, dz1 = dt∘[t > 0].  Returns
    (dh_img, dh_txt, db1, dW2, db2, dw3, db3) in the shapes of the inputs;
    ``rows`` image rows at a time."""
    del b3
    h2 = w2.shape[1]
    dh_img, dh_txt = torch.empty_like(h_img), torch.zeros_like(h_txt)
    dw2, db2 = torch.zeros_like(w2), torch.zeros_like(b2)
    dw3 = torch.zeros(h2, dtype=w3.dtype, device=w3.device)
    for blk in _row_blocks(h_img.shape[0], rows):
        t = F.relu(h_img[blk, None, :] + h_txt[None, :, :] + b1)
        z2 = t @ w2 + b2
        gb = g[blk, :, None]
        dz2 = (gb * w3.reshape(-1)) * (z2 > 0)
        dz1 = (dz2 @ w2.T) * (t > 0)
        dh_img[blk] = dz1.sum(1)
        dh_txt += dz1.sum(0)
        dw2 += t.reshape(-1, t.shape[-1]).T @ dz2.reshape(-1, h2)
        db2 += dz2.sum((0, 1))
        dw3 += (F.relu(z2) * gb).sum((0, 1))
    return (dh_img, dh_txt, dh_img.sum(0), dw2, db2, dw3.reshape(w3.shape),
            g.sum().reshape(1))


def _launch(fn, like: torch.Tensor, *args) -> int:
    """Call a kernel's C entry point on ``like``'s card and its current
    stream (the last argument); returns the cudaError_t."""
    with torch.cuda.device(like.device):
        return fn(*args, torch.cuda.current_stream(like.device).cuda_stream)


def _check_kernel_inputs(tensors) -> None:
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in tensors):
        raise TypeError("the critic kernels take contiguous float32 tensors")
    h_img, h_txt, _, w2 = tensors[:4]
    if not (h_img.shape[1] == h_txt.shape[1] == w2.shape[0] <= MAX_H1
            and w2.shape[1] <= MAX_H2):
        raise ValueError(f"the critic kernels take H1 <= {MAX_H1} and H2 <= "
                         f"{MAX_H2}; got h {tuple(h_img.shape)}, "
                         f"{tuple(h_txt.shape)}, W2 {tuple(w2.shape)}")
    if max(h_img.shape[0], h_txt.shape[0]) * h_img.shape[1] >= 2 ** 31:
        raise ValueError("row offsets past int32")


def _launched(err: int, name: str, shape) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err} at "
                           f"(B_img, B_txt, H1, H2)={shape}")
    LAUNCHES[name] += 1


def _forward_kernel(h_img, h_txt, b1, w2, b2, w3, b3) -> torch.Tensor:
    from mimm_tpu_torch.ops import _build

    args = (h_img, h_txt, b1, w2, b2, w3, b3)
    _check_kernel_inputs(args)
    (ni, h1), nj, h2 = h_img.shape, h_txt.shape[0], w2.shape[1]
    fn = _build.load(FWD_SOURCE).mimm_pairwise_critic_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(ni, nj, dtype=torch.float32, device=h_img.device)
    err = _launch(fn, h_img, *(t.data_ptr() for t in args), out.data_ptr(),
                  ni, nj, h1, h2)
    _launched(err, KERNELS["fwd"], (ni, nj, h1, h2))
    return out


def bwd_splits(n_img: int, n_txt: int) -> int:
    """Pair ranges of the dW2 kernel: enough blocks to fill the card at the
    GradCache shape, never more ranges than tiles of 256 pairs."""
    return max(1, min(MAX_SPLITS, -(-n_img * n_txt // _W_TILE_PAIRS)))


def _bwd_lib(args):
    """(library, shape) of a backward launch, after the input checks;
    args = (h_img, h_txt, b1, W2, b2, w3, g)."""
    from mimm_tpu_torch.ops import _build

    _check_kernel_inputs(args)
    (ni, h1), nj, h2 = args[0].shape, args[1].shape[0], args[3].shape[1]
    if tuple(args[6].shape) != (ni, nj):
        raise ValueError(f"g must be {(ni, nj)}, got {tuple(args[6].shape)}")
    return _build.load(BWD_SOURCE), (ni, nj, h1, h2)


def _empty(device, *shape) -> torch.Tensor:
    return torch.empty(*shape, dtype=torch.float32, device=device)


def bwd_rows_kernel(args, txt: bool) -> torch.Tensor:
    """dh_img (``txt`` False, row 6) or dh_txt (True, row 7)."""
    lib, shape = _bwd_lib(args)
    fn = lib.mimm_pairwise_critic_bwd_rows
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dh = _empty(args[0].device, shape[1] if txt else shape[0], shape[2])
    _launched(_launch(fn, dh, *(t.data_ptr() for t in args), dh.data_ptr(),
                      *shape, int(txt)),
              KERNELS["bwd_txt" if txt else "bwd_img"], shape)
    return dh


def bwd_w_kernel(args) -> list:
    """Per-split partials [dW2 (S, H1, H2), db2 (S, H2), dw3 (S, H2), db3
    (S)] of row 6's weight gradients."""
    lib, (ni, nj, h1, h2) = _bwd_lib(args)
    fn = lib.mimm_pairwise_critic_bwd_w
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    splits = bwd_splits(ni, nj)
    dev = args[0].device
    parts = [_empty(dev, splits, h1, h2), _empty(dev, splits, h2),
             _empty(dev, splits, h2), _empty(dev, splits)]
    _launched(_launch(fn, parts[0], *(t.data_ptr() for t in args),
                      *(p.data_ptr() for p in parts), ni, nj, h1, h2, splits),
              KERNELS["bwd_w"], (ni, nj, h1, h2))
    return parts


def bwd_reduce_kernel(parts, dh_img: torch.Tensor):
    """(dW2, db1, db2, dw3, db3): the partials' sums and db1 = Σ_i
    dh_img[i], in a fixed order."""
    from mimm_tpu_torch.ops import _build

    splits, h1, h2 = parts[0].shape
    if not all(t.dtype == torch.float32 and t.is_contiguous()
               for t in [*parts, dh_img]) or dh_img.shape[1] != h1:
        raise ValueError("partials and dh_img must be contiguous float32 "
                         "with matching H1")
    fn = _build.load(BWD_SOURCE).mimm_pairwise_critic_bwd_reduce
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = dh_img.device
    outs = [_empty(dev, h1, h2), _empty(dev, h1), _empty(dev, h2),
            _empty(dev, h2), _empty(dev, 1)]
    _launched(_launch(fn, dh_img, *(p.data_ptr() for p in parts),
                      dh_img.data_ptr(), *(t.data_ptr() for t in outs),
                      splits, dh_img.shape[0], h1, h2),
              KERNELS["bwd_reduce"], (dh_img.shape[0], None, h1, h2))
    return outs


def _backward_kernel(h_img, h_txt, b1, w2, b2, w3, g):
    args = (h_img, h_txt, b1, w2, b2, w3, g)
    dh_img = bwd_rows_kernel(args, txt=False)
    dh_txt = bwd_rows_kernel(args, txt=True)
    dw2, db1, db2, dw3, db3 = bwd_reduce_kernel(bwd_w_kernel(args), dh_img)
    return dh_img, dh_txt, db1, dw2, db2, dw3.reshape(w3.shape), db3


def pair_scores(h_img, h_txt, b1, w2, b2, w3, b3) -> torch.Tensor:
    """The forward on its own: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if h_img.device.type == "cuda":
        return _forward_kernel(h_img, h_txt, b1, w2, b2, w3, b3)
    return pair_scores_plain(h_img, h_txt, b1, w2, b2, w3, b3)


def pair_scores_bwd(h_img, h_txt, b1, w2, b2, w3, b3, g):
    """The backward on its own: the kernels for CUDA tensors, the plain
    version for CPU tensors."""
    if h_img.device.type == "cuda":
        return _backward_kernel(h_img, h_txt, b1, w2, b2, w3, g)
    return pair_scores_bwd_plain(h_img, h_txt, b1, w2, b2, w3, b3, g)


class _PairScores(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h_img, h_txt, b1, w2, b2, w3, b3):
        ctx.save_for_backward(h_img, h_txt, b1, w2, b2, w3, b3)
        return pair_scores(h_img, h_txt, b1, w2, b2, w3, b3)

    @staticmethod
    def backward(ctx, g):
        # the cotangent in float32, as _core_bwd casts it (:394)
        return pair_scores_bwd(*ctx.saved_tensors,
                               g.to(torch.float32).contiguous())


def pairwise_critic_scores_pallas(params: List[dict], emb_img: torch.Tensor,
                                  emb_txt: torch.Tensor, *,
                                  force_kernel: bool = False) -> torch.Tensor:
    """Scores of the reference's 3-layer critic (W1, W2, w3): the
    factorized path under the switch, the kernels past it (float32)."""
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
    if not uses_kernel(emb_img.shape[0], emb_txt.shape[0], h1, force_kernel):
        return pairwise_critic_scores(params, emb_img, emb_txt)
    d_img = emb_img.shape[-1]
    f32 = lambda t: t.to(torch.float32)
    w1 = f32(params[0]["w"])
    h_img = f32(emb_img) @ w1[:d_img]        # plain products, as in JAX;
    h_txt = f32(emb_txt) @ w1[d_img:]        # autograd covers W1 and embs
    return _PairScores.apply(
        h_img.contiguous(), h_txt.contiguous(),
        *(f32(params[i][k]).contiguous() for i, k in
          ((0, "b"), (1, "w"), (1, "b"), (2, "w"), (2, "b"))))
