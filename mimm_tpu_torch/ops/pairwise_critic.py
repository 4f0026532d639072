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
its backward the four kernels of ``csrc/pairwise_critic_bwd.cu``.  Row 6,
the JAX ``_bwd_img_kernel``, runs on the tensor cores in 3xTF32 (each
float32 operand split into two tf32 parts, three ``mma.sync`` a product,
about float32's accuracy) as three pair products: ``bwd_img`` recomputes z2
once and gives dh_img, db2, dw3, db3 and the z2 > 0 bits (one bit a pair
and H2 column, B_img·B_txt·H2/8 bytes, 268 MB at 2048²), ``bwd_w`` the dW2
partials from those bits, ``bwd_reduce`` the fixed-order sums.  Past
``BITS_BUDGET_BYTES`` of bits, ``bwd_img`` and ``bwd_w`` run over ranges of
image rows in turn (``bwd_chunk_rows``), ``bwd_w`` adding into the same
partials, so the bits stay within that budget at any batch.  Row 7,
``bwd_txt`` (dh_txt), runs in the same loop, after ``bwd_w`` and on the
same range's bits: one pair product, dt from the bits' mask, in the same
3xTF32 form; the first range writes dh_txt, later ranges add into it, in
order.  So every gradient takes its relu mask of z2 from the same bits.
No buffer of B_img·B_txt·H1 floats exists on that path.  For CPU tensors they are
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
           "bwd_img": "pairwise_critic_bwd_img",    # row 6: dh_img, db2, dw3
           "bwd_w": "pairwise_critic_bwd_w",        # row 6: dW2
           "bwd_reduce": "pairwise_critic_bwd_reduce",  # row 6: the sums
           "bwd_txt": "pairwise_critic_bwd_txt"}    # row 7: dh_txt
MAX_H1 = 1024
MAX_H2 = 512
MAX_SPLITS = 16           # pair ranges of the dW2 kernel (scratch per split)
_W_SPLIT_PAIRS = 256      # fewest pairs a range
_IMG_ROWS = 4             # image rows a bwd_img block owns (csrc IT)
# the z2 > 0 bits of one bwd_img / bwd_w / bwd_txt launch: all of 2048 x
# 2048 pairs at H2 = 512; larger batches take several launches
# (bwd_chunk_rows)
BITS_BUDGET_BYTES = 2 ** 28


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


def _typed(fn, pointers: int, ints: int):
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _forward_kernel(h_img, h_txt, b1, w2, b2, w3, b3) -> torch.Tensor:
    from mimm_tpu_torch.ops import _build

    args = (h_img, h_txt, b1, w2, b2, w3, b3)
    _check_kernel_inputs(args)
    (ni, h1), nj, h2 = h_img.shape, h_txt.shape[0], w2.shape[1]
    fn = _typed(_build.load(FWD_SOURCE).mimm_pairwise_critic_fwd, 8, 4)
    out = torch.empty(ni, nj, dtype=torch.float32, device=h_img.device)
    err = _launch(fn, h_img, *(t.data_ptr() for t in args), out.data_ptr(),
                  ni, nj, h1, h2)
    _launched(err, KERNELS["fwd"], (ni, nj, h1, h2))
    return out


def bwd_splits(n_img: int, n_txt: int) -> int:
    """Pair ranges of the dW2 kernel: enough blocks to fill the card at the
    GradCache shape, never more ranges than chunks of 256 pairs."""
    return max(1, min(MAX_SPLITS, -(-n_img * n_txt // _W_SPLIT_PAIRS)))


def bwd_chunk_rows(n_img: int, n_txt: int, h2: int) -> int:
    """Image rows of one bwd_img / bwd_w / bwd_txt launch: all of them
    while their z2 > 0 bits fit BITS_BUDGET_BYTES, else the most rows, a
    multiple of bwd_img's block, that fit (at least one block)."""
    per_row = n_txt * -(-h2 // 32) * 4
    rows = BITS_BUDGET_BYTES // per_row // _IMG_ROWS * _IMG_ROWS
    return min(n_img, max(_IMG_ROWS, rows))


def _bwd_lib(args):
    """(library, shape) of a backward launch, after the input checks;
    args = (h_img, h_txt, b1, W2, b2, w3, g)."""
    from mimm_tpu_torch.ops import _build

    _check_kernel_inputs(args)
    (ni, h1), nj, h2 = args[0].shape, args[1].shape[0], args[3].shape[1]
    if tuple(args[6].shape) != (ni, nj):
        raise ValueError(f"g must be {(ni, nj)}, got {tuple(args[6].shape)}")
    return _build.load(BWD_SOURCE), (ni, nj, h1, h2)


def _empty(device, *shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(*shape, dtype=dtype, device=device)


def bwd_img_kernel(args, dh: torch.Tensor, vecp: torch.Tensor):
    """Row 6's tensor-core kernel: writes dh_img into ``dh`` (B_img, H1)
    and the per-block partials of db2, dw3 and db3 into ``vecp``
    (ceil(B_img/4), 2·H2 + 1); returns the z2 > 0 bits (B_img·B_txt,
    ceil(H2/32)) int32."""
    lib, (ni, nj, h1, h2) = _bwd_lib(args)
    if not (dh.dtype == vecp.dtype == torch.float32 and dh.is_contiguous()
            and vecp.is_contiguous() and tuple(dh.shape) == (ni, h1)
            and tuple(vecp.shape) == (-(-ni // _IMG_ROWS), 2 * h2 + 1)):
        raise ValueError(f"dh and vecp must be contiguous float32 {(ni, h1)} "
                         f"and {(-(-ni // _IMG_ROWS), 2 * h2 + 1)}")
    fn = _typed(lib.mimm_pairwise_critic_bwd_img, 10, 4)
    bits = _empty(dh.device, ni * nj, -(-h2 // 32), dtype=torch.int32)
    _launched(_launch(fn, dh, *(t.data_ptr() for t in args), dh.data_ptr(),
                      bits.data_ptr(), vecp.data_ptr(), ni, nj, h1, h2),
              KERNELS["bwd_img"], (ni, nj, h1, h2))
    return bits


def _check_bits(bits: torch.Tensor, ni: int, nj: int, h2: int) -> None:
    if bits.dtype != torch.int32 or tuple(bits.shape) != (ni * nj,
                                                          -(-h2 // 32)):
        raise ValueError(f"bits must be int32 {(ni * nj, -(-h2 // 32))}, got "
                         f"{bits.dtype} {tuple(bits.shape)}")


def bwd_txt_kernel(args, bits: torch.Tensor,
                   dh: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row 7: dh_txt (B_txt, H1) from the bits of ``bwd_img_kernel`` on the
    same args, in a new tensor, or added to ``dh``'s values when it is
    given."""
    lib, (ni, nj, h1, h2) = _bwd_lib(args)
    _check_bits(bits, ni, nj, h2)
    accumulate = dh is not None
    if dh is None:
        dh = _empty(args[0].device, nj, h1)
    elif dh.dtype != torch.float32 or tuple(dh.shape) != (nj, h1) \
            or not dh.is_contiguous():
        raise ValueError(f"dh must be contiguous float32 {(nj, h1)}")
    fn = _typed(lib.mimm_pairwise_critic_bwd_txt, 8, 5)
    h_img, h_txt, b1, w2, _, w3, g = args
    _launched(_launch(fn, dh, *(t.data_ptr() for t in (h_img, h_txt, b1, w2,
                                                       w3, g, bits, dh)),
                      ni, nj, h1, h2, int(accumulate)),
              KERNELS["bwd_txt"], (ni, nj, h1, h2))
    return dh


def bwd_w_kernel(args, bits: torch.Tensor, splits: int,
                 dw2p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row 6's dW2 kernel: per-split partials (splits, H1, H2) of dW2 from
    the bits of ``bwd_img_kernel``, in a new tensor, or added to ``dw2p``'s
    values when it is given."""
    lib, (ni, nj, h1, h2) = _bwd_lib(args)
    _check_bits(bits, ni, nj, h2)
    accumulate = dw2p is not None
    if dw2p is None:
        dw2p = _empty(args[0].device, splits, h1, h2)
    elif tuple(dw2p.shape) != (splits, h1, h2) or not dw2p.is_contiguous():
        raise ValueError(f"dw2p must be contiguous {(splits, h1, h2)}")
    fn = _typed(lib.mimm_pairwise_critic_bwd_w, 7, 6)
    h_img, h_txt, b1, _, _, w3, g = args
    _launched(_launch(fn, dw2p, *(t.data_ptr() for t in (h_img, h_txt, b1, w3,
                                                         g, bits, dw2p)),
                      ni, nj, h1, h2, splits, int(accumulate)),
              KERNELS["bwd_w"], (ni, nj, h1, h2))
    return dw2p


def bwd_reduce_kernel(dw2p: torch.Tensor, vecp: torch.Tensor,
                      dh_img: torch.Tensor):
    """(dW2, db1, db2, dw3, db3): the partials' sums and db1 = Σ_i
    dh_img[i], in a fixed order."""
    from mimm_tpu_torch.ops import _build

    splits, h1, h2 = dw2p.shape
    if not all(t.dtype == torch.float32 and t.is_contiguous()
               for t in (dw2p, vecp, dh_img)) or dh_img.shape[1] != h1 \
            or vecp.shape[1] != 2 * h2 + 1:
        raise ValueError("partials and dh_img must be contiguous float32 "
                         "with matching H1 and H2")
    fn = _typed(_build.load(BWD_SOURCE).mimm_pairwise_critic_bwd_reduce, 8, 5)
    dev = dh_img.device
    outs = [_empty(dev, h1, h2), _empty(dev, h1), _empty(dev, h2),
            _empty(dev, h2), _empty(dev, 1)]
    _launched(_launch(fn, dh_img, dw2p.data_ptr(), vecp.data_ptr(),
                      dh_img.data_ptr(), *(t.data_ptr() for t in outs),
                      splits, vecp.shape[0], dh_img.shape[0], h1, h2),
              KERNELS["bwd_reduce"], (dh_img.shape[0], None, h1, h2))
    return outs


def _backward_kernel(h_img, h_txt, b1, w2, b2, w3, g):
    args = (h_img, h_txt, b1, w2, b2, w3, g)
    (ni, h1), nj, h2 = h_img.shape, h_txt.shape[0], w2.shape[1]
    dh_img = _empty(h_img.device, ni, h1)
    vecp = _empty(h_img.device, -(-ni // _IMG_ROWS), 2 * h2 + 1)
    rows, splits = bwd_chunk_rows(ni, nj, h2), bwd_splits(ni, nj)
    dw2p = dh_txt = None
    for r0 in range(0, ni, rows):   # whole blocks of image rows, in order
        r1 = min(ni, r0 + rows)
        part = (h_img[r0:r1], *args[1:6], g[r0:r1])
        bits = bwd_img_kernel(part, dh_img[r0:r1],
                              vecp[r0 // _IMG_ROWS:-(-r1 // _IMG_ROWS)])
        dw2p = bwd_w_kernel(part, bits, splits, dw2p)
        dh_txt = bwd_txt_kernel(part, bits, dh_txt)
        del bits                    # at most BITS_BUDGET_BYTES
    dw2, db1, db2, dw3, db3 = bwd_reduce_kernel(dw2p, vecp, dh_img)
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
