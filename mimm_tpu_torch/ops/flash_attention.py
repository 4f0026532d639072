"""Fused attention: ctx = dropout(softmax(Q Kᵀ/√D + key_bias)) · V, with
its gradient.

Counterpart of mimm_tpu/ops/flash_attention.py ``flash_attention`` (the
``custom_vjp`` at :202).  ``flash_attention`` is a ``torch.autograd.Function``
that saves q, k, v, bias and the seed, as the JAX residuals do.  For CUDA
tensors the forward launches ``csrc/flash_attention_fwd.cu`` and the
backward ``csrc/flash_attention_bwd.cu``; for CPU tensors the forward is
``flash_attention_plain``, the same function in plain PyTorch with the same
dtype steps, and the backward is autograd through it.  There is no fallback
from CUDA to the plain version: a CUDA call launches the kernel or raises.
The forward is the operator ``mimm_tpu_torch::flash_attention_fwd``
(``torch.library.custom_op``: the kernel for CUDA tensors, the plain
version for CPU tensors, a fake that allocates for tracers), so that
``torch.export`` records one node where the kernel runs
(tools/export_serving.py); the backward stays in the autograd Function.

Dropout on the probabilities (``rate > 0``) keeps element (b, h, i, j) by a
Philox4x32-10 draw keyed on the seed (ops/philox.py), the same bits in both
kernels and the plain version.  They are not the TPU's on-core PRNG bits.
A tensor-parallel rank that holds heads h0 .. h0+H-1 of H_total passes
``head_offset=h0, heads_total=H_total`` and draws those heads' bits of the
whole attention's mask (JAX's Pallas call sees the global heads under
GSPMD); the defaults (0, H) give the single-rank bits.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from mimm_tpu_torch.ops.philox import attention_keep_mask, keep_threshold

# launches of each kernel since the last reset_launch_counts(); a wrapper
# adds one exactly where it launches its kernel
LAUNCHES: collections.Counter = collections.Counter()
SOURCE = "flash_attention_fwd"        # csrc/flash_attention_fwd.cu
BWD_SOURCE = "flash_attention_bwd"    # csrc/flash_attention_bwd.cu
# one template instantiation of each source per input dtype
KERNELS = {torch.float32: "flash_attention_fwd_f32",
           torch.bfloat16: "flash_attention_fwd_bf16"}
BWD_KERNELS = {torch.float32: "flash_attention_bwd_f32",
               torch.bfloat16: "flash_attention_bwd_bf16"}
MAX_SEQ_LEN = 512
HEAD_DIM = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def keep_scale(rate: float) -> float:
    """1/(1 - rate) rounded to float32, the factor of a kept probability."""
    return torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32).item()


def flash_attention_plain(q, k, v, bias, seed=None, rate: float = 0.0,
                          head_offset: int = 0, heads_total=None):
    """The kernel's function in plain PyTorch, with its dtype steps: f32
    scores, f32 whole-row softmax, at ``rate > 0`` the Philox mask times
    1/(1 - rate) in f32, probabilities cast to the input dtype before an
    f32-accumulated P·V, output in the input dtype.  float64 inputs keep
    float64 throughout (gradient checks)."""
    dt = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.matmul(q.to(dt), k.to(dt).transpose(-1, -2))
    s = s * scale + bias.to(dt)[:, None, None, :]
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = e / e.sum(dim=-1, keepdim=True)
    if rate > 0.0:
        B, H, L, _ = q.shape
        keep = attention_keep_mask(seed, B, H, L, rate,
                                   head_offset=head_offset,
                                   heads_total=heads_total)
        p = p * torch.where(keep, keep_scale(rate), 0.0).to(dt)
    p = p.to(v.dtype)
    return torch.matmul(p.to(dt), v.to(dt)).to(q.dtype)


def _check(q, k, v, bias, seed, rate, head_offset=0, heads_total=None):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share a (B, H, L, D) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, L, _ = q.shape
    total = H if heads_total is None else heads_total
    if head_offset < 0 or head_offset + H > total:
        raise ValueError(f"heads {head_offset}..{head_offset + H - 1} are "
                         f"not among heads_total={total}")
    if tuple(bias.shape) != (B, L):
        raise ValueError(f"bias must be (B, L) = {(B, L)}, got "
                         f"{tuple(bias.shape)}")
    dtypes = set(_DTYPE_CODES) | ({torch.float64} if q.device.type == "cpu"
                                  else set())
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"bias must be float32, got {bias.dtype}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    tensors = [q, k, v, bias]
    if rate > 0.0:
        if seed is None or seed.numel() != 1 or seed.dtype != torch.int32:
            raise ValueError("rate > 0 needs the seed as an int32 tensor of "
                             "one element")
        tensors.append(seed)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"q, k, v, bias, seed on different devices: {devices}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def _kernel_args(tensors, rate, head_offset=0, heads_total=None):
    """Shape checks of the CUDA kernels; returns (B, H, L, D) and the
    dropout arguments (flag, threshold, keep scale, head offset, heads
    total)."""
    B, H, L, D = tensors[0].shape
    if D != HEAD_DIM or not 1 <= L <= MAX_SEQ_LEN:
        raise ValueError(f"the kernel takes D={HEAD_DIM} and "
                         f"1 <= L <= {MAX_SEQ_LEN}; got D={D}, L={L}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, k, v, bias (and dO) must be contiguous")
    drop = (1, keep_threshold(rate), keep_scale(rate)) if rate > 0.0 \
        else (0, 0, 1.0)
    return (B, H, L, D), drop + (head_offset,
                                 H if heads_total is None else heads_total)


def _launch(fn, like: torch.Tensor, *args) -> int:
    """Call a kernel's C entry point on ``like``'s card and its current
    stream (the last argument); returns the cudaError_t."""
    with torch.cuda.device(like.device):
        return fn(*args, torch.cuda.current_stream(like.device).cuda_stream)


def _forward_kernel(q, k, v, bias, seed, rate, head_offset=0,
                    heads_total=None):
    from mimm_tpu_torch.ops import _build

    (B, H, L, D), drop = _kernel_args((q, k, v, bias), rate, head_offset,
                                      heads_total)
    fn = _build.load(SOURCE).mimm_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_uint, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    err = _launch(fn, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  bias.data_ptr(), seed.data_ptr() if drop[0] else None,
                  out.data_ptr(), B, H, L, D, 1.0 / (D ** 0.5), *drop,
                  _DTYPE_CODES[q.dtype])
    if err != 0:
        raise RuntimeError(f"{KERNELS[q.dtype]} launch failed: cudaError_t "
                           f"{err} at (B,H,L,D)={(B, H, L, D)}, {q.dtype}")
    LAUNCHES[KERNELS[q.dtype]] += 1
    return out


def _backward_kernel(q, k, v, bias, seed, rate, do, head_offset=0,
                     heads_total=None):
    from mimm_tpu_torch.ops import _build

    (B, H, L, D), drop = _kernel_args((q, k, v, bias, do), rate, head_offset,
                                      heads_total)
    if do.dtype != q.dtype:
        raise TypeError(f"dO must be {q.dtype}, got {do.dtype}")
    fn = _build.load(BWD_SOURCE).mimm_flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_uint, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = torch.empty(3 * B * H * L, device=q.device, dtype=torch.float32)
    # the keep bits of the mask, written by the bfloat16 kernel's first
    # pass and read by its second: one bit a probability
    bits = torch.empty(B * H * L * -(-L // 32), device=q.device,
                       dtype=torch.int32) \
        if drop[0] and q.dtype == torch.bfloat16 else None
    err = _launch(fn, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  bias.data_ptr(), seed.data_ptr() if drop[0] else None,
                  do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  stats.data_ptr(), None if bits is None else bits.data_ptr(),
                  B, H, L, D, 1.0 / (D ** 0.5), *drop, _DTYPE_CODES[q.dtype])
    if err != 0:
        raise RuntimeError(f"{BWD_KERNELS[q.dtype]} launch failed: "
                           f"cudaError_t {err} at (B,H,L,D)={(B, H, L, D)}, "
                           f"{q.dtype}")
    LAUNCHES[BWD_KERNELS[q.dtype]] += 1
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, bias, seed, rate, do,
                              head_offset: int = 0, heads_total=None):
    """dq, dk, dv by autograd through ``flash_attention_plain`` (the mask
    regenerated from the seed): what the backward kernel is held against."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention_plain(*qkv, bias, seed, rate, head_offset,
                                    heads_total)
        return torch.autograd.grad(out, qkv, do)


def flash_attention_bwd(q, k, v, bias, seed, rate, do, head_offset: int = 0,
                        heads_total=None):
    """The backward on its own: the kernel for CUDA tensors, the plain
    autograd for CPU tensors."""
    if q.device.type == "cuda":
        return _backward_kernel(q, k, v, bias, seed, rate, do.contiguous(),
                                head_offset, heads_total)
    return flash_attention_bwd_plain(q, k, v, bias, seed, rate, do,
                                     head_offset, heads_total)


# the forward as a registered operator, so that torch.export and other
# tracers see one node where the kernel runs (tools/export_serving.py):
# the kernel for CUDA tensors, the plain version for CPU tensors, and for
# tracing a fake that only allocates (it launches and counts nothing)
@torch.library.custom_op(
    "mimm_tpu_torch::flash_attention_fwd", mutates_args=(),
    device_types="cuda",
    schema="(Tensor q, Tensor k, Tensor v, Tensor bias, Tensor? seed, "
           "float rate, int head_offset, int heads_total) -> Tensor")
def flash_attention_fwd(q, k, v, bias, seed, rate, head_offset, heads_total):
    return _forward_kernel(q, k, v, bias, seed, rate, head_offset,
                           heads_total)


@flash_attention_fwd.register_kernel("cpu")
def _flash_attention_fwd_cpu(q, k, v, bias, seed, rate, head_offset,
                             heads_total):
    return flash_attention_plain(q, k, v, bias, seed, rate, head_offset,
                                 heads_total)


@flash_attention_fwd.register_fake
def _flash_attention_fwd_fake(q, k, v, bias, seed, rate, head_offset,
                              heads_total):
    return torch.empty_like(q)


class _FlashAttention(torch.autograd.Function):
    """The operator's forward with the backward kernel (or the plain
    autograd on the CPU) as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, rate, head_offset, heads_total):
        ctx.save_for_backward(q, k, v, bias, seed)
        ctx.rate = rate
        ctx.heads = (head_offset, heads_total)
        return flash_attention_fwd(q, k, v, bias, seed, rate, head_offset,
                                   heads_total)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, seed = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, bias, seed, ctx.rate, do,
                                         *ctx.heads)
        # no gradient for the bias and the seed (JAX returns zeros)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, bias, seed=None, rate: float = 0.0,
                    whole_sample: bool = False, head_offset: int = 0,
                    heads_total=None):
    """q, k, v: (B, H, L, D); bias: (B, L) float32 additive key bias; seed:
    an int32 tensor of one element (needed at ``rate > 0``); ``rate``:
    dropout on the probabilities; ``head_offset`` / ``heads_total``: where
    the H heads sit among the whole attention's (a tensor-parallel rank's
    share; default 0 and H), which keys their dropout bits.  Returns the
    context (B, H, L, D) in q's dtype, differentiable in q, k and v.

    ``whole_sample`` selected a TPU grid; both grids are one function and
    take the same kernels here."""
    del whole_sample
    _check(q, k, v, bias, seed, rate, head_offset, heads_total)
    return _FlashAttention.apply(q, k, v, bias, seed, float(rate),
                                 int(head_offset),
                                 q.shape[1] if heads_total is None
                                 else int(heads_total))
