"""The ResNet stem's shallow 3x3 convolution with its gradient
(mimm_tpu/ops/shallow_conv.py counterpart, queue B rows 12-14).

``shallow_conv3x3(x, weight, out_dtype)``: a 3x3, stride 1, zero-pad 1
convolution of a one-channel image ``x`` ((B, H, W, 1) NHWC, as JAX's
:178 takes it) with ``weight`` (C, 1, 3, 3), the port's
``conv1.weight``, in float32.  It returns (B, C, H, W) NCHW in
``out_dtype``, the layout the port's tower runs in.  Every product and sum
is float32 (float64 for float64 inputs, which only the CPU takes, for
gradient checks); a bfloat16 image is widened to float32 first, as JAX's
``x.astype(jnp.float32)`` (:186) does, and each output is rounded once.

It is a ``torch.autograd.Function``: the forward runs kernel row 12, the
backward row 13 for the weight gradient ((C, 1, 3, 3) in float32), and row
14 for the image's gradient only when ``ctx.needs_input_grad[0]``.  On the
training path the image is data, so the dx kernel never runs there, as XLA
drops JAX's (:35-36).

For CUDA tensors each wrapper launches its kernel in
``csrc/shallow_conv.cu`` (which takes C = 8, the stem's width) or raises;
for CPU tensors it computes the plain version: JAX's nine shifted
multiply-adds over a zero-padded view, in JAX's order (the forward sums its
taps k = dr·3 + dc one by one, the input gradient sums (dr, dc, c) from
zero), written without ``F.conv2d``, whose float32 oneDNN backward is not
safe on every CPU build.  The forward and dx kernels round as these plain
versions do, product by product, so in float32 the two agree to the bit;
dW sums its 4.2 M terms a step in another order.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

# launches of each kernel since the last reset_launch_counts(); a wrapper
# adds one exactly where it launches its kernel
LAUNCHES: collections.Counter = collections.Counter()
SOURCE = "shallow_conv"           # csrc/shallow_conv.cu
KERNELS = {"fwd": "shallow_conv_fwd",      # row 12: y
           "dw": "shallow_conv_dw",        # row 13: dw (both passes)
           "dx": "shallow_conv_dx"}        # row 14: dx
KERNEL_CHANNELS = 8
TAPS = 9
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def _acc(t: torch.Tensor) -> torch.Tensor:
    """The dtype the sums run in: float32 (float64 for float64 inputs)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _image(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W) view of a (B, H, W, 1) NHWC image: the layout is the
    caller's, never guessed from the shape (an image of H = 1 is (B, 1, W,
    1))."""
    return x[..., 0]


# ---- the plain versions -----------------------------------------------------

def fwd_plain(x, weight, out_dtype):
    """Row 12: y (B, C, H, W) in ``out_dtype``."""
    xi = _acc(_image(x))
    h, w = xi.shape[1:]
    xp = F.pad(xi, (1, 1, 1, 1))
    w9 = _acc(weight).reshape(weight.shape[0], TAPS)
    acc = None
    for k in range(TAPS):
        dr, dc = divmod(k, 3)
        term = xp[:, None, dr:dr + h, dc:dc + w] * w9[:, k].view(1, -1, 1, 1)
        acc = term if acc is None else acc + term
    return acc.to(out_dtype)


def dw_plain(x, dy):
    """Row 13: dw (C, 1, 3, 3) in the sums' dtype."""
    xi = _acc(_image(x))
    h, w = xi.shape[1:]
    xp = F.pad(xi, (1, 1, 1, 1))
    g = _acc(dy)
    cols = [(xp[:, None, dr:dr + h, dc:dc + w] * g).sum(dim=(0, 2, 3))
            for dr in range(3) for dc in range(3)]
    return torch.stack(cols, dim=1).reshape(dy.shape[1], 1, 3, 3)


def dx_plain(dy, weight, dtype):
    """Row 14: dx (B, H, W) in ``dtype``."""
    g = _acc(dy)
    h, w = g.shape[2:]
    gp = F.pad(g, (1, 1, 1, 1))
    w9 = _acc(weight).reshape(weight.shape[0], TAPS)
    acc = torch.zeros(g.shape[0], h, w, dtype=g.dtype, device=g.device)
    for k in range(TAPS):
        dr, dc = divmod(k, 3)
        for c in range(g.shape[1]):
            acc = acc + gp[:, c, 2 - dr:2 - dr + h, 2 - dc:2 - dc + w] \
                * w9[c, k]
    return acc.to(dtype)


# ---- the kernels' wrappers --------------------------------------------------

def _launch(fn, like: torch.Tensor, *args) -> int:
    """Call a kernel's C entry point on ``like``'s card and its current
    stream (the last argument); returns the cudaError_t."""
    with torch.cuda.device(like.device):
        return fn(*args, torch.cuda.current_stream(like.device).cuda_stream)


@functools.lru_cache(maxsize=None)
def _entry(name: str, pointers: int, ints: int, stream: bool = True):
    """The C entry point ``name``, typed once: the kernels take tens of
    microseconds, so a wrapper's host time is part of what a caller sees."""
    from mimm_tpu_torch.ops import _build

    fn = getattr(_build.load(SOURCE), name)
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints \
        + [ctypes.c_void_p] * stream
    fn.restype = ctypes.c_int
    return fn


def _run(kind: str, pointers, like: torch.Tensor, shape, codes) -> None:
    """Launch kernel ``kind`` on ``pointers`` + (B, H, W, C) + dtype codes
    and count it; raises if the launch is refused."""
    fn = _entry(f"mimm_{KERNELS[kind]}", len(pointers), 4 + len(codes))
    err = _launch(fn, like, *(p.data_ptr() for p in pointers), *shape, *codes)
    if err != 0:
        raise RuntimeError(f"{KERNELS[kind]} launch failed: cudaError_t {err}"
                           f" at (B, H, W, C) = {shape}, dtype codes {codes}")
    LAUNCHES[KERNELS[kind]] += 1


def _w_rows(weight: torch.Tensor) -> torch.Tensor:
    """The float32 (C, 9) weight, copied only if it is not."""
    return weight.to(torch.float32).contiguous()


def fwd_kernel(x, weight, out_dtype):
    xi = _image(x)
    (b, h, w), c = xi.shape, weight.shape[0]
    y = torch.empty(b, c, h, w, dtype=out_dtype, device=x.device)
    _run("fwd", (xi, _w_rows(weight), y), x, (b, h, w, c),
         (_DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype]))
    return y


def dw_kernel(x, dy):
    """dw comes back as (C, 1, 3, 3) float32, conv1.weight's layout."""
    xi = _image(x)
    (b, h, w), c = xi.shape, dy.shape[1]
    blocks = _entry("mimm_shallow_conv_dw_blocks", 0, 3, False)(b, h, w)
    part = torch.empty(blocks, c * TAPS, dtype=torch.float32, device=x.device)
    out = torch.empty(c, 1, 3, 3, dtype=torch.float32, device=x.device)
    _run("dw", (xi, dy, part, out), x, (b, h, w, c),
         (_DTYPE_CODES[x.dtype], _DTYPE_CODES[dy.dtype]))
    return out


def dx_kernel(dy, weight, dtype):
    (b, c, h, w) = dy.shape
    out = torch.empty(b, h, w, dtype=dtype, device=dy.device)
    _run("dx", (dy, _w_rows(weight), out), dy, (b, h, w, c),
         (_DTYPE_CODES[dy.dtype], _DTYPE_CODES[dtype]))
    return out


def _check_dtypes(device: torch.device, *dtypes) -> None:
    allowed = set(_DTYPE_CODES) | (
        {torch.float64} if device.type == "cpu" else set())
    if not set(dtypes) <= allowed:
        raise TypeError(f"the shallow conv takes float32 or bfloat16 (float64 "
                        f"on the CPU); got {[str(d) for d in dtypes]}")


def _check(weight: torch.Tensor, image_shape, tensors) -> None:
    """What both the kernels and the plain versions take, for an image of
    ``image_shape`` (B, H, W); the kernels also C = 8 and fewer than 2^31
    output elements."""
    if weight.dim() != 4 or weight.shape[1] != 1:
        raise ValueError(f"the shallow conv takes C_in = 1: weight (C, 1, 3, "
                         f"3); got {tuple(weight.shape)}")
    if tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"the shallow conv takes a 3x3 kernel; got "
                         f"{tuple(weight.shape)}")
    if len({t.device for t in (weight, *tensors)}) != 1:
        raise ValueError("the shallow conv's tensors lie on different devices")
    if not all(t.is_contiguous() for t in (weight, *tensors)):
        raise ValueError("the shallow conv takes contiguous tensors")
    _check_dtypes(weight.device, *(t.dtype for t in (weight, *tensors)))
    if weight.dtype == torch.bfloat16:
        raise TypeError("the shallow conv's weight is float32")
    b, h, w = image_shape
    if weight.is_cuda and (weight.shape[0] != KERNEL_CHANNELS
                           or b * h * w * KERNEL_CHANNELS >= 2 ** 31):
        raise ValueError(f"the shallow conv kernels take C = "
                         f"{KERNEL_CHANNELS} and B·C·H·W < 2^31; got "
                         f"(B, H, W, C) = {(b, h, w, weight.shape[0])}")


def _image_shape(x: torch.Tensor):
    if x.dim() != 4 or x.shape[3] != 1:
        raise ValueError(f"the shallow conv takes a one-channel NHWC image "
                         f"(B, H, W, 1); got {tuple(x.shape)}")
    return tuple(_image(x).shape)


def fwd(x, weight, out_dtype):
    """Row 12: y (B, C, H, W) in ``out_dtype``; the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check(weight, _image_shape(x), (x,))
    _check_dtypes(x.device, out_dtype)
    return (fwd_kernel if x.is_cuda else fwd_plain)(x, weight, out_dtype)


def dw(x, dy, weight):
    """Row 13: dw (C, 1, 3, 3) in float32 (float64 for float64 inputs)."""
    shape = _image_shape(x)
    if tuple(dy.shape) != (shape[0], weight.shape[0], *shape[1:]):
        raise ValueError(f"dy (B, C, H, W) = {tuple(dy.shape)} does not match "
                         f"x {tuple(x.shape)} and weight "
                         f"{tuple(weight.shape)}")
    _check(weight, shape, (x, dy))
    return (dw_kernel if x.is_cuda else dw_plain)(x, dy)


def dx(dy, weight, dtype):
    """Row 14: dx (B, H, W) in ``dtype``."""
    if dy.dim() != 4 or dy.shape[1] != weight.shape[0]:
        raise ValueError(f"dy (B, C, H, W) = {tuple(dy.shape)} does not match "
                         f"weight {tuple(weight.shape)}")
    _check(weight, (dy.shape[0], *dy.shape[2:]), (dy,))
    _check_dtypes(dy.device, dtype)
    return (dx_kernel if dy.is_cuda else dx_plain)(dy, weight, dtype)


class _ShallowConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, out_dtype):
        ctx.save_for_backward(x, weight)
        return fwd(x, weight, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy = dy.contiguous()
        dweight = dw(x, dy, weight).to(weight.dtype)
        dimage = dx(dy, weight, x.dtype).reshape(x.shape) \
            if ctx.needs_input_grad[0] else None
        return dimage, dweight, None


def shallow_conv3x3(x: torch.Tensor, weight: torch.Tensor,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """3x3 / stride-1 / pad-1 convolution of a one-channel image: x (B, H,
    W, 1) NHWC, weight (C, 1, 3, 3) float32; returns (B, C, H, W) in
    ``out_dtype``."""
    return _ShallowConv.apply(x, weight, out_dtype)
