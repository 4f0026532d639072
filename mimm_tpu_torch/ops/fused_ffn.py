"""Fused BERT FFN: ``gelu_tanh(x·w1 + b1)·w2 + b2`` with its gradient
(mimm_tpu/ops/fused_ffn.py counterpart, queue B rows 8-11).

``fused_ffn(x, w1, b1, w2, b2)`` takes JAX's shapes, x (T, d), w1 (d, f),
b1 (f,), w2 (f, d), b2 (d,), all float32 or all bfloat16, and is a
``torch.autograd.Function`` that saves (x, w1, w2, h) as JAX's ``_ffn_fwd``
does (:171), h being the pre-GELU activation rounded to the compute dtype.
For CUDA tensors the forward launches ``csrc/fused_ffn_fwd.cu`` and the
backward the three kernels of ``csrc/fused_ffn_bwd.cu`` (A: dx and dh; B1:
dw1 and db1; B2: dw2); ``db2 = Σ_rows dy`` is a plain sum, as in JAX (:217).
In bfloat16, B1 and B2 split T into ranges by the card's SM count and add
the ranges' float32 partials in a fixed order; the wrapper allocates their
workspace (``_workspace``).
For CPU tensors each kernel's wrapper computes its plain version, the same
function in plain PyTorch with the kernels' casts: every product sums in
float32, the forward applies the GELU to the float32 h before rounding it,
the backward sees h as saved, g is rounded to the compute dtype before
``g·w2`` and dh before ``dh·w1ᵀ``.  There is no fallback from CUDA to the
plain versions: a CUDA call launches the kernels or raises.

The kernels read the weights where ``torch.nn.Linear`` keeps them, (out,
in) row-major: a ``w1`` that is the transposed view of a contiguous (f, d)
tensor (``intermediate.dense.weight.t()``) and a ``w2`` that is the view of
a contiguous (d, f) one are passed by pointer, and their gradients come
back as views of the same layout; a row-major ``w1`` or ``w2`` is copied
once per call into that layout.

d and f must be multiples of 128, as in JAX; the kernels take d <= 1024.
T is arbitrary: tail rows are masked in the kernels, where JAX pads.
"""

from __future__ import annotations

import collections
import ctypes

import torch

# launches of each kernel since the last reset_launch_counts(); a wrapper
# adds one exactly where it launches its kernel
LAUNCHES: collections.Counter = collections.Counter()
FWD_SOURCE = "fused_ffn_fwd"      # csrc/fused_ffn_fwd.cu
BWD_SOURCE = "fused_ffn_bwd"      # csrc/fused_ffn_bwd.cu
KERNELS = {"fwd": "fused_ffn_fwd",          # row 8: y, h
           "bwd_a": "fused_ffn_bwd_a",      # row 9: dx, dh
           "bwd_b1": "fused_ffn_bwd_b1",    # row 10: dw1, db1
           "bwd_b2": "fused_ffn_bwd_b2"}    # row 11: dw2
LANES = 128
MAX_D = 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SQRT_2_OVER_PI = 0.7978845608028654
_GELU_C = 0.044715


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def gelu_tanh(h: torch.Tensor) -> torch.Tensor:
    u = _SQRT_2_OVER_PI * (h + _GELU_C * h * h * h)
    return 0.5 * h * (1.0 + torch.tanh(u))


def dgelu_tanh(h: torch.Tensor) -> torch.Tensor:
    u = _SQRT_2_OVER_PI * (h + _GELU_C * h * h * h)
    t = torch.tanh(u)
    du = _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_C * h * h)
    return 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * du


def _acc(t: torch.Tensor) -> torch.Tensor:
    """The dtype the sums run in: float32 (float64 for float64 inputs,
    which only the CPU takes, for gradient checks)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


# ---- the plain versions -------------------------------------------------------

def fwd_plain(x, w1, b1, w2, b2):
    """(y, h) of row 8 in plain PyTorch."""
    h = _acc(x) @ _acc(w1) + _acc(b1)
    g = gelu_tanh(h).to(x.dtype)
    y = _acc(g) @ _acc(w2) + _acc(b2)
    return y.to(x.dtype), h.to(x.dtype)


def bwd_a_plain(dy, h, w1, w2):
    """(dx, dh) of row 9."""
    dh = (_acc(dy) @ _acc(w2).t() * dgelu_tanh(_acc(h))).to(dy.dtype)
    return (_acc(dh) @ _acc(w1).t()).to(dy.dtype), dh


def bwd_b1_plain(x, dh):
    """(dw1, db1) of row 10, in the sums' dtype."""
    return _acc(x).t() @ _acc(dh), _acc(dh).sum(0)


def bwd_b2_plain(dy, h):
    """dw2 of row 11, in the sums' dtype."""
    return _acc(gelu_tanh(_acc(h)).to(dy.dtype)).t() @ _acc(dy)


def fused_ffn_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """The forward in plain PyTorch, with the kernel's casts."""
    return fwd_plain(x, w1, b1, w2, b2)[0]


def fused_ffn_bwd_plain(x, w1, b1, w2, b2, dy):
    """(dx, dw1, db1, dw2, db2) for the cotangent dy, written out with the
    kernels' formulas and casts (no autograd), as JAX's ``_ffn_bwd``."""
    h = fwd_plain(x, w1, b1, w2, b2)[1]
    dx, dh = bwd_a_plain(dy, h, w1, w2)
    dw1, db1 = bwd_b1_plain(x, dh)
    dw2 = bwd_b2_plain(dy, h)
    return (dx, dw1.to(w1.dtype), db1.to(w1.dtype), dw2.to(w2.dtype),
            _acc(dy).sum(0).to(w2.dtype))


# ---- the kernels' wrappers -------------------------------------------------------

def _check(tensors, t: int, d: int, f: int) -> None:
    """What both the kernels and the plain versions take."""
    dtypes = {a.dtype for a in tensors}
    allowed = set(_DTYPE_CODES) | (
        {torch.float64} if tensors[0].device.type == "cpu" else set())
    if len(dtypes) != 1 or not dtypes <= allowed:
        raise TypeError(f"the fused FFN takes float32 or bfloat16 tensors of "
                        f"one dtype; got {sorted(map(str, dtypes))}")
    if len({a.device for a in tensors}) != 1:
        raise ValueError("the fused FFN's tensors lie on different devices")
    if t < 1 or d % LANES or f % LANES or min(d, f) < LANES:
        raise ValueError(f"the fused FFN takes d and f that are multiples of "
                         f"{LANES} and T >= 1; got (T, d, f) = {(t, d, f)}")


def _check_kernel(t: int, d: int, f: int) -> None:
    if d > MAX_D or t * max(d, f) >= 2 ** 31:
        raise ValueError(f"the fused FFN kernels take d <= {MAX_D} and "
                         f"T·f < 2^31; got (T, d, f) = {(t, d, f)}")


def _dense(a: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, copied only if it is not."""
    a = a.contiguous()
    return a if a.data_ptr() % 16 == 0 else a.clone()


def _stored(w: torch.Tensor) -> torch.Tensor:
    """The (out, in) storage of a weight given as (in, out): the view's
    base if ``w`` is the transpose of a contiguous tensor, else a copy."""
    return _dense(w.t())


def _launch(fn, like: torch.Tensor, *args) -> int:
    """Call a kernel's C entry point on ``like``'s card and its current
    stream (the last argument); returns the cudaError_t."""
    with torch.cuda.device(like.device):
        return fn(*args, torch.cuda.current_stream(like.device).cuda_stream)


def _entry(source: str, name: str, pointers: int, ints: int = 4):
    from mimm_tpu_torch.ops import _build

    fn = getattr(_build.load(source), name)
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _run(kind: str, source: str, pointers, like: torch.Tensor, shape,
         *extra: int) -> None:
    """Launch kernel ``kind`` on ``pointers`` (None for a null one) + (T,
    d, f, dtype code, *extra) and count it; raises if the launch is
    refused."""
    _check_kernel(*shape)
    fn = _entry(source, f"mimm_{KERNELS[kind]}", len(pointers),
                4 + len(extra))
    err = _launch(fn, like, *(None if p is None else p.data_ptr()
                              for p in pointers), *shape,
                  _DTYPE_CODES[like.dtype], *extra)
    if err != 0:
        raise RuntimeError(f"{KERNELS[kind]} launch failed: cudaError_t {err}"
                           f" at (T, d, f) = {shape}, {like.dtype}")
    LAUNCHES[KERNELS[kind]] += 1


def _sm_count(like: torch.Tensor) -> int:
    """The SM count of ``like``'s card: the bfloat16 weight-gradient
    kernels split T by it."""
    return torch.cuda.get_device_properties(like.device).multi_processor_count


def _workspace(like: torch.Tensor, t: int, d: int, f: int, sms: int):
    """The float32 workspace of the bfloat16 B1 / B2 kernels' partial sums
    over ranges of T (their C entry point sizes it); None for one range or
    float32."""
    if like.dtype != torch.bfloat16:
        return None
    from mimm_tpu_torch.ops import _build

    fn = _build.load(BWD_SOURCE).mimm_fused_ffn_bwd_b_workspace
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    n = fn(t, d, f, sms)
    return torch.empty(n, dtype=torch.float32, device=like.device) \
        if n else None


def fwd_kernel(x, w1, b1, w2, b2):
    (t, d), f = x.shape, w1.shape[1]
    y = torch.empty(t, d, dtype=x.dtype, device=x.device)
    h = torch.empty(t, f, dtype=x.dtype, device=x.device)
    _run("fwd", FWD_SOURCE, (_dense(x), _stored(w1), _dense(b1), _stored(w2),
                             _dense(b2), y, h), x, (t, d, f))
    return y, h


def bwd_a_kernel(dy, h, w1, w2):
    (t, d), f = dy.shape, h.shape[1]
    dx = torch.empty(t, d, dtype=dy.dtype, device=dy.device)
    dh = torch.empty(t, f, dtype=dy.dtype, device=dy.device)
    _run("bwd_a", BWD_SOURCE, (_dense(dy), _dense(h), _stored(w1),
                               _stored(w2), dx, dh), dy, (t, d, f))
    return dx, dh


def bwd_b1_kernel(x, dh):
    """dw1 comes back as the transposed view of a contiguous (f, d)
    tensor, the layout of ``intermediate.dense.weight``."""
    (t, d), f = x.shape, dh.shape[1]
    dw1 = torch.empty(f, d, dtype=torch.float32, device=x.device)
    db1 = torch.empty(f, dtype=torch.float32, device=x.device)
    sms = _sm_count(x)
    _run("bwd_b1", BWD_SOURCE, (_dense(x), _dense(dh), dw1, db1,
                                _workspace(x, t, d, f, sms)), x, (t, d, f),
         sms)
    return dw1.t(), db1


def bwd_b2_kernel(dy, h):
    """dw2 comes back as the transposed view of a contiguous (d, f)
    tensor, the layout of ``output.dense.weight``."""
    (t, d), f = dy.shape, h.shape[1]
    dw2 = torch.empty(d, f, dtype=torch.float32, device=dy.device)
    sms = _sm_count(dy)
    _run("bwd_b2", BWD_SOURCE, (_dense(dy), _dense(h), dw2,
                                _workspace(dy, t, d, f, sms)), dy, (t, d, f),
         sms)
    return dw2.t()


def fwd(x, w1, b1, w2, b2):
    """Row 8: (y (T, d), h (T, f)) in x's dtype; the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    (t, d), f = x.shape, w1.shape[1]
    _check((x, w1, b1, w2, b2), t, d, f)
    if (tuple(w1.shape), tuple(b1.shape), tuple(w2.shape), tuple(b2.shape)) \
            != ((d, f), (f,), (f, d), (d,)):
        raise ValueError(f"x (T, d), w1 (d, f), b1 (f,), w2 (f, d), b2 (d,); "
                         f"got {[tuple(a.shape) for a in (x, w1, b1, w2, b2)]}")
    return (fwd_kernel if x.is_cuda else fwd_plain)(x, w1, b1, w2, b2)


def bwd_a(dy, h, w1, w2):
    """Row 9: (dx (T, d), dh (T, f)) in dy's dtype."""
    _check((dy, h, w1, w2), dy.shape[0], dy.shape[1], h.shape[1])
    return (bwd_a_kernel if dy.is_cuda else bwd_a_plain)(dy, h, w1, w2)


def bwd_b1(x, dh):
    """Row 10: (dw1 (d, f), db1 (f,)) in float32."""
    _check((x, dh), x.shape[0], x.shape[1], dh.shape[1])
    return (bwd_b1_kernel if x.is_cuda else bwd_b1_plain)(x, dh)


def bwd_b2(dy, h):
    """Row 11: dw2 (f, d) in float32."""
    _check((dy, h), dy.shape[0], dy.shape[1], h.shape[1])
    return (bwd_b2_kernel if dy.is_cuda else bwd_b2_plain)(dy, h)


class _FusedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        y, h = fwd(x, w1, b1, w2, b2)
        ctx.save_for_backward(x, w1, w2, h)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w1, w2, h = ctx.saved_tensors
        dy = dy.contiguous()
        dx, dh = bwd_a(dy, h, w1, w2)
        dw1, db1 = bwd_b1(x, dh)
        dw2 = bwd_b2(dy, h)
        db2 = _acc(dy).sum(0)
        return (dx, dw1.to(w1.dtype), db1.to(w1.dtype), dw2.to(w2.dtype),
                db2.to(w2.dtype))


def fused_ffn(x, w1, b1, w2, b2) -> torch.Tensor:
    """tanh-GELU FFN ``gelu(x @ w1 + b1) @ w2 + b2``; x: (T, d), w1: (d,
    f), b1: (f,), w2: (f, d), b2: (d,)."""
    return _FusedFFN.apply(x, w1, b1, w2, b2)
