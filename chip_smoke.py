"""Smoke run of the PyTorch port (mimm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a), nvcc and
no arguments.  Phases:

1. versions, the card's name and power limit, and the build of every CUDA
   source of the port (mimm_tpu_torch/csrc, one nvcc each, all started
   together) with ptxas's registers, shared memory and spills;
2. each kernel against its plain PyTorch version on the card at the shapes
   the serving and training paths give it, with a different number of
   padded keys in each row: the flash forward at dropout rate 0 and 0.1,
   the flash backward (dQ, dK, dV) at rate 0 and 0.1, the realized keep
   rate of the Philox mask, and the CUDA Philox against Random123's
   known-answer vectors; the pairwise-critic kernels (S and the seven
   gradients) at (20, 12), (300, 257) and the GradCache step's 2048 x 2048
   pairs, with the reference critic's widths;
3. each kernel's time beside its plain version's and its bound: the flash
   kernels at (64, 12, 320, 64) with one PyTorch library call's
   (``scaled_dot_product_attention`` forward, or its backward alone: a
   yardstick the port never calls), the critic kernels at 2048 x 2048
   pairs with the factorized path (plain PyTorch and cuBLAS) as yardstick;
4. the serving path through its entry point, the HTTP server of
   ``mimm_tpu_torch.cli.serve``, at full width: ResNet256_6_2_1, a 12-layer
   BERT-base TextBert with the flash gate open, and the Pneumonia
   classifier, with random weights from a fixed seed, in a float32 and a
   bfloat16 session and with dynamic batching.  Every response is held
   against a direct forward of the port's models with the plain attention
   path (``flash_attention=False``), and the flash kernel must launch once
   per encoder layer per text batch;
5. the MI pretraining train step at full width through ``create_mi_state``
   / ``make_mi_train_step`` / ``make_mi_multi_step`` (ResNet256_6_2_1,
   12-layer BERT-base, the 1536-1024-512-1 critic, B=64, production
   preset, random weights from seed 0, the compact batch layout): one
   warm-up and 3 timed steps per sequence bucket with ms/step, peak memory
   and flash launches per step (12 forward + 12 backward at L >= 256, none
   below), pairs/s over the bucket mix and at L=320; one float32 L=320
   step at dropout 0 with the flash kernels against the plain attention
   path; ``save_mi_checkpoints`` and a strict reload of its ``.bin`` files;
6. where the device time of one image batch, one text batch and one train
   step at L=64 and at L=320 goes (torch.profiler);
7. GradCache at full width (production preset, L=128) through
   ``make_mi_train_step`` / ``make_mi_multi_step`` with
   ``grad_cache_chunks``: B=256 in 4 chunks (under the critic's switch: no
   critic kernel) and B=2048 in 32 chunks (past it: each critic kernel once
   a step), one warm-up and 2 timed steps each, ms/step, pairs/s, peak
   memory against the B=64 L=128 step's, and the critic's own memory;
8. ``BertConfig.remat``: two B=64 L=320 bf16 steps at dropout 0.1 with
   and without it, from one state (24 flash forward launches a step with
   it, 12 without, 12 backward either way; the same losses);
9. the ``kernels`` JSON line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; without a card it exits before
printing any result.
"""

from __future__ import annotations

import collections
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import ctypes

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from mimm_tpu_torch import checkpoint as ckpt  # noqa: E402
from mimm_tpu_torch.cli.serve import build_server  # noqa: E402
from mimm_tpu_torch.config import (DEFAULT_CLASSIFIER_LAYERS,  # noqa: E402
                                   PRODUCTION_SEQ_BUCKETS, TrainingConfig)
from mimm_tpu_torch.models.bert import BertConfig, TextBert  # noqa: E402
from mimm_tpu_torch.models.joint import ImageReportModel  # noqa: E402
from mimm_tpu_torch.models.mlp import BasicMLP  # noqa: E402
from mimm_tpu_torch.models.mlp import make_mlp  # noqa: E402
from mimm_tpu_torch.models.resnet import ResNet256_6_2_1  # noqa: E402
from mimm_tpu_torch.objectives.pairing import \
    pairwise_critic_scores  # noqa: E402
from mimm_tpu_torch.ops import _build  # noqa: E402
from mimm_tpu_torch.ops import flash_attention as fa  # noqa: E402
from mimm_tpu_torch.ops import pairwise_critic as pc  # noqa: E402
from mimm_tpu_torch.ops.image_norm import device_normalize  # noqa: E402
from mimm_tpu_torch.ops.philox import attention_keep_mask  # noqa: E402
from mimm_tpu_torch.serve import InferenceSession  # noqa: E402
from mimm_tpu_torch.train import mi  # noqa: E402

SEED = 0
BATCH = 64                      # the serving default batch
SEQ = 320                       # the serving default max_seq_length
BERT_BASE = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 max_position_embeddings=512, type_vocab_size=2,
                 num_classes=1, flash_attention=True)
SERVE_SHAPE = (BATCH, 12, SEQ, 64)          # (B, H, L, D) of each layer
CHECK_SHAPES = (SERVE_SHAPE, (1, 12, 256, 64), (2, 12, 512, 64))
DTYPES = (torch.float32, torch.bfloat16)
# kernel vs plain version, max abs error: in float32 the two differ only in
# the order of the f32 sums; in bfloat16 the output keeps 8 bits (|ctx| < 4)
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# HTTP response vs the direct plain-attention forward, max abs error over
# max(1, max |reference|): float32 allows the kernel's f32 tolerance once
# per encoder layer (12 x 1e-4).  In bfloat16 the plain path rounds the
# scores to bf16 before the softmax where the kernel keeps them in f32, a
# 2^-9 relative difference in every layer; 5e-2 on tanh-bounded outputs.
RESPONSE_TOL = {"float32": 12 * 1e-4, "bfloat16": 5e-2}
# NVIDIA H100 SXM data sheet: HBM3 rate; dense peaks (f32 outside the
# tensor cores, bf16 on them)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
# backward kernel vs autograd through the plain version, max abs error over
# max |reference| of each of dQ, dK, dV: in float32 the two differ in the
# order of f32 sums; in bfloat16 the kernel rounds P∘M and dS to bf16
# before its products (the TPU kernel's steps) where autograd rounds dP
# instead, and each output keeps 8 bits
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
RATES = (0.0, 0.1)              # the serving path's and the training path's
FLASH = {"fwd": ("mimm_tpu_torch/csrc/flash_attention_fwd.cu",
                 "mimm_tpu/ops/flash_attention.py:134"),
         "bwd": ("mimm_tpu_torch/csrc/flash_attention_bwd.cu",
                 "mimm_tpu/ops/flash_attention.py:155")}
# Random123 known-answer vectors of Philox4x32-10: (counter, key) -> words
PHILOX_KAT = (((0, 0, 0, 0), (0, 0),
               (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
              ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
               (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)))
# the JAX bench's report-length mix over PRODUCTION_SEQ_BUCKETS (bench.py
# BUCKET_MIX, from the fixture corpus)
BUCKET_MIX = {64: 0.327, 96: 0.391, 128: 0.182, 160: 0.064,
              192: 0.018, 256: 0.009, 320: 0.009}
TIMED_STEPS = 3
# f32 L=320 train step, flash kernels against the plain attention path, at
# dropout 0.  The DV loss is a difference of two terms of order 1, so its
# f32 error is absolute: 1e-5 allows 12 layers of reordered f32 sums in the
# text embeddings.  Per parameter group, the largest |Δ| and the share of
# elements with |Δ| > 1e-6: a first Adam step moves a weight by
# lr·m̂/(√v̂ + eps), ±lr unless |g| is near eps, so a gradient that is zero
# up to f32 rounding may flip or scale its step: at most 2·lr apart, and
# rare.
STEP_LOSS_ATOL = 1e-5
STEP_MAX_ABS = 2.5 * TrainingConfig().init_lr
STEP_FLIP_SHARE = 1e-3
# the pairwise critic kernels: (B_img, B_txt) shapes of the check, the
# last the GradCache step's; H1, H2 of the reference critic
CRITIC_SHAPES = ((20, 12), (300, 257), (2048, 2048))
CRITIC_HIDDEN = mi.CRITIC_HIDDEN
CRITIC_ROWS = 256          # image rows per block of the plain version
# kernel against plain version, max abs error over max |reference|.  The
# inputs lie on a 2^-6 grid, so z2 is exact in f32 in any summation order
# and the relu masks of the two agree; what remains is the order of the
# later f32 sums: 1e-4 for S and dh (≤ 2048·512 terms), 1e-3 for the
# weight gradients, which sum 4.2 M pair terms in another order.
CRITIC_TOL = {"S": 1e-4, "dh_img": 1e-4, "dh_txt": 1e-4, "db1": 1e-3,
              "dW2": 1e-3, "db2": 1e-3, "dw3": 1e-3, "db3": 1e-3}
CRITIC_SRC = {
    "fwd": ("mimm_tpu_torch/csrc/pairwise_critic_fwd.cu",
            "mimm_tpu/ops/pairwise_critic.py:144"),
    "bwd_img": ("mimm_tpu_torch/csrc/pairwise_critic_bwd.cu",
                "mimm_tpu/ops/pairwise_critic.py:205"),
    "bwd_w": ("mimm_tpu_torch/csrc/pairwise_critic_bwd.cu",
              "mimm_tpu/ops/pairwise_critic.py:205"),
    "bwd_reduce": ("mimm_tpu_torch/csrc/pairwise_critic_bwd.cu",
                   "mimm_tpu/ops/pairwise_critic.py:205"),
    "bwd_txt": ("mimm_tpu_torch/csrc/pairwise_critic_bwd.cu",
                "mimm_tpu/ops/pairwise_critic.py:270")}
CRITIC_TIMED = 3           # ~0.1-1 s a launch at the GradCache shape


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ---- phase 1: versions and build -------------------------------------------

def versions_and_build() -> None:
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"card: {torch.cuda.get_device_name(0)}  torch {torch.__version__}"
          f"  cuda {torch.version.cuda}  nvcc: {nvcc[-1]}  python "
          f"{sys.version.split()[0]}")
    print(f"nvidia-smi: {card_line()}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in libs:
        print(f"ptxas -v ({name}):\n{_build.ptxas_reports[name].strip()}")


# ---- phase 2: each kernel against its plain version -------------------------

def attention_inputs(shape, dtype, gen, device):
    """q, k, v from a seeded generator; bias -10000 on a different number
    of trailing keys in each row (7b+3 mod L/2 are distinct for b < L/2)."""
    B, H, L, D = shape
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(dtype)
               for _ in range(3))
    bias = torch.zeros(B, L, device=device)
    for b in range(B):
        pad = (7 * b + 3) % (L // 2)
        bias[b, L - pad:] = -10000.0
    return q, k, v, bias


def _seed(value: int, device) -> torch.Tensor:
    return torch.tensor([value], dtype=torch.int32, device=device)


def _scaled_err(got, want) -> float:
    """max |got − want| over max |want|."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def check_philox(device) -> None:
    """Philox4x32-10 against Random123's known-answer vectors: through the
    CUDA generator the kernels use (csrc/philox.cuh) on the card, through
    ops/philox.py on the CPU."""
    rows = np.array([list(c) + list(k) for c, k, _ in PHILOX_KAT], np.uint32)
    want = np.array([w for _, _, w in PHILOX_KAT], np.uint32)
    if torch.device(device).type == "cuda":
        fn = _build.load(fa.SOURCE).mimm_philox4x32_10
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        src = torch.from_numpy(rows.view(np.int32)).to(device)
        out = torch.empty(len(rows), 4, dtype=torch.int32, device=device)
        err = fn(src.data_ptr(), out.data_ptr(), len(rows),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"philox kernel launch failed: {err}")
        got = out.cpu().numpy().view(np.uint32)
    else:
        from mimm_tpu_torch.ops.philox import philox4x32
        got = np.array([[int(w) for w in philox4x32(c, k)]
                        for c, k, _ in PHILOX_KAT], np.uint32)
    print(f"  philox4x32-10 known-answer vectors: "
          f"{[' '.join(f'{w:08x}' for w in r) for r in got]}")
    if not np.array_equal(got, want):
        raise AssertionError(f"Philox4x32-10 disagrees with Random123: {got}")


def check_kernels(device, shapes=CHECK_SHAPES) -> dict:
    """Each kernel against its plain version, per shape, dtype and dropout
    rate; raises past its tolerance.  Returns the largest max abs error per
    (kernel, dtype) and the realized keep rate of the mask at rate 0.1."""
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    check_philox(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    worst = {(kind, dt): 0.0 for kind in FLASH for dt in DTYPES}
    for n, shape in enumerate(shapes):
        for dt in DTYPES:
            for rate in RATES:
                args = attention_inputs(shape, dt, gen, device)
                seed = _seed(1000 + n, device)
                got = fa.flash_attention(*args, seed, rate)
                _sync(device)
                want = fa.flash_attention_plain(*args, seed, rate)
                _sync(device)
                assert got.dtype == dt and got.shape == want.shape
                err = (got.float() - want.float()).abs().max().item()
                print(f"  flash_attention_fwd {shape} {dt} rate {rate}: max "
                      f"abs err {err:.3e} (tol {KERNEL_TOL[dt]:.0e})")
                if not err <= KERNEL_TOL[dt]:
                    raise AssertionError(f"forward kernel disagrees with its "
                                         f"plain version at {shape} {dt} "
                                         f"rate {rate}: {err}")
                worst["fwd", dt] = max(worst["fwd", dt], err)
                do = torch.randn(shape, generator=gen, device=device).to(dt)
                got = fa.flash_attention_bwd(*args, seed, rate, do)
                _sync(device)
                want = fa.flash_attention_bwd_plain(*args, seed, rate, do)
                _sync(device)
                errs = [_scaled_err(g, w) for g, w in zip(got, want)]
                abs_err = max((g.float() - w.float()).abs().max().item()
                              for g, w in zip(got, want))
                print(f"  flash_attention_bwd {shape} {dt} rate {rate}: "
                      f"scaled max err dQ {errs[0]:.3e} dK {errs[1]:.3e} dV "
                      f"{errs[2]:.3e} (tol {BWD_TOL[dt]:.0e})")
                if not all(g.dtype == dt for g in got) \
                        or not max(errs) <= BWD_TOL[dt]:
                    raise AssertionError(f"backward kernel disagrees with "
                                         f"autograd through the plain version"
                                         f" at {shape} {dt} rate {rate}: "
                                         f"{errs}")
                worst["bwd", dt] = max(worst["bwd", dt], abs_err)
    B, H, L, _ = shapes[0]
    keep = attention_keep_mask(_seed(7, device), B, H, L, RATES[-1])
    keep_rate = keep.float().mean().item()
    sigma = (RATES[-1] * (1 - RATES[-1]) / keep.numel()) ** 0.5
    print(f"  keep rate of the mask at rate {RATES[-1]} over {keep.numel()} "
          f"draws: {keep_rate:.6f} (1 - rate within 5 sigma = {5 * sigma:.1e})")
    if not abs(keep_rate - (1 - RATES[-1])) <= 5 * sigma:
        raise AssertionError(f"keep rate {keep_rate}")
    return {"worst": worst, "keep_rate": keep_rate}


def critic_inputs(n_img, n_txt, hidden, gen, device):
    """(h_img, h_txt, b1, W2, b2, w3, b3, g) on a 2^-6 grid (see
    CRITIC_TOL), float32, from a seeded generator."""
    h1, h2 = hidden

    def grid(shape, bound):
        n = int(bound * 64)
        return torch.randint(-n, n + 1, shape, generator=gen,
                             device=device).float() / 64

    return (grid((n_img, h1), 2.0), grid((n_txt, h1), 2.0), grid((h1,), 0.5),
            grid((h1, h2), 0.25), grid((h2,), 0.5), grid((h2, 1), 0.5),
            grid((1,), 1.0), grid((n_img, n_txt), 1.0))


def check_critic(device, shapes=CRITIC_SHAPES, hidden=CRITIC_HIDDEN) -> dict:
    """The critic kernels against their plain versions: S and the seven
    gradients per shape; raises past CRITIC_TOL.  The plain version runs
    CRITIC_ROWS image rows at a time past that many.  Returns the largest
    max abs error per kernel name."""
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    worst = dict.fromkeys(pc.KERNELS.values(), 0.0)
    names = ("S", "dh_img", "dh_txt", "db1", "dW2", "db2", "dw3", "db3")
    weights = ("db1", "dW2", "db2", "dw3", "db3")
    for n_img, n_txt in shapes:
        args = critic_inputs(n_img, n_txt, hidden, gen, device)
        rows = CRITIC_ROWS if n_img > CRITIC_ROWS else None
        got = [pc.pair_scores(*args[:7]), *pc.pair_scores_bwd(*args)]
        _sync(device)
        want = [pc.pair_scores_plain(*args[:7], rows=rows),
                *pc.pair_scores_bwd_plain(*args, rows=rows)]
        _sync(device)
        errs = {n: _scaled_err(a, b) if a.shape == b.shape else math.inf
                for n, a, b in zip(names, got, want)}
        abs_err = {n: (a - b).abs().max().item()
                   for n, a, b in zip(names, got, want)}
        print(f"  pairwise critic {(n_img, n_txt, *hidden)}: scaled max err "
              + ", ".join(f"{n} {errs[n]:.2e}" for n in names)
              + f" (tol {CRITIC_TOL['S']:.0e} for S and dh, "
              f"{CRITIC_TOL['dW2']:.0e} for the weights)")
        bad = [n for n in names if not errs[n] <= CRITIC_TOL[n]]
        if bad:
            raise AssertionError(f"critic kernels disagree with the plain "
                                 f"version at {(n_img, n_txt)}: {bad} {errs}")
        k = pc.KERNELS
        for name, err in ((k["fwd"], abs_err["S"]),
                          (k["bwd_img"], abs_err["dh_img"]),
                          (k["bwd_txt"], abs_err["dh_txt"]),
                          (k["bwd_w"], max(abs_err[n] for n in weights)),
                          (k["bwd_reduce"], max(abs_err[n] for n in weights))):
            worst[name] = max(worst[name], err)
        del got, want, args
    return worst


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---- phase 3: timing ---------------------------------------------------------

def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean ms of ``fn`` over ``iters`` back-to-back launches, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(shape, dtype, kind="fwd"):
    """(ms, 'bytes' | 'operations').  Forward: q, k, v read and the output
    written once plus the f32 bias, against the two products' 4·B·H·L²·D
    flops.  Backward: q, k, v, dO read and dQ, dK, dV written once plus the
    bias, against the five products' 10·B·H·L²·D flops.  At the dtype's
    peak; the softmax's and the dropout's O(B·H·L²) are left out."""
    B, H, L, D = shape
    esize = torch.empty((), dtype=dtype).element_size()
    tensors, products = (4, 2) if kind == "fwd" else (7, 5)
    t_bytes = (tensors * B * H * L * D * esize + 4 * B * L) / HBM_BYTES_PER_S
    t_ops = 2 * products * B * H * L * L * D / PEAK_FLOP_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_kernels() -> dict:
    """{(kind, dtype): {rate: times}} at SERVE_SHAPE."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    card = card_line()
    out = {}
    for dt in DTYPES:
        q, k, v, bias = attention_inputs(SERVE_SHAPE, dt, gen, "cuda")
        do = torch.randn(SERVE_SHAPE, generator=gen, device="cuda").to(dt)
        mask = bias[:, None, None, :].to(dt)
        seed = _seed(11, "cuda")
        for rate in RATES:
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            sdpa = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  dropout_p=rate)
            rows = {
                "fwd": (lambda: fa.flash_attention(q, k, v, bias, seed, rate),
                        lambda: fa.flash_attention_plain(q, k, v, bias, seed,
                                                         rate),
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, attn_mask=mask, dropout_p=rate)),
                "bwd": (lambda: fa.flash_attention_bwd(q, k, v, bias, seed,
                                                       rate, do),
                        lambda: fa.flash_attention_bwd_plain(
                            q, k, v, bias, seed, rate, do),
                        lambda: torch.autograd.grad(sdpa, (qs, ks, vs), do,
                                                    retain_graph=True))}
            for kind, (kernel, plain, library) in rows.items():
                ms = time_ms(kernel, iters=30)
                plain_ms = time_ms(plain, iters=10)
                library_ms = time_ms(library, iters=30)
                bound_ms, bound_by = attention_bound(SERVE_SHAPE, dt, kind)
                out.setdefault((kind, dt), {})[rate] = dict(
                    ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=bound_ms, bound_by=bound_by)
                print(f"  flash_attention_{kind} {SERVE_SHAPE} {dt} rate "
                      f"{rate}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                      f"sdpa {library_ms:.4f} ms, bound {bound_ms * 1e3:.1f} "
                      f"us ({bound_by}), kernel at "
                      f"{100 * bound_ms / ms:.1f}% of the bound  [{card}]")
            del sdpa
    return out


def critic_bounds(n_img, n_txt, hidden, splits) -> dict:
    """{kind: (ms, 'bytes' | 'operations')} of each critic kernel, and
    'bwd' for the whole backward.  One pair product is 2·P·H1·H2 f32
    FLOP at 67 TFLOP/s; the forward does one, each rows kernel and the dW2
    kernel two, and the whole backward cannot do fewer than three (the z2
    recompute, dt, dW2).  Their bytes (h rows, W2, g, S, the gradients:
    tens of MB) are far below.  The sums kernel moves bytes only: the
    partials and dh_img read once, the gradients written once."""
    h1, h2 = hidden
    pairs = n_img * n_txt
    prod = 2 * pairs * h1 * h2 / PEAK_FLOP_PER_S[torch.float32] * 1e3
    io = 4 * ((n_img + n_txt) * h1 + h1 * h2 + 2 * h2 + h1 + 1 + pairs)
    io_ms = io / HBM_BYTES_PER_S * 1e3
    out = {kind: (max(n * prod, io_ms), "operations" if n * prod >= io_ms
                  else "bytes")
           for kind, n in (("fwd", 1), ("bwd_img", 2), ("bwd_txt", 2),
                           ("bwd_w", 2), ("bwd", 3))}
    red = 4 * (splits * (h1 * h2 + 2 * h2 + 1) + n_img * h1
               + h1 * h2 + h1 + 2 * h2 + 1)
    out["bwd_reduce"] = (red / HBM_BYTES_PER_S * 1e3, "bytes")
    return out


def time_critic(shape=CRITIC_SHAPES[-1], hidden=CRITIC_HIDDEN) -> dict:
    """{kind: times} of each critic kernel at the GradCache shape (CUDA
    events, CRITIC_TIMED launches after one), beside the plain versions and
    the factorized path (objectives/pairing.py, plain PyTorch and cuBLAS:
    the port's path under the switch), a yardstick and no single library
    call.  Also the kernel path and the factorized path from embeddings,
    forward and forward + backward, at B=1024, where both fit."""
    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    args = critic_inputs(*shape, hidden, gen, "cuda")
    bargs = (*args[:6], args[7])
    dh_img = pc.bwd_rows_kernel(bargs, txt=False)
    parts = pc.bwd_w_kernel(bargs)
    calls = {"fwd": lambda: pc.pair_scores(*args[:7]),
             "bwd_img": lambda: pc.bwd_rows_kernel(bargs, txt=False),
             "bwd_txt": lambda: pc.bwd_rows_kernel(bargs, txt=True),
             "bwd_w": lambda: pc.bwd_w_kernel(bargs),
             "bwd_reduce": lambda: pc.bwd_reduce_kernel(parts, dh_img)}
    ms = {kind: time_ms(call, iters=CRITIC_TIMED, warmup=1)
          for kind, call in calls.items()}
    plain = {"fwd": time_ms(lambda: pc.pair_scores_plain(
        *args[:7], rows=CRITIC_ROWS), iters=CRITIC_TIMED, warmup=1),
        "bwd": time_ms(lambda: pc.pair_scores_bwd_plain(
            *args, rows=CRITIC_ROWS), iters=CRITIC_TIMED, warmup=1)}
    bounds = critic_bounds(*shape, hidden, pc.bwd_splits(*shape))
    out = {}
    for kind in calls:
        bound_ms, bound_by = bounds[kind]
        out[kind] = dict(ms=ms[kind], plain_ms=plain["fwd" if kind == "fwd"
                                                      else "bwd"],
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None)
        print(f"  {pc.KERNELS[kind]} {shape + hidden}: kernel {ms[kind]:.4f}"
              f" ms, bound {bound_ms:.4f} ms ({bound_by}), kernel at "
              f"{100 * bound_ms / ms[kind]:.1f}% of the bound  [{card}]")
    bwd_ms = sum(ms[k] for k in calls if k != "fwd")
    print(f"  critic backward {shape + hidden}: four kernels {bwd_ms:.4f} ms "
          f"(6 pair products), bound of the backward {bounds['bwd'][0]:.4f} "
          f"ms (3 products); plain forward {plain['fwd']:.4f} ms, plain "
          f"backward {plain['bwd']:.4f} ms ({CRITIC_ROWS} image rows a "
          f"block)  [{card}]")
    del args, bargs, dh_img, parts

    # the factorized path beside the kernel path, from 768-d embeddings;
    # the factorized forward at 2048 needs three (n, n, H1) f32 tensors
    critic = [{k: t.cuda() for k, t in layer.items()} for layer in make_mlp(
        2 * BERT_BASE["hidden_size"], list(hidden),
        generator=torch.Generator().manual_seed(SEED + 6))]
    paths = {"factorized": pairwise_critic_scores,
             "kernel": lambda p, a, b: pc.pairwise_critic_scores_pallas(
                 p, a, b, force_kernel=True)}
    big = 2048 if 2048 ** 2 * hidden[0] * 4 * 3 < torch.cuda.mem_get_info()[0] \
        else 1024
    fact = {}
    for path, what, n in (("factorized", "fwd", big),
                          ("factorized", "fwd", 1024), ("kernel", "fwd", 1024),
                          ("factorized", "fwd+bwd", 1024),
                          ("kernel", "fwd+bwd", 1024)):
        emb = [torch.randn(n, BERT_BASE["hidden_size"], generator=gen,
                           device="cuda") for _ in range(2)]
        params = [{k: t.detach().requires_grad_(what != "fwd")
                   for k, t in layer.items()} for layer in critic]
        fn = paths[path]

        def call():
            if what == "fwd":
                with torch.no_grad():
                    fn(params, *emb)
            else:
                fn(params, *emb).sum().backward()

        key = f"{path} {what} B={n}"
        fact[key] = time_ms(call, iters=CRITIC_TIMED, warmup=1)
        print(f"  {path} path {what} at B={n}: {fact[key]:.4f} ms  [{card}]")
        del emb, params
        torch.cuda.empty_cache()
    out["yardstick"] = fact
    return out


# ---- phase 4: the serving path through HTTP ----------------------------------

def random_state_dict(model, gen, std_2d=None) -> dict:
    """Seeded random weights in ``model``'s reference layout: He-normal
    convs, N(0, std_2d or 1/fan_in) matrices and tables, norm scales near 1,
    small biases, BatchNorm statistics around (0, 1)."""
    sd = {}
    for name, t in model.state_dict().items():
        shape, fan_in = t.shape, t.shape[1:].numel()
        if name.endswith("num_batches_tracked"):
            sd[name] = torch.zeros((), dtype=torch.int64)
            continue
        if name.endswith("running_mean"):
            x = 0.1 * torch.randn(shape, generator=gen)
        elif name.endswith("running_var"):
            x = 0.5 + torch.rand(shape, generator=gen)
        elif t.dim() == 4:
            x = torch.randn(shape, generator=gen) * math.sqrt(2.0 / fan_in)
        elif t.dim() == 2:
            x = torch.randn(shape, generator=gen) * (
                std_2d if std_2d is not None else fan_in ** -0.5)
        elif name.endswith("weight"):
            x = 1.0 + 0.1 * torch.randn(shape, generator=gen)
        else:
            x = 0.02 * torch.randn(shape, generator=gen)
        sd[name] = x
    return sd


def write_checkpoints(root: str, bert_kw: dict):
    """The reference-named .bin files of a save directory and a
    bert_config.json; returns (save_dir, bert_dir, state dicts)."""
    gen = torch.Generator().manual_seed(SEED)
    save, bert_dir = os.path.join(root, "save"), os.path.join(root, "bert")
    os.makedirs(save)
    os.makedirs(bert_dir)
    cfg = BertConfig(**bert_kw)
    with torch.device("meta"):
        models = {"image": ResNet256_6_2_1(), "text": TextBert(cfg),
                  "classifier": BasicMLP(768, DEFAULT_CLASSIFIER_LAYERS)}
    sds = {"image": random_state_dict(models["image"], gen),
           "text": random_state_dict(models["text"], gen,
                                     std_2d=cfg.initializer_range),
           "classifier": random_state_dict(models["classifier"], gen)}
    for key, name in (("image", "pytorch_MI_image_model.bin"),
                      ("text", "pytorch_MI_text_model.bin"),
                      ("classifier",
                       "pytorch_image_classifier_Pneumonia_epoch1.bin")):
        ckpt.save_state_dict_bin(os.path.join(save, name), sds[key])
    with open(os.path.join(bert_dir, "bert_config.json"), "w") as f:
        json.dump(bert_kw, f, indent=2)
    return save, bert_dir, sds


class Reference:
    """Direct forwards of the port's models on the device with the plain
    attention path: what every HTTP response is held against."""

    def __init__(self, sds, bert_kw, compute_dtype: str, device):
        dt = getattr(torch, compute_dtype)
        self.device = device
        self.image = ResNet256_6_2_1(dtype=dt)
        self.text = TextBert(BertConfig(**dict(bert_kw, flash_attention=False)),
                             dtype=dt)
        self.clf = BasicMLP(768, DEFAULT_CLASSIFIER_LAYERS)
        for model, key in ((self.image, "image"), (self.text, "text"),
                           (self.clf, "classifier")):
            model.load_state_dict(sds[key], strict=True)
            model.to(device).eval()

    def _embed(self, images):
        x = torch.from_numpy(images[..., None]).to(self.device)
        return self.image(device_normalize(x))[1].float()

    @torch.inference_mode()
    def images(self, images):
        return self._embed(images).cpu().numpy()

    @torch.inference_mode()
    def classify(self, images):
        return self.clf(self._embed(images))[:, 0].cpu().numpy()

    @torch.inference_mode()
    def texts(self, ids, masks):
        t = [torch.from_numpy(a).long().to(self.device)
             for a in (ids, masks, np.zeros_like(ids))]
        return self.text(t[0], t[2], t[1])[0].float().cpu().numpy()


def make_requests(batch: int, seq: int, vocab: int):
    """uint8 images and pre-tokenised texts with varied lengths."""
    rng = np.random.default_rng(SEED)
    images = rng.integers(0, 256, (batch, 256, 256), dtype=np.uint8)
    ids = rng.integers(1000, vocab, (batch, seq)).astype(np.int32)
    lengths = rng.integers(8, seq + 1, batch)
    lengths[0] = seq
    masks = (np.arange(seq)[None] < lengths[:, None]).astype(np.int32)
    ids[:, 0] = 101                                       # [CLS]
    ids[np.arange(batch), lengths - 1] = 102              # [SEP]
    ids *= masks
    return images, ids, masks


def _post(url: str, body: bytes, ctype: str) -> dict:
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read().decode())


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _texts_body(ids, masks) -> bytes:
    return json.dumps({"input_ids": ids.tolist(),
                       "attention_mask": masks.tolist()}).encode()


def check_response(name, got, want, tol, varied=True) -> None:
    got = np.asarray(got, np.float32)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{name}: shape {got.shape} (want {want.shape}) "
                             f"or non-finite values")
    if varied and not np.ptp(want, axis=0).max() > 1e-3:
        raise AssertionError(f"{name}: reference rows do not differ")
    err = float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))
    print(f"  {name}: {got.shape}, scaled max err {err:.3e} (tol {tol:.1e})")
    if not err <= tol:
        raise AssertionError(f"{name}: response differs from the reference "
                             f"forward: {err} > {tol}")


class Server:
    """``build_server`` on 127.0.0.1 (any free port) in a thread."""

    def __init__(self, **kw):
        self.server = build_server(port=0, **kw)
        self.base = f"http://127.0.0.1:{self.server.server_port}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=60)


def _launches() -> int:
    return sum(fa.LAUNCHES.values())


def drive_session(srv: Server, ref: Reference, compute_dtype: str, data,
                  layers: int, batch: int) -> dict:
    """The requests of one session, each checked; returns its throughput."""
    images, ids, masks = data
    tol = RESPONSE_TOL[compute_dtype]
    with urllib.request.urlopen(srv.base + "/healthz", timeout=60) as r:
        health = json.loads(r.read().decode())
    print(f"  /healthz: {health}")
    assert health["status"] == "ok" and health["text_model"] \
        and health["classifier"]
    for n in (batch, 3):
        got = _post(srv.base + "/embed_images", _npy(images[:n]),
                    "application/x-npy")["embeddings"]
        check_response(f"/embed_images npy n={n}", got, ref.images(images[:n]),
                       tol)
    for n in (batch, 5):
        before = _launches()
        got = _post(srv.base + "/embed_texts", _texts_body(ids[:n], masks[:n]),
                    "application/json")["embeddings"]
        launched = _launches() - before
        check_response(f"/embed_texts n={n}", got,
                       ref.texts(ids[:n], masks[:n]), tol)
        want = layers * -(-n // batch)
        print(f"  /embed_texts n={n}: flash launches {launched} (want {want})")
        if launched != want:
            raise AssertionError(f"flash kernel launched {launched} times "
                                 f"for one text batch, want {want}")
    n = min(batch, 16)
    got = _post(srv.base + "/classify", _npy(images[:n]),
                "application/x-npy")["probabilities"]
    check_response(f"/classify n={n}", got, ref.classify(images[:n]), tol,
                   varied=False)

    def per_s(path, body, ctype, reps=5):
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            _post(srv.base + path, body, ctype)
            walls.append(time.perf_counter() - t0)
        return batch / statistics.median(walls)

    return {"images_per_s": per_s("/embed_images", _npy(images),
                                  "application/x-npy"),
            "texts_per_s": per_s("/embed_texts", _texts_body(ids, masks),
                                 "application/json")}


def drive_dynamic(srv: Server, ref: Reference, data, layers: int,
                  batch: int) -> None:
    """Concurrent small requests through --dynamic_batching: each response
    matches its rows of the reference; text batches launch whole layers."""
    images, ids, masks = data
    tol = RESPONSE_TOL["float32"]
    step = max(1, batch // 8)
    jobs = [("/embed_texts", i, _texts_body(ids[i:i + step],
                                            masks[i:i + step]),
             "application/json") for i in range(0, batch, step)]
    jobs += [("/embed_images", i, _npy(images[i:i + step]),
              "application/x-npy") for i in range(0, batch // 2, step)]
    results = [None] * len(jobs)

    def one(j):
        path, _, body, ctype = jobs[j]
        results[j] = _post(srv.base + path, body, ctype)["embeddings"]

    before = _launches()
    threads = [threading.Thread(target=one, args=(j,))
               for j in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    launched = _launches() - before
    want_txt, want_img = ref.texts(ids, masks), ref.images(images[:batch // 2])
    for (path, i, _, _), got in zip(jobs, results):
        want = want_txt if path == "/embed_texts" else want_img
        check_response(f"dynamic {path} rows {i}:{i + step}", got,
                       want[i:i + step], tol, varied=step > 1)
    n_text = sum(1 for j in jobs if j[0] == "/embed_texts")
    print(f"  dynamic batching: {len(jobs)} concurrent requests, flash "
          f"launches {launched} = {launched // layers} text device calls "
          f"for {n_text} text requests")
    if launched % layers or not layers <= launched <= layers * n_text:
        raise AssertionError(f"dynamic batching launched {launched}")


def drive_serving(root: str, device, bert_kw=BERT_BASE, batch=BATCH,
                  seq=SEQ) -> dict:
    """Phase 4; returns {"launches": {kernel: n}, "per_s": {...}}."""
    save, bert_dir, sds = write_checkpoints(root, bert_kw)
    data = make_requests(batch, seq, bert_kw["vocab_size"])
    layers = bert_kw["num_hidden_layers"]
    kw = dict(save_directory=save, batch_size=batch, disease="Pneumonia",
              bert_pretrained_dir=bert_dir, max_seq_length=seq, device=device)
    refs = {cd: Reference(sds, bert_kw, cd, device)
            for cd in ("float32", "bfloat16")}
    card = card_line() if torch.device(device).type == "cuda" else "cpu"
    per_s = {}
    fa.reset_launch_counts()            # the main path's run starts here
    for cd in ("float32", "bfloat16"):
        print(f"session compute_dtype={cd}")
        srv = Server(compute_dtype=cd, **kw)
        try:
            per_s[cd] = drive_session(srv, refs[cd], cd, data, layers, batch)
        finally:
            srv.close()
        print(f"  {cd}: {per_s[cd]['images_per_s']:.1f} images/s, "
              f"{per_s[cd]['texts_per_s']:.1f} texts/s (HTTP, batch {batch},"
              f" L={seq}, median of 5)  [{card}]")
    print("session compute_dtype=float32 --dynamic_batching true")
    srv = Server(compute_dtype="float32", dynamic_batching=True,
                 batch_wait_ms=50.0, **kw)
    try:
        drive_dynamic(srv, refs["float32"], data, layers, batch)
    finally:
        srv.close()
    launches = dict(fa.LAUNCHES)        # ... and ends here
    print(f"main-path launches: {launches}")
    return {"launches": launches, "per_s": per_s, "save": save,
            "config": BertConfig(**bert_kw), "data": data}


# ---- phase 5: the MI train step at full width ---------------------------------

# what load_bert_config gives the production preset on BERT-base
TRAIN_BERT = dict(BERT_BASE, gelu_tanh=True, u8_dropout=True)


def compact_batch(rng, batch: int, seq: int, vocab: int, device) -> dict:
    """The production loader's compact layout (the JAX bench's batch):
    uint8 image crops, uint16 ids, uint8 masks and segments, int64 ids of
    distinct studies."""
    img = rng.integers(0, 255, (batch, 256, 256, 1)).astype(np.uint8)
    ids = rng.integers(0, vocab, (batch, seq)).astype(np.uint16)
    return {"image": torch.from_numpy(img).to(device),
            "txt_ids": torch.from_numpy(ids).to(device),
            "txt_masks": torch.ones(batch, seq, dtype=torch.uint8,
                                    device=device),
            "txt_segments": torch.zeros(batch, seq, dtype=torch.uint8,
                                        device=device),
            "study_id": torch.arange(batch, dtype=torch.int64, device=device)}


def _snapshot(state) -> dict:
    """Copies of the parameters, critic and BatchNorm statistics by group."""
    p = state.params
    groups = {"image": p["image_model"], "text": p["text_model"],
              "critic": mi.critic_dict(state.critic_params),
              "batch_stats": state.batch_stats}
    return {g: {n: t.detach().float().cpu().clone() for n, t in d.items()}
            for g, d in groups.items()}


def compare_flash_step(device, bert_kw, batch: int, seq: int) -> dict:
    """One float32 step at dropout 0 from one state, with the flash kernels
    (flash_attention=True) and with the plain attention path; returns the
    relative loss difference and per group (max |Δ|, share > 1e-6)."""
    cfg = TrainingConfig.production(compute_dtype="float32")
    data = compact_batch(np.random.default_rng(SEED + 2), batch, seq,
                         bert_kw["vocab_size"], device)
    runs = {}
    for flash in (True, False):
        bc = BertConfig(**dict(bert_kw, flash_attention=flash,
                               hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0))
        model = mi.build_joint_model(cfg, bc, device=device)
        txs = mi.make_optimizers(cfg, steps_per_epoch=200_000 // batch)
        state = mi.create_mi_state(model, cfg, txs,
                                   torch.Generator().manual_seed(SEED + 3))
        state, loss = mi.make_mi_train_step(model, txs, cfg)(state, data)
        runs[flash] = (loss.item(), _snapshot(state))
        del model, state
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    (l_k, a), (l_p, b) = runs[True], runs[False]
    out = {"loss_diff": abs(l_k - l_p), "loss": (l_k, l_p)}
    for g in a:
        d = torch.cat([(a[g][n] - b[g][n]).abs().reshape(-1) for n in a[g]])
        out[g] = (d.max().item(), (d > 1e-6).float().mean().item())
    print(f"  f32 L={seq} step, flash kernels vs plain attention, dropout 0:"
          f" loss {l_k:.9e} vs {l_p:.9e} (|diff| {out['loss_diff']:.2e}, tol "
          f"{STEP_LOSS_ATOL:.0e}); max |dparam|, share > 1e-6: "
          + ", ".join(f"{g} {out[g][0]:.2e}, {out[g][1]:.2e}" for g in a)
          + f" (tol {STEP_MAX_ABS:.1e}, {STEP_FLIP_SHARE:.0e})")
    if not out["loss_diff"] <= STEP_LOSS_ATOL or not all(
            out[g][0] <= STEP_MAX_ABS and out[g][1] <= STEP_FLIP_SHARE
            for g in a):
        raise AssertionError(f"flash and plain train steps disagree: {out}")
    return out


def check_reload(save: str, state, bert_config) -> None:
    """The three .bin files load into fresh port modules with strict=True
    and hold the state's weights and statistics."""
    want = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    image = ResNet256_6_2_1()
    image.load_state_dict(ckpt.load_state_dict_bin(
        os.path.join(save, "pytorch_MI_image_model.bin")), strict=True)
    text = TextBert(BertConfig.from_json_file(os.path.join(save,
                                                           "config.json")))
    text.load_state_dict(ckpt.load_state_dict_bin(
        os.path.join(save, "pytorch_MI_text_model.bin")), strict=True)
    joint = ImageReportModel(bert_config)
    joint.load_state_dict(ckpt.load_state_dict_bin(
        os.path.join(save, "pytorch_model_epoch1.bin")), strict=True)
    got = dict(joint.state_dict())
    got.update({f"image_model.{k}": v for k, v in image.state_dict().items()})
    got.update({f"text_model.{k}": v for k, v in text.state_dict().items()})
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    print(f"  save_mi_checkpoints: 3 .bin files reloaded strict, "
          f"{len(want)} tensors, {len(bad)} differ")
    if bad:
        raise AssertionError(f"reloaded checkpoint differs: {bad[:5]}")


def drive_training(root: str, device, bert_kw=TRAIN_BERT, batch=BATCH,
                   buckets=PRODUCTION_SEQ_BUCKETS, cmp_seq=SEQ) -> dict:
    """Phase 5; returns the launches of the training path, the per-bucket
    times, and what phase 6 profiles."""
    cuda = torch.device(device).type == "cuda"
    card = card_line() if cuda else "cpu"
    cfg = TrainingConfig.production()
    bc = BertConfig(**bert_kw)
    model = mi.build_joint_model(cfg, bc, device=device)
    txs = mi.make_optimizers(cfg, steps_per_epoch=200_000 // batch)
    state = mi.create_mi_state(model, cfg, txs,
                               torch.Generator().manual_seed(SEED))
    train_step = mi.make_mi_train_step(model, txs, cfg)
    multi_step = mi.make_mi_multi_step(model, txs, cfg)
    rng = np.random.default_rng(SEED)
    layers = bc.num_hidden_layers
    flash_names = (fa.KERNELS[torch.bfloat16], fa.BWD_KERNELS[torch.bfloat16])
    ms, losses, batches, peak = {}, [], {}, {}
    fa.reset_launch_counts()            # the training path's run starts here
    for seq in buckets:
        data = batches[seq] = compact_batch(rng, batch, seq, bc.vocab_size,
                                            device)
        state, loss = train_step(state, data)           # warm-up
        losses.append(loss[None])
        stacked = {k: torch.stack([v] * TIMED_STEPS) for k, v in data.items()}
        _sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        before = dict(fa.LAUNCHES)
        t0 = time.perf_counter()
        state, step_losses = multi_step(state, stacked)
        _sync(device)
        ms[seq] = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
        losses.append(step_losses)
        per_step = [(fa.LAUNCHES[n] - before.get(n, 0)) / TIMED_STEPS
                    for n in flash_names]
        if cuda:
            peak[seq] = torch.cuda.max_memory_allocated()
        mem = f"{peak[seq] / 2 ** 30:.2f} GiB" if cuda else "not measured"
        print(f"  L={seq}: {ms[seq]:.3f} ms/step ({batch / ms[seq] * 1e3:.1f}"
              f" pairs/s, host clock, {TIMED_STEPS} steps after 1 warm-up), "
              f"peak memory {mem}, flash launches per step fwd {per_step[0]:g}"
              f" bwd {per_step[1]:g}, losses "
              f"{[round(x, 6) for x in step_losses.tolist()]}  [{card}]")
        want = layers if seq >= bc.flash_min_seq_len and seq % 8 == 0 else 0
        if cuda and per_step != [want, want]:
            raise AssertionError(f"L={seq}: flash launches per step "
                                 f"{per_step}, want {want} fwd and bwd")
    flat = torch.cat(losses).float().cpu()
    if not torch.isfinite(flat).all() or len(set(flat.tolist())) != len(flat):
        raise AssertionError(f"train losses not finite and distinct: "
                             f"{flat.tolist()}")
    # the bucket mix; even weights for a rehearsal's other buckets
    mix = {b: BUCKET_MIX[b] if set(buckets) <= set(BUCKET_MIX) else 1.0
           for b in buckets}
    weighted_ms = sum(mix[b] * ms[b] for b in buckets) / sum(mix.values())
    per_s = {"mix": batch / weighted_ms * 1e3,
             "last": batch / ms[buckets[-1]] * 1e3}
    print(f"  MI train step, B={batch}, production preset: "
          f"{per_s['mix']:.1f} pairs/s over the bucket mix, "
          f"{per_s['last']:.1f} pairs/s at L={buckets[-1]}  [{card}]")
    step_cmp = compare_flash_step(device, bert_kw, batch, cmp_seq)
    save = os.path.join(root, "mi_save")
    mi.save_mi_checkpoints(save, state, 1, bc)
    check_reload(save, state, bc)
    launches = dict(fa.LAUNCHES)        # ... and ends here
    print(f"training-path launches: {launches}")
    return {"launches": launches, "ms": ms, "per_s": per_s, "cmp": step_cmp,
            "state": state, "step": train_step, "batches": batches,
            "peak": peak}


# ---- phase 6: where the device time goes ---------------------------------------

def profile_call(title: str, call, wall_ms: float, card: str) -> None:
    """Kernel time by name over one call of ``call`` under torch.profiler,
    and the device idle share against ``wall_ms``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    # kernel rows only: an operator's row repeats its kernels' time
    rows = [(e.self_device_time_total / 1e3, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(r[0] for r in rows)
    print(f"profile {title}: {wall_ms:.3f} ms (host clock, profiler off), "
          f"device busy {busy:.3f} ms (profiler on)"
          + (f", idle share {1 - busy / wall_ms:.3f}" if busy else
             ", device time not measured") + f"  [{card}]")
    for ms, key, count in sorted(rows, reverse=True)[:8]:
        print(f"    {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{count:<4d}"
              f" {key[:90]}")


def profile_batches(save: str, config, data) -> None:
    images, ids, masks = data
    card = card_line()
    for cd in ("float32", "bfloat16"):
        sess = InferenceSession(save, batch_size=BATCH, bert_config=config,
                                compute_dtype=cd, max_seq_length=SEQ,
                                device="cuda")
        for name, call in (
                ("image batch", lambda: sess.embed_images(images[..., None])),
                ("text batch", lambda: sess.embed_texts(
                    ids, masks, np.zeros_like(ids)))):
            walls = []
            for _ in range(6):      # the first call warms up
                t0 = time.perf_counter()
                call()              # ends in a device-to-host copy
                walls.append(time.perf_counter() - t0)
            profile_call(f"{cd} {name} (B={BATCH}), session call median of 5",
                         call, statistics.median(walls[1:]) * 1e3, card)


def profile_train_steps(train: dict) -> None:
    """One train step at the shortest and at the longest bucket."""
    for seq in (min(train["ms"]), max(train["ms"])):
        profile_call(f"MI train step bf16 L={seq} (B={BATCH}), ms/step of "
                     f"phase 5", lambda: train["step"](train["state"],
                                                       train["batches"][seq]),
                     train["ms"][seq], card_line())


# ---- phase 7: GradCache at full width ------------------------------------------

# (batch, grad_cache_chunks) at L=128, as tools/bench_grad_cache.py drives
# JAX: chunks of 64; 256 is under the critic's 8 GiB switch, 2048 past it
GC_CONFIGS = ((256, 4), (2048, 32))
GC_SEQ = 128
GC_TIMED = 2
CRITIC_MEMORY_LIMIT = 2 ** 30


def critic_memory(critic, batch: int, width: int, device) -> int:
    """Device bytes one critic forward + backward adds at ``batch``
    (the h products, S, the gradients, the kernels' scratch), from
    random embeddings."""
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    emb = [torch.randn(batch, width, generator=gen, device=device)
           .requires_grad_() for _ in range(2)]
    g = torch.randn(batch, batch, generator=gen, device=device)
    params = [{k: t.detach().requires_grad_() for k, t in layer.items()}
              for layer in critic]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    scores = pc.pairwise_critic_scores_pallas(params, *emb)
    grads = torch.autograd.grad(scores, [*emb, *mi.critic_dict(params)
                                         .values()], g)
    torch.cuda.synchronize()
    del scores, grads
    return torch.cuda.max_memory_allocated() - base


def drive_grad_cache(device, bert_kw=TRAIN_BERT, configs=GC_CONFIGS,
                     seq=GC_SEQ, direct_peak=None) -> dict:
    """GradCache through ``make_mi_train_step`` / ``make_mi_multi_step``
    with ``grad_cache_chunks``, production preset, full width: one warm-up
    and GC_TIMED timed steps per (batch, chunks).  Past the critic's switch
    each step runs the critic's autograd function once forward and once
    backward, so each critic kernel launches once a step; under it none
    does.  Returns the critic path's launches and the per-config times."""
    cuda = torch.device(device).type == "cuda"
    card = card_line() if cuda else "cpu"
    bc = BertConfig(**bert_kw)
    rng = np.random.default_rng(SEED + 7)
    names = list(pc.KERNELS.values())
    out, losses = {}, []
    # the path's launches: those of the warm-up and timed steps (the memory
    # probe and the profiled step below are not counted)
    counted = collections.Counter()
    fa.reset_launch_counts()
    pc.reset_launch_counts()
    for batch, chunks in configs:
        cfg = TrainingConfig.production(batch_size=batch,
                                        grad_cache_chunks=chunks)
        model = mi.build_joint_model(cfg, bc, device=device)
        txs = mi.make_optimizers(cfg, steps_per_epoch=200_000 // batch)
        state = mi.create_mi_state(model, cfg, txs,
                                   torch.Generator().manual_seed(SEED))
        data = compact_batch(rng, batch, seq, bc.vocab_size, device)
        start = dict(pc.LAUNCHES)
        state, loss = mi.make_mi_train_step(model, txs, cfg)(state, data)
        losses.append(loss[None])                       # warm-up
        stacked = {k: torch.stack([v] * GC_TIMED) for k, v in data.items()}
        _sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        before, flash_before = dict(pc.LAUNCHES), sum(fa.LAUNCHES.values())
        t0 = time.perf_counter()
        state, step_losses = mi.make_mi_multi_step(model, txs, cfg)(state,
                                                                    stacked)
        _sync(device)
        ms = (time.perf_counter() - t0) / GC_TIMED * 1e3
        losses.append(step_losses)
        per_step = {n: (pc.LAUNCHES[n] - before.get(n, 0)) / GC_TIMED
                    for n in names}
        counted.update({n: pc.LAUNCHES[n] - start.get(n, 0) for n in names})
        flash = (sum(fa.LAUNCHES.values()) - flash_before) / GC_TIMED
        peak = torch.cuda.max_memory_allocated() if cuda else None
        mem = f"{peak / 2 ** 30:.2f} GiB" if cuda else "not measured"
        kernel = pc.uses_kernel(batch, batch, CRITIC_HIDDEN[0])
        print(f"  B={batch} in {chunks} chunks of {batch // chunks}, L={seq}:"
              f" {ms:.3f} ms/step ({batch / ms * 1e3:.1f} pairs/s, host "
              f"clock, {GC_TIMED} steps after 1 warm-up), peak memory {mem}, "
              f"critic kernels {'past' if kernel else 'under'} the switch, "
              f"launches per step {per_step}, flash launches per step "
              f"{flash:g}, losses {[round(x, 6) for x in step_losses.tolist()]}"
              f"  [{card}]")
        if cuda and (set(per_step.values()) != {1 if kernel else 0}
                     or flash != 0):
            raise AssertionError(f"B={batch}: critic launches per step "
                                 f"{per_step} (want {int(kernel)} of each),"
                                 f" flash {flash} (want 0)")
        out[batch] = {"chunks": chunks, "ms": ms, "pairs_per_s":
                      batch / ms * 1e3, "peak": peak}
        if kernel and cuda:
            out["critic_bytes"] = critic_memory(state.critic_params, batch,
                                                BERT_BASE["hidden_size"],
                                                device)
            print(f"  critic forward + backward at B={batch}: "
                  f"{out['critic_bytes'] / 2 ** 20:.1f} MiB of device memory"
                  f" (h products, S, gradients, scratch; limit "
                  f"{CRITIC_MEMORY_LIMIT / 2 ** 30:.0f} GiB)  [{card}]")
            if not out["critic_bytes"] < CRITIC_MEMORY_LIMIT:
                raise AssertionError(f"critic memory {out['critic_bytes']}")
            if direct_peak is not None and not peak <= 2 * direct_peak:
                raise AssertionError(f"GradCache peak {peak} > twice the "
                                     f"B=64 direct step's {direct_peak}")
            profile_call(f"GradCache step B={batch} in {chunks} chunks, "
                         f"L={seq}, ms/step above",
                         lambda: mi.make_mi_train_step(model, txs, cfg)(
                             state, data), ms, card)
        del model, state, data, stacked
        if cuda:
            torch.cuda.empty_cache()
    flat = torch.cat(losses).float().cpu()
    if not torch.isfinite(flat).all() or len(set(flat.tolist())) != len(flat):
        raise AssertionError(f"GradCache losses not finite and distinct: "
                             f"{flat.tolist()}")
    out["launches"] = {n: c for n, c in counted.items() if c}
    print(f"GradCache-path launches: {out['launches']}, flash "
          f"{dict(fa.LAUNCHES)}")
    return out


# ---- phase 8: BERT remat ---------------------------------------------------------

REMAT_STEPS = 2     # the text tower's first AdamW update is 0 (warmup)


def drive_remat(device, bert_kw=TRAIN_BERT, batch=BATCH, seq=SEQ) -> dict:
    """REMAT_STEPS bf16 steps at dropout 0.1 with ``BertConfig.remat``
    against the same steps without, from one state and one seed: the same
    losses, updated parameters within the flash-vs-plain step's limits
    (the text tower and the critic should agree exactly: the recompute runs
    the same kernels on the same inputs with the same masks), and per step
    twice the flash forward launches (each layer recomputed)."""
    cuda = torch.device(device).type == "cuda"
    cfg = TrainingConfig.production()
    data = compact_batch(np.random.default_rng(SEED + 9), batch, seq,
                         bert_kw["vocab_size"], device)
    layers = bert_kw["num_hidden_layers"]
    names = (fa.KERNELS[torch.bfloat16], fa.BWD_KERNELS[torch.bfloat16])
    runs = {}
    fa.reset_launch_counts()            # the remat path's run starts here
    for remat in (True, False):
        bc = BertConfig(**dict(bert_kw, remat=remat))
        model = mi.build_joint_model(cfg, bc, device=device)
        txs = mi.make_optimizers(cfg, steps_per_epoch=200_000 // batch)
        state = mi.create_mi_state(model, cfg, txs,
                                   torch.Generator().manual_seed(SEED + 10))
        step = mi.make_mi_train_step(model, txs, cfg)
        before = dict(fa.LAUNCHES)
        losses = [step(state, data)[1].item()]          # warm-up
        _sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses += [step(state, data)[1].item()
                   for _ in range(REMAT_STEPS - 1)]
        _sync(device)
        ms = (time.perf_counter() - t0) / (REMAT_STEPS - 1) * 1e3
        per_step = [(fa.LAUNCHES[n] - before.get(n, 0)) / REMAT_STEPS
                    for n in names]
        mem = f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB" \
            if cuda else "not measured"
        print(f"  remat={remat}: {ms:.3f} ms/step (host clock, the step "
              f"after the first), peak memory {mem}")
        runs[remat] = (losses, _snapshot(state), per_step)
        del model, state, step
        if cuda:
            torch.cuda.empty_cache()
    (l_r, a, launched), (l_p, b, plain) = runs[True], runs[False]
    out = {}
    for g in a:
        d = torch.cat([(a[g][n] - b[g][n]).abs().reshape(-1) for n in a[g]])
        out[g] = (d.max().item(), (d > 1e-6).float().mean().item())
    print(f"  bf16 L={seq} B={batch}, {REMAT_STEPS} steps at dropout 0.1, "
          f"remat against no remat: losses {l_r} vs {l_p}; flash launches per"
          f" step fwd, bwd {launched} vs {plain}; max |dparam|, share > 1e-6:"
          + ", ".join(f"{g} {out[g][0]:.2e}, {out[g][1]:.2e}" for g in a)
          + f" (tol {STEP_MAX_ABS:.1e}, {STEP_FLIP_SHARE:.0e})  "
          f"[{card_line() if cuda else 'cpu'}]")
    want = ([2 * layers, layers], [layers, layers]) if cuda else (
        [0, 0], [0, 0])
    if l_r != l_p or (launched, plain) != want or not all(
            out[g][0] <= STEP_MAX_ABS and out[g][1] <= STEP_FLIP_SHARE
            for g in a):
        raise AssertionError(f"remat step differs: losses {l_r} {l_p}, "
                             f"launches {launched} {plain}, {out}")
    out["launches"] = dict(fa.LAUNCHES)     # ... and ends here
    return out


# ---- main ----------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== phase 1: versions and build")
    versions_and_build()
    print("== phase 2: kernels against their plain versions")
    checked = check_kernels("cuda")
    critic_worst = check_critic("cuda")
    print("== phase 3: timing at (64, 12, 320, 64) and at 2048 x 2048 pairs")
    times = time_kernels()
    critic_times = time_critic()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        print("== phase 4: the serving path over HTTP (full width)")
        serve = drive_serving(root, "cuda")
        print("== phase 5: the MI train step (full width, B=64)")
        train = drive_training(root, "cuda")
        print("== phase 6: where the device time goes")
        profile_batches(serve["save"], serve["config"], serve["data"])
        profile_train_steps(train)
    del train["state"], train["batches"]
    torch.cuda.empty_cache()
    print(f"== phase 7: GradCache (full width, production preset, L={GC_SEQ})")
    grad_cache = drive_grad_cache("cuda", direct_peak=train["peak"][GC_SEQ])
    print(f"== phase 8: BERT remat (full width, B={BATCH}, L={SEQ})")
    remat = drive_remat("cuda")

    # each path's launches, counted from 0 just before it and read just
    # after; serving runs the flash forward, training and remat the flash
    # backward too, GradCache the critic kernels
    flash_all = [*fa.KERNELS.values(), *fa.BWD_KERNELS.values()]
    paths = {"serving": (serve["launches"], fa.KERNELS.values()),
             "training": (train["launches"], flash_all),
             "grad_cache": (grad_cache["launches"], pc.KERNELS.values()),
             "remat": (remat["launches"],
                       [fa.KERNELS[torch.bfloat16],
                        fa.BWD_KERNELS[torch.bfloat16]])}
    for path, (counts, names) in paths.items():
        for name in names:
            if counts.get(name, 0) == 0:
                raise AssertionError(f"{name} was not launched on the {path} "
                                     f"path")
    launches = lambda name: sum(c.get(name, 0) for c, _ in paths.values())
    kernels = []
    for kind, names in (("fwd", fa.KERNELS), ("bwd", fa.BWD_KERNELS)):
        for dt in DTYPES:
            name = names[dt]
            kernels.append({
                "name": name, "route": "cuda", "source": FLASH[kind][0],
                "replaces": FLASH[kind][1], "launches": launches(name),
                "max_abs_err": checked["worst"][kind, dt],
                **times[kind, dt][RATES[-1]],
                "ms_rate0": times[kind, dt][0.0]["ms"]})
    for kind, name in pc.KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": CRITIC_SRC[kind][0],
            "replaces": CRITIC_SRC[kind][1], "launches": launches(name),
            "max_abs_err": critic_worst[name], **critic_times[kind]})
    kernels[-len(pc.KERNELS)]["factorized_ms"] = critic_times["yardstick"]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
