"""Smoke run of the PyTorch port (mimm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a), nvcc and
no arguments.  Phases:

1. versions, the card's name and power limit, and the build of every CUDA
   source of the port (mimm_tpu_torch/csrc, one nvcc each, all started
   together) with ptxas's registers, shared memory and spills, and for
   each flash kernel, critic kernel and fused FFN forward and backward A
   the count of tensor-core instructions in its SASS (``cuobjdump -sass``:
   HMMA for mma.sync, HGMMA for wgmma; the critic forward must have HGMMA,
   the bfloat16 flash kernels, the critic backward's bwd_img, bwd_w and
   bwd_txt and the bfloat16 fused FFN forward and backward A HMMA, the
   float32 flash kernels and the float32 fused FFN forward and backward A
   neither);
2. each kernel against its plain PyTorch version on the card at the shapes
   the serving and training paths give it, with a different number of
   padded keys in each row: the flash forward at dropout rate 0 and 0.1,
   at (64, 12, 320, 64), (1, 12, 256, 64), (2, 12, 512, 64) and the ragged
   (3, 12, 264, 64) and (2, 12, 37, 64),
   the flash backward (dQ, dK, dV) at rate 0 and 0.1, the realized keep
   rate of the Philox mask, and the CUDA Philox against Random123's
   known-answer vectors; the pairwise-critic kernels (S and the seven
   gradients) at (20, 12), (300, 257) and the GradCache step's 2048 x 2048
   pairs, with the reference critic's widths, and a second forward and
   backward call on the same inputs that must give the same bits; the
   four fused FFN kernels in float32 and bfloat16 at (T, d, f) = (20480,
   768, 3072), at a ragged T and at a small shape; the three shallow-conv stem kernels (forward,
   dW, dx) in float32 and bfloat16 at (B, H, W) = (64, 256, 256), a ragged
   (3, 257, 131) and (2, 16, 16);
3. each kernel's time beside its plain version's and its bound: the flash
   kernels at (64, 12, 320, 64) with one PyTorch library call's
   (``scaled_dot_product_attention`` forward, or its backward alone: a
   yardstick the port never calls), the critic kernels at 2048 x 2048
   pairs with the factorized path (plain PyTorch and cuBLAS) as yardstick
   and each bound on the TF32 tensor cores at float32 accuracy (three
   TF32 products for a product of two inexact operands, two where one is
   the exact relu mask) and at the float32 CUDA-core rate,
   the fused FFN kernels at (20480, 768, 3072) with the unfused path
   (``F.linear``, ``F.gelu``, ``F.linear`` and autograd through them), the
   stem kernels at (64, 256, 256) with one cuDNN call each (``F.conv2d``,
   ``torch.nn.grad.conv2d_weight``, ``torch.nn.grad.conv2d_input``); and
   the attention core of a layer alone (forward + backward, bf16, B=64,
   rate 0.1) at every bucket length, the flash path against the plain
   path of ``models/bert.py`` (the ``flash_min_seq_len`` crossover), with
   the flash kernels alone beside it (the rest is the layout copies);
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
   step at L=64 and at L=320 goes, and of one attention core (flash path,
   forward + backward, L=320) between the kernels and the layout copies
   around them (torch.profiler);
7. GradCache at full width (production preset, L=128) through
   ``make_mi_train_step`` / ``make_mi_multi_step`` with
   ``grad_cache_chunks``: B=256 in 4 chunks (under the critic's switch: no
   critic kernel) and B=2048 in 32 chunks (past it: each critic kernel once
   a step), one warm-up and 2 timed steps each, ms/step, pairs/s, peak
   memory against the B=64 L=128 step's, and the critic's own memory;
8. ``BertConfig.remat``: two B=64 L=320 bf16 steps at dropout 0.1 with
   and without it, from one state (24 flash forward launches a step with
   it, 12 without, 12 backward either way; the same losses);
9. ``BertConfig(fused_ffn=True, gelu_tanh=True)`` on both paths at full
   width: the bfloat16 HTTP session with the two knobs in its
   bert_config.json, responses held against a direct forward with the flag
   off, the fused FFN forward kernel 12 times per text batch, and one
   flag-on text batch under torch.profiler; the production-preset MI step
   with the flag on at L=128 and L=320 (one warm-up and 3 timed steps
   each, 12 launches of each of the four kernels a step) beside the
   flag-off steps of phase 5, and one L=320 step under torch.profiler
   (device busy, the kernels that take it); one float32 L=320 step at
   dropout 0 with the flag on against off; two steps with and without
   remat (24 forward launches a step with it);
10. ``TrainingConfig.production(pallas_stem=True)`` on the training path
   at full width: one warm-up and 3 timed steps at L=128 and L=320 beside
   phase 5's (one forward and one dW launch a step, no dx); the L=320 step
   with the stem on and off in turns within the phase, and one step of
   each under torch.profiler (device busy, the kernels that differ); one
   f32 L=320 step at dropout 0 with the stem on against off, and with the
   stem's plain versions against both (the witness of the stem's limit on
   the share of image-tower weights that move), a GradCache step of
   B=256 in 4 chunks (8 forward and 4 dW launches), the bf16 image tower
   alone (forward + backward, B=64) with the kernel stem against the cuDNN
   stem in device ms, and one f32 tower call whose image requires a
   gradient (dx once, held against the cuDNN stem's image gradient);
11. ``MultiModalManager.train`` over 1024 in-memory compact pairs whose
   report lengths follow the bucket mix: one epoch, B=64, ``scan_steps``
   8, ``prefetch`` 2, 4 loader threads, ``pallas_stem``: steps against
   ``batches_per_epoch()``, epoch seconds and pairs/s from mi.jsonl, peak
   memory, one forward and one dW launch a step, a finite epoch loss, a
   strict reload of the written ``.bin`` files, and the device's busy time
   over the same run again under torch.profiler;
12. the ``kernels`` JSON line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; without a card it exits before
printing any result.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import math
import os
import shutil
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
from mimm_tpu_torch.models import bert as bert_model  # noqa: E402
from mimm_tpu_torch.models.bert import BertConfig, TextBert  # noqa: E402
from mimm_tpu_torch.models.joint import ImageReportModel  # noqa: E402
from mimm_tpu_torch.models.mlp import BasicMLP  # noqa: E402
from mimm_tpu_torch.models.mlp import make_mlp  # noqa: E402
from mimm_tpu_torch.models.resnet import ResNet256_6_2_1  # noqa: E402
from mimm_tpu_torch.objectives.pairing import \
    pairwise_critic_scores  # noqa: E402
from mimm_tpu_torch.ops import _build  # noqa: E402
from mimm_tpu_torch.ops import flash_attention as fa  # noqa: E402
from mimm_tpu_torch.ops import fused_ffn as ff  # noqa: E402
from mimm_tpu_torch.ops import pairwise_critic as pc  # noqa: E402
from mimm_tpu_torch.ops import shallow_conv as sc  # noqa: E402
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
# the serving shape, one and two 256 / 512-key sequences, and ragged
# lengths: five 64-key tiles with a partial last one, and one partial tile
CHECK_SHAPES = (SERVE_SHAPE, (1, 12, 256, 64), (2, 12, 512, 64),
                (3, 12, 264, 64), (2, 12, 37, 64))
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
PEAK_TF32_FLOP_PER_S = 494.7e12    # dense, on the tensor cores
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
# The kernel stem against cuDNN's changes the image tower's first layer, so
# every image-tower gradient carries its f32 noise (with flash or the fused
# FFN, only what reaches the image tower through the loss): more elements
# lie within that noise of zero and flip their first Adam step.  Each flip
# is still one step (max |Δ| <= STEP_MAX_ABS).  Measured on an NVIDIA H100
# 80GB HBM3 at 700 W: 1.67e-3 of the image tower's elements, and the same
# 1.67e-3 for the stem's plain versions against cuDNN's (compare_step's
# third arm), while the kernel stem against the plain one moves 9.8e-6.
STEM_FLIP_SHARE = 5e-3
# the pairwise critic kernels: (B_img, B_txt) shapes of the check, the
# last the GradCache step's; H1, H2 of the reference critic
CRITIC_SHAPES = ((20, 12), (300, 257), (2048, 2048))
CRITIC_HIDDEN = mi.CRITIC_HIDDEN
CRITIC_ROWS = 256          # image rows per block of the plain version
# check_critic_normal's shapes, and the bwd_img / bwd_w launches its
# chunked run of the first takes
CRITIC_NORMAL_SHAPES = ((300, 257), (2048, 2048))
CRITIC_CHUNKS = 4
# bwd_img's z2 > 0 decisions unlike float64's, at most this many times the
# share that float32 z2 (TF32 off) has.  Measured on an NVIDIA H100 80GB
# HBM3 at 700 W: 7.5-7.8 x at (300, 257), 15.8 x at 2048² (1.07e-6 against
# 6.75e-8); one TF32 product 553-1302 x
CRITIC_FLIP_RATIO = 32
# kernel against plain version, max abs error over max |reference|.  The
# inputs lie on a 2^-6 grid, so z2 is exact in f32 in any summation order
# and the relu masks of the two agree; what remains is the order of the
# later f32 sums: 1e-4 for S and dh (≤ 2048·512 terms), 1e-3 for the
# weight gradients, which sum 4.2 M pair terms in another order.  On
# normal values (check_critic_normal) the same limits hold row 6 against
# float64 with the kernels' own relu masks; measured on an NVIDIA H100
# 80GB HBM3 at 700 W: the kernels 2.5e-7-1.6e-6, one TF32 product
# 1.8e-4-3.4e-4 (dh_img past 1e-4).  Against the plain version with its
# own masks, flipped masks at z2 ≈ 0 give float32 itself (TF32 off) up to
# 3.3e-3 there, and the kernels up to 1.3e-2.
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
# the fused FFN kernels: (T, d, f) of the check: the serving and training
# paths' 64 x 320 tokens at BERT-base widths, a ragged T, and a small one
FFN_SHAPE = (BATCH * SEQ, BERT_BASE["hidden_size"],
             BERT_BASE["intermediate_size"])
FFN_SHAPES = (FFN_SHAPE, (64 * 96 + 37, *FFN_SHAPE[1:]), (100, 256, 512))
# kernel against plain version on the same inputs, max abs error over max
# |reference| of each output.  In float32 the two differ in the order of
# the f32 sums (768 or 3072 terms for y, h, dx, dh; T terms for the weight
# gradients) and in tanhf's last bits.  In bfloat16 both sum in f32 and
# round once, so they differ where a sum lies within that noise of a
# rounding boundary: one bf16 ulp (2^-8 relative) of a few elements of h,
# dh, y or dx; a flipped g or dh moves a weight gradient, an f32 sum of T
# terms, far less.
FFN_TOL = {torch.float32: {"y": 1e-5, "h": 1e-5, "dx": 1e-5, "dh": 1e-5,
                           "dw1": 1e-4, "db1": 1e-4, "dw2": 1e-4},
           torch.bfloat16: {"y": 1e-2, "h": 1e-2, "dx": 1e-2, "dh": 1e-2,
                            "dw1": 1e-3, "db1": 1e-3, "dw2": 1e-3}}
FFN_OUTPUTS = {"fwd": ("y", "h"), "bwd_a": ("dx", "dh"),
               "bwd_b1": ("dw1", "db1"), "bwd_b2": ("dw2",)}
FFN_SRC = {
    "fwd": ("mimm_tpu_torch/csrc/fused_ffn_fwd.cu",
            "mimm_tpu/ops/fused_ffn.py:85"),
    "bwd_a": ("mimm_tpu_torch/csrc/fused_ffn_bwd.cu",
              "mimm_tpu/ops/fused_ffn.py:95"),
    "bwd_b1": ("mimm_tpu_torch/csrc/fused_ffn_bwd.cu",
               "mimm_tpu/ops/fused_ffn.py:107"),
    "bwd_b2": ("mimm_tpu_torch/csrc/fused_ffn_bwd.cu",
               "mimm_tpu/ops/fused_ffn.py:120")}
FFN_TIMED = 5              # ~10 ms a launch at FFN_SHAPE
# the shallow-conv stem kernels: (B, H, W) of the check: the train step's
# batch of 256² images, a ragged shape (W no multiple of any vector, a
# ragged last strip), a small one, and W = 196, a multiple of 4 but not of
# 8 (the float32 vector path and the bfloat16 element path of the forward
# and dW); the time at the first
STEM_SHAPES = ((BATCH, 256, 256), (3, 257, 131), (2, 16, 16), (2, 64, 196))
# kernel against plain version on the same inputs, max |got − want| over
# max |want|.  The forward and dx kernels round each product and each
# running sum as the plain versions do, in their order, so they should agree
# to the bit: 1e-6 in float32, one bf16 ulp (2^-8 = 3.9e-3) in bfloat16.
# dW sums B·H·W = 4.2 M products per weight in another order than the plain
# version's torch.sum: 1e-5.
STEM_TOL = {torch.float32: {"fwd": 1e-6, "dw": 1e-5, "dx": 1e-6},
            torch.bfloat16: {"fwd": 2.0 ** -8, "dw": 1e-5, "dx": 2.0 ** -8}}
STEM_SRC = {kind: ("mimm_tpu_torch/csrc/shallow_conv.cu",
                   f"mimm_tpu/ops/shallow_conv.py:{line}")
            for kind, line in (("fwd", 54), ("dw", 73), ("dx", 99))}
STEM_TIMED = 20            # tens of microseconds a launch


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
    return libs


# the device functions of each tensor-core candidate, by a part of their
# mangled name: (library, parts, the tensor-core instruction it must have:
# "HMMA" (mma.sync), "HGMMA" (wgmma) or None, neither)
SASS_FUNCTIONS = {
    "flash_attention_fwd_bf16": (fa.SOURCE, ("fwd_bf16_kernel",), "HMMA"),
    "flash_attention_fwd_f32": (fa.SOURCE, ("fwd_kernelIfE",), None),
    "flash_attention_bwd_bf16": (fa.BWD_SOURCE, ("bwd_rows_bf16_kernel",
                                                 "bwd_cols_bf16_kernel"),
                                 "HMMA"),
    "flash_attention_bwd_f32": (fa.BWD_SOURCE, ("bwd_rows_kernelIfE",
                                                "bwd_cols_kernelIfE"), None),
    # row 5 on wgmma, rows 6 and 7 on mma.sync (3xTF32)
    "pairwise_critic_fwd": (pc.FWD_SOURCE, ("fwd_kernel",), "HGMMA"),
    "pairwise_critic_bwd_img": (pc.BWD_SOURCE, ("bwd_img_kernel",), "HMMA"),
    "pairwise_critic_bwd_w": (pc.BWD_SOURCE, ("bwd_w_kernel",), "HMMA"),
    "pairwise_critic_bwd_txt": (pc.BWD_SOURCE, ("bwd_txt_kernel",), "HMMA"),
    # rows 8 and 9: bf16 on the tensor cores (fused_ffn_tc.cuh tc_kernel),
    # f32 on the CUDA cores
    "fused_ffn_fwd_bf16": (ff.FWD_SOURCE, ("9tc_kernel",), "HMMA"),
    "fused_ffn_fwd_f32": (ff.FWD_SOURCE, ("row_tile_kernelILi",), None),
    "fused_ffn_bwd_a_bf16": (ff.BWD_SOURCE, ("9tc_kernel",), "HMMA"),
    "fused_ffn_bwd_a_f32": (ff.BWD_SOURCE, ("row_tile_kernelILi",), None),
    # rows 10 and 11: bf16 on wgmma (wgrad_kernel<GELU_A, SUM_A>) with the
    # fixed-order sum of its ranges of T, f32 on the CUDA cores
    "fused_ffn_bwd_b1_bf16": (ff.BWD_SOURCE, ("wgrad_kernelILb0ELb1E",),
                              "HGMMA"),
    "fused_ffn_bwd_b2_bf16": (ff.BWD_SOURCE, ("wgrad_kernelILb1ELb0E",),
                              "HGMMA"),
    "fused_ffn_bwd_b_reduce_bf16": (ff.BWD_SOURCE, ("wgrad_reduce_kernel",),
                                    None),
    "fused_ffn_bwd_b1_f32": (ff.BWD_SOURCE, ("acc_kernelIfLb0ELb1E",), None),
    "fused_ffn_bwd_b2_f32": (ff.BWD_SOURCE, ("acc_kernelIfLb1ELb0E",), None),
    # rows 12-14: the stem's kernels on the CUDA cores, all four dtype pairs
    "shallow_conv_fwd": (sc.SOURCE, ("10fwd_kernel",), None),
    "shallow_conv_dw": (sc.SOURCE, ("9dw_kernel", "dw_reduce_kernel"), None),
    "shallow_conv_dx": (sc.SOURCE, ("9dx_kernel",), None)}
TENSOR_OPS = ("HMMA", "HGMMA")


def ptxas_usage(report: str) -> dict:
    """{mangled function: (registers, spill store bytes, spill load bytes)}
    from an ``nvcc -Xptxas -v`` report."""
    usage, name, spills = {}, None, (0, 0)
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "bytes spill stores" in line and name:
            words = line.replace(",", "").split()
            spills = (int(words[words.index("spill") - 2]),
                      int(words[words.index("loads") - 3]))
        elif "Used" in line and "registers" in line and name:
            words = line.replace(",", "").split()
            usage[name] = (int(words[words.index("registers") - 1]), *spills)
            name, spills = None, (0, 0)
    return usage


def sass_counts(libs: dict) -> dict:
    """{kernel: {"HMMA": n, "HGMMA": n}}: the tensor-core instructions in
    its SASS (mma.sync shows as HMMA, wgmma as HGMMA), from ``cuobjdump
    -sass`` of the built libraries.  Raises unless each kernel of
    SASS_FUNCTIONS has the kind it must have (the critic forward and the
    bfloat16 fused FFN weight gradients HGMMA; the bfloat16 flash kernels,
    the critic backward's kernels and the bfloat16 fused FFN forward and
    backward A HMMA) and the float32 flash and fused FFN kernels, the
    weight gradients' reduce and the stem's kernels neither.  Prints each
    function's registers and spill bytes beside its counts."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    per_function = {}
    usage = {}
    for src in {lib for lib, _, _ in SASS_FUNCTIONS.values()}:
        usage.update({(src, f): u for f, u in
                      ptxas_usage(_build.ptxas_reports.get(src, "")).items()})
    for src in sorted({lib for lib, _, _ in SASS_FUNCTIONS.values()}):
        sass = subprocess.run([tool, "-sass", libs[src]], capture_output=True,
                              text=True, check=True).stdout
        name = None
        for line in sass.splitlines():
            if "Function :" in line:
                name = (src, line.split("Function :")[1].strip())
                per_function[name] = collections.Counter()
            elif name is None:
                continue
            elif "HGMMA" in line:
                per_function[name]["HGMMA"] += 1
            elif "HMMA" in line:
                per_function[name]["HMMA"] += 1
            elif "FFMA" in line or "FMUL" in line:
                per_function[name]["FFMA/FMUL"] += 1
    counts, wrong = {}, []
    for kernel, (src, parts, must) in SASS_FUNCTIONS.items():
        found = {f: c for (lib, f), c in per_function.items()
                 if lib == src and any(p in f for p in parts)}
        counts[kernel] = {op: sum(c[op] for c in found.values())
                          for op in TENSOR_OPS}
        regs = ", ".join(
            f"{f[1]}: {u[0]} registers, spill {u[1]} / {u[2]} bytes "
            f"stored / loaded" for f, u in sorted(usage.items())
            if f[0] == src and f[1] in found)
        print(f"  SASS {kernel}: {counts[kernel]['HMMA']} HMMA, "
              f"{counts[kernel]['HGMMA']} HGMMA, "
              f"{sum(c['FFMA/FMUL'] for c in found.values())} FFMA/FMUL in "
              f"{sorted(found)}; ptxas: {regs or 'no report'}")
        held = counts[kernel][must] > 0 if must else \
            not any(counts[kernel].values())
        if not found or not held:
            wrong.append(kernel)
    if wrong:
        raise AssertionError(f"tensor-core instructions (HMMA, HGMMA) where "
                             f"none belong or not the kind that must be "
                             f"there: {wrong} {counts}")
    return counts


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
        again = [pc.pair_scores(*args[:7]), *pc.pair_scores_bwd(*args)]
        _sync(device)
        # every sum in a fixed order: the same bits twice (remat, GradCache)
        rerun = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
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
              f"{CRITIC_TOL['dW2']:.0e} for the weights); a second forward "
              f"and backward give the same bits: {rerun}")
        bad = [n for n in names if not errs[n] <= CRITIC_TOL[n]]
        if not rerun:
            raise AssertionError(f"two critic forward and backward calls "
                                 f"at {(n_img, n_txt)} differ")
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


def critic_inputs_normal(n_img, n_txt, hidden, gen, device):
    """(h_img, h_txt, b1, W2, b2, w3, b3, g) float32 at the scale of the
    reference critic in training: h = emb·W1 of unit-normal 768-d
    embeddings, W1, W2, w3 and the biases as ``make_mlp(1536, hidden)``
    initializes them (uniform within 1/sqrt(fan_in)), g unit-normal over
    B_txt (a softmax cross-entropy cotangent's scale).  Unlike
    ``critic_inputs`` no value is exact in tf32, so every low half of the
    3xTF32 split is in play, and z2 lies within rounding of 0 for some
    pairs."""
    h1, h2 = hidden
    d = BERT_BASE["hidden_size"]
    mlp = make_mlp(2 * d, list(hidden),
                   generator=torch.Generator().manual_seed(SEED + n_img))
    (w1, b1), (w2, b2), (w3, b3) = [(layer["w"].to(device),
                                     layer["b"].to(device)) for layer in mlp]
    emb = [torch.randn(n, d, generator=gen, device=device)
           for n in (n_img, n_txt)]
    g = torch.randn(n_img, n_txt, generator=gen, device=device) / n_txt
    return (emb[0] @ w1[:d], emb[1] @ w1[d:], b1, w2.contiguous(), b2,
            w3.contiguous(), b3, g)


def critic_masked_bwd(args, bits, rows):
    """Rows 6 and 7's gradients with the relu masks the kernels used: t
    from the float32 z1 = (h_img + h_txt) + b1 they form, the z2 > 0 mask from
    ``bits`` (``bwd_img``'s), the products in float64 (the judge), float32
    and float32 in one TF32 pass each (the control).  So only the products'
    own rounding is left.  Also the share of z2 > 0 decisions that differ
    from float64's: ``bits``', and those of z2 in float32 and in TF32.
    Returns ({variant: {output: tensor}}, {variant: share})."""
    h_img, h_txt, b1, w2, b2, w3, _, g = args
    (n_img, h1), n_txt, h2 = h_img.shape, h_txt.shape[0], w2.shape[1]
    variants = {"f64": torch.float64, "f32": torch.float32,
                "tf32": torch.float32}
    grads = {v: {"dh_img": torch.empty(n_img, h1, dtype=dt,
                                       device=h_img.device),
                 "dh_txt": torch.zeros(n_txt, h1, dtype=dt,
                                       device=h_img.device),
                 "dW2": torch.zeros(h1, h2, dtype=dt, device=h_img.device),
                 "db2": torch.zeros(h2, dtype=dt, device=h_img.device)}
             for v, dt in variants.items()}
    flips = dict.fromkeys(("kernel", "f32", "tf32"), 0)
    shifts = torch.arange(32, device=bits.device, dtype=torch.int32)
    for blk in pc._row_blocks(n_img, rows):
        t32 = F.relu(h_img[blk, None, :] + h_txt[None, :, :] + b1)
        n = t32.shape[0]
        words = bits[blk.start * n_txt:blk.stop * n_txt]
        mask = ((words[..., None] >> shifts) & 1).reshape(n, n_txt, -1)
        mask = mask[..., :h2].bool()
        del words
        z_pos = {}
        for v, dt in variants.items():
            torch.backends.cuda.matmul.allow_tf32 = v == "tf32"
            try:
                t, w = t32.to(dt), w2.to(dt)
                z_pos[v] = (t @ w + b2.to(dt)) > 0
                dz2 = (g[blk, :, None].to(dt) * w3.reshape(-1).to(dt)) * mask
                dz1 = (dz2 @ w.T) * (t32 > 0)
                grads[v]["dh_img"][blk] = dz1.sum(1)
                grads[v]["dh_txt"] += dz1.sum(0)
                del dz1
                grads[v]["dW2"] += t.reshape(-1, h1).T @ dz2.reshape(-1, h2)
                grads[v]["db2"] += dz2.sum((0, 1))
                del t, dz2
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        flips["kernel"] += (mask != z_pos["f64"]).sum().item()
        for v in ("f32", "tf32"):
            flips[v] += (z_pos[v] != z_pos["f64"]).sum().item()
        del t32, mask, z_pos
    for v in grads:
        grads[v]["db1"] = grads[v]["dh_img"].sum(0)
    return grads, {v: c / (n_img * n_txt * h2) for v, c in flips.items()}


def check_critic_normal(device, shapes=CRITIC_NORMAL_SHAPES,
                        hidden=CRITIC_HIDDEN) -> dict:
    """The critic kernels on ``critic_inputs_normal``, per shape.  On such
    values z2 lies within float32 rounding of 0 for some pairs, and a
    flipped relu mask moves a gradient by one pair's term, which no float32
    version avoids (the plain one with TF32 off included): so the products
    and the masks are judged apart.  Raises unless
      * rows 6 and 7's gradients (dh_img, dh_txt, db1, dW2, db2) hold
        CRITIC_TOL, unchanged, against ``critic_masked_bwd`` in float64 with the
        kernels' own masks, and the control (the same in TF32, what one
        TF32 product in place of 3xTF32 gives) fails it at the last shape;
      * ``bwd_img``'s z2 > 0 decisions differ from float64's in at most
        CRITIC_FLIP_RATIO times the share that float32 z2 (TF32 off) does,
        and TF32's exceed that at the last shape;
      * S and dw3, continuous in z2, hold CRITIC_TOL against the plain
        version in float64;
      * two backward calls give the same bits, and each kernel launches
        once a call.
    Every gradient's error against the plain version in float64 is printed
    beside the plain float32 version's.  The first shape runs again with
    BITS_BUDGET_BYTES cut so that the backward takes about CRITIC_CHUNKS
    launches of bwd_img, bwd_w and bwd_txt, whole bwd_img blocks of image
    rows each.  Returns the largest max abs error per kernel name."""
    gen = torch.Generator(device=device).manual_seed(SEED + 16)
    worst = dict.fromkeys(pc.KERNELS.values(), 0.0)
    names = ("S", "dh_img", "dh_txt", "db1", "dW2", "db2", "dw3", "db3")
    judged = ("dh_img", "dh_txt", "db1", "dW2", "db2")   # rows 6 and 7
    budget = pc.BITS_BUDGET_BYTES
    runs = [(shape, None) for shape in shapes]
    runs.insert(1, (shapes[0], CRITIC_CHUNKS))
    fmt = lambda e: ", ".join(f"{n} {v:.2e}" for n, v in e.items())
    for run, ((n_img, n_txt), chunks) in enumerate(runs):
        last = run == len(runs) - 1
        args = critic_inputs_normal(n_img, n_txt, hidden, gen, device)
        bargs = (*args[:6], args[7])
        rows = CRITIC_ROWS // 2 if n_img > CRITIC_ROWS else None
        if chunks:      # whole bwd_img blocks of image rows a launch
            per = -(-n_img // chunks)
            per = -(-per // pc._IMG_ROWS) * pc._IMG_ROWS
            pc.BITS_BUDGET_BYTES = per * n_txt * -(-hidden[1] // 32) * 4
            chunks = -(-n_img // per)
        try:
            before = dict(pc.LAUNCHES)
            got = [pc.pair_scores(*args[:7]), *pc.pair_scores_bwd(*args)]
            launched = {k: pc.LAUNCHES[pc.KERNELS[k]]
                        - before.get(pc.KERNELS[k], 0) for k in pc.KERNELS}
            again = pc.pair_scores_bwd(*args)
        finally:
            pc.BITS_BUDGET_BYTES = budget
        _sync(device)
        rerun = all(torch.equal(a, b) for a, b in zip(got[1:], again))
        del again
        got = dict(zip(names, got))
        bits = pc.bwd_img_kernel(bargs, torch.empty_like(args[0]), torch.empty(
            -(-n_img // pc._IMG_ROWS), 2 * hidden[1] + 1, device=device))
        masked, flips = critic_masked_bwd(args, bits, rows)
        del bits
        ref = masked.pop("f64")
        err = {v: {n: _scaled_err(a[n], ref[n]) for n in judged}
               for v, a in [("kernel", got), *masked.items()]}
        f64 = [a.double() for a in args]
        want = dict(zip(names, [pc.pair_scores_plain(*f64[:7], rows=rows),
                                *pc.pair_scores_bwd_plain(*f64, rows=rows)]))
        del f64
        plain = dict(zip(names, [pc.pair_scores_plain(*args[:7], rows=rows),
                                 *pc.pair_scores_bwd_plain(*args, rows=rows)]))
        end = {v: {n: _scaled_err(a[n], want[n]) for n in names}
               for v, a in (("kernel", got), ("f32", plain))}
        del plain
        print(f"  pairwise critic, normal values {(n_img, n_txt, *hidden)}"
              f"{f' in {chunks} row ranges' if chunks else ''}: rows 6-7 with "
              f"the kernels' masks against float64: kernels {fmt(err['kernel'])}"
              f"; float32 {fmt(err['f32'])}; control, TF32 "
              f"{fmt(err['tf32'])} (tol {CRITIC_TOL['dh_img']:.0e} for dh, "
              f"{CRITIC_TOL['dW2']:.0e} for the weights)")
        print(f"    z2 > 0 decisions unlike float64's: bwd_img "
              f"{flips['kernel']:.3e}, float32 {flips['f32']:.3e}, TF32 "
              f"{flips['tf32']:.3e} (limit {CRITIC_FLIP_RATIO} x float32's);"
              f" against the plain version in float64, masks as each "
              f"computes them: kernels {fmt(end['kernel'])}; plain float32 "
              f"{fmt(end['f32'])}; a second backward gives the same bits: "
              f"{rerun}; launches {launched}")
        want_launches = {k: chunks if chunks and k in ("bwd_img", "bwd_w",
                                                       "bwd_txt")
                         else 1 for k in pc.KERNELS}
        bad = [n for n in judged if not err["kernel"][n] <= CRITIC_TOL[n]]
        bad += [n for n in ("S", "dw3")
                if not end["kernel"][n] <= CRITIC_TOL[n]]
        # at least one decision's share, so that one flip is no failure
        flip_limit = CRITIC_FLIP_RATIO * max(
            flips["f32"], 1 / (n_img * n_txt * hidden[1]))
        if not flips["kernel"] <= flip_limit:
            bad.append("z2 > 0 decisions")
        if not rerun:
            raise AssertionError(f"two critic backward calls at "
                                 f"{(n_img, n_txt)} differ")
        if bad:
            raise AssertionError(f"critic kernels on normal values at "
                                 f"{(n_img, n_txt)}: {bad} {err['kernel']} "
                                 f"{end['kernel']} {flips}")
        if launched != want_launches:
            raise AssertionError(f"critic launches {launched}, want "
                                 f"{want_launches}")
        if last and (all(err["tf32"][n] <= CRITIC_TOL[n] for n in judged)
                     or flips["tf32"] <= flip_limit):
            raise AssertionError(f"the TF32 control passes at "
                                 f"{(n_img, n_txt)}: {err['tf32']} {flips};"
                                 f" the check cannot tell 3xTF32 from one "
                                 f"TF32 product")
        k = pc.KERNELS
        abs_err = lambda n, r: (got[n].double() - r[n]).abs().max().item()
        for name, e in ((k["fwd"], abs_err("S", want)),
                        (k["bwd_img"], abs_err("dh_img", ref)),
                        (k["bwd_txt"], abs_err("dh_txt", ref)),
                        (k["bwd_w"], abs_err("dW2", ref)),
                        (k["bwd_reduce"], max(abs_err("db1", ref),
                                              abs_err("db2", ref),
                                              abs_err("dw3", want)))):
            worst[name] = max(worst[name], e)
        del got, args, bargs, masked, ref, want
    return worst


def ffn_inputs(t, d, f, dtype, gen, device):
    """(x, w1, b1, w2, b2, dy): unit-scale activations and cotangent,
    N(0, 0.02) weights as views of (out, in) tensors, the layout of the
    model's nn.Linear weights, from a seeded generator."""
    def draw(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen,
                                    device=device)).to(dtype)

    return (draw(t, d), draw(f, d, scale=0.02).t(), draw(f, scale=0.02),
            draw(d, f, scale=0.02).t(), draw(d, scale=0.02), draw(t, d))


def check_ffn(device, shapes=FFN_SHAPES) -> dict:
    """The four fused FFN kernels against their plain versions on the same
    inputs (the backward kernels on the plain forward's h and the plain
    backward's dh), per shape and dtype; raises past FFN_TOL, or if a
    second call of B1 or B2 gives other bits (their sums over T have a
    fixed order).  Returns the largest max abs error per (kernel name,
    dtype)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    worst = {(n, dt): 0.0 for n in ff.KERNELS.values() for dt in DTYPES}
    for t, d, f in shapes:
        for dt in DTYPES:
            x, w1, b1, w2, b2, dy = ffn_inputs(t, d, f, dt, gen, device)
            want = {"fwd": ff.fwd_plain(x, w1, b1, w2, b2)}
            h = want["fwd"][1]
            want["bwd_a"] = ff.bwd_a_plain(dy, h, w1, w2)
            dh = want["bwd_a"][1]
            want["bwd_b1"] = ff.bwd_b1_plain(x, dh)
            want["bwd_b2"] = (ff.bwd_b2_plain(dy, h),)
            _sync(device)
            got = {"fwd": ff.fwd(x, w1, b1, w2, b2),
                   "bwd_a": ff.bwd_a(dy, h, w1, w2),
                   "bwd_b1": ff.bwd_b1(x, dh), "bwd_b2": (ff.bwd_b2(dy, h),)}
            again = [*ff.bwd_b1(x, dh), ff.bwd_b2(dy, h)]
            _sync(device)
            if not all(torch.equal(a, b) for a, b in zip(
                    [*got["bwd_b1"], *got["bwd_b2"]], again)):
                raise AssertionError(f"fused FFN B1 / B2 gave other bits on a "
                                     f"second call at {(t, d, f)} {dt}")
            errs = {}
            for kind, names in FFN_OUTPUTS.items():
                for name, a, b in zip(names, got[kind], want[kind]):
                    same = a.shape == b.shape and a.dtype == b.dtype
                    errs[name] = _scaled_err(a, b) if same else math.inf
                    key = ff.KERNELS[kind], dt
                    worst[key] = max(worst[key], (a.float() - b.float())
                                     .abs().max().item() if same else math.inf)
            print(f"  fused_ffn {(t, d, f)} {dt}: scaled max err "
                  + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
                  + f" (tol {FFN_TOL[dt]['y']:.0e}, weight gradients "
                  f"{FFN_TOL[dt]['dw1']:.0e}); B1, B2 the same bits twice")
            bad = [n for n, e in errs.items() if not e <= FFN_TOL[dt][n]]
            if bad:
                raise AssertionError(f"fused FFN kernels disagree with their "
                                     f"plain versions at {(t, d, f)} {dt}: "
                                     f"{bad} {errs}")
            del got, again, want, x, w1, w2, dy, h, dh
    return worst


def stem_inputs(b, h, w, dtype, gen, device):
    """(x (B, H, W, 1), weight (8, 1, 3, 3) float32, dy (B, 8, H, W)): a
    normalized 8-bit image in ``dtype`` (the stem's input after the cast to
    the compute dtype), He-normal weights, a unit-scale cotangent."""
    x = torch.randint(0, 256, (b, h, w, 1), generator=gen, device=device)
    weight = torch.randn(8, 1, 3, 3, generator=gen, device=device) \
        * math.sqrt(2.0 / 72)
    dy = torch.randn(b, 8, h, w, generator=gen, device=device)
    return (x.float() / 255).to(dtype), weight, dy.to(dtype)


def check_stem(device, shapes=STEM_SHAPES) -> dict:
    """The three shallow-conv kernels against their plain versions on the
    same inputs, per shape and dtype, and dW called twice; raises past
    STEM_TOL or if the two dW calls differ in a bit.  Returns the largest
    max abs error per (kernel name, dtype)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    worst = {(n, dt): 0.0 for n in sc.KERNELS.values() for dt in DTYPES}
    for b, h, w in shapes:
        for dt in DTYPES:
            x, weight, dy = stem_inputs(b, h, w, dt, gen, device)
            want = {"fwd": sc.fwd_plain(x, weight, dt),
                    "dw": sc.dw_plain(x, dy),
                    "dx": sc.dx_plain(dy, weight, dt)}
            _sync(device)
            got = {"fwd": sc.fwd(x, weight, dt), "dw": sc.dw(x, dy, weight),
                   "dx": sc.dx(dy, weight, dt)}
            dw_again = sc.dw(x, dy, weight)
            _sync(device)
            same_bits = bool(torch.equal(dw_again, got["dw"]))
            errs = {}
            for kind, a in got.items():
                b_ = want[kind]
                same = a.shape == b_.shape and a.dtype == b_.dtype
                errs[kind] = _scaled_err(a, b_) if same else math.inf
                key = sc.KERNELS[kind], dt
                worst[key] = max(worst[key], (a.float() - b_.float()).abs()
                                 .max().item() if same else math.inf)
            exact = {k: bool(torch.equal(got[k], want[k]))
                     for k in ("fwd", "dx")}
            print(f"  shallow_conv {(b, h, w)} {dt}: scaled max err "
                  + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
                  + f" (tol {STEM_TOL[dt]}); bit-equal {exact}; dW twice: "
                  f"the same bits {same_bits}")
            bad = [k for k, e in errs.items() if not e <= STEM_TOL[dt][k]]
            if not same_bits:
                bad.append("dw twice")
            if bad:
                raise AssertionError(f"shallow conv kernels disagree with "
                                     f"their plain versions at {(b, h, w)} "
                                     f"{dt}: {bad} {errs}")
            del got, want, x, dy, dw_again
    return worst


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---- phase 3: timing --------------------------------------------------------

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


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device ms of ``fn``: the CUDA kernels' and copies' own time
    under torch.profiler over ``iters`` calls, divided by ``iters``.  For
    work of tens of microseconds, where back-to-back calls timed by CUDA
    events also take in the host's time between launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy / 1e3 / iters


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


BUCKET_TIMED = 10


def _attention_arms(seq: int, gen, batch=BATCH, bert_kw=None,
                    device="cuda"):
    """The attention core of one BERT layer at (batch, seq), bf16, dropout
    0.1, forward and backward: {"plain": the plain path of models/bert.py,
    "flash": its flash path (the layout copies in and out around the
    kernels), "kernels": the flash kernels alone on contiguous tensors}."""
    bert_kw = TRAIN_BERT if bert_kw is None else bert_kw
    nh = bert_kw["num_attention_heads"]
    hd = bert_kw["hidden_size"] // nh
    on = BertConfig(**dict(bert_kw, flash_attention=True,
                           flash_min_seq_len=0))
    off = BertConfig(**dict(bert_kw, flash_attention=False))
    qkv = torch.randn(batch, seq, 3 * nh * hd, generator=gen,
                      device=device).to(torch.bfloat16).requires_grad_()
    q, k, v, bias = attention_inputs((batch, nh, seq, hd), torch.bfloat16,
                                     gen, device)
    attn_bias = bias[:, None, None, :].to(torch.bfloat16)
    dctx = torch.randn(batch, seq, nh * hd, generator=gen,
                       device=device).to(torch.bfloat16)
    seed = _seed(13, device)
    qc, kc, vc = (t.detach().requires_grad_() for t in (q, k, v))
    dctx_heads = dctx.view(batch, seq, nh, hd).transpose(1, 2).contiguous()
    rate = on.attention_probs_dropout_prob

    def model_path(cfg):
        def run():
            parts = (t.reshape(batch, seq, nh, hd).transpose(1, 2)
                     for t in qkv.split(nh * hd, dim=-1))
            ctx = bert_model.attention(cfg, *parts, attn_bias, False, gen)
            torch.autograd.grad(ctx, qkv, dctx)
        return run

    def kernels():
        ctx = fa.flash_attention(qc, kc, vc, bias, seed, rate)
        torch.autograd.grad(ctx, (qc, kc, vc), dctx_heads)
    return {"plain": model_path(off), "flash": model_path(on),
            "kernels": kernels}


def time_buckets(buckets=PRODUCTION_SEQ_BUCKETS) -> dict:
    """ms of the attention core (forward + backward, B=64, bf16, rate 0.1)
    at each bucket length, the flash path against the plain path of
    models/bert.py (the flash_min_seq_len crossover), and the flash
    kernels alone (the rest of the flash path is its layout copies); CUDA
    events over BUCKET_TIMED calls, the arms in turns."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    card = card_line()
    out = {}
    for seq in buckets:
        arms = _attention_arms(seq, gen)
        ms = {name: time_ms(fn, iters=BUCKET_TIMED, warmup=2)
              for name, fn in arms.items()}
        out[seq] = ms
        print(f"  attention fwd+bwd bf16 B={BATCH} L={seq}: plain "
              f"{ms['plain']:.4f} ms, flash {ms['flash']:.4f} ms (kernels "
              f"{ms['kernels']:.4f}, layout copies "
              f"{ms['flash'] - ms['kernels']:.4f}), flash/plain "
              f"{ms['flash'] / ms['plain']:.3f}  [{card}]")
    return out


def critic_bounds(n_img, n_txt, hidden, splits) -> dict:
    """{kind: (ms, 'bytes' | 'operations', ms on the CUDA cores)} of each
    critic kernel, and 'bwd' for the whole backward.  One pair product is
    2·P·H1·H2 float32 FLOP.  The least time for it at float32 accuracy is
    on the TF32 tensor cores (494.7 TFLOP/s): three TF32 products (3xTF32)
    where both operands are inexact, two where one is exact in tf32, as the
    relu mask (1.0 or 0.0) is.  The z2 recompute needs three (t·W2); dt =
    g·(mask·(w3∘W2)ᵀ) and dW2 = w3·((g·t)ᵀ·mask) need two each.  So the
    forward needs 3 TF32 products, bwd_img 5 (z2, dt), bwd_w 2 (dW2),
    bwd_txt 2 (dt), and the whole backward no fewer than 7 (z2, dt, dW2).
    The third number is the pair products (1, 2, 1, 1, 3) at the 67 TFLOP/s
    float32 rate outside the tensor cores.  Bytes:
    h rows, W2, g, S, the gradients, and bwd_img's z2 bits (written once,
    read once by bwd_w and by bwd_txt) and dW2 partials; they are far
    below.  The sums kernel moves bytes only: the partials and dh_img read
    once, the gradients written once."""
    h1, h2 = hidden
    pairs = n_img * n_txt
    flop = 2 * pairs * h1 * h2
    tf32 = flop / PEAK_TF32_FLOP_PER_S * 1e3
    prod_f32 = flop / PEAK_FLOP_PER_S[torch.float32] * 1e3
    io = 4 * ((n_img + n_txt) * h1 + h1 * h2 + 2 * h2 + h1 + 1 + pairs)
    bits = 4 * pairs * -(-h2 // 32)
    parts = -(-n_img // pc._IMG_ROWS) * (2 * h2 + 1)
    moved = {"fwd": io, "bwd_img": io + bits + 4 * parts,
             "bwd_w": io + bits + 4 * splits * h1 * h2,
             "bwd_txt": io + bits, "bwd": io}
    out = {}
    for kind, n_tf32, n_pair in (("fwd", 3, 1), ("bwd_img", 5, 2),
                                 ("bwd_w", 2, 1), ("bwd_txt", 2, 1),
                                 ("bwd", 7, 3)):
        io_ms = moved[kind] / HBM_BYTES_PER_S * 1e3
        out[kind] = (max(n_tf32 * tf32, io_ms), "operations"
                     if n_tf32 * tf32 >= io_ms else "bytes", n_pair * prod_f32)
    red = 4 * (splits * h1 * h2 + parts + n_img * h1 + h1 * h2 + h1
               + 2 * h2 + 1)
    out["bwd_reduce"] = (red / HBM_BYTES_PER_S * 1e3, "bytes", None)
    return out


ROW6 = ("bwd_img", "bwd_w", "bwd_reduce")


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
    splits = pc.bwd_splits(*shape)
    dh_img = torch.empty(shape[0], hidden[0], device="cuda")
    vecp = torch.empty(-(-shape[0] // pc._IMG_ROWS), 2 * hidden[1] + 1,
                       device="cuda")
    bits = pc.bwd_img_kernel(bargs, dh_img, vecp)
    dw2p = pc.bwd_w_kernel(bargs, bits, splits)
    calls = {"fwd": lambda: pc.pair_scores(*args[:7]),
             "bwd_img": lambda: pc.bwd_img_kernel(bargs, dh_img, vecp),
             "bwd_w": lambda: pc.bwd_w_kernel(bargs, bits, splits),
             "bwd_reduce": lambda: pc.bwd_reduce_kernel(dw2p, vecp, dh_img),
             "bwd_txt": lambda: pc.bwd_txt_kernel(bargs, bits)}
    ms = {kind: time_ms(call, iters=CRITIC_TIMED, warmup=1)
          for kind, call in calls.items()}
    plain = {"fwd": time_ms(lambda: pc.pair_scores_plain(
        *args[:7], rows=CRITIC_ROWS), iters=CRITIC_TIMED, warmup=1),
        "bwd": time_ms(lambda: pc.pair_scores_bwd_plain(
            *args, rows=CRITIC_ROWS), iters=CRITIC_TIMED, warmup=1)}
    bounds = critic_bounds(*shape, hidden, splits)
    out = {}
    for kind in calls:
        bound_ms, bound_by, cores_ms = bounds[kind]
        out[kind] = dict(ms=ms[kind], plain_ms=plain["fwd" if kind == "fwd"
                                                      else "bwd"],
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None, bound_ms_f32_cores=cores_ms)
        cores = "" if cores_ms is None else (
            f"; {cores_ms:.4f} ms at the float32 rate outside the tensor "
            f"cores ({100 * cores_ms / ms[kind]:.1f}%)")
        print(f"  {pc.KERNELS[kind]} {shape + hidden}: kernel {ms[kind]:.4f}"
              f" ms, bound {bound_ms:.4f} ms ({bound_by}, TF32), kernel at "
              f"{100 * bound_ms / ms[kind]:.1f}% of the bound{cores}; plain "
              f"{out[kind]['plain_ms']:.4f} ms  [{card}]")
    row6 = sum(ms[k] for k in ROW6)
    row6_bound = sum(bounds[k][0] for k in ROW6)
    row6_cores = sum(bounds[k][2] or 0.0 for k in ROW6)
    print(f"  row 6 (bwd_img + bwd_w + bwd_reduce) {shape + hidden}: "
          f"{row6:.4f} ms, TF32 bound {row6_bound:.4f} ms "
          f"({100 * row6_bound / row6:.1f}%), float32 CUDA-core bound "
          f"{row6_cores:.4f} ms ({100 * row6_cores / row6:.1f}%)  [{card}]")
    bwd_ms = sum(ms[k] for k in calls if k != "fwd")
    print(f"  critic backward {shape + hidden}: four kernels {bwd_ms:.4f} ms "
          f"(4 pair products), bound of the backward {bounds['bwd'][0]:.4f} "
          f"ms (7 TF32 products; {bounds['bwd'][2]:.4f} ms at the "
          f"float32 rate); plain forward {plain['fwd']:.4f} ms, plain "
          f"backward {plain['bwd']:.4f} ms ({CRITIC_ROWS} image rows a "
          f"block)  [{card}]")
    out["bwd_img"]["row6_ms"] = row6
    del args, bargs, dh_img, bits, vecp, dw2p

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


def ffn_bounds(t, d, f, dtype) -> dict:
    """{kind: (ms, 'bytes' | 'operations')}: one product is 2·T·d·f FLOP at
    the dtype's peak; the forward and backward A do two, B1 and B2 one.
    Bytes: every input read and every output written once (the weight
    gradients and db1 in f32); the GELU's O(T·f) operations are left out."""
    e = torch.empty((), dtype=dtype).element_size()
    prod = 2 * t * d * f / PEAK_FLOP_PER_S[dtype]
    acts = e * (t * d + t * f)
    moved = {"fwd": e * (2 * t * d + t * f + 2 * d * f + d + f),
             "bwd_a": e * (2 * t * d + 2 * t * f + 2 * d * f),
             "bwd_b1": acts + 4 * (d * f + f), "bwd_b2": acts + 4 * d * f}
    out = {}
    for kind, n in (("fwd", 2), ("bwd_a", 2), ("bwd_b1", 1), ("bwd_b2", 1)):
        t_ops, t_bytes = n * prod, moved[kind] / HBM_BYTES_PER_S
        out[kind] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def time_ffn(shape=FFN_SHAPE) -> dict:
    """{(kind, dtype): times} of each fused FFN kernel at the serving and
    training shape (CUDA events, FFN_TIMED launches after one), beside its
    plain version, its bound, and the unfused path: ``F.linear``,
    ``F.gelu(approximate="tanh")``, ``F.linear`` and autograd through them
    (cuBLAS and elementwise kernels: several calls, a yardstick the port's
    fused path never calls, and no single library call).  B1 and B2 also
    beside one cuBLAS call each (``library_ms``): ``torch.mm(dh.t(), x)``,
    dw1 in the inputs' dtype without db1, and ``torch.mm(dy.t(), g)``, the
    product alone, g = T(gelu_tanh(h)) made before the timed window; and
    their device time under the profiler (``device_ms``: the kernels' own
    time, the host's between back-to-back calls left out)."""
    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    out = {}
    for dt in DTYPES:
        x, w1, b1, w2, b2, dy = ffn_inputs(*shape, dt, gen, "cuda")
        _, h = ff.fwd(x, w1, b1, w2, b2)
        _, dh = ff.bwd_a(dy, h, w1, w2)
        g = ff.gelu_tanh(h.float()).to(dt)
        library = {"bwd_b1": lambda: torch.mm(dh.t(), x),
                   "bwd_b2": lambda: torch.mm(dy.t(), g)}
        pairs = {"fwd": (lambda: ff.fwd(x, w1, b1, w2, b2),
                         lambda: ff.fwd_plain(x, w1, b1, w2, b2)),
                 "bwd_a": (lambda: ff.bwd_a(dy, h, w1, w2),
                           lambda: ff.bwd_a_plain(dy, h, w1, w2)),
                 "bwd_b1": (lambda: ff.bwd_b1(x, dh),
                            lambda: ff.bwd_b1_plain(x, dh)),
                 "bwd_b2": (lambda: ff.bwd_b2(dy, h),
                            lambda: ff.bwd_b2_plain(dy, h))}
        bounds = ffn_bounds(*shape, dt)
        leaves = [a.detach().requires_grad_() for a in (x, w1, b1, w2, b2)]

        def unfused():
            xs, w1s, b1s, w2s, b2s = leaves
            return F.linear(F.gelu(F.linear(xs, w1s.t(), b1s),
                                   approximate="tanh"), w2s.t(), b2s)

        def unfused_fwd():
            with torch.no_grad():
                unfused()

        y = unfused()
        unfused_ms = {
            "fwd": time_ms(unfused_fwd, iters=FFN_TIMED, warmup=1),
            "bwd": time_ms(lambda: torch.autograd.grad(
                y, leaves, dy, retain_graph=True), iters=FFN_TIMED, warmup=1)}
        del y
        for kind, (kernel, plain) in pairs.items():
            ms = time_ms(kernel, iters=FFN_TIMED, warmup=1)
            plain_ms = time_ms(plain, iters=3, warmup=1)
            library_ms = time_ms(library[kind], iters=FFN_TIMED, warmup=1) \
                if kind in library else None
            bound_ms, bound_by = bounds[kind]
            out[kind, dt] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, library_ms=library_ms)
            if kind in library:     # without the host's time between calls
                out[kind, dt]["device_ms"] = device_ms(kernel, iters=20)
            print(f"  {ff.KERNELS[kind]} {shape} {dt}: kernel {ms:.4f} ms"
                  + (f" (device {out[kind, dt]['device_ms']:.4f} ms)"
                     if kind in library else "")
                  + f", plain {plain_ms:.4f} ms, "
                  + (f"one cuBLAS call {library_ms:.4f} ms, "
                     if library_ms else "")
                  + f"bound {bound_ms:.4f} ms ({bound_by}), kernel at "
                  f"{100 * bound_ms / ms:.1f}% of the bound  [{card}]")
        bwd_ms = sum(out[k, dt]["ms"] for k in ("bwd_a", "bwd_b1", "bwd_b2"))
        print(f"  fused FFN {shape} {dt}: forward kernel "
              f"{out['fwd', dt]['ms']:.4f} ms against the unfused forward "
              f"{unfused_ms['fwd']:.4f} ms and its bound "
              f"{out['fwd', dt]['bound_ms']:.4f} ms; three backward kernels "
              f"{bwd_ms:.4f} ms against autograd through the unfused path "
              f"{unfused_ms['bwd']:.4f} ms  [{card}]")
        out["fwd", dt]["unfused_fwd_ms"] = unfused_ms["fwd"]
        out["bwd_a", dt]["unfused_bwd_ms"] = unfused_ms["bwd"]
        out["bwd_a", dt]["fused_bwd_ms"] = bwd_ms
        del x, w1, w2, dy, h, dh, g, leaves, library
        torch.cuda.empty_cache()
    return out


def stem_bounds(b, h, w, dtype) -> dict:
    """{kind: (ms, 'bytes' | 'operations')}: 72 multiply-adds a pixel
    (2·B·H·W·8·9 FLOP) at the dtype's peak, against each input read and
    each output written once: the forward x and y, dW x and dy (and the 72
    float32 sums), dx dy and dx; x and dx in ``dtype`` as on the training
    path, where the image is cast to the compute dtype first."""
    e = torch.empty((), dtype=dtype).element_size()
    pixels = b * h * w
    t_ops = 2 * pixels * 72 / PEAK_FLOP_PER_S[dtype]
    moved = {"fwd": e * pixels * 9, "dw": e * pixels * 9 + 4 * 72,
             "dx": e * pixels * 9}
    return {kind: (max(t_ops, n / HBM_BYTES_PER_S) * 1e3,
                   "operations" if t_ops >= n / HBM_BYTES_PER_S else "bytes")
            for kind, n in moved.items()}


def time_stem(shape=STEM_SHAPES[0]) -> dict:
    """{(kind, dtype): times} of each shallow-conv kernel at the train
    step's shape, beside its plain version, its bound and one cuDNN call
    computing the same function (``F.conv2d``,
    ``torch.nn.grad.conv2d_weight``, ``torch.nn.grad.conv2d_input``, with
    TF32 off as ``main`` sets it).  In bfloat16 cuDNN takes the weight in
    bfloat16: the same operation with one rounding more.  Each time is the
    device's (``device_ms``, STEM_TIMED calls); ``ms_events`` is the
    kernel's wrapper called back to back under CUDA events, the host's time
    between launches included."""
    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    out = {}
    for dt in DTYPES:
        x, weight, dy = stem_inputs(*shape, dt, gen, "cuda")
        xc = x.permute(0, 3, 1, 2)          # (B, 1, H, W), the same memory
        wc = weight.to(dt)
        calls = {
            "fwd": (lambda: sc.fwd(x, weight, dt),
                    lambda: sc.fwd_plain(x, weight, dt),
                    lambda: F.conv2d(xc, wc, padding=1)),
            "dw": (lambda: sc.dw(x, dy, weight), lambda: sc.dw_plain(x, dy),
                   lambda: torch.nn.grad.conv2d_weight(xc, wc.shape, dy,
                                                       padding=1)),
            "dx": (lambda: sc.dx(dy, weight, dt),
                   lambda: sc.dx_plain(dy, weight, dt),
                   lambda: torch.nn.grad.conv2d_input(xc.shape, wc, dy,
                                                      padding=1))}
        bounds = stem_bounds(*shape, dt)
        for kind, (kernel, plain, library) in calls.items():
            ms = device_ms(kernel, iters=STEM_TIMED)
            ms_events = time_ms(kernel, iters=STEM_TIMED)
            plain_ms = device_ms(plain, iters=3, warmup=1)
            library_ms = device_ms(library, iters=STEM_TIMED)
            # cuDNN's own autotuned choice beside its heuristic one
            torch.backends.cudnn.benchmark = True
            try:
                tuned_ms = device_ms(library, iters=STEM_TIMED)
            finally:
                torch.backends.cudnn.benchmark = False
            bound_ms, bound_by = bounds[kind]
            out[kind, dt] = dict(ms=ms, plain_ms=plain_ms,
                                 library_ms=library_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, ms_events=ms_events,
                                 library_tuned_ms=tuned_ms)
            print(f"  {sc.KERNELS[kind]} {shape} {dt}: kernel {ms:.4f} ms "
                  f"(device; {ms_events:.4f} ms back to back under CUDA "
                  f"events), plain {plain_ms:.4f} ms, cuDNN "
                  f"{library_ms:.4f} ms (kernel / cuDNN "
                  f"{ms / library_ms:.3f}; {tuned_ms:.4f} ms with "
                  f"cudnn.benchmark, kernel / it {ms / tuned_ms:.3f}), bound "
                  f"{bound_ms:.4f} ms ({bound_by}), kernel at "
                  f"{100 * bound_ms / ms:.1f}% of the bound  [{card}]")
        del x, dy, xc
        torch.cuda.empty_cache()
    return out


# ---- phase 4: the serving path through HTTP ---------------------------------

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
    attention path and the unfused FFN: what every HTTP response is held
    against."""

    def __init__(self, sds, bert_kw, compute_dtype: str, device):
        dt = getattr(torch, compute_dtype)
        self.device = device
        self.image = ResNet256_6_2_1(dtype=dt)
        self.text = TextBert(BertConfig(**dict(bert_kw, flash_attention=False,
                                               fused_ffn=False)), dtype=dt)
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
                  layers: int, batch: int, count=_launches,
                  kernel: str = "flash") -> dict:
    """The requests of one session, each checked; returns its throughput.
    ``count()`` reads the launches of the kernel that must run once per
    encoder layer per text batch."""
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
        before = count()
        got = _post(srv.base + "/embed_texts", _texts_body(ids[:n], masks[:n]),
                    "application/json")["embeddings"]
        launched = count() - before
        check_response(f"/embed_texts n={n}", got,
                       ref.texts(ids[:n], masks[:n]), tol)
        want = layers * -(-n // batch)
        print(f"  /embed_texts n={n}: {kernel} launches {launched} (want "
              f"{want})")
        if launched != want:
            raise AssertionError(f"{kernel} kernel launched {launched} times "
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


# ---- phase 5: the MI train step at full width -------------------------------

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


@contextlib.contextmanager
def plain_stem():
    """The stem's plain versions (JAX's nine shifted products in PyTorch) in
    place of its forward and dW kernels, on CUDA tensors too."""
    kernels = sc.fwd_kernel, sc.dw_kernel
    sc.fwd_kernel, sc.dw_kernel = sc.fwd_plain, sc.dw_plain
    try:
        yield
    finally:
        sc.fwd_kernel, sc.dw_kernel = kernels


def _step_diff(a, b) -> dict:
    """|Δloss| and, per group, (max |Δ|, share > 1e-6) of two step runs."""
    (l_a, p_a), (l_b, p_b) = a, b
    out = {"loss_diff": abs(l_a - l_b), "loss": (l_a, l_b)}
    for g in p_a:
        d = torch.cat([(p_a[g][n] - p_b[g][n]).abs().reshape(-1)
                       for n in p_a[g]])
        out[g] = (d.max().item(), (d > 1e-6).float().mean().item())
    return out


def _held(out: dict, flip_share: float) -> bool:
    return out["loss_diff"] <= STEP_LOSS_ATOL and all(
        v[0] <= STEP_MAX_ABS and v[1] <= flip_share
        for g, v in out.items() if g not in ("loss_diff", "loss"))


def _diff_line(out: dict) -> str:
    return (f"loss {out['loss'][0]:.9e} vs {out['loss'][1]:.9e} (|diff| "
            f"{out['loss_diff']:.2e}); max |dparam|, share > 1e-6: "
            + ", ".join(f"{g} {v[0]:.2e}, {v[1]:.2e}" for g, v in out.items()
                        if g not in ("loss_diff", "loss")))


def compare_step(device, bert_kw, batch: int, seq: int,
                 knob: str = "flash_attention") -> dict:
    """One float32 step at dropout 0 from one state, with ``knob`` on (the
    flash kernels, with ``fused_ffn`` the fused FFN kernels, with the
    TrainingConfig knob ``pallas_stem`` the shallow-conv kernels) and off
    (the plain attention path, the unfused FFN, the cuDNN stem); returns the
    loss difference and per group (max |Δ|, share > 1e-6).  With
    ``pallas_stem`` a third step runs the stem's plain versions: the kernel
    step is held against it under phase 5's limits, and it against the
    cuDNN step under the stem's (the witness of STEM_FLIP_SHARE)."""
    data = compact_batch(np.random.default_rng(SEED + 2), batch, seq,
                         bert_kw["vocab_size"], device)
    runs = {}
    on_cfg = knob == "pallas_stem"          # the others are BertConfig's
    flip_share = STEM_FLIP_SHARE if on_cfg else STEP_FLIP_SHARE
    arms = (("on", True), ("off", False)) + ((("plain", True),) if on_cfg
                                             else ())
    for arm, flag in arms:
        cfg = TrainingConfig.production(compute_dtype="float32",
                                        **({knob: flag} if on_cfg else {}))
        bc = BertConfig(**{**bert_kw, **({} if on_cfg else {knob: flag}),
                           "hidden_dropout_prob": 0.0,
                           "attention_probs_dropout_prob": 0.0})
        model = mi.build_joint_model(cfg, bc, device=device)
        txs = mi.make_optimizers(cfg, steps_per_epoch=200_000 // batch)
        state = mi.create_mi_state(model, cfg, txs,
                                   torch.Generator().manual_seed(SEED + 3))
        with plain_stem() if arm == "plain" else contextlib.nullcontext():
            state, loss = mi.make_mi_train_step(model, txs, cfg)(state, data)
            runs[arm] = (loss.item(), _snapshot(state))
        del model, state
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    out = _step_diff(runs["on"], runs["off"])
    print(f"  f32 L={seq} step, {knob} on vs off, dropout 0: {_diff_line(out)}"
          f" (tol {STEP_LOSS_ATOL:.0e}; {STEP_MAX_ABS:.1e}, {flip_share:.0e})")
    if not _held(out, flip_share):
        raise AssertionError(f"train steps with {knob} on and off disagree: "
                             f"{out}")
    if on_cfg:
        out["kernel_vs_plain"] = _step_diff(runs["on"], runs["plain"])
        out["plain_vs_off"] = _step_diff(runs["plain"], runs["off"])
        print(f"  the same step with the stem's plain versions: the kernel "
              f"stem against it {_diff_line(out['kernel_vs_plain'])} (tol "
              f"{STEP_LOSS_ATOL:.0e}; {STEP_MAX_ABS:.1e}, "
              f"{STEP_FLIP_SHARE:.0e}); it against the cuDNN stem "
              f"{_diff_line(out['plain_vs_off'])} (tol {flip_share:.0e})")
        if not (_held(out["kernel_vs_plain"], STEP_FLIP_SHARE)
                and _held(out["plain_vs_off"], flip_share)):
            raise AssertionError(f"the stem's plain-version step disagrees: "
                                 f"{out}")
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
    step_cmp = compare_step(device, bert_kw, batch, cmp_seq)
    save = os.path.join(root, "mi_save")
    mi.save_mi_checkpoints(save, state, 1, bc)
    check_reload(save, state, bc)
    launches = dict(fa.LAUNCHES)        # ... and ends here
    print(f"training-path launches: {launches}")
    return {"launches": launches, "ms": ms, "per_s": per_s, "cmp": step_cmp,
            "state": state, "step": train_step, "batches": batches,
            "peak": peak}


# ---- phase 6: where the device time goes ------------------------------------

def profile_call(title: str, call, wall_ms: float, card: str) -> dict:
    """Kernel time by name over one call of ``call`` under torch.profiler,
    and the device idle share against ``wall_ms``; returns the busy ms and
    {kernel: (ms, launches)}."""
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
    return {"busy": busy, "rows": {key: (ms, count) for ms, key, count in rows}}


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


def profile_attention(seq=SEQ) -> None:
    """One attention core of a layer, flash path, forward + backward, B=64,
    bf16, under torch.profiler: the kernels against the layout copies."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    run = _attention_arms(seq, gen)["flash"]
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    profile_call(f"attention core fwd+bwd bf16 L={seq} (B={BATCH}), flash "
                 f"path", run, (time.perf_counter() - t0) * 1e3, card_line())


def profile_train_steps(train: dict) -> None:
    """One train step at the shortest and at the longest bucket."""
    for seq in (min(train["ms"]), max(train["ms"])):
        profile_call(f"MI train step bf16 L={seq} (B={BATCH}), ms/step of "
                     f"phase 5", lambda: train["step"](train["state"],
                                                       train["batches"][seq]),
                     train["ms"][seq], card_line())


# ---- phase 7: GradCache at full width ---------------------------------------

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
            # twice the batch: 1 GiB of z2 bits in one launch, bounded to
            # BITS_BUDGET_BYTES by running the backward over ranges of
            # image rows
            big = 2 * batch
            out["critic_bytes_big"] = critic_memory(
                state.critic_params, big, BERT_BASE["hidden_size"], device)
            print(f"  critic forward + backward at B={big}: "
                  f"{out['critic_bytes_big'] / 2 ** 20:.1f} MiB of device "
                  f"memory, the backward in "
                  f"{-(-big // pc.bwd_chunk_rows(big, big, CRITIC_HIDDEN[1]))}"
                  f" launches of bwd_img, bwd_w and bwd_txt (z2 bits at most "
                  f"{pc.BITS_BUDGET_BYTES / 2 ** 20:.0f} MiB a launch; limit "
                  f"{CRITIC_MEMORY_LIMIT / 2 ** 30:.0f} GiB)  [{card}]")
            if not out["critic_bytes_big"] < CRITIC_MEMORY_LIMIT:
                raise AssertionError(f"critic memory at B={big}: "
                                     f"{out['critic_bytes_big']}")
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


# ---- phase 8: BERT remat ----------------------------------------------------

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
    fused = bool(bert_kw.get("fused_ffn") and bert_kw.get("gelu_tanh"))
    runs, ffn = {}, {}
    fa.reset_launch_counts()            # the remat path's run starts here
    ff.reset_launch_counts()
    for remat in (True, False):
        bc = BertConfig(**dict(bert_kw, remat=remat))
        model = mi.build_joint_model(cfg, bc, device=device)
        txs = mi.make_optimizers(cfg, steps_per_epoch=200_000 // batch)
        state = mi.create_mi_state(model, cfg, txs,
                                   torch.Generator().manual_seed(SEED + 10))
        step = mi.make_mi_train_step(model, txs, cfg)
        before, ffn_before = dict(fa.LAUNCHES), dict(ff.LAUNCHES)
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
        ffn[remat] = [(ff.LAUNCHES[n] - ffn_before.get(n, 0)) / REMAT_STEPS
                      for n in ff.KERNELS.values()]
        print(f"  remat={remat}: {ms:.3f} ms/step (host clock, the step "
              f"after the first), peak memory {mem}, fused FFN launches per "
              f"step (fwd, bwd_a, bwd_b1, bwd_b2) {ffn[remat]}")
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
    n_ffn = layers if fused and cuda else 0     # the forward twice with remat
    if (ffn[True], ffn[False]) != ([2 * n_ffn] + [n_ffn] * 3, [n_ffn] * 4):
        raise AssertionError(f"fused FFN launches per step with and without "
                             f"remat: {ffn}, want {n_ffn} of each and twice "
                             f"the forward with remat")
    if l_r != l_p or (launched, plain) != want or not all(
            out[g][0] <= STEP_MAX_ABS and out[g][1] <= STEP_FLIP_SHARE
            for g in a):
        raise AssertionError(f"remat step differs: losses {l_r} {l_p}, "
                             f"launches {launched} {plain}, {out}")
    out["launches"] = {**fa.LAUNCHES, **ff.LAUNCHES}     # ... and ends here
    return out


# ---- phase 9: the fused_ffn configuration on both paths ---------------------

FFN_SERVE_BERT = dict(BERT_BASE, gelu_tanh=True, fused_ffn=True)
FFN_TRAIN_BERT = dict(TRAIN_BERT, fused_ffn=True)
FFN_BUCKETS = (128, SEQ)


def drive_fused_ffn(root: str, device, serve_kw=FFN_SERVE_BERT,
                    train_kw=FFN_TRAIN_BERT, batch=BATCH, seq=SEQ,
                    buckets=FFN_BUCKETS, off=None) -> dict:
    """``BertConfig(fused_ffn=True, gelu_tanh=True)`` at full width on both
    paths.  Serving: the bfloat16 HTTP session, whose bert_config.json sets
    the two knobs, every response held against a direct forward with the
    flag off (and the plain attention path), the forward kernel once per
    encoder layer per text batch.  Training: the production preset with
    the flag on, one warm-up and TIMED_STEPS timed steps per bucket, each
    of the four kernels once per layer and step; then one float32 step at
    dropout 0 with the flag on against off from one state, under the
    flash-vs-plain step's limits.  ``off``: the flag-off numbers of this
    run's earlier phases, printed beside ({"ms": {seq: ms}, "peak": {seq:
    bytes}, "texts_per_s": x})."""
    cuda = torch.device(device).type == "cuda"
    card = card_line() if cuda else "cpu"
    off = off or {"ms": {}, "peak": {}, "texts_per_s": None}
    layers = serve_kw["num_hidden_layers"]
    names = list(ff.KERNELS.values())
    sub = os.path.join(root, "fused_ffn")
    os.makedirs(sub)
    save, bert_dir, sds = write_checkpoints(sub, serve_kw)
    data = make_requests(batch, seq, serve_kw["vocab_size"])
    ref = Reference(sds, serve_kw, "bfloat16", device)
    ff.reset_launch_counts()            # the flag-on serving path starts here
    print("session compute_dtype=bfloat16, fused_ffn and gelu_tanh set in "
          "bert_config.json")
    srv = Server(compute_dtype="bfloat16", save_directory=save,
                 batch_size=batch, disease="Pneumonia",
                 bert_pretrained_dir=bert_dir, max_seq_length=seq,
                 device=device)
    try:
        count = (lambda: ff.LAUNCHES[names[0]]) if cuda else (lambda: 0)
        per_s = drive_session(srv, ref, "bfloat16", data,
                              layers if cuda else 0, batch, count=count,
                              kernel="fused FFN forward")
    finally:
        srv.close()
    serve_launches = dict(ff.LAUNCHES)  # ... and ends here
    if cuda:    # the device time of one flag-on text batch
        sess = InferenceSession(save, batch_size=batch,
                                bert_config=BertConfig(**serve_kw),
                                compute_dtype="bfloat16", max_seq_length=seq,
                                device=device)
        _, ids, masks = data
        embed = lambda: sess.embed_texts(ids, masks, np.zeros_like(ids))
        walls = []
        for _ in range(6):      # the first call warms up
            t0 = time.perf_counter()
            embed()             # ends in a device-to-host copy
            walls.append(time.perf_counter() - t0)
        profile_call(f"bfloat16 text batch (B={batch}), fused_ffn on, "
                     f"session call median of 5", embed,
                     statistics.median(walls[1:]) * 1e3, card)
        del sess
    was = off["texts_per_s"]
    print(f"  bfloat16, flag on: {per_s['images_per_s']:.1f} images/s, "
          f"{per_s['texts_per_s']:.1f} texts/s (HTTP, batch {batch}, L={seq}, "
          f"median of 5); flag off in this run: "
          + (f"{was:.1f} texts/s" if was else "not measured")
          + f"; launches {serve_launches}  [{card}]")
    del ref, sds
    if cuda:
        torch.cuda.empty_cache()

    cfg = TrainingConfig.production(fused_ffn=True)
    bc = BertConfig(**train_kw)
    model = mi.build_joint_model(cfg, bc, device=device)
    txs = mi.make_optimizers(cfg, steps_per_epoch=200_000 // batch)
    state = mi.create_mi_state(model, cfg, txs,
                               torch.Generator().manual_seed(SEED))
    train_step = mi.make_mi_train_step(model, txs, cfg)
    multi_step = mi.make_mi_multi_step(model, txs, cfg)
    rng = np.random.default_rng(SEED + 13)
    ms, peak, losses = {}, {}, []
    ff.reset_launch_counts()            # the flag-on training path starts here
    for length in buckets:
        batch_data = compact_batch(rng, batch, length, bc.vocab_size, device)
        state, loss = train_step(state, batch_data)          # warm-up
        losses.append(loss[None])
        stacked = {k: torch.stack([v] * TIMED_STEPS)
                   for k, v in batch_data.items()}
        _sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        before = dict(ff.LAUNCHES)
        t0 = time.perf_counter()
        state, step_losses = multi_step(state, stacked)
        _sync(device)
        ms[length] = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
        losses.append(step_losses)
        per_step = [(ff.LAUNCHES[n] - before.get(n, 0)) / TIMED_STEPS
                    for n in names]
        if cuda:
            peak[length] = torch.cuda.max_memory_allocated()
        gib = lambda b: f"{b / 2 ** 30:.2f} GiB" if b else "not measured"
        off_ms = off["ms"].get(length)
        print(f"  L={length}, flag on: {ms[length]:.3f} ms/step "
              f"({batch / ms[length] * 1e3:.1f} pairs/s, host clock, "
              f"{TIMED_STEPS} steps after 1 warm-up), peak memory "
              f"{gib(peak.get(length))}; flag off in this run: "
              + (f"{off_ms:.3f} ms/step" if off_ms else "not measured")
              + f", peak {gib(off['peak'].get(length))}; launches per step "
              f"(fwd, bwd_a, bwd_b1, bwd_b2) {per_step}, losses "
              f"{[round(x, 6) for x in step_losses.tolist()]}  [{card}]")
        if cuda and per_step != [layers] * 4:
            raise AssertionError(f"L={length}: fused FFN launches per step "
                                 f"{per_step}, want {layers} of each")
    flat = torch.cat(losses).float().cpu()
    if not torch.isfinite(flat).all() or len(set(flat.tolist())) != len(flat):
        raise AssertionError(f"flag-on train losses not finite and distinct: "
                             f"{flat.tolist()}")
    timed_launches = collections.Counter(ff.LAUNCHES)  # the steps end here
    if cuda:    # where the flag-on step's device time goes, outside the path
        profile_call(f"MI train step bf16 L={buckets[-1]} (B={batch}), "
                     f"fused_ffn on, ms/step above",
                     lambda: train_step(state, batch_data), ms[buckets[-1]],
                     card)
    del model, state, train_step, multi_step
    if cuda:
        torch.cuda.empty_cache()
    ff.reset_launch_counts()            # the path's step comparison ...
    step_cmp = compare_step(device, train_kw, batch, seq,
                                  knob="fused_ffn")
    train_launches = dict(timed_launches + ff.LAUNCHES)  # ... ends here
    print(f"flag-on launches: serving {serve_launches}, training "
          f"{train_launches}")
    return {"serve_launches": serve_launches, "train_launches":
            train_launches, "ms": ms, "peak": peak, "per_s": per_s,
            "cmp": step_cmp}


# ---- phase 10: the pallas_stem configuration on the training path -----------

STEM_BUCKETS = FFN_BUCKETS
STEM_GC = (256, 4)           # GradCache (batch, chunks) at GC_SEQ
TOWER_TIMED = 10
# the image's gradient of an f32 eval tower call with the kernel stem,
# against cuDNN's stem input gradient (``conv2d_input``) on the same
# cotangent of the stem's output, max |Δ| over max |reference|: 72 f32
# products a pixel in another order
TOWER_DX_TOL = 1e-5


def _stem_counts() -> list:
    return [sc.LAUNCHES[sc.KERNELS[k]] for k in ("fwd", "dw", "dx")]


def tower_step_ms(pallas_stem: bool, batch: int, device) -> tuple:
    """(device ms, events ms) of one bf16 image-tower forward + backward in
    train mode, the H100 counterpart of tools/bench_image_tower.py's step
    without its optimizer: the device's own time (``device_ms``) and CUDA
    events over TOWER_TIMED steps after 3 (the host's gaps included)."""
    net = ResNet256_6_2_1(dtype=torch.bfloat16, pallas_stem=pallas_stem)
    net.load_state_dict(random_state_dict(
        net, torch.Generator().manual_seed(SEED + 16)), strict=True)
    net.to(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 17)
    x = device_normalize(torch.randint(0, 256, (batch, 256, 256, 1),
                                       generator=gen, device=device,
                                       dtype=torch.uint8))
    params = list(net.parameters())

    def step():     # fc1 is off the embedding's path
        torch.autograd.grad(net(x, train=True)[1].float().sum(), params,
                            allow_unused=True)

    return (device_ms(step, iters=TOWER_TIMED),
            time_ms(step, iters=TOWER_TIMED, warmup=3))


def tower_input_grad(device, batch: int) -> dict:
    """One float32 eval-mode tower call with the kernel stem whose image
    requires a gradient: dx launches once, and the image gradient it gives
    is held against cuDNN's stem input gradient on the cotangent that
    reached the stem's output (caught by a hook).  The whole tower's image
    gradient with the cuDNN stem is printed beside it: there the two
    forwards differ in f32 rounding, which can flip a ReLU."""
    from mimm_tpu_torch.models import resnet

    sd = random_state_dict(ResNet256_6_2_1(),
                           torch.Generator().manual_seed(SEED + 18))
    gen = torch.Generator(device=device).manual_seed(SEED + 19)
    x = torch.rand(batch, 256, 256, 1, generator=gen, device=device)
    stem_dy, real = [], resnet.shallow_conv3x3

    def hooked(*args):
        y = real(*args)
        y.register_hook(stem_dy.append)
        return y

    grads = {}
    for stem in (True, False):
        net = ResNet256_6_2_1(pallas_stem=stem)
        net.load_state_dict(sd, strict=True)
        net.to(device)
        xg = x.clone().requires_grad_()
        resnet.shallow_conv3x3 = hooked
        try:
            z = net(xg)[1]
        finally:
            resnet.shallow_conv3x3 = real
        before = _stem_counts()
        grads[stem] = torch.autograd.grad((z * z).sum(), xg)[0]
        _sync(device)
        if stem:
            launched = [a - b for a, b in zip(_stem_counts(), before)]
            weight = net.conv1.weight.detach()
    (dy,) = stem_dy
    want = torch.nn.grad.conv2d_input(
        (batch, 1, 256, 256), weight, dy, padding=1).reshape(x.shape)
    err = _scaled_err(grads[True], want)
    diff = grads[True] - grads[False]
    tower = {"max": _scaled_err(grads[True], grads[False]),
             "rel_l2": (diff.norm() / grads[False].norm()).item()}
    cuda = torch.device(device).type == "cuda"
    print(f"  tower input gradient, f32 eval, B={batch}: kernel stem's dx "
          f"against cuDNN's conv2d_input on the same cotangent, scaled max "
          f"err {err:.2e} (tol {TOWER_DX_TOL:.0e}); stem backward launches "
          f"(fwd, dw, dx) {launched}; whole tower, kernel stem against cuDNN "
          f"stem: scaled max err {tower['max']:.2e}, relative L2 "
          f"{tower['rel_l2']:.2e}  [{card_line() if cuda else 'cpu'}]")
    if not err <= TOWER_DX_TOL or (cuda and launched != [0, 1, 1]):
        raise AssertionError(f"tower input gradient: err {err}, launches "
                             f"{launched} (want 0 fwd, 1 dw, 1 dx)")
    return {"err": err, "tower": tower}


STEM_TURNS = ("off", "on", "on", "off")


def stem_in_turns(device, bc, batch: int, seq: int, rng, card: str) -> dict:
    """The production step at ``seq`` with the stem on and off in one
    phase: a state for each, one warm-up step each, then TIMED_STEPS steps
    of one arm after the other in STEM_TURNS on the same batch (host
    clock); on the card, one step of each under torch.profiler, and the
    kernels whose launches or device time differ between the two."""
    cuda = torch.device(device).type == "cuda"
    data = compact_batch(rng, batch, seq, bc.vocab_size, device)
    stacked = {k: torch.stack([v] * TIMED_STEPS) for k, v in data.items()}
    arms = {}
    for arm in ("on", "off"):
        cfg = TrainingConfig.production(pallas_stem=arm == "on")
        model = mi.build_joint_model(cfg, bc, device=device)
        txs = mi.make_optimizers(cfg, steps_per_epoch=200_000 // batch)
        state = mi.create_mi_state(model, cfg, txs,
                                   torch.Generator().manual_seed(SEED))
        step = mi.make_mi_train_step(model, txs, cfg)
        state, _ = step(state, data)                        # warm-up
        arms[arm] = [state, step, mi.make_mi_multi_step(model, txs, cfg)]
    ms = {"on": [], "off": []}
    for arm in STEM_TURNS:
        state, _, multi = arms[arm]
        _sync(device)
        t0 = time.perf_counter()
        arms[arm][0], _ = multi(state, stacked)
        _sync(device)
        ms[arm].append((time.perf_counter() - t0) / TIMED_STEPS * 1e3)
    print(f"  L={seq}, stem on and off in turns {STEM_TURNS}, ms/step over "
          f"{TIMED_STEPS} steps each (host clock): on "
          f"{[round(t, 3) for t in ms['on']]}, off "
          f"{[round(t, 3) for t in ms['off']]}  [{card}]")
    busy = {}
    if cuda:
        prof = {}
        for arm in ("on", "off"):
            state, step, _ = arms[arm]
            prof[arm] = profile_call(
                f"MI train step bf16 L={seq} (B={batch}), stem {arm}, the "
                f"median ms/step of the turns above",
                lambda: step(state, data), statistics.median(ms[arm]), card)
            busy[arm] = prof[arm]["busy"]
        on, off = prof["on"]["rows"], prof["off"]["rows"]
        diff = sorted(((on.get(k, (0, 0))[0] - off.get(k, (0, 0))[0],
                        on.get(k, (0, 0))[1] - off.get(k, (0, 0))[1], k)
                       for k in set(on) | set(off)),
                      key=lambda r: -abs(r[0]))
        total = {arm: sum(c for _, c in prof[arm]["rows"].values())
                 for arm in prof}
        print(f"    kernels launched in one step: on {total['on']}, off "
              f"{total['off']}; the kernels that differ most, stem on minus "
              f"off (device ms, launches):")
        for d_ms, d_n, key in [r for r in diff if r[0] or r[1]][:8]:
            print(f"    {d_ms:+9.3f} ms {d_n:+5d}  {key[:90]}")
    return {"ms": ms, "busy": busy}


def drive_pallas_stem(device, bert_kw=TRAIN_BERT, batch=BATCH,
                      buckets=STEM_BUCKETS, gc=STEM_GC, gc_seq=GC_SEQ,
                      cmp_seq=SEQ, tower_batch=BATCH, off=None) -> dict:
    """``TrainingConfig.production(pallas_stem=True)`` at full width: one
    warm-up and TIMED_STEPS timed steps per bucket (one forward and one dW
    launch a step, no dx: the image is data), beside the flag-off steps of
    phase 5 (``off``: {"ms": {seq: ms}, "peak": {seq: bytes}}); the last
    bucket's step with the stem on and off in turns (``stem_in_turns``);
    one f32 step at dropout 0, stem on against off from one state, under
    phase 5's limits, with the plain-version witness; GradCache with the stem on (2 forward launches a chunk, one
    dW); the image tower alone, kernel stem against cuDNN stem, in device
    ms; and one tower call with an image that requires a gradient, the one
    place dx runs.  Returns the launches of the training path and of the
    input-gradient call, and the times."""
    cuda = torch.device(device).type == "cuda"
    card = card_line() if cuda else "cpu"
    off = off or {"ms": {}, "peak": {}}
    names = [sc.KERNELS[k] for k in ("fwd", "dw", "dx")]
    cfg = TrainingConfig.production(pallas_stem=True)
    bc = BertConfig(**bert_kw)
    model = mi.build_joint_model(cfg, bc, device=device)
    txs = mi.make_optimizers(cfg, steps_per_epoch=200_000 // batch)
    state = mi.create_mi_state(model, cfg, txs,
                               torch.Generator().manual_seed(SEED))
    train_step = mi.make_mi_train_step(model, txs, cfg)
    multi_step = mi.make_mi_multi_step(model, txs, cfg)
    rng = np.random.default_rng(SEED + 20)
    ms, peak, losses = {}, {}, []
    sc.reset_launch_counts()            # the stem's training path starts here
    for length in buckets:
        data = compact_batch(rng, batch, length, bc.vocab_size, device)
        state, loss = train_step(state, data)               # warm-up
        losses.append(loss[None])
        stacked = {k: torch.stack([v] * TIMED_STEPS) for k, v in data.items()}
        _sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        before = _stem_counts()
        t0 = time.perf_counter()
        state, step_losses = multi_step(state, stacked)
        _sync(device)
        ms[length] = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
        losses.append(step_losses)
        per_step = [(a - b) / TIMED_STEPS
                    for a, b in zip(_stem_counts(), before)]
        if cuda:
            peak[length] = torch.cuda.max_memory_allocated()
        gib = lambda b: f"{b / 2 ** 30:.2f} GiB" if b else "not measured"
        off_ms = off["ms"].get(length)
        print(f"  L={length}, stem on: {ms[length]:.3f} ms/step "
              f"({batch / ms[length] * 1e3:.1f} pairs/s, host clock, "
              f"{TIMED_STEPS} steps after 1 warm-up), peak memory "
              f"{gib(peak.get(length))}; stem off in this run: "
              + (f"{off_ms:.3f} ms/step" if off_ms else "not measured")
              + f", peak {gib(off['peak'].get(length))}; launches per step "
              f"(fwd, dw, dx) {per_step}, losses "
              f"{[round(x, 6) for x in step_losses.tolist()]}  [{card}]")
        if cuda and per_step != [1, 1, 0]:
            raise AssertionError(f"L={length}: stem launches per step "
                                 f"{per_step}, want 1 fwd, 1 dw, no dx")
    flat = torch.cat(losses).float().cpu()
    if not torch.isfinite(flat).all() or len(set(flat.tolist())) != len(flat):
        raise AssertionError(f"stem-on train losses not finite and distinct: "
                             f"{flat.tolist()}")
    del model, state, train_step, multi_step
    if cuda:
        torch.cuda.empty_cache()
    turns = stem_in_turns(device, bc, batch, buckets[-1], rng, card)
    step_cmp = compare_step(device, bert_kw, batch, cmp_seq,
                            knob="pallas_stem")

    gc_batch, chunks = gc
    gcfg = TrainingConfig.production(pallas_stem=True, batch_size=gc_batch,
                                     grad_cache_chunks=chunks)
    model = mi.build_joint_model(gcfg, bc, device=device)
    txs = mi.make_optimizers(gcfg, steps_per_epoch=200_000 // gc_batch)
    state = mi.create_mi_state(model, gcfg, txs,
                               torch.Generator().manual_seed(SEED))
    data = compact_batch(rng, gc_batch, gc_seq, bc.vocab_size, device)
    step = mi.make_mi_train_step(model, txs, gcfg)
    state, loss = step(state, data)                         # warm-up
    _sync(device)
    before = _stem_counts()
    t0 = time.perf_counter()
    gc_losses = [step(state, data)[1] for _ in range(GC_TIMED)]
    _sync(device)
    gc_ms = (time.perf_counter() - t0) / GC_TIMED * 1e3
    gc_per_step = [(a - b) / GC_TIMED for a, b in zip(_stem_counts(), before)]
    print(f"  GradCache B={gc_batch} in {chunks} chunks, L={gc_seq}, stem on: "
          f"{gc_ms:.3f} ms/step (host clock, {GC_TIMED} steps after 1), "
          f"launches per step (fwd, dw, dx) {gc_per_step}, losses "
          f"{[round(x.item(), 6) for x in gc_losses]}  [{card}]")
    if cuda and gc_per_step != [2 * chunks, chunks, 0]:
        raise AssertionError(f"GradCache stem launches per step {gc_per_step},"
                             f" want {2 * chunks} fwd, {chunks} dw, no dx")
    train_launches = dict(sc.LAUNCHES)  # ... and ends here
    del model, state, step, data
    if cuda:
        torch.cuda.empty_cache()

    tower = {}
    if cuda:
        for stem in (True, False, False, True):     # in turns
            tower.setdefault(stem, []).append(
                tower_step_ms(stem, tower_batch, device))
        print(f"  image tower alone, bf16, B={tower_batch}, forward + backward"
              f" in train mode, (device ms, CUDA-event ms) a step over "
              f"{TOWER_TIMED} steps, in turns: kernel stem {tower[True]}, "
              f"cuDNN stem {tower[False]}  [{card}]")
    sc.reset_launch_counts()            # the input-gradient call starts here
    dx_check = tower_input_grad(device, tower_batch)
    dx_launches = dict(sc.LAUNCHES)     # ... and ends here
    return {"train_launches": train_launches, "dx_launches": dx_launches,
            "ms": ms, "peak": peak, "turns": turns, "cmp": step_cmp,
            "gc_ms": gc_ms,
            "tower_ms": tower, "dx": dx_check}


# ---- phase 11: the Manager's epoch loop -------------------------------------

MANAGER_PAIRS = 1024
MANAGER_WORKERS = 4


class InMemoryPairs:
    """The paired-dataset interface (data/pipeline.py) over in-memory
    compact samples: uint8 256² crops, uint16 ids, uint8 masks and
    segments, report lengths drawn over PRODUCTION_SEQ_BUCKETS by
    BUCKET_MIX (uniform within a bucket), distinct study ids."""

    def __init__(self, n: int, seq: int, vocab: int, seed: int):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, 256, 256, 1), dtype=np.uint8)
        bounds = (0, *PRODUCTION_SEQ_BUCKETS)
        share = np.array([BUCKET_MIX[b] for b in PRODUCTION_SEQ_BUCKETS])
        bucket = rng.choice(len(share), size=n, p=share / share.sum())
        self.lengths = np.array([rng.integers(bounds[b] + 1, bounds[b + 1] + 1)
                                 for b in bucket])
        self.ids = rng.integers(1000, vocab, (n, seq)).astype(np.uint16)
        self.seq = seq

    def __len__(self):
        return len(self.images)

    def token_length(self, idx: int) -> int:
        return int(self.lengths[idx])

    def load(self, idx, rng, train=True):
        mask = (np.arange(self.seq) < self.lengths[idx]).astype(np.uint8)
        return {"image": self.images[idx], "txt_ids": self.ids[idx] * mask,
                "txt_masks": mask,
                "txt_segments": np.zeros(self.seq, np.uint8),
                "study_id": np.int64(idx)}


def drive_manager(root: str, device, bert_kw=TRAIN_BERT, pairs=MANAGER_PAIRS,
                  batch=BATCH, workers=MANAGER_WORKERS) -> dict:
    """``MultiModalManager(TrainingConfig.production(pallas_stem=True,
    ...)).train(None, dataset=...)`` over InMemoryPairs: one epoch, B=64,
    ``scan_steps`` 8, ``prefetch`` 2, ``workers`` loader threads.  Then the
    same run again under torch.profiler for the device's busy time.
    Returns the launches of the first run and its numbers."""
    from mimm_tpu_torch.data.pipeline import Loader

    cuda = torch.device(device).type == "cuda"
    card = card_line() if cuda else "cpu"
    data = InMemoryPairs(pairs, SEQ, bert_kw["vocab_size"], SEED + 21)
    bc = BertConfig(**bert_kw)
    want_steps = Loader(data, batch, bucket_lengths=PRODUCTION_SEQ_BUCKETS) \
        .batches_per_epoch()

    def run(name):
        save = os.path.join(root, name)
        cfg = TrainingConfig.production(
            pallas_stem=True, batch_size=batch, num_train_epochs=1,
            data_loader_workers=workers, prefetch=2, save_directory=save)
        mgr = mi.MultiModalManager(cfg, bert_config=bc,
                                   load_pretrained_bert=False, device=device)
        state = mgr.train(None, dataset=data)
        _sync(device)
        with open(os.path.join(save, "mi.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        return save, state, [r for r in recs if "epoch_loss" in r]

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sc.reset_launch_counts()            # the Manager's run starts here
    save, state, recs = run("manager")
    launches = dict(sc.LAUNCHES)        # ... and ends here
    steps, (rec,) = state.step, recs
    seconds, loss = rec["epoch_seconds"], rec["epoch_loss"]
    peak = torch.cuda.max_memory_allocated() if cuda else None
    counts = [launches.get(sc.KERNELS[k], 0) for k in ("fwd", "dw", "dx")]
    print(f"  Manager epoch, {pairs} pairs, B={batch}, scan_steps 8, prefetch "
          f"2, {workers} loader threads: {steps} steps (batches_per_epoch "
          f"{want_steps}), {seconds:.3f} s ({steps * batch / seconds:.1f} "
          f"pairs/s, host clock, from mi.jsonl), peak memory "
          + (f"{peak / 2 ** 30:.2f} GiB" if cuda else "not measured")
          + f", stem launches (fwd, dw, dx) {counts}, epoch loss {loss:.6f}"
          f"  [{card}]")
    if steps != want_steps or not math.isfinite(loss) or (
            cuda and counts != [steps, steps, 0]):
        raise AssertionError(f"Manager epoch: {steps} steps (want "
                             f"{want_steps}), loss {loss}, launches {counts}")
    check_reload(save, state, bc)
    t0 = time.perf_counter()
    mi.save_mi_checkpoints(os.path.join(root, "save_again"), state, 1, bc)
    save_s = time.perf_counter() - t0
    print(f"  save_mi_checkpoints alone, the same state: {save_s:.3f} s of "
          f"the epoch's {seconds:.3f} s (host clock)  [{card}]")
    del state
    if cuda:
        torch.cuda.empty_cache()
        profile_call(f"Manager epoch ({steps} steps of B={batch}, the whole "
                     f"train() call profiled), epoch seconds of the run above",
                     lambda: run("manager_profiled"), seconds * 1e3, card)
    return {"launches": launches, "steps": steps, "seconds": seconds,
            "pairs_per_s": steps * batch / seconds, "peak": peak,
            "loss": loss, "save_seconds": save_s}


# ---- main -------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    started = time.perf_counter()

    print("== phase 1: versions and build")
    tensor_ops = sass_counts(versions_and_build())
    print("== phase 2: kernels against their plain versions")
    checked = check_kernels("cuda")
    critic_worst = check_critic("cuda")
    for name, err in check_critic_normal("cuda").items():
        critic_worst[name] = max(critic_worst[name], err)
    ffn_worst = check_ffn("cuda")
    t0 = time.perf_counter()
    stem_worst = check_stem("cuda")
    print(f"  check_stem: {time.perf_counter() - t0:.1f} s")
    print(f"== phase 3: timing at (64, 12, 320, 64), at 2048 x 2048 pairs, "
          f"at (T, d, f) = {FFN_SHAPE} and at (B, H, W) = {STEM_SHAPES[0]}")
    times = time_kernels()
    time_buckets()
    critic_times = time_critic()
    ffn_times = time_ffn()
    t0 = time.perf_counter()
    stem_times = time_stem()
    print(f"  time_stem: {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        print("== phase 4: the serving path over HTTP (full width)")
        serve = drive_serving(root, "cuda")
        print("== phase 5: the MI train step (full width, B=64)")
        train = drive_training(root, "cuda")
        print("== phase 6: where the device time goes")
        profile_batches(serve["save"], serve["config"], serve["data"])
        profile_train_steps(train)
        profile_attention()
    del train["state"], train["batches"]
    torch.cuda.empty_cache()
    print(f"== phase 7: GradCache (full width, production preset, L={GC_SEQ})")
    grad_cache = drive_grad_cache("cuda", direct_peak=train["peak"][GC_SEQ])
    print(f"== phase 8: BERT remat (full width, B={BATCH}, L={SEQ})")
    remat = drive_remat("cuda")
    print(f"== phase 9: fused_ffn on both paths (full width, B={BATCH})")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        fused = drive_fused_ffn(root, "cuda", off={
            "ms": train["ms"], "peak": train["peak"],
            "texts_per_s": serve["per_s"]["bfloat16"]["texts_per_s"]})
    fused_remat = drive_remat("cuda", bert_kw=FFN_TRAIN_BERT)
    print(f"== phase 10: pallas_stem on the training path (full width, "
          f"B={BATCH})")
    stem = drive_pallas_stem("cuda", off={"ms": train["ms"],
                                          "peak": train["peak"]})
    print(f"== phase 11: MultiModalManager, one epoch of {MANAGER_PAIRS} "
          f"in-memory pairs (full width, B={BATCH})")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        manager = drive_manager(root, "cuda")

    # each path's launches, counted from 0 just before it and read just
    # after; serving runs the flash forward, training and remat the flash
    # backward too, GradCache the critic kernels, the fused_ffn paths the
    # fused FFN forward (serving) and all four of its kernels (training,
    # remat), the pallas_stem training path and the Manager the stem's
    # forward and dW, the tower's input gradient its dx
    flash_all = [*fa.KERNELS.values(), *fa.BWD_KERNELS.values()]
    flash_bf16 = [fa.KERNELS[torch.bfloat16], fa.BWD_KERNELS[torch.bfloat16]]
    paths = {"serving": (serve["launches"], fa.KERNELS.values()),
             "training": (train["launches"], flash_all),
             "grad_cache": (grad_cache["launches"], pc.KERNELS.values()),
             "remat": (remat["launches"], flash_bf16),
             "serving_fused_ffn": (fused["serve_launches"],
                                   [ff.KERNELS["fwd"]]),
             "training_fused_ffn": (fused["train_launches"],
                                    ff.KERNELS.values()),
             "remat_fused_ffn": (fused_remat["launches"],
                                 [*flash_bf16, *ff.KERNELS.values()]),
             "training_pallas_stem": (stem["train_launches"],
                                      [sc.KERNELS["fwd"], sc.KERNELS["dw"]]),
             "tower_input_grad": (stem["dx_launches"], [sc.KERNELS["dx"]]),
             "manager": (manager["launches"],
                         [sc.KERNELS["fwd"], sc.KERNELS["dw"]])}
    for path, (counts, names) in paths.items():
        for name in names:
            if counts.get(name, 0) == 0:
                raise AssertionError(f"{name} was not launched on the {path} "
                                     f"path")
    launches = lambda name: sum(c.get(name, 0) for c, _ in paths.values())
    sass = lambda name: ({f"sass_{op.lower()}": n for op, n in
                          tensor_ops[name].items()}
                         if name in tensor_ops else {})
    kernels = []
    for kind, names in (("fwd", fa.KERNELS), ("bwd", fa.BWD_KERNELS)):
        for dt in DTYPES:
            name = names[dt]
            kernels.append({
                "name": name, "route": "cuda", "source": FLASH[kind][0],
                "replaces": FLASH[kind][1], "launches": launches(name),
                "max_abs_err": checked["worst"][kind, dt],
                **times[kind, dt][RATES[-1]],
                "ms_rate0": times[kind, dt][0.0]["ms"], **sass(name)})
    for kind, name in pc.KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": CRITIC_SRC[kind][0],
            "replaces": CRITIC_SRC[kind][1], "launches": launches(name),
            "max_abs_err": critic_worst[name], **critic_times[kind],
            **sass(name)})
    kernels[-len(pc.KERNELS)]["factorized_ms"] = critic_times["yardstick"]
    # the fused FFN kernels: the bfloat16 numbers first (the production
    # preset's dtype), the float32 ones under "f32"
    for kind, name in ff.KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": FFN_SRC[kind][0],
            "replaces": FFN_SRC[kind][1], "launches": launches(name),
            "max_abs_err": ffn_worst[name, torch.bfloat16],
            **ffn_times[kind, torch.bfloat16],
            **sass(f"{name}_bf16"),
            "f32": {"max_abs_err": ffn_worst[name, torch.float32],
                    **ffn_times[kind, torch.float32]}})
    # the shallow-conv kernels likewise: bfloat16 first, float32 under "f32"
    for kind, name in sc.KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": STEM_SRC[kind][0],
            "replaces": STEM_SRC[kind][1], "launches": launches(name),
            "max_abs_err": stem_worst[name, torch.bfloat16],
            **stem_times[kind, torch.bfloat16],
            "f32": {"max_abs_err": stem_worst[name, torch.float32],
                    **stem_times[kind, torch.float32]}})
    print(f"chip_smoke: all phases in {time.perf_counter() - started:.1f} s "
          f"(the time limit is 1200 s)")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
