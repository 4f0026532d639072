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
   the flash backward (dQ, dK, dV) at rate 0 and 0.1, a tensor-parallel
   rank's heads (6 of 12 at offset 6, rate 0.1: the keep mask, the
   outputs and gradients the head slice of the whole call's bit for bit),
   the realized keep rate of the Philox mask, and the CUDA Philox against
   Random123's known-answer vectors; the pairwise-critic kernels (S and the seven
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
   a step), one warm-up and one timed step each, ms/step, pairs/s, peak
   memory against the B=64 L=128 step's, the critic's own memory, and
   the B=256 step under torch.profiler (device busy, idle share);
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
11. ``MultiModalManager.train`` over 256 in-memory compact pairs whose
   report lengths follow the bucket mix: one epoch, B=64, ``scan_steps``
   8, ``prefetch`` 2, 4 loader threads, ``pallas_stem``: steps against
   ``batches_per_epoch()``, epoch seconds and pairs/s from mi.jsonl, peak
   memory, one forward and one dW launch a step, a finite epoch loss, a
   strict reload of the written ``.bin`` files, and the device's busy time
   over the same run again under torch.profiler;
12. MI pretraining from disk through its entry point,
   ``mimm_tpu_torch.cli.multi_modal.train_mutual_information``, at full
   width (production preset with ``pallas_stem``, B=64, 2 epochs,
   ``keep_checkpoints`` 1, 4 loader threads) over a corpus written here
   from numpy: 512 pairs whose report lengths follow the bucket mix and
   64 more in each of the 256 and 320 buckets, reports of words of a
   BERT-base-sized vocabulary (tokenized by the port's native WordPiece
   tokenizer on 4 threads and ``load_and_cache_examples``), and one
   crop-cache entry per image with a
   full-resolution CXR's geometry (no image file: every read must be a
   hit).  Run A trains uninterrupted; run B gets a real SIGTERM after step
   5 of epoch 1 and checkpoints; run C resumes it (``resume_from`` "auto")
   and must end at A's step count on A's bits in every tensor (cuDNN
   deterministic; BERT's embedding lookups sum their gradients in a fixed
   order, and two backward calls of the lookup at the token-type shape
   must give the same bits without the deterministic flag).  The epoch's
   split between the loader threads' reads (ms a read, every read through
   the host library), the pinned copies, the steps
   and the saves, the pairs/s of A's epochs, the hits, the pruned
   checkpoints and a strict reload of the ``.bin`` files;
13. the autoencoder baseline through its entry point,
   ``mimm_tpu_torch.cli.uni_modal.main``, at full width (ResNetAE 256²,
   6 levels, 2 residual blocks, z_dim 192, bottleneck 768; production
   preset, B=64, 2 epochs, ``keep_checkpoints`` 1, 4 loader threads) over
   512 crop-cache windows written here (every read a hit): runs A, B
   (SIGTERM after step 5) and C (resumed), C on A's bits in every
   tensor; no port kernel launched on the path (JAX's AE reaches no
   Pallas kernel); the ``.bin`` files reloaded strict with A's eval
   embedding; images/s per epoch, the split of A's epochs, seconds a
   save; the B=64 step's ms, peak and one profiled step; B=256 in 4
   chunks within 1.5 x its peak; one f32 B=8 step against float64 under
   phase 5's |Δloss| and largest |Δ|, and within 1.5 x the shares of
   elements moved and flipped that JAX's own f32 step shows;
14. the per-disease classifiers, validation and Grad-CAM through their
   entry points on phase 12's MI image encoder and phase 13's autoencoder
   (phases 12-14 share one directory), over 1024 studies of 64 windows
   of their own whose labels follow the windows' brightness:
   ``mimm_tpu_torch.cli.train.main`` ``--stage classifier_mm`` and
   ``classifier_um`` (frozen f32 encoders at 256², the 8-layer MLP, B=64,
   4 epochs, 4 loader threads, every read a hit); for Cardiomegaly on the
   MI encoder run B (``cli.multi_modal.train_image_classifier``, a
   SIGTERM after step 5) and run C (``resume_from`` "auto"), C on the
   sweep's bits in every MLP and optimizer tensor with its best accuracy
   and checkpoint; ``mimm_tpu_torch.cli.validate.main --extended`` for
   both modalities, each report's accuracy and tallies equal to a direct
   recomputation here and its AUC and GDV within REPORT_AUC_TOL /
   REPORT_GDV_RTOL of it, AUC at least CLF_MIN_AUC, the MI classifier
   calling both classes, MM against UM on one line; no port kernel on the
   sweep, runs B-C or the validations, each counted from 0; the split of
   each sweep (loader thread-seconds and ms a read, embedding calls, MLP
   steps, saves), ten of the MM sweep's embedding calls under
   torch.profiler (wall, the main thread's time inside operators, device
   time, the gaps over 1 ms between its operators), the frozen-encoder
   pass alone in images/s, seconds a validation;
   Grad-CAM on 8 images (shape (8, 8, 8), values in [0, 1], f32 against
   float64 within ``cam_limits``); one embedding pass with
   ``pallas_stem``: one stem forward launch a batch, within STEM_EMB_TOL
   of the cuDNN stem's embedding;
15. the port's host library and profiling: a build of
   ``csrc/host/mimm_host.cpp`` from scratch with g++ on this host; 256
   train draws (raw and normalized) and the eval crops of a 12-bit uint16
   2544 x 3056 source's crop-cache window through the library, each equal
   bit for bit to the numpy path on this host's CPU; ms a read (crop-cache
   read + transform) both ways at 1 and 4 threads; phase 12's corpus
   tokenized by the native encoder (serial and on 4 threads) and by the
   Python one, the same features, with each time; one epoch of MI
   pretraining from disk through ``train_mutual_information`` (production
   preset, ``pallas_stem``, B=64) over 192 pairs in each of the 256 and
   320 buckets with ``profile_steps`` 3 and ``tensorboard``: the trace
   under ``profile/`` holds the bf16 flash forward and backward kernels
   and the stem's forward and dW, each as many times as the launch
   counters count over the traced dispatches, and the event files under
   ``tb/mi/`` decode (every CRC checked) to mi.jsonl's scalars;
16. data parallelism (``mimm_tpu_torch/parallel/mesh.py``): worlds of 2
   ranks on the one card, both on ``cuda:0``, each a process of this
   script (``--world-worker``) started with the MIMM_* variables of
   ``initialize_distributed`` (a ``localhost:<port>`` coordinator).  NCCL,
   the default backend for CUDA tensors, if it takes two ranks on one
   device; else the world of 2 runs on gloo over CUDA tensors, chosen
   explicitly, and a world of 1 runs on NCCL through the entry point too;
   the backend of each world is printed.  (a) the f32 L=320 step at
   dropout 0 of the production preset with ``pallas_stem``, world 2 x 32
   rows against world 1 x 64 from the same weights: the gradients each
   optimizer receives (cosine, norm ratio), the running statistics, the
   losses of two Adam steps and the weights after the first (WORLD_*
   below says what is held and why); (b) MI pretraining from disk
   through ``mimm_tpu_torch.cli.multi_modal`` (bf16, ``pallas_stem``,
   B=64, 2 epochs over a crop-cache corpus of 448 pairs written as phase
   12's, the sharded checkpoint format): run A uninterrupted, in the
   world of (a), (d) and (e) (the bf16 flash kernels and the stem's on each
   rank), run B with a SIGTERM to
   rank 1 alone (both ranks stop at the same step), run C resumed on A's
   bits in every tensor; world-2 pairs/s against a world of 1 through
   the same entry point (one epoch); seconds a sharded save and an async save's
   return; (c) the
   converter's ``.bin`` files from A's sharded checkpoint load strict and
   equal rank 0's parameters; (d) the B=2048 GradCache step (32 chunks of
   64, L=128; 16 chunks and the critic kernels on each rank) within
   CRITIC_TOL of phase 7's world-1 loss from the same state; (e) the f32
   AE step with sync-BN (as (a)) and the classifier's embedding pass,
   world 2 against world 1;
17. tensor and sequence parallelism, ZeRO-1 and FSDP
   (``parallel/mesh.py``; ``drive_tp``): worlds of 2 ranks on the one
   card as in phase 16, on phase 16's backend.  (a) ``{'model': 2}``: the
   f32 L=320 step of phase 16 (a) with BERT and the critic
   tensor-parallel, two Adam steps against one rank (embeddings,
   gradients by max |Δg| / max |g|, cosine and norm ratio, losses, the
   weights' shares after step 1; TP_* below), the
   flash kernels once per layer per rank per step, and at dropout 0.1
   each rank's first flash context (its 6 heads, keyed on their place
   among all 12) against one rank's heads; (b) TP with sequence
   parallelism against (a); one encoder layer with the fused FFN under
   TP (f = 1536 a rank) against unsharded; (c) ``{'data': 2}`` ZeRO-1 and
   ZeRO-1 + FSDP against the replicated world, bit for bit, with each
   rank's resident bytes; (d) the AE likewise; (e) ``cli.multi_modal
   --mesh_shape model=2 --sequence_parallel true`` from disk (f32, 2
   epochs of one step): its checkpoint against the world's gathered
   state, one rank resuming epoch 2 from it;
18. GPipe pipeline parallelism of the text tower (``parallel/
   pipeline.py``; ``drive_pp``): a world of 2 ranks on ``{'pipe': 2}`` on
   the one card, on phase 16's backend.  (a) the f32 L=320 step of phase
   17 (a) at M = 4 microbatches (6 layers a stage), two Adam steps against
   one rank: the image embeddings bit for bit, the text embeddings,
   gradients by max |Δg| / max |g|, cosine and norm ratio, losses and the
   weights' shares after step 1 (phase 17 (a)'s limits), the f32 flash
   forward and backward 6 × 4 times a rank a step; (b) the bf16
   production step at dropout 0.1 with remat, twice from one state: the
   same bits, a finite loss, the flash forward 2 × 6 × 4 and the backward
   6 × 4 times a rank; (c) each rank's resident text parameters and
   moments against the stage rule and one rank's, its peak memory
   (printed); (d) ``cli.multi_modal --mesh_shape pipe=2
   --pipeline_microbatches 2`` from disk (f32, 2 epochs of one step): its
   checkpoint against the world's gathered state in the plain layout, the
   converter's ``.bin`` files loaded strict, one rank resuming epoch 2
   from it;
19. the serving export (``tools/export_serving.py``; ``drive_export``):
   phase 4's checkpoints (the 12-layer BERT-base with the flash gate open,
   B=64, L=320, the Pneumonia classifier) exported to ``embed_images``,
   ``embed_texts`` and ``classify`` artifacts on the card, and
   ``embed_texts`` again with the fused FFN (phase 9's serving config);
   a child process that imports only the manifest's ``requires`` (the
   custom operators' modules, never ``mimm_tpu_torch.models``) loads and
   runs them: each artifact within 1e-5 (max |Δ| / max(1, max |ref|)) of
   the live float32 ``InferenceSession`` over phase 4's requests, the f32
   flash forward 12 times and the f32 fused FFN forward 12 times a 64-row
   text batch; the export and reload seconds, the artifacts' bytes and
   the ms of a batch through the artifact beside the session's;
20. the CLI and ETL rest on the card's host (``drive_etl``):
   ``cli.dataset_populate`` (download without fetching, merge, populate,
   stats) over a seeded MIMIC-like tree, read back through
   ``read_disease_stats`` and the datasets; ``tools.derive_buckets``,
   ``tools.corpus_check`` (0 broken) and ``cli.prebuild_cache`` (every
   entry valid) over phase 12's corpus; ``tools.mem_report`` equal to the
   byte to the resident bytes phases 17 (c), 17 (d) and 18 (c) counted;
21. the ``kernels`` JSON line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Every phase prints its host-clock seconds with the card's name and power
limit as it ends.  Any failure raises and exits non-zero; without a card
it exits before printing any result.  Development runs that print no
result lines: ``python3 chip_smoke.py --phase17`` (``--phase18``,
``--phase19``) runs phases 1, 2 and 17 (18, 19) and phase 3's flash times
alone; ``--phase20`` runs those and phases 17, 18 and 20.
"""

from __future__ import annotations

import atexit
import collections
import concurrent.futures
import contextlib
import copy
import io
import json
import math
import os
import shutil
import signal
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
from mimm_tpu_torch import profiling  # noqa: E402
from mimm_tpu_torch.cli.serve import build_server  # noqa: E402
from mimm_tpu_torch.config import (DEFAULT_CLASSIFIER_LAYERS,  # noqa: E402
                                   PRODUCTION_SEQ_BUCKETS, TrainingConfig,
                                   construct_training_parameters)
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
from mimm_tpu_torch.ops.embedding import embedding_lookup  # noqa: E402
from mimm_tpu_torch.ops.image_norm import (decompact_batch,  # noqa: E402
                                            device_normalize)
from mimm_tpu_torch.ops.philox import attention_keep_mask  # noqa: E402
from mimm_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
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
    sources = sorted({lib for lib, _, _ in SASS_FUNCTIONS.values()})
    # one cuobjdump a library, all started together
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        dumps = pool.map(lambda src: subprocess.run(
            [tool, "-sass", libs[src]], capture_output=True, text=True,
            check=True).stdout, sources)
    for src, sass in zip(sources, dumps):
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
    check_head_offset(device, gen)
    B, H, L, _ = shapes[0]
    keep = attention_keep_mask(_seed(7, device), B, H, L, RATES[-1])
    keep_rate = keep.float().mean().item()
    sigma = (RATES[-1] * (1 - RATES[-1]) / keep.numel()) ** 0.5
    print(f"  keep rate of the mask at rate {RATES[-1]} over {keep.numel()} "
          f"draws: {keep_rate:.6f} (1 - rate within 5 sigma = {5 * sigma:.1e})")
    if not abs(keep_rate - (1 - RATES[-1])) <= 5 * sigma:
        raise AssertionError(f"keep rate {keep_rate}")
    return {"worst": worst, "keep_rate": keep_rate}


def check_head_offset(device, gen, shape=SERVE_SHAPE, offset=6,
                      heads=6) -> None:
    """A tensor-parallel rank's heads: ``heads`` of the 12 at ``offset``
    (``head_offset`` / ``heads_total``), rate 0.1, each dtype.  The plain
    keep mask at the offset is the whole mask's head slice bit for bit; the
    kernels' outputs and gradients are the head slice of the (B, 12, L, D)
    call's bit for bit (each head is computed alone, from the same bits),
    and within the tolerances of their plain version at the offset."""
    B, H, L, _ = shape
    rate = RATES[-1]
    seed = _seed(2000, device)
    sl = slice(offset, offset + heads)
    part_mask = attention_keep_mask(seed, B, heads, L, rate,
                                    head_offset=offset, heads_total=H)
    mask_equal = torch.equal(part_mask,
                             attention_keep_mask(seed, B, H, L, rate)[:, sl])
    for dt in DTYPES:
        q, k, v, bias = attention_inputs(shape, dt, gen, device)
        do = torch.randn(shape, generator=gen, device=device).to(dt)
        whole = fa.flash_attention(q, k, v, bias, seed, rate)
        whole_g = fa.flash_attention_bwd(q, k, v, bias, seed, rate, do)
        part = [t[:, sl].contiguous() for t in (q, k, v, do)]
        got = fa.flash_attention(*part[:3], bias, seed, rate,
                                 head_offset=offset, heads_total=H)
        got_g = fa.flash_attention_bwd(*part[:3], bias, seed, rate, part[3],
                                       offset, H)
        want = fa.flash_attention_plain(*part[:3], bias, seed, rate, offset,
                                        H)
        want_g = fa.flash_attention_bwd_plain(*part[:3], bias, seed, rate,
                                              part[3], offset, H)
        _sync(device)
        bits = torch.equal(got, whole[:, sl]) and all(
            torch.equal(g, w[:, sl]) for g, w in zip(got_g, whole_g))
        err = (got.float() - want.float()).abs().max().item()
        errs = [_scaled_err(g, w) for g, w in zip(got_g, want_g)]
        print(f"  flash_attention heads {offset}..{offset + heads - 1} of {H} "
              f"{tuple(part[0].shape)} {dt} rate {rate}: the plain keep mask "
              f"the whole mask's head slice bit for bit {mask_equal}; "
              f"forward and dQ, dK, dV the (B, {H}, L, D) call's head slice "
              f"bit for bit {bits}; against the plain version at the "
              f"offset: forward max abs err {err:.3e} (tol "
              f"{KERNEL_TOL[dt]:.0e}), backward scaled "
              f"{max(errs):.3e} (tol {BWD_TOL[dt]:.0e})")
        if not (mask_equal and bits and err <= KERNEL_TOL[dt]
                and max(errs) <= BWD_TOL[dt]):
            raise AssertionError(f"flash kernels at head offset {offset} of "
                                 f"{H}, {dt}: mask {mask_equal}, bits {bits}, "
                                 f"{err}, {errs}")


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
    events also take in the host's time between launches.  The device's
    activity alone is traced (``profile_call``).  A trace that recorded no
    device time (late in a long run of profiler traces one did) is taken
    again, up to three times, and then raises."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(iters):
            fn()

    for _ in range(3):
        busy = profile_call(None, calls, 0.0, "")["busy"]
        if busy > 0:
            return busy / iters
    raise RuntimeError("torch.profiler recorded no device time in 3 traces")


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


def check_reload(save: str, state, bert_config, epoch: int = 1) -> None:
    """The three .bin files (the joint one of ``epoch``) load into fresh
    port modules with strict=True and hold the state's weights and
    statistics."""
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
        os.path.join(save, f"pytorch_model_epoch{epoch}.bin")), strict=True)
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
    {kernel: (ms, launches)}; with ``title`` None it prints nothing and
    returns the busy ms only.  Only the device's activity is traced (the
    kernels are what is read; a host operator's events cost seconds in a
    many-kernel call)."""
    started = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    # kernel rows only: an operator's row repeats its kernels' time
    rows = [(e.self_device_time_total / 1e3, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(r[0] for r in rows)
    if title is None:       # device_ms's silent use
        return {"busy": busy}
    print(f"profile {title}: {wall_ms:.3f} ms (host clock, profiler off), "
          f"device busy {busy:.3f} ms (profiler on)"
          + (f", idle share {1 - busy / wall_ms:.3f}" if busy else
             ", device time not measured")
          + f"; profiled in {time.perf_counter() - started:.1f} s  "
          f"[{card}]")
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
GC_TIMED = 1
# the step traced by torch.profiler: B=256 (~20 k kernels); tracing the
# B=2048 step (~160 k) took 57.0 s of the run's limit on an NVIDIA H100
# 80GB HBM3 at 700 W (its device busy then 2474.5 ms, idle share 0.600)
GC_PROFILED = GC_CONFIGS[0]
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
        first = loss
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
                      batch / ms * 1e3, "peak": peak,
                      "first_loss": first.item()}
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
        if cuda and (batch, chunks) == GC_PROFILED:
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
TOWER_TIMED = 5         # 10 before the run's time limit bound
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
    started = time.perf_counter()
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
    split = {"buckets": time.perf_counter() - started}
    turns = stem_in_turns(device, bc, batch, buckets[-1], rng, card)
    split["turns"] = time.perf_counter() - started - sum(split.values())
    step_cmp = compare_step(device, bert_kw, batch, cmp_seq,
                            knob="pallas_stem")
    split["compare"] = time.perf_counter() - started - sum(split.values())

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
    split["grad_cache"] = time.perf_counter() - started - sum(split.values())
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
    split["tower"] = time.perf_counter() - started - sum(split.values())
    print("  phase 10's parts, seconds (host clock): "
          + ", ".join(f"{k} {v:.1f}" for k, v in split.items()))
    return {"train_launches": train_launches, "dx_launches": dx_launches,
            "ms": ms, "peak": peak, "turns": turns, "cmp": step_cmp,
            "gc_ms": gc_ms,
            "tower_ms": tower, "dx": dx_check}


# ---- phase 11: the Manager's epoch loop -------------------------------------

MANAGER_PAIRS = 256     # 512 before the run's time limit bound
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


# ---- phase 12: MI pretraining from disk through its entry point ------------

# 512 pairs (and 512 AE images): the whole run, phase 16 included, keeps
# inside its time limit
CLI_PAIRS = 512
CLI_LONG = 64          # more pairs in each of the 256 and 320 buckets
CLI_EPOCHS = 2
CLI_STOP_STEP = 5      # run B's SIGTERM: inside epoch 1, not a multiple of 8
CLI_WINDOWS = 64       # distinct cache windows, hard-linked over the entries
# a full-resolution MIMIC-CXR (mimm_tpu/data/transforms.py:8)
CXR_SHAPE = (2544, 3056)
SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def window_pool(root: str, img_size: int, rng) -> list:
    """CLI_WINDOWS crop-cache windows (uint8) as ``support_window`` cuts
    them from a CXR_SHAPE image, written under ``root``; their paths."""
    from mimm_tpu_torch.data import crop_cache

    h, w = CXR_SHAPE
    oy, ox, wh, ww = crop_cache.support_window(h, w, img_size)
    pool = []
    for k in range(CLI_WINDOWS):
        path = os.path.join(root, f"window{k}.npz")
        crop_cache.write(path, rng.integers(0, 256, (wh, ww), dtype=np.uint8),
                         (oy, ox, h, w))
        pool.append(path)
    return pool


def link_window(window: str, cache_dir: str, img_id: str,
                img_size: int) -> None:
    """``window`` as the crop-cache entry of ``img_id`` (a hard link)."""
    entry = os.path.join(cache_dir, f"{img_id}.w{img_size}.npz")
    try:
        os.link(window, entry)
    except OSError:
        shutil.copyfile(window, entry)


def write_cli_corpus(root: str, pairs: int, long: int, vocab_size: int,
                     img_size: int, seed: int) -> dict:
    """The files ``train_mutual_information`` reads, from numpy (no image
    codec): ``bert/vocab.txt`` of ``vocab_size`` tokens, ``text/
    all_data.tsv`` in the reference's layout (index, label, study, image,
    report), ``metadata.csv`` (``mimic_id``) and one crop-cache entry
    ``<img_id>.w<img_size>.npz`` per image, a uint8 window as
    ``support_window`` cuts it from a CXR_SHAPE image.  ``pairs`` report
    lengths (in tokens, [CLS] and [SEP] included) follow BUCKET_MIX over
    PRODUCTION_SEQ_BUCKETS, uniform within a bucket; ``long`` more fall in
    each of the two longest buckets.  Each report word is one token."""
    rng = np.random.default_rng(seed)
    paths = {k: os.path.join(root, k)
             for k in ("bert", "text", "cache", "images")}
    for p in paths.values():
        os.makedirs(p, exist_ok=True)
    vocab = [*SPECIAL_TOKENS,
             *(f"w{i:05d}" for i in range(vocab_size - len(SPECIAL_TOKENS)))]
    with open(os.path.join(paths["bert"], "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    bounds = (0, *PRODUCTION_SEQ_BUCKETS)
    share = np.array([BUCKET_MIX[b] for b in PRODUCTION_SEQ_BUCKETS])
    bucket = np.concatenate([
        rng.choice(len(share), size=pairs, p=share / share.sum()),
        np.full(long, len(share) - 2), np.full(long, len(share) - 1)])
    lengths = [int(rng.integers(max(3, bounds[b] + 1), bounds[b + 1] + 1))
               for b in bucket]
    pool = window_pool(root, img_size, rng)
    rows, reports = [], []
    for i, length in enumerate(lengths):
        study = 50000000 + i
        img_id = f"p{10000000 + i}_s{study}_{i:08x}.jpg"
        link_window(pool[i % CLI_WINDOWS], paths["cache"], img_id, img_size)
        words = rng.integers(len(SPECIAL_TOKENS), vocab_size, length - 2)
        reports.append(f"{i}\t-1\t{study}\t{img_id}\t"
                       + " ".join(vocab[j] for j in words))
        rows.append(img_id)
    with open(os.path.join(paths["text"], "all_data.tsv"), "w") as f:
        f.write("\n".join(reports) + "\n")
    paths["metadata"] = os.path.join(root, "metadata.csv")
    with open(paths["metadata"], "w") as f:
        f.write("mimic_id\n" + "".join(f"{r}\n" for r in rows))
    return paths


class _RunProbe:
    """What one ``train_mutual_information`` call does, read from outside:
    each step's host seconds, text length and loss (kept on the device
    until the end); the thread-seconds of the dataset's reads; the seconds
    of the pinned copies and of the checkpoint saves; the crop cache the
    Manager built.  ``stop_at``: after that step, a real SIGTERM to this
    process (the entry point's preemption handler takes it).  Installs its
    wrappers while it is entered."""

    def __init__(self):
        from mimm_tpu_torch.data import crop_cache, pipeline
        self._mods = crop_cache, pipeline
        self.stop_at = None
        self.reset()

    def reset(self):
        self.steps, self.lengths, self.losses = [], [], []
        self.load_s, self.copy_s, self.save_s, self.envelope_s = \
            0.0, 0.0, 0.0, 0.0
        self.reads = 0
        self.caches = []
        self._lock = threading.Lock()

    def __enter__(self):
        import signal

        crop_cache, pipeline = self._mods
        self._real = (mi.make_mi_step_body, pipeline.CXRImageReportDataset.load,
                      pipeline._to_device, mi.save_mi_checkpoints,
                      ckpt.save_checkpoint, crop_cache.from_config)
        body_of, load, to_device, save, envelope, from_config = self._real
        probe = self

        def timed(fn, field):
            def call(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    setattr(probe, field, getattr(probe, field)
                            + time.perf_counter() - t0)
            return call

        def make_body(*a, **kw):
            body = body_of(*a, **kw)

            def step(state, batch):
                t0 = time.perf_counter()
                state, loss = body(state, batch)
                probe.steps.append(time.perf_counter() - t0)
                probe.lengths.append(int(batch["txt_ids"].shape[-1]))
                probe.losses.append(loss)
                if state.step == probe.stop_at:
                    os.kill(os.getpid(), signal.SIGTERM)
                return state, loss
            return step

        def timed_load(ds, *a, **kw):
            t0 = time.perf_counter()
            try:
                return load(ds, *a, **kw)
            finally:
                with probe._lock:
                    probe.load_s += time.perf_counter() - t0
                    probe.reads += 1

        def keep_cache(cfg):
            cache = from_config(cfg)
            probe.caches.append(cache)
            return cache

        mi.make_mi_step_body = make_body
        pipeline.CXRImageReportDataset.load = timed_load
        pipeline._to_device = timed(to_device, "copy_s")
        mi.save_mi_checkpoints = timed(save, "save_s")
        ckpt.save_checkpoint = timed(envelope, "envelope_s")
        crop_cache.from_config = keep_cache
        return self

    def __exit__(self, *exc):
        crop_cache, pipeline = self._mods
        (mi.make_mi_step_body, pipeline.CXRImageReportDataset.load,
         pipeline._to_device, mi.save_mi_checkpoints, ckpt.save_checkpoint,
         crop_cache.from_config) = self._real

    def hits(self):
        return (sum(c.hits for c in self.caches),
                sum(c.misses for c in self.caches))


def _flat(tree) -> dict:
    """A resume checkpoint's tree as {path: value}, tensors copied to the
    CPU: every parameter, buffer, critic tensor, moment and count."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(f"{prefix}/{i}", v)
        else:
            out[prefix] = node.detach().cpu().clone() \
                if torch.is_tensor(node) else node
    walk("", tree)
    return out


def _flat_tree(state) -> dict:
    """``_flat`` of ``state``'s resume checkpoint tree."""
    return _flat(mi.mi_state_tree(state))


def embedding_repeat(device, batch=BATCH, seq=SEQ, width=768,
                     dtype=torch.float32, lookup=embedding_lookup) -> float:
    """The largest |difference| between two backward calls of ``lookup``
    on the same inputs at the token-type lookup's shape in a step (every
    index 0: one row gathers B·L gradients), with
    torch.use_deterministic_algorithms off."""
    if torch.are_deterministic_algorithms_enabled():
        raise AssertionError("embedding_repeat reads the lookup with "
                             "torch.use_deterministic_algorithms off")
    gen = torch.Generator(device=device).manual_seed(SEED + 29)
    ids = torch.zeros(batch, seq, dtype=torch.long, device=device)
    weight = torch.randn(2, width, generator=gen, device=device)
    dy = torch.randn(batch, seq, width, generator=gen, device=device) \
        .to(dtype)
    grads = []
    for _ in range(2):
        w = weight.to(dtype).requires_grad_()
        (g,) = torch.autograd.grad(lookup(ids, w), (w,), dy)
        grads.append(g)
    return (grads[0].float() - grads[1].float()).abs().max().item()


def _ms_a_read(split: dict) -> str:
    """A probe's dataset.load thread-seconds over its reads, in ms."""
    return f"{split['load'] / max(1, split['reads']) * 1e3:.3f} ms a read"


def _jsonl(save: str, name: str = "mi") -> list:
    with open(os.path.join(save, f"{name}.jsonl")) as f:
        return [json.loads(line) for line in f]


def drive_mi_cli(root: str, device, bert_kw=BERT_BASE, pairs=CLI_PAIRS,
                 long=CLI_LONG, batch=BATCH, workers=MANAGER_WORKERS,
                 stop_step=CLI_STOP_STEP, in_memory_pairs_per_s=None
                 ) -> dict:
    """``train_mutual_information(TrainingConfig.production(pallas_stem=
    True, ...))`` over ``write_cli_corpus``: run A uninterrupted, run B
    stopped by a SIGTERM after ``stop_step``, run C resuming B ("auto").
    Raises unless C ends at A's step count on A's bits, every read was a
    crop-cache hit, only the newest epoch checkpoint is left and the .bin
    files reload strict.  Returns A's launches and numbers."""
    from mimm_tpu_torch import preempt
    from mimm_tpu_torch.cli.multi_modal import train_mutual_information

    cuda = torch.device(device).type == "cuda"
    card = card_line() if cuda else "cpu"
    started = time.perf_counter()
    corpus = write_cli_corpus(os.path.join(root, "corpus"), pairs, long,
                              bert_kw["vocab_size"], 256, SEED + 23)
    with open(os.path.join(corpus["bert"], "bert_config.json"), "w") as f:
        json.dump(bert_kw, f)
    written = time.perf_counter() - started

    def cfg_for(save, **kw):
        return TrainingConfig.production(
            pallas_stem=True, batch_size=batch, num_train_epochs=CLI_EPOCHS,
            keep_checkpoints=1, data_loader_workers=workers, prefetch=2,
            seed=SEED, image_dir=corpus["images"],
            text_data_dir=corpus["text"],
            dataset_metadata=corpus["metadata"],
            decoded_crop_cache=corpus["cache"],
            bert_pretrained_dir=corpus["bert"], save_directory=save, **kw)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    probe = _RunProbe()
    try:
        with probe:
            # ---- A: uninterrupted; the mi_cli path's launches ---------------
            save_a = os.path.join(root, "run_a")
            for mod in (fa, sc, pc, ff):
                mod.reset_launch_counts()       # the mi_cli path starts here
            _, state = train_mutual_information(cfg_for(save_a), device)
            _sync(device)
            launches = {**fa.LAUNCHES, **sc.LAUNCHES, **pc.LAUNCHES,
                        **ff.LAUNCHES}          # ... and ends here
            recs = [r for r in _jsonl(save_a) if "epoch_loss" in r]
            steps, hits = state.step, probe.hits()
            split = {"load": probe.load_s, "reads": probe.reads,
                     "copy": probe.copy_s,
                     "steps": sum(probe.steps), "save": probe.save_s,
                     "envelope": probe.envelope_s}
            long_steps = sum(L >= bert_kw.get("flash_min_seq_len", 256)
                             for L in probe.lengths)
            bc = BertConfig.from_json_file(os.path.join(save_a,
                                                        "config.json"))
            check_reload(save_a, state, bc, epoch=CLI_EPOCHS)
            files_a = sorted(os.listdir(save_a))
            want = _flat_tree(state)
            del state
            if cuda:
                torch.cuda.empty_cache()
            # ---- B: a SIGTERM after stop_step -------------------------------
            save_bc = os.path.join(root, "run_bc")
            probe.reset()
            probe.stop_at = stop_step
            _, state = train_mutual_information(cfg_for(save_bc), device)
            probe.stop_at = None
            b_step, b_hits = state.step, probe.hits()
            preempted = any(r.get("preempted") == 1 for r in _jsonl(save_bc))
            del state
            preempt.clear()   # a new process would start without the flag
            # ---- C: the same command, resume_from "auto" --------------------
            probe.reset()
            _, state = train_mutual_information(
                cfg_for(save_bc, resume_from="auto"), device)
            _sync(device)
            c_hits = probe.hits()
            got = _flat_tree(state)
            c_step = state.step
            files_c = sorted(os.listdir(save_bc))
            del state
    finally:
        torch.backends.cudnn.deterministic = deterministic
        preempt.uninstall()
        preempt.clear()
    seconds = time.perf_counter() - started

    per_epoch = steps // CLI_EPOCHS
    epoch_s = [r["epoch_seconds"] for r in recs]
    print(f"  corpus: {pairs + 2 * long} pairs ({pairs} by the bucket mix, "
          f"{long} more at 256 and at 320), vocab {bert_kw['vocab_size']}, "
          f"windows of a {CXR_SHAPE[0]}x{CXR_SHAPE[1]} CXR, written in "
          f"{written:.1f} s (host clock)")
    print(f"  run A: {steps} steps ({per_epoch} an epoch, {long_steps} at L "
          f">= 256), epochs {', '.join(f'{s:.3f}' for s in epoch_s)} s = "
          + ", ".join(f"{per_epoch * batch / s:.1f}" for s in epoch_s)
          + " pairs/s (host clock, mi.jsonl)"
          + (f"; phase 11's in-memory epoch {in_memory_pairs_per_s:.1f} "
             f"pairs/s" if in_memory_pairs_per_s else "") + f"  [{card}]")
    print(f"  run A's {CLI_EPOCHS} epochs ({sum(epoch_s):.3f} s): "
          f"dataset.load {split['load']:.3f} thread-s over {workers} loader "
          f"threads ({split['reads']} reads, {_ms_a_read(split)} through "
          f"the host library), pinned copies {split['copy']:.3f} s, steps "
          f"{split['steps']:.3f} s (host time in the step calls), "
          f"save_mi_checkpoints {split['save']:.3f} s (the envelope "
          f"{split['envelope']:.3f} s of it)  [{card}]")
    print(f"  crop cache (hits, misses): A {hits}, B {b_hits}, C {c_hits}")
    print(f"  run B: SIGTERM after step {stop_step}, stopped at step "
          f"{b_step}, preempted=1 in mi.jsonl: {preempted}; run C resumed "
          f"to step {c_step} (A {steps}); files left: A "
          f"{[f for f in files_a if f.endswith('.ckpt')]}, B/C "
          f"{[f for f in files_c if f.endswith('.ckpt')]}")
    differ = [k for k in want if not (torch.equal(want[k], got[k])
                                      if torch.is_tensor(want[k])
                                      else want[k] == got[k])]
    print(f"  C against A: {len(want)} tensors and counts, {len(differ)} "
          f"differ" + (f" ({differ[:3]})" if differ else ", bit for bit"))
    bad = []
    if differ:
        bad.append(f"run C differs from run A in {len(differ)} tensors, the "
                   f"first {differ[0]}")
    # BERT's lookups sum their gradients in a fixed order (ops/embedding.py):
    # two backward calls at the token-type lookup's longest shape here give
    # the same bits without the deterministic flag, where F.embedding's
    # float32 sums do not
    seq = max(probe.lengths or [SEQ])
    repeat = {name: embedding_repeat(device, batch, seq, dtype=dt)
              for name, dt in (("float32", torch.float32),
                               ("bfloat16", torch.bfloat16))}
    print(f"  the embedding lookup's backward at ({batch}, {seq}), every index "
          f"0, two calls on the same inputs, max |diff|: "
          + ", ".join(f"{k} {v:.2e}" for k, v in repeat.items())
          + f" (F.embedding float32 "
          f"{embedding_repeat(device, batch, seq, lookup=F.embedding):.2e})")
    if any(repeat.values()):
        bad.append(f"the embedding lookup's backward is not the same bits "
                   f"twice: {repeat}")
    if cuda:
        layers = bert_kw["num_hidden_layers"]
        want_launches = {
            fa.KERNELS[torch.bfloat16]: layers * long_steps,
            fa.BWD_KERNELS[torch.bfloat16]: layers * long_steps,
            sc.KERNELS["fwd"]: steps, sc.KERNELS["dw"]: steps}
        print(f"  run A's launches: {launches} (want {want_launches})")
        if any(launches.get(n, 0) != c for n, c in want_launches.items()) \
                or long_steps == 0:
            bad.append(f"run A's launches {launches}, want {want_launches}")
    total_hits = [hits, b_hits, c_hits]
    if any(m for _, m in total_hits) or not all(h for h, _ in total_hits):
        bad.append(f"crop-cache misses (hits, misses): {total_hits}")
    if not (0 < b_step < per_epoch and preempted
            and "mi_preempt.ckpt" in files_c):
        bad.append(f"run B stopped at step {b_step} (epoch 1 has "
                   f"{per_epoch}), preempted {preempted}")
    if c_step != steps:
        bad.append(f"run C ended at step {c_step}, A at {steps}")
    last = f"mi_epoch{CLI_EPOCHS}.ckpt"
    for name, files in (("A", files_a), ("C", files_c)):
        if [f for f in files if f.startswith("mi_epoch")] != [last]:
            bad.append(f"run {name} left {files}")
    if not all(math.isfinite(r["epoch_loss"]) for r in recs):
        bad.append(f"run A's losses: {recs}")
    print(f"  phase 12: {seconds:.1f} s (host clock)  [{card}]")
    if bad:
        raise AssertionError("; ".join(bad))
    return {"launches": launches, "steps": steps, "long_steps": long_steps,
            "seconds": seconds, "epoch_seconds": epoch_s, "split": split,
            "hits": total_hits, "bit_equal": not differ, "save": save_a}


# ---- phase 13: the autoencoder through its entry point ---------------------

AE_IMAGES = 512       # see CLI_PAIRS
AE_EPOCHS = 2
AE_STOP_STEP = 5       # run B's SIGTERM: inside epoch 1 (8 steps)
AE_TIMED = 3
AE_CHUNKED = (256, 4)  # the chunked step: B and grad_cache_chunks
AE_CHUNK_PEAK = 1.5    # its peak against the B=64 step's, at most
AE_CMP_BATCH = 8       # the float32 step held against float64
# JAX's own float32 AE step against its float64 step at this configuration
# (full width, B=8, Adam at 1e-4, this batch; tests/jax_ae_f32_shares.py
# on the CPU): per group, the share of elements more than 1e-6 apart and
# the share whose step took the other sign.  Phase 5's share of 1e-3 does
# not hold for the AE's reference itself: 0.29-1.5 % of each group's
# elements move more than 1e-6 and 0.03-0.12 % flip their first Adam step.
# The port is held to AE_SHARE_MARGIN times the reference's shares, and to
# phase 5's |Δloss| and largest |Δ|.
JAX_AE_F32 = {"encoder": (1.518e-2, 1.203e-3), "decoder": (2.864e-3, 3.457e-4),
              "fc": (9.341e-3, 1.089e-3)}
AE_SHARE_MARGIN = 1.5


def write_image_corpus(root: str, images: int, img_size: int,
                       seed: int) -> dict:
    """The files ``train_auto_encoder`` reads, from numpy (no image codec):
    ``metadata.csv`` (``mimic_id``) and one crop-cache entry per image, a
    window of ``window_pool``; ``images/`` stays empty, so every read must
    be a hit."""
    rng = np.random.default_rng(seed)
    paths = {k: os.path.join(root, k) for k in ("cache", "images")}
    for p in paths.values():
        os.makedirs(p, exist_ok=True)
    pool = window_pool(root, img_size, rng)
    rows = [f"p{20000000 + i}_s{60000000 + i}_{i:08x}.jpg"
            for i in range(images)]
    for i, img_id in enumerate(rows):
        link_window(pool[i % CLI_WINDOWS], paths["cache"], img_id, img_size)
    paths["metadata"] = os.path.join(root, "metadata.csv")
    with open(paths["metadata"], "w") as f:
        f.write("mimic_id\n" + "".join(f"{r}\n" for r in rows))
    return paths


class _AEProbe:
    """What one ``train_auto_encoder`` call does, read from outside: each
    step's host seconds and loss (kept on the device), the thread-seconds
    of the dataset's reads, the seconds of each epoch save, the crop cache
    it built.  ``stop_at``: after that step, a real SIGTERM to this process
    (the entry point's preemption handler takes it).  Installs its
    wrappers while it is entered."""

    def __init__(self):
        self.stop_at = None
        self.reset()

    def reset(self):
        self.steps, self.losses, self.saves, self.caches = [], [], [], []
        self.load_s, self.reads = 0.0, 0
        self._lock = threading.Lock()

    def __enter__(self):
        import signal

        from mimm_tpu_torch.data import crop_cache, pipeline
        from mimm_tpu_torch.train import ae

        self._mods = ae, crop_cache, pipeline
        self._real = (ae.make_ae_train_step, ae.save_ae_checkpoint,
                      pipeline.CXRImageDataset.load, crop_cache.from_config)
        make_step, save, load, from_config = self._real
        probe = self

        def make(*a, **kw):
            step = make_step(*a, **kw)

            def run(state, images):
                t0 = time.perf_counter()
                state, loss = step(state, images)
                probe.steps.append(time.perf_counter() - t0)
                probe.losses.append(loss)
                if state.step == probe.stop_at:
                    os.kill(os.getpid(), signal.SIGTERM)
                return state, loss
            return run

        def timed_save(*a, **kw):
            t0 = time.perf_counter()
            try:
                return save(*a, **kw)
            finally:
                probe.saves.append(time.perf_counter() - t0)

        def timed_load(ds, *a, **kw):
            t0 = time.perf_counter()
            try:
                return load(ds, *a, **kw)
            finally:
                with probe._lock:
                    probe.load_s += time.perf_counter() - t0
                    probe.reads += 1

        def keep_cache(cfg):
            cache = from_config(cfg)
            probe.caches.append(cache)
            return cache

        ae.make_ae_train_step, ae.save_ae_checkpoint = make, timed_save
        pipeline.CXRImageDataset.load = timed_load
        crop_cache.from_config = keep_cache
        return self

    def __exit__(self, *exc):
        ae, crop_cache, pipeline = self._mods
        (ae.make_ae_train_step, ae.save_ae_checkpoint,
         pipeline.CXRImageDataset.load, crop_cache.from_config) = self._real

    def hits(self):
        return (sum(c.hits for c in self.caches),
                sum(c.misses for c in self.caches))


def _ae_flat(state) -> dict:
    """Every tensor and count of an AE state (its resume tree), on the
    CPU: parameters, running statistics, moments, counts."""
    from mimm_tpu_torch.train import ae

    tree = ae.ae_state_tree(state)
    out = {f"model/{k}": v.detach().cpu().clone()
           for k, v in tree["model"].items()}
    for part in ("mu", "nu"):
        out.update({f"opt/{part}/{k}": v.detach().cpu().clone()
                    for k, v in tree["opt_state"][part].items()})
    out["opt/count"] = tree["opt_state"]["count"]
    out["step"] = tree["step"]
    return out


def _ae_images(rng, batch: int, device) -> torch.Tensor:
    """A compact batch: uint8 (B, 256, 256, 1) crops on ``device``."""
    return torch.from_numpy(rng.integers(0, 256, (batch, 256, 256, 1),
                                         dtype=np.uint8)).to(device)


def ae_step_numbers(device, batch: int, card: str) -> dict:
    """The production AE step at full width from seeded random weights:
    ms per step (AE_TIMED after a warm-up, host clock ending in a
    synchronize), its peak memory, one step under torch.profiler; then
    the chunked step, AE_CHUNKED, one warm-up and 2 timed, whose peak must
    stay within AE_CHUNK_PEAK of the B=64 step's and whose loss must be
    finite."""
    from mimm_tpu_torch.train import ae

    cuda = torch.device(device).type == "cuda"
    cfg = TrainingConfig.production()
    model = ae.build_ae_model(cfg, device)
    state = ae.create_ae_state(model, cfg, torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 33)
    data = _ae_images(rng, batch, device)
    step = ae.make_ae_train_step(model, ae._ae_tx(cfg))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    state, _ = step(state, data)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(AE_TIMED):
        state, loss = step(state, data)
    _sync(device)
    ms = (time.perf_counter() - t0) / AE_TIMED * 1e3
    peak = torch.cuda.max_memory_allocated() if cuda else None
    print(f"  B={batch} AE step: {ms:.3f} ms ({batch / ms * 1e3:.1f} images/s, "
          f"{AE_TIMED} after 1 warm-up, host clock), peak "
          + (f"{peak / 2 ** 30:.2f} GiB" if cuda else "not measured")
          + f", loss {loss.item():.6f}  [{card}]")
    if cuda:
        profile_call(f"AE step B={batch} (one step; wall: the timed steps' "
                     f"mean)", lambda: step(state, data), ms, card)
    big, chunks = AE_CHUNKED
    chunked = ae.make_ae_train_step(model, ae._ae_tx(cfg), chunks=chunks)
    data = _ae_images(rng, big, device)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state, _ = chunked(state, data)
    _sync(device)
    t0 = time.perf_counter()
    losses = [chunked(state, data)[1] for _ in range(2)]
    _sync(device)
    ms_c = (time.perf_counter() - t0) / 2 * 1e3
    peak_c = torch.cuda.max_memory_allocated() if cuda else None
    finite = all(math.isfinite(x.item()) for x in losses)
    print(f"  B={big} in {chunks} chunks: {ms_c:.3f} ms a step "
          f"({big / ms_c * 1e3:.1f} images/s, 2 after 1 warm-up), peak "
          + (f"{peak_c / 2 ** 30:.2f} GiB = {peak_c / peak:.2f} x the "
             f"B={batch} step's" if cuda else "not measured")
          + f", losses {[round(x.item(), 6) for x in losses]}  [{card}]")
    if not finite or (cuda and peak_c > AE_CHUNK_PEAK * peak):
        raise AssertionError(f"chunked AE step: losses {losses}, peak "
                             f"{peak_c} against {AE_CHUNK_PEAK} x {peak}")
    del state, model
    return {"ms": ms, "peak": peak, "chunked_ms": ms_c, "chunked_peak": peak_c}


def ae_f32_against_f64(device, card: str, batch: int = AE_CMP_BATCH) -> dict:
    """One float32 step of the full-width AE (float32 moments, TF32 as the
    caller set it) against the same step in float64 from one state, per
    group (encoder, decoder, fc1/fc2): the largest |Δ|, the share of
    elements more than 1e-6 apart and the share whose step took the other
    sign.  Held: |Δloss| and the largest |Δ| to phase 5's limits, the two
    shares to AE_SHARE_MARGIN times JAX's own (JAX_AE_F32)."""
    from mimm_tpu_torch.train import ae

    cfg = TrainingConfig(compute_dtype="float32")
    m32 = ae.build_ae_model(cfg, device)
    s32 = ae.create_ae_state(m32, cfg, torch.Generator().manual_seed(SEED + 1))
    m64 = copy.deepcopy(m32).double()
    m64.dtype = torch.float64
    s64 = ae.create_ae_state(m64, cfg, None, weights=m64.state_dict())
    before = {n: p.detach().double().cpu() for n, p in m32.named_parameters()}
    data = _ae_images(np.random.default_rng(SEED + 35), batch, device)
    losses, after = [], []
    for model, state in ((m32, s32), (m64, s64)):
        _, loss = ae.make_ae_train_step(model, ae._ae_tx(cfg))(state, data)
        losses.append(loss.item())
        after.append({n: p.detach().double().cpu()
                      for n, p in model.named_parameters()})
    out = {"loss_diff": abs(losses[0] - losses[1])}
    bad = [] if out["loss_diff"] <= STEP_LOSS_ATOL else ["loss"]
    for group, (share_jax, flip_jax) in JAX_AE_F32.items():
        names = [n for n in before if n.startswith(group)]
        d = torch.cat([(after[0][n] - after[1][n]).abs().reshape(-1)
                       for n in names])
        flips = torch.cat([(torch.sign(after[0][n] - before[n])
                            != torch.sign(after[1][n] - before[n])).reshape(-1)
                           for n in names])
        out[group] = (d.max().item(), (d > 1e-6).double().mean().item(),
                      flips.double().mean().item())
        if out[group][0] > STEP_MAX_ABS \
                or out[group][1] > AE_SHARE_MARGIN * share_jax \
                or out[group][2] > AE_SHARE_MARGIN * flip_jax:
            bad.append(group)
    print(f"  f32 B={batch} AE step against float64: loss {losses[0]:.9e} vs "
          f"{losses[1]:.9e} (|diff| {out['loss_diff']:.2e}); max |dparam|, "
          f"share > 1e-6, share of flipped steps (JAX's own): "
          + ", ".join(f"{g} {v[0]:.2e}, {v[1]:.2e} ({JAX_AE_F32[g][0]:.2e}), "
                      f"{v[2]:.2e} ({JAX_AE_F32[g][1]:.2e})"
                      for g, v in out.items() if g != "loss_diff")
          + f"  [{card}]")
    if bad:
        raise AssertionError(f"the f32 AE step is past its limits against "
                             f"float64 in {bad}: {out}")
    return out


def drive_ae_cli(root: str, device, images=AE_IMAGES, batch=BATCH,
                 workers=MANAGER_WORKERS, stop_step=AE_STOP_STEP) -> dict:
    """``mimm_tpu_torch.cli.uni_modal.main`` with the production preset at
    full width (ResNetAE 256², 6 levels, 2 residual blocks, z_dim 192,
    bottleneck 768), B=64, AE_EPOCHS epochs, ``keep_checkpoints`` 1,
    ``workers`` loader threads, over ``write_image_corpus``: run A
    uninterrupted, run B stopped by a SIGTERM after ``stop_step``, run C
    resuming B ("auto").  Raises unless C ends at A's step count on A's
    bits in every tensor, every read was a crop-cache hit, the AE path
    launched no port kernel, only the newest epoch checkpoint is left and
    the .bin files reload strict into a fresh ResNetAE and its towers
    with A's eval embedding; then the step's numbers
    (``ae_step_numbers``) and the f32 step against float64
    (``ae_f32_against_f64``)."""
    from mimm_tpu_torch import preempt
    from mimm_tpu_torch.cli import uni_modal
    from mimm_tpu_torch.train import ae

    cuda = torch.device(device).type == "cuda"
    card = card_line() if cuda else "cpu"
    started = time.perf_counter()
    corpus = write_image_corpus(os.path.join(root, "corpus"), images, 256,
                                SEED + 31)
    written = time.perf_counter() - started

    def argv(save, *extra):
        return ["--preset", "production", "--device", str(device),
                "--batch_size", str(batch), "--num_train_epochs",
                str(AE_EPOCHS), "--keep_checkpoints", "1",
                "--data_loader_workers", str(workers), "--prefetch", "2",
                "--seed", str(SEED), "--image_dir", corpus["images"],
                "--dataset_metadata", corpus["metadata"],
                "--decoded_crop_cache", corpus["cache"],
                "--save_directory", save, *extra]

    kernel_mods = (fa, sc, pc, ff)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    probe = _AEProbe()
    try:
        with probe:
            # ---- A: uninterrupted; the AE path's launches -------------------
            save_a = os.path.join(root, "ae_a")
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            for mod in kernel_mods:
                mod.reset_launch_counts()       # the AE path starts here
            state = uni_modal.main(argv(save_a))
            _sync(device)
            launches = {k: v for mod in kernel_mods
                        for k, v in mod.LAUNCHES.items() if v}  # ... ends here
            peak = torch.cuda.max_memory_allocated() if cuda else None
            recs = [r for r in _jsonl(save_a, "ae") if "epoch_loss" in r]
            steps, hits = state.step, probe.hits()
            split = {"load": probe.load_s, "reads": probe.reads,
                     "steps": sum(probe.steps), "saves": list(probe.saves)}
            files_a = sorted(os.listdir(save_a))
            want = _ae_flat(state)
            fresh = ae.build_ae_model(TrainingConfig.production(), device)
            ckpt.load_ae_from_bins(fresh, save_a, AE_EPOCHS)
            x = device_normalize(_ae_images(np.random.default_rng(SEED + 37),
                                            8, device)).permute(0, 3, 1, 2)
            with torch.no_grad():
                reload_same = torch.equal(fresh.encode(x),
                                          state.model.encode(x)) and all(
                    torch.equal(a, b) for a, b in zip(
                        fresh.state_dict().values(),
                        state.model.state_dict().values()))
            del state, fresh
            if cuda:
                torch.cuda.empty_cache()
            # ---- B: a SIGTERM after stop_step -------------------------------
            save_bc = os.path.join(root, "ae_bc")
            probe.reset()
            probe.stop_at = stop_step
            state = uni_modal.main(argv(save_bc))
            probe.stop_at = None
            b_step, b_hits = state.step, probe.hits()
            preempted = any(r.get("preempted") == 1
                            for r in _jsonl(save_bc, "ae"))
            del state
            preempt.clear()   # a new process would start without the flag
            # ---- C: the same command, --resume_from auto --------------------
            probe.reset()
            state = uni_modal.main(argv(save_bc, "--resume_from", "auto"))
            _sync(device)
            c_hits, c_step = probe.hits(), state.step
            got = _ae_flat(state)
            files_c = sorted(os.listdir(save_bc))
            del state
    finally:
        torch.backends.cudnn.deterministic = deterministic
        preempt.uninstall()
        preempt.clear()
    runs_s = time.perf_counter() - started

    per_epoch = steps // AE_EPOCHS
    epoch_s = [r["epoch_seconds"] for r in recs]
    print(f"  corpus: {images} images, crop-cache windows of a "
          f"{CXR_SHAPE[0]}x{CXR_SHAPE[1]} CXR, written in {written:.1f} s "
          f"(host clock)")
    print(f"  run A: {steps} steps ({per_epoch} an epoch), epochs "
          f"{', '.join(f'{s:.3f}' for s in epoch_s)} s = "
          + ", ".join(f"{per_epoch * batch / s:.1f}" for s in epoch_s)
          + " images/s (host clock, ae.jsonl), epoch losses "
          + ", ".join(f"{r['epoch_loss']:.6f}" for r in recs)
          + ", peak " + (f"{peak / 2 ** 30:.2f} GiB" if cuda
                         else "not measured") + f"  [{card}]")
    print(f"  run A's {AE_EPOCHS} epochs ({sum(epoch_s):.3f} s): dataset.load "
          f"{split['load']:.3f} thread-s over {workers} loader threads "
          f"({split['reads']} reads, {_ms_a_read(split)} through the host "
          f"library), step "
          f"calls {split['steps']:.3f} s (host time; "
          f"{split['steps'] / max(1, steps) * 1e3:.2f} ms a call), "
          f"save_ae_checkpoint "
          + ", ".join(f"{s:.3f}" for s in split["saves"]) + f" s  [{card}]")
    print(f"  crop cache (hits, misses): A {hits}, B {b_hits}, C {c_hits}; "
          f"port-kernel launches on the AE path: {launches or 'none'}")
    print(f"  run B: SIGTERM after step {stop_step}, stopped at step {b_step}, "
          f"preempted=1 in ae.jsonl: {preempted}; run C resumed to step "
          f"{c_step} (A {steps}); files left: A "
          f"{[f for f in files_a if f.endswith('.ckpt')]}, B/C "
          f"{[f for f in files_c if f.endswith('.ckpt')]}; the .bin files "
          f"reload strict with A's eval embedding: {reload_same}")
    differ = [k for k in want if k not in got or not (
        torch.equal(want[k], got[k]) if torch.is_tensor(want[k])
        else want[k] == got[k])]
    print(f"  C against A: {len(want)} tensors and counts, {len(differ)} "
          f"differ" + (f", the first {differ[0]}" if differ
                       else ", bit for bit"))
    bad = []
    if differ:
        bad.append(f"run C differs from run A in {len(differ)} tensors, the "
                   f"first {differ[0]}")
    if launches:
        bad.append(f"the AE path launched port kernels: {launches}")
    total_hits = [hits, b_hits, c_hits]
    if any(m for _, m in total_hits) or not all(h for h, _ in total_hits):
        bad.append(f"crop-cache misses (hits, misses): {total_hits}")
    if not (0 < b_step < per_epoch and preempted
            and "ae_preempt.ckpt" in files_c):
        bad.append(f"run B stopped at step {b_step} (epoch 1 has "
                   f"{per_epoch}), preempted {preempted}")
    if c_step != steps or steps != AE_EPOCHS * (images // batch):
        bad.append(f"run C ended at step {c_step}, A at {steps}")
    last = f"ae_epoch{AE_EPOCHS}.ckpt"
    for name, files in (("A", files_a), ("C", files_c)):
        if [f for f in files if f.startswith("ae_epoch")] != [last] or \
                f"encoder_{AE_EPOCHS}.bin" not in files:
            bad.append(f"run {name} left {files}")
    if not reload_same:
        bad.append("the .bin files do not reload to A's state")
    if not all(math.isfinite(r["epoch_loss"]) for r in recs):
        bad.append(f"run A's losses: {recs}")
    if bad:
        raise AssertionError("; ".join(bad))
    numbers = ae_step_numbers(device, batch, card)
    f32 = ae_f32_against_f64(device, card)
    seconds = time.perf_counter() - started
    print(f"  phase 13: {seconds:.1f} s (host clock; the three runs "
          f"{runs_s:.1f} s)  [{card}]")
    return {"steps": steps, "epoch_seconds": epoch_s, "split": split,
            "hits": total_hits, "peak": peak, "seconds": seconds,
            "f32": f32, **numbers, "save": save_a}


# ---- phase 14: the classifier, validation and Grad-CAM ----------------------

CLF_STUDIES = 1024     # the studies labelled for each sweep disease
CLF_EPOCHS = 4
CLF_STOP_STEP = 5      # run B's SIGTERM: inside epoch 1
CLF_DISEASE = "Cardiomegaly"   # runs B and C: the sweep's first disease, MM
ENCODER_TIMED = 5      # timed B=64 frozen-encoder passes after a warm-up
CAM_IMAGES = 8
# the share of the studies positive for each sweep disease, the darkest
CLF_QUANTILES = {"Cardiomegaly": 0.4, "Pneumonia": 0.5}
# the labels follow the images, so each validated classifier must rank
# them (AUC), and the MI one, whose outputs straddle 0.5 by epoch 4, must
# call both classes.  The AE one ranks them (AUC 1.0) but its eval-mode
# outputs stay above 0.5 for 6 epochs while its training loss falls to
# 0.38: its tallies are the label counts, and its embedding is held by
# AUC and GDV against the recomputation
CLF_MIN_AUC = 0.9
# the validation report against its recomputation: accuracy and tallies
# exactly; AUC to 2e-5 (about 5 of the ~250,000 positive-negative pairs
# changing order, should a probability move by an ulp); GDV to 1e-5 of
# its magnitude (float64 distances over the same float32 embeddings; the
# recomputation takes each distance directly, not by |a|^2 + |b|^2 - 2ab)
REPORT_AUC_TOL = 2e-5
REPORT_GDV_RTOL = 1e-5
# Grad-CAM heatmaps lie in [0, 1]; float32 (TF32 off) against float64 on
# the card, max |diff|: the f32 gradient's relative error (~1e-6) can
# grow where a map's range (hi - lo) is small after the relu
CAM_TOL = 1e-3
# ... and where that range falls below grad_cam's 1e-8 clamp, the clamp
# and not the range sets the heatmap's scale, which is then the score's
# gradient, p(1 - p) of the f32 sigmoid: 1 - p carries up to 2^-23 of
# absolute error, CAM_SIGMOID_ERR / (1 - p) of relative error
CAM_SIGMOID_ERR = 2.0 ** -22
# the f32 embedding with the stem kernel against the cuDNN stem: max |Δ| /
# max |reference|.  The stem's own f32 forward holds 1e-6 against cuDNN
# (STEM_TOL); the tower's 30 more convolutions and their BatchNorms
# follow it in eval mode, each free to grow a difference by a few times,
# and phase 10's f32 stem-on-against-off step holds 1e-5 on the loss
STEM_EMB_TOL = 1e-4


def write_labelled_corpus(root: str, studies: int, img_size: int,
                          seed: int) -> dict:
    """The files the classifier runs read, from numpy (no image codec):
    ``metadata.csv``, one crop-cache entry per study (a hard link to one of
    CLI_WINDOWS windows, study i to window i mod CLI_WINDOWS) and
    ``disease_stats.csv``.  Window k is 255 minus uniform noise of
    amplitude a_k (spread over 32..96); in half the windows a share s_k
    (spread over 0.4..0.6) of every 32 columns is black, so each window's
    brightness (mean / max, what survives ``device_normalize``) differs,
    in two clusters.  A study is positive for a disease when its
    brightness lies below that disease's CLF_QUANTILES quantile over the
    studies (Pneumonia's median is the gap between the clusters): the
    labels follow the images, and a classifier that learns calls both
    classes.  Returns the paths and {disease: positives}."""
    from mimm_tpu_torch.cli.train import DISEASES
    from mimm_tpu_torch.data import crop_cache
    from mimm_tpu_torch.utils import MimicID

    rng = np.random.default_rng(seed)
    paths = {k: os.path.join(root, k) for k in ("cache", "images")}
    for p in paths.values():
        os.makedirs(p, exist_ok=True)
    h, w = CXR_SHAPE
    oy, ox, wh, ww = crop_cache.support_window(h, w, img_size)
    pool, bright = [], []
    half = CLI_WINDOWS // 2
    amps = rng.permutation(np.linspace(32, 96, CLI_WINDOWS).round()
                           .astype(int))
    stripes = rng.permutation(np.concatenate([
        np.zeros(CLI_WINDOWS - half), np.linspace(0.4, 0.6, half)]))
    for k, (amp, share) in enumerate(zip(amps, stripes)):
        win = (255 - rng.integers(0, amp + 1, (wh, ww))).astype(np.uint8)
        win[:, np.arange(ww) % 32 < round(32 * share)] = 0
        pool.append(os.path.join(root, f"window{k}.npz"))
        crop_cache.write(pool[-1], win, (oy, ox, h, w))
        bright.append(win.mean() / win.max())
    rows = [f"p{30000000 + i}_s{70000000 + i}_{i:08x}.jpg"
            for i in range(studies)]
    for i, img_id in enumerate(rows):
        link_window(pool[i % CLI_WINDOWS], paths["cache"], img_id, img_size)
    paths["metadata"] = os.path.join(root, "metadata.csv")
    with open(paths["metadata"], "w") as f:
        f.write("mimic_id\n" + "".join(f"{r}\n" for r in rows))
    b = np.array([bright[i % CLI_WINDOWS] for i in range(studies)])
    ids = [MimicID.get_study_id(r) for r in rows]
    paths["stats"] = os.path.join(root, "disease_stats.csv")
    positives = {}
    with open(paths["stats"], "w") as f:
        for disease in DISEASES:
            pos = b < np.quantile(b, CLF_QUANTILES[disease])
            p = [s for s, x in zip(ids, pos) if x]
            n = [s for s, x in zip(ids, pos) if not x]
            f.write(f"{disease},{len(p)},\"{p}\"\n"
                    f"{disease}_negative,{len(n)},\"{n}\"\n")
            positives[disease] = len(p)
    return paths, positives


EMBED_SPAN = "chip_smoke.embedding_call"
EMBED_TRACE_FROM = 20  # the sweep's first embedding calls traced: past the
EMBED_TRACED = 10      # first epoch's warm-up, the loader threads running


def span_split(path: str, span: str) -> list:
    """Each host-side ``span`` of a torch.profiler trace (its copy on the
    device's timeline is left out): its wall ms, the ms its thread spent
    inside operators (their union), the device ms of the kernels that
    started inside it, the gaps of more than 0.1 ms between its thread's
    operators (ms: time the thread held no operator; an operator drops the
    GIL and takes it back when it ends, so a thread waiting for the GIL
    waits here), and what the trace shows during the gaps over 1 ms:
    {event name: ms of it inside such a gap}, for the operators and CUDA
    runtime calls of every thread."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    host = [e for e in events if e.get("cat") in ("cpu_op", "cuda_runtime")]
    out = []
    for sp in (e for e in events if e.get("name") == span
               and e.get("cat") == "user_annotation"):
        t0, t1 = sp["ts"], sp["ts"] + sp["dur"]
        ops = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") == "cpu_op" and e.get("tid") == sp["tid"]
                     and t0 <= e["ts"] < t1)
        busy, gaps, end = 0.0, [], t0
        for a, b in ops:
            if a > end:
                gaps.append((end, a))
            if b > end:
                busy += b - max(a, end)
                end = b
        if t1 > end:
            gaps.append((end, t1))
        gaps = [(a, b) for a, b in gaps if b - a > 1e2]
        during = collections.Counter()
        for e in host:
            for a, b in (g for g in gaps if g[1] - g[0] > 1e3):
                o = min(b, e["ts"] + e["dur"]) - max(a, e["ts"])
                if o > 0:
                    who = "main" if e.get("tid") == sp["tid"] else "other"
                    during[f"{e['name'][:48]} ({who})"] += o / 1e3
        device = sum(e["dur"] for e in events
                     if e.get("cat") == "kernel" and t0 <= e["ts"] < t1)
        out.append({"wall": sp["dur"] / 1e3, "ops": busy / 1e3,
                    "device": device / 1e3,
                    "gaps": [(b - a) / 1e3 for a, b in gaps],
                    "during": during})
    return out


class _ClassifierProbe:
    """What the classifier runs do, read from outside: the thread-seconds
    of the dataset's reads, each embedding call's and each MLP step's
    seconds (each ending in a synchronize, so that device time lands in
    its own call), each save's seconds, the crop caches built.
    ``stop_at``: after that step, a real SIGTERM to this process (the
    entry point's preemption handler takes it)."""

    def __init__(self, device):
        self.device = device
        self.stop_at = None
        self.prof = None
        self.reset()

    def trace_embedding_calls(self, logdir: str) -> None:
        """Trace EMBED_TRACED embedding calls from the EMBED_TRACE_FROM-th
        of the next run on (once), each inside an EMBED_SPAN span."""
        self.prof = profiling.StepProfiler(logdir, EMBED_TRACED)

    def reset(self):
        self.embed_s, self.step_s, self.saves, self.caches = [], [], [], []
        self.load_s, self.reads = 0.0, 0
        self._lock = threading.Lock()

    def __enter__(self):
        import signal

        from mimm_tpu_torch.data import crop_cache, pipeline
        from mimm_tpu_torch.train import classifier as clf

        self._mods = clf, crop_cache, pipeline
        self._real = (clf.make_embedding_fn, clf.make_classifier_step,
                      clf.ClassifierModelManager.save,
                      pipeline.CXRImageDiseaseDataset.load,
                      crop_cache.from_config)
        make_embed, make_step, save, load, from_config = self._real
        probe = self

        def timed_embed(*a, **kw):
            embed = make_embed(*a, **kw)

            def run(images):
                prof = probe.prof
                if prof is not None and len(probe.embed_s) == EMBED_TRACE_FROM:
                    prof.start()
                t0 = time.perf_counter()
                with profiling.annotate(EMBED_SPAN):
                    out = embed(images)
                    _sync(probe.device)
                probe.embed_s.append(time.perf_counter() - t0)
                if prof is not None and prof.active:
                    prof.step(out)
                return out
            return run

        def timed_step(*a, **kw):
            step = make_step(*a, **kw)

            def run(state, emb, labels):
                t0 = time.perf_counter()
                state, loss = step(state, emb, labels)
                _sync(probe.device)
                probe.step_s.append(time.perf_counter() - t0)
                if state.step == probe.stop_at:
                    os.kill(os.getpid(), signal.SIGTERM)
                return state, loss
            return run

        def timed_save(*a, **kw):
            t0 = time.perf_counter()
            try:
                return save(*a, **kw)
            finally:
                probe.saves.append(time.perf_counter() - t0)

        def timed_load(ds, *a, **kw):
            t0 = time.perf_counter()
            try:
                return load(ds, *a, **kw)
            finally:
                with probe._lock:
                    probe.load_s += time.perf_counter() - t0
                    probe.reads += 1

        def keep_cache(cfg):
            cache = from_config(cfg)
            probe.caches.append(cache)
            return cache

        clf.make_embedding_fn, clf.make_classifier_step = timed_embed, \
            timed_step
        clf.ClassifierModelManager.save = timed_save
        pipeline.CXRImageDiseaseDataset.load = timed_load
        crop_cache.from_config = keep_cache
        return self

    def __exit__(self, *exc):
        clf, crop_cache, pipeline = self._mods
        (clf.make_embedding_fn, clf.make_classifier_step,
         clf.ClassifierModelManager.save,
         pipeline.CXRImageDiseaseDataset.load,
         crop_cache.from_config) = self._real

    def split(self) -> dict:
        return {"load": self.load_s, "reads": self.reads,
                "embed": sum(self.embed_s),
                "embed_calls": len(self.embed_s), "steps": sum(self.step_s),
                "step_calls": len(self.step_s), "saves": sum(self.saves),
                "save_calls": len(self.saves)}

    def hits(self):
        return (sum(c.hits for c in self.caches),
                sum(c.misses for c in self.caches))


def _clf_flat(state) -> dict:
    """Every tensor and count of a classifier state (its resume tree), on
    the CPU."""
    from mimm_tpu_torch.train.classifier import classifier_state_tree

    tree = classifier_state_tree(state)
    out = {f"model/{k}": v.detach().cpu().clone()
           for k, v in tree["model"].items()}
    for part, d in tree["opt_state"].items():
        if isinstance(d, dict):
            out.update({f"opt/{part}/{k}": v.detach().cpu().clone()
                        for k, v in d.items()})
        else:
            out[f"opt/{part}"] = d
    out["step"] = tree["step"]
    return out


def _encoders(cfg, device, which=("mm", "um")) -> dict:
    """The frozen encoders of ``cfg``'s run directories as the sweep
    builds them (the ResNet in float32 with the cuDNN stem, the AE in the
    config's dtype), loaded strict, in eval mode."""
    from mimm_tpu_torch.cli.train import mm_run_dir, um_run_dir
    from mimm_tpu_torch.train import ae

    out = {}
    if "mm" in which:
        out["mm"] = ResNet256_6_2_1(
            output_channels=cfg.output_channels).to(device)
        out["mm"].load_state_dict(ckpt.load_resnet_from_bin(os.path.join(
            mm_run_dir(cfg), "pytorch_MI_image_model.bin")), strict=True)
    if "um" in which:
        out["um"] = ae.build_ae_model(cfg, device)
        out["um"].load_state_dict(ckpt.load_state_dict_bin(os.path.join(
            um_run_dir(cfg), f"autoencoder_path_{cfg.num_train_epochs}.bin")),
            strict=True)
    return {k: m.eval() for k, m in out.items()}


def _embed_direct(model, modality: str, images: torch.Tensor):
    with torch.no_grad():
        x = device_normalize(images)
        if modality == "mm":
            return model(x, train=False)[1]
        return model.encode(x.permute(0, 3, 1, 2), train=False)


def cam_limits(heat64: np.ndarray, p64: np.ndarray) -> np.ndarray:
    """Each image's limit on |f32 - float64| of its Grad-CAM heatmap:
    CAM_TOL, plus, where float64's map is below the clamp (its maximum
    under 1), the f32 sigmoid's share of the scale."""
    top = heat64.reshape(len(heat64), -1).max(axis=1)
    return CAM_TOL + np.where(top < 1.0, top * CAM_SIGMOID_ERR / (1 - p64),
                              0.0)


def _embed_plain(model, modality: str, x: torch.Tensor) -> torch.Tensor:
    """The embedding of host-normalized images ``x`` (B, H, W, 1), put
    together here: for the MI ResNet the stem, the six stages, the 2x2
    pool and the NHWC flatten written out (not ``forward``'s slot 1); for
    the autoencoder ``encode`` on the NCHW map."""
    from mimm_tpu_torch.models.resnet import _conv, _norm

    with torch.no_grad():
        x = x.permute(0, 3, 1, 2)
        if modality == "um":
            return model.encode(x, train=False)
        h = F.relu(_norm(model.bn1, _conv(model.conv1, x), False))
        for li in range(model.num_layers):
            for block in getattr(model, f"layer{li + 1}"):
                h = block(h, False)
        h = F.avg_pool2d(h, 2, 2)
        return h.permute(0, 2, 3, 1).reshape(len(h), -1).float()


def _gdv_direct(emb: np.ndarray, y: np.ndarray, device) -> float:
    """GDV (reference validate.py:37-49) written out on the device in
    float64: each class z-scored (population std, 1 where it is 0), the
    Euclidean distances taken directly, the reference's element-count
    normalization."""
    def z(a):
        a = torch.from_numpy(a).to(device, torch.float64)
        sd = a.std(0, unbiased=False)
        return (a - a.mean(0)) / torch.where(sd == 0, torch.ones_like(sd), sd)

    pos, neg = z(emb[y == 1]), z(emb[y == 0])
    dist = lambda a, b: torch.cdist(
        a, b, compute_mode="donot_use_mm_for_euclid_dist").sum().item()
    d = pos.shape[1]
    tp, tn = len(pos) * d, len(neg) * d
    intra = (dist(pos, pos) * 2 / (tp * (tp - 1))
             + dist(neg, neg) * 2 / (tn * (tn - 1))) / 2
    return (intra - dist(pos, neg) / (tp * tn)) / math.sqrt(len(pos)
                                                            + len(neg))


def recompute_report(cfg, model, modality: str, disease: str,
                     device) -> dict:
    """The validation's report recomputed here, apart from ``validate.py``
    and its Loader: the disease's studies read one by one with the eval
    transform, normalized on the host, embedded by ``_embed_plain``, the
    classifier ``.bin`` beside the encoder, ``np.round`` of the sigmoid;
    the tallies, accuracy, AUC by counting the positive-negative pairs in
    order, GDV by ``_gdv_direct``."""
    from mimm_tpu_torch.cli.train import mm_run_dir, um_run_dir
    from mimm_tpu_torch.data import crop_cache
    from mimm_tpu_torch.data.pipeline import CXRImageDiseaseDataset
    from mimm_tpu_torch.validate import find_classifier_checkpoint

    run_dir = mm_run_dir(cfg) if modality == "mm" else um_run_dir(cfg)
    clf = BasicMLP(768, DEFAULT_CLASSIFIER_LAYERS)
    clf.load_state_dict(ckpt.load_state_dict_bin(
        find_classifier_checkpoint(run_dir, disease)), strict=True)
    clf.to(device).eval()
    dataset = CXRImageDiseaseDataset(
        cfg.image_dir, cfg.dataset_metadata, disease,
        cfg.dataset_disease_stats, img_size=cfg.img_size,
        compact=cfg.compact_transfer, crop_cache=crop_cache.from_config(cfg))
    embs, probs, labels = [], [], []
    for lo in range(0, len(dataset), cfg.batch_size):
        items = [dataset.load(i, None, train=False)
                 for i in range(lo, min(len(dataset), lo + cfg.batch_size))]
        x = np.stack([it["image"] for it in items]).astype(np.float32)
        x /= np.maximum(x.max(axis=(1, 2, 3), keepdims=True), 1e-3)
        emb = _embed_plain(model, modality, torch.from_numpy(x).to(device))
        with torch.no_grad():
            probs.append(clf(emb)[:, 0])
        embs.append(emb)
        labels += [it["label"] for it in items]
    p = torch.cat(probs).cpu().numpy().astype(np.float64)
    emb = torch.cat(embs).cpu().numpy()
    y = np.asarray(labels)
    pred = np.round(p)
    tally = lambda q, t: int(((pred == q) & (y == t)).sum())
    out = {"tp": tally(1, 1), "tn": tally(0, 0), "fp": tally(1, 0),
           "fn": tally(0, 1), "positives": int(y.sum()),
           "negatives": int((1 - y).sum())}
    out["accuracy"] = (out["tp"] + out["tn"]) / len(y)
    sp, sn = p[y == 1][:, None], p[y == 0][None, :]
    out["auc"] = float(((sp > sn) + 0.5 * (sp == sn)).mean())
    out["separability"] = _gdv_direct(emb, y, device)
    # not in the report: the sigmoid's spread, and how far apart the
    # classes' mean embeddings lie against the spread within a class
    spread = np.sqrt((emb[y == 1].var(0).sum() + emb[y == 0].var(0).sum())
                     / 2)
    out["p_quartiles"] = np.quantile(p, [0, 0.25, 0.5, 0.75, 1]).tolist()
    out["class_separation"] = float(np.linalg.norm(
        emb[y == 1].mean(0) - emb[y == 0].mean(0)) / spread)
    return out


def encoder_images_per_s(models: dict, batch: int, device,
                         card: str) -> dict:
    """Images/s of each frozen encoder's embedding pass alone: B=``batch``
    uint8 crops, ENCODER_TIMED passes after a warm-up, host clock ending
    in a synchronize; with cuDNN's default algorithms and with
    ``cudnn.deterministic`` (the setting of the phase's runs)."""
    rng = np.random.default_rng(SEED + 41)
    images = torch.from_numpy(rng.integers(0, 256, (batch, 256, 256, 1),
                                           dtype=np.uint8)).to(device)
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    try:
        for flag in (False, True):
            torch.backends.cudnn.deterministic = flag
            for modality, model in models.items():
                _embed_direct(model, modality, images)
                _sync(device)
                t0 = time.perf_counter()
                for _ in range(ENCODER_TIMED):
                    _embed_direct(model, modality, images)
                _sync(device)
                out[modality, flag] = ENCODER_TIMED * batch / (
                    time.perf_counter() - t0)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    ms = lambda m, f: batch / out[m, f] * 1e3
    print(f"  the frozen-encoder pass alone, f32, B={batch} ({ENCODER_TIMED} "
          f"after 1 warm-up, host clock), images/s (ms a batch), cuDNN's "
          f"default / deterministic algorithms: MI ResNet "
          f"{out['mm', False]:.1f} ({ms('mm', False):.2f}) / "
          f"{out['mm', True]:.1f} ({ms('mm', True):.2f}), AE encoder "
          f"{out['um', False]:.1f} ({ms('um', False):.2f}) / "
          f"{out['um', True]:.1f} ({ms('um', True):.2f})  [{card}]")
    return {m: out[m, False] for m in models} | {
        f"{m}_deterministic": out[m, True] for m in models}


def drive_classifier(root: str, device, mi_run: str, ae_run: str,
                     epochs=AE_EPOCHS, batch=BATCH,
                     workers=MANAGER_WORKERS, studies=CLF_STUDIES,
                     stop_step=CLF_STOP_STEP) -> dict:
    """The downstream half through its entry points over
    ``write_labelled_corpus``'s ``studies`` studies, on phase 12's MI
    image encoder (``mi_run``'s ``pytorch_MI_image_model.bin``) and phase
    13's autoencoder (``ae_run``'s ``autoencoder_path_<epochs>.bin``; the
    sweep reads both run directories under one ``--num_train_epochs``, so
    the two phases train as many epochs): ``cli.train.main``
    ``--stage classifier_mm`` and ``classifier_um`` (both sweep diseases,
    frozen f32 encoders, the DEFAULT_CLASSIFIER_LAYERS MLP, B=``batch``,
    CLF_EPOCHS epochs, ``workers`` loader threads); for CLF_DISEASE on the
    MI encoder, run B (``cli.multi_modal.train_image_classifier``, a
    SIGTERM after ``stop_step``) and run C (``resume_from`` "auto"), which
    must end on run A's bits; ``cli.validate.main --extended`` for both
    modalities, each report against ``recompute_report`` (AUC at least
    CLF_MIN_AUC, the MI classifier calling both classes); each of the
    three paths without a port kernel; Grad-CAM on CAM_IMAGES images, f32
    against float64; one embedding pass with the stem kernel against the
    cuDNN stem.  Raises on any failed check; returns the stem pass's
    launches and the numbers."""
    from mimm_tpu_torch import cam, preempt
    from mimm_tpu_torch.cli import train as cli_train
    from mimm_tpu_torch.cli import validate as cli_validate
    from mimm_tpu_torch.cli.multi_modal import train_image_classifier
    from mimm_tpu_torch.data import crop_cache
    from mimm_tpu_torch.data.pipeline import CXRImageDiseaseDataset, Loader
    from mimm_tpu_torch.train.classifier import make_embedding_fn
    from mimm_tpu_torch.validate import find_classifier_checkpoint

    cuda = torch.device(device).type == "cuda"
    card = card_line() if cuda else "cpu"
    started = time.perf_counter()
    corpus, positives = write_labelled_corpus(
        os.path.join(root, "corpus"), studies, 256, SEED + 51)
    stats = corpus["stats"]
    for save in ("runs_a", "runs_bc"):
        for run_dir, src, name in (
                (f"mm_dv_epoch{epochs}", mi_run, "pytorch_MI_image_model.bin"),
                (f"um_ae_epoch{epochs}", ae_run,
                 f"autoencoder_path_{epochs}.bin")):
            os.makedirs(os.path.join(root, save, run_dir), exist_ok=True)
            dst = os.path.join(root, save, run_dir, name)
            try:
                os.link(os.path.join(src, name), dst)
            except OSError:
                shutil.copyfile(os.path.join(src, name), dst)
    flags = lambda save, *extra: [
        "--device", str(device), "--batch_size", str(batch),
        "--num_train_epochs", str(epochs), "--num_train_epochs_classifier",
        str(CLF_EPOCHS), "--data_loader_workers", str(workers),
        "--prefetch", "2", "--seed", str(SEED), "--compute_dtype", "float32",
        "--compact_transfer", "true", "--image_dir", corpus["images"],
        "--dataset_metadata", corpus["metadata"], "--dataset_disease_stats",
        stats, "--decoded_crop_cache", corpus["cache"],
        "--save_directory", os.path.join(root, save), *extra]
    kernel_mods = (fa, sc, pc, ff)

    def count_from_0():
        for mod in kernel_mods:
            mod.reset_launch_counts()

    def counted():
        return {k: v for mod in kernel_mods for k, v in mod.LAUNCHES.items()
                if v}

    launches = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    probe = _ClassifierProbe(device)
    probe.trace_embedding_calls(os.path.join(root, "embedding_trace"))
    runs, splits, hits, seconds = {}, {}, {}, {}
    try:
        with probe:
            # ---- A: the sweep through cli.train, both modalities ------------
            count_from_0()                      # the sweep starts
            for stage in ("classifier_mm", "classifier_um"):
                probe.reset()
                t0 = time.perf_counter()
                runs[stage] = cli_train.main(flags("runs_a", "--stage", stage))
                _sync(device)
                seconds[stage] = time.perf_counter() - t0
                splits[stage], hits[stage] = probe.split(), probe.hits()
            launches["sweep"] = counted()       # ... and ends
            want = _clf_flat(runs["classifier_mm"][0][0])
            want_best = [(r[1], os.path.basename(r[2] or ""))
                         for r in runs["classifier_mm"][:1]]
            # ---- B: a SIGTERM after stop_step; C: resume_from "auto" --------
            # the sweep's config and encoder; flags()[:2] is --device
            base = construct_training_parameters(flags("runs_bc")[2:])
            bc_dir, embed = cli_train.build_frozen_encoder(base, True, device)
            cfg_bc = base.replace(save_directory=bc_dir,
                                  disease_label=CLF_DISEASE,
                                  optimizer=cli_train.OPTIMIZERS[0],
                                  init_lr=cli_train.LEARNING_RATES[0])
            preempt.install()
            probe.reset()
            count_from_0()                      # runs B and C start
            probe.stop_at = stop_step
            b_state, _, _ = train_image_classifier(
                cfg_bc, embed, cli_train.MLP_LAYERS[0], device=device)
            probe.stop_at = None
            b_step = b_state.step
            b_files = sorted(os.listdir(bc_dir))
            preempt.clear()   # a new process would start without the flag
            probe.reset()
            c_state, c_acc, c_best = train_image_classifier(
                cfg_bc.replace(resume_from="auto"), embed,
                cli_train.MLP_LAYERS[0], device=device)
            _sync(device)
            launches["runs B-C"] = counted()    # ... and end
            hits["bc"] = probe.hits()
            got = _clf_flat(c_state)
            got_best = [(c_acc, os.path.basename(c_best or ""))]
            # ---- validation through cli.validate, both modalities ------------
            reports, val_s = {}, {}
            count_from_0()                      # the validations start
            for modality in ("mm", "um"):
                probe.reset()
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    reports[modality] = cli_validate.main(flags(
                        "runs_a", "--modality", modality, "--extended",
                        "--disease", "Pneumonia"))
                _sync(device)
                val_s[modality] = time.perf_counter() - t0
                hits[f"validate_{modality}"] = probe.hits()
                print(f"  cli.validate --modality {modality} --extended "
                      f"({val_s[modality]:.2f} s, host clock): "
                      + "; ".join(buf.getvalue().strip().splitlines()))
            launches["validation"] = counted()  # ... and end
        # the direct recomputation, with the validation's cuDNN algorithms
        base = construct_training_parameters(flags("runs_a")[2:])
        models = _encoders(base, device)
        direct = {m: recompute_report(base, models[m], m, "Pneumonia", device)
                  for m in ("mm", "um")}
    finally:
        torch.backends.cudnn.deterministic = deterministic
        preempt.uninstall()
        preempt.clear()
    runs_s = time.perf_counter() - started
    rates = encoder_images_per_s(models, batch, device, card)

    # ---- Grad-CAM: the MI encoder and its trained classifier ----------------
    dataset = CXRImageDiseaseDataset(
        base.image_dir, base.dataset_metadata, "Pneumonia", stats,
        img_size=base.img_size, compact=True,
        crop_cache=crop_cache.from_config(base))
    loader = Loader(dataset, batch, seed=SEED, num_workers=workers,
                    train=False, drop_last=False)
    val_batches = [torch.from_numpy(b["image"]).to(device)
                   for b in loader.epoch(0)]
    x8 = device_normalize(val_batches[0][:CAM_IMAGES])
    clf = BasicMLP(768, DEFAULT_CLASSIFIER_LAYERS)
    clf.load_state_dict(ckpt.load_state_dict_bin(find_classifier_checkpoint(
        cli_train.mm_run_dir(base), "Pneumonia")), strict=True)
    clf.to(device).eval()
    t0 = time.perf_counter()
    heat = cam.resnet_grad_cam(models["mm"], clf, x8)
    _sync(device)
    cam_s = time.perf_counter() - t0
    m64 = copy.deepcopy(models["mm"]).double()
    m64.dtype = torch.float64
    clf64 = copy.deepcopy(clf).double()
    heat64 = cam.resnet_grad_cam(m64, clf64, x8.double())
    with torch.no_grad():
        p64 = clf64(m64(x8.double())[1])[:, 0].cpu().numpy()
    del m64
    cam_err = np.abs(heat - heat64).reshape(len(heat), -1).max(axis=1)
    cam_lim = cam_limits(heat64, p64)
    cam_diff = float(cam_err.max())
    print(f"  Grad-CAM on {CAM_IMAGES} images: heatmaps {heat.shape} in "
          f"[{heat.min():.3f}, {heat.max():.3f}], {cam_s * 1e3:.1f} ms "
          f"(host clock); f32 against float64, each image's max |diff| "
          f"(limit; float64's 1 - p, its map's maximum): "
          + ", ".join(f"{e:.2e} ({lim:.2e}; {1 - p:.2e}, {h.max():.3g})"
                      for e, lim, p, h in zip(cam_err, cam_lim, p64, heat64))
          + f"  [{card}]")

    # ---- the stem kernel on the embedding path -------------------------------
    stem_model = ResNet256_6_2_1(output_channels=base.output_channels,
                                 pallas_stem=True).to(device)
    stem_embed = make_embedding_fn("multimodal", stem_model,
                                   models["mm"].state_dict())
    sc.reset_launch_counts()            # the stem's embedding path starts
    with_stem = [stem_embed(b) for b in val_batches]
    _sync(device)
    stem_launches = dict(sc.LAUNCHES)   # ... and ends here
    cudnn = [_embed_direct(models["mm"], "mm", b) for b in val_batches]
    stem_err = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
                   for a, b in zip(with_stem, cudnn))
    print(f"  the MI embedding with the stem kernel, {len(val_batches)} "
          f"batches ({sum(len(b) for b in val_batches)} images): launches "
          f"{stem_launches or 'none'}; against the cuDNN stem max |diff| / "
          f"max(1, |ref|) {stem_err:.2e} (limit {STEM_EMB_TOL:g})  [{card}]")

    # ---- what the runs printed, and the checks --------------------------------
    for stage in ("classifier_mm", "classifier_um"):
        s = splits[stage]
        accs = ", ".join(f"{d} {r[1]:.4f} ({os.path.basename(r[2] or '-')})"
                         for d, r in zip(cli_train.DISEASES, runs[stage]))
        epoch_s = seconds[stage] / (len(runs[stage]) * CLF_EPOCHS)
        run_dir = (cli_train.mm_run_dir if stage == "classifier_mm"
                   else cli_train.um_run_dir)(base)
        with open(os.path.join(run_dir, "classifier_Pneumonia.jsonl")) as f:
            recs = [json.loads(r) for r in f if '"epoch"' in r]
        print(f"  {stage}, Pneumonia's epochs (train loss, train / "
              f"validation accuracy): " + ", ".join(
                  f"{r['train_loss']:.4f} {r['train_acc']:.3f} / "
                  f"{r['val_acc']:.3f}" for r in recs))
        print(f"  {stage}: {seconds[stage]:.2f} s for {len(runs[stage])} "
              f"diseases x {CLF_EPOCHS} epochs ({s['step_calls']} MLP steps), "
              f"{epoch_s:.2f} s an epoch with its saves and validation "
              f"({studies / epoch_s:.1f} images/s); "
              f"dataset.load {s['load']:.3f} thread-s over {workers} loader "
              f"threads ({s['reads']} reads, {_ms_a_read(s)} through the "
              f"host library), {s['embed_calls']} embedding calls "
              f"{s['embed']:.3f} s "
              f"({s['embed'] / max(1, s['embed_calls']) * 1e3:.2f} ms a call), "
              f"MLP steps {s['steps']:.3f} s, {s['save_calls']} saves "
              f"{s['saves']:.3f} s (each call ending in a synchronize, host "
              f"clock); best validation accuracy {accs}  [{card}]")
    if probe.prof.trace_path:
        calls = span_split(probe.prof.trace_path, EMBED_SPAN)
        gaps = sorted((g for c in calls for g in c["gaps"]), reverse=True)
        rng_of = lambda k: (f"{min(c[k] for c in calls):.2f}–"
                            f"{max(c[k] for c in calls):.2f}")
        print(f"  classifier_mm's embedding calls {EMBED_TRACE_FROM}–"
              f"{EMBED_TRACE_FROM + len(calls) - 1} under torch.profiler "
              f"({workers} loader threads reading): wall {rng_of('wall')} ms, "
              f"the main thread inside operators {rng_of('ops')} ms, "
              f"device {rng_of('device')} ms; gaps over 0.1 ms between the "
              f"main thread's operators: {len(gaps)} "
              f"({sum(g > 1 for g in gaps)} over 1 ms), {sum(gaps):.2f} ms in "
              f"all, median {statistics.median(gaps or [0]):.3f} ms, the "
              f"largest " + ", ".join(f"{g:.2f}" for g in gaps[:6])
              + f" ms (the interpreter's switch interval "
              f"{sys.getswitchinterval() * 1e3:g} ms); inside the gaps over "
              f"1 ms, ms of each thread's operators and CUDA runtime calls: "
              + ", ".join(f"{k} {v:.1f}" for k, v in sum(
                  (c["during"] for c in calls), collections.Counter())
                  .most_common(6)) + f"  [{card}]")
    print(f"  labelled studies: {studies} for each disease, positives (the "
          f"darkest windows) {positives}; crop cache (hits, misses): {hits}; "
          f"port-kernel launches, each path counted from 0: "
          + ", ".join(f"{k} {v or 'none'}" for k, v in launches.items()))
    differ = [k for k in want if k not in got or not (
        torch.equal(want[k], got[k]) if torch.is_tensor(want[k])
        else want[k] == got[k])]
    print(f"  run B ({CLF_DISEASE}, MI encoder): SIGTERM after step "
          f"{stop_step}, stopped at step {b_step}, files "
          f"{[f for f in b_files if 'preempt' in f]}; run C resumed to step "
          f"{got['step']} (A {want['step']}); C against A: {len(want)} "
          f"tensors and counts, {len(differ)} differ"
          + (f", the first {differ[0]}" if differ else ", bit for bit")
          + f"; best (accuracy, checkpoint) A {want_best}, C {got_best}")
    line = lambda m: (f"accuracy {reports[m]['accuracy']:.4f} (tp "
                      f"{reports[m]['tp']}, tn {reports[m]['tn']}, fp "
                      f"{reports[m]['fp']}, fn {reports[m]['fn']}), GDV "
                      f"{reports[m]['separability']:.6e} (recomputed "
                      f"{direct[m]['separability']:.6e}), AUC "
                      f"{reports[m]['auc']:.6f} (recomputed "
                      f"{direct[m]['auc']:.6f}), sigmoid quartiles "
                      + "/".join(f"{q:.3g}" for q in direct[m]["p_quartiles"])
                      + f", class-mean distance / spread within a class "
                      f"{direct[m]['class_separation']:.3f}")
    print(f"  Pneumonia, MM against UM ({reports['mm']['positives']} + "
          f"{reports['mm']['negatives']} images): MM {line('mm')}; UM "
          f"{line('um')}; validation {val_s['mm']:.2f} / {val_s['um']:.2f} "
          f"s (host clock)  [{card}]")
    bad = []
    for modality in ("mm", "um"):
        rep, want_rep = reports[modality], direct[modality]
        exact = ("accuracy", "tp", "tn", "fp", "fn", "positives",
                 "negatives")
        if any(rep[k] != want_rep[k] for k in exact) \
                or not abs(rep["auc"] - want_rep["auc"]) <= REPORT_AUC_TOL \
                or not abs(rep["separability"] - want_rep["separability"]) \
                <= REPORT_GDV_RTOL * abs(want_rep["separability"]):
            bad.append(f"the {modality} report {rep} is not its direct "
                       f"recomputation {want_rep}")
        if not rep["auc"] >= CLF_MIN_AUC:
            bad.append(f"the {modality} classifier's ranking does not follow "
                       f"the labels: {rep}")
        if modality == "mm" and rep["tp"] + rep["fp"] in (
                0, rep["tp"] + rep["tn"] + rep["fp"] + rep["fn"]):
            bad.append(f"the mm classifier calls one class only, so its "
                       f"tallies do not test the embedding: {rep}")
    if differ:
        bad.append(f"run C differs from run A in {len(differ)} tensors, the "
                   f"first {differ[0]}")
    if got_best != want_best or b_step != stop_step \
            or f"classifier_{CLF_DISEASE}_preempt.ckpt" not in b_files:
        bad.append(f"runs B/C: stopped at {b_step}, files {b_files}, best "
                   f"A {want_best} C {got_best}")
    if any(launches.values()):
        bad.append(f"the classifier paths launched port kernels: {launches}")
    if any(m for _, m in hits.values()) or not all(h for h, _ in
                                                   hits.values()):
        bad.append(f"crop-cache misses (hits, misses): {hits}")
    for stage, out in runs.items():
        steps = [r[0].step for r in out]
        if len(out) != len(cli_train.DISEASES) or len(set(steps)) != 1 \
                or steps[0] == 0:
            bad.append(f"{stage} ran {steps}")
    if heat.shape != (CAM_IMAGES, 8, 8) or not np.isfinite(heat).all() \
            or heat.min() < 0 or heat.max() > 1 \
            or not (cam_err <= cam_lim).all():
        bad.append(f"Grad-CAM: shape {heat.shape}, range [{heat.min()}, "
                   f"{heat.max()}], f32 against f64 {cam_err} (limits "
                   f"{cam_lim})")
    if cuda and stem_launches != {sc.KERNELS["fwd"]: len(val_batches)}:
        bad.append(f"the stem embedding's launches {stem_launches}, want "
                   f"{len(val_batches)} forward")
    if stem_err > STEM_EMB_TOL:
        bad.append(f"the stem kernel's embedding is {stem_err} from the "
                   f"cuDNN stem's")
    seconds_all = time.perf_counter() - started
    print(f"  phase 14: {seconds_all:.1f} s (host clock; the runs, "
          f"validations and recomputations {runs_s:.1f} s)  [{card}]")
    if bad:
        raise AssertionError("; ".join(bad))
    return {"stem_launches": stem_launches, "seconds": seconds_all,
            "splits": splits, "runs_seconds": seconds, "validate_s": val_s,
            "reports": {m: {k: reports[m][k] for k in
                            ("accuracy", "separability", "auc")}
                        for m in reports},
            "images_per_s": rates, "cam_diff": cam_diff,
            "stem_err": stem_err, "bit_equal": not differ}


def drive_classifier_alone(root: str, device) -> dict:
    """Phase 14 without phases 12 and 13: ``drive_classifier`` on seeded
    random encoders (the MI ResNet by ``random_state_dict``, the
    full-width AE by ``train.ae.init_ae_params``, their ``.bin`` files
    written here)."""
    from mimm_tpu_torch.train import ae

    gen = torch.Generator().manual_seed(SEED)
    mi_run = os.path.join(root, "mi", "run_a")
    ae_run = os.path.join(root, "ae", "ae_a")
    ckpt.save_state_dict_bin(
        os.path.join(mi_run, "pytorch_MI_image_model.bin"),
        random_state_dict(ResNet256_6_2_1(), gen))
    model = ae.build_ae_model(TrainingConfig(compute_dtype="float32"), "cpu")
    ae.init_ae_params(model, gen)
    ckpt.save_state_dict_bin(
        os.path.join(ae_run, f"autoencoder_path_{AE_EPOCHS}.bin"),
        model.state_dict())
    del model
    return drive_classifier(os.path.join(root, "clf"), device, mi_run,
                            ae_run)


def _keep_only(root: str, keep_dir: str, *names: str) -> None:
    """Delete everything under ``root`` but ``keep_dir``'s ``names`` and
    ``root``'s own ``names`` (the files a later phase reads)."""
    for entry in os.listdir(root):
        path = os.path.join(root, entry)
        if entry in names:
            continue
        if os.path.abspath(path) == os.path.abspath(keep_dir):
            for f in os.listdir(path):
                if f not in names:
                    os.remove(os.path.join(path, f))
        elif os.path.isdir(path):
            shutil.rmtree(path)
        else:
            os.remove(path)


# ---- phase 15: the host library and profiling ------------------------------

HOST_DRAWS = 256       # train draws of phase 12's window geometry, each way
HOST_IMAGES = 4        # 12-bit uint16 CXR_SHAPE sources they are cut from
HOST_TIMED = 64        # reads timed each way at 1 and at 4 threads
HOST_THREADS = (1, 4)
PROFILE_STEPS = 3
PROFILE_LONG = 128     # pairs in each of the 256 and 320 buckets: 2 batches
# the device kernels each wrapper's launch puts in a torch.profiler trace,
# each by its demangled or its mangled name
TRACE_KERNELS = {
    fa.KERNELS[torch.bfloat16]: (("fwd_bf16_kernel",),),
    fa.BWD_KERNELS[torch.bfloat16]: (("bwd_rows_bf16_kernel",),
                                     ("bwd_cols_bf16_kernel",)),
    sc.KERNELS["fwd"]: (("shallow_conv::fwd_kernel",
                         "12shallow_conv10fwd_kernel"),),
    sc.KERNELS["dw"]: (("shallow_conv::dw_kernel",
                        "12shallow_conv9dw_kernel"),
                       ("shallow_conv::dw_reduce_kernel",
                        "12shallow_conv16dw_reduce_kernel"))}


def _all_launches() -> dict:
    return {**fa.LAUNCHES, **sc.LAUNCHES, **pc.LAUNCHES, **ff.LAUNCHES}


def host_windows(root: str, img_size: int = 256) -> list:
    """HOST_IMAGES crop-cache entries of 12-bit uint16 CXR_SHAPE sources
    as ``support_window`` cuts them, under ``root``: (cache, img_ids,
    windows) with windows as (win, origin)."""
    from mimm_tpu_torch.data import crop_cache

    rng = np.random.default_rng(SEED + 31)
    h, w = CXR_SHAPE
    oy, ox, wh, ww = crop_cache.support_window(h, w, img_size)
    cache = crop_cache.DecodedCropCache(os.path.join(root, "cache"), img_size)
    ids, wins = [], []
    for k in range(HOST_IMAGES):
        win = rng.integers(0, 4096, (wh, ww)).astype(np.uint16)
        img_id = f"host{k}.png"
        crop_cache.write(cache._path(img_id), win, (oy, ox, h, w))
        ids.append(img_id)
        wins.append((win, (oy, ox)))
    return cache, ids, wins


def _plain_window(win, origin, rng, img_size, train, raw):
    """The numpy path of ``reference_transform_window`` (the host library's
    plain version)."""
    from mimm_tpu_torch.data import transforms as tf

    h, w = CXR_SHAPE
    if train:
        angle, tx, ty = tf.sample_affine_params(rng, w, h)
        out = tf.affine_crop(win, angle, tx, ty, img_size,
                             src_origin=origin, full_shape=(h, w))
    else:
        top = int(round((h - img_size) / 2.0)) - origin[0]
        left = int(round((w - img_size) / 2.0)) - origin[1]
        out = win[top:top + img_size, left:left + img_size]
    return np.ascontiguousarray(out) if raw else tf.max_normalize(out)


def host_checks(root: str, draws: int = HOST_DRAWS, timed: int = HOST_TIMED,
                img_size: int = 256) -> dict:
    """The host library on this host's CPU: a build from scratch into a
    directory of its own, then every train draw (raw and normalized) and
    the eval crop of the windows against the numpy path bit for bit, and
    ms a read at 1 and 4 threads: the crop-cache read alone, the transform
    alone both ways, and the two together both ways.  Raises on a
    differing pixel."""
    import concurrent.futures

    from mimm_tpu_torch.data import native_ops
    from mimm_tpu_torch.data import transforms as tf

    gxx = subprocess.run([native_ops._gxx(), "--version"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    build_dir, real_dir = os.path.join(root, "host_build"), _build.BUILD_DIR
    _build.BUILD_DIR = build_dir
    t0 = time.perf_counter()
    try:
        built = native_ops.build()
    finally:
        _build.BUILD_DIR = real_dir
    build_s = time.perf_counter() - t0
    print(f"  host library: {os.path.basename(built)} built from scratch in "
          f"{build_s:.2f} s (host clock; {gxx}, "
          f"{' '.join(native_ops.GXX_FLAGS)})")

    cache, ids, wins = host_windows(root, img_size)
    h, w = CXR_SHAPE
    bad, compared = [], 0
    for d in range(draws):
        win, origin = wins[d % len(wins)]
        for raw in (False, True):
            got = tf.reference_transform_window(
                win, origin, (h, w), np.random.default_rng((SEED, d)),
                img_size, train=True, raw=raw)
            want = _plain_window(win, origin, np.random.default_rng((SEED, d)),
                                 img_size, True, raw)
            compared += 1
            if got.dtype != want.dtype or not np.array_equal(got, want):
                where = np.argwhere(got != want)
                bad.append(f"draw {d} raw={raw}: {len(where)} pixels, first "
                           f"{where[0].tolist() if len(where) else '-'}")
    for win, origin in wins:
        for raw in (False, True):
            got = tf.reference_transform_window(win, origin, (h, w), None,
                                                img_size, train=False,
                                                raw=raw)
            want = _plain_window(win, origin, None, img_size, False, raw)
            compared += 1
            if got.dtype != want.dtype or not np.array_equal(got, want):
                bad.append(f"eval raw={raw}")
    print(f"  native against numpy on this host's CPU: {compared} crops "
          f"({draws} train draws of a {h}x{w} uint16 source's 256 window, "
          f"raw and normalized, and {len(wins)} eval crops each way), "
          f"{len(bad)} differ" + (f": {bad[:3]}" if bad else ", bit for bit"))
    if bad:
        raise AssertionError(f"the host library differs from numpy: {bad[:3]}")

    h, w = CXR_SHAPE
    loaded = [cache.read("", img_id) for img_id in ids]

    def transform(i, native):
        win, oy, ox = loaded[i % len(loaded)][:3]
        rng = np.random.default_rng((SEED, 1, i))
        if native:
            return tf.reference_transform_window(win, (oy, ox), (h, w), rng,
                                                 img_size, raw=True)
        return _plain_window(win, (oy, ox), rng, img_size, True, True)

    ways = {"cache read": lambda i: cache.read("", ids[i % len(ids)]),
            "native transform": lambda i: transform(i, True),
            "numpy transform": lambda i: transform(i, False),
            "read + native": lambda i: (cache.read("", ids[i % len(ids)]),
                                        transform(i, True)),
            "read + numpy": lambda i: (cache.read("", ids[i % len(ids)]),
                                       transform(i, False))}
    ms = {}
    for way, fn in ways.items():
        fn(0)
        for threads in HOST_THREADS:
            t0 = time.perf_counter()
            if threads == 1:
                for i in range(timed):
                    fn(i)
            else:
                with concurrent.futures.ThreadPoolExecutor(threads) as pool:
                    list(pool.map(fn, range(timed)))
            ms[way, threads] = (time.perf_counter() - t0) / timed * 1e3
    print(f"  ms a read ({timed} reads of a window, raw train transform; "
          f"wall clock over reads, {HOST_THREADS[0]} thread / "
          f"{HOST_THREADS[1]} threads): " + ", ".join(
              f"{way} {ms[way, 1]:.3f} / {ms[way, 4]:.3f}" for way in ways)
          + f"  (host clock, {os.cpu_count()} cores)")
    return {"build_s": build_s, "compared": compared, "ms": ms}


def tokenize_both(root: str, bert_kw: dict, pairs: int, long: int,
                  seq: int) -> dict:
    """Phase 12's corpus (its writer and seed) tokenized natively (serial
    and on 4 threads) and by the Python encoder (serial: CUDA is
    initialized, so no forked pool): the same features, and each time."""
    from mimm_tpu_torch.data.features import (convert_examples_to_features,
                                              create_examples_from_tsv)
    from mimm_tpu_torch.data.tokenizer import (NativeWordPieceTokenizer,
                                               WordPieceTokenizer)

    corpus = write_cli_corpus(os.path.join(root, "corpus12"), pairs, long,
                              bert_kw["vocab_size"], 256, SEED + 23)
    examples = create_examples_from_tsv(os.path.join(corpus["text"],
                                                     "all_data.tsv"))
    out, seconds = {}, {}
    for name, tok, workers in (
            ("native_4_threads", NativeWordPieceTokenizer, 4),
            ("native_serial", NativeWordPieceTokenizer, 0),
            ("python_serial", WordPieceTokenizer, 0)):
        tokenizer = tok.from_pretrained(corpus["bert"])
        t0 = time.perf_counter()
        out[name] = convert_examples_to_features(examples, seq, tokenizer,
                                                 num_workers=workers)
        seconds[name] = time.perf_counter() - t0
    same = out["native_4_threads"] == out["native_serial"] \
        == out["python_serial"]
    print(f"  WordPiece over phase 12's corpus ({len(examples)} reports, "
          f"L={seq}): " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                    seconds.items())
          + f" (host clock); the same features: {same}")
    if not same:
        raise AssertionError("native and Python WordPiece features differ")
    return seconds


def trace_kernel_counts(path: str) -> dict:
    """{wrapper: [count of each of its device kernels]} in the kernel
    events of a torch.profiler trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = collections.Counter(e.get("name", "") for e in events
                                if e.get("cat") == "kernel")
    return {key: [sum(n for name, n in names.items()
                      if any(p in name for p in alternatives))
                  for alternatives in kernels]
            for key, kernels in TRACE_KERNELS.items()}


class _LaunchWindow(profiling.StepProfiler):
    """Installed as the Manager's StepProfiler: it keeps the port kernels'
    launch counts when the trace starts and when it stops, so the counters
    over the traced dispatches can be held against the trace."""

    made: list = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.counts_at_start = self.counts_at_stop = None
        _LaunchWindow.made.append(self)

    def start(self):
        if not self.active and self.remaining > 0:
            self.counts_at_start = dict(_all_launches())
        super().start()

    def close(self, sync_value=None):
        was = self.active
        super().close(sync_value)
        if was:
            self.counts_at_stop = dict(_all_launches())


def dropped_launches(path: str) -> list:
    """The kernel launches of a torch.profiler trace (``cudaLaunchKernel``
    and its kin on the host) whose kernel has no event in it: for each,
    its ms after the trace's first event."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    first = min(e["ts"] for e in events if "ts" in e)
    kernels = {e["args"].get("correlation") for e in events
               if e.get("cat") == "kernel" and "args" in e}
    return sorted((e["ts"] - first) / 1e3 for e in events
                  if e.get("cat") == "cuda_runtime"
                  and "LaunchKernel" in e.get("name", "")
                  and e.get("args", {}).get("correlation") not in kernels)


def profiled_mi_run(root: str, device, bert_kw=BERT_BASE, batch=BATCH,
                    workers=MANAGER_WORKERS, profile_long=PROFILE_LONG
                    ) -> dict:
    """One epoch of ``train_mutual_information`` (production preset,
    ``pallas_stem``, ``scan_steps`` 8) over ``profile_long`` pairs in each
    of the 256 and 320 buckets with ``profile_steps`` 3 and
    ``tensorboard``.  Returns its launches, the launch counters over the
    traced dispatches, the trace's kernel counts, the launches the trace
    holds no kernel for, and the check of its event files against
    mi.jsonl; raises on none of them."""
    from mimm_tpu_torch import tbevents
    from mimm_tpu_torch.cli.multi_modal import train_mutual_information

    corpus = write_cli_corpus(os.path.join(root, "corpus15"), 0,
                              profile_long, bert_kw["vocab_size"], 256,
                              SEED + 37)
    with open(os.path.join(corpus["bert"], "bert_config.json"), "w") as f:
        json.dump(bert_kw, f)
    save = os.path.join(root, "run")
    cfg = TrainingConfig.production(
        pallas_stem=True, batch_size=batch, num_train_epochs=1,
        data_loader_workers=workers, prefetch=2, seed=SEED,
        image_dir=corpus["images"], text_data_dir=corpus["text"],
        dataset_metadata=corpus["metadata"],
        decoded_crop_cache=corpus["cache"],
        bert_pretrained_dir=corpus["bert"], save_directory=save,
        profile_steps=PROFILE_STEPS, tensorboard=True)
    real = mi.StepProfiler
    _LaunchWindow.made.clear()
    mi.StepProfiler = _LaunchWindow
    try:
        for mod in (fa, sc, pc, ff):
            mod.reset_launch_counts()       # the profiled path starts here
        t0 = time.perf_counter()
        _, state = train_mutual_information(cfg, device)
        _sync(device)
        run_s = time.perf_counter() - t0
        launches = _all_launches()          # ... and ends here
    finally:
        mi.StepProfiler = real
    (prof,) = _LaunchWindow.made
    traced = {k: prof.counts_at_stop.get(k, 0) - prof.counts_at_start.get(k, 0)
              for k in TRACE_KERNELS}
    recs = _jsonl(save)
    tb_dir = os.path.join(save, "tb", "mi")
    (events,) = [os.path.join(tb_dir, f) for f in os.listdir(tb_dir)]
    got = {(t, s): v for _, s, t, v in tbevents.read_scalars(events)}
    want, ordinal = {}, 0
    for rec in recs:
        step = rec.get("step", rec.get("epoch", ordinal))
        ordinal = step + 1
        want.update({(k, step): float(np.float32(v)) for k, v in rec.items()
                     if k not in ("time", "step", "epoch")
                     and isinstance(v, (int, float))})
    out = {"launches": launches, "traced": traced, "steps": state.step,
           "trace_counts": trace_kernel_counts(prof.trace_path),
           "dropped": dropped_launches(prof.trace_path),
           "trace_mb": os.path.getsize(prof.trace_path) / 2 ** 20,
           "trace": os.path.basename(prof.trace_path), "run_s": run_s,
           "tb": (len(got), len(want), bool(want) and got == want),
           "finite": all(math.isfinite(r["epoch_loss"]) for r in recs
                         if "epoch_loss" in r)}
    shutil.rmtree(save)
    return out


def profiled_mi_in_child(root: str, device, bert_kw=BERT_BASE, batch=BATCH,
                         workers=MANAGER_WORKERS, profile_long=PROFILE_LONG
                         ) -> dict:
    """``profiled_mi_run`` in a process of its own, as a user runs the
    entry point (this process has run phases 1-14 and a dozen profiler
    windows by now); its printing goes to this process's output."""
    out = os.path.join(root, "profiled_mi.json")
    args = dict(root=root, device=str(device), bert_kw=bert_kw, batch=batch,
                workers=workers, profile_long=profile_long)
    code = (f"import json, sys; sys.path.insert(0, {REPO!r}); "
            f"import torch; torch.backends.cuda.matmul.allow_tf32 = False; "
            f"torch.backends.cudnn.allow_tf32 = False; "
            f"torch.backends.mkldnn.enabled = "
            f"{torch.backends.mkldnn.enabled}; "
            f"import chip_smoke as c; "
            f"run = c.profiled_mi_run(**json.loads({json.dumps(args)!r})); "
            f"json.dump(run, open({out!r}, 'w'))")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)
    with open(out) as f:
        return json.load(f)


def drive_host_and_profiling(root: str, device, bert_kw=BERT_BASE,
                             batch=BATCH, workers=MANAGER_WORKERS,
                             draws=HOST_DRAWS, timed=HOST_TIMED,
                             corpus_pairs=CLI_PAIRS, corpus_long=CLI_LONG,
                             profile_long=PROFILE_LONG) -> dict:
    """Phase 15: ``host_checks``, ``tokenize_both`` over phase 12's corpus,
    then ``profiled_mi_run`` in a process of its own
    (``profiled_mi_in_child``): its trace must name the bf16 flash kernels
    and the stem's forward and dW with the counts the launch counters give
    over the traced dispatches, and its event files must decode to
    mi.jsonl's scalars.  Returns the run's launches and the numbers."""
    cuda = torch.device(device).type == "cuda"
    card = card_line() if cuda else "cpu"
    started = time.perf_counter()
    host = host_checks(root, draws=draws, timed=timed)
    tok_s = tokenize_both(root, bert_kw, corpus_pairs, corpus_long,
                          TrainingConfig.production().max_seq_length)
    run = profiled_mi_in_child(root, device, bert_kw, batch, workers,
                               profile_long)
    bad = []
    print(f"  MI from disk with profile_steps {PROFILE_STEPS} and "
          f"tensorboard: {run['steps']} steps over {2 * profile_long} pairs "
          f"(256 and 320 buckets, scan_steps 8: single-batch dispatches) in "
          f"{run['run_s']:.1f} s (host clock, tokenizing and the save "
          f"included); trace {run['trace']} {run['trace_mb']:.1f} MiB  "
          f"[{card}]")
    if cuda:
        print(f"  launch counters over the traced dispatches: "
              f"{run['traced']}; the trace's kernels: {run['trace_counts']}; "
              f"launches without a kernel event: {len(run['dropped'])}"
              + (f" (ms after the trace's first event: "
                 f"{[round(t, 3) for t in run['dropped'][:8]]})"
                 if run["dropped"] else ""))
        for key, per_kernel in run["trace_counts"].items():
            if run["traced"][key] == 0 or any(n != run["traced"][key]
                                              for n in per_kernel):
                bad.append(f"{key}: trace {per_kernel}, counters "
                           f"{run['traced'][key]}")
    decoded, jsonl, equal = run["tb"]
    print(f"  tb/mi: {decoded} scalars decoded (every record's CRC "
          f"checked), mi.jsonl's {jsonl}: equal {equal}")
    if not equal:
        bad.append(f"tb/mi's {decoded} scalars against mi.jsonl's {jsonl}")
    if not run["finite"]:
        bad.append("a loss that is not finite")
    seconds = time.perf_counter() - started
    print(f"  phase 15: {seconds:.1f} s (host clock)  [{card}]")
    if bad:
        raise AssertionError("; ".join(bad))
    return {"launches": run["launches"], "traced": run["traced"],
            "trace_counts": run["trace_counts"], "host": host,
            "tokenize_s": tok_s, "seconds": seconds, "steps": run["steps"]}


# ---- main -------------------------------------------------------------------

# ---- phase 16: data parallelism, a world of 2 ranks on the one card --------

WORLD = 2
WORLD_PAIRS = 320      # (b)'s corpus: by the bucket mix, and WORLD_LONG more
WORLD_LONG = 64        # in each of the 256 and 320 buckets: a batch of each
# (5 steps an epoch: run B's agreed stop at dispatch 8 falls in epoch 2;
# 384 pairs, 6 steps, before the run's time limit bound)
WORLD_EPOCHS = 2
WORLD_W1_EPOCHS = 1    # world 1's pairs/s, one epoch (the time limit)
WORLD_SIGNAL_AFTER = 3     # run B: rank 1 alone sends itself SIGTERM here
WORLD_TIMEOUT = 420        # seconds a world launch may take
# what the ranks build: full width on the card (``drive_world(spec=)``
# takes small ones for a rehearsal on the CPU)
WORLD_SPEC = {"device": "cuda", "bert_kw": TRAIN_BERT, "cli_bert": BERT_BASE,
              "batch": BATCH, "seq": SEQ, "gc": GC_CONFIGS[-1],
              "gc_first": GC_CONFIGS[0][0], "gc_seq": GC_SEQ, "ae": None,
              "pairs": WORLD_PAIRS, "long": WORLD_LONG, "workers": 3}
# (a), (e): what a step computes, world 2 against world 1 from one state,
# and against world 1 computed "in halves" (``split_rows``): one rank
# computing as the world does, each rank's block of rows through every
# convolution, linear layer and stem call, BatchNorm's statistics the
# blocks' [E[x], E[x²]] summed in rank order as sync-BN's all-reduce sums
# them, and nothing of the world's code (no process group, gather or
# all-reduce).  Both sides run cuDNN's deterministic algorithms.  At this
# random start the DV bound is ~1e-3, a difference of two terms of order
# 1 whose gradient cancels, so the rounding of sync-BN's statistics (two
# means of 32 rows averaged, where one rank takes one mean of 64),
# through E[x²] − E[x]², becomes % of the gradient, and Adam's first step
# lr · sign(g) flips where g is near 0.  Measured on an NVIDIA H100 80GB
# HBM3 at 700 W (chip_smoke.py phase 16): world 2 against world 1 max
# |Δg| / max |g| image 1.67e-2, text 1.43e-2, critic 9.41e-2 (cosine
# 0.99979-0.99988, norm ratio 1.0005-1.0020), 9.8e-3 and 4.2e-3 of the
# image tower's and the critic's weights > 1e-6 apart after Adam step 1;
# the halves against world 1 the same to three digits; world 2 against
# the halves 6.3e-6, 1.0e-7, 0, rank 0's embeddings and the losses equal
# bit for bit, 1.1e-5 of the image tower's weights apart; with the
# halves' shapes but one rank's statistics, 2e-6 against world 1 and
# 1.7e-2 / 1.4e-2 / 9.4e-2 against world 2.  So world 2 is held to the
# halves as a kernel is to its plain version: rank 0's embeddings within
# WORLD_HALVES_EMB, the gradients within WORLD_HALVES_GRAD, both losses
# within phase 5's 1e-5, after each Adam step the largest |Δ| within
# phase 5's 2.5·lr and after step 1 the shares within phase 10's (5e-3
# for the image tower with the stem and its statistics, 1e-3 for the
# text tower and the critic).  And to world 1 where the rounding allows:
# the gradients' cosine at least WORLD_COS and their norms' ratio within
# WORLD_NORM (an N-times or twice-summed gradient gives a ratio of N),
# the running statistics (max |Δ| over each tensor's largest |value|)
# within WORLD_BN_RTOL, the loss of step 1 within 1e-5 and of step 2
# within JAX's second-step band (tests/test_sharding.py:34: rtol 5e-4,
# atol 5e-5), the largest |Δ| after step 1 within 2.5·lr and after step 2
# within twice that.  The float64 CPU test holds world 2 to world 1 to
# 1e-10 (tests/test_torch_data_parallel.py).
WORLD_HALVES_EMB = 1e-6
WORLD_HALVES_GRAD = 1e-4
WORLD_HALVES_SHARE = {"image": STEM_FLIP_SHARE,
                      "batch_stats": STEM_FLIP_SHARE,
                      "text": STEP_FLIP_SHARE, "critic": STEP_FLIP_SHARE}
WORLD_BN_RTOL = 1e-5
WORLD_LOSS2 = (5e-4, 5e-5)
WORLD_COS = 0.999
WORLD_NORM = (0.99, 1.01)
# (e): the AE's MSE gradient does not cancel (world 2 against world 1
# 2.08e-4, the halves against world 1 the same; world 2 against the
# halves 1.8e-6, 4.5e-6 of its weights apart after Adam step 1): held to
# world 1 at max |Δg| / max |g| within WORLD_AE_GRAD, to the halves
# within WORLD_HALVES_GRAD and its first Adam step's shares within phase
# 5's 1e-3
WORLD_AE_GRAD = 1e-3
# (e): the embedding pass, max |Δ| over max |embedding| (cuDNN may take
# other algorithms at B=32 and B=64)
WORLD_EMB_TOL = 1e-4


class GradTap:
    """An optimizer (``init``, ``update``) that keeps the gradients it is
    handed, as float32 on the CPU, and updates nothing."""

    def __init__(self):
        self.grads = {}

    def init(self, params):
        return {}

    def update(self, grads, state, params=None):
        self.grads.update({n: g.detach().float().cpu().clone()
                           for n, g in grads.items()})
        return {n: torch.zeros_like(g) for n, g in grads.items()}, state


@contextlib.contextmanager
def split_rows(rows: int, parts: int):
    """One process computing as a world of ``parts`` ranks does: every
    ``F.linear``, ``F.conv2d``, stem kernel (``shallow_conv3x3``) and AE
    patch convolution call whose first dimension is a multiple of the
    global batch ``rows`` runs on ``parts`` contiguous blocks of it,
    concatenated (each rank's GEMM and convolution shapes; autograd sums
    the blocks' weight gradients as the world's all-reduce does), and
    BatchNorm's training statistics are the blocks' [E[x], E[x²]] summed
    in rank order over ``parts``, as sync-BN's all-reduce takes them.
    With ``parts`` 1, nothing changes."""
    from mimm_tpu_torch.models import autoencoder, resnet

    def split(fn):
        def call(x, *a, **kw):
            if parts == 1 or x.shape[0] % rows:
                return fn(x, *a, **kw)
            return torch.cat([fn(b, *a, **kw) for b in x.chunk(parts)])
        return call

    saved = (F.linear, F.conv2d, resnet.shallow_conv3x3, resnet._batch_stats,
             autoencoder.patch_conv, autoencoder.patch_conv_transpose)

    def stats(xf):
        if parts == 1 or xf.shape[0] % rows:
            return saved[3](xf)
        blocks = [saved[3](b) for b in xf.chunk(parts)]
        return sum(blocks[1:], blocks[0]) / parts

    F.linear, F.conv2d = split(F.linear), split(F.conv2d)
    resnet.shallow_conv3x3 = split(resnet.shallow_conv3x3)
    resnet._batch_stats = stats
    autoencoder.patch_conv = split(autoencoder.patch_conv)
    autoencoder.patch_conv_transpose = split(autoencoder.patch_conv_transpose)
    try:
        yield
    finally:
        (F.linear, F.conv2d, resnet.shallow_conv3x3, resnet._batch_stats,
         autoencoder.patch_conv, autoencoder.patch_conv_transpose) = saved


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside, as (a) and (e) run both
    sides of each comparison."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


@contextlib.contextmanager
def _observe(model, rows: int, parts: int):
    """Inside, ``model``'s forward runs under ``split_rows(rows, parts)``;
    yields a list that keeps its first call's first two outputs, where it
    returns a tuple (float32, on the CPU)."""
    seen = []

    def observed(*a, **kw):
        with split_rows(rows, parts):
            out = type(model).forward(model, *a, **kw)
        if not seen and isinstance(out, tuple):
            seen.extend(o.detach().float().cpu().clone() for o in out[:2])
        return out
    model.forward = observed
    try:
        yield seen
    finally:
        del model.forward


def _grad_agree(a: dict, b: dict) -> tuple:
    """(cosine, norm ratio) of two gradient dicts as flat vectors, a
    against b, in float64."""
    va = torch.cat([a[n].double().reshape(-1) for n in sorted(b)])
    vb = torch.cat([b[n].double().reshape(-1) for n in sorted(b)])
    cos = (va @ vb / (va.norm() * vb.norm()).clamp_min(1e-300)).item()
    return cos, (va.norm() / vb.norm().clamp_min(1e-300)).item()


def _grad_diff(a: dict, b: dict) -> float:
    """max |a - b| over max |b| of two gradient dicts."""
    d = max((a[n] - b[n]).abs().max().item() for n in b)
    return d / max(max(b[n].abs().max().item() for n in b), 1e-30)


def _running_diff(a: dict, b: dict) -> float:
    """The largest max |Δ| / max |value| over the running statistics."""
    return max(((a[n] - b[n]).abs().max()
                / b[n].abs().max().clamp_min(1e-30)).item() for n in b)


def world_start(root: str, name: str, task: str, n: int, spec: dict,
                *args: str, backend: str = "",
                timeout: float = WORLD_TIMEOUT) -> tuple:
    """Start ``n`` ranks of this script's ``--world-worker <job> <task>``
    with the MIMM_* variables of ``initialize_distributed`` (a
    ``localhost:<port>`` coordinator), the job directory ``<root>/<name>``;
    ``world_wait`` collects them, so the caller may work meanwhile."""
    import socket

    job = os.path.join(root, name)
    os.makedirs(job, exist_ok=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(n):
        env = dict(os.environ, MIMM_COORDINATOR_ADDRESS=f"localhost:{port}",
                   MIMM_NUM_PROCESSES=str(n), MIMM_PROCESS_ID=str(rank))
        log = open(os.path.join(job, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--world-worker",
             job, task, backend, json.dumps(spec), *args], env=env,
            stdout=log, stderr=subprocess.STDOUT, cwd=REPO), log))
    _RUNNING.append(procs)
    return (job, name, task, procs, time.monotonic() + timeout)


_RUNNING: list = []     # the ranks of started worlds not yet collected


@atexit.register
def _stop_worlds() -> None:
    """Kill the ranks of every world still running when this process
    exits (a phase failed while its world ran)."""
    for procs in _RUNNING:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()


def world_wait(world: tuple) -> list:
    """Wait for a ``world_start`` world; every rank is killed once one
    fails or the time is up.  Returns each rank's json; raises with the
    failed ranks' last output."""
    job, name, task, procs, deadline = world
    _RUNNING.remove(procs)
    try:
        while any(p.poll() is None for p, _ in procs):
            if time.monotonic() > deadline or any(
                    p.returncode not in (None, 0) for p, _ in procs):
                break
            time.sleep(0.2)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [(r, p.returncode) for r, (p, _) in enumerate(procs)
           if p.returncode != 0]
    if bad:
        tails = []
        for r, _ in bad:
            with open(os.path.join(job, f"rank{r}.log")) as f:
                tails.append(f"--- rank {r}:\n{f.read()[-3000:]}")
        raise RuntimeError(f"world {name} ({task}) failed (rank, rc): {bad}\n"
                           + "\n".join(tails))
    out = []
    for rank in range(len(procs)):
        with open(os.path.join(job, f"rank{rank}.json")) as f:
            out.append(json.load(f))
    return out


def world_launch(root: str, name: str, task: str, n: int, spec: dict,
                 *args: str, backend: str = "",
                 timeout: float = WORLD_TIMEOUT) -> list:
    """``world_start`` then ``world_wait``."""
    return world_wait(world_start(root, name, task, n, spec, *args,
                                  backend=backend, timeout=timeout))


def world_equality_steps(mesh, device, spec: dict,
                         splits: tuple = (1,)) -> list:
    """(a): two float32 steps at dropout 0 of the production preset with
    ``pallas_stem`` from seeded weights, over the global batch (a study id
    shared by rows of the two ranks), this rank's rows of it with a
    ``mesh``; one run for each of ``splits``, in that many blocks
    (``split_rows``), on one model: the gradients of one step
    (``GradTap``), its embeddings of this rank's rows and the running
    statistics after it, then the losses and snapshots of two Adam steps
    from the same start."""
    bc = BertConfig(**{**spec["bert_kw"], "hidden_dropout_prob": 0.0,
                       "attention_probs_dropout_prob": 0.0})
    batch = spec["batch"]
    cfg = TrainingConfig.production(compute_dtype="float32", pallas_stem=True)
    model = mi.build_joint_model(cfg, bc, device=device)
    rng = np.random.default_rng(SEED + 41)
    data = []
    for _ in range(2):
        d = compact_batch(rng, batch, spec["seq"], bc.vocab_size, device)
        d["study_id"][batch // 2 + 1] = d["study_id"][1]
        data.append(mesh_lib.shard_batch(mesh, d))
    txs = mi.make_optimizers(cfg, steps_per_epoch=200_000 // batch)
    runs = []
    for split in splits:
        with _observe(model, batch, split) as seen:
            # the step's gradients, from the start
            taps = mi.MIOptimizers(img=GradTap(), mi=GradTap(), txt=GradTap())
            state = mi.create_mi_state(model, cfg, taps,
                                       torch.Generator().manual_seed(SEED + 43))
            state, _ = mi.make_mi_train_step(model, taps, cfg, mesh=mesh)(
                state, data[0])
            out = {"grads": {g: getattr(taps, k).grads for g, k in (
                ("image", "img"), ("text", "txt"), ("critic", "mi"))},
                "running": _snapshot(state)["batch_stats"],
                "emb": dict(zip(("image", "text"), seen))}
            # two Adam steps from the same start
            state = mi.create_mi_state(model, cfg, txs,
                                       torch.Generator().manual_seed(SEED + 43))
            step = mi.make_mi_train_step(model, txs, cfg, mesh=mesh)
            out["losses"], out["snaps"] = [], []
            for d in data:
                state, loss = step(state, d)
                out["losses"].append(loss.item())
                out["snaps"].append(_snapshot(state))
        runs.append(out)
    return runs


def world_grad_cache_step(mesh, device, spec: dict) -> tuple:
    """(d): phase 7's GradCache step (B=2048 in 32 chunks of 64, L=128)
    from its state and batch, this rank's rows; returns the loss, the
    kernels' launches and its seconds (host clock)."""
    bc = BertConfig(**spec["bert_kw"])
    batch, chunks = spec["gc"]
    rng = np.random.default_rng(SEED + 7)
    compact_batch(rng, spec["gc_first"], spec["gc_seq"], bc.vocab_size,
                  "cpu")                # phase 7 draws its B=256 batch first
    data = mesh_lib.shard_batch(mesh, compact_batch(
        rng, batch, spec["gc_seq"], bc.vocab_size, device))
    cfg = TrainingConfig.production(batch_size=batch, grad_cache_chunks=chunks)
    model = mi.build_joint_model(cfg, bc, device=device)
    txs = mi.make_optimizers(cfg, steps_per_epoch=200_000 // batch)
    state = mi.create_mi_state(model, cfg, txs,
                               torch.Generator().manual_seed(SEED))
    step = mi.make_mi_train_step(model, txs, cfg, mesh=mesh)
    for mod in (fa, sc, pc, ff):
        mod.reset_launch_counts()       # the grad_cache_world path
    t0 = time.perf_counter()
    state, loss = step(state, data)
    _sync(device)
    seconds = time.perf_counter() - t0
    return loss.item(), _all_launches(), seconds


def world_ae_steps(mesh, device, spec: dict, splits: tuple = (1,)) -> list:
    """(e): two float32 steps of the full-width autoencoder (sync-BN over
    a ``mesh``) from seeded weights, one run for each of ``splits`` (in
    that many blocks: ``split_rows``) on one model; each returns the
    gradients of one step, the running statistics after it, the losses of
    two Adam steps and the weights after the first."""
    from mimm_tpu_torch.models.autoencoder import ResNetAE
    from mimm_tpu_torch.train import ae

    cfg = TrainingConfig.production(compute_dtype="float32")
    model = ae.build_ae_model(cfg, device) if spec["ae"] is None else \
        ResNetAE(**spec["ae"]).to(device)
    rng = np.random.default_rng(SEED + 47)
    batch = spec["batch"]
    images = [_ae_images(rng, batch, device)[
        mesh_lib.local_rows(mesh, batch)] for _ in range(2)]
    runs = []
    for split in splits:
        with _observe(model, batch, split):
            tap = GradTap()
            state = ae.create_ae_state(model, cfg,
                                       torch.Generator().manual_seed(SEED + 45))
            ae.make_ae_train_step(model, tap, mesh=mesh)(state, images[0])
            sd = model.state_dict()
            out = {"grads": tap.grads, "running": {
                n: sd[n].detach().float().cpu().clone() for n in sd
                if "running" in n}, "losses": []}
            state = ae.create_ae_state(model, cfg,
                                       torch.Generator().manual_seed(SEED + 45))
            step = ae.make_ae_train_step(model, ae._ae_tx(cfg), mesh=mesh)
            for x in images:
                state, loss = step(state, x)
                out["losses"].append(loss.item())
                if not out.get("snap"):    # the first Adam step's weights
                    out["snap"] = {n: p.detach().float().cpu().clone()
                                   for n, p in model.named_parameters()}
        runs.append(out)
    return runs


def world_embedding(mesh, device, spec: dict) -> torch.Tensor:
    """(e): the classifier's frozen-encoder pass (``make_embedding_fn``,
    the MI image encoder from seeded weights, float32) over one batch."""
    from mimm_tpu_torch.train import classifier

    model = ResNet256_6_2_1()
    model.load_state_dict(random_state_dict(
        model, torch.Generator().manual_seed(SEED + 49)), strict=True)
    embed = classifier.make_embedding_fn("multimodal", model.to(device),
                                         mesh=mesh)
    images = _ae_images(np.random.default_rng(SEED + 51), spec["batch"],
                        device)
    out = embed(images)
    _sync(device)
    return out.float().cpu()


def _compare(mine: dict, ref: dict) -> dict:
    """A step run (``world_equality_steps`` / ``world_ae_steps``) against
    another: per gradient group max |Δg| / max |g| ("grad") and (cosine,
    norm ratio) ("agree"), the running statistics' ("running") and the
    losses' |Δ| ("loss")."""
    return {"grad": {g: _grad_diff(mine["grads"][g], ref["grads"][g])
                     for g in ref["grads"]},
            "agree": {g: _grad_agree(mine["grads"][g], ref["grads"][g])
                      for g in ref["grads"]},
            "running": _running_diff(mine["running"], ref["running"]),
            "loss": [abs(a - b) for a, b in zip(mine["losses"],
                                                ref["losses"])]}


def _compare_line(c: dict) -> str:
    return ("gradients' max |Δg| / max |g|, cosine, norm ratio: "
            + ", ".join(f"{g} {c['grad'][g]:.2e}, {cos:.6f}, {ratio:.6f}"
                        for g, (cos, ratio) in c["agree"].items())
            + f"; running statistics {c['running']:.2e}; losses' |Δ| "
            + ", ".join(f"{x:.2e}" for x in c["loss"]))


def _shares(mine: dict, ref: dict, groups) -> dict:
    """Per group (by name prefix), (max |Δ|, share > 1e-6) of two weight
    snapshots."""
    out = {}
    for group in groups:
        d = torch.cat([(mine[n] - ref[n]).abs().reshape(-1) for n in ref
                       if n.startswith(group)])
        out[group] = (d.max().item(), (d > 1e-6).float().mean().item())
    return out


def _shares_line(sh: dict) -> str:
    return ", ".join(f"{g} {v[0]:.2e}, {v[1]:.2e}" for g, v in sh.items())


def world_worker(job: str, task: str, backend: str, spec_json: str,
                 *args: str) -> int:
    """One rank of a world ``world_launch`` started: ``probe`` (the
    backend's collectives), ``steps`` ((a), (d) and (e), then (b)'s run A
    in the same world, its corpus under ``args[0]``) or ``cli`` (run
    ``args[0]`` of (b) through the entry point), phase 17's ``tp17`` and
    phase 18's ``pp18`` (their corpora under ``args[0]``).  Writes
    ``rank<r>.json`` (and rank 0 the tensors the parent compares)."""
    spec = json.loads(spec_json)
    device = spec["device"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device == "cpu":
        # torch's CPU oneDNN float32 convolution backward corrupts the
        # heap on some CPU builds; the card is unaffected
        torch.backends.mkldnn.enabled = False
    if task == "cli":
        return world_cli(job, args[0], args[1], backend, spec)
    mesh_lib.initialize_distributed(device=device, backend=backend or None)
    mesh = mesh_lib.make_mesh()
    dev = mesh_lib.rank_device(device)
    out = {"rank": mesh.rank, "size": mesh.size,
           "backend": mesh_lib.backend_name(), "device": str(dev)}
    if task == "tp17":
        out.update(tp_worker(job, mesh_lib.make_mesh({"model": TP_WORLD}),
                             dev, spec))
        out["cli"] = world_cli_run(job, task, args[0], backend, spec)
    elif task == "pp18":
        out.update(pp_worker(job, mesh_lib.make_mesh({"pipe": PP_WORLD}),
                             dev, spec))
        out["cli"] = world_cli_run(job, task, args[0], backend, spec)
    elif task == "probe":
        x = torch.full((4,), float(mesh.rank + 1), device=dev)
        torch.distributed.all_reduce(x)
        out["sum"] = x[0].item()
    else:
        t0 = time.perf_counter()
        with deterministic_cudnn():
            saved = {"equality": world_equality_steps(mesh, dev, spec)[0]}
        out["equality"] = {"losses": saved["equality"]["losses"],
                           "seconds": time.perf_counter() - t0}
        _empty_cache(device)
        loss, launches, seconds = world_grad_cache_step(mesh, dev, spec)
        out["grad_cache"] = {"loss": loss, "launches": launches,
                             "seconds": seconds}
        _empty_cache(device)
        with deterministic_cudnn():
            saved["ae"] = world_ae_steps(mesh, dev, spec)[0]
            saved["embedding"] = world_embedding(mesh, dev, spec)
        if mesh.rank == 0:
            torch.save(saved, os.path.join(job, "steps.pt"))
    with open(os.path.join(job, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(out, f)
    if task == "steps":         # (b)'s run A in this world (its group)
        return world_cli(os.path.join(args[0], "cli_A"), "A", args[0],
                         backend, spec)
    torch.distributed.destroy_process_group()
    return 0


def _empty_cache(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def world_cli(job: str, run: str, root: str, backend: str,
              spec: dict) -> int:
    """Run ``run`` of (b) through ``mimm_tpu_torch.cli.multi_modal.main``
    (which starts the world from the MIMM_* variables): A uninterrupted,
    B with a SIGTERM to rank 1 alone after its step WORLD_SIGNAL_AFTER,
    C resuming B, W1 a world of one on the default backend.  Each epoch's
    seconds less those in its saves and waits go to ``train_seconds``.
    Rank 0 of A and C saves its whole tree for the parent."""
    from mimm_tpu_torch import metrics
    from mimm_tpu_torch.cli import multi_modal

    with open(os.path.join(root, "corpus.json")) as f:
        corpus = json.load(f)
    save = os.path.join(root, {"A": "run_a", "B": "run_bc", "C": "run_bc",
                               "W1": "run_w1"}[run])
    flags = ["--preset", "production", "--pallas_stem", "true",
             "--batch_size", str(spec["batch"]), "--seed", str(SEED),
             "--num_train_epochs",
             str(WORLD_W1_EPOCHS if run == "W1" else WORLD_EPOCHS),
             "--keep_checkpoints", "1", "--prefetch", "2",
             "--data_loader_workers", str(spec["workers"]),
             "--image_dir", corpus["images"],
             "--text_data_dir", corpus["text"],
             "--dataset_metadata", corpus["metadata"],
             "--decoded_crop_cache", corpus["cache"],
             "--bert_pretrained_dir", corpus["bert"],
             "--save_directory", save, "--device", spec["device"]]
    if backend:
        flags += ["--dist_backend", backend]
    if run == "C":
        flags += ["--resume_from", "auto"]
    if run == "W1":     # the sharded save's collectives run on the group
        flags += ["--checkpoint_format", "orbax_async"]
    # C must land on A's bits: deterministic cuDNN, as phase 12 runs
    torch.backends.cudnn.deterministic = True
    info = {"signalled": False, "steps_seconds": 0.0, "saves": [],
            "waits": [], "train_seconds": []}
    real_body = mi.make_mi_step_body
    real_save, real_wait = ckpt.save_checkpoint, ckpt.wait_for_async_saves
    real_export, real_summary = mi.save_mi_checkpoints, \
        metrics.MetricWriter.epoch_summary
    io = [0.0]          # this epoch's seconds in saves and waits

    def timed(real, field):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = real(*a, **kw)
            info[field].append(time.perf_counter() - t0)
            return out
        return call

    def io_timed(real):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = real(*a, **kw)
            io[0] += time.perf_counter() - t0
            return out
        return call

    def summary(self, epoch, loss, seconds, *a, **kw):
        info["train_seconds"].append(seconds - io[0])
        io[0] = 0.0
        return real_summary(self, epoch, loss, seconds, *a, **kw)

    # every resume-checkpoint save: the seconds until it returns (an
    # "orbax_async" save: once the tree is on the host), and the waits
    ckpt.save_checkpoint = timed(real_save, "saves")
    ckpt.wait_for_async_saves = io_timed(timed(real_wait, "waits"))
    mi.save_mi_checkpoints = io_timed(real_export)
    metrics.MetricWriter.epoch_summary = summary

    def observed(*a, **kw):
        body = real_body(*a, **kw)

        def step(state, batch):
            t0 = time.perf_counter()
            state, loss = body(state, batch)
            info["steps_seconds"] += time.perf_counter() - t0
            if run == "B" and mesh_lib.world_rank() == 1 \
                    and state.step == WORLD_SIGNAL_AFTER:
                info["signalled"] = True
                os.kill(os.getpid(), signal.SIGTERM)
            return state, loss
        return step

    mi.make_mi_step_body = observed
    os.makedirs(job, exist_ok=True)
    for mod in (fa, sc, pc, ff):
        mod.reset_launch_counts()           # the mi_world path starts here
    t0 = time.perf_counter()
    _, state = multi_modal.main(flags)
    _sync(spec["device"])
    info["launches"] = _all_launches()      # ... and ends here
    info["seconds"] = time.perf_counter() - t0
    rank = mesh_lib.world_rank()
    info.update(rank=rank, size=mesh_lib.world_size(), steps=state.step,
                backend=mesh_lib.backend_name(),
                device=str(next(state.model.parameters()).device))
    if rank == 0 and run in ("A", "C"):
        torch.save(_flat_tree(state), os.path.join(job, "tree.pt"))
    with open(os.path.join(job, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    torch.distributed.destroy_process_group()
    return 0


def drive_world(root: str, device, gc_loss=None, spec=None) -> dict:
    """Phase 16: data parallelism with a world of 2 ranks on the one card,
    both on cuda:0, each a process of this script started with the MIMM_*
    variables.  The backend: NCCL (the default for CUDA tensors) if it
    takes two ranks on one device, else gloo over the CUDA tensors, chosen
    explicitly, and then a world of one on NCCL through the entry point
    too.  (a) the f32 L=320 step world 2 x 32 rows against world 1 x 64,
    (b) MI pretraining from disk through ``cli.multi_modal`` (runs A, B
    SIGTERM'd on rank 1, C resumed; the sharded format), (c) the
    converter's .bin files, (d) the B=2048 GradCache step against phase
    7's ``gc_loss`` (computed here on one rank when None), (e) two AE
    steps and the classifier's embedding pass.  ``spec``: what the ranks
    build (WORLD_SPEC by default).  Returns the world paths' launches and
    the numbers."""
    from mimm_tpu_torch.tools import convert_checkpoint

    spec = dict(WORLD_SPEC, device=str(device), **(spec or {}))
    cuda = torch.device(device).type == "cuda"
    card = card_line() if cuda else "cpu"
    batch = spec["batch"]
    started = time.perf_counter()
    bad = []
    # ---- the backend -------------------------------------------------------
    backend = ""
    if cuda:
        try:
            probe = world_launch(root, "probe", "probe", WORLD, spec,
                                 timeout=180)
            assert [p["sum"] for p in probe] == [3.0, 3.0], probe
            print(f"  NCCL takes 2 ranks on one card: backend "
                  f"{probe[0]['backend']!r}, both on {probe[0]['device']}")
        except RuntimeError as e:
            backend = "gloo"
            reason = [ln.strip() for ln in str(e).splitlines()
                      if "Duplicate" in ln or "Error" in ln][-1:]
            print(f"  NCCL refused 2 ranks on one card ({reason}): the "
                  f"world of 2 runs on gloo over CUDA tensors, chosen "
                  f"explicitly (--dist_backend gloo); a world of 1 runs on "
                  f"NCCL")
    # ---- (a), (d), (e), then (b)'s run A: world 2 ---------------------------
    corpus = write_cli_corpus(os.path.join(root, "corpus"), spec["pairs"],
                              spec["long"], spec["cli_bert"]["vocab_size"],
                              256, SEED + 53)
    with open(os.path.join(corpus["bert"], "bert_config.json"), "w") as f:
        json.dump(spec["cli_bert"], f)
    with open(os.path.join(root, "corpus.json"), "w") as f:
        json.dump(corpus, f)
    t0 = time.perf_counter()
    steps = world_launch(root, "steps", "steps", WORLD, spec, root,
                         backend=backend)
    steps_s = time.perf_counter() - t0
    runs, seconds = {"A": []}, {}
    for rank in range(WORLD):
        with open(os.path.join(root, "cli_A", f"rank{rank}.json")) as f:
            runs["A"].append(json.load(f))
    seconds["A"] = runs["A"][0]["seconds"]
    world = torch.load(os.path.join(root, "steps", "steps.pt"),
                       weights_only=True)
    print(f"  world of 2 ({steps[0]['backend']}, {steps[0]['device']} and "
          f"{steps[1]['device']}): (a), (d), (e) and (b)'s run A in "
          f"{steps_s:.1f} s (host clock, process start included; run A "
          f"{runs['A'][0]['seconds']:.1f} s)")
    # (b)'s run B (its seconds are no metric) runs while this process
    # computes the references of (a), (d), (e): the same bits either way
    t_b = time.perf_counter()
    run_b = world_start(root, "cli_B", "cli", WORLD, spec, "B", root,
                        backend=backend)
    with deterministic_cudnn():                 # as the ranks run
        one, halves = world_equality_steps(None, device, spec,
                                           (1, WORLD))
    _empty_cache(device)
    if steps[1]["equality"]["losses"] != steps[0]["equality"]["losses"]:
        bad.append(f"(a) the ranks' losses differ: {steps}")
    mine = world["equality"]
    vs_h, vs_1 = _compare(mine, halves), _compare(mine, one)
    h_vs_1 = _compare(halves, one)
    rows = slice(0, batch // WORLD)        # rank 0's rows
    emb = {g: [((mine["emb"][g] - ref["emb"][g][rows]).abs().max()
                / ref["emb"][g][rows].abs().max()).item()
               for ref in (halves, one)] for g in ("image", "text")}
    print(f"  (a) f32 L={spec['seq']} pallas_stem at dropout 0, world 2 x "
          f"{batch // WORLD} rows, world 1 x {batch} in halves (split_rows: "
          f"the world's GEMM and convolution shapes and its BatchNorm "
          f"statistics) and world 1 x {batch}:")
    print(f"  (a) rank 0's embeddings, max |Δ| / max |emb| against the "
          f"halves (held to {WORLD_HALVES_EMB:.0e}), world 1: " + ", ".join(
              f"{g} {a:.2e}, {b:.2e}" for g, (a, b) in emb.items()))
    print(f"  (a) world 2 against the halves: {_compare_line(vs_h)} (held: "
          f"max |Δg| / max |g| {WORLD_HALVES_GRAD:.0e}, running "
          f"{WORLD_BN_RTOL:.0e}, losses {STEP_LOSS_ATOL:.0e})")
    print(f"  (a) world 2 against world 1: {_compare_line(vs_1)} (held: "
          f"cosine at least {WORLD_COS:g}, norm ratio within {WORLD_NORM}, "
          f"running {WORLD_BN_RTOL:.0e}, losses {STEP_LOSS_ATOL:.0e}, then "
          f"rtol {WORLD_LOSS2[0]:.0e} atol {WORLD_LOSS2[1]:.0e})")
    print(f"  (a) the halves against world 1 (the world's arithmetic alone, "
          f"not held): {_compare_line(h_vs_1)}")
    if max(a for a, _ in emb.values()) > WORLD_HALVES_EMB:
        bad.append(f"(a) rank 0's embeddings against the halves {emb}")
    if max(vs_h["grad"].values()) > WORLD_HALVES_GRAD:
        bad.append(f"(a) gradients against the halves {vs_h['grad']}")
    if max(vs_h["loss"]) > STEP_LOSS_ATOL:
        bad.append(f"(a) losses against the halves {vs_h['loss']}")
    if any(cos < WORLD_COS or not WORLD_NORM[0] <= ratio <= WORLD_NORM[1]
           for cos, ratio in vs_1["agree"].values()):
        bad.append(f"(a) gradients against world 1 {vs_1['agree']}")
    if max(vs_h["running"], vs_1["running"]) > WORLD_BN_RTOL:
        bad.append(f"(a) running statistics {vs_h['running']}, "
                   f"{vs_1['running']}")
    rtol, atol = WORLD_LOSS2
    if vs_1["loss"][0] > STEP_LOSS_ATOL or \
            vs_1["loss"][1] > atol + rtol * abs(one["losses"][1]):
        bad.append(f"(a) losses {mine['losses']} against world 1's "
                   f"{one['losses']}")
    for s in range(2):
        got = {name: _step_diff((0.0, mine["snaps"][s]),
                                (0.0, ref["snaps"][s]))
               for name, ref in (("halves", halves), ("world 1", one))}
        got["halves vs world 1"] = _step_diff((0.0, halves["snaps"][s]),
                                              (0.0, one["snaps"][s]))
        moved = {name: {g: v for g, v in d.items()
                        if g not in ("loss_diff", "loss")}
                 for name, d in got.items()}
        print(f"  (a) after Adam step {s + 1}, max |dparam|, share > 1e-6: "
              + "; ".join(f"world 2 against {name}: {_shares_line(m)}"
                          if name != "halves vs world 1" else
                          f"the halves against world 1: {_shares_line(m)}"
                          for name, m in moved.items())
              + f" (held: against the halves max {STEP_MAX_ABS:.1e}"
              + (f", shares {WORLD_HALVES_SHARE}" if s == 0 else "")
              + f"; against world 1 max {(s + 1) * STEP_MAX_ABS:.1e})")
        if any(v[0] > STEP_MAX_ABS or s == 0 and v[1] > WORLD_HALVES_SHARE[g]
               for g, v in moved["halves"].items()):
            bad.append(f"(a) weights after Adam step {s + 1} against the "
                       f"halves: {moved['halves']}")
        if max(v[0] for v in moved["world 1"].values()) > \
                (s + 1) * STEP_MAX_ABS:
            bad.append(f"(a) weights after Adam step {s + 1} against world "
                       f"1: {moved['world 1']}")
    if gc_loss is None:
        gc_loss = world_grad_cache_step(None, device, spec)[0]
        _empty_cache(device)
    gc = steps[0]["grad_cache"]
    gc_diff = abs(gc["loss"] - gc_loss)
    critic_launches = [s["grad_cache"]["launches"] for s in steps]
    print(f"  (d) GradCache B={spec['gc'][0]} in {spec['gc'][1]} chunks "
          f"({spec['gc'][1] // WORLD} a rank), L={spec['gc_seq']}: loss "
          f"{gc['loss']:.7f}, world 1 {gc_loss:.7f} (|diff| {gc_diff:.2e}, "
          f"tol {CRITIC_TOL['S']:.0e}), {gc['seconds']:.3f} s a step (host "
          f"clock), launches by rank {critic_launches}  [{card}]")
    if gc_diff > CRITIC_TOL["S"] * max(1.0, abs(gc_loss)):
        bad.append(f"(d) GradCache loss {gc['loss']} against {gc_loss}")
    with deterministic_cudnn():
        one_ae, halves_ae = world_ae_steps(None, device, spec, (1, WORLD))
        emb1 = world_embedding(None, device, spec)
    _empty_cache(device)
    for d in (one_ae, halves_ae, world["ae"]):
        d["grads"] = {"ae": d["grads"]}
    ae_h, ae_1 = _compare(world["ae"], halves_ae), _compare(world["ae"],
                                                             one_ae)
    sh = {name: _shares(world["ae"]["snap"], ref["snap"], JAX_AE_F32)
          for name, ref in (("halves", halves_ae), ("world 1", one_ae))}
    sh["halves vs world 1"] = _shares(halves_ae["snap"], one_ae["snap"],
                                      JAX_AE_F32)
    print(f"  (e) f32 AE steps, world 2 x {batch // WORLD} (sync-BN) against "
          f"world 1 x {batch} in halves: {_compare_line(ae_h)} (held: max "
          f"|Δg| / max |g| {WORLD_HALVES_GRAD:.0e}, losses "
          f"{STEP_LOSS_ATOL:.0e}); against world 1: {_compare_line(ae_1)} "
          f"(held: max |Δg| / max |g| {WORLD_AE_GRAD:.0e}, cosine at least "
          f"{WORLD_COS:g}, norm ratio within {WORLD_NORM}, running "
          f"{WORLD_BN_RTOL:.0e}, losses {STEP_LOSS_ATOL:.0e}, then rtol "
          f"{WORLD_LOSS2[0]:.0e} atol {WORLD_LOSS2[1]:.0e}); the halves "
          f"against world 1, not held: "
          f"{_compare_line(_compare(halves_ae, one_ae))}")
    print(f"  (e) after Adam step 1, max |dparam|, share > 1e-6: "
          + "; ".join(f"{name}: {_shares_line(v)}" for name, v in sh.items())
          + f" (held: max {STEP_MAX_ABS:.1e}; against the halves, shares "
          f"{STEP_FLIP_SHARE:.0e})")
    for c, name, tol in ((ae_h, "the halves", WORLD_HALVES_GRAD),
                         (ae_1, "world 1", WORLD_AE_GRAD)):
        if max(c["grad"].values()) > tol or any(
                cos < WORLD_COS or not WORLD_NORM[0] <= r <= WORLD_NORM[1]
                for cos, r in c["agree"].values()) \
                or c["running"] > WORLD_BN_RTOL:
            bad.append(f"(e) AE against {name}: {c}")
    if ae_h["loss"][0] > STEP_LOSS_ATOL or ae_1["loss"][0] > \
            STEP_LOSS_ATOL or ae_h["loss"][1] > STEP_LOSS_ATOL or \
            ae_1["loss"][1] > atol + rtol * abs(one_ae["losses"][1]):
        bad.append(f"(e) AE losses {ae_h['loss']}, {ae_1['loss']}")
    if max(v[0] for name in ("halves", "world 1")
           for v in sh[name].values()) > STEP_MAX_ABS \
            or max(v[1] for v in sh["halves"].values()) > STEP_FLIP_SHARE:
        bad.append(f"(e) AE weights after Adam step 1: {sh}")
    emb_err = ((world["embedding"] - emb1).abs().max()
               / emb1.abs().max()).item()
    print(f"  (e) the classifier's embedding pass at B={batch}, world 2 "
          f"against world 1: max |diff| / max |emb| {emb_err:.2e} (tol "
          f"{WORLD_EMB_TOL:.0e})")
    if emb_err > WORLD_EMB_TOL:
        bad.append(f"(e) embedding pass: {emb_err}")
    del world, one, halves, one_ae, halves_ae
    runs["B"] = world_wait(run_b)
    seconds["B"] = time.perf_counter() - t_b
    # ---- (b): the entry point from disk -----------------------------------
    for run, n, be in (("C", WORLD, backend), ("W1", 1, "")):
        t0 = time.perf_counter()
        runs[run] = world_launch(root, f"cli_{run}", "cli", n, spec, run,
                                 root, backend=be)
        seconds[run] = time.perf_counter() - t0
    per_epoch = runs["W1"][0]["steps"] // WORLD_W1_EPOCHS
    pairs_s = {run: [per_epoch * batch / x
                     for x in runs[run][0]["train_seconds"]]
               for run in ("A", "W1")}
    b_steps = [r["steps"] for r in runs["B"]]
    if cuda:
        for rank, r in enumerate(runs["A"]):
            want = [fa.KERNELS[torch.bfloat16],
                    fa.BWD_KERNELS[torch.bfloat16], sc.KERNELS["fwd"],
                    sc.KERNELS["dw"]]
            print(f"  (b) run A's launches on rank {rank}: {r['launches']}")
            if not all(r["launches"].get(n, 0) for n in want):
                bad.append(f"(b) run A's rank {rank} launched "
                           f"{r['launches']}, want each of {want}")
    a_tree = torch.load(os.path.join(root, "cli_A", "tree.pt"),
                        weights_only=True)
    c_tree = torch.load(os.path.join(root, "cli_C", "tree.pt"),
                        weights_only=True)
    differ = [k for k in a_tree if not (
        torch.equal(a_tree[k], c_tree[k]) if torch.is_tensor(a_tree[k])
        else a_tree[k] == c_tree[k])]
    save_a = os.path.join(root, "run_a")
    files_a = sorted(os.listdir(save_a))
    preempted = [r.get("step") for r in _jsonl(os.path.join(root, "run_bc"))
                 if r.get("preempted")]
    print(f"  (b) cli.multi_modal, production preset with pallas_stem, B="
          f"{batch} ({batch // WORLD} a rank), "
          f"{spec['pairs'] + 2 * spec['long']} pairs, {per_epoch} steps an "
          f"epoch: world 2 on {runs['A'][0]['backend']} "
          f"({runs['A'][0]['device']}, {runs['A'][1]['device']}) epochs "
          + ", ".join(f"{x:.1f}" for x in pairs_s["A"])
          + f" pairs/s; world 1 on {runs['W1'][0]['backend']} epochs "
          + ", ".join(f"{x:.1f}" for x in pairs_s["W1"])
          + f" pairs/s (host clock, rank 0, each epoch's seconds less its "
          f"saves' and waits'; epoch 1 carries the warm-up)  [{card}]")
    print(f"  (b) runs A / B / C / W1: {seconds['A']:.1f} / "
          f"{seconds['B']:.1f} / {seconds['C']:.1f} / {seconds['W1']:.1f} s "
          f"(host clock, process start included but A's, which ran in the "
          f"world of (a), (d), (e)); host seconds in the step "
          f"calls, rank 0 of A: {runs['A'][0]['steps_seconds']:.3f}; "
          f"seconds a sharded save (run A, by rank): "
          f"{[[round(x, 3) for x in r['saves']] for r in runs['A']]}; an "
          f"\"orbax_async\" save's return (world 1): "
          f"{[round(x, 3) for x in runs['W1'][0]['saves']]}, its waits "
          f"{[round(x, 3) for x in runs['W1'][0]['waits'] if x > 1e-3]}  "
          f"[{card}]")
    print(f"  (b) run B: SIGTERM to rank 1 alone after its step "
          f"{WORLD_SIGNAL_AFTER} (signalled "
          f"{[r['signalled'] for r in runs['B']]}), both ranks stopped at "
          f"steps {b_steps}, preempted at {preempted}; run C resumed to "
          f"{[r['steps'] for r in runs['C']]} (A "
          f"{[r['steps'] for r in runs['A']]}); C against A: {len(a_tree)} "
          f"tensors and counts, {len(differ)} differ"
          + (f" ({differ[:3]})" if differ else ", bit for bit")
          + f"; A left {files_a}")
    if differ:
        bad.append(f"(b) run C differs from A in {len(differ)}: {differ[:3]}")
    if len(set(b_steps)) != 1 or not 0 < b_steps[0] < runs["A"][0]["steps"] \
            or preempted != [b_steps[0]] or not runs["B"][1]["signalled"]:
        bad.append(f"(b) run B stopped at {b_steps}, preempted {preempted}")
    if [r["steps"] for r in runs["C"]] != [r["steps"] for r in runs["A"]]:
        bad.append("(b) run C did not end at A's step")
    last = f"mi_epoch{WORLD_EPOCHS}.ckpt"
    if not os.path.isdir(os.path.join(save_a, last)) or \
            any(f.endswith(".bin") for f in files_a):
        bad.append(f"(b) run A left {files_a}")
    # ---- (c): the converter -------------------------------------------------
    conv = os.path.join(root, "converted")
    t0 = time.perf_counter()
    convert_checkpoint.convert("mi", os.path.join(save_a, last), conv)
    conv_s = time.perf_counter() - t0
    bc = BertConfig.from_json_file(os.path.join(save_a, "config.json"))
    models = {"image_model": ResNet256_6_2_1(), "text_model": TextBert(bc),
              "joint": ImageReportModel(bc)}
    for name, fname in (("image_model", "pytorch_MI_image_model.bin"),
                        ("text_model", "pytorch_MI_text_model.bin"),
                        ("joint", f"pytorch_model_epoch{WORLD_EPOCHS}.bin")):
        models[name].load_state_dict(ckpt.load_state_dict_bin(
            os.path.join(conv, fname)), strict=True)
    got = {f"/{tower}/{k}": v for tower in ("image_model", "text_model")
           for k, v in models[tower].state_dict().items()}
    got_joint = {"/" + k.replace(".", "/", 1): v
                 for k, v in models["joint"].state_dict().items()}
    conv_bad = [k for k, v in [*got.items(), *got_joint.items()]
                if not torch.equal(v, a_tree[k])]
    print(f"  (c) tools/convert_checkpoint.py --kind mi from A's sharded "
          f"{last} in {conv_s:.1f} s: {sorted(os.listdir(conv))} loaded "
          f"strict, {len(got) + len(got_joint)} tensors, {len(conv_bad)} "
          f"differ from rank 0's")
    if conv_bad:
        bad.append(f"(c) converted .bin files differ: {conv_bad[:3]}")
    seconds_all = time.perf_counter() - started
    print(f"  phase 16: {seconds_all:.1f} s (host clock)  [{card}]")
    if bad:
        raise AssertionError("; ".join(bad))
    mi_world = collections.Counter()
    for run in ("A", "B", "C"):
        for r in runs[run]:
            mi_world.update(r["launches"])
    gc_world = collections.Counter()
    for s in steps:
        gc_world.update(s["grad_cache"]["launches"])
    return {"mi_world": dict(mi_world), "grad_cache_world": dict(gc_world),
            "seconds": seconds_all, "pairs_per_s": pairs_s,
            "backend": runs["A"][0]["backend"]}

# ---- phase 17: tensor and sequence parallelism, ZeRO-1 / FSDP ---------------

TP_WORLD = 2
# (e)'s corpus: phase 16's recipe at one step an epoch (half a batch in
# each of the 256 and 320 buckets, one bucket of SEQ: a TP + SP step on
# gloo is the run's dearest, ~10 s)
TP_LONG = BATCH // 2
# NCCL refuses two ranks on one device (phase 16): gloo over CUDA tensors
TP_BACKEND = "gloo"
# what the ranks build: full width on the card (``drive_tp(spec=)`` takes
# small ones for a rehearsal on the CPU)
TP_SPEC = {"device": "cuda", "bert_kw": TRAIN_BERT, "cli_bert": BERT_BASE,
           "batch": BATCH, "seq": SEQ, "ae": None, "long": TP_LONG,
           "workers": 3, "ffn_bert": FFN_TRAIN_BERT}
# (a) {'model': 2} against one rank, f32 L=320 at dropout 0, deterministic
# cuDNN on both sides.  The image tower runs whole on each model rank
# (bit for bit one rank's); the text tower's row-parallel outputs sum two
# partial products in f32, so its embeddings move by f32 rounding, which
# the cancelling DV gradient magnifies as phase 16 (a) showed.  The
# readings are the same in every call (NVIDIA H100 80GB HBM3, 700 W):
# text embeddings 3.35e-6, gradients' max |Δg| / max |g| image 1.16e-4,
# text 1.41e-4, critic 6.71e-4, cosine 1 - 5e-7, norm ratio 1 + 8e-6,
# step 1's loss equal and step 2's 4.0e-7 apart.  Held: the text
# embeddings' max |Δ| / max |emb| within TP_EMB; each group's max |Δg| /
# max |g| within TP_GRAD, its cosine at least TP_COS and its norm ratio
# within TP_NORM (about 3 to 20 times the readings: a wrong or twice-
# summed gradient of one whole leaf moves them by its own share); step
# 1's loss within phase 5's 1e-5 and step 2's within TP_LOSS2; after
# step 1 the share of weights moved by more than 1e-6 within phase 10's
# (WORLD_HALVES_SHARE; a sign error in a leaf of more than that share of
# its group shows there).  After step 2 the shares are printed and not
# held: Adam's second update divides f32 rounding by a small √v̂, and a
# third of the image weights move apart.  No bound on the largest |Δ|
# after a step: Adam moves each weight by about lr whatever its gradient.
# At dropout 0.1 each rank's first flash call (its 6 heads) against the
# head slice of one rank's, within phase 2's f32 tolerance.
TP_EMB = 1e-5
TP_GRAD = 2e-3
TP_COS = 1 - 1e-5
TP_NORM = (1 - 1e-4, 1 + 1e-4)
TP_LOSS2 = 1.5e-6
# (b) {'model': 2} with sequence parallelism against (a): everything the
# two compute alike is bit for bit (the forward, the losses, every
# gradient a product or a lookup takes); the LayerNorms' scales and
# shifts and the row-parallel biases, which under SP sum their tokens in
# two halves and an all-reduce, within TP_SP_SUM of max |g|; the second
# step's loss within (a)'s TP_LOSS2
TP_SP_SUM = 1e-5
# the fused FFN layer under TP against unsharded, max |Δ| / max |ref| of
# the output and every gradient: the f32 weight gradients' FFN_TOL
TP_FFN_TOL = 1e-4
# (c) / (d): ZeRO-1 and FSDP against the replicated world, bit for bit
TP_ZERO_MODES = {"replicated": {}, "zero1": {"zero1": True},
                 "zero1_fsdp": {"zero1": True, "fsdp": True}}


def _tp_data(spec, bc, device):
    rng = np.random.default_rng(SEED + 61)
    batch = spec["batch"]
    data = []
    for _ in range(2):
        d = compact_batch(rng, batch, spec["seq"], bc.vocab_size, device)
        d["study_id"][batch // 2 + 1] = d["study_id"][1]
        data.append(d)
    return data


def _tree_snap(state) -> dict:
    """``mi_state_tree``'s whole tensors (every rank calls it) as float32
    CPU copies by group: "image", "text", "critic", "batch_stats", and the
    moments under "moments"."""
    tree = mi.mi_state_tree(state)
    out = {"image": {}, "batch_stats": {}, "moments": {}}
    for n, t in tree["image_model"].items():
        if n.endswith("num_batches_tracked"):
            continue
        out["batch_stats" if "running" in n else "image"][n] = \
            t.detach().float().cpu().clone()
    out["text"] = {n: t.detach().float().cpu().clone()
                   for n, t in tree["text_model"].items()}
    out["critic"] = {f"{i}.{k}": t.detach().float().cpu().clone()
                     for i, layer in enumerate(tree["critic"])
                     for k, t in layer.items()}
    for opt in ("img_opt", "txt_opt", "mi_opt"):
        for part in ("mu", "nu"):
            for n, t in tree[opt].get(part, {}).items():
                out["moments"][f"{opt}.{part}.{n}"] = \
                    t.detach().float().cpu().clone()
    return out


def tp_steps(mesh, device, spec: dict, sp: bool = False) -> dict:
    """(a) / (b): the f32 L=320 step of phase 16 (a) (production preset,
    ``pallas_stem``, dropout 0) from seeded weights over the whole batch
    on every rank, placed by ``shard_mi_state`` (TP with a 'model' axis,
    ``sp``: sequence parallelism): two Adam steps, their losses, whole
    states and kernel launches, and step 1's gradients (the TP pieces
    gathered) and embeddings."""
    bc = BertConfig(**{**spec["bert_kw"], "hidden_dropout_prob": 0.0,
                       "attention_probs_dropout_prob": 0.0})
    batch = spec["batch"]
    cfg = TrainingConfig.production(compute_dtype="float32", pallas_stem=True,
                                    sequence_parallel=sp)
    data = _tp_data(spec, bc, device)
    txs = mi.make_optimizers(cfg, steps_per_epoch=200_000 // batch)
    taps = {"image": {}, "text": {}, "critic": {}}
    txs = mi.MIOptimizers(**{k: _recording(getattr(txs, k), taps[g])
                             for k, g in (("img", "image"), ("txt", "text"),
                                          ("mi", "critic"))})
    # a fresh model each run: TP cuts its parameters in place
    model = mi.build_joint_model(cfg, bc, device=device)
    state = mesh_lib.shard_mi_state(mesh, mi.create_mi_state(
        model, cfg, txs, torch.Generator().manual_seed(SEED + 63)),
        sequence_parallel=sp)
    step = mi.make_mi_train_step(model, txs, cfg, mesh=mesh)
    out = {"losses": [], "snaps": []}
    for mod in (fa, sc, pc, ff):
        mod.reset_launch_counts()      # the tp / sp world path starts here
    t0 = time.perf_counter()
    with _observe(model, batch, 1) as seen:
        for d in data:
            state, loss = step(state, d)
            out["losses"].append(loss.item())
            out["snaps"].append(_tree_snap(state))
    _sync(device)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = _all_launches()          # ... and ends here
    if state.layout is not None:      # step 1's TP pieces, whole
        for g, group in (("text", "text_model"), ("critic", "critic")):
            dims = state.layout.groups[group].tp or {}
            taps[g] = {n: mesh_lib.gather_leaf(
                t.to(device), dims.get(n), mesh, mesh_lib.MODEL_AXIS).cpu()
                for n, t in taps[g].items()}
    out.update(grads=taps, emb=dict(zip(("image", "text"), seen)))
    return out


def _recording(tx, store: dict):
    """``tx`` that also keeps the gradients of its first update (float32,
    on the CPU) in ``store``."""
    def update(grads, state, params=None):
        if not store:
            store.update({n: g.detach().float().cpu().clone()
                          for n, g in grads.items()})
        return tx.update(grads, state, params)
    return mi.GradientTransformation(tx.init, update)


def tp_flash_heads(mesh, device, spec: dict) -> torch.Tensor:
    """(a) at dropout 0.1: the first flash call's context of a train-mode
    text forward (TrainingConfig's f32 production BERT, seeded weights and
    generator): all heads on one rank, this rank's under TP."""
    bc = BertConfig(**spec["bert_kw"])
    cfg = TrainingConfig.production(compute_dtype="float32")
    model = mi.build_joint_model(cfg, bc, device=device)
    txs = mi.make_optimizers(cfg, steps_per_epoch=1000)
    state = mesh_lib.shard_mi_state(mesh, mi.create_mi_state(
        model, cfg, txs, torch.Generator().manual_seed(SEED + 65)))
    d = _tp_data(spec, bc, device)[0]
    wide = decompact_batch(d)
    seen = []
    real = bert_model.flash_attention

    def first(*a, **kw):
        out = real(*a, **kw)
        if not seen:
            seen.append(out.detach().float().cpu().clone())
        return out

    bert_model.flash_attention = first
    try:
        with torch.no_grad():
            model.text_model(wide["txt_ids"], wide["txt_segments"],
                             wide["txt_masks"], deterministic=False,
                             generator=torch.Generator(device=device)
                             .manual_seed(SEED + 67))
    finally:
        bert_model.flash_attention = real
    del state
    return seen[0]


def tp_ffn_layer(mesh, device, spec: dict) -> dict:
    """One encoder layer with ``fused_ffn`` on (f32, dropout 0, L=320,
    B=64), forward and backward, unsharded or a TP rank's (f = 3072 / M
    intermediate columns, b2 once after the sum): the output, dx and the
    whole parameter gradients (float32, CPU), and the launches."""
    from mimm_tpu_torch.models.bert import BertLayer, set_tensor_parallel

    bc = BertConfig(**{**spec["ffn_bert"], "hidden_dropout_prob": 0.0,
                       "attention_probs_dropout_prob": 0.0})
    layer = BertLayer(bc)
    gen = torch.Generator().manual_seed(SEED + 69)
    with torch.no_grad():
        for n, p in layer.named_parameters():
            p.copy_(torch.randn(p.shape, generator=gen)
                    * (0.02 if p.dim() == 2 else 0.1)
                    + (1.0 if n.endswith("LayerNorm.weight") else 0.0))
    layer = layer.to(device)
    params = dict(layer.named_parameters())
    dims = {n: d for n, d in mesh_lib.bert_tp_shardings(
        mesh, {"l." + n: p for n, p in params.items()}).items()}
    dims = {n[2:]: d for n, d in dims.items()}
    if mesh is not None:
        with torch.no_grad():
            for n, p in params.items():
                p.data = mesh_lib.shard_leaf(p.data, dims[n], mesh,
                                             mesh_lib.MODEL_AXIS).contiguous()
        set_tensor_parallel(layer, mesh)
    shape = (spec["batch"], spec["seq"], bc.hidden_size)
    x = (torch.randn(shape, generator=gen)).to(device).requires_grad_()
    w = torch.randn(shape, generator=gen).to(device)
    bias = torch.zeros(shape[0], 1, 1, shape[1], device=device)
    for mod in (fa, sc, pc, ff):
        mod.reset_launch_counts()          # the tp_ffn path starts here
    y = layer(x, bias)
    names = sorted(params)
    grads = torch.autograd.grad((y * w).sum(), [x] + [params[n]
                                                      for n in names])
    _sync(device)
    out = {"launches": _all_launches(),     # ... and ends here
           "y": y.detach().float().cpu(), "dx": grads[0].float().cpu()}
    for n, g in zip(names, grads[1:]):
        out[n] = mesh_lib.gather_leaf(g, dims[n], mesh, mesh_lib.MODEL_AXIS) \
            .float().cpu() if mesh is not None else g.float().cpu()
    return out


def _state_bytes(state) -> int:
    """The bytes of the rank's resident parameters and moments."""
    out = 0
    tensors = list(state.model.parameters()) + [
        t for layer in state.critic_params for t in layer.values()]
    for opt in (state.img_opt, state.txt_opt, state.mi_opt):
        mesh_lib._map_moments(opt, lambda m: tensors.extend(m.values()) or m)
    for t in tensors:
        out += t.numel() * t.element_size()
    return out


def _predicted_bytes(full: dict, moment_bytes: dict, data: int,
                     zero1: bool, fsdp: bool) -> int:
    """The bytes the rule of ``zero1_shardings`` leaves a rank: every
    tensor of ``full`` ({name: (shape, param element size)}) whole or
    1/``data`` of it, its two moments likewise (``moment_bytes``: their
    element size by name)."""
    mesh = mesh_lib.Mesh(data=data)
    rule = mesh_lib.zero1_shardings(mesh, {n: torch.empty(s, device="meta")
                                           for n, (s, _) in full.items()})
    out = 0
    for n, (shape, size) in full.items():
        numel = math.prod(shape)
        part = numel // data if rule[n] is not None else numel
        out += (part if fsdp else numel) * size
        out += 2 * (part if zero1 else numel) * moment_bytes[n]
    return out


def zero_steps(mesh, device, spec: dict, zero1: bool, fsdp: bool) -> dict:
    """(c): two f32 steps of (a)'s configuration over this data index's
    rows, placed by ``shard_mi_state(zero1=, fsdp=)``: the losses, the
    whole state after them, the seconds, the launches, and the rank's
    resident bytes of parameters and moments (counted, predicted by the
    rule, and ``torch.cuda.memory_allocated``)."""
    bc = BertConfig(**{**spec["bert_kw"], "hidden_dropout_prob": 0.0,
                       "attention_probs_dropout_prob": 0.0})
    batch = spec["batch"]
    cfg = TrainingConfig.production(compute_dtype="float32", pallas_stem=True)
    data = [mesh_lib.shard_batch(mesh, d) for d in _tp_data(spec, bc, device)]
    txs = mi.make_optimizers(cfg, steps_per_epoch=200_000 // batch)
    model = mi.build_joint_model(cfg, bc, device=device)
    state = mi.create_mi_state(model, cfg, txs,
                               torch.Generator().manual_seed(SEED + 63))
    full = {}
    for g, params, opt in (
            ("img", dict(model.image_model.named_parameters()),
             state.img_opt),
            ("txt", dict(model.text_model.named_parameters()), state.txt_opt),
            ("mi", mi.critic_dict(state.critic_params), state.mi_opt)):
        for n, p in params.items():
            full[f"{g}.{n}"] = (tuple(p.shape), p.element_size(),
                                opt.mu[n].element_size())
    state = mesh_lib.shard_mi_state(mesh, state, zero1=zero1, fsdp=fsdp)
    step = mi.make_mi_train_step(model, txs, cfg, mesh=mesh)
    out = {"losses": []}
    for mod in (fa, sc, pc, ff):
        mod.reset_launch_counts()          # the zero world path starts here
    t0 = time.perf_counter()
    for d in data:
        state, loss = step(state, d)
        out["losses"].append(loss.item())
    _sync(device)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = _all_launches()      # ... and ends here
    _empty_cache(device)
    out["bytes"] = {
        "counted": _state_bytes(state),
        "predicted": _predicted_bytes(
            {n: v[:2] for n, v in full.items()},
            {n: v[2] for n, v in full.items()}, mesh_lib.mesh_size(mesh),
            zero1, fsdp),
        "allocated": torch.cuda.memory_allocated(device)
        if torch.device(device).type == "cuda" else 0}
    out["snap"] = _tree_snap(state)
    return out


def ae_zero_steps(mesh, device, spec: dict, zero1: bool, fsdp: bool) -> dict:
    """(d): two f32 steps of the full-width autoencoder over this data
    index's rows (sync-BN), placed by ``shard_ae_state(zero1=, fsdp=)``:
    the losses, the rank's resident bytes of parameters and moments after
    them and the whole state (``ae_state_tree``)."""
    from mimm_tpu_torch.models.autoencoder import ResNetAE
    from mimm_tpu_torch.train import ae

    cfg = TrainingConfig.production(compute_dtype="float32")
    model = ae.build_ae_model(cfg, device) if spec["ae"] is None else \
        ResNetAE(**spec["ae"]).to(device)
    rng = np.random.default_rng(SEED + 71)
    batch = spec["batch"]
    images = [_ae_images(rng, batch, device)[
        mesh_lib.local_rows(mesh, batch)] for _ in range(2)]
    state = mesh_lib.shard_ae_state(mesh, ae.create_ae_state(
        model, cfg, torch.Generator().manual_seed(SEED + 73)),
        zero1=zero1, fsdp=fsdp)
    step = ae.make_ae_train_step(model, ae._ae_tx(cfg), mesh=mesh)
    out = {"losses": []}
    for x in images:
        state, loss = step(state, x)
        out["losses"].append(loss.item())
    tensors = list(state.model.parameters())
    mesh_lib._map_moments(state.opt_state,
                          lambda m: tensors.extend(m.values()) or m)
    out["bytes"] = sum(t.numel() * t.element_size() for t in tensors)
    tree = ae.ae_state_tree(state)
    out["snap"] = {"model": {n: t.detach().float().cpu().clone()
                             for n, t in tree["model"].items()
                             if not n.endswith("num_batches_tracked")},
                   "moments": {f"{p}.{n}": t.detach().float().cpu().clone()
                               for p in ("mu", "nu")
                               for n, t in tree["opt_state"][p].items()}}
    return out


def _snap_differ(a: dict, b: dict) -> list:
    """The names of two snapshots' tensors that differ in any bit."""
    return [f"{g}/{n}" for g in b for n in b[g]
            if not torch.equal(a[g][n], b[g][n])]


def _sp_summed(name: str) -> bool:
    """A text parameter whose gradient sequence parallelism sums over the
    ranks' tokens: the encoder's LayerNorms and row-parallel biases."""
    return ".encoder." in name and (
        "LayerNorm" in name or name.endswith("output.dense.bias"))


def tp_worker(job: str, mesh_tp, dev, spec: dict) -> dict:
    """The 'tp17' task of a world of 2: (a), (b), the flash heads at
    dropout 0.1 and the FFN layer on ``{'model': 2}``, then (c) and (d) on
    ``{'data': 2}``.  Rank 0 compares (b) with (a), (c) and (d) with the
    replicated world, and keeps the tensors the parent compares with one
    rank."""
    rank = mesh_lib.world_rank()
    out, saved = {}, {}
    with deterministic_cudnn():
        t0 = time.perf_counter()
        a = tp_steps(mesh_tp, dev, spec)
        _empty_cache(dev)
        b = tp_steps(mesh_tp, dev, spec, sp=True)
        _empty_cache(dev)
        out["tp_seconds"] = time.perf_counter() - t0
        out["a"] = {"losses": a["losses"], "launches": a["launches"],
                    "seconds": a["seconds"]}
        out["b"] = {"losses": b["losses"], "launches": b["launches"],
                    "seconds": b["seconds"]}
        # (b) against (a)
        grad_bits = {g: [n for n in a["grads"][g]
                         if not torch.equal(a["grads"][g][n],
                                            b["grads"][g][n])]
                     for g in a["grads"]}
        summed = [n for n in grad_bits["text"] if _sp_summed(n)]
        other = [f"{g}/{n}" for g, ns in grad_bits.items() for n in ns
                 if not (g == "text" and _sp_summed(n))]
        top = max((a["grads"]["text"][n].abs().max().item()
                   for n in a["grads"]["text"] if _sp_summed(n)),
                  default=1.0)
        out["sp_vs_tp"] = {
            "emb_equal": all(torch.equal(a["emb"][g], b["emb"][g])
                             for g in a["emb"]),
            "loss1_equal": a["losses"][0] == b["losses"][0],
            "loss2_diff": abs(a["losses"][1] - b["losses"][1]),
            "grads_differ_not_summed": other,
            "summed_differ": len(summed),
            "summed_total": sum(1 for n in a["grads"]["text"]
                                if _sp_summed(n)),
            "summed_max": max((((a["grads"]["text"][n]
                                 - b["grads"]["text"][n]).abs().max().item())
                               for n in summed), default=0.0) / max(top,
                                                                    1e-30),
            "snap1_differ": len(_snap_differ(a["snaps"][0], b["snaps"][0]))}
        saved["a"] = {k: a[k] for k in ("grads", "emb", "losses", "snaps")}
        del a, b
        saved["heads"] = tp_flash_heads(mesh_tp, dev, spec)
        _empty_cache(dev)
        ffn = tp_ffn_layer(mesh_tp, dev, spec)
        out["ffn_launches"] = ffn.pop("launches")
        saved["ffn"] = ffn
        _empty_cache(dev)
        mesh_d = mesh_lib.make_mesh({"data": TP_WORLD})
        zero, out["zero"] = {}, {}
        for mode, kw in TP_ZERO_MODES.items():
            zero[mode] = zero_steps(mesh_d, dev, spec, **{
                "zero1": False, "fsdp": False, **kw})
            out["zero"][mode] = {k: zero[mode][k] for k in (
                "losses", "seconds", "launches", "bytes")}
            _empty_cache(dev)
        for mode in TP_ZERO_MODES:
            out["zero"][mode]["differ"] = _snap_differ(
                zero[mode]["snap"], zero["replicated"]["snap"])
        del zero
        out["ae"] = {}
        ae_runs = {mode: ae_zero_steps(mesh_d, dev, spec, **{
            "zero1": False, "fsdp": False, **kw})
            for mode, kw in TP_ZERO_MODES.items() if mode != "zero1"}
        for mode, r in ae_runs.items():
            out["ae"][mode] = {"losses": r["losses"], "bytes": r["bytes"],
                               "differ": _snap_differ(
                                   r["snap"], ae_runs["replicated"]["snap"])}
    if rank < TP_WORLD:
        torch.save(saved, os.path.join(job, f"tp17-rank{rank}.pt"))
    return out


# phase 17 (e) and phase 18 (d): a world's MI run from disk through the
# entry point (f32, ``pallas_stem``, one bucket of SEQ, WORLD_CLI_EPOCHS
# epochs of one step, every epoch's checkpoint kept), and one rank resuming
# its epoch 2 from the world's first checkpoint
WORLD_CLI_EPOCHS = 2
WORLD_CLI_MESH = {"tp17": ["--mesh_shape", f"model={TP_WORLD}",
                           "--sequence_parallel", "true"],
                  "pp18": ["--mesh_shape", "pipe=2",
                           "--pipeline_microbatches", "2"]}


def write_world_cli_corpus(root: str, task: str, spec: dict, seed: int,
                           bert: dict) -> None:
    """``task``'s corpus (``write_cli_corpus``: ``spec["long"]`` pairs in
    each of the 256 and 320 buckets) under ``<root>/corpus-<task>``, with
    ``bert`` as its ``bert_config.json``."""
    corpus = write_cli_corpus(os.path.join(root, f"corpus-{task}"), 0,
                              spec["long"], bert["vocab_size"], 256, seed)
    with open(os.path.join(corpus["bert"], "bert_config.json"), "w") as f:
        json.dump(bert, f)
    with open(os.path.join(root, f"corpus-{task}.json"), "w") as f:
        json.dump(corpus, f)


def _world_cli_flags(task: str, run: str, root: str, spec: dict,
                     backend: str) -> list:
    """The flags of ``task``'s run "world" (a world of 2 with
    WORLD_CLI_MESH[task]) or "R1" (one process resuming from the world's
    ``mi_epoch1.ckpt``), saving under ``<root>/run-<task>-<run>``."""
    with open(os.path.join(root, f"corpus-{task}.json")) as f:
        corpus = json.load(f)
    flags = ["--preset", "production", "--compute_dtype", "float32",
             "--pallas_stem", "true", "--batch_size", str(spec["batch"]),
             "--seed", str(SEED), "--num_train_epochs", str(WORLD_CLI_EPOCHS),
             "--keep_checkpoints", "0", "--prefetch", "2",
             "--seq_buckets", str(spec["seq"]),
             "--data_loader_workers", str(spec["workers"]),
             "--image_dir", corpus["images"],
             "--text_data_dir", corpus["text"],
             "--dataset_metadata", corpus["metadata"],
             "--decoded_crop_cache", corpus["cache"],
             "--bert_pretrained_dir", corpus["bert"],
             "--save_directory", os.path.join(root, f"run-{task}-{run}"),
             "--device", spec["device"]]
    if run == "world":
        flags += WORLD_CLI_MESH[task]
        if backend:
            flags += ["--dist_backend", backend]
    else:
        flags += ["--resume_from", os.path.join(root, f"run-{task}-world",
                                                "mi_epoch1.ckpt")]
    return flags


def world_cli_run(job: str, task: str, root: str, backend: str,
                  spec: dict) -> dict:
    """``task``'s run "world" through ``mimm_tpu_torch.cli.multi_modal.main``
    on this rank, in the world the task ran in (the entry point uses the
    group it finds); rank 0 keeps the whole final state.  Returns the
    run's launches, seconds and steps."""
    from mimm_tpu_torch.cli import multi_modal

    torch.backends.cudnn.deterministic = True
    for mod in (fa, sc, pc, ff):
        mod.reset_launch_counts()   # the tp_cli / pp_cli path starts here
    t0 = time.perf_counter()
    _, state = multi_modal.main(_world_cli_flags(task, "world", root, spec,
                                                 backend))
    _sync(spec["device"])
    info = {"launches": _all_launches(),    # ... and ends here
            "seconds": time.perf_counter() - t0, "steps": state.step}
    tree = _flat_tree(state)        # every rank: TP pieces, stages gathered
    if mesh_lib.world_rank() == 0:
        torch.save(tree, os.path.join(job, "tree.pt"))
    return info


def world_cli_resume(task: str, root: str, spec: dict) -> dict:
    """``task``'s run "R1" in this process, then the comparisons: the
    world's last checkpoint against its gathered final state (the entries
    that differ, whole shapes), and the resumed epoch against the
    world's (epoch losses; the weights' largest |Δ| and share > 1e-6).
    Returns them with the seconds and the checkpoint's tree."""
    from mimm_tpu_torch import preempt
    from mimm_tpu_torch.cli import multi_modal

    t0 = time.perf_counter()
    try:
        with deterministic_cudnn():
            _, state = multi_modal.main(_world_cli_flags(task, "R1", root,
                                                         spec, ""))
        _sync(spec["device"])
        r1_tree = _flat_tree(state)
    finally:
        preempt.uninstall()
        preempt.clear()
    seconds = time.perf_counter() - t0
    world = torch.load(os.path.join(root, task, "tree.pt"), weights_only=True)
    last = os.path.join(root, f"run-{task}-world",
                        f"mi_epoch{WORLD_CLI_EPOCHS}.ckpt")
    saved = _flat(ckpt.load_checkpoint(last))
    differ = sorted(set(world) ^ set(saved)) + [
        k for k in world if k in saved and not (
            torch.equal(world[k], saved[k]) if torch.is_tensor(world[k])
            else world[k] == saved[k])]
    params = [k for k in world if torch.is_tensor(world[k])
              and world[k].is_floating_point() and "_opt/" not in k
              and "running" not in k]
    d = torch.cat([(world[k] - r1_tree[k]).abs().reshape(-1) for k in params])
    return {"seconds": seconds, "last": last, "saved": saved,
            "entries": len(world), "differ": differ,
            "whole": all(torch.is_tensor(v) and v.shape == saved[k].shape
                         for k, v in world.items()
                         if torch.is_tensor(v) and k in saved),
            "r1_max": d.max().item(),
            "r1_share": (d > 1e-6).float().mean().item(),
            "loss": {run: [r["epoch_loss"] for r in _jsonl(os.path.join(
                root, f"run-{task}-{run}")) if "epoch_loss" in r]
                for run in ("world", "R1")}}


def _tp_compare_line(c: dict) -> str:
    return ", ".join(f"{g} {c['grad'][g]:.2e} ({cos:.9f}, {ratio:.9f})"
                     for g, (cos, ratio) in c["agree"].items())


def drive_tp(root: str, device, backend: str = "gloo", spec=None) -> dict:
    """Phase 17: worlds of 2 ranks on the one card (gloo over CUDA tensors,
    as phase 16 found NCCL refuses two ranks on one device): (a) TP on
    ``{'model': 2}`` against one rank at dropout 0, and each rank's flash
    heads at dropout 0.1; (b) TP + SP against (a); the fused FFN layer
    under TP; (c) ZeRO-1 and ZeRO-1 + FSDP against the replicated world;
    (d) the AE likewise; (e) ``cli.multi_modal --mesh_shape model=2
    --sequence_parallel true`` from disk, its checkpoint reloaded and
    resumed on one rank.  Returns the paths' launches and the numbers."""
    spec = dict(TP_SPEC, device=str(device), **(spec or {}))
    cuda = torch.device(device).type == "cuda"
    card = card_line() if cuda else "cpu"
    started = time.perf_counter()
    bad = []
    # ---- the world: (a)-(d), then (e)'s run on the entry point ----------------
    write_world_cli_corpus(root, "tp17", spec, SEED + 75, spec["cli_bert"])
    t0 = time.perf_counter()
    world = world_start(root, "tp17", "tp17", TP_WORLD, spec, root,
                        backend=backend)
    # ---- one rank, while the world runs (the same bits either way) --------------
    t1 = time.perf_counter()
    with deterministic_cudnn():
        one = tp_steps(None, device, spec)
        _empty_cache(device)
        heads1 = tp_flash_heads(None, device, spec)
        _empty_cache(device)
        ffn1 = tp_ffn_layer(None, device, spec)
        _empty_cache(device)
    one_s = time.perf_counter() - t1
    ranks = world_wait(world)
    world_s = time.perf_counter() - t0
    got = [torch.load(os.path.join(root, "tp17", f"tp17-rank{r}.pt"),
                      weights_only=True) for r in range(TP_WORLD)]
    print(f"  world of {TP_WORLD} ({ranks[0]['backend']}, "
          f"{ranks[0]['device']} and {ranks[1]['device']}): {world_s:.1f} s "
          f"(host clock, process start included; (a) + (b) "
          f"{ranks[0]['tp_seconds']:.1f} s; one rank's references beside "
          f"it)")
    # ---- (a) ------------------------------------------------------------------
    mine = got[0]["a"]
    c = _compare(dict(mine, running=mine["snaps"][0]["batch_stats"]),
                 dict(one, running=one["snaps"][0]["batch_stats"]))
    emb = {g: ((mine["emb"][g] - one["emb"][g]).abs().max()
               / one["emb"][g].abs().max().clamp_min(1e-30)).item()
           for g in one["emb"]}
    moved = [{g: v for g, v in _step_diff((0.0, mine["snaps"][s]),
                                          (0.0, one["snaps"][s])).items()
              if g not in ("loss_diff", "loss", "moments")}
             for s in range(2)]
    print(f"  (a) {{'model': {TP_WORLD}}} TP, f32 L={spec['seq']} "
          f"pallas_stem at dropout 0, against one rank (deterministic "
          f"cuDNN): embeddings max |Δ| / max |emb| "
          + ", ".join(f"{g} {v:.2e}" for g, v in emb.items())
          + f" (text held to {TP_EMB:.0e}); gradients max |Δg| / max |g| "
          f"(cosine, norm ratio): {_tp_compare_line(c)} (held: "
          f"{TP_GRAD:.0e}, cosine at least {TP_COS:.7g}, norm ratio within "
          f"{TP_NORM}); losses {mine['losses']} against {one['losses']} "
          f"(held: {STEP_LOSS_ATOL:.0e}, then {TP_LOSS2:.1e}); running "
          f"statistics {c['running']:.2e}")
    for s in range(2):
        print(f"  (a) after Adam step {s + 1}, max |dparam|, share > 1e-6: "
              f"{_shares_line(moved[s])}"
              + (f" (held: shares {WORLD_HALVES_SHARE})" if s == 0
                 else " (not held)"))
    if any(v[1] > WORLD_HALVES_SHARE[g] for g, v in moved[0].items()):
        bad.append(f"(a) weights after Adam step 1: {moved[0]}")
    if emb["text"] > TP_EMB:
        bad.append(f"(a) text embeddings {emb}")
    if any(v > TP_GRAD for v in c["grad"].values()) or any(
            cos < TP_COS or not TP_NORM[0] <= ratio <= TP_NORM[1]
            for cos, ratio in c["agree"].values()):
        bad.append(f"(a) gradients against one rank {c['grad']} "
                   f"{c['agree']}")
    if c["loss"][0] > STEP_LOSS_ATOL or c["loss"][1] > TP_LOSS2:
        bad.append(f"(a) losses {mine['losses']} against {one['losses']}")
    if c["running"] > WORLD_BN_RTOL:
        bad.append(f"(a) running statistics {c['running']}")
    layers = spec["bert_kw"]["num_hidden_layers"]
    for r, rk in enumerate(ranks):
        for path in ("a", "b"):
            launches = rk[path]["launches"]
            want = {fa.KERNELS[torch.float32]: 2 * layers,
                    fa.BWD_KERNELS[torch.float32]: 2 * layers}
            print(f"  ({path}) rank {r}: 2 steps in "
                  f"{rk[path]['seconds']:.3f} s (host clock), launches "
                  f"{launches}")
            if cuda and any(launches.get(n, 0) != k for n, k in want.items()):
                bad.append(f"({path}) rank {r} launched {launches}, want "
                           f"{want} (once per layer per step)")
    heads = heads1.shape[1] // TP_WORLD
    head_err = [(got[r]["heads"] - heads1[:, r * heads:(r + 1) * heads])
                .abs().max().item() for r in range(TP_WORLD)]
    print(f"  (a) dropout 0.1, each rank's first flash call ({heads} heads "
          f"at offset {heads} · rank of {heads1.shape[1]}) against one "
          f"rank's heads: max abs err {[f'{e:.2e}' for e in head_err]} (tol "
          f"{KERNEL_TOL[torch.float32]:.0e})")
    if max(head_err) > KERNEL_TOL[torch.float32]:
        bad.append(f"(a) flash heads at dropout 0.1: {head_err}")
    # ---- (b) ------------------------------------------------------------------
    s = ranks[0]["sp_vs_tp"]
    print(f"  (b) TP + SP against (a)'s TP: embeddings bit for bit "
          f"{s['emb_equal']}, step 1's loss {s['loss1_equal']}, step 2's "
          f"|Δ| {s['loss2_diff']:.2e}; gradients differing outside the "
          f"SP-summed tensors: {s['grads_differ_not_summed'][:4]} "
          f"({len(s['grads_differ_not_summed'])}); the SP-summed LayerNorms "
          f"and row-parallel biases: {s['summed_differ']} of "
          f"{s['summed_total']} differ, max |Δg| / max |g| "
          f"{s['summed_max']:.2e} (held: {TP_SP_SUM:.0e}); tensors apart "
          f"after Adam step 1: {s['snap1_differ']}")
    if not (s["emb_equal"] and s["loss1_equal"]) \
            or s["grads_differ_not_summed"] or s["summed_max"] > TP_SP_SUM \
            or s["loss2_diff"] > TP_LOSS2:
        bad.append(f"(b) TP + SP against TP: {s}")
    # ---- the fused FFN layer ------------------------------------------------------
    # the key bias's gradient is 0 up to rounding (a softmax is unchanged
    # by a shift of a query's scores), so it has no scale to hold it to
    ffn_err = {k: max(_scaled_err(got[r]["ffn"][k], v)
                      for r in range(TP_WORLD)) for k, v in ffn1.items()
               if k not in ("launches", "attention.self.key.bias")}
    worst = max(ffn_err, key=ffn_err.get)
    print(f"  fused FFN layer under TP (f = "
          f"{spec['ffn_bert']['intermediate_size'] // TP_WORLD} a rank, f32, "
          f"T = {spec['batch'] * spec['seq']}) against unsharded, max |Δ| / "
          f"max |ref| over {len(ffn_err)} outputs: worst {worst} "
          f"{ffn_err[worst]:.2e}, y {ffn_err['y']:.2e}, dx "
          f"{ffn_err['dx']:.2e} (tol {TP_FFN_TOL:.0e}); launches by rank "
          f"{[rk['ffn_launches'] for rk in ranks]}")
    if ffn_err[worst] > TP_FFN_TOL:
        bad.append(f"FFN layer under TP: {worst} {ffn_err[worst]}")
    if cuda and not all(rk["ffn_launches"].get(n, 0) == 1
                        for rk in ranks for n in ff.KERNELS.values()):
        bad.append(f"FFN layer launches {[rk['ffn_launches'] for rk in ranks]}")
    # ---- (c), (d) ----------------------------------------------------------------
    for r, rk in enumerate(ranks):
        for mode, z in rk["zero"].items():
            gib = {k: v / 2 ** 30 for k, v in z["bytes"].items()}
            print(f"  (c) rank {r} {mode}: losses {z['losses']}, 2 steps in "
                  f"{z['seconds']:.3f} s (host clock); resident params + "
                  f"moments {gib['counted']:.3f} GiB (rule of "
                  f"zero1_shardings: {gib['predicted']:.3f}), "
                  f"memory_allocated after the steps {gib['allocated']:.3f} "
                  f"GiB; tensors differing from replicated: "
                  f"{len(z['differ'])} {z['differ'][:3]}")
            if z["differ"] or z["losses"] != rk["zero"]["replicated"][
                    "losses"] or z["bytes"]["counted"] != \
                    z["bytes"]["predicted"]:
                bad.append(f"(c) rank {r} {mode}: {z}")
        for mode, z in rk["ae"].items():
            print(f"  (d) rank {r} AE {mode}: losses {z['losses']}; tensors "
                  f"differing from replicated: {len(z['differ'])}")
            if z["differ"] or z["losses"] != rk["ae"]["replicated"]["losses"]:
                bad.append(f"(d) rank {r} AE {mode}: {z}")
    # ---- (e): the entry point ----------------------------------------------------
    runs = [rk["cli"] for rk in ranks]
    e = world_cli_resume("tp17", root, spec)
    print(f"  (e) cli.multi_modal {' '.join(WORLD_CLI_MESH['tp17'])} (f32, "
          f"pallas_stem, {2 * spec['long']} pairs, "
          f"{runs[0]['steps'] // WORLD_CLI_EPOCHS} steps an epoch, "
          f"{WORLD_CLI_EPOCHS} epochs) in the world above in "
          f"{runs[0]['seconds']:.1f} s (host clock), one rank resuming epoch "
          f"2 from its mi_epoch1.ckpt in this process in {e['seconds']:.1f} "
          f"s; mi_epoch{WORLD_CLI_EPOCHS}.ckpt against the world's gathered "
          f"state: {e['entries']} entries, {len(e['differ'])} differ, whole "
          f"tensors {e['whole']}; epoch losses world {e['loss']['world']}, "
          f"one rank {e['loss']['R1']} (held: epoch 2 within (a)'s "
          f"{TP_LOSS2:.1e}); weights after epoch 2 max |Δ| "
          f"{e['r1_max']:.2e}, share > 1e-6 {e['r1_share']:.2e} (held: "
          f"{STEP_FLIP_SHARE:.0e}); launches by rank "
          f"{[r['launches'] for r in runs]}  [{card}]")
    if e["differ"] or not e["whole"]:
        bad.append(f"(e) the checkpoint against the world's state: "
                   f"{e['differ'][:3]}")
    if len(e["loss"]["R1"]) != 1 or abs(e["loss"]["R1"][0]
                                        - e["loss"]["world"][-1]) > \
            TP_LOSS2 or e["r1_share"] > STEP_FLIP_SHARE:
        bad.append(f"(e) one rank's resumed epoch against the world's: "
                   f"{e['loss']}, {e['r1_max']}, {e['r1_share']}")
    seconds_all = time.perf_counter() - started
    print(f"  phase 17: {seconds_all:.1f} s (host clock; one rank's "
          f"references {one_s:.1f} s)  [{card}]")
    if bad:
        raise AssertionError("; ".join(bad))
    count = lambda key: sum((collections.Counter(rk[key]["launches"])
                             for rk in ranks), collections.Counter())
    zero = collections.Counter()
    for rk in ranks:
        for z in rk["zero"].values():
            zero.update(z["launches"])
    cli = collections.Counter()
    for r in runs:
        cli.update(r["launches"])
    ffn = collections.Counter()
    for rk in ranks:
        ffn.update(rk["ffn_launches"])
    return {"tp_world": dict(count("a")), "sp_world": dict(count("b")),
            "zero_world": dict(zero), "tp_cli": dict(cli),
            "tp_ffn": dict(ffn), "seconds": seconds_all,
            # each rank's counted resident bytes of (c) and (d), by mode
            "zero_bytes": [{m: z["bytes"]["counted"]
                            for m, z in rk["zero"].items()} for rk in ranks],
            "ae_bytes": [{m: z["bytes"] for m, z in rk["ae"].items()}
                         for rk in ranks]}


# ---- phase 18: GPipe pipeline parallelism of the text tower ---------------

PP_WORLD = 2
PP_MICRO = 4            # (a), (b): M, 16 rows a microbatch at B = 64
# (a) {'pipe': 2} against one rank, f32 L=320 at dropout 0, deterministic
# cuDNN on both sides: each rank runs the image tower whole (its
# embeddings bit for bit one rank's), and the text tower's layers run on
# microbatches of B/M rows, whose products cuBLAS may sum in another order
# than the whole batch's; the [CLS] rows then differ by f32 rounding,
# which the cancelling DV gradient magnifies as in phase 17 (a).  Held to
# phase 17 (a)'s limits: the text embeddings TP_EMB, the gradients TP_GRAD /
# TP_COS / TP_NORM, step 1's loss phase 5's 1e-5 and step 2's TP_LOSS2,
# the shares moved after Adam step 1 WORLD_HALVES_SHARE.  Each rank
# launches the f32 flash forward and backward once per layer of its stage
# and microbatch: n/S × M a step.  (b) the bf16 production step at dropout
# 0.1 with remat: two runs give the same bits, the flash forward 2 × n/S ×
# M a step (remat recomputes it), the backward n/S × M.  (c) each rank's
# resident text parameters and moments: its stage's layers and the
# replicated rest, whole, counted against that rule.  (d) the entry point
# from disk: the checkpoint is the world's gathered state in the plain
# layout, and one rank resumes its epoch 2 within phase 17 (e)'s limits.


@contextlib.contextmanager
def _captured_embeddings():
    """Inside, the first two tensors the MI step hands
    ``parallel.mesh.gather_rows`` (the image and the text embeddings, with
    a mesh or without) are kept, float32 on the CPU, in the yielded
    dict."""
    seen = []
    real = mesh_lib.gather_rows

    def gather(x, mesh):
        if len(seen) < 2:
            seen.append(x.detach().float().cpu().clone())
        return real(x, mesh)

    mesh_lib.gather_rows = gather
    out = {}
    try:
        yield out
    finally:
        mesh_lib.gather_rows = real
        out.update(zip(("image", "text"), seen))


def _pp_resident(state, mesh) -> dict:
    """This rank's bytes of text parameters and moments, counted, by the
    stage rule (its stage's layers and the replicated rest, whole) and for
    one rank (every tensor whole)."""
    params = dict(state.model.text_model.named_parameters())
    opt = state.txt_opt
    counted = sum(p.numel() * p.element_size() for p in params.values()) \
        + sum(t.numel() * t.element_size()
              for part in (opt.mu, opt.nu) for t in part.values())
    if state.layout is None:
        return {"counted": counted, "rule": counted, "one_rank": counted}
    layout = state.layout.groups["text_model"]
    rule = one = 0
    for n, p in params.items():
        size = p.element_size() + opt.mu[n].element_size() \
            + opt.nu[n].element_size()
        numel = math.prod(layout.shapes[n])
        one += numel * size
        if layout.pipe[n] in (None, mesh.pipe_rank):
            rule += numel * size
    return {"counted": counted, "rule": rule, "one_rank": one}


def pp_steps(mesh, device, spec: dict) -> dict:
    """(a) / (c): phase 17 (a)'s f32 L=320 step (production preset,
    ``pallas_stem``, dropout 0) from its seeded weights and batches,
    pipelined over ``mesh``'s 'pipe' axis at M = PP_MICRO (one rank with
    ``mesh`` None): two Adam steps, their losses, whole states and kernel
    launches, step 1's gradients (the stages' layers gathered) and
    embeddings, the rank's resident text bytes and peak memory."""
    bc = BertConfig(**{**spec["bert_kw"], "hidden_dropout_prob": 0.0,
                       "attention_probs_dropout_prob": 0.0})
    batch = spec["batch"]
    cfg = TrainingConfig.production(compute_dtype="float32", pallas_stem=True,
                                    pipeline_microbatches=PP_MICRO)
    data = _tp_data(spec, bc, device)
    txs = mi.make_optimizers(cfg, steps_per_epoch=200_000 // batch)
    taps = {"image": {}, "text": {}, "critic": {}}
    txs = mi.MIOptimizers(**{k: _recording(getattr(txs, k), taps[g])
                             for k, g in (("img", "image"), ("txt", "text"),
                                          ("mi", "critic"))})
    model = mi.build_joint_model(cfg, bc, device=device)
    state = mesh_lib.shard_mi_state(mesh, mi.create_mi_state(
        model, cfg, txs, torch.Generator().manual_seed(SEED + 63)))
    out = {"losses": [], "snaps": [], "resident": _pp_resident(state, mesh)}
    step = mi.make_mi_train_step(model, txs, cfg, mesh=mesh)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for mod in (fa, sc, pc, ff):
        mod.reset_launch_counts()      # the pp world path starts here
    t0 = time.perf_counter()
    with _captured_embeddings() as emb:
        for d in data:
            state, loss = step(state, d)
            out["losses"].append(loss.item())
            out["snaps"].append(_tree_snap(state))
    _sync(device)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = _all_launches()          # ... and ends here
    out["peak"] = torch.cuda.max_memory_allocated(device) \
        if torch.device(device).type == "cuda" else 0
    if state.layout is not None:      # step 1's stage layers, whole
        layout = state.layout.groups["text_model"]
        taps["text"] = {n: t.cpu() for n, t in mesh_lib.gather_stages(
            {n: t.to(device) for n, t in taps["text"].items()}, layout.pipe,
            layout.shapes, mesh).items()}
    out.update(grads=taps, emb=emb)
    return out


def pp_remat_steps(mesh, device, spec: dict) -> dict:
    """(b): the bf16 production step at dropout 0.1 with remat, pipelined
    at M = PP_MICRO, twice from the same seeded state and batch: each
    run's loss, whole state after the step and launches."""
    bc = BertConfig(**{**spec["bert_kw"], "remat": True})
    cfg = TrainingConfig.production(pipeline_microbatches=PP_MICRO)
    d = _tp_data(spec, bc, device)[0]
    runs = []
    for _ in range(2):
        model = mi.build_joint_model(cfg, bc, device=device)
        txs = mi.make_optimizers(cfg, steps_per_epoch=200_000 // spec["batch"])
        state = mesh_lib.shard_mi_state(mesh, mi.create_mi_state(
            model, cfg, txs, torch.Generator().manual_seed(SEED + 81)))
        step = mi.make_mi_train_step(model, txs, cfg, mesh=mesh)
        for mod in (fa, sc, pc, ff):
            mod.reset_launch_counts()      # the pp remat path starts here
        state, loss = step(state, d)
        _sync(device)
        launches = _all_launches()         # ... and ends here
        runs.append({"loss": loss.item(), "launches": launches,
                     "snap": _tree_snap(state)})
        del model, state, step
        _empty_cache(device)
    return {"losses": [r["loss"] for r in runs],
            "launches": [r["launches"] for r in runs],
            "differ": _snap_differ(runs[1]["snap"], runs[0]["snap"])}


def pp_worker(job: str, mesh, dev, spec: dict) -> dict:
    """The 'pp18' task of a world of 2 on ``{'pipe': 2}``: (a) with (c)'s
    bytes, then (b).  Rank 0 keeps (a)'s tensors for the parent."""
    out = {}
    with deterministic_cudnn():
        a = pp_steps(mesh, dev, spec)
        _empty_cache(dev)
        out["a"] = {k: a[k] for k in ("losses", "launches", "seconds",
                                      "resident", "peak")}
        if mesh_lib.world_rank() == 0:
            torch.save({k: a[k] for k in ("grads", "emb", "losses", "snaps")},
                       os.path.join(job, "pp18-a.pt"))
        del a
        t0 = time.perf_counter()
        out["b"] = pp_remat_steps(mesh, dev, spec)
        out["b"]["seconds"] = time.perf_counter() - t0
    return out


def drive_pp(root: str, device, backend: str = "gloo", spec=None) -> dict:
    """Phase 18: a world of 2 ranks on ``{'pipe': 2}`` on the one card
    (phase 16's backend): (a) the f32 step pipelined at M = PP_MICRO
    against one rank, with the flash launches of each stage; (b) the bf16
    step at dropout 0.1 with remat, twice; (c) each rank's resident text
    bytes against the stage rule, its peak memory; (d) ``cli.multi_modal
    --mesh_shape pipe=2 --pipeline_microbatches 2`` from disk:
    its checkpoint against the world's gathered state, the plain layout,
    the converter's ``.bin`` files loaded strict, one rank resuming epoch
    2 from it.  Returns the paths' launches and the numbers."""
    from mimm_tpu_torch.tools import convert_checkpoint

    spec = dict(TP_SPEC, device=str(device), **(spec or {}))
    cuda = torch.device(device).type == "cuda"
    card = card_line() if cuda else "cpu"
    started = time.perf_counter()
    bad = []
    # dropout 0: the pipeline draws its masks per (layer, microbatch), one
    # rank from one stream (parallel/pipeline.py), so (d)'s one-rank epoch
    # equals the world's only without dropout, as JAX's tests compare them
    write_world_cli_corpus(root, "pp18", spec, SEED + 85, dict(
        spec["cli_bert"], hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0))
    t0 = time.perf_counter()
    world = world_start(root, "pp18", "pp18", PP_WORLD, spec, root,
                        backend=backend)
    # ---- one rank, while the world runs (the same bits either way) --------------
    t1 = time.perf_counter()
    with deterministic_cudnn():
        one = pp_steps(None, device, spec)
    _empty_cache(device)
    one_s = time.perf_counter() - t1
    ranks = world_wait(world)
    world_s = time.perf_counter() - t0
    got = torch.load(os.path.join(root, "pp18", "pp18-a.pt"),
                     weights_only=True)
    print(f"  world of {PP_WORLD} on {{'pipe': {PP_WORLD}}} "
          f"({ranks[0]['backend']}, {ranks[0]['device']} and "
          f"{ranks[1]['device']}): {world_s:.1f} s (host clock, process "
          f"start included; one rank's references beside it)")
    # ---- (a) ------------------------------------------------------------------
    layers = spec["bert_kw"]["num_hidden_layers"]
    per = layers // PP_WORLD * PP_MICRO         # launches a stage a step
    c = _compare(dict(got, running=got["snaps"][0]["batch_stats"]),
                 dict(one, running=one["snaps"][0]["batch_stats"]))
    emb = {g: ((got["emb"][g] - one["emb"][g]).abs().max()
               / one["emb"][g].abs().max().clamp_min(1e-30)).item()
           for g in one["emb"]}
    image_equal = torch.equal(got["emb"]["image"], one["emb"]["image"])
    moved = [{g: v for g, v in _step_diff((0.0, got["snaps"][s]),
                                          (0.0, one["snaps"][s])).items()
              if g not in ("loss_diff", "loss", "moments")}
             for s in range(2)]
    print(f"  (a) {{'pipe': {PP_WORLD}}} GPipe at M={PP_MICRO}, f32 "
          f"L={spec['seq']} pallas_stem at dropout 0, against one rank "
          f"(deterministic cuDNN): image embeddings bit for bit "
          f"{image_equal}; embeddings max |Δ| / max |emb| "
          + ", ".join(f"{g} {v:.2e}" for g, v in emb.items())
          + f" (text held to {TP_EMB:.0e}); gradients max |Δg| / max |g| "
          f"(cosine, norm ratio): {_tp_compare_line(c)} (held: "
          f"{TP_GRAD:.0e}, cosine at least {TP_COS:.7g}, norm ratio within "
          f"{TP_NORM}); losses {got['losses']} against {one['losses']} "
          f"(held: {STEP_LOSS_ATOL:.0e}, then {TP_LOSS2:.1e}); running "
          f"statistics {c['running']:.2e}")
    for s in range(2):
        print(f"  (a) after Adam step {s + 1}, max |dparam|, share > 1e-6: "
              f"{_shares_line(moved[s])}"
              + (f" (held: shares {WORLD_HALVES_SHARE})" if s == 0
                 else " (not held)"))
    if not image_equal:
        bad.append("(a) image embeddings differ from one rank's")
    if any(v[1] > WORLD_HALVES_SHARE[g] for g, v in moved[0].items()):
        bad.append(f"(a) weights after Adam step 1: {moved[0]}")
    if emb["text"] > TP_EMB:
        bad.append(f"(a) text embeddings {emb}")
    if any(v > TP_GRAD for v in c["grad"].values()) or any(
            cos < TP_COS or not TP_NORM[0] <= ratio <= TP_NORM[1]
            for cos, ratio in c["agree"].values()):
        bad.append(f"(a) gradients against one rank {c['grad']} "
                   f"{c['agree']}")
    if c["loss"][0] > STEP_LOSS_ATOL or c["loss"][1] > TP_LOSS2:
        bad.append(f"(a) losses {got['losses']} against {one['losses']}")
    if c["running"] > WORLD_BN_RTOL:
        bad.append(f"(a) running statistics {c['running']}")
    want = {fa.KERNELS[torch.float32]: 2 * per,
            fa.BWD_KERNELS[torch.float32]: 2 * per}
    for r, rk in enumerate(ranks):
        launches = rk["a"]["launches"]
        print(f"  (a) rank {r}: 2 steps in {rk['a']['seconds']:.3f} s (host "
              f"clock), launches {launches} (flash: {per} a step each way: "
              f"{layers // PP_WORLD} layers x {PP_MICRO} microbatches)")
        if cuda and any(launches.get(n, 0) != k for n, k in want.items()):
            bad.append(f"(a) rank {r} launched {launches}, want {want}")
    print(f"  (a) one rank: 2 steps in {one['seconds']:.3f} s, launches "
          f"{one['launches']}")
    # ---- (b) ------------------------------------------------------------------
    want_b = {fa.KERNELS[torch.bfloat16]: 2 * per,
              fa.BWD_KERNELS[torch.bfloat16]: per}
    for r, rk in enumerate(ranks):
        b = rk["b"]
        print(f"  (b) rank {r}: bf16 production step at dropout 0.1 with "
              f"remat, M={PP_MICRO}, twice from one state: losses "
              f"{b['losses']}, tensors differing {len(b['differ'])} "
              f"{b['differ'][:3]}, launches {b['launches']} (flash forward "
              f"{2 * per} with remat, backward {per}); {b['seconds']:.1f} s")
        if b["differ"] or b["losses"][0] != b["losses"][1] \
                or not math.isfinite(b["losses"][0]):
            bad.append(f"(b) rank {r}: {b['losses']}, {b['differ'][:3]}")
        if cuda and any(l.get(n, 0) != k for l in b["launches"]
                        for n, k in want_b.items()):
            bad.append(f"(b) rank {r} launched {b['launches']}, want {want_b}")
    # ---- (c) ------------------------------------------------------------------
    for r, rk in enumerate(ranks):
        res = {k: v / 2 ** 30 for k, v in rk["a"]["resident"].items()}
        print(f"  (c) rank {r}: resident text params + moments "
              f"{res['counted']:.4f} GiB, the stage rule {res['rule']:.4f} "
              f"GiB, one rank {res['one_rank']:.4f} GiB; peak memory "
              f"{rk['a']['peak'] / 2 ** 30:.2f} GiB (print only; one rank "
              f"{one['peak'] / 2 ** 30:.2f} GiB)  [{card}]")
        if rk["a"]["resident"]["counted"] != rk["a"]["resident"]["rule"] \
                or not rk["a"]["resident"]["counted"] < \
                rk["a"]["resident"]["one_rank"]:
            bad.append(f"(c) rank {r} resident bytes {rk['a']['resident']}")
    # ---- (d): the entry point ----------------------------------------------------
    runs = [rk["cli"] for rk in ranks]
    e = world_cli_resume("pp18", root, spec)
    cli_layers = spec["cli_bert"]["num_hidden_layers"]
    shape = (spec["cli_bert"]["hidden_size"],
             spec["cli_bert"]["intermediate_size"])
    plain = all(tuple(e["saved"].get(
        f"/text_model/bert.encoder.layer.{i}.output.dense.weight",
        torch.empty(0)).shape) == shape for i in range(cli_layers))
    conv = os.path.join(root, "converted18")
    convert_checkpoint.convert("mi", e["last"], conv)
    bc = BertConfig.from_json_file(os.path.join(root, "run-pp18-world",
                                                "config.json"))
    for model, fname in ((ResNet256_6_2_1(), "pytorch_MI_image_model.bin"),
                         (TextBert(bc), "pytorch_MI_text_model.bin"),
                         (ImageReportModel(bc),
                          f"pytorch_model_epoch{WORLD_CLI_EPOCHS}.bin")):
        model.load_state_dict(ckpt.load_state_dict_bin(
            os.path.join(conv, fname)), strict=True)
    print(f"  (d) cli.multi_modal {' '.join(WORLD_CLI_MESH['pp18'])} (f32, "
          f"pallas_stem, dropout 0, {2 * spec['long']} pairs, "
          f"{runs[0]['steps'] // WORLD_CLI_EPOCHS} steps an epoch, "
          f"{WORLD_CLI_EPOCHS} epochs) in the world above in "
          f"{runs[0]['seconds']:.1f} s (host clock), one rank resuming epoch "
          f"2 from its mi_epoch1.ckpt in this process in {e['seconds']:.1f} "
          f"s; mi_epoch{WORLD_CLI_EPOCHS}.ckpt against the world's gathered "
          f"state: {e['entries']} entries, {len(e['differ'])} differ, the "
          f"plain layout (layer0..{cli_layers - 1} whole) {plain}; the "
          f"converter's .bin files loaded strict; epoch losses world "
          f"{e['loss']['world']}, one rank {e['loss']['R1']} (held: epoch 2 "
          f"within {TP_LOSS2:.1e}); weights after epoch 2 max |Δ| "
          f"{e['r1_max']:.2e}, share > 1e-6 {e['r1_share']:.2e} (held: "
          f"{STEP_FLIP_SHARE:.0e}); launches by rank "
          f"{[r['launches'] for r in runs]}  [{card}]")
    if e["differ"] or not plain:
        bad.append(f"(d) the checkpoint against the world's state: "
                   f"{e['differ'][:3]}, plain layout {plain}")
    if len(e["loss"]["R1"]) != 1 or abs(e["loss"]["R1"][0]
                                        - e["loss"]["world"][-1]) > \
            TP_LOSS2 or e["r1_share"] > STEP_FLIP_SHARE:
        bad.append(f"(d) one rank's resumed epoch against the world's: "
                   f"{e['loss']}, {e['r1_max']}, {e['r1_share']}")
    seconds_all = time.perf_counter() - started
    print(f"  phase 18: {seconds_all:.1f} s (host clock; the world "
          f"{world_s:.1f} s, one rank's references {one_s:.1f} s)  [{card}]")
    if bad:
        raise AssertionError("; ".join(bad))
    total = lambda counts: sum((collections.Counter(c) for c in counts),
                               collections.Counter())
    return {"pp_world": dict(total(rk["a"]["launches"] for rk in ranks)),
            "pp_remat": dict(total(l for rk in ranks
                                   for l in rk["b"]["launches"])),
            "pp_cli": dict(total(r["launches"] for r in runs)),
            "seconds": seconds_all,
            # each rank's (c) bytes: counted, by the stage rule, one rank's
            "resident": [rk["a"]["resident"] for rk in ranks]}


# ---- phase 19: the serving export -------------------------------------------

# artifact vs the live float32 session, max |Δ| / max(1, max |ref|): the
# same kernels run in the same order on the same weights, so expect 0
EXPORT_TOL = 1e-5
EXPORT_TIMED = 3        # batches timed through each artifact and session
# the inputs of each entry point, by their names in the child's in.npz
EXPORT_INPUTS = {"embed_images": ["images"],
                 "embed_texts": ["ids", "masks", "segs"],
                 "classify": ["images"]}
# the reload child: it imports only the manifests' ``requires`` (and
# torch, numpy), takes the parent's TF32 settings (PyTorch's default runs
# cuDNN convolutions in TF32, which the parent turns off), loads each
# artifact set as its manifest appears (the parent exports the next set
# meanwhile), runs each entry once with the kernels' counts from 0, and
# when every set is in, times each entry; writes out.npz / out.json
EXPORT_CHILD = r"""
import importlib, json, os, statistics, sys, time
import numpy as np
import torch

job = sys.argv[1]
with open(os.path.join(job, "job.json")) as f:
    spec = json.load(f)
torch.backends.cudnn.allow_tf32 = spec["tf32"]["cudnn"]
torch.backends.cuda.matmul.allow_tf32 = spec["tf32"]["matmul"]
x = dict(np.load(os.path.join(job, "in.npz")))
out, meta = {}, {"load_s": {}, "ms": {}, "launches": {}}
programs, modules = {}, {}
deadline = time.monotonic() + spec["wait_s"]
for name, d in spec["sets"].items():
    path = os.path.join(d, "manifest.json")     # written last by the export
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            sys.exit(f"no manifest at {path}")
        time.sleep(0.05)
    with open(path) as f:
        mf = json.load(f)
    for m in mf["requires"]:
        modules[m] = importlib.import_module(m)
    dev = torch.device(mf["device"])
    for entry, e in mf["entries"].items():
        key = f"{name}/{entry}"
        t0 = time.perf_counter()
        program = torch.export.load(os.path.join(d, e["file"])).module()
        meta["load_s"][key] = time.perf_counter() - t0
        args = [x[k] for k in spec["inputs"][entry]]

        def call(program=program, args=args, dev=dev):
            with torch.inference_mode():
                return program(*[torch.from_numpy(a).to(dev)
                                 for a in args]).cpu().numpy()
        for m in modules.values():
            m.reset_launch_counts()
        out[key] = call()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        meta["launches"][key] = {k: v for m in modules.values()
                                 for k, v in m.LAUNCHES.items()}
        programs[key] = (call, dev)
sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
for key, (call, dev) in programs.items():
    walls = []
    for _ in range(spec["timed"]):
        sync()
        t0 = time.perf_counter()
        call()
        walls.append(time.perf_counter() - t0)
    meta["ms"][key] = 1e3 * statistics.median(walls)
meta["modules"] = sorted(m for m in sys.modules
                         if m.startswith("mimm_tpu_torch"))
np.savez(os.path.join(job, "out.npz"), **out)
with open(os.path.join(job, "out.json"), "w") as f:
    json.dump(meta, f)
"""


def drive_export(root: str, device, bert_kw=BERT_BASE, ffn_kw=FFN_SERVE_BERT,
                 batch=BATCH, seq=SEQ) -> dict:
    """Phase 19: phase 4's checkpoints through ``export_artifacts`` (all
    three entries, and ``embed_texts`` again under ``ffn_kw``) on
    ``device``, reloaded and run in a child that imports only the
    ``requires``, started after the first set's export: it loads that set
    while this process exports the second and computes the live float32
    sessions' outputs over phase 4's requests.  Each artifact held to
    EXPORT_TOL against them, and (on the card) the flash and fused FFN
    forwards once a layer a text batch; the sessions timed after the
    child.  Returns the artifacts' launches and the numbers."""
    from mimm_tpu_torch.tools import export_serving

    cuda = torch.device(device).type == "cuda"
    card = card_line() if cuda else "cpu"
    started = time.perf_counter()
    save, bert_dir, _ = write_checkpoints(root, bert_kw)
    ffn_dir = os.path.join(root, "bert_ffn")
    os.makedirs(ffn_dir)
    with open(os.path.join(ffn_dir, "bert_config.json"), "w") as f:
        json.dump(ffn_kw, f, indent=2)
    images_u8, ids, masks = make_requests(batch, seq, bert_kw["vocab_size"])
    x = {"images": device_normalize(torch.from_numpy(
        images_u8[..., None])).numpy(), "ids": ids, "masks": masks,
        "segs": np.zeros_like(ids)}
    layers = bert_kw["num_hidden_layers"]
    sets = {"base": os.path.join(root, "exported"),
            "ffn": os.path.join(root, "exported_ffn")}
    job = os.path.join(root, "reload")
    os.makedirs(job)
    np.savez(os.path.join(job, "in.npz"), **x)
    with open(os.path.join(job, "job.json"), "w") as f:
        json.dump({"sets": sets, "inputs": EXPORT_INPUTS,
                   "timed": EXPORT_TIMED, "wait_s": 600,
                   "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                            "matmul": torch.backends.cuda.matmul.allow_tf32}},
                  f)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    manifests = {"base": export_serving.export_artifacts(
        save, sets["base"], batch_size=batch, bert_pretrained_dir=bert_dir,
        disease="Pneumonia", max_seq_length=seq, device=device)}
    export_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", EXPORT_CHILD, job],
                            env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    manifests["ffn"] = export_serving.export_artifacts(
        save, sets["ffn"], batch_size=batch, bert_pretrained_dir=ffn_dir,
        max_seq_length=seq, device=device, entries=["embed_texts"])
    _sync(device)
    export_s += time.perf_counter() - t0
    _empty_cache(device)
    sizes = {f"{name}/{entry}": os.path.getsize(os.path.join(
        sets[name], e["file"])) for name, mf in manifests.items()
        for entry, e in mf["entries"].items()}
    # meanwhile, the live float32 sessions' outputs over the same inputs
    sessions = {
        "base": InferenceSession(
            save, batch_size=batch, bert_config=BertConfig(**bert_kw),
            classifier_layers=list(DEFAULT_CLASSIFIER_LAYERS),
            disease="Pneumonia", max_seq_length=seq, device=device),
        "ffn": InferenceSession(save, batch_size=batch,
                                bert_config=BertConfig(**ffn_kw),
                                max_seq_length=seq, device=device)}
    want = {f"{name}/{entry}": getattr(sessions[name], entry)(
        *[x[k] for k in EXPORT_INPUTS[entry]])
        for name, mf in manifests.items() for entry in mf["entries"]}
    try:
        _, stderr = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    reload_s = time.perf_counter() - t1
    if proc.returncode != 0:
        raise AssertionError(f"the reload child failed (rc "
                             f"{proc.returncode}): {stderr[-4000:]}")
    with np.load(os.path.join(job, "out.npz")) as z:
        got = {k: z[k] for k in z.files}
    with open(os.path.join(job, "out.json")) as f:
        meta = json.load(f)
    for d in sets.values():
        shutil.rmtree(d)
    bad = []
    print(f"  exported {sorted(sizes)} on {manifests['base']['device']} in "
          f"{export_s:.1f} s; the reload child (imports "
          f"{manifests['base']['requires']}) in {reload_s:.1f} s (host clock, "
          f"process start included, the second export and the sessions' "
          f"outputs beside it; loads "
          + ", ".join(f"{k} {v:.2f} s" for k, v in meta["load_s"].items())
          + f")  [{card}]")
    models = [m for m in meta["modules"]
              if m.startswith("mimm_tpu_torch.models")]
    print(f"  the child's port modules: {meta['modules']}")
    if models:
        bad.append(f"the reload child loaded {models}")
    session_ms = {}
    for key in sorted(got):
        name, entry = key.split("/")
        fn = getattr(sessions[name], entry)
        args = [x[k] for k in EXPORT_INPUTS[entry]]
        walls = []
        for _ in range(EXPORT_TIMED):
            _sync(device)
            t0 = time.perf_counter()
            fn(*args)
            walls.append(time.perf_counter() - t0)
        session_ms[key] = 1e3 * statistics.median(walls)
        try:
            check_response(f"artifact {key}", got[key], want[key],
                           EXPORT_TOL, varied=entry != "classify")
        except AssertionError as e:
            bad.append(str(e))
        print(f"  {key}: {sizes[key] / 2 ** 20:.1f} MiB; a batch of {batch} "
              f"in {meta['ms'][key]:.2f} ms through the artifact, "
              f"{session_ms[key]:.2f} ms through the session (host clock, "
              f"median of {EXPORT_TIMED}, copies included); launches "
              f"{meta['launches'][key]}  [{card}]")
    want_launches = {"base/embed_texts": {fa.KERNELS[torch.float32]: layers},
                     "ffn/embed_texts": {fa.KERNELS[torch.float32]: layers,
                                         ff.KERNELS["fwd"]: layers}}
    for key, launched in meta["launches"].items():
        want = want_launches.get(key, {}) if cuda else {}
        if launched != want:
            bad.append(f"{key} launched {launched}, want {want}")
    del sessions
    _empty_cache(device)
    seconds = time.perf_counter() - started
    print(f"  phase 19: {seconds:.1f} s (host clock)  [{card}]")
    if bad:
        raise AssertionError("; ".join(bad))
    total = collections.Counter()
    for key in ("base/embed_images", "base/embed_texts", "base/classify"):
        total.update(meta["launches"][key])
    return {"launches": dict(total),
            "ffn_launches": dict(meta["launches"]["ffn/embed_texts"]),
            "export_s": export_s, "reload_s": reload_s, "bytes": sizes,
            "ms": meta["ms"], "session_ms": session_ms, "seconds": seconds}


# ---- phase 20: the CLI and ETL rest on the card's host ------------------------

ETL_STUDIES = 1000
ETL_DISEASES = ("Atelectasis", "Cardiomegaly", "Consolidation", "Edema",
                "Enlarged Cardiomediastinum", "Fracture", "Lung Lesion",
                "Lung Opacity", "No Finding", "Pleural Effusion",
                "Pleural Other", "Pneumonia", "Pneumothorax",
                "Support Devices")
ETL_WORDS = ("the", "heart", "size", "is", "normal", "no", "focal",
             "consolidation", "pleural", "effusion", "lungs", "are", "clear",
             "mild", "cardiomegaly", "stable", "left", "right", "lower",
             "lobe", "opacity", "atelectasis", "tube", "in", "place")


def write_mimic_tree(root: str, studies: int, seed: int) -> dict:
    """A seeded MIMIC-CXR-like tree of ``studies`` studies over the
    subfolders p10 and p11, as ``DatasetConfig`` paths: the metadata
    ``.csv.gz`` (one to three dicoms a study, PA / AP / LATERAL views),
    one report a study (a FINDINGS: section or none, an IMPRESSION: or
    none, header lines with colons, some with no text left), an empty
    image file for most dicoms, and the NegBio label ``.csv.gz`` (1.0,
    0.0, -1.0 or empty per disease).  Returns the config's fields."""
    import gzip

    rng = np.random.default_rng(seed)
    full = os.path.join(root, "full_data_set")
    cfg = {"data_dir": full,
           "image_storage_dir": os.path.join(full, "images"),
           "text_storage_dir": os.path.join(full, "text")}
    for k, sub in (("training", "training_data"), ("testing", "testing_data")):
        d = os.path.join(root, sub)
        cfg[f"{k}_data_dir"] = d
        cfg[f"{k}_image_dir"] = os.path.join(d, "images")
        cfg[f"{k}_text_dir"] = os.path.join(d, "text")
        cfg[f"{k}_dataset_labeldata"] = os.path.join(
            d, f"{k}_label_negbio.csv")

    def sentence():
        words = rng.choice(ETL_WORDS, int(rng.integers(3, 12)))
        return " ".join(words).capitalize() + "."

    meta = ["dicom_id,subject_id,study_id,"
            "PerformedProcedureStepDescription,ViewPosition"]
    labels = ["subject_id,study_id," + ",".join(ETL_DISEASES)]
    for i in range(studies):
        sub = ("p10", "p11")[i % 2]
        subject, study = f"{sub[1:]}{i:06d}", str(50000000 + i)
        for v in range(int(rng.integers(1, 4))):
            dicom = f"{i:08x}-{v}"
            view = ("PA", "AP", "LATERAL")[int(rng.integers(0, 3))]
            meta.append(f"{dicom},{subject},{study},CHEST,{view}")
            if rng.random() < 0.9:
                img = os.path.join(cfg["image_storage_dir"], sub,
                                   f"p{subject}_s{study}_{dicom}.jpg")
                os.makedirs(os.path.dirname(img), exist_ok=True)
                open(img, "wb").close()
        lines = ["FINAL REPORT", f"EXAMINATION: CHEST (PA AND LAT) {i}",
                 f"INDICATION: {sentence()}", ""]
        kind = int(rng.integers(0, 4))
        if kind == 0:       # FINDINGS and IMPRESSION sections
            lines += ["FINDINGS: " + sentence(), sentence(), "",
                      "IMPRESSION:", sentence()]
        elif kind == 1:     # paragraphs only, one with a colon
            lines += [sentence(), "", f"COMPARISON: {sentence()}",
                      sentence()]
        elif kind == 2:     # an IMPRESSION after a paragraph
            lines += [sentence(), "", "IMPRESSION: " + sentence()]
        # kind 3: headers only, nothing left to extract
        path = os.path.join(cfg["text_storage_dir"], sub, f"s{study}.txt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        cells = rng.choice(["1.0", "0.0", "-1.0", ""], len(ETL_DISEASES),
                           p=[0.2, 0.4, 0.1, 0.3])
        labels.append(f"{subject},{study}," + ",".join(cells))
    os.makedirs(full, exist_ok=True)
    for name, rows in (("mimic-cxr-2.0.0-metadata.csv.gz", meta),
                       ("mimic-cxr-2.0.0-negbio.csv.gz", labels)):
        with gzip.open(os.path.join(full, name), "wt") as f:
            f.write("\n".join(rows) + "\n")
    return cfg


def _flags(cfg: dict) -> list:
    return [a for k, v in cfg.items() for a in (f"--{k}", v)]


def _main_out(main, argv) -> tuple:
    """(return value, standard output) of an entry point's ``main``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def drive_etl(root: str, device, tp: dict, pp: dict, bert_kw=TRAIN_BERT,
              studies=ETL_STUDIES, spec=None) -> dict:
    """Phase 20: ``cli.dataset_populate``'s stages over
    ``write_mimic_tree``, read back through ``read_disease_stats`` and the
    datasets; ``tools.derive_buckets``, ``tools.corpus_check`` and
    ``cli.prebuild_cache`` over phase 12's corpus (``write_cli_corpus``
    with phase 12's arguments); ``tools.mem_report`` against the resident
    bytes phases 17 (c) / (d) (``tp``) and 18 (c) (``pp``) counted, at
    their configurations.  Host code only: ``device`` names the card of
    the phases whose bytes it reads."""
    import csv

    from mimm_tpu_torch.cli import dataset_populate, prebuild_cache
    from mimm_tpu_torch.data import etl
    from mimm_tpu_torch.data.pipeline import (CXRImageDataset,
                                              CXRImageDiseaseDataset)
    from mimm_tpu_torch.tools import corpus_check, derive_buckets, mem_report

    spec = dict(TP_SPEC, **(spec or {}))
    card = card_line() if torch.device(device).type == "cuda" else "cpu"
    started = time.perf_counter()
    bad = []
    # ---- the ETL through its entry point ---------------------------------------
    cfg = write_mimic_tree(os.path.join(root, "mimic"), studies, SEED + 91)
    written = time.perf_counter() - started
    t0 = time.perf_counter()
    for stage in ("download", "merge", "populate", "stats"):
        dataset_populate.main(["--stage", stage, "--subfolders", "p10,p11",
                               *_flags(cfg)])
    etl_s = time.perf_counter() - t0

    def rows(path, **kw):
        with open(path, newline="") as f:
            return list(csv.reader(f, **kw))
    subs = [rows(os.path.join(cfg["text_storage_dir"],
                              f"data_subfolder_{s}.tsv"), delimiter="\t")
            for s in ("p10", "p11")]
    merged = rows(os.path.join(cfg["training_text_dir"], "all_data.tsv"),
                  delimiter="\t")
    split = {k: rows(os.path.join(cfg[f"{k}_text_dir"], f"{k}_data.tsv"),
                     delimiter="\t") for k in ("training", "testing")}
    disease = "Cardiomegaly"
    read_back = {}
    for k in ("training", "testing"):
        table = rows(cfg[f"{k}_dataset_labeldata"])
        col = table[0].index(disease)
        stats = os.path.join(cfg[f"{k}_data_dir"], "disease_stats.csv")
        pos, neg = etl.read_disease_stats(stats, disease)
        ds = CXRImageDiseaseDataset(cfg["image_storage_dir"],
                                    cfg[f"{k}_dataset_labeldata"], disease,
                                    stats)
        read_back[k] = {
            "rows": len(CXRImageDataset(cfg["image_storage_dir"],
                                        cfg[f"{k}_dataset_labeldata"])),
            "pos": len(pos), "neg": len(neg),
            "want": (sum(r[col] == "1.0" for r in table[1:]),
                     sum(r[col] == "0.0" for r in table[1:])),
            "dataset": len(ds), "labels": int(sum(ds.labels))}
        r = read_back[k]
        if r["rows"] != len(split[k]) or (r["pos"], r["neg"]) != r["want"] \
                or (r["dataset"], r["labels"]) != (r["pos"] + r["neg"],
                                                   r["pos"]):
            bad.append(f"{k} read back: {r}, split rows {len(split[k])}")
    print(f"  cli.dataset_populate over {studies} studies (tree written in "
          f"{written:.1f} s): download (no fetch) p10 / p11 "
          f"{[len(s) for s in subs]} studies, merge {len(merged)}, populate "
          f"{len(split['training'])} train / {len(split['testing'])} test, "
          f"stats; {etl_s:.1f} s (host clock); read back through "
          f"read_disease_stats and the datasets ({disease}): "
          + ", ".join(f"{k} {v['rows']} rows, {v['pos']} pos / {v['neg']} "
                      f"neg, disease set {v['dataset']}"
                      for k, v in read_back.items()) + f"  [{card}]")
    if len(merged) != sum(map(len, subs)) or \
            len(split["training"]) + len(split["testing"]) == 0 or \
            not 0 < len(split["testing"]) < len(split["training"]):
        bad.append(f"ETL rows: subfolders {[len(s) for s in subs]}, merged "
                   f"{len(merged)}, split {[len(v) for v in split.values()]}")
    # ---- phase 12's corpus: derive_buckets, corpus_check, prebuild_cache -------
    t0 = time.perf_counter()
    corpus = write_cli_corpus(os.path.join(root, "corpus"), CLI_PAIRS,
                              CLI_LONG, BERT_BASE["vocab_size"], 256,
                              SEED + 23)
    tsv = os.path.join(corpus["text"], "all_data.tsv")
    want_len = sorted(min(len(r[4].split()) + 2, SEQ)
                      for r in rows(tsv, delimiter="\t"))
    _, text = _main_out(derive_buckets.main, [
        "--tsv_glob", tsv, "--vocab", os.path.join(corpus["bert"],
                                                   "vocab.txt")])
    buckets = json.loads(text)
    n = len(want_len)
    pct = {q: want_len[min(n - 1, int(n * f))]
           for q, f in (("p50", 0.5), ("p90", 0.9), ("p99", 0.99))}
    shares = {str(b): round(s, 4) for b, s in derive_buckets.shares_for(
        want_len, PRODUCTION_SEQ_BUCKETS).items()}
    got_shares = next(c["shares"] for c in buckets["candidates"]
                      if tuple(c["buckets"]) == PRODUCTION_SEQ_BUCKETS)
    print(f"  tools.derive_buckets over phase 12's {n} reports (the port's "
          f"WordPiece): percentiles {buckets['percentiles']}, shares of "
          f"{PRODUCTION_SEQ_BUCKETS} {got_shares}")
    if buckets["n_reports"] != n or any(
            buckets["percentiles"][q] != v for q, v in pct.items()) \
            or got_shares != shares:
        bad.append(f"derive_buckets: {buckets['percentiles']} "
                   f"{got_shares}, want {pct} {shares}")
    rc, text = _main_out(corpus_check.main, [
        "--metadata", corpus["metadata"], "--image_dir", corpus["images"],
        "--text_dir", corpus["text"], "--vocab_dir", corpus["bert"],
        "--decoded_crop_cache", corpus["cache"]])
    print("  tools.corpus_check over phase 12's corpus: "
          + "; ".join(line.strip() for line in text.splitlines()[:2])
          + f" (exit {rc})")
    if rc != 0 or f"total records:      {n}" not in text:
        bad.append(f"corpus_check exit {rc}: {text[-500:]}")
    rc, text = _main_out(prebuild_cache.main, [
        "--image_dir", corpus["images"], "--cache_dir", corpus["cache"],
        "--metadata", corpus["metadata"], "--report_every", "0",
        "--workers", "4"])
    summary = json.loads(text.strip().splitlines()[-1])
    print(f"  cli.prebuild_cache over phase 12's crop cache: {summary} "
          f"(exit {rc})")
    if rc != 0 or summary["skipped_valid"] != n or summary["total"] != n:
        bad.append(f"prebuild_cache exit {rc}: {summary}")
    corpus_s = time.perf_counter() - t0
    # ---- mem_report against the bytes phases 17 and 18 counted ----------------
    t0 = time.perf_counter()
    bc = BertConfig(**{**spec["bert_kw"], "hidden_dropout_prob": 0.0,
                       "attention_probs_dropout_prob": 0.0})
    state_groups = ("params/image_model", "params/text_model",
                    "critic_params", "img_opt", "mi_opt", "txt_opt")
    checks = []
    for mode, kw in TP_ZERO_MODES.items():
        cfg_z = TrainingConfig.production(
            compute_dtype="float32", pallas_stem=True,
            mesh_shape=(("data", TP_WORLD),),
            zero1_optimizer_sharding=kw.get("zero1", False),
            fsdp_parameter_sharding=kw.get("fsdp", False))
        r = mem_report.report(cfg_z, bert_config=bc)
        got = sum(r["groups"][g]["per_rank_bytes"] for g in state_groups)
        checks.append((f"17 (c) {mode}", got,
                       [rk[mode] for rk in tp["zero_bytes"]]))
        if spec["ae"] is None and mode in tp["ae_bytes"][0]:
            r = mem_report.report(cfg_z, trainer="ae")
            got = sum(r["groups"][g]["per_rank_bytes"]
                      for g in ("params", "opt_state"))
            checks.append((f"17 (d) AE {mode}", got,
                           [rk[mode] for rk in tp["ae_bytes"]]))
    cfg_p = TrainingConfig.production(compute_dtype="float32",
                                      pallas_stem=True,
                                      pipeline_microbatches=PP_MICRO,
                                      mesh_shape=(("pipe", PP_WORLD),))
    r = mem_report.report(cfg_p, bert_config=bc)
    text_groups = ("params/text_model", "txt_opt")
    checks.append(("18 (c) a stage", sum(r["groups"][g]["per_rank_bytes"]
                                         for g in text_groups),
                   [res["counted"] for res in pp["resident"]]))
    checks.append(("18 (c) one rank", sum(r["groups"][g]["global_bytes"]
                                          for g in text_groups),
                   [res["one_rank"] for res in pp["resident"]]))
    mem_s = time.perf_counter() - t0
    for name, got, counted in checks:
        print(f"  tools.mem_report, phase {name}: {got} bytes "
              f"({got / 2 ** 30:.4f} GiB) a rank; counted by rank "
              + ", ".join(f"{r}: {c}" for r, c in enumerate(counted)))
        if any(c != got for c in counted):
            bad.append(f"mem_report {name}: {got} against {counted}")
    if spec["ae"] is None and not any("AE" in c[0] for c in checks):
        bad.append("mem_report: no AE bytes from phase 17 (d)")
    seconds = time.perf_counter() - started
    print(f"  phase 20: {seconds:.1f} s (host clock; the ETL {etl_s:.1f} s, "
          f"phase 12's corpus {corpus_s:.1f} s, mem_report {mem_s:.1f} s)  "
          f"[{card}]")
    if bad:
        raise AssertionError("; ".join(bad))
    return {"seconds": seconds}


class PhaseClock:
    """Prints each phase's host-clock seconds with the card's name and
    power limit as it ends (``clock.done(n)``), and keeps them."""

    def __init__(self):
        self.card = card_line()
        self.seconds = {}
        self.t0 = time.perf_counter()

    def done(self, phase: int) -> None:
        now = time.perf_counter()
        self.seconds[phase] = now - self.t0
        self.t0 = now
        print(f"  -- phase {phase}: {self.seconds[phase]:.1f} s (host clock)  "
              f"[{self.card}]")


def main(only: int = 0) -> int:
    """Every phase, or with ``only`` 17, 18, 19 or 20 (``python3
    chip_smoke.py --phase17`` ..., a development run that prints no result
    lines) the build, phase 2's flash checks, phase 3's flash times and
    that phase (20: phases 17, 18 and 20, whose check reads their
    bytes)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    started = time.perf_counter()
    clock = PhaseClock()

    print("== phase 1: versions and build")
    tensor_ops = sass_counts(versions_and_build())
    clock.done(1)
    print("== phase 2: kernels against their plain versions")
    checked = check_kernels("cuda")
    if only:
        clock.done(2)
        print(f"== phase 3: the flash kernels' times at {SERVE_SHAPE}")
        time_kernels()
        clock.done(3)
        tp = pp = None
        if only in (17, 20):
            print(f"== phase 17: tensor and sequence parallelism, ZeRO-1 / "
                  f"FSDP, worlds of {TP_WORLD} ranks on the one card")
            with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
                tp = drive_tp(root, "cuda", backend=TP_BACKEND)
            torch.cuda.empty_cache()
            clock.done(17)
        if only in (18, 20):
            print(f"== phase 18: GPipe, a world of {PP_WORLD} ranks on the "
                  f"one card")
            with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
                pp = drive_pp(root, "cuda", backend=TP_BACKEND)
            clock.done(18)
        if only == 19:
            print(f"== phase 19: the serving export (full width, B={BATCH}, "
                  f"L={SEQ}, float32)")
            with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
                drive_export(root, "cuda")
            clock.done(19)
        if only == 20:
            print("== phase 20: the CLI and ETL rest on the card's host")
            with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
                drive_etl(root, "cuda", tp, pp)
            clock.done(20)
        print(f"chip_smoke: phases {sorted(clock.seconds)} in "
              f"{time.perf_counter() - started:.1f} s (a development run: no "
              f"result lines)")
        return 0
    critic_worst = check_critic("cuda")
    for name, err in check_critic_normal("cuda").items():
        critic_worst[name] = max(critic_worst[name], err)
    ffn_worst = check_ffn("cuda")
    t0 = time.perf_counter()
    stem_worst = check_stem("cuda")
    print(f"  check_stem: {time.perf_counter() - t0:.1f} s")
    clock.done(2)
    print(f"== phase 3: timing at (64, 12, 320, 64), at 2048 x 2048 pairs, "
          f"at (T, d, f) = {FFN_SHAPE} and at (B, H, W) = {STEM_SHAPES[0]}")
    times = time_kernels()
    time_buckets()
    critic_times = time_critic()
    ffn_times = time_ffn()
    t0 = time.perf_counter()
    stem_times = time_stem()
    print(f"  time_stem: {time.perf_counter() - t0:.1f} s")
    clock.done(3)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        print("== phase 4: the serving path over HTTP (full width)")
        serve = drive_serving(root, "cuda")
        clock.done(4)
        print("== phase 5: the MI train step (full width, B=64)")
        train = drive_training(root, "cuda")
        clock.done(5)
        print("== phase 6: where the device time goes")
        profile_batches(serve["save"], serve["config"], serve["data"])
        profile_train_steps(train)
        profile_attention()
        clock.done(6)
    del train["state"], train["batches"]
    torch.cuda.empty_cache()
    print(f"== phase 7: GradCache (full width, production preset, L={GC_SEQ})")
    grad_cache = drive_grad_cache("cuda", direct_peak=train["peak"][GC_SEQ])
    clock.done(7)
    print(f"== phase 8: BERT remat (full width, B={BATCH}, L={SEQ})")
    remat = drive_remat("cuda")
    clock.done(8)
    print(f"== phase 9: fused_ffn on both paths (full width, B={BATCH})")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        fused = drive_fused_ffn(root, "cuda", off={
            "ms": train["ms"], "peak": train["peak"],
            "texts_per_s": serve["per_s"]["bfloat16"]["texts_per_s"]})
    fused_remat = drive_remat("cuda", bert_kw=FFN_TRAIN_BERT)
    clock.done(9)
    print(f"== phase 10: pallas_stem on the training path (full width, "
          f"B={BATCH})")
    stem = drive_pallas_stem("cuda", off={"ms": train["ms"],
                                          "peak": train["peak"]})
    clock.done(10)
    print(f"== phase 11: MultiModalManager, one epoch of {MANAGER_PAIRS} "
          f"in-memory pairs (full width, B={BATCH})")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        manager = drive_manager(root, "cuda")
    torch.cuda.empty_cache()
    clock.done(11)
    # phase 14 reads phase 12's MI encoder and phase 13's autoencoder: one
    # directory holds the three phases
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        mi_root, ae_root = os.path.join(root, "mi"), os.path.join(root, "ae")
        print(f"== phase 12: MI pretraining from disk through its entry "
              f"point (full width, B={BATCH}, {CLI_EPOCHS} epochs; runs A, B "
              f"preempted, C resumed)")
        mi_cli = drive_mi_cli(mi_root, "cuda",
                              in_memory_pairs_per_s=manager["pairs_per_s"])
        _keep_only(mi_root, mi_cli["save"], "pytorch_MI_image_model.bin")
        torch.cuda.empty_cache()
        clock.done(12)
        print(f"== phase 13: the autoencoder through its entry point (full "
              f"width, B={BATCH}, {AE_EPOCHS} epochs; runs A, B preempted, C "
              f"resumed)")
        ae_cli = drive_ae_cli(ae_root, "cuda")
        _keep_only(ae_root, ae_cli["save"],
                   f"autoencoder_path_{AE_EPOCHS}.bin")
        torch.cuda.empty_cache()
        clock.done(13)
        print(f"== phase 14: the classifier, validation and Grad-CAM through "
              f"their entry points (full width, B={BATCH}, {CLF_EPOCHS} "
              f"epochs; runs A, B preempted, C resumed)")
        classifier = drive_classifier(os.path.join(root, "clf"), "cuda",
                                      mi_cli["save"], ae_cli["save"])
    torch.cuda.empty_cache()
    clock.done(14)
    print(f"== phase 15: the host library and profiling (native against "
          f"numpy, ms a read, WordPiece, MI from disk with profile_steps "
          f"{PROFILE_STEPS} and tensorboard; full width, B={BATCH})")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        host = drive_host_and_profiling(root, "cuda")
    torch.cuda.empty_cache()
    clock.done(15)
    print(f"== phase 16: data parallelism, worlds of {WORLD} ranks on the "
          f"one card ((a) equality, (b) the entry point from disk, (c) the "
          f"converter, (d) GradCache, (e) the AE and the classifier)")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        world = drive_world(root, "cuda", gc_loss=grad_cache[
            GC_CONFIGS[-1][0]]["first_loss"])
    torch.cuda.empty_cache()
    clock.done(16)
    print(f"== phase 17: tensor and sequence parallelism, ZeRO-1 / FSDP, "
          f"worlds of {TP_WORLD} ranks on the one card ((a) TP, (b) TP + SP, "
          f"the fused FFN under TP, (c) ZeRO-1 / FSDP, (d) the AE, (e) the "
          f"entry point from disk)")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        tp = drive_tp(root, "cuda", backend=world["backend"])
    torch.cuda.empty_cache()
    clock.done(17)
    print(f"== phase 18: GPipe, a world of {PP_WORLD} ranks on the one card "
          f"on {{'pipe': {PP_WORLD}}} ((a) the f32 step against one rank, "
          f"(b) the bf16 step with remat, (c) resident bytes, (d) the entry "
          f"point from disk)")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        pp = drive_pp(root, "cuda", backend=world["backend"])
    torch.cuda.empty_cache()
    clock.done(18)
    print(f"== phase 19: the serving export (full width, B={BATCH}, L={SEQ}, "
          f"float32: embed_images, embed_texts, classify, and embed_texts "
          f"with the fused FFN), reloaded in a child that imports only the "
          f"custom operators' modules")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        export = drive_export(root, "cuda")
    torch.cuda.empty_cache()
    clock.done(19)
    print("== phase 20: the CLI and ETL rest on the card's host "
          "(dataset_populate, derive_buckets, corpus_check, prebuild_cache, "
          "mem_report against phases 17 and 18)")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        drive_etl(root, "cuda", tp, pp)
    clock.done(20)

    # each path's launches, counted from 0 just before it and read just
    # after; serving runs the flash forward, training and remat the flash
    # backward too, GradCache the critic kernels, the fused_ffn paths the
    # fused FFN forward (serving) and all four of its kernels (training,
    # remat), the pallas_stem training path and the Manager the stem's
    # forward and dW, the tower's input gradient its dx, the MI entry
    # point from disk the bf16 flash kernels and the stem's forward and dW,
    # the classifier's embedding pass with the stem kernel its forward, the
    # profiled MI run of phase 15 the bf16 flash kernels and the stem's
    # forward and dW, the world's MI runs from disk (phase 16 (b), every
    # rank's) the bf16 flash kernels and the stem's forward and dW, the
    # world's GradCache step (phase 16 (d)) the critic kernels, phase 17's
    # TP, TP + SP and ZeRO worlds and its TP entry point from disk the f32
    # flash kernels (with the stem's forward and dW where pallas_stem is
    # on), its TP layer the fused FFN kernels, phase 18's pipelined world
    # and its entry point from disk the f32 flash kernels and the stem's
    # forward and dW, its remat world the bf16 flash kernels, phase 19's
    # artifacts (run in its reload child) the f32 flash forward and, with
    # the fused FFN, the f32 fused FFN forward
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
                         [sc.KERNELS["fwd"], sc.KERNELS["dw"]]),
             "mi_cli": (mi_cli["launches"],
                        [*flash_bf16, sc.KERNELS["fwd"], sc.KERNELS["dw"]]),
             "classifier_stem_embedding": (classifier["stem_launches"],
                                           [sc.KERNELS["fwd"]]),
             "mi_profiled": (host["launches"],
                             [*flash_bf16, sc.KERNELS["fwd"],
                              sc.KERNELS["dw"]]),
             "mi_world": (world["mi_world"],
                          [*flash_bf16, sc.KERNELS["fwd"], sc.KERNELS["dw"]]),
             "grad_cache_world": (world["grad_cache_world"],
                                  pc.KERNELS.values()),
             "tp_world": (tp["tp_world"], [fa.KERNELS[torch.float32],
                                           fa.BWD_KERNELS[torch.float32]]),
             "sp_world": (tp["sp_world"], [fa.KERNELS[torch.float32],
                                           fa.BWD_KERNELS[torch.float32]]),
             "tp_ffn": (tp["tp_ffn"], ff.KERNELS.values()),
             "zero_world": (tp["zero_world"],
                            [fa.KERNELS[torch.float32],
                             fa.BWD_KERNELS[torch.float32],
                             sc.KERNELS["fwd"], sc.KERNELS["dw"]]),
             "tp_cli": (tp["tp_cli"], [fa.KERNELS[torch.float32],
                                       fa.BWD_KERNELS[torch.float32],
                                       sc.KERNELS["fwd"], sc.KERNELS["dw"]]),
             "pp_world": (pp["pp_world"], [fa.KERNELS[torch.float32],
                                           fa.BWD_KERNELS[torch.float32],
                                           sc.KERNELS["fwd"],
                                           sc.KERNELS["dw"]]),
             "pp_remat_world": (pp["pp_remat"], flash_bf16),
             "pp_cli": (pp["pp_cli"], [fa.KERNELS[torch.float32],
                                       fa.BWD_KERNELS[torch.float32],
                                       sc.KERNELS["fwd"], sc.KERNELS["dw"]]),
             "serving_export": (export["launches"],
                                [fa.KERNELS[torch.float32]]),
             "serving_export_fused_ffn": (export["ffn_launches"],
                                          [fa.KERNELS[torch.float32],
                                           ff.KERNELS["fwd"]])}
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
          f"(the time limit is 1200 s); by phase: "
          + ", ".join(f"{n}: {s:.1f}" for n, s in clock.seconds.items()))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--world-worker"]:
        sys.exit(world_worker(*sys.argv[2:]))
    sys.exit(main(only={"--phase17": 17, "--phase18": 18, "--phase19": 19,
                        "--phase20": 20}.get(
        (sys.argv[1:2] or [""])[0], 0)))
