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
   known-answer vectors;
3. each kernel's time at (64, 12, 320, 64) beside its plain version's, one
   PyTorch library call's (``scaled_dot_product_attention`` forward, or its
   backward alone: a yardstick the port never calls) and its bound;
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
7. the ``kernels`` JSON line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; without a card it exits before
printing any result.
"""

from __future__ import annotations

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
from mimm_tpu_torch.models.resnet import ResNet256_6_2_1  # noqa: E402
from mimm_tpu_torch.ops import _build  # noqa: E402
from mimm_tpu_torch.ops import flash_attention as fa  # noqa: E402
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
    ms, losses, batches = {}, [], {}
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
        mem = f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB" \
            if cuda else "not measured"
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
            "state": state, "step": train_step, "batches": batches}


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
    print("== phase 3: timing at (64, 12, 320, 64)")
    times = time_kernels()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        print("== phase 4: the serving path over HTTP (full width)")
        serve = drive_serving(root, "cuda")
        print("== phase 5: the MI train step (full width, B=64)")
        train = drive_training(root, "cuda")
        print("== phase 6: where the device time goes")
        profile_batches(serve["save"], serve["config"], serve["data"])
        profile_train_steps(train)
    del train["state"], train["batches"]

    # each path's launches, counted from 0 just before it and read just
    # after; both paths run the forward kernels, training the backward too
    paths = {"serving": (serve["launches"], fa.KERNELS.values()),
             "training": (train["launches"],
                          [*fa.KERNELS.values(), *fa.BWD_KERNELS.values()])}
    for path, (counts, names) in paths.items():
        for name in names:
            if counts.get(name, 0) == 0:
                raise AssertionError(f"{name} was not launched on the {path} "
                                     f"path")
    kernels = []
    for kind, names in (("fwd", fa.KERNELS), ("bwd", fa.BWD_KERNELS)):
        for dt in DTYPES:
            name = names[dt]
            kernels.append({
                "name": name, "route": "cuda", "source": FLASH[kind][0],
                "replaces": FLASH[kind][1],
                "launches": sum(c.get(name, 0) for c, _ in paths.values()),
                "max_abs_err": checked["worst"][kind, dt],
                **times[kind, dt][RATES[-1]],
                "ms_rate0": times[kind, dt][0.0]["ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
