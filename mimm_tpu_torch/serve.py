"""Inference / serving path (mimm_tpu/serve.py counterpart).

``InferenceSession`` loads the reference-named checkpoints of a save
directory onto one device and serves fixed-batch entry points (inputs are
padded up to ``batch_size`` and results sliced back, so callers may send
any N >= 1):

* ``embed_images(images) -> (N, 768)``   — MI image encoder
* ``embed_texts(ids, masks, segments)``  — MI text encoder (pooled [CLS])
* ``featurize_reports`` / ``embed_reports(texts)`` — raw report strings:
  server-side WordPiece (pass ``vocab_dir``) + the text encoder
* ``classify(images) -> (N,)``           — encoder + per-disease Basic_MLP

Numeric knobs: ``compute_dtype="bfloat16"`` runs activations in bf16;
``weight_dtype="int8"`` is weight-only post-training quantization with the
JAX package's numbers: every >=2-D float weight is symmetric int8 with one
float32 scale per output channel (flax's last axis: torch dim 0 for Linear
and conv weights, dim 1 — the hidden column — for embedding tables).  The
int8 weights stay on the device and are dequantized per call as
``q8.to(dt) * s8.to(dt)``.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from mimm_tpu_torch import checkpoint as ckpt
from mimm_tpu_torch import resolve_device
from mimm_tpu_torch.models.bert import BertConfig, TextBert
from mimm_tpu_torch.models.mlp import BasicMLP
from mimm_tpu_torch.models.resnet import ResNet256_6_2_1
from mimm_tpu_torch.ops.image_norm import device_normalize

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _output_dims(model: nn.Module) -> Dict[str, int]:
    """State-dict name -> the torch dim of flax's last (output) axis for
    every weight the int8 path quantizes."""
    dims = {}
    for name, m in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(m, nn.Embedding):
            dims[prefix + "weight"] = 1   # (vocab, hidden): hidden column
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
            dims[prefix + "weight"] = 0   # (out, in[, kh, kw])
    return dims


def quantize_state_dict(model: nn.Module, sd: Dict[str, torch.Tensor]):
    """Symmetric per-output-channel int8 for every >=2-D float weight:
    ``{"q8": int8, "s8": float32}``; other entries are returned as they
    are.  The arithmetic is mimm_tpu/serve.py ``_quantize_weights``'s in
    float32, so both give the same numbers."""
    dims = _output_dims(model)
    out = {}
    for k, x in sd.items():
        if x.dim() >= 2 and x.is_floating_point():
            keep = dims[k]
            reduce = tuple(d for d in range(x.dim()) if d != keep)
            s = x.abs().amax(dim=reduce, keepdim=True) / 127.0
            s = torch.clamp(s, min=1e-12).to(torch.float32)
            q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
            out[k] = {"q8": q, "s8": s}
        else:
            out[k] = x
    return out


def _materialize(state, dtype):
    return {k: (v["q8"].to(dtype) * v["s8"].to(dtype))
            if isinstance(v, dict) else v for k, v in state.items()}


class DynamicBatcher:
    """Cross-request dynamic batching for a batched inference function.

    Concurrent callers ``submit(*arrays)`` row-blocks of any size; one
    worker thread drains the queue — waiting up to ``max_wait_ms`` after
    the first arrival for a batch to accumulate, up to ``batch_size`` rows
    — concatenates compatible requests (identical trailing shapes/dtypes;
    mismatched ones are deferred to the next round, never dropped), runs
    ONE call of ``fn``, and scatters the result rows back.  Errors in
    ``fn`` propagate to every caller in the failed group."""

    def __init__(self, fn, batch_size: int, max_wait_ms: float = 5.0):
        self.fn = fn
        self.batch_size = int(batch_size)
        self.max_wait = max(0.0, float(max_wait_ms)) / 1e3
        self._q = queue.Queue()
        self._stop = object()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, *arrays) -> np.ndarray:
        """Blocks until this request's result rows are ready."""
        arrays = tuple(np.asarray(a) for a in arrays)
        n = arrays[0].shape[0]
        box = {"event": threading.Event()}
        self._q.put((arrays, n, box))
        box["event"].wait()
        if "error" in box:
            raise box["error"]
        return box["result"]

    def close(self) -> None:
        self._q.put(self._stop)
        self._worker.join(timeout=5)

    @staticmethod
    def _key(arrays):
        return tuple((a.shape[1:], a.dtype) for a in arrays)

    def _run(self) -> None:
        pending = []
        while True:
            # block for the first request (or drain leftovers first)
            if not pending:
                item = self._q.get()
                if item is self._stop:
                    return
                pending.append(item)
            deadline = time.monotonic() + self.max_wait
            group, rows = [], 0
            key = self._key(pending[0][0])
            deferred = []
            while pending or time.monotonic() < deadline:
                if not pending:
                    try:
                        item = self._q.get(
                            timeout=max(0.0, deadline - time.monotonic()))
                    except queue.Empty:
                        break
                    if item is self._stop:
                        self._flush(group, key)
                        for it in deferred:
                            self._fail(it, RuntimeError("batcher closed"))
                        return
                    pending.append(item)
                    continue
                item = pending.pop(0)
                if self._key(item[0]) != key:
                    deferred.append(item)  # different shape family: next round
                    continue
                group.append(item)
                rows += item[1]
                if rows >= self.batch_size:
                    break
            self._flush(group, key)
            # leftovers (batch filled early) keep their arrival order,
            # ahead of the shape-mismatched deferrals
            pending = pending + deferred

    def _flush(self, group, key) -> None:
        if not group:
            return
        try:
            joined = [np.concatenate([g[0][i] for g in group])
                      for i in range(len(key))]
            out = np.asarray(self.fn(*joined))
            off = 0
            for arrays, n, box in group:
                box["result"] = out[off:off + n]
                off += n
                box["event"].set()
        except Exception as e:  # propagate to every waiting caller
            for item in group:
                self._fail(item, e)

    @staticmethod
    def _fail(item, err) -> None:
        _, _, box = item
        box["error"] = err
        box["event"].set()


class InferenceSession:
    def __init__(self, save_directory: str, batch_size: int = 64,
                 output_channels: int = 1,
                 bert_config: Optional[BertConfig] = None,
                 classifier_layers: Optional[List[int]] = None,
                 disease: Optional[str] = None,
                 classifier_epoch: Optional[int] = None,
                 compute_dtype: str = "float32",
                 weight_dtype: str = "float32",
                 vocab_dir: Optional[str] = None,
                 max_seq_length: int = 320,
                 device="cuda"):
        if weight_dtype not in ("float32", "int8"):
            raise ValueError(f"unsupported weight_dtype: {weight_dtype}")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"unsupported compute_dtype: {compute_dtype}")
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.max_seq_length = max_seq_length
        self.dtype = _DTYPES[compute_dtype]
        self._quant = weight_dtype == "int8"
        # functional_call swaps the (meta) module's tensors in place for the
        # call, so concurrent requests take turns on the device
        self._device_lock = threading.Lock()
        self._tokenizer = None
        if vocab_dir is not None:
            from mimm_tpu_torch.data.tokenizer import \
                NativeWordPieceTokenizer
            self._tokenizer = NativeWordPieceTokenizer.from_pretrained(
                vocab_dir)

        self.image_model = ResNet256_6_2_1(output_channels=output_channels,
                                           dtype=self.dtype)
        self._image_state = self._load(
            self.image_model,
            ckpt.load_state_dict_bin(
                os.path.join(save_directory, "pytorch_MI_image_model.bin")))

        self.text_model = None
        txt_path = os.path.join(save_directory, "pytorch_MI_text_model.bin")
        if bert_config is not None:
            if not os.path.exists(txt_path):
                raise FileNotFoundError(
                    f"bert_config given but no text checkpoint at {txt_path}")
            self.text_model = TextBert(bert_config, dtype=self.dtype)
            self._text_state = self._load(
                self.text_model,
                ckpt.normalize_bert_keys(ckpt.load_state_dict_bin(txt_path)))

        self.classifier = None
        if classifier_layers is not None and disease is not None:
            from mimm_tpu_torch.validate import find_classifier_checkpoint
            # the MLP head is tiny (< 1 MB): always full precision
            self.classifier = BasicMLP(768, classifier_layers)
            self.classifier.load_state_dict(ckpt.load_state_dict_bin(
                find_classifier_checkpoint(save_directory, disease,
                                           classifier_epoch)), strict=True)
            self.classifier.eval().to(self.device)

    def _load(self, model: nn.Module, sd) -> dict:
        """Check ``sd`` against ``model`` (strict), move it to the device
        (int8-quantized if asked) and leave the module's own tensors on the
        meta device: every call runs it through ``functional_call`` on
        these tensors, so the device holds one copy of the weights."""
        model.load_state_dict(sd, strict=True)
        model.eval()
        sd = model.state_dict()
        state = quantize_state_dict(model, sd) if self._quant else sd
        model.to("meta")

        def put(v):
            if isinstance(v, dict):
                return {kk: vv.to(self.device) for kk, vv in v.items()}
            return v.to(self.device)
        return {k: put(v) for k, v in state.items()}

    def _forward(self, model, state, *args):
        return functional_call(model, _materialize(state, self.dtype), args)

    def _pad(self, x: np.ndarray):
        n = x.shape[0]
        pad = (-n) % self.batch_size
        if pad:
            x = np.concatenate([x, np.zeros((pad, *x.shape[1:]), x.dtype)])
        return x, n

    def _run_batched(self, fn, *arrays) -> np.ndarray:
        padded = [self._pad(np.asarray(a))[0] for a in arrays]
        n = np.asarray(arrays[0]).shape[0]
        outs = []
        with self._device_lock, torch.inference_mode():
            for i in range(0, padded[0].shape[0], self.batch_size):
                chunk = [torch.from_numpy(np.ascontiguousarray(
                    p[i:i + self.batch_size])).to(self.device)
                    for p in padded]
                outs.append(fn(*chunk).cpu().numpy())
        return np.concatenate(outs)[:n]

    def _image_embeddings(self, imgs: torch.Tensor) -> torch.Tensor:
        return self._forward(self.image_model, self._image_state,
                             device_normalize(imgs))[1].float()

    def _text_embeddings(self, ids, masks, segs) -> torch.Tensor:
        return self._forward(self.text_model, self._text_state, ids.long(),
                             segs.long(), masks.long())[0].float()

    def _classify(self, imgs: torch.Tensor) -> torch.Tensor:
        return self.classifier(self._image_embeddings(imgs))[:, 0]

    def embed_images(self, images: np.ndarray) -> np.ndarray:
        """(N, H, W, 1) float32/uint8/uint16 -> (N, 768) embeddings."""
        return self._run_batched(self._image_embeddings, images)

    def embed_texts(self, ids, masks, segments) -> np.ndarray:
        if self.text_model is None:
            raise RuntimeError("no text model loaded (pass bert_config)")
        return self._run_batched(self._text_embeddings, ids, masks, segments)

    def featurize_reports(self, texts: List[str]):
        """Raw findings/impression strings -> (ids, masks, segments):
        [CLS] + WordPiece + [SEP], truncated/padded to ``max_seq_length``."""
        if self._tokenizer is None:
            raise RuntimeError("no tokenizer loaded (pass vocab_dir)")
        L = self.max_seq_length
        cls_id, = self._tokenizer.convert_tokens_to_ids(["[CLS]"])
        sep_id, = self._tokenizer.convert_tokens_to_ids(["[SEP]"])
        ids = np.zeros((len(texts), L), np.int32)
        masks = np.zeros((len(texts), L), np.int32)
        for i, text in enumerate(texts):
            toks = self._tokenizer.tokenize(text)[:L - 2]
            row = [cls_id] + self._tokenizer.convert_tokens_to_ids(toks) + [sep_id]
            ids[i, :len(row)] = row
            masks[i, :len(row)] = 1
        return ids, masks, np.zeros_like(ids)

    def embed_reports(self, texts: List[str]) -> np.ndarray:
        if self.text_model is None:
            raise RuntimeError("no text model loaded (pass bert_config)")
        return self.embed_texts(*self.featurize_reports(texts))

    def classify(self, images: np.ndarray) -> np.ndarray:
        """(N, H, W, 1) -> (N,) disease probabilities."""
        if self.classifier is None:
            raise RuntimeError("no classifier loaded (pass classifier_layers "
                               "+ disease)")
        return self._run_batched(self._classify, images)
