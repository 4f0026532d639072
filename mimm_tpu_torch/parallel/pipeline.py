"""GPipe pipeline parallelism of the BERT text tower over the 'pipe' mesh
axis (mimm_tpu/parallel/pipeline.py counterpart).

The text encoder's n layers are split over S stages, layer i on stage
``i // (n / S)`` (``stage_layers``), and the rows of a batch into M
microbatches (``num_microbatches``, 0: one per stage).  A stage holds and
updates only its own layers (``parallel.mesh.pipe_shardings``, placed by
``shard_mi_state``); the embeddings, the pooler and the classifier are
replicated.  JAX runs one program of M + S − 1 ticks in which every stage
computes at every tick (the bubbles' results discarded) and lets autodiff
transpose the ``ppermute`` chain; torch runs one process per stage, so
the port keeps the schedule's meaning, not its lockstep:

* **Forward** (``pipelined_textbert_apply``): stage 0 computes the
  embeddings, their LayerNorm and dropout on its data index's rows and
  splits them into M microbatches; stage s runs its n/S layers on
  microbatch m as soon as it arrives from stage s − 1 and sends the result
  to stage s + 1.  No bubble is computed.  The last stage's [CLS] rows,
  (B, h), are broadcast over the pipe line: only ``hidden[:, 0]`` feeds
  the pooler (JAX pipeline.py:320-321), so this gives the numbers of
  JAX's masked ``psum`` of the whole (B, L, h) output at 1/L of its bytes.
  Every rank then runs the pooler, the classifier, the critic and the
  bound, and holds the same loss.
* **Backward** (``StageRun.backward``), driven explicitly after each rank
  has taken the gradient of its loss with respect to the [CLS] rows: the
  last stage pulls it back through its layers microbatch by microbatch,
  last first, and sends each microbatch's input gradient to stage s − 1,
  which pulls it back through its stored output of that microbatch (one
  ``torch.autograd.grad`` each), down to stage 0's embeddings.  A blocking
  send or receive inside an autograd function would run in the engine's
  order, which can differ between ranks and deadlock; here every transfer
  runs in the order this module gives it.
* **Dropout**: stage s cannot replay the draws of the layers before it
  from one sequential generator, so each (step, data index or chunk,
  global layer, microbatch) draws from its own generator through
  splitmix64 (``stream_generator``; JAX folds the key per (global layer,
  microbatch)), which also seeds the layer's flash kernel; the embedding
  dropout and the pooled dropout take streams of their own (JAX's 2n and
  2n + 1).  The masks therefore differ from the plain schedule's, as in
  JAX; equality with one rank holds at dropout 0.  ``BertConfig.remat``
  recomputes each layer in the backward (JAX's ``jax.checkpoint`` of
  ``apply_layer``).
* **Transfers** between stages: ``send`` / ``recv`` of the pipe group on
  the tensors' device where the group's backend takes CUDA tensors
  point to point (NCCL); gloo's point-to-point calls take CPU tensors
  only, so over gloo a CUDA activation goes through a host copy.  A
  failed transfer raises.

Who sums what is in parallel/mesh.py's header; train/mi.py applies it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from mimm_tpu_torch.parallel.mesh import (PIPE_AXIS, Mesh, axis_global_rank,
                                          pipe_size)

_MASK64 = (1 << 64) - 1


def pipeline_stage_count(mesh: Optional[Mesh]) -> int:
    """Pipeline stages: the size of the mesh's 'pipe' axis (1: no
    pipeline)."""
    return pipe_size(mesh)


def stage_layers(num_layers: int, mesh: Optional[Mesh]) -> range:
    """The global indices of this rank's encoder layers; raises
    ``ValueError`` when the stages do not divide ``num_layers``."""
    stages = pipeline_stage_count(mesh)
    if num_layers % stages:
        raise ValueError(f"num_hidden_layers={num_layers} not divisible by "
                         f"pipeline stages={stages}")
    per = num_layers // stages
    stage = 0 if mesh is None else mesh.pipe_rank
    return range(stage * per, (stage + 1) * per)


def microbatch_count(num_microbatches: int, mesh: Optional[Mesh]) -> int:
    """M: ``num_microbatches``, or one per stage when it is 0."""
    return int(num_microbatches) or pipeline_stage_count(mesh)


def splitmix64(*words: int) -> int:
    """The words mixed in turn by splitmix64's finalizer."""
    x = 0
    for w in words:
        x = (x + (w & _MASK64) + 0x9E3779B97F4A7C15) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 31
    return x


def stream_generator(key: int, stream: int, microbatch: int,
                     device) -> torch.Generator:
    """The generator of one (stream, microbatch) of a pipelined forward
    whose draws are keyed on ``key`` (the step and the data index, or the
    GradCache chunk): stream i < n the encoder layer i, 2n the embedding
    dropout, 2n + 1 the pooled dropout."""
    gen = torch.Generator(device=device)
    gen.manual_seed(splitmix64(key, stream, microbatch) & 0x7FFFFFFFFFFFFFFF)
    return gen


def _wire(device: torch.device, mesh: Mesh) -> torch.device:
    """Where the pipe group sends a tensor on ``device`` point to point:
    there for CPU tensors and for CUDA tensors over NCCL, else the CPU."""
    if device.type != "cuda" or \
            "nccl" in str(dist.get_backend(mesh.pipe_group)).lower():
        return device
    return torch.device("cpu")


def send_to(tensor: torch.Tensor, stage: int, mesh: Mesh) -> None:
    """``tensor`` to stage ``stage`` of this rank's pipe line."""
    t = tensor.detach().contiguous()
    dist.send(t.to(_wire(t.device, mesh)),
              axis_global_rank(mesh, PIPE_AXIS, stage), group=mesh.pipe_group)


def recv_from(shape, dtype: torch.dtype, device, stage: int,
              mesh: Mesh) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` from stage ``stage``, on
    ``device``."""
    device = torch.device(device)
    buf = torch.empty(shape, dtype=dtype, device=_wire(device, mesh))
    dist.recv(buf, axis_global_rank(mesh, PIPE_AXIS, stage),
              group=mesh.pipe_group)
    return buf.to(device)


@dataclasses.dataclass
class StageRun:
    """What one pipelined forward leaves on this stage for its backward:
    each microbatch's input (a leaf) and output, stage 0's embeddings, and
    the [CLS] rows (a leaf) the pooler read."""

    mesh: Mesh
    layer_params: Dict[str, torch.Tensor]
    embedding_params: Dict[str, torch.Tensor]
    inputs: List[torch.Tensor]
    outputs: List[torch.Tensor]
    hidden: Optional[torch.Tensor]
    cls: torch.Tensor
    rows: int

    @property
    def stage(self) -> int:
        return self.mesh.pipe_rank

    @property
    def last(self) -> bool:
        return self.stage == self.mesh.pipe - 1

    def backward(self, d_cls: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The reverse pipeline from ``d_cls``, the gradient of this rank's
        loss with respect to ``cls`` (every rank of the line calls it with
        the same one): {text_model parameter name: gradient} of this
        stage's layers, summed over the microbatches, and on stage 0 of the
        embeddings.  Frees the stored graphs."""
        grads: Dict[str, torch.Tensor] = {}
        names = list(self.layer_params)
        params = [self.layer_params[n] for n in names]
        d_inputs: List[Optional[torch.Tensor]] = [None] * len(self.outputs)
        for m in reversed(range(len(self.outputs))):
            y = self.outputs[m]
            if self.last:
                lo = m * self.rows
                y, gy = y[:, 0], d_cls[lo:lo + self.rows].to(y.dtype)
            else:
                gy = recv_from(y.shape, y.dtype, y.device, self.stage + 1,
                               self.mesh)
            *gs, dx = torch.autograd.grad(y, params + [self.inputs[m]],
                                          grad_outputs=gy, allow_unused=True)
            for n, g in zip(names, gs):
                if g is not None:
                    grads[n] = g if n not in grads else grads[n] + g
            if self.stage > 0:
                send_to(dx, self.stage - 1, self.mesh)
            else:
                d_inputs[m] = dx
            self.outputs[m] = self.inputs[m] = None
        if self.stage == 0:
            names = list(self.embedding_params)
            gs = torch.autograd.grad(
                self.hidden, [self.embedding_params[n] for n in names],
                grad_outputs=torch.cat(d_inputs), allow_unused=True)
            grads.update({n: g for n, g in zip(names, gs) if g is not None})
            self.hidden = None
        return grads


def pipelined_encoder(bert, mesh: Mesh, hidden: Optional[torch.Tensor],
                      attn_bias: torch.Tensor, num_microbatches: int, *,
                      deterministic: bool = True, key: int = 0):
    """The encoder layers of ``bert`` (a ``models.bert.BertModel`` whose
    other stages' layers may be empty) as an S-stage pipeline over this
    rank's pipe line.  ``hidden``: the (B, L, h) embeddings on stage 0
    (None elsewhere); ``attn_bias``: the (B, 1, 1, L) mask on every stage.
    Returns (the last stage's (B, h) [CLS] rows on every stage, a
    ``StageRun`` when gradients are on, else None)."""
    cfg = bert.config
    n_layers = cfg.num_hidden_layers
    layers = stage_layers(n_layers, mesh)
    rows_all = attn_bias.shape[0]
    m_count = int(num_microbatches)
    if rows_all % m_count:
        raise ValueError(f"batch {rows_all} not divisible by microbatches "
                         f"{m_count}")
    rows = rows_all // m_count
    seq = attn_bias.shape[-1]
    device = attn_bias.device
    stage, last = mesh.pipe_rank, mesh.pipe_rank == mesh.pipe - 1
    grad = torch.is_grad_enabled()
    shape = (rows, seq, cfg.hidden_size)
    inputs, outputs, cls_parts = [], [], []
    for m in range(m_count):
        x = hidden[m * rows:(m + 1) * rows] if stage == 0 else \
            recv_from(shape, bert.dtype, device, stage - 1, mesh)
        if grad:
            x = x.detach().requires_grad_()
        gen = (lambda i, m=m: None) if deterministic else \
            (lambda i, m=m: stream_generator(key, i, m, device))
        y = bert.encode(x, attn_bias[m * rows:(m + 1) * rows], layers,
                        deterministic, gen)
        if last:
            cls_parts.append(y[:, 0].detach())
        else:
            send_to(y, stage + 1, mesh)
        if grad:
            inputs.append(x)
            outputs.append(y)
    if last:
        cls = torch.cat(cls_parts).contiguous()
    else:
        cls = torch.empty((rows_all, cfg.hidden_size), dtype=bert.dtype,
                          device=device)
    dist.broadcast(cls, axis_global_rank(mesh, PIPE_AXIS, mesh.pipe - 1),
                   group=mesh.pipe_group)
    if not grad:
        return cls, None
    cls.requires_grad_()
    named = dict(bert.named_parameters())
    layer_params = {f"bert.{n}": p for n, p in named.items()
                    if n.startswith("encoder.layer.")
                    and int(n.split(".")[2]) in layers}
    embedding_params = {f"bert.{n}": p for n, p in named.items()
                        if n.startswith("embeddings.")} if stage == 0 else {}
    return cls, StageRun(mesh, layer_params, embedding_params, inputs,
                         outputs, hidden, cls, rows)


def pipelined_textbert_apply(text_model, mesh: Mesh, input_ids,
                             token_type_ids=None, attention_mask=None, *,
                             num_microbatches: int = 0,
                             deterministic: bool = True, key: int = 0):
    """``TextBert`` (models/bert.py) with its encoder pipelined over the
    mesh's 'pipe' axis: the same modules on the same parameters, only the
    layers run through the schedule.  Every rank of a pipe line calls it
    with the same rows.  Returns ``(pooled, logits, run)`` as the plain
    forward's (pooled promoted to at least float32), ``run`` the
    ``StageRun`` whose ``backward`` the caller drives (None without
    gradients).  ``key``: the draws' key (``stream_generator``)."""
    bert = text_model.bert
    n_layers = bert.config.num_hidden_layers
    stage_layers(n_layers, mesh)          # the configuration's errors first
    m_count = microbatch_count(num_microbatches, mesh)
    if input_ids.shape[0] % m_count:
        raise ValueError(f"batch {input_ids.shape[0]} not divisible by "
                         f"microbatches {m_count}")
    device = input_ids.device
    gen = (lambda stream: None) if deterministic else \
        (lambda stream: stream_generator(key, stream, 0, device))
    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids)
    if mesh.pipe_rank == 0:
        hidden, attn_bias = bert.embed(input_ids, token_type_ids,
                                       attention_mask, deterministic,
                                       gen(2 * n_layers))
    else:
        hidden, attn_bias = None, bert.attention_bias(attention_mask)
    cls, run = pipelined_encoder(bert, mesh, hidden, attn_bias, m_count,
                                 deterministic=deterministic, key=key)
    pooled, logits = text_model.head(bert.pool(cls), deterministic,
                                     gen(2 * n_layers + 1))
    return pooled, logits, run
