"""Data, tensor, sequence and pipeline parallelism and ZeRO-1 / FSDP over
``torch.distributed`` (mimm_tpu/parallel/mesh.py counterpart, its 'data',
'model' and 'pipe' axes).

JAX runs one program over a device mesh and lets XLA insert the
collectives; torch runs one process per device.  So the terms map as:

* JAX's ``process_count()`` / ``process_index()`` are the world size and
  this process's rank.  A ``Mesh`` here lays the world out as JAX's
  ``make_mesh`` reshapes its devices, row-major in the order the axes are
  given: ``{'data': D, 'model': M}`` puts rank ``d·M + m`` at data index d
  and model index m (``data_rank``, ``model_rank``), ``{'data': D,
  'pipe': S}`` rank ``d·S + s`` at data index d and stage s
  (``pipe_rank``), with one process group per line of each axis larger
  than 1 (the ranks that differ only in that axis: ``data_group``,
  ``model_group``, ``pipe_group``).  Without a mesh shape the whole world
  is the 'data' axis.
* ``initialize_distributed`` reads the JAX package's variables
  (``MIMM_DISTRIBUTED``, ``MIMM_COORDINATOR_ADDRESS``,
  ``MIMM_NUM_PROCESSES``, ``MIMM_PROCESS_ID``) and starts the process
  group.  The backend follows the device: NCCL for CUDA tensors and gloo
  for CPU tensors (``"cpu:gloo,cuda:nccl"`` on the card, ``"gloo"`` on the
  CPU); only an explicit ``backend`` argument overrides it, and a failed
  start raises.
* A rank's device is ``cuda:(local_rank % device_count())``
  (``rank_device``), so two ranks may share one card.
* ``shard_batch`` takes this data index's rows of a global batch (the
  ranks of one data index, over 'model' and 'pipe', get the same rows)
  and ``replicate`` broadcasts rank 0's tensors to the world;
  ``gather_rows`` is the all-gather the critic's global negatives need,
  and ``all_reduce_sum`` the one sync-BN's statistics need, both over the
  'data' axis, with autograd.
* Tensor parallelism (Megatron; JAX's GSPMD over ``bert_tp_shardings`` /
  ``critic_tp_shardings``): a 'model' rank holds its piece of each
  column-parallel weight (output features) and row-parallel weight (input
  features).  ``copy_to_model`` (identity forward, all-reduce backward)
  enters a column-parallel product and ``reduce_from_model`` (all-reduce
  forward, identity backward) leaves a row-parallel one.  Sequence
  parallelism replaces them by ``gather_seq`` (all-gather of the tokens
  forward, reduce-scatter backward) and ``reduce_scatter_seq`` (the
  reverse); ``scatter_seq`` / ``gather_seq_replicated`` enter and leave
  the sequence-parallel region.  Gloo has no reduce-scatter, so one is an
  all-reduce and a slice: the same sum.
* ZeRO-1 and FSDP (``zero1_shardings``): a tensor rests split along the
  largest axis the 'data' axis divides, each data index holding one
  slice; ``sharded_update`` runs an optimizer on the slices and gathers
  the parameters again (ZeRO-1) or keeps them split (FSDP, gathered at
  the start of the next step by ``gather_params``).
* Pipeline parallelism (GPipe, parallel/pipeline.py; JAX's
  ``pp_resident`` branch of ``mi_state_specs``): stage s of S holds the
  parameters and AdamW moments of the text encoder's layers [s·n/S,
  (s+1)·n/S) and empty tensors for the other layers (``pipe_shardings``);
  the embeddings, the pooler and the classifier are replicated.  The
  layout wins over TP and ZeRO for the text tower, as in JAX; ZeRO-1 and
  FSDP then split the image tower and the critic over 'data'.  The
  'model' axis only replicates under pipeline parallelism in JAX (the
  pipelined layers are built without the mesh), so a mesh with both
  'model' and 'pipe' larger than 1 raises ``ValueError``.
  ``full_group`` gathers the stages' layers into the plain ``layer0 ..
  layer{n-1}`` tree that checkpoints hold.

Who sums what.  Each rank computes the loss of the WHOLE batch from the
gathered embeddings, so every rank holds the same loss; so:

* ``gather_rows``' backward hands each data index only its own rows of
  the embedding gradient (not the sum over ranks, which would make a
  tower's gradient D times too large); the towers' parameter gradients,
  each data index's share, are then summed over the 'data' axis only
  (``all_reduce_``).  Over 'model' they are equal (the image tower, which
  every model rank runs whole) or this rank's piece (the text tower's TP
  leaves).
* The text leaves that TP replicates (embeddings, LayerNorms, the
  row-parallel biases, the pooler) get the same full gradient on every
  model rank, since ``copy_to_model`` sums the column-parallel branches'
  input gradients: they are not summed over 'model'.
* Under sequence parallelism a rank sees only its tokens in the
  LayerNorm / dropout / residual regions, so the LayerNorms and the
  row-parallel biases there ARE summed over 'model' (``copy_to_model`` on
  the parameter: identity forward, all-reduce backward).
* Under pipeline parallelism every rank of a pipe line computes the same
  loss from the same replicated [CLS] rows, so the gradient of those rows
  that the last stage pulls back through its layers is one rank's, not
  the sum over the S ranks (as ``gather_rows``).  An encoder layer's
  gradient is its stage's own, summed over the M microbatches and over
  'data' only; the embeddings' (and their LayerNorm's) exist on stage 0
  alone and are broadcast over 'pipe'; the pooler's, the classifier's,
  the image tower's and the critic's are equal on every pipe rank and are
  not summed over 'pipe'.
* Sync-BN's statistics and ``gather_rows`` run over the data group, not
  the world.
* The critic's gradient, which every data index computes in full, is
  taken from data index 0; under TP its replicated layers' gradients are
  the same on every model rank and its TP layers keep each rank's piece.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import math
import os
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"


def world_size() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


def world_rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_available() \
        and dist.is_initialized() else 0


def local_rank(rank: Optional[int] = None) -> int:
    """This process's rank on its host: a launcher's ``LOCAL_RANK``, or
    the rank (``rank``, by default the group's: one host)."""
    if os.environ.get("LOCAL_RANK", "").strip():
        return int(os.environ["LOCAL_RANK"])
    return world_rank() if rank is None else rank


def rank_device(device) -> torch.device:
    """``device`` for this rank: a bare ``"cuda"`` in a world of several
    ranks is ``cuda:(local_rank % device_count())``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and world_size() > 1 \
            and torch.cuda.is_available():
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev


def default_backend(device) -> str:
    """NCCL for CUDA tensors and gloo for CPU tensors."""
    return "cpu:gloo,cuda:nccl" if torch.device(device).type == "cuda" \
        else "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda", backend: Optional[str] = None,
                           timeout_s: float = 600.0) -> bool:
    """Start the process group of a multi-process run (JAX's
    ``initialize_distributed``).

    Opt in with ``MIMM_DISTRIBUTED=1`` (a launcher such as ``torchrun`` has
    set ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``: the
    ``env://`` rendezvous) or with an explicit coordinator, count and id,
    as arguments or as ``MIMM_COORDINATOR_ADDRESS`` (``host:port``, or a
    ``tcp://`` / ``file://`` URL) / ``MIMM_NUM_PROCESSES`` /
    ``MIMM_PROCESS_ID``.  Returns True when a process group exists
    (started here, or already by a launcher: then nothing is done), False
    for a plain single process, which starts nothing.  ``backend``:
    ``default_backend(device)`` unless given."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or \
        os.environ.get("MIMM_COORDINATOR_ADDRESS") or None
    if num_processes is None and os.environ.get("MIMM_NUM_PROCESSES"):
        num_processes = int(os.environ["MIMM_NUM_PROCESSES"])
    if process_id is None and os.environ.get("MIMM_PROCESS_ID"):
        process_id = int(os.environ["MIMM_PROCESS_ID"])
    auto = os.environ.get("MIMM_DISTRIBUTED", "").lower() in ("1", "true",
                                                              "auto")
    if coordinator_address is None and num_processes is None and not auto:
        return False
    backend = backend or default_backend(device)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs the number of "
                             "processes and this process's id "
                             "(MIMM_NUM_PROCESSES, MIMM_PROCESS_ID)")
        kw = dict(init_method=coordinator_address
                  if "://" in coordinator_address
                  else f"tcp://{coordinator_address}",
                  world_size=num_processes, rank=process_id)
    elif num_processes is not None:
        kw = dict(init_method="env://", world_size=num_processes,
                  rank=process_id if process_id is not None
                  else int(os.environ["RANK"]))
    else:
        kw = dict(init_method="env://")
    dev = torch.device(device)
    if dev.type == "cuda":
        # before the group starts, so NCCL binds this rank's card
        rank = kw.get("rank", int(os.environ.get("RANK", "0")))
        torch.cuda.set_device(dev.index if dev.index is not None
                              else local_rank(rank) % torch.cuda.device_count())
    dist.init_process_group(backend, timeout=datetime.timedelta(
        seconds=timeout_s), **kw)
    _GROUPS.clear()
    logger.info("process group started: rank %d of %d, backend %s",
                world_rank(), world_size(), backend)
    return True


def backend_name() -> str:
    """The default group's backend as torch reports it ("" without one)."""
    return str(dist.get_backend()) if dist.is_initialized() else ""


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The world as JAX's mesh: ``data`` × ``model`` × ``pipe`` ranks, this
    process at (``data_rank``, ``model_rank``, ``pipe_rank``);
    ``axis_names`` as given (a 'model' axis named at size 1 still selects
    the TP placements, as in JAX); ``data_group`` / ``model_group`` /
    ``pipe_group``: the process groups of this rank's line along each axis
    (None: the default group, or no collective at size 1).  ``size`` and
    ``rank`` are the world's."""

    data: int = 1
    model: int = 1
    data_rank: int = 0
    model_rank: int = 0
    axis_names: tuple = (DATA_AXIS,)
    data_group: Any = dataclasses.field(default=None, compare=False,
                                        repr=False)
    model_group: Any = dataclasses.field(default=None, compare=False,
                                         repr=False)
    pipe: int = 1
    pipe_rank: int = 0
    pipe_group: Any = dataclasses.field(default=None, compare=False,
                                        repr=False)

    @property
    def size(self) -> int:
        return self.data * self.model * self.pipe

    @property
    def rank(self) -> int:
        return world_rank() if self.size > 1 else 0

    @property
    def shape(self) -> Dict[str, int]:
        sizes = {DATA_AXIS: self.data, MODEL_AXIS: self.model,
                 PIPE_AXIS: self.pipe}
        return {a: sizes.get(a, 1) for a in self.axis_names}

    @property
    def tp(self) -> bool:
        """The mesh names a 'model' axis (JAX's ``tp_mesh``)."""
        return MODEL_AXIS in self.axis_names


_GROUPS: Dict[tuple, Any] = {}


def _axis_group(dims: tuple, axis: int, rank: int):
    """The process group of the ranks that differ from ``rank`` only in
    mesh axis ``axis`` of the row-major layout ``dims``; every rank creates
    every such group in the same order (``dist.new_group`` is collective).
    None when that axis is the whole world."""
    n = int(np.prod(dims))
    if dims[axis] == n:
        return None
    key = (dims, axis)
    if key not in _GROUPS:
        grid = np.arange(n).reshape(dims)
        lines = np.moveaxis(grid, axis, -1).reshape(-1, dims[axis])
        mine = None
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                mine = g
        _GROUPS[key] = mine
    return _GROUPS[key]


def make_mesh(mesh_shape: Optional[Dict[str, int]] = None,
              dcn_mesh_shape: Optional[Dict[str, int]] = None) -> Mesh:
    """The world as a mesh.  ``mesh_shape``: e.g. ``{'data': 2, 'model':
    2}`` or ``{'data': 2, 'pipe': 2}`` (all ranks on 'data' by default),
    laid out in its axis order as JAX reshapes its devices;
    ``dcn_mesh_shape``: the factor of each axis that spans hosts.  On GPUs
    it only orders the ranks, so an axis of ``n × dcn`` ranks gives the
    same math; it is validated as JAX does.  'model' and 'pipe' both
    larger than 1 raise ``ValueError``: JAX's pipelined text tower
    replicates over 'model'."""
    mesh_shape = dict(mesh_shape or {})
    if dcn_mesh_shape and not mesh_shape:
        raise ValueError("dcn_mesh_shape requires an explicit mesh_shape "
                         "(the per-slice factors)")
    unknown = set(dcn_mesh_shape or {}) - set(mesh_shape)
    if unknown:
        raise ValueError(f"dcn_mesh_shape axes {sorted(unknown)} not in "
                         f"mesh_shape {tuple(mesh_shape)}")
    total = {a: int(s) * int((dcn_mesh_shape or {}).get(a, 1))
             for a, s in mesh_shape.items()}
    for axis, size in total.items():
        if axis not in (DATA_AXIS, MODEL_AXIS, PIPE_AXIS) and size > 1:
            raise ValueError(f"unknown mesh axis {axis!r} (the port's axes: "
                             f"{DATA_AXIS!r}, {MODEL_AXIS!r}, {PIPE_AXIS!r})")
    if total.get(MODEL_AXIS, 1) > 1 and total.get(PIPE_AXIS, 1) > 1:
        raise ValueError(
            f"a mesh of 'model' {total[MODEL_AXIS]} and 'pipe' "
            f"{total[PIPE_AXIS]}: pipeline parallelism runs the text "
            f"layers without tensor parallelism (JAX builds the pipelined "
            f"BertLayer without the mesh and its resident layout wins over "
            f"TP), so the 'model' axis would only replicate; use one of "
            f"the two")
    n, rank = world_size(), world_rank()
    if not mesh_shape:
        return Mesh(data=n, data_rank=rank if n > 1 else 0)
    want = int(np.prod(list(total.values())))
    if want != n:
        raise ValueError(f"mesh {mesh_shape} x DCN {dcn_mesh_shape or {}} "
                         f"needs {want} ranks, the world has {n}")
    names = tuple(total)
    dims = tuple(total.values())
    coords = dict(zip(names, np.unravel_index(rank, dims))) if n > 1 \
        else {a: 0 for a in names}
    groups = {}
    for axis in (DATA_AXIS, MODEL_AXIS, PIPE_AXIS):
        if total.get(axis, 1) > 1 and n > 1:
            groups[axis] = _axis_group(dims, names.index(axis), rank)
    return Mesh(data=total.get(DATA_AXIS, 1), model=total.get(MODEL_AXIS, 1),
                pipe=total.get(PIPE_AXIS, 1),
                data_rank=int(coords.get(DATA_AXIS, 0)),
                model_rank=int(coords.get(MODEL_AXIS, 0)),
                pipe_rank=int(coords.get(PIPE_AXIS, 0)), axis_names=names,
                data_group=groups.get(DATA_AXIS),
                model_group=groups.get(MODEL_AXIS),
                pipe_group=groups.get(PIPE_AXIS))


def mesh_size(mesh: Optional[Mesh]) -> int:
    """The 'data' axis's size (1 without a mesh)."""
    return 1 if mesh is None else mesh.data


def model_size(mesh: Optional[Mesh]) -> int:
    """The 'model' axis's size (1 without a mesh)."""
    return 1 if mesh is None else mesh.model


def pipe_size(mesh: Optional[Mesh]) -> int:
    """The 'pipe' axis's size, the pipeline's stages (1 without a mesh)."""
    return 1 if mesh is None else mesh.pipe


def _group(mesh: Mesh, axis: str):
    return {DATA_AXIS: mesh.data_group, MODEL_AXIS: mesh.model_group,
            PIPE_AXIS: mesh.pipe_group}[axis]


def _axis_size(mesh: Optional[Mesh], axis: str) -> int:
    return {DATA_AXIS: mesh_size, MODEL_AXIS: model_size,
            PIPE_AXIS: pipe_size}[axis](mesh)


def _axis_rank(mesh: Mesh, axis: str) -> int:
    return {DATA_AXIS: mesh.data_rank, MODEL_AXIS: mesh.model_rank,
            PIPE_AXIS: mesh.pipe_rank}[axis]


def axis_global_rank(mesh: Mesh, axis: str, index: int) -> int:
    """The world rank of the rank at ``index`` along ``axis`` in this
    rank's line of it."""
    group = _group(mesh, axis)
    return index if group is None else dist.get_global_rank(group, index)


# ---- collectives ----------------------------------------------------------

def _all_gather(x: torch.Tensor, mesh: Mesh, axis: str,
                dim: int = 0) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(_axis_size(mesh, axis))]
    dist.all_gather(parts, x, group=_group(mesh, axis))
    return torch.cat(parts, dim=dim)


def _all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, group=_group(mesh, axis))
    return out


def _slice(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    n = _axis_size(mesh, axis)
    size = x.shape[dim] // n
    return x.narrow(dim, _axis_rank(mesh, axis) * size, size)


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 in data order; the backward returns this
    data index's rows of the gradient (every rank holds the same loss)."""

    @staticmethod
    def forward(ctx, x, mesh, rank):
        ctx.rows, ctx.rank = x.shape[0], rank
        return _all_gather(x, mesh, DATA_AXIS)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.rows
        return grad[lo:lo + ctx.rows], None, None


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x`` of every data index stacked along dim 0 in data order (equal
    row counts), with autograd: the gradient of a rank's rows is its rows
    of the gathered tensor's gradient, not summed over the ranks."""
    if mesh_size(mesh) == 1:
        return x
    return _GatherRows.apply(x, mesh, mesh.data_rank)


class _AllReduceSum(torch.autograd.Function):
    """Sum over an axis; the backward sums the ranks' gradients, since
    each rank's copy of the sum feeds that rank's share of the loss."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh, ctx.axis), None, None


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``x`` over the 'data' axis, with autograd."""
    if mesh_size(mesh) == 1:
        return x
    return _AllReduceSum.apply(x, mesh, DATA_AXIS)


# -- the 'model' axis: tensor and sequence parallelism --

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh, MODEL_AXIS), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh, MODEL_AXIS)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherSeq(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward ``reduce`` True: the sum
    over the ranks, then this rank's slice (the gathered tensor feeds a
    column-parallel product, each rank's branch a part of its gradient);
    False: this rank's slice (the gathered tensor feeds replicated
    work)."""

    @staticmethod
    def forward(ctx, x, mesh, dim, reduce):
        ctx.mesh, ctx.dim, ctx.reduce = mesh, dim, reduce
        return _all_gather(x, mesh, MODEL_AXIS, dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.reduce:
            grad = _all_reduce(grad, ctx.mesh, MODEL_AXIS)
        return _slice(grad, ctx.mesh, MODEL_AXIS, ctx.dim).contiguous(), \
            None, None, None


class _ScatterSeq(torch.autograd.Function):
    """This rank's slice along ``dim`` forward; backward: the all-gather
    (``reduce`` True: of the slices of a sum over the ranks)."""

    @staticmethod
    def forward(ctx, x, mesh, dim, reduce):
        ctx.mesh, ctx.dim = mesh, dim
        if reduce:
            x = _all_reduce(x, mesh, MODEL_AXIS)
        return _slice(x, mesh, MODEL_AXIS, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.mesh, MODEL_AXIS, ctx.dim), None, None, \
            None


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Identity forward, the gradient summed over 'model' backward: the
    input of column-parallel products (or a replicated parameter that each
    rank applies to its own tokens)."""
    if model_size(mesh) == 1:
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum over 'model' forward, identity backward: the output of a
    row-parallel product."""
    if model_size(mesh) == 1:
        return x
    return _ReduceFromModel.apply(x, mesh)


def gather_seq(x: torch.Tensor, mesh: Optional[Mesh],
               dim: int = 1) -> torch.Tensor:
    """Every rank's tokens (all-gather along ``dim``) into a
    column-parallel product; backward: reduce-scatter."""
    if model_size(mesh) == 1:
        return x
    return _GatherSeq.apply(x, mesh, dim, True)


def gather_seq_replicated(x: torch.Tensor, mesh: Optional[Mesh],
                          dim: int = 1) -> torch.Tensor:
    """Every rank's tokens out of the sequence-parallel region into
    replicated work; backward: this rank's slice."""
    if model_size(mesh) == 1:
        return x
    return _GatherSeq.apply(x, mesh, dim, False)


def reduce_scatter_seq(x: torch.Tensor, mesh: Optional[Mesh],
                       dim: int = 1) -> torch.Tensor:
    """The sum over 'model' of a row-parallel product's partials, this
    rank's tokens of it; backward: all-gather."""
    if model_size(mesh) == 1:
        return x
    return _ScatterSeq.apply(x, mesh, dim, True)


def scatter_seq(x: torch.Tensor, mesh: Optional[Mesh],
                dim: int = 1) -> torch.Tensor:
    """This rank's tokens of a replicated tensor, into the
    sequence-parallel region; backward: all-gather."""
    if model_size(mesh) == 1:
        return x
    return _ScatterSeq.apply(x, mesh, dim, False)


class _GatherDim(torch.autograd.Function):
    """All-gather a TP piece along ``dim`` forward; backward: this rank's
    piece of the gradient (the full tensor feeds replicated work)."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _all_gather(x, mesh, MODEL_AXIS, dim)

    @staticmethod
    def backward(ctx, grad):
        return _slice(grad, ctx.mesh, MODEL_AXIS, ctx.dim).contiguous(), \
            None, None


def gather_model_dim(x: torch.Tensor, mesh: Optional[Mesh],
                     dim: int) -> torch.Tensor:
    """The whole tensor of a TP piece split along ``dim``, with autograd
    (the rank keeps its piece of the gradient)."""
    if model_size(mesh) == 1 or dim is None:
        return x
    return _GatherDim.apply(x, mesh, dim)


def _name_buckets(tensors: dict, keys: list) -> List[List[str]]:
    """``keys`` of ``tensors`` ({name: tensor}) grouped by (device, dtype),
    in their order: one collective each."""
    buckets: Dict[tuple, List[str]] = {}
    for k in keys:
        buckets.setdefault((tensors[k].device, tensors[k].dtype),
                           []).append(k)
    return list(buckets.values())


def _buckets(tensors: List[torch.Tensor]) -> Dict[tuple, List[torch.Tensor]]:
    buckets: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        buckets.setdefault((t.device, t.dtype), []).append(t)
    return buckets


@torch.no_grad()
def all_reduce_(tensors: Iterable[torch.Tensor], mesh: Optional[Mesh],
                dtype: Optional[torch.dtype] = None,
                scale: Optional[float] = None,
                axis: str = DATA_AXIS) -> None:
    """Sum each tensor over ``axis`` ('data' by default) in place, in one
    collective per (device, dtype) bucket; ``dtype``: the collective's
    dtype (the sum rounded to it), ``scale``: a factor applied after the
    sum."""
    tensors = list(tensors)
    if _axis_size(mesh, axis) == 1 or not tensors:
        return
    for (_, dt), group in _buckets(tensors).items():
        flat = torch.cat([t.reshape(-1).to(dtype or dt) for t in group])
        dist.all_reduce(flat, group=_group(mesh, axis))
        if scale is not None:
            flat = flat / scale
        off = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n


@torch.no_grad()
def broadcast_(tensors: Iterable[torch.Tensor], mesh: Optional[Mesh],
               src: int = 0, axis: Optional[str] = None) -> None:
    """Rank ``src``'s values into every rank's tensors, in place: of the
    world (``axis`` None), or along a mesh axis (``src`` an index on it)."""
    tensors = list(tensors)
    size = (1 if mesh is None else mesh.size) if axis is None \
        else _axis_size(mesh, axis)
    if size == 1 or not tensors:
        return
    group = None if axis is None else _group(mesh, axis)
    root = src if axis is None else axis_global_rank(mesh, axis, src)
    for group_t in _buckets(tensors).values():
        flat = torch.cat([t.reshape(-1) for t in group_t])
        dist.broadcast(flat, root, group=group)
        off = 0
        for t in group_t:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def any_rank(flag: bool, mesh: Optional[Mesh], device="cpu") -> bool:
    """True if ``flag`` is set on any rank of the world (a collective
    every rank calls)."""
    if mesh is None or mesh.size == 1:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                     device=_collective_device(device))
    dist.all_reduce(t)
    return bool(t.item())


def _collective_device(device) -> torch.device:
    """A device the default group can reduce on: the rank's card where
    the group has no CPU backend (pure NCCL), else the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return rank_device(dev)
    if backend_name() == "nccl":
        return rank_device("cuda")
    return torch.device("cpu")


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None and mesh.size > 1:
        dist.barrier()


# ---- batches and replicated state ------------------------------------------

def local_rows(mesh: Optional[Mesh], rows: int) -> slice:
    """This data index's rows of a global batch of ``rows``; raises when
    the 'data' axis does not divide it."""
    n = mesh_size(mesh)
    if rows % n:
        raise ValueError(f"batch of {rows} rows not divisible by the "
                         f"{n}-rank data axis")
    local = rows // n
    lo = (0 if mesh is None else mesh.data_rank) * local
    return slice(lo, lo + local)


def shard_batch(mesh: Optional[Mesh], batch: dict) -> dict:
    """This data index's rows of every array of a global batch (JAX's
    ``shard_batch``: the leading dim over 'data', replicated over
    'model'); raises on a batch the 'data' axis does not divide."""
    rows = next(iter(batch.values())).shape[0]
    sl = local_rows(mesh, rows)
    return {k: v[sl] for k, v in batch.items()}


def replicate(mesh: Optional[Mesh], tree):
    """Rank 0's values of every tensor of ``tree`` (a module, a tensor, or
    nested dicts / lists of tensors) on every rank of the world, in place;
    returns ``tree``."""
    broadcast_(_tensors(tree), mesh)
    return tree


def _tensors(tree) -> list:
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + [
            b for b in tree.buffers() if b.dtype.is_floating_point
            or b.dtype in (torch.int32, torch.int64)]
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


# ---- placements: which axis of a tensor a mesh axis splits ------------------
#
# A placement is an int (the tensor's dim split over the mesh axis, each
# index holding one contiguous slice) or None (replicated), in a tree of the
# same structure as the tensors'.

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def seq_sharding(mesh: Optional[Mesh]) -> Optional[int]:
    """The dim of a (B, L, H) activation that sequence parallelism splits
    over 'model' (1), or None when the mesh has no 'model' axis (SP
    without TP has no all-reduce to split), as JAX's ``seq_sharding``."""
    return 1 if mesh is not None and mesh.tp else None


_COLUMN = (".attention.self.query.", ".attention.self.key.",
           ".attention.self.value.", ".intermediate.dense.")


def bert_tp_shardings(mesh: Optional[Mesh], text_params: dict) -> dict:
    """The TP placement of the text tower's parameters (names of
    ``TextBert.named_parameters()``): query / key / value / intermediate
    column-parallel (torch's (out, in) weight and the bias split along
    dim 0, so a rank holds whole heads), attention output / FFN output
    row-parallel (the weight along dim 1, the bias replicated), the rest
    replicated.  All None without a 'model' axis."""
    def place(name: str) -> Optional[int]:
        if mesh is None or not mesh.tp:
            return None
        if any(c in "." + name for c in _COLUMN):
            return 0
        if name.endswith("output.dense.weight"):
            return 1
        return None

    return {n: place(n) for n in text_params}


def critic_tp_shardings(mesh: Optional[Mesh], critic_params: list) -> list:
    """The critic's TP placement (its ``[{'w': (in, out), 'b'}]`` layers):
    layer 0 column-parallel (w along dim 1, b along dim 0), layer 1
    row-parallel (w along dim 0, b replicated), the rest replicated."""
    tp = mesh is not None and mesh.tp
    return [{"w": (1 if i == 0 else 0 if i == 1 else None) if tp else None,
             "b": 0 if tp and i == 0 else None}
            for i in range(len(critic_params))]


def zero1_shardings(mesh: Optional[Mesh], tree):
    """The ZeRO-1 / FSDP placement over 'data' (JAX's rule): each tensor
    split along its largest axis that the 'data' axis divides, ties to
    the leading axis; a tensor with no such axis (scalars, odd shapes) is
    replicated.  Same structure as ``tree``."""
    d = mesh_size(mesh)

    def place(t) -> Optional[int]:
        shape = tuple(getattr(t, "shape", ()))
        best = None
        if d > 1:
            for i, s in enumerate(shape):
                if s % d == 0 and (best is None or s > shape[best]):
                    best = i
        return best

    return _tree_map(place, tree)


def shard_leaf(t: torch.Tensor, dim: Optional[int], mesh: Optional[Mesh],
               axis: str) -> torch.Tensor:
    """This rank's slice of ``t`` along ``dim`` over ``axis`` (a copy);
    ``t`` itself when replicated."""
    n = _axis_size(mesh, axis)
    if dim is None or n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"a tensor of shape {tuple(t.shape)} does not split "
                         f"along dim {dim} over the {n}-rank {axis!r} axis")
    return _slice(t.detach(), mesh, axis, dim).clone()


@torch.no_grad()
def gather_leaf(t: torch.Tensor, dim: Optional[int], mesh: Optional[Mesh],
                axis: str) -> torch.Tensor:
    """The whole tensor of the slices of every rank of ``axis``
    (``shard_leaf``'s inverse, bit for bit)."""
    if dim is None or _axis_size(mesh, axis) == 1:
        return t
    return _all_gather(t.detach(), mesh, axis, dim)


@torch.no_grad()
def gather_leaves(tensors: dict, dims: dict, mesh: Optional[Mesh],
                  axis: str) -> dict:
    """``gather_leaf`` of each of ``tensors`` ({name: slice}) along
    ``dims[name]``, in one all-gather per (device, dtype) bucket."""
    n = _axis_size(mesh, axis)
    out = dict(tensors)
    split = [k for k, t in tensors.items() if dims.get(k) is not None]
    if n == 1 or not split:
        return out
    for keys in _name_buckets(tensors, split):
        whole = _all_gather(torch.cat([tensors[k].detach().reshape(-1)
                                       for k in keys]), mesh, axis)
        parts = whole.chunk(n)
        off = 0
        for k in keys:
            t = tensors[k]
            size = t.numel()
            out[k] = torch.cat([p[off:off + size].view(t.shape)
                                for p in parts], dim=dims[k])
            off += size
    return out


_LAYER = "bert.encoder.layer."


def pipe_shardings(mesh: Optional[Mesh], text_params: dict) -> dict:
    """The pipeline placement of the text tower's parameters (names of
    ``TextBert.named_parameters()``; JAX's ``pp_resident_shardings``): the
    stage that holds each encoder layer's tensors, layer i on stage
    ``i // (n / S)``, and None (replicated) for the embeddings, the pooler
    and the classifier.  All None without a 'pipe' axis; raises
    ``ValueError`` when S does not divide the n layers."""
    stages = pipe_size(mesh)
    layer = {n: int(n[len(_LAYER):].split(".")[0]) for n in text_params
             if n.startswith(_LAYER)}
    if stages == 1 or not layer:
        return {n: None for n in text_params}
    n_layers = max(layer.values()) + 1
    if n_layers % stages:
        raise ValueError(f"num_hidden_layers={n_layers} not divisible by "
                         f"pipeline stages={stages}")
    per = n_layers // stages
    return {n: (layer[n] // per if n in layer else None) for n in text_params}


@torch.no_grad()
def gather_stages(tensors: dict, stages: dict, shapes: dict,
                  mesh: Optional[Mesh]) -> dict:
    """The whole tensors of a pipeline-placed group: each of ``tensors``
    ({name: tensor}) that ``stages[name]`` places on a stage is broadcast
    from that stage over 'pipe' at its full shape (``shapes[name]``), one
    broadcast per stage and dtype; the others as they are."""
    n = pipe_size(mesh)
    out = dict(tensors)
    if n == 1:
        return out
    for stage in range(n):
        keys = [k for k in tensors if stages.get(k) == stage]
        for keys_b in _name_buckets(tensors, keys):
            sizes = [math.prod(shapes[k]) for k in keys_b]
            like = tensors[keys_b[0]]
            if mesh.pipe_rank == stage:
                flat = torch.cat([tensors[k].detach().reshape(-1)
                                  for k in keys_b])
            else:
                flat = torch.empty(sum(sizes), dtype=like.dtype,
                                   device=like.device)
            dist.broadcast(flat, axis_global_rank(mesh, PIPE_AXIS, stage),
                           group=mesh.pipe_group)
            off = 0
            for k, size in zip(keys_b, sizes):
                out[k] = flat[off:off + size].view(shapes[k])
                off += size
    return out


# ---- placed train states ------------------------------------------------------

@dataclasses.dataclass
class GroupLayout:
    """How one parameter group of a train state rests on the mesh:
    ``tp`` its TP placement over 'model' (None: replicated), ``zero`` the
    'data' placement of its optimizer moments (ZeRO-1) and ``fsdp`` that
    of its parameters, both on the rank's TP pieces (None: off); ``pipe``
    the stage of each tensor of a pipeline-placed group (the rank keeps an
    empty tensor for another stage's) with ``shapes`` the whole shapes."""

    tp: Optional[dict] = None
    zero: Optional[dict] = None
    fsdp: Optional[dict] = None
    pipe: Optional[dict] = None
    shapes: Optional[dict] = None


@dataclasses.dataclass
class StateLayout:
    """The placement of every parameter group of a train state."""

    mesh: Mesh
    groups: Dict[str, GroupLayout]


def _map_moments(opt_state, fn):
    """``opt_state`` (AdamState / SGDState / FrozenState of train/optim.py)
    with ``fn`` applied to each of its moment dicts ``{name: tensor}``; a
    state of another optimizer as it is."""
    from mimm_tpu_torch.train import optim

    if isinstance(opt_state, optim.FrozenState):
        return optim.FrozenState(_map_moments(opt_state.inner, fn),
                                 opt_state.trainable)
    if isinstance(opt_state, optim.SGDState):
        return optim.SGDState(opt_state.count, fn(opt_state.trace))
    if isinstance(opt_state, optim.AdamState):
        return optim.AdamState(opt_state.count, fn(opt_state.mu),
                               fn(opt_state.nu))
    return opt_state


def place_group(params: Dict[str, torch.Tensor], opt_state,
                layout: GroupLayout, mesh: Mesh):
    """Cut a group's full parameters (in place: each parameter's ``.data``
    becomes its piece) and its optimizer moments to ``layout``: another
    stage's tensors to empty ones, the TP pieces, then the 'data' slices.
    Returns the placed optimizer state."""
    def staged(n: str, t: torch.Tensor) -> torch.Tensor:
        stage = (layout.pipe or {}).get(n)
        if stage is None or stage == mesh.pipe_rank:
            return t
        return t.new_empty(0)

    with torch.no_grad():
        for n, p in params.items():
            piece = shard_leaf(staged(n, p.data), (layout.tp or {}).get(n),
                               mesh, MODEL_AXIS)
            if layout.fsdp is not None:
                piece = shard_leaf(piece, layout.fsdp.get(n), mesh, DATA_AXIS)
            p.data = piece.contiguous()

    def cut(moments: dict) -> dict:
        out = {}
        for n, t in moments.items():
            t = shard_leaf(staged(n, t), (layout.tp or {}).get(n), mesh,
                           MODEL_AXIS)
            if layout.zero is not None:
                t = shard_leaf(t, layout.zero.get(n), mesh, DATA_AXIS)
            out[n] = t.contiguous()
        return out

    return _map_moments(opt_state, cut)


def gather_params(params: Dict[str, torch.Tensor],
                  layout: Optional[GroupLayout], mesh: Mesh) -> None:
    """FSDP: every parameter's whole TP piece again (all-gathered over
    'data' into ``.data``), before a step's forward."""
    if layout is None or layout.fsdp is None:
        return
    whole = gather_leaves({n: p.data for n, p in params.items()},
                          layout.fsdp, mesh, DATA_AXIS)
    for n, p in params.items():
        p.data = whole[n]


def full_group(params: Dict[str, torch.Tensor], opt_state,
               layout: Optional[GroupLayout], mesh: Optional[Mesh]):
    """The whole tensors of a placed group at rest: ({name: parameter},
    optimizer state), gathered over 'data' (the FSDP slices, the ZeRO-1
    moments), then over 'model' (the TP pieces) and over 'pipe' (the
    stages' layers).  Every rank calls it."""
    if layout is None:
        return dict(params), opt_state

    def whole(tensors: dict, data_dims: Optional[dict]) -> dict:
        if data_dims is not None:
            tensors = gather_leaves(tensors, data_dims, mesh, DATA_AXIS)
        tensors = gather_leaves(tensors, layout.tp or {}, mesh, MODEL_AXIS)
        if layout.pipe is not None:
            tensors = gather_stages(tensors, layout.pipe, layout.shapes,
                                    mesh)
        return tensors

    out = whole({n: p.detach() for n, p in params.items()}, layout.fsdp)
    return out, _map_moments(opt_state, lambda m: whole(m, layout.zero))


@torch.no_grad()
def sharded_update(tx, grads: Dict[str, torch.Tensor], opt_state,
                   params: Dict[str, torch.Tensor],
                   layout: Optional[GroupLayout], mesh: Optional[Mesh],
                   apply=None):
    """One optimizer update of a group whose ``params`` hold their whole
    TP pieces (FSDP gathered) and whose ``grads`` are summed over 'data'.
    ZeRO-1: the update runs on this data index's slices of the gradients
    and parameters (Adam is elementwise: the same bits as the whole
    update's), and the parameters are all-gathered again, or with FSDP
    stay this slice; FSDP alone: the whole update, then the slice.
    ``apply``: ``(params, updates)`` adding the updates in place (by
    default ``train.optim.apply_updates``).  Returns the new optimizer
    state."""
    from mimm_tpu_torch.train.optim import apply_updates
    apply = apply or apply_updates

    zero = None if layout is None else layout.zero
    fsdp = None if layout is None else layout.fsdp
    if zero is None:
        updates, opt_state = tx.update(grads, opt_state, params)
        apply(params, updates)
        for n, p in params.items():
            if fsdp is not None:
                p.data = shard_leaf(p.data, fsdp.get(n), mesh,
                                    DATA_AXIS).contiguous()
        return opt_state
    g = {n: shard_leaf(t, zero.get(n), mesh, DATA_AXIS)
         for n, t in grads.items()}
    p_s = {n: shard_leaf(p.detach(), zero.get(n), mesh, DATA_AXIS).clone()
           for n, p in params.items()}
    updates, opt_state = tx.update(g, opt_state, p_s)
    apply(p_s, updates)
    if fsdp is not None:
        if any(fsdp.get(n) != zero.get(n) for n in params):
            raise ValueError("the FSDP and ZeRO-1 placements differ")
        for n, p in params.items():
            p.data = p_s[n].contiguous()
        return opt_state
    whole = gather_leaves(p_s, zero, mesh, DATA_AXIS)
    for n, p in params.items():
        p.copy_(whole[n])
    return opt_state


def _text_layout(state, mesh: Mesh, zero1: bool, fsdp: bool) -> GroupLayout:
    params = dict(state.model.text_model.named_parameters())
    if mesh.pipe > 1:   # the resident stage layout wins, as in JAX
        return GroupLayout(pipe=pipe_shardings(mesh, params),
                           shapes={n: tuple(p.shape)
                                   for n, p in params.items()})
    if mesh.tp:     # the text moments follow their TP params
        return GroupLayout(tp=bert_tp_shardings(mesh, params))
    return GroupLayout(zero=zero1_shardings(mesh, params) if zero1 else None,
                       fsdp=zero1_shardings(mesh, params) if fsdp else None)


def _local_shapes(full: dict, tp: Optional[dict], mesh: Mesh) -> dict:
    """Stand-ins of the TP pieces' shapes, for the 'data' placement."""
    out = {}
    for n, t in full.items():
        shape = list(t.shape)
        d = (tp or {}).get(n)
        if d is not None and mesh.model > 1:
            shape[d] //= mesh.model
        out[n] = torch.empty(shape, device="meta")
    return out


def mi_state_layouts(mesh: Optional[Mesh], state, zero1: bool = False,
                     fsdp: bool = False) -> Optional[Dict[str, GroupLayout]]:
    """The placement ``shard_mi_state`` gives an MI train state (its
    tensors may lie on the meta device: only shapes are read): a
    ``GroupLayout`` for "image_model", "text_model" and "critic", or None
    where everything stays replicated."""
    from mimm_tpu_torch.train.mi import critic_dict

    zero1 = zero1 and mesh_size(mesh) > 1
    fsdp = fsdp and mesh_size(mesh) > 1
    if mesh is None or not (mesh.tp or zero1 or fsdp or mesh.pipe > 1):
        return None
    img = dict(state.model.image_model.named_parameters())
    critic = critic_dict(state.critic_params)
    ctp = critic_tp_shardings(mesh, state.critic_params)
    ctp = {f"{i}.{k}": d for i, layer in enumerate(ctp)
           for k, d in layer.items()} if mesh.tp else None
    critic_local = _local_shapes(critic, ctp, mesh)
    return {
        "image_model": GroupLayout(
            zero=zero1_shardings(mesh, img) if zero1 else None,
            fsdp=zero1_shardings(mesh, img) if fsdp else None),
        "text_model": _text_layout(state, mesh, zero1, fsdp),
        "critic": GroupLayout(
            tp=ctp,
            zero=zero1_shardings(mesh, critic_local) if zero1 else None,
            fsdp=zero1_shardings(mesh, critic_local)
            if fsdp and not mesh.tp else None)}


def shard_mi_state(mesh: Optional[Mesh], state, zero1: bool = False,
                   fsdp: bool = False, sequence_parallel: bool = False):
    """Place an MI train state on the mesh (JAX's ``shard_mi_state`` /
    ``mi_state_specs``).  Rank 0's weights and optimizer state are
    broadcast to the world first.  With a 'model' axis the text tower goes
    tensor-parallel (``bert_tp_shardings``, its moments with it) and the
    critic too (``critic_tp_shardings``), and the BERT modules run their
    TP forward (``models.bert.set_tensor_parallel``), sequence-parallel
    with ``sequence_parallel`` (cfg.sequence_parallel; JAX's
    ``sp_sharding``, which has no effect without the axis).  ``zero1``
    (cfg.zero1_optimizer_sharding): the moments rest 'data'-split
    (``zero1_shardings``): the image tower's and the critic's, and the text
    tower's without TP or a 'pipe' axis.  ``fsdp``
    (cfg.fsdp_parameter_sharding): the parameters rest 'data'-split too:
    the image tower's, and without TP the critic's and (without a 'pipe'
    axis) the text tower's.  With a 'pipe' axis the text tower rests in
    the pipeline layout (``pipe_shardings``: a stage keeps its layers'
    parameters and moments, empty tensors for the others'; parallel/
    pipeline.py runs it).  Sets ``state.layout``; returns the state."""
    from mimm_tpu_torch.models.bert import (set_sequence_parallel,
                                            set_tensor_parallel)

    replicate(mesh, [state.model, state.critic_params])
    _replicate_opt(mesh, [state.img_opt, state.mi_opt, state.txt_opt])
    layouts = mi_state_layouts(mesh, state, zero1, fsdp)
    if layouts is None:
        return state
    img = dict(state.model.image_model.named_parameters())
    state.img_opt = place_group(img, state.img_opt, layouts["image_model"],
                                mesh)
    state.txt_opt = place_group(
        dict(state.model.text_model.named_parameters()), state.txt_opt,
        layouts["text_model"], mesh)
    state.mi_opt = place_group(_critic_params(state), state.mi_opt,
                               layouts["critic"], mesh)
    if mesh.tp:
        set_tensor_parallel(state.model.text_model, mesh)
        set_sequence_parallel(state.model.text_model, sequence_parallel)
    state.layout = StateLayout(mesh, layouts)
    return state


def _critic_params(state) -> Dict[str, torch.Tensor]:
    from mimm_tpu_torch.train.mi import critic_dict
    return critic_dict(state.critic_params)


def _replicate_opt(mesh: Optional[Mesh], opt_states: list) -> None:
    for st in opt_states:
        _map_moments(st, lambda m: replicate(mesh, m))


def ae_state_layout(mesh: Optional[Mesh], state, zero1: bool = False,
                    fsdp: bool = False) -> Optional[GroupLayout]:
    """The placement ``shard_ae_state`` gives an AE train state's model
    (shapes only), or None where everything stays replicated."""
    if mesh is None or mesh.data == 1 or not (zero1 or fsdp):
        return None
    params = dict(state.model.named_parameters())
    return GroupLayout(zero=zero1_shardings(mesh, params) if zero1 else None,
                       fsdp=zero1_shardings(mesh, params) if fsdp else None)


def shard_ae_state(mesh: Optional[Mesh], state, zero1: bool = False,
                   fsdp: bool = False):
    """Place an AE train state (train/ae.py): rank 0's weights broadcast
    to the world; ``zero1`` rests the Adam moments 'data'-split and
    ``fsdp`` the parameters too (``zero1_shardings``, as the MI trainer's
    ZeRO ladder).  Sets ``state.layout``; returns the state."""
    replicate(mesh, state.model)
    _replicate_opt(mesh, [state.opt_state])
    layout = ae_state_layout(mesh, state, zero1, fsdp)
    if layout is None:
        return state
    params = dict(state.model.named_parameters())
    state.opt_state = place_group(params, state.opt_state, layout, mesh)
    state.layout = StateLayout(mesh, {"model": layout})
    return state
