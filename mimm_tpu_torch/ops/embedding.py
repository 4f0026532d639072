"""An embedding lookup whose backward sums in a fixed order.

``F.embedding``'s CUDA backward sums the gradient rows of one index in an
order that changes from call to call unless
``torch.use_deterministic_algorithms`` is set, a global flag.
``embedding_lookup`` gathers as ``F.embedding`` does (the same bits) and
sums the gradient with plain torch operations whose order depends only on
the indices:

1. sort the flat indices stably and gather the gradient rows in that
   order, widened to float64;
2. in blocks of ``BLOCK`` sorted rows, each row's sum over the rows of its
   block with the same index: one batched product with the 0/1 matrix of
   equal indices (float64, so no TF32 setting reaches it);
3. an index that runs over a block boundary contributes the sum of its
   first and of its last piece in each block; those pieces, two a block,
   are again a sorted sequence, reduced the same way (recursively, to one
   block);
4. the row at which each index starts writes its total, rounded once to
   the weight's dtype, into a zero table.

No step reads a value back to the host.  Every sum runs in float64 and is
rounded once, so in float32 and bfloat16 the result is at least as close
to the exact sum as ``F.embedding``'s float32 accumulation.
"""

from __future__ import annotations

import torch

BLOCK = 32


def _segment_totals(sid: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``sid`` (n,) non-decreasing, ``g`` (n, h): each row's sum over the
    rows of its index, at least at the row where the index starts."""
    n, h = g.shape
    nb = -(-n // BLOCK)
    pad = nb * BLOCK - n
    if pad:
        # an index past every real one, and zero rows
        sid = torch.cat([sid, (sid[-1:] + 1).expand(pad)])
        g = torch.cat([g, g.new_zeros(pad, h)])
    sb = sid.view(nb, BLOCK)
    same = (sb[:, :, None] == sb[:, None, :]).to(g.dtype)
    piece = torch.bmm(same, g.view(nb, BLOCK, h))
    if nb > 1:
        first, last = sb[:, 0], sb[:, -1]
        # a block of one index gives its sum once, as its first piece
        ends = torch.stack([piece[:, 0], torch.where(
            (first == last)[:, None], 0.0, piece[:, -1])], 1)
        tot = _segment_totals(torch.stack([first, last], 1).reshape(-1),
                              ends.reshape(-1, h)).view(nb, 2, h)
        piece = torch.where((sb == first[:, None])[..., None], tot[:, :1],
                            torch.where((sb == last[:, None])[..., None],
                                        tot[:, 1:], piece))
    return piece.reshape(-1, h)[:n]


def embedding_backward(ids: torch.Tensor, dy: torch.Tensor,
                       rows: int) -> torch.Tensor:
    """The (rows, h) gradient of a lookup of ``ids`` given ``dy`` (ids.shape
    + (h,)), in ``dy``'s dtype."""
    h = dy.shape[-1]
    flat = ids.reshape(-1)
    sid, perm = torch.sort(flat, stable=True)
    tot = _segment_totals(
        sid, dy.reshape(-1, h).index_select(0, perm).to(torch.float64))
    start = torch.ones_like(sid, dtype=torch.bool)
    start[1:] = sid[1:] != sid[:-1]
    # one write per index, at its first row; the other rows go to a spare
    # row past the table
    dest = torch.where(start, sid, rows)
    out = dy.new_zeros(rows + 1, h)
    out.index_put_((dest,), tot.to(dy.dtype))
    return out[:rows]


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return weight.index_select(0, ids.reshape(-1)).view(
            *ids.shape, weight.shape[1])

    @staticmethod
    def backward(ctx, dy):
        (ids,) = ctx.saved_tensors
        return None, embedding_backward(ids, dy, ctx.rows)


def embedding_lookup(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, weight)`` (no padding index, no max norm), with a
    backward that gives the same bits on every call."""
    return _Lookup.apply(ids, weight)
