"""TextBert — BERT text encoder with a pooled-[CLS] head
(mimm_tpu/models/bert.py counterpart, eval and train forward).

A pytorch_transformers-1.0.0-style BertModel (post-LayerNorm encoder, GELU,
learned position + token-type embeddings, tanh pooler over [CLS]) and a
linear classifier head.  Module names give the reference keys
(``bert.encoder.layer.{i}.attention.self.query.weight``, ...), so reference
``.bin`` files load with ``strict=True``.  Parameters stay float32 and are
cast to the compute dtype at use, as flax does.

Attention takes the hand-written flash kernel (ops/flash_attention.py) under
the dispatch gate of the JAX package (``flash_attention`` and
``L >= flash_min_seq_len`` and ``L % 8 == 0`` and ``head_dim % 8 == 0``);
below it, the plain path is the counterpart of JAX's einsum path.

``deterministic=False`` (JAX's flag) trains: dropout after the embedding
LayerNorm, on the attention probabilities (inside the flash kernels, or
on the plain path), after the attention output and FFN projections, and
on the pooled output before the classifier, every mask drawn from the
``torch.Generator`` the caller passes.

Tensor parallelism (``set_tensor_parallel``, which
``parallel.mesh.shard_mi_state`` calls once it has cut the parameters to
``bert_tp_shardings``): a 'model' rank holds whole heads of query / key /
value and the matching columns of the FFN's first product
(column-parallel), and the matching inputs of the attention output and
FFN output (row-parallel, their biases added once after the sum).  The
fused QKV concatenates the rank's own q, k and v pieces; the flash kernel
runs on the rank's heads with their place among all heads, so its dropout
bits are one rank's; the fused FFN runs on the rank's intermediate
columns.  Sequence parallelism (``set_sequence_parallel``, JAX's
``sp_sharding``): between the products a rank holds L/M tokens, the
gathers and reduce-scatters of parallel/mesh.py at the products' edges;
where M does not divide L the call runs as TP alone, as JAX's ``_sp`` is
then a no-op.  Every dropout mask is drawn whole from the shared
generator and the rank's part applied, so a world draws one rank's masks.

Pipeline parallelism (parallel/pipeline.py) calls the forward's pieces
apart: ``BertModel.embed`` on stage 0, ``encode`` over a stage's range of
layers with a generator of each (layer, microbatch), and ``pool`` and
``TextBert.head`` on every rank.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mimm_tpu_torch.ops.dropout import dropout_fn
from mimm_tpu_torch.ops.embedding import embedding_lookup
from mimm_tpu_torch.ops.flash_attention import flash_attention
from mimm_tpu_torch.ops.fused_ffn import fused_ffn
from mimm_tpu_torch.parallel.mesh import (copy_to_model, gather_seq,
                                          gather_seq_replicated,
                                          reduce_from_model,
                                          reduce_scatter_seq, scatter_seq)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """pytorch_transformers BertConfig fields + the JAX package's knobs.

    ``packed_dropout`` / ``u8_dropout`` pick the training dropout
    (ops/dropout.py); ``remat`` recomputes each encoder layer's activations
    in the backward (``nn.remat(BertLayer)``), with the forward's dropout
    masks.  ``whole_sample`` selection (``flash_whole_sample_max_len``)
    picked a TPU grid; both grids are one function here.  ``fused_ffn``
    takes the fused FFN kernels (ops/fused_ffn.py) where ``gelu_tanh`` is
    set too, and is ignored with the erf GELU, as in the JAX package."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    num_classes: int = 1
    packed_dropout: bool = False
    u8_dropout: bool = False
    remat: bool = False
    fused_qkv: bool = True
    softmax_dtype: str = "float32"
    flash_attention: bool = False
    flash_whole_sample_max_len: int = 512
    flash_min_seq_len: int = 256
    gelu_tanh: bool = False
    fused_ffn: bool = False

    @classmethod
    def from_json_file(cls, path: str, **overrides) -> "BertConfig":
        with open(path) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        raw = {k: v for k, v in raw.items() if k in known}
        if "vocab_size_or_config_json_file" in raw:  # v1.0.0 field name
            raw["vocab_size"] = raw.pop("vocab_size_or_config_json_file")
        raw.update(overrides)
        return cls(**raw)

    # standard BertConfig attributes only: execution knobs stay out of a
    # config.json that a pytorch_transformers consumer might read
    _ARCH_FIELDS = ("vocab_size", "hidden_size", "num_hidden_layers",
                    "num_attention_heads", "intermediate_size", "hidden_act",
                    "hidden_dropout_prob", "attention_probs_dropout_prob",
                    "max_position_embeddings", "type_vocab_size",
                    "initializer_range", "layer_norm_eps", "num_classes")

    def to_json_file(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump({k: getattr(self, k) for k in self._ARCH_FIELDS},
                      f, indent=2, sort_keys=True)
            f.write("\n")
        return path


class _Holder(nn.Module):
    """Named submodules only: reproduces a reference key path."""

    def __init__(self, /, **modules):
        super().__init__()
        for name, m in modules.items():
            setattr(self, name, m)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor,
                grad_sum=None) -> torch.Tensor:
    """Statistics in at least float32, result in the compute dtype.
    ``grad_sum``: a mesh whose 'model' axis sums the scale's and shift's
    gradients (a sequence-parallel rank normalizes its own tokens)."""
    dt = torch.promote_types(x.dtype, torch.float32)
    return F.layer_norm(x.to(dt), ln.normalized_shape,
                        copy_to_model(ln.weight, grad_sum).to(dt),
                        copy_to_model(ln.bias, grad_sum).to(dt),
                        ln.eps).to(x.dtype)


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        h = config.hidden_size
        self.config = config
        self.tp = None          # the mesh of a tensor-parallel rank
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)

    def forward(self, hidden, attn_bias, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """The context of this rank's heads, (B, L, heads·D): all heads,
        or under TP the heads of its query / key / value pieces."""
        cfg = self.config
        hd = cfg.hidden_size // cfg.num_attention_heads
        width = self.query.weight.shape[0]          # this rank's heads·D
        nh = width // hd
        b, seq_len, _ = hidden.shape
        dt = hidden.dtype
        if cfg.fused_qkv:
            # each of q, k and v takes its own heads' rows
            w = torch.cat([self.query.weight, self.key.weight,
                           self.value.weight]).to(dt)
            bias = torch.cat([self.query.bias, self.key.bias,
                              self.value.bias]).to(dt)
            q, k, v = F.linear(hidden, w, bias).split(width, dim=-1)
        else:
            q, k, v = (_linear(m, hidden)
                       for m in (self.query, self.key, self.value))
        # (B, L, H, D) -> (B, H, L, D)
        q, k, v = (t.reshape(b, seq_len, nh, hd).transpose(1, 2)
                   for t in (q, k, v))
        offset = 0 if self.tp is None else self.tp.model_rank * nh
        return attention(cfg, q, k, v, attn_bias, deterministic, generator,
                         head_offset=offset)


def attention(cfg: BertConfig, q, k, v, attn_bias, deterministic: bool = True,
              generator: Optional[torch.Generator] = None,
              head_offset: int = 0) -> torch.Tensor:
    """softmax(q·kᵀ/√D + attn_bias) with dropout, times v: q, k, v (B, H,
    L, D) views, attn_bias (B, 1, 1, L); returns the context as (B, L, H·D).
    The flash kernel under the gate, else the plain path.  The H heads are
    heads ``head_offset`` .. of the config's ``num_attention_heads`` (a
    tensor-parallel rank's), whose dropout bits they take."""
    b, nh, seq_len, hd = q.shape
    heads = cfg.num_attention_heads
    dt = q.dtype
    if cfg.flash_attention and seq_len >= cfg.flash_min_seq_len \
            and seq_len % 8 == 0 and hd % 8 == 0:
        rate = 0.0 if deterministic else cfg.attention_probs_dropout_prob
        seed = None
        if rate > 0.0:  # one int32 seed per layer from the step's stream
            seed = torch.randint(0, 2 ** 31 - 1, (1,), dtype=torch.int32,
                                 device=q.device, generator=generator)
        bias_row = attn_bias[:, 0, 0, :].float().contiguous()   # (B, L)
        ctx = flash_attention(q.contiguous(), k.contiguous(),
                              v.contiguous(), bias_row, seed, rate,
                              head_offset=head_offset, heads_total=heads)
        return ctx.transpose(1, 2).reshape(b, seq_len, nh * hd)

    scores = torch.matmul(q, k.transpose(-1, -2)) \
        / torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dt)
    scores = scores + attn_bias
    if cfg.softmax_dtype == "float32":
        sdt = torch.promote_types(dt, torch.float32)
        probs = torch.softmax(scores.to(sdt), dim=-1).to(dt)
    else:
        probs = torch.softmax(
            scores - scores.amax(dim=-1, keepdim=True).detach(), dim=-1)
    part = None
    if nh < heads:      # this rank's heads of the whole mask
        part = ((b, heads, seq_len, seq_len),
                (slice(None), slice(head_offset, head_offset + nh)))
    probs = dropout_fn(cfg)(probs, cfg.attention_probs_dropout_prob,
                            generator, deterministic, part=part)
    ctx = torch.matmul(probs, v)
    return ctx.transpose(1, 2).reshape(b, seq_len, nh * hd)


class BertLayer(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_eps
        self.config = config
        self.tp = None          # the mesh of a tensor-parallel rank
        self.attention = _Holder(
            self=BertSelfAttention(config),
            output=_Holder(dense=nn.Linear(h, h),
                           LayerNorm=nn.LayerNorm(h, eps=eps)))
        self.intermediate = _Holder(
            dense=nn.Linear(h, config.intermediate_size))
        self.output = _Holder(dense=nn.Linear(config.intermediate_size, h),
                              LayerNorm=nn.LayerNorm(h, eps=eps))

    def forward(self, hidden, attn_bias, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        if self.tp is not None:
            return self._forward_tp(hidden, attn_bias, deterministic,
                                    generator)
        cfg = self.config
        drop = dropout_fn(cfg)
        att = self.attention
        a = _linear(att.output.dense,
                    att.self(hidden, attn_bias, deterministic, generator))
        a = drop(a, cfg.hidden_dropout_prob, generator, deterministic)
        hidden = _layer_norm(att.output.LayerNorm, hidden + a)
        if cfg.fused_ffn and cfg.gelu_tanh:
            # the same two nn.Linear parameter sets, another binding: the
            # kernels read the (out, in) weights in place through .t()
            dt = hidden.dtype
            w1, w2 = self.intermediate.dense, self.output.dense
            out = fused_ffn(hidden.reshape(-1, cfg.hidden_size),
                            w1.weight.to(dt).t(), w1.bias.to(dt),
                            w2.weight.to(dt).t(), w2.bias.to(dt)
                            ).reshape(hidden.shape)
        else:
            inter = _linear(self.intermediate.dense, hidden)
            inter = F.gelu(inter,
                           approximate="tanh" if cfg.gelu_tanh else "none")
            out = _linear(self.output.dense, inter)
        out = drop(out, cfg.hidden_dropout_prob, generator, deterministic)
        return _layer_norm(self.output.LayerNorm, hidden + out)

    def _forward_tp(self, hidden, attn_bias, deterministic, generator):
        """The layer on a tensor-parallel rank.  ``hidden``: (B, L, h), or
        under sequence parallelism this rank's (B, L/M, h) tokens (told
        apart from ``attn_bias``'s L)."""
        cfg, mesh = self.config, self.tp
        drop = dropout_fn(cfg)
        att = self.attention
        full_len = attn_bias.shape[-1]
        sp = hidden.shape[1] != full_len

        def enter(x):       # into a column-parallel product
            return gather_seq(x, mesh) if sp else copy_to_model(x, mesh)

        def leave(x, bias):     # out of a row-parallel one, bias once
            if sp:
                return reduce_scatter_seq(x, mesh) \
                    + copy_to_model(bias, mesh).to(x.dtype)
            return reduce_from_model(x, mesh) + bias.to(x.dtype)

        def dropped(x):
            part = None
            if sp:      # this rank's tokens of the whole mask
                n = x.shape[1]
                lo = mesh.model_rank * n
                part = ((x.shape[0], full_len, x.shape[2]),
                        (slice(None), slice(lo, lo + n)))
            return drop(x, cfg.hidden_dropout_prob, generator, deterministic,
                        part=part)

        grad_sum = mesh if sp else None
        dense = att.output.dense
        ctx = att.self(enter(hidden), attn_bias, deterministic, generator)
        a = leave(F.linear(ctx, dense.weight.to(ctx.dtype)), dense.bias)
        hidden = _layer_norm(att.output.LayerNorm, hidden + dropped(a),
                             grad_sum)
        x = enter(hidden)
        w1, w2 = self.intermediate.dense, self.output.dense
        dt = x.dtype
        if cfg.fused_ffn and cfg.gelu_tanh:
            # this rank's intermediate columns; b2 after the sum
            out = fused_ffn(x.reshape(-1, cfg.hidden_size),
                            w1.weight.to(dt).t(), w1.bias.to(dt),
                            w2.weight.to(dt).t(),
                            torch.zeros_like(w2.bias, dtype=dt)
                            ).reshape(x.shape)
        else:
            inter = F.gelu(_linear(w1, x),
                           approximate="tanh" if cfg.gelu_tanh else "none")
            out = F.linear(inter, w2.weight.to(dt))
        out = leave(out, w2.bias)
        return _layer_norm(self.output.LayerNorm, hidden + dropped(out),
                           grad_sum)


class BertModel(nn.Module):
    """Post-LN BERT encoder + tanh pooler (pytorch_transformers 1.0.0)."""

    def __init__(self, config: BertConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        h = config.hidden_size
        self.config = config
        self.dtype = dtype
        self.tp = None                  # the mesh of a tensor-parallel rank
        self.sequence_parallel = False
        self.embeddings = _Holder(
            word_embeddings=nn.Embedding(config.vocab_size, h),
            position_embeddings=nn.Embedding(config.max_position_embeddings, h),
            token_type_embeddings=nn.Embedding(config.type_vocab_size, h),
            LayerNorm=nn.LayerNorm(h, eps=config.layer_norm_eps))
        self.encoder = _Holder(layer=nn.ModuleList(
            BertLayer(config) for _ in range(config.num_hidden_layers)))
        self.pooler = _Holder(dense=nn.Linear(h, h))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        if not deterministic:
            _check_training(self.config, generator)
        hidden, attn_bias = self.embed(input_ids, token_type_ids,
                                       attention_mask, deterministic,
                                       generator)
        # sequence parallelism where 'model' divides L (JAX's _sp: a no-op
        # otherwise, the call then runs as TP alone)
        sp = self.tp is not None and self.sequence_parallel \
            and input_ids.shape[1] % self.tp.model == 0
        if sp:
            hidden = scatter_seq(hidden, self.tp)
        hidden = self.encode(hidden, attn_bias,
                             range(self.config.num_hidden_layers),
                             deterministic, lambda i: generator)
        if sp:
            hidden = gather_seq_replicated(hidden, self.tp)
        return hidden, self.pool(hidden[:, 0])

    def embed(self, input_ids, token_type_ids=None, attention_mask=None,
              deterministic: bool = True,
              generator: Optional[torch.Generator] = None):
        """The embeddings' LayerNorm and dropout, (B, L, h) in the compute
        dtype, and the (B, 1, 1, L) additive attention mask."""
        cfg = self.config
        dt = self.dtype
        emb = self.embeddings
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        # the word and token-type lookups sum their gradients in a fixed
        # order (ops/embedding.py); the positions are arange(L), the
        # table's first L rows
        seq = input_ids.shape[1]
        hidden = (embedding_lookup(input_ids,
                                   emb.word_embeddings.weight.to(dt))
                  + emb.position_embeddings.weight[:seq].to(dt)[None]
                  + embedding_lookup(token_type_ids,
                                     emb.token_type_embeddings.weight.to(dt)))
        hidden = _layer_norm(emb.LayerNorm, hidden)
        hidden = dropout_fn(cfg)(hidden, cfg.hidden_dropout_prob, generator,
                                 deterministic)
        return hidden, self.attention_bias(attention_mask)

    def attention_bias(self, attention_mask) -> torch.Tensor:
        """(B, 1, 1, L) additive mask, -10000 on padding, formed in the
        compute dtype (-9984 in bfloat16) as pytorch_transformers does."""
        return (1.0 - attention_mask[:, None, None, :].to(self.dtype)) \
            * -10000.0

    def encode(self, hidden, attn_bias, layers: range,
               deterministic: bool = True, generator_of=lambda i: None):
        """The encoder layers ``layers`` (global indices) over ``hidden``,
        layer i drawing its dropout masks and flash seed from
        ``generator_of(i)``; each layer rematerialized under
        ``config.remat`` when gradients are on."""
        remat = self.config.remat and torch.is_grad_enabled()
        for i in layers:
            layer = self.encoder.layer[i]
            if remat:
                hidden = _remat_layer(layer, hidden, attn_bias, deterministic,
                                      generator_of(i))
            else:
                hidden = layer(hidden, attn_bias, deterministic,
                               generator_of(i))
        return hidden

    def pool(self, cls: torch.Tensor) -> torch.Tensor:
        """tanh(pooler([CLS])), in the compute dtype."""
        return torch.tanh(_linear(self.pooler.dense, cls))


def _remat_layer(layer: BertLayer, hidden, attn_bias, deterministic: bool,
                 generator: Optional[torch.Generator]):
    """``nn.remat(BertLayer)`` (mimm_tpu/models/bert.py:336): the layer's
    activations are recomputed in the backward instead of kept.
    ``torch.utils.checkpoint`` restores only the default generators, so the
    explicit generator's state is taken here and set again at the start of
    each run of the layer: the recompute draws the forward's dropout masks
    and flash seed, and remat changes no result, as in flax, whose RNG
    streams do not depend on ``nn.remat``."""
    state = None if generator is None else generator.get_state()

    def run(h, bias):
        if state is not None:
            generator.set_state(state)
        return layer(h, bias, deterministic, generator)

    return checkpoint(run, hidden, attn_bias, use_reentrant=False,
                      preserve_rng_state=False)


def set_tensor_parallel(module: nn.Module, mesh) -> None:
    """Run every BERT layer of ``module`` as a tensor-parallel rank of
    ``mesh`` (its parameters already cut to ``bert_tp_shardings``), or
    unsharded with ``mesh`` None or a 'model' axis of 1."""
    tp = mesh if mesh is not None and mesh.model > 1 else None
    if tp is not None:
        cfg = next(m.config for m in module.modules()
                   if isinstance(m, (BertModel, BertLayer)))
        for what, n in (("num_attention_heads", cfg.num_attention_heads),
                        ("intermediate_size", cfg.intermediate_size)):
            if n % tp.model:
                raise ValueError(f"{what}={n} does not split over a "
                                 f"{tp.model}-rank 'model' axis")
    for m in module.modules():
        if isinstance(m, (BertModel, BertLayer, BertSelfAttention)):
            m.tp = tp


def set_sequence_parallel(module: nn.Module, on: bool) -> None:
    """Sequence parallelism in every BertModel of ``module`` (effective
    under tensor parallelism)."""
    for m in module.modules():
        if isinstance(m, BertModel):
            m.sequence_parallel = bool(on)


def _check_training(config: BertConfig, generator) -> None:
    rates = (config.hidden_dropout_prob, config.attention_probs_dropout_prob)
    if generator is None and any(r > 0.0 for r in rates):
        raise ValueError("a training forward with dropout needs an explicit "
                         "torch.Generator on the input's device")


class TextBert(nn.Module):
    """BertModel -> dropout -> classifier head; returns (pooled, logits)
    with pooled promoted to at least float32 (reference model.py:54-89)."""

    def __init__(self, config: BertConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.bert = BertModel(config, dtype=dtype)
        self.classifier = nn.Linear(config.hidden_size, config.num_classes)

    def forward(self, input_ids, token_type_ids=None,
                attention_mask: Optional[torch.Tensor] = None, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask,
                              deterministic=deterministic, generator=generator)
        return self.head(pooled, deterministic, generator)

    def head(self, pooled, deterministic: bool = True,
             generator: Optional[torch.Generator] = None):
        """(pooled promoted to at least float32, the classifier's logits
        over its dropout)."""
        pooled = pooled.to(torch.promote_types(pooled.dtype, torch.float32))
        dropped = dropout_fn(self.config)(
            pooled, self.config.hidden_dropout_prob, generator, deterministic)
        return pooled, _linear(self.classifier, dropped)

