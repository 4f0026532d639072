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
from mimm_tpu_torch.ops.flash_attention import flash_attention


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """pytorch_transformers BertConfig fields + the JAX package's knobs.

    ``packed_dropout`` / ``u8_dropout`` pick the training dropout
    (ops/dropout.py); ``remat`` recomputes each encoder layer's activations
    in the backward (``nn.remat(BertLayer)``), with the forward's dropout
    masks.  ``whole_sample`` selection (``flash_whole_sample_max_len``)
    picked a TPU grid; both grids are one function here."""

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


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """Statistics in at least float32, result in the compute dtype."""
    dt = torch.promote_types(x.dtype, torch.float32)
    return F.layer_norm(x.to(dt), ln.normalized_shape, ln.weight.to(dt),
                        ln.bias.to(dt), ln.eps).to(x.dtype)


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        h = config.hidden_size
        self.config = config
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)

    def forward(self, hidden, attn_bias, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        cfg = self.config
        h, nh = cfg.hidden_size, cfg.num_attention_heads
        hd = h // nh
        b, seq_len, _ = hidden.shape
        dt = hidden.dtype
        if cfg.fused_qkv:
            w = torch.cat([self.query.weight, self.key.weight,
                           self.value.weight]).to(dt)
            bias = torch.cat([self.query.bias, self.key.bias,
                              self.value.bias]).to(dt)
            q, k, v = F.linear(hidden, w, bias).split(h, dim=-1)
        else:
            q, k, v = (_linear(m, hidden)
                       for m in (self.query, self.key, self.value))
        # (B, L, H, D) -> (B, H, L, D)
        q, k, v = (t.reshape(b, seq_len, nh, hd).transpose(1, 2)
                   for t in (q, k, v))

        if cfg.flash_attention and seq_len >= cfg.flash_min_seq_len \
                and seq_len % 8 == 0 and hd % 8 == 0:
            rate = 0.0 if deterministic else cfg.attention_probs_dropout_prob
            seed = None
            if rate > 0.0:  # one int32 seed per layer from the step's stream
                seed = torch.randint(0, 2 ** 31 - 1, (1,), dtype=torch.int32,
                                     device=hidden.device, generator=generator)
            bias_row = attn_bias[:, 0, 0, :].float().contiguous()   # (B, L)
            ctx = flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), bias_row, seed, rate)
            return ctx.transpose(1, 2).reshape(b, seq_len, h)

        scores = torch.matmul(q, k.transpose(-1, -2)) \
            / torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dt)
        scores = scores + attn_bias
        if cfg.softmax_dtype == "float32":
            sdt = torch.promote_types(dt, torch.float32)
            probs = torch.softmax(scores.to(sdt), dim=-1).to(dt)
        else:
            probs = torch.softmax(
                scores - scores.amax(dim=-1, keepdim=True).detach(), dim=-1)
        probs = dropout_fn(cfg)(probs, cfg.attention_probs_dropout_prob,
                                generator, deterministic)
        ctx = torch.matmul(probs, v)
        return ctx.transpose(1, 2).reshape(b, seq_len, h)


class BertLayer(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        if config.fused_ffn and config.gelu_tanh:
            raise NotImplementedError(
                "fused_ffn (mimm_tpu/ops/fused_ffn.py) is not ported yet: "
                "ROADMAP.md queue B, rows 8-11")
        h, eps = config.hidden_size, config.layer_norm_eps
        self.config = config
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
        cfg = self.config
        drop = dropout_fn(cfg)
        att = self.attention
        a = _linear(att.output.dense,
                    att.self(hidden, attn_bias, deterministic, generator))
        a = drop(a, cfg.hidden_dropout_prob, generator, deterministic)
        hidden = _layer_norm(att.output.LayerNorm, hidden + a)
        inter = _linear(self.intermediate.dense, hidden)
        inter = F.gelu(inter, approximate="tanh" if cfg.gelu_tanh else "none")
        out = _linear(self.output.dense, inter)
        out = drop(out, cfg.hidden_dropout_prob, generator, deterministic)
        return _layer_norm(self.output.LayerNorm, hidden + out)


class BertModel(nn.Module):
    """Post-LN BERT encoder + tanh pooler (pytorch_transformers 1.0.0)."""

    def __init__(self, config: BertConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        h = config.hidden_size
        self.config = config
        self.dtype = dtype
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
        cfg = self.config
        if not deterministic:
            _check_training(cfg, generator)
        dt = self.dtype
        emb = self.embeddings
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        pos_ids = torch.arange(input_ids.shape[1], device=input_ids.device)
        hidden = (F.embedding(input_ids, emb.word_embeddings.weight.to(dt))
                  + F.embedding(pos_ids, emb.position_embeddings.weight.to(dt))[None]
                  + F.embedding(token_type_ids,
                                emb.token_type_embeddings.weight.to(dt)))
        hidden = _layer_norm(emb.LayerNorm, hidden)
        hidden = dropout_fn(cfg)(hidden, cfg.hidden_dropout_prob, generator,
                                 deterministic)
        # (B, 1, 1, L) additive mask, -10000 on padding, formed in the
        # compute dtype (-9984 in bfloat16) as pytorch_transformers does
        attn_bias = (1.0 - attention_mask[:, None, None, :].to(dt)) * -10000.0
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.encoder.layer:
            if remat:
                hidden = _remat_layer(layer, hidden, attn_bias, deterministic,
                                      generator)
            else:
                hidden = layer(hidden, attn_bias, deterministic, generator)
        pooled = torch.tanh(_linear(self.pooler.dense, hidden[:, 0]))
        return hidden, pooled


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
        pooled = pooled.to(torch.promote_types(pooled.dtype, torch.float32))
        dropped = dropout_fn(self.config)(
            pooled, self.config.hidden_dropout_prob, generator, deterministic)
        return pooled, _linear(self.classifier, dropped)

