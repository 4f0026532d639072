"""The MI trainer's optimizers (mimm_tpu/train/optim.py counterpart), as
functional updates over parameter dicts ``{name: tensor}``.

* ``adam_torch`` — torch.optim.Adam's rule (betas 0.9/0.999, eps 1e-8),
  for the image tower and the critic (reference main_utils.py:151-160);
* ``adamw_hf`` — pytorch_transformers 1.0.0 ``AdamW``: with
  ``correct_bias=False`` no bias correction, the learning rate taken at
  the count BEFORE the increment (so the first warmup update is exactly
  0), and the decoupled decay applied to the post-step value (reference
  main_utils.py:166-168).  ``torch.optim.AdamW`` does neither;
* ``warmup_linear_schedule``, ``bert_decay_mask``, ``freeze`` and the
  trainable masks.

An optimizer is ``init(params) -> state`` and ``update(grads, state,
params) -> (updates, state)``; ``apply_updates`` adds the updates to the
parameters in place.  ``moment_dtype=torch.bfloat16`` stores the two
moments in bf16 while the update math runs in the gradient dtype (f32).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import torch

Params = Dict[str, torch.Tensor]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


@dataclasses.dataclass
class AdamState:
    count: int
    mu: Params
    nu: Params


def _zeros(params: Params, moment_dtype) -> Params:
    return {n: torch.zeros_like(p, dtype=moment_dtype or p.dtype)
            for n, p in params.items()}


def _init(moment_dtype):
    def init(params: Params) -> AdamState:
        return AdamState(0, _zeros(params, moment_dtype),
                         _zeros(params, moment_dtype))
    return init


def _moments(grads: Params, state: AdamState, b1: float, b2: float):
    """mu = b1·mu + (1−b1)·g and nu = b2·nu + (1−b2)·g², in the gradient
    dtype, as lists in ``grads``' order."""
    names = list(grads)
    g = [grads[n] for n in names]
    mu = [state.mu[n].to(t.dtype) for n, t in zip(names, g)]
    nu = [state.nu[n].to(t.dtype) for n, t in zip(names, g)]
    mu = torch._foreach_add(torch._foreach_mul(mu, b1),
                            torch._foreach_mul(g, 1 - b1))
    nu = torch._foreach_add(torch._foreach_mul(nu, b2),
                            torch._foreach_mul(torch._foreach_mul(g, g),
                                               1 - b2))
    return names, mu, nu


def _store(names, mu, nu, like: Params, moment_dtype):
    cast = lambda t, n: t.to(moment_dtype or like[n].dtype)
    return ({n: cast(m, n) for n, m in zip(names, mu)},
            {n: cast(v, n) for n, v in zip(names, nu)})


def adam_torch(learning_rate, moment_dtype: Optional[torch.dtype] = None
               ) -> GradientTransformation:
    """torch.optim.Adam's update: −lr·(m/bc1)/(√(v/bc2) + eps)."""
    b1, b2, eps = 0.9, 0.999, 1e-8

    def update(grads: Params, state: AdamState, params=None):
        count = state.count + 1
        lr = learning_rate(count) if callable(learning_rate) else learning_rate
        names, mu, nu = _moments(grads, state, b1, b2)
        bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
        denom = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(nu, bc2)), eps)
        upd = torch._foreach_div(torch._foreach_mul(mu, -lr / bc1), denom)
        mu_s, nu_s = _store(names, mu, nu, state.mu, moment_dtype)
        return dict(zip(names, upd)), AdamState(count, mu_s, nu_s)

    return GradientTransformation(_init(moment_dtype), update)


def warmup_linear_schedule(base_lr: float, warmup_steps: float,
                           t_total: int) -> Callable[[int], float]:
    """pytorch_transformers 1.0.0 WarmupLinearSchedule: linear 0 -> 1 over
    ``warmup_steps``, then linear 1 -> 0 until ``t_total``; evaluated at the
    number of completed steps."""
    warmup = float(warmup_steps)

    def schedule(count) -> float:
        count = float(count)
        if count < warmup:
            return base_lr * count / max(1.0, warmup)
        return base_lr * max(0.0, (t_total - count) / max(1.0, t_total - warmup))

    return schedule


def adamw_hf(learning_rate, b1: float = 0.9, b2: float = 0.999,
             eps: float = 1e-6, weight_decay: float = 0.0,
             correct_bias: bool = False, mask=None,
             moment_dtype: Optional[torch.dtype] = None
             ) -> GradientTransformation:
    """pytorch_transformers 1.0.0 ``AdamW``.  ``mask``: ``{name: bool}`` or
    a callable ``params -> {name: bool}`` selecting the parameters that
    decay (the reference excludes biases and LayerNorms)."""

    def update(grads: Params, state: AdamState, params: Params):
        if params is None:
            raise ValueError("adamw_hf requires params")
        count = state.count + 1
        lr = learning_rate(state.count) if callable(learning_rate) \
            else learning_rate
        names, mu, nu = _moments(grads, state, b1, b2)
        step_size = lr * (1 - b2 ** count) ** 0.5 / (1 - b1 ** count) \
            if correct_bias else lr
        decay = (mask(params) if callable(mask) else mask) \
            if mask is not None else {n: True for n in params}
        denom = torch._foreach_add(torch._foreach_sqrt(nu), eps)
        upd = torch._foreach_div(torch._foreach_mul(mu, -step_size), denom)
        out = {}
        for n, s in zip(names, upd):
            if decay[n] and weight_decay > 0.0:
                # decay of the POST-step value: p <- (p + s) − lr·wd·(p + s)
                s = s - lr * weight_decay * (params[n] + s)
            out[n] = s
        mu_s, nu_s = _store(names, mu, nu, state.mu, moment_dtype)
        return out, AdamState(count, mu_s, nu_s)

    return GradientTransformation(_init(moment_dtype), update)


def bert_decay_mask(params: Params) -> Dict[str, bool]:
    """True for the parameters that decay: all but biases and LayerNorm
    parameters (reference no_decay list, main_utils.py:158), by name."""
    return {n: not (n.lower().endswith("bias") or "layernorm" in n.lower())
            for n in params}


@dataclasses.dataclass
class FrozenState:
    inner: object
    trainable: Dict[str, bool]


def freeze(tx: GradientTransformation,
           trainable_mask_fn) -> GradientTransformation:
    """``tx`` on the parameters where ``trainable_mask_fn(params)`` is True;
    the others get zero updates and no optimizer state (reference freezes,
    model.py:83-89,490-495)."""

    def init(params: Params) -> FrozenState:
        trainable = trainable_mask_fn(params)
        return FrozenState(tx.init({n: p for n, p in params.items()
                                    if trainable[n]}), trainable)

    def update(grads: Params, state: FrozenState, params=None):
        keep = lambda d: None if d is None else \
            {n: t for n, t in d.items() if state.trainable[n]}
        upd, inner = tx.update(keep(grads), state.inner, keep(params))
        out = {n: upd[n] if state.trainable[n] else torch.zeros_like(g)
               for n, g in grads.items()}
        return out, FrozenState(inner, state.trainable)

    return GradientTransformation(init, update)


def resnet_trainable_mask(params: Params) -> Dict[str, bool]:
    """Reference ``ResNet256_6_2_1.freeze_encoder`` (model.py:490-495):
    only the last residual stage (layer6) and the fc head train."""
    return {n: n.startswith("layer6") or n.startswith("fc") for n in params}


def bert_trainable_mask(params: Params) -> Dict[str, bool]:
    """Reference ``TextBert.freeze_bert_encoder`` (model.py:83-86): the
    BERT trunk freezes, the classifier head trains."""
    return {n: not n.startswith("bert.") for n in params}


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> None:
    """params += updates, in place."""
    names = list(updates)
    torch._foreach_add_([params[n] for n in names],
                        [updates[n].to(params[n].dtype) for n in names])


def state_to_tree(state) -> dict:
    """An optimizer state as plain dicts, for the resume checkpoint:
    ``AdamState`` -> {"count", "mu", "nu"} (moments in their own dtypes),
    ``FrozenState`` -> {"inner", "trainable"}."""
    if isinstance(state, FrozenState):
        return {"inner": state_to_tree(state.inner),
                "trainable": dict(state.trainable)}
    return {"count": int(state.count), "mu": dict(state.mu),
            "nu": dict(state.nu)}


def state_from_tree(tree: dict, device) -> object:
    """``state_to_tree``'s inverse, the tensors on ``device``."""
    if "inner" in tree:
        return FrozenState(state_from_tree(tree["inner"], device),
                           dict(tree["trainable"]))
    on = lambda d: {n: t.to(device) for n, t in d.items()}
    return AdamState(int(tree["count"]), on(tree["mu"]), on(tree["nu"]))
