"""AdamW + warmup/cosine schedule over the nested-dict param tree: the
port of ``repro.train.optimizer``.

Moments are kept in f32 whatever the param dtype, and each new param is
written back in its own dtype, as in JAX. The update runs in place under
``torch.no_grad()`` (params, ``mu`` and ``nu`` are overwritten) and still
returns the ``(params, state, metrics)`` triple, so call sites read like
the reference. ``torch.optim.AdamW`` is not this function: it keeps its
moments in the param dtype and has neither the global-norm clip nor this
schedule. ``metrics`` holds 0-d tensors on the params' device; nothing in
the step reads a value back to the host.

Leaves are visited in JAX's order (dict keys sorted), so
``global_norm`` sums its squares in the same order as the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple

import torch

F32 = torch.float32


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor          # 0-d int32
    mu: Any
    nu: Any


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a nested dict, in JAX's order (keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in
                tree_leaves(tree[key])]
    return [tree]


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of a nested dict, keeping its nesting."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, val) for key, val in tree.items()}
    return fn(tree)


def init_opt(params) -> OptState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
    return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                    tree_map(zeros, params), tree_map(zeros, params))


def lr_at(cfg: OptConfig, step):
    """Linear warmup to ``cfg.lr``, then a cosine decay to 0 at
    ``total_steps``. ``step``: a 0-d integer tensor; returns 0-d f32."""
    warm = cfg.lr * (step + 1) / max(1, cfg.warmup_steps)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * cfg.lr * (1.0 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(g.to(F32))) for g in tree_leaves(tree))
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(cfg: OptConfig, params, grads, state: OptState):
    """Returns (params, new_state, metrics); ``params``, ``state.mu`` and
    ``state.nu`` are updated in place."""
    step = state.step
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.betas
    lr = lr_at(cfg, step)
    bc1 = 1.0 - b1 ** (step.to(F32) + 1.0)
    bc2 = 1.0 - b2 ** (step.to(F32) + 1.0)
    for p, g, m, v in zip(*(tree_leaves(t) for t in
                            (params, grads, state.mu, state.nu))):
        g = g.to(F32) * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        step_ = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p.to(F32)
        p.copy_((p.to(F32) - lr * step_).to(p.dtype))
    return params, OptState(step + 1, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}
