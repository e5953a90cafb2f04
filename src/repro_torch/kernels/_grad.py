"""Gradients through the Hopper kernels.

The kernel wrappers fill outputs they allocate themselves, through ctypes:
a result has no ``grad_fn``. So a wrapper whose kernel is on a training
path (``flash_attention``, ``wkv6``) goes through a
``torch.autograd.Function``: its forward is the kernel, its backward
recomputes the plain version under ``torch.enable_grad()`` and returns
autograd's gradient of it (:func:`plain_backward`). That is the gradient
the JAX package's training path takes: XLA differentiates its jnp forms,
and no Pallas kernel there has a backward. Every other launch calls
:func:`refuse_grad` first, so a kernel never hands back a silently
detached result: on the card, an input that requires grad while grad
mode is on raises. On the CPU the wrappers run the plain versions, which
autograd differentiates directly.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise if grad mode is on and one of ``tensors`` requires grad.
    Inside an autograd ``Function``'s forward grad mode is off."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel's output would be detached from autograd; "
            "call it under torch.no_grad(), or through the ops entry point "
            "where the kernel has a gradient")


def plain_backward(plain: Callable, saved: Sequence[torch.Tensor],
                   needs: Sequence[bool], grad_outputs, **kwargs):
    """Autograd's gradient of ``plain(*saved, **kwargs)`` with respect to
    the inputs flagged in ``needs``, for the cotangents ``grad_outputs``
    (one per output of ``plain``). Returns one entry per input, None where
    it was not needed or does not reach the outputs (autograd reads None
    as zero)."""
    inputs = [t.detach().requires_grad_(bool(n)) for t, n in
              zip(saved, needs)]
    wanted = [t for t in inputs if t.requires_grad]
    if not wanted:
        return [None] * len(inputs)
    with torch.enable_grad():
        out = plain(*inputs, **kwargs)
    outs = out if isinstance(out, tuple) else (out,)
    grads = iter(torch.autograd.grad(outs, wanted, tuple(grad_outputs),
                                     allow_unused=True))
    return [next(grads) if t.requires_grad else None for t in inputs]
