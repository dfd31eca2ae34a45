"""Gradients for the forward-only kernels K1 and K2.

The JAX package gives ``vit_attention`` and ``onepass_attention`` a
``custom_vjp`` whose backward recomputes the attention in XLA and
differentiates that (``ops/vit_attention.py:175-193``,
``ops/prefill_attention.py:190-225``); neither has a Pallas backward.
``KernelForwardPlainGrad`` is the port's twin: its forward launches the
kernel, and its backward recomputes the module's plain version from the
saved inputs and differentiates it with autograd.  Without it the output
of a kernel (filled through ``ctypes``) has no ``grad_fn``, and a
gradient into q, k or v is silently dropped.
"""

from __future__ import annotations

from typing import Callable

import torch


class KernelForwardPlainGrad(torch.autograd.Function):
    """``apply(kernel, plain, q, k, v)``: ``kernel(q, k, v)`` forward;
    the gradients of ``plain(q, k, v)`` backward.  ``kernel`` and ``plain``
    close over every non-tensor argument (lengths, segment ids, window)."""

    @staticmethod
    def forward(ctx, kernel: Callable, plain: Callable, q, k, v):
        ctx.plain = plain
        ctx.save_for_backward(q, k, v)
        return kernel(q, k, v)

    @staticmethod
    def backward(ctx, dout):
        inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            out = ctx.plain(*inputs)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, dout))
        return (None, None, *(next(grads) if t.requires_grad else None for t in inputs))
