"""Public wrapper: WKV6 forward with a recompute backward, port of
``repro.kernels.wkv.ops`` (a ``jax.custom_vjp`` there).

Forward: the chunk kernel (``wkv_forward_cuda``; its plain version on a
CPU tensor).  Backward: recompute through the step oracle ``wkv_ref`` with
autograd and take its vector-Jacobian product, as the reference does.  The
reference has no backward kernel, so neither does the port.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.wkv.kernel import wkv_forward_cuda
from repro_torch.kernels.wkv.ref import wkv_ref


class WKVForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, lw, u, s0, chunk: int = 16):
        o, sT = wkv_forward_cuda(r, k, v, lw, u, s0, chunk=chunk)
        ctx.save_for_backward(r, k, v, lw, u, s0)
        return o, sT

    @staticmethod
    def backward(ctx, do, dsT):
        inputs = [a.detach().requires_grad_(True) for a in ctx.saved_tensors]
        with torch.enable_grad():
            o, sT = wkv_ref(*inputs)
        # o comes out of the kernel in r's dtype, of the oracle in f32
        grads = torch.autograd.grad((o, sT), inputs, (do.to(o.dtype), dsT))
        return (*grads, None)


def wkv_forward(r, k, v, lw, u, s0, chunk: int = 16):
    """r,k,v,lw: (BH, T, K); u: (K,) or (BH, K); s0: (BH, K, V) ->
    (o (BH, T, K) in r's dtype, sT (BH, K, V) f32)."""
    return WKVForward.apply(r, k, v, lw, u, s0, chunk)
