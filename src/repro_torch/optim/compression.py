"""Gradient compression with error feedback, port of
``repro.optim.compression``.

Two schemes, both with error feedback:

* bf16 — cast grads to bf16 before the all-reduce (2x wire bytes saved);
  residual = fp32 - bf16 accumulates locally and is re-added next step.
* int8 — per-leaf symmetric quantization (scale = max|g|/127); 4x saved.

The hook is a pair (encode, decode) applied around a data-parallel sum
(``repro_torch.runtime.robust_agg``'s, or any all-reduce).  A gradient tree
is a dict of tensors (nested dicts allowed); the residual tree has its
structure, in f32.

Error feedback keeps the scheme unbiased over time: e_{t+1} = g_t - Q(g_t + e_t).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class EFState(NamedTuple):
    residual: Any  # same structure as grads, fp32


def _map(fn: Callable, *trees):
    """``fn`` over the leaves of dict trees of one structure (a non-dict
    is a leaf, so a (codes, scale) pair is one)."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _unzip(pairs):
    """A tree of (a, b) pairs -> (tree of a, tree of b)."""
    if isinstance(pairs, dict):
        split = {k: _unzip(v) for k, v in pairs.items()}
        return ({k: v[0] for k, v in split.items()},
                {k: v[1] for k, v in split.items()})
    return pairs


def init_ef(grads_like) -> EFState:
    return EFState(_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                        grads_like))


def encode_bf16(grads, ef: EFState):
    """Returns (the bf16 tree to send, the new EFState)."""
    def enc(g, r):
        gf = g.float() + r
        q = gf.to(torch.bfloat16)
        return q, gf - q.float()
    q, r = _unzip(_map(enc, grads, ef.residual))
    return q, EFState(r)


def decode_bf16(q):
    return _map(lambda g: g.float(), q)


def encode_int8(grads, ef: EFState):
    """Returns (a tree of (int8 codes, f32 scale) pairs, the new EFState).
    The scale is max(|g + r|.max(), 1e-12) / 127; codes round half to even
    and clip to +-127."""
    def enc(g, r):
        gf = g.float() + r
        scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        return (q, scale), gf - q.float() * scale
    q, r = _unzip(_map(enc, grads, ef.residual))
    return q, EFState(r)


def decode_int8(q):
    return _map(lambda pair: pair[0].float() * pair[1], q)
