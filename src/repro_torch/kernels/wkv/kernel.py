"""Wrapper of the CUDA chunked WKV6 forward kernel (``csrc/wkv.cu``), and
its plain torch version.

Counterpart of ``repro.kernels.wkv.kernel.wkv_forward_pallas``.  Per
(batch * head) row it sweeps the chunks of c = min(chunk, T) tokens in
order, carrying the state S (K, V) in f32:

    lin   = cumsum(lw)            lprev = lin - lw
    w_ts  = sum_i r[t,i] exp(lprev[t,i] - lin[tau,i]) k[tau,i]   (tau < t)
    o     = w_ts v + (sum_i r u k) v + (r exp(lprev)) S
    S     = exp(lin[-1]) S + (k exp(lin[-1] - lin))^T v

On a CUDA tensor ``wkv_forward_cuda`` launches the kernel on the current
stream (or raises); on a CPU tensor it runs :func:`wkv_forward_plain`,
since there is no kernel to launch.  ``wkv_forward_cuda.launches`` counts
calls that launch: each launches two kernels, the first pass and the chunk
sweep.

``w = w_ts + bonus`` depends on neither S nor V, so a first pass computes
it for every (row, chunk) into scratch (:func:`wkv_chunk_w_plain` is that
pass in plain torch).  The chunk sweep then runs as (V / 16, BH) CTAs, each
sweeping the chunks of one row for 16 columns of S and o
(:func:`wkv_forward_plain` on a V-slice of s0 and v gives that slice of the
whole).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64)       # K (= V) the kernel is instantiated for
MAX_CHUNK = 64                 # c the kernel's shared-memory tiles hold
MAX_ROWS = 65535               # BH: the grid's second dimension


def _cw(c: int) -> int:
    """Floats of w per chunk in the first pass's scratch (c * c, padded to
    a multiple of 4 so that each chunk's block is 16-byte aligned)."""
    return (c * c + 3) // 4 * 4


def _check_shapes(r, k, v, lw, u, s0, chunk: int) -> int:
    """Raise unless the operands are a WKV problem; returns c."""
    if r.dim() != 3 or any(a.shape != r.shape for a in (k, v, lw)):
        raise ValueError(f"wkv_forward: r, k, v, lw must share one "
                         f"(BH, T, K) shape, got {[tuple(a.shape) for a in (r, k, v, lw)]}")
    BH, T, K = r.shape
    if s0.dim() != 3 or s0.shape[:2] != (BH, K):
        raise ValueError(f"wkv_forward: s0 must be (BH, K, V) = ({BH}, {K}, "
                         f"V), got {tuple(s0.shape)}")
    if s0.shape[2] != K:
        # the reference allocates o as (BH, T, K) (kernel.py:114), so it
        # serves V == K only
        raise ValueError(f"wkv_forward: V = {s0.shape[2]} != K = {K}; the "
                         f"output is (BH, T, K), as the reference's, so V "
                         f"must equal K")
    if tuple(u.shape) not in ((K,), (BH, K)):
        raise ValueError(f"wkv_forward: u must be (K,) or (BH, K), got "
                         f"{tuple(u.shape)}")
    if chunk < 1 or T < 1:
        raise ValueError(f"wkv_forward: need chunk >= 1 and T >= 1, got "
                         f"chunk={chunk}, T={T}")
    c = min(chunk, T)
    if T % c:
        # as the reference's Pallas route (kernel.py:91): the caller pads
        raise ValueError(f"wkv_forward: T = {T} is not a multiple of the "
                         f"chunk c = {c}; pad T to a chunk multiple")
    return c


def _chunk(s, r, k, v, lw, u2, mask, compute_dtype):
    """One chunk of the sweep: (S after it, o of its c tokens)."""
    rr, kk, vv, ll = (a.float() for a in (r, k, v, lw))
    lin = torch.cumsum(ll, dim=1)
    lprev = lin - ll
    a = torch.exp(lprev[:, :, None, :] - lin[:, None, :, :])      # (BH,c,c,K)
    a = torch.where(mask[None, :, :, None], a, 0.0)

    def rnd(x):
        # the reference's compute dtype for the big intra-chunk operands;
        # a product of two or three bf16 values is exact in f32, so only
        # the order of the sums differs from its f32-accumulating einsums
        return x.to(compute_dtype).float()

    w_ts = torch.einsum("bti,btsi,bsi->bts", rnd(rr), rnd(a), rnd(kk))
    o = rnd(w_ts) @ rnd(vv)
    o = o + (rr * u2[:, None, :] * kk).sum(-1, keepdim=True) * vv
    o = o + (rr * torch.exp(lprev)) @ s
    last = lin[:, -1:, :]                                         # (BH, 1, K)
    s = s * torch.exp(last).transpose(1, 2) + \
        (kk * torch.exp(last - lin)).transpose(1, 2) @ vv
    return s, o


def wkv_forward_plain(r, k, v, lw, u, s0, *, chunk: int = 16,
                      compute_dtype: torch.dtype = torch.float32,
                      remat: bool = False):
    """The chunked evaluation in plain torch, in the same math as the
    reference's Pallas body (f32 inside); returns (o in r's dtype, sT f32).

    ``compute_dtype`` rounds the intra-chunk operands (r, the decays, k,
    then w and v) to that type first, as the reference's ``wkv_chunked``
    does; ``remat`` recomputes each chunk in a backward pass instead of
    saving its (c, c, K) decays (``torch.utils.checkpoint``), as the
    reference's ``wkv_inner_remat`` does, and changes no value."""
    c = _check_shapes(r, k, v, lw, u, s0, chunk)
    BH, T, K = r.shape
    u2 = (u.reshape(1, K) if u.dim() == 1 else u).float()      # (1|BH, K)
    s = s0.float()
    # tau < t; exp of the masked-out entries may be inf, and where() drops
    # it (never multiply by a mask: inf * 0 is NaN)
    mask = torch.ones((c, c), dtype=torch.bool, device=r.device).tril(-1)
    remat = remat and torch.is_grad_enabled()
    outs = []
    for j in range(T // c):
        sl = slice(j * c, (j + 1) * c)
        args = (s, r[:, sl], k[:, sl], v[:, sl], lw[:, sl], u2, mask,
                compute_dtype)
        s, o = (checkpoint(_chunk, *args, use_reentrant=False) if remat
                else _chunk(*args))
        outs.append(o)
    return torch.cat(outs, dim=1).to(r.dtype), s


def wkv_chunk_w_plain(r, k, lw, u, *, chunk: int = 16):
    """The first pass in plain torch: per (row, chunk) the c x c matrix
    w[t, tau] = sum_i r[t,i] exp(lprev[t,i] - lin[tau,i]) k[tau,i] for
    tau < t, sum_i r[t,i] u[i] k[t,i] on the diagonal, 0 above it; returns
    (BH, T // c, c, c) f32.  The chunk sweep then adds w v to o."""
    BH, T, K = r.shape
    c = min(chunk, T)
    if T % c:
        raise ValueError(f"wkv_chunk_w_plain: T = {T} is not a multiple of "
                         f"the chunk c = {c}")
    rr, kk, ll = (a.float().reshape(BH, T // c, c, K) for a in (r, k, lw))
    u2 = (u.reshape(1, K) if u.dim() == 1 else u).float()[:, None, None, :]
    lin = torch.cumsum(ll, dim=2)
    lprev = lin - ll
    mask = torch.ones((c, c), dtype=torch.bool, device=r.device).tril(-1)
    a = torch.exp(lprev[:, :, :, None, :] - lin[:, :, None, :, :])
    a = torch.where(mask[None, None, :, :, None], a, 0.0)
    w = torch.einsum("bjti,bjtsi,bjsi->bjts", rr, a, kk)
    bonus = (rr * u2 * kk).sum(-1)                        # (BH, nc, c)
    return w + torch.diag_embed(bonus)


def _launch(kern, r, k, v, lw, u, s0, *, chunk: int = 16):
    if r.device.type == "cpu":
        return wkv_forward_plain(r, k, v, lw, u, s0, chunk=chunk)
    c = _check_shapes(r, k, v, lw, u, s0, chunk)
    BH, T, K = r.shape
    if any(a.device != r.device for a in (k, v, lw, u, s0)) or \
            r.device.type != "cuda":
        raise ValueError(f"wkv_forward_cuda: every operand must lie on one "
                         f"CUDA device, got r on {r.device}")
    if r.dtype not in DTYPE_CODES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv_forward_cuda: r, k, v must share a dtype in "
                        f"(float32, bfloat16), got {r.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if any(a.dtype != torch.float32 for a in (lw, u, s0)):
        raise TypeError(f"wkv_forward_cuda: lw, u and s0 must be float32, "
                        f"got {lw.dtype}, {u.dtype}, {s0.dtype}")
    if K not in HEAD_DIMS:
        raise ValueError(f"wkv_forward_cuda: K = {K}; the kernel is built "
                         f"for K in {HEAD_DIMS}")
    if c > MAX_CHUNK:
        raise ValueError(f"wkv_forward_cuda: chunk c = {c} > {MAX_CHUNK}")
    if r.numel() > 2**31 - 1:
        raise ValueError("wkv_forward_cuda: more than 2**31 - 1 elements")
    if BH > MAX_ROWS:
        raise ValueError(f"wkv_forward_cuda: BH = {BH} > {MAX_ROWS} rows")
    # the model hands transposed views; the kernel reads rows contiguously,
    # in 16-byte pieces (cp.async), so every base must be 16-byte aligned
    r, k, v, lw, u, s0 = (a.contiguous() if a.data_ptr() % 16 == 0
                          else a.clone(memory_format=torch.contiguous_format)
                          for a in (r, k, v, lw, u, s0))
    o = torch.empty((BH, T, K), dtype=r.dtype, device=r.device)
    sT = torch.empty((BH, K, K), dtype=torch.float32, device=r.device)
    wbuf = torch.empty((BH * (T // c) * _cw(c),), dtype=torch.float32,
                       device=r.device)
    fn = _build.bind("wkv", "rt_wkv_forward", 9, 6)
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
             u.data_ptr(), s0.data_ptr(), wbuf.data_ptr(), o.data_ptr(),
             sT.data_ptr(), BH, T, K, c, int(u.dim() == 2),
             DTYPE_CODES[r.dtype], _build.stream_ptr(r))
    kern.launches += 1
    _build.check(err, "wkv_forward_cuda")
    return o, sT


def _flops(r, k, v, lw, u, s0, **_) -> float:
    """4 a (row, token, key, value): the state's decay, update and read."""
    BH, T, K = r.shape
    return 4.0 * BH * T * K * K


wkv_forward_cuda = _build.CudaKernel("wkv_forward", _launch, _flops)


def wkv_chunk_w_cuda(r, k, lw, u, *, chunk: int = 16):
    """The kernel's first pass alone (w of every (row, chunk), as
    :func:`wkv_chunk_w_plain` returns it), for checking and timing it on the
    card; no launch counter, since no entry point calls it.  On a CPU tensor
    it is the plain version."""
    if r.device.type == "cpu":
        return wkv_chunk_w_plain(r, k, lw, u, chunk=chunk)
    BH, T, K = r.shape
    c = min(chunk, T)
    if T % c or K not in HEAD_DIMS or not 1 <= c <= MAX_CHUNK:
        raise ValueError(f"wkv_chunk_w_cuda: shape {tuple(r.shape)} with "
                         f"chunk {chunk} is not one the kernel takes")
    if r.dtype not in DTYPE_CODES or k.dtype != r.dtype or \
            lw.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError("wkv_chunk_w_cuda: r, k in float32 or bfloat16, "
                        "lw and u in float32")
    r, k, lw, u = (a.contiguous() for a in (r, k, lw, u))
    nc = T // c
    wbuf = torch.zeros((BH, nc, _cw(c)), dtype=torch.float32, device=r.device)
    fn = _build.bind("wkv", "rt_wkv_w_pass", 5, 6)
    err = fn(r.data_ptr(), k.data_ptr(), lw.data_ptr(), u.data_ptr(),
             wbuf.data_ptr(), BH, T, K, c, int(u.dim() == 2),
             DTYPE_CODES[r.dtype], _build.stream_ptr(r))
    _build.check(err, "wkv_chunk_w_cuda")
    return wbuf[:, :, :c * c].reshape(BH, nc, c, c)
