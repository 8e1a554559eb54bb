"""Plain torch oracle for the WKV6 recurrence (flattened batch*heads layout),
port of ``repro.kernels.wkv.ref``.

    s_t = diag(w_t) s_{t-1} + k_t v_t^T
    o_t = r_t^T (s_{t-1} + diag(u) k_t v_t^T)

r,k,v: (BH, T, K); lw = log w (<= 0): (BH, T, K); u: (K,) shared or
(BH, K) per row; s0: (BH, K, V).  The CUDA kernel (``csrc/wkv.cu``) and its
plain version (``kernel.py``) evaluate this chunkwise; this oracle is the
step-by-step recurrence.  It computes in the promoted type of its inputs
(f32 for bf16 or f32 inputs, f64 for f64), so a caller can evaluate it in
float64, and returns o in that type, as the reference does.
"""
from __future__ import annotations

import torch


def wkv_ref(r, k, v, lw, u, s0):
    BH, T, K = r.shape
    u2 = (u.reshape(1, K) if u.dim() == 1 else u).expand(BH, K)
    s = s0.float()
    outs = []
    for t in range(T):
        rr, kk, vv, ll = r[:, t], k[:, t], v[:, t], lw[:, t]     # (BH, K)
        kv = kk[:, :, None] * vv[:, None, :]                      # (BH, K, V)
        m = s + u2[:, :, None] * kv
        outs.append(torch.einsum("bi,biv->bv", rr.to(m.dtype), m))
        s = s * torch.exp(ll)[..., None] + kv
    return torch.stack(outs, dim=1), s
