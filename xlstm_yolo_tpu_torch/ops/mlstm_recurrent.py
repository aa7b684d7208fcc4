"""Step-by-step sigmoid-input-gate mLSTM: the oracle the chunkwise forms
are tested against.

Counterpart of ``xlstm_yolo_tpu/ops/mlstm_recurrent.py``
(``mlstm_siging_step`` / ``mlstm_siging_recurrent_sequence``).
"""

from __future__ import annotations

import torch

from xlstm_yolo_tpu_torch.utils.torch_utils import acc_dtype

__all__ = ["mlstm_siging_step", "mlstm_siging_recurrent_sequence"]


def mlstm_siging_step(q, k, v, i, f, c_state, n_state, qk_scale=None, eps: float = 1e-6):
    """One timestep.  q/k: (B, NH, DHQK), v: (B, NH, DHHV), i/f: (B, NH).

        C' = sig(f) C + sig(i) k v^T;  n' = sig(f) n + sig(i) k
        h  = (qs C') / (max(|qs . n'|, 1) + eps),  qs = q / sqrt(DHQK)
    """
    if qk_scale is None:
        qk_scale = q.shape[-1] ** -0.5
    acc = acc_dtype(q.dtype)
    fg = torch.sigmoid(f.to(acc))[..., None]
    ig = torch.sigmoid(i.to(acc))[..., None]
    kf, vf, qs = k.to(acc), v.to(acc), q.to(acc) * qk_scale
    c_new = fg[..., None] * c_state + (ig * kf)[..., :, None] * vf[..., None, :]
    n_new = fg * n_state + ig * kf
    num = torch.einsum("bhd,bhdv->bhv", qs, c_new)
    den = torch.clamp(torch.einsum("bhd,bhd->bh", qs, n_new).abs(), min=1.0)
    h = num / (den[..., None] + eps)
    return h.to(q.dtype), (c_new, n_new)


def mlstm_siging_recurrent_sequence(q, k, v, i, f, c_initial=None, n_initial=None,
                                    qk_scale=None, eps: float = 1e-6,
                                    return_last_states: bool = False):
    """Loop :func:`mlstm_siging_step` over S.  q/k: (B, NH, S, DHQK), i/f: (B, NH, S)."""
    B, NH, S, DHQK = q.shape
    DHHV = v.shape[-1]
    acc = acc_dtype(q.dtype)
    C = (c_initial.to(acc) if c_initial is not None
         else torch.zeros(B, NH, DHQK, DHHV, dtype=acc, device=q.device))
    n = (n_initial.to(acc) if n_initial is not None
         else torch.zeros(B, NH, DHQK, dtype=acc, device=q.device))
    hs = []
    for t in range(S):
        h, (C, n) = mlstm_siging_step(q[:, :, t], k[:, :, t], v[:, :, t], i[..., t], f[..., t],
                                      C, n, qk_scale=qk_scale, eps=eps)
        hs.append(h)
    h = torch.stack(hs, dim=2)
    if return_last_states:
        return h, (C, n)
    return h
