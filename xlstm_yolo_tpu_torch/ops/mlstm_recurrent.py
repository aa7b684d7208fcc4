"""Step-by-step mLSTM: the oracles the chunkwise forms are tested against,
and the recurrent tail of the inference wrapper.

Counterpart of ``xlstm_yolo_tpu/ops/mlstm_recurrent.py``: the sigmoid
input gate (``mlstm_siging_step`` / ``mlstm_siging_recurrent_sequence``,
state (C, n)) and the exponential input gate with the max stabilizer m
(``mlstm_step_stabilized`` / ``mlstm_recurrent_sequence_stabilized``, state
(C, n, m), C and n relative to m).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xlstm_yolo_tpu_torch.utils.torch_utils import acc_dtype

__all__ = ["mlstm_recurrent_sequence_stabilized", "mlstm_siging_recurrent_sequence",
           "mlstm_siging_step", "mlstm_step_stabilized"]


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


def mlstm_step_stabilized(q, k, v, i, f, c_state, n_state, m_state, qk_scale=None,
                          eps: float = 1e-6):
    """One timestep of the exp-input-gate mLSTM.  q/k: (B, NH, DHQK),
    v: (B, NH, DHHV), i/f: (B, NH), m_state (B, NH).

        m' = max(logsig(f) + m, i)
        C' = e^{logsig(f) + m - m'} C + e^{i - m'} k v^T,  n' likewise with k
        h  = (qs C') / (max(|qs . n'|, e^{-m'}) + eps),  qs = q / sqrt(DHQK)
    """
    if qk_scale is None:
        qk_scale = q.shape[-1] ** -0.5
    acc = acc_dtype(q.dtype)
    logf = F.logsigmoid(f.to(acc))
    iv = i.to(acc)
    m_new = torch.maximum(logf + m_state, iv)
    fbar = torch.exp(logf + m_state - m_new)[..., None]
    ibar = torch.exp(iv - m_new)[..., None]
    kf, vf, qs = k.to(acc), v.to(acc), q.to(acc) * qk_scale
    c_new = fbar[..., None] * c_state + (ibar * kf)[..., :, None] * vf[..., None, :]
    n_new = fbar * n_state + ibar * kf
    num = torch.einsum("bhd,bhdv->bhv", qs, c_new)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qs, n_new).abs(), torch.exp(-m_new))
    h = num / (den[..., None] + eps)
    return h.to(q.dtype), (c_new, n_new, m_new)


def mlstm_recurrent_sequence_stabilized(q, k, v, i, f, c_initial=None, n_initial=None,
                                        m_initial=None, qk_scale=None, eps: float = 1e-6,
                                        return_last_states: bool = False):
    """Loop :func:`mlstm_step_stabilized` over S from (C, n, m) (zeros by
    default).  q/k: (B, NH, S, DHQK), i/f: (B, NH, S)."""
    B, NH, S, DHQK = q.shape
    acc = acc_dtype(q.dtype)
    C = (c_initial.to(acc) if c_initial is not None
         else torch.zeros(B, NH, DHQK, v.shape[-1], dtype=acc, device=q.device))
    n = (n_initial.to(acc) if n_initial is not None
         else torch.zeros(B, NH, DHQK, dtype=acc, device=q.device))
    m = (m_initial.to(acc) if m_initial is not None
         else torch.zeros(B, NH, dtype=acc, device=q.device))
    hs = []
    for t in range(S):
        h, (C, n, m) = mlstm_step_stabilized(q[:, :, t], k[:, :, t], v[:, :, t], i[..., t],
                                             f[..., t], C, n, m, qk_scale=qk_scale, eps=eps)
        hs.append(h)
    h = torch.stack(hs, dim=2)
    if return_last_states:
        return h, (C, n, m)
    return h
