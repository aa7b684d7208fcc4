"""Quadratic (parallel-form) sigmoid-input-gate mLSTM: an oracle for the
chunkwise forms, independent of them.

Counterpart of ``mlstm_siging_parallel`` in
``xlstm_yolo_tpu/ops/mlstm_parallel.py``.  No main path runs it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xlstm_yolo_tpu_torch.utils.torch_utils import acc_dtype

__all__ = ["mlstm_siging_parallel"]


def mlstm_siging_parallel(q, k, v, i, f, eps: float = 1e-6, normalize: bool = True,
                          stable_fgate: bool = True, stopgrad_norm: bool = False):
    """q, k: (B, NH, S, DHQK), v: (B, NH, S, DHHV), i, f: (B, NH, S).

        D[l, j] = exp(sum_{t=j+1..l} logsig(f_t) + logsig(i_j)),  j <= l
        C       = (q k^T / sqrt(DHQK)) * D
        h_l     = sum_j C[l, j] v_j / (max(|sum_j C[l, j]|, 1) + eps)

    Gate math and products in float32 (float64 for float64 inputs); h in
    q's dtype.  ``stable_fgate`` sums the forget gates of each (l, j)
    directly instead of differencing a cumsum; ``stopgrad_norm`` detaches
    the denominator.
    """
    B, NH, S, DHQK = q.shape
    acc = acc_dtype(q.dtype)
    log_fg = F.logsigmoid(f.to(acc))
    log_ig = F.logsigmoid(i.to(acc))
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    if stable_fgate:
        mat = torch.tril(log_fg[..., :, None].expand(B, NH, S, S), diagonal=-1)
        mat_log_fg = torch.cumsum(mat, dim=-2)
    else:
        csum = torch.cumsum(log_fg, dim=-1)
        mat_log_fg = csum[..., :, None] - csum[..., None, :]
    mat_log_fg = torch.where(causal, mat_log_fg, torch.full((), -torch.inf, dtype=acc,
                                                            device=q.device))
    mat_D = torch.exp(mat_log_fg + log_ig[..., None, :])
    mat_C = (q.to(acc) @ k.to(acc).transpose(-1, -2)) * DHQK ** -0.5 * mat_D
    if normalize:
        n = torch.clamp(mat_C.sum(-1, keepdim=True).abs(), min=1.0)
        if stopgrad_norm:
            n = n.detach()
        mat_C = mat_C / (n + eps)
    return (mat_C @ v.to(acc)).to(q.dtype)
