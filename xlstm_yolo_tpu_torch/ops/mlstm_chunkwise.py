"""Chunkwise-parallel mLSTM in plain PyTorch.

Counterpart of ``xlstm_yolo_tpu/ops/mlstm_chunkwise.py``: the sigmoid
input gate (:func:`mlstm_siging_chunkwise`, below) and the exponential
input gate with the max stabilizer (:func:`mlstm_chunkwise_stabilized`, the
registry's ``chunkwise--native_stablef``).  The sequence is split into chunks of length L; the recurrent
state ``C`` (DHQK x DHHV) and normalizer ``n`` (DHQK) are carried across
chunk boundaries while everything inside a chunk is a dense product.

Per chunk, with all gate math in float32 (float64 for float64 inputs):
    b[l]  = sum_{t<=l} logsig(f_t)
    a[l]  = sum_{t>l} logsig(f_t) + logsig(i_l)
    g     = b[L-1]
    C_k   = exp(g) C_{k-1} + (exp(a) * k)^T v
    n_k   = exp(g) n_{k-1} + sum_l exp(a_l) k_l
    D[l,j]= exp(b[l] - b[j] + logsig(i_j)),  j <= l
    h_l   = (exp(b[l]) qs_l C_{k-1} + sum_j D[l,j] (qs_l . k_j) v_j)
            / (max(|exp(b[l]) qs_l . n_{k-1} + sum_j D[l,j] (qs_l . k_j)|, 1) + eps)

A ragged S is handled by masking: rows past S get logsig(f) = 0 (the
decay passes through) and logsig(i) = -inf (they add nothing), and their
q/k/v are zero.  This is the definition the CUDA kernel in
``ops/chunkwise_v2.py`` is held against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from xlstm_yolo_tpu_torch.utils.torch_utils import acc_dtype

__all__ = ["ChunkGates", "chunkwise_log_gates", "mlstm_chunkwise_stabilized",
           "mlstm_siging_chunkwise"]


class ChunkGates(NamedTuple):
    """Per-chunk log-gate tensors, shape (B, NH, NC, L)."""

    vecB: torch.Tensor  # inclusive intra-chunk cumsum of logsig(f)
    vecA: torch.Tensor  # sum_{t>l} logsig(f) + logsig(i)
    scaG: torch.Tensor  # (B, NH, NC) total chunk decay
    logi: torch.Tensor  # logsig(i), -inf on masked rows


def chunkwise_log_gates(i: torch.Tensor, f: torch.Tensor, chunk_size: int,
                        seq_len: int | None = None) -> ChunkGates:
    """vecB / vecA / scaG for (B, NH, S) gates with S a multiple of L.

    Rows at or past ``seq_len`` (default: S) are masked inert.
    """
    B, NH, S = f.shape
    L = chunk_size
    if S % L:
        raise ValueError(f"S={S} not divisible by chunk_size={L}")
    NC = S // L
    acc = acc_dtype(f.dtype)
    logf = F.logsigmoid(f.to(acc))
    logi = F.logsigmoid(i.to(acc))
    if seq_len is not None and seq_len < S:
        valid = torch.arange(S, device=f.device) < seq_len
        logf = torch.where(valid, logf, torch.zeros((), dtype=acc, device=f.device))
        logi = torch.where(valid, logi, torch.full((), -torch.inf, dtype=acc, device=f.device))
    logf = logf.reshape(B, NH, NC, L)
    logi = logi.reshape(B, NH, NC, L)
    vecB = torch.cumsum(logf, dim=-1)
    scaG = vecB[..., -1]
    vecA = (scaG[..., None] - vecB) + logi
    return ChunkGates(vecB, vecA, scaG, logi)


def mlstm_siging_chunkwise(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    i: torch.Tensor,
    f: torch.Tensor,
    chunk_size: int = 64,
    c_initial: torch.Tensor | None = None,
    n_initial: torch.Tensor | None = None,
    qk_scale: float | None = None,
    return_last_states: bool = False,
    eps: float = 1e-6,
    stopgrad_norm: bool = False,
    den: torch.Tensor | None = None,
    return_chunk_states: bool = False,
):
    """Chunkwise siging mLSTM over (B, NH, S, DH) heads, any S.

    q/k: (B, NH, S, DHQK), v: (B, NH, S, DHHV), i/f: (B, NH, S).  The
    arithmetic runs in float32 (float64 for float64 inputs); ``h`` is
    returned in q's dtype and the last states ``(C, n)`` in that type.

    ``stopgrad_norm`` detaches the max(|.|, 1) denominator, as the kernel's
    backward and the JAX package's Pallas VJP do; without it autograd
    differentiates through it (the JAX ``chunkwise--native_autograd``).
    ``den`` (B, NH, NC, L) replaces the computed denominator by a given
    constant (the backward's recompute from saved forward values).
    ``return_chunk_states`` appends ``(C_prev, n_prev, den)``: the state
    before each chunk (B, NH, NC, DHQK, DHHV) / (B, NH, NC, DHQK) and the
    denominator per row (B, NH, NC, L), 1 on padded rows.
    """
    B, NH, S, DHQK = q.shape
    DHHV = v.shape[-1]
    L = chunk_size
    NC = -(-S // L)
    pad = NC * L - S
    if qk_scale is None:
        qk_scale = DHQK ** -0.5
    dev = q.device
    acc = acc_dtype(q.dtype)

    def padded(x):
        x = x.to(acc)
        return F.pad(x, (0, 0, 0, pad)) if pad else x

    qc = padded(q).reshape(B, NH, NC, L, DHQK)
    kc = padded(k).reshape(B, NH, NC, L, DHQK)
    vc = padded(v).reshape(B, NH, NC, L, DHHV)
    ip = F.pad(i.to(acc), (0, pad)) if pad else i.to(acc)
    fp = F.pad(f.to(acc), (0, pad)) if pad else f.to(acc)
    vecB, vecA, scaG, logi = chunkwise_log_gates(ip, fp, L, seq_len=S)

    # per-chunk state increments
    kbar = kc * torch.exp(vecA)[..., None]
    dC = torch.einsum("bhnld,bhnlv->bhndv", kbar, vc)
    dN = kbar.sum(dim=-2)
    gbar = torch.exp(scaG)

    C = (c_initial.to(acc) if c_initial is not None
         else torch.zeros(B, NH, DHQK, DHHV, dtype=acc, device=dev))
    n = (n_initial.to(acc) if n_initial is not None
         else torch.zeros(B, NH, DHQK, dtype=acc, device=dev))
    C_prev, n_prev = [], []
    for c in range(NC):  # inter-chunk recurrence; emits the state before chunk c
        C_prev.append(C)
        n_prev.append(n)
        g = gbar[..., c]
        C = g[..., None, None] * C + dC[:, :, c]
        n = g[..., None] * n + dN[:, :, c]
    C_prev = torch.stack(C_prev, dim=2)  # (B, NH, NC, DHQK, DHHV)
    n_prev = torch.stack(n_prev, dim=2)  # (B, NH, NC, DHQK)

    # intra-chunk part; logD is masked BEFORE exp (the upper triangle's
    # b[l] - b[j] > 0 overflows once forget gates close)
    causal = torch.ones(L, L, dtype=torch.bool, device=dev).tril()
    logD = vecB[..., :, None] - vecB[..., None, :] + logi[..., None, :]
    matD = torch.exp(torch.where(causal, logD, torch.full((), -torch.inf, device=dev)))
    matSD = torch.einsum("bhnld,bhnjd->bhnlj", qc, kc) * qk_scale * matD

    qbar = qc * torch.exp(vecB)[..., None] * qk_scale
    num = torch.einsum("bhnld,bhndv->bhnlv", qbar, C_prev) + matSD @ vc
    if den is None:
        den_raw = torch.einsum("bhnld,bhnd->bhnl", qbar, n_prev) + matSD.sum(-1)
        den = torch.clamp(den_raw.abs(), min=1.0)
        if stopgrad_norm:
            den = den.detach()
    else:
        den = den.to(acc)
    h = (num / (den[..., None] + eps)).reshape(B, NH, NC * L, DHHV)[:, :, :S]
    h = h.to(q.dtype)
    out = (h, (C, n)) if return_last_states else h
    if return_chunk_states:
        out = (*(out if return_last_states else (out,)), (C_prev, n_prev, den))
    return out


def mlstm_chunkwise_stabilized(q, k, v, i, f, chunk_size: int = 64, c_initial=None,
                               n_initial=None, m_initial=None, qk_scale: float | None = None,
                               return_last_states: bool = False, eps: float = 1e-6,
                               stopgrad_norm: bool = False):
    """Chunkwise mLSTM with the exponential input gate and a running max m
    per (batch, head), C and n stored relative to it.  q/k: (B, NH, S, DHQK),
    v: (B, NH, S, DHHV), i/f: (B, NH, S), S a multiple of ``chunk_size``;
    optional m_initial (B, NH).

    Per chunk, with b, g as in the siging form and a_l = sum_{t>l} logsig(f_t)
    + i_l (the raw i):
        m_k    = max(g + m_{k-1}, max_l a_l)
        C_k    = e^{g + m_{k-1} - m_k} C_{k-1} + (e^{a - m_k} k)^T v,  n_k likewise
        m_comb = max(b_l + m_{k-1}, max_{j <= l} (b_l - b_j + i_j))   per row
        h_l    = (e^{b_l + m_{k-1} - m_comb} qs_l C_{k-1}
                  + sum_j e^{logD[l, j] - m_comb} (qs_l . k_j) v_j) / (den + eps)
        den    = max(|the same with n and ones|, e^{-m_comb})

    The score products round q, k to q's dtype when it is bfloat16 or
    float16, and the (L, L) tile times [v, 1] (one product gives the
    numerator and the intra-chunk normaliser) rounds both, as the JAX
    function does; the state updates stay unrounded.  ``stopgrad_norm``
    detaches the denominator and both stabilizers (m, m_comb), the
    constants of the kernels' backward.  Returns h in q's dtype, and
    (C, n, m) with ``return_last_states``.
    """
    B, NH, S, DHQK = q.shape
    DHHV = v.shape[-1]
    L = chunk_size
    if S % L:
        raise ValueError(f"S={S} not divisible by chunk_size={L}")
    NC = S // L
    if qk_scale is None:
        qk_scale = DHQK ** -0.5
    dev = q.device
    acc = acc_dtype(q.dtype)
    cd = q.dtype if q.dtype in (torch.bfloat16, torch.float16) else acc

    def R(x):
        return x.to(cd).to(acc)

    sg = (lambda x: x.detach()) if stopgrad_norm else (lambda x: x)
    logf = F.logsigmoid(f.to(acc)).reshape(B, NH, NC, L)
    ic = i.to(acc).reshape(B, NH, NC, L)
    vecB = torch.cumsum(logf, dim=-1)
    rev = logf.flip(-1).cumsum(-1).flip(-1)
    vecA = torch.cat([rev[..., 1:], logf.new_zeros(B, NH, NC, 1)], dim=-1) + ic
    scaG = vecB[..., -1]
    qc, kc, vc = (x.to(acc).reshape(B, NH, NC, L, x.shape[-1]) for x in (q, k, v))

    C = (c_initial.to(acc) if c_initial is not None
         else torch.zeros(B, NH, DHQK, DHHV, dtype=acc, device=dev))
    n = (n_initial.to(acc) if n_initial is not None
         else torch.zeros(B, NH, DHQK, dtype=acc, device=dev))
    m = (m_initial.to(acc) if m_initial is not None
         else torch.zeros(B, NH, dtype=acc, device=dev))
    vecA_max = vecA.amax(-1)
    C_prev, n_prev, m_prev = [], [], []
    for c in range(NC):  # inter-chunk recurrence; emits the state before chunk c
        C_prev.append(C)
        n_prev.append(n)
        m_prev.append(m)
        g = scaG[..., c]
        m_new = sg(torch.maximum(g + m, vecA_max[..., c]))
        gbar = torch.exp(g + m - m_new)
        kbar = kc[:, :, c] * torch.exp(vecA[:, :, c] - m_new[..., None])[..., None]
        C = gbar[..., None, None] * C + torch.einsum("bhld,bhlv->bhdv", kbar, vc[:, :, c])
        n = gbar[..., None] * n + kbar.sum(-2)
        m = m_new
    C_prev = torch.stack(C_prev, dim=2)
    n_prev = torch.stack(n_prev, dim=2)
    m_prev = torch.stack(m_prev, dim=2)  # (B, NH, NC)

    causal = torch.ones(L, L, dtype=torch.bool, device=dev).tril()
    logD = vecB[..., :, None] - vecB[..., None, :] + ic[..., None, :]
    logD = torch.where(causal, logD, torch.full((), -torch.inf, dtype=acc, device=dev))
    b_inter = vecB + m_prev[..., None]
    m_comb = sg(torch.maximum(b_inter, logD.amax(-1)))
    matSD = R((R(qc) @ R(kc).transpose(-1, -2)) * qk_scale
              * torch.exp(logD - m_comb[..., None]))
    qbar = qc * torch.exp(b_inter - m_comb)[..., None] * qk_scale
    h_ext = matSD @ torch.cat([R(vc), vc.new_ones(B, NH, NC, L, 1)], dim=-1)
    num = R(qbar) @ R(C_prev) + h_ext[..., :DHHV]
    den_raw = torch.einsum("bhnld,bhnd->bhnl", qbar, n_prev) + h_ext[..., DHHV]
    den = sg(torch.maximum(den_raw.abs(), torch.exp(-m_comb)))
    h = (num / (den[..., None] + eps)).reshape(B, NH, S, DHHV).to(q.dtype)
    if return_last_states:
        return h, (C, n, m)
    return h
