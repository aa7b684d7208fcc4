"""Sequence-length wrappers around the chunkwise kernels.

Counterpart of ``xlstm_yolo_tpu/ops/wrappers.py``: the same chunk choice,
zero padding and segment plan, so that a kernel whose chunk length is part
of its function (the v1 route rounds its products per chunk) gets the
chunks the JAX package gives it.

- :func:`wrap_chunkwise_pad_zeros` (training): zero-pad S to a multiple of
  the chunk, run, slice back; a kernel with ``handles_ragged`` masks its
  own ragged tail and is called as it is.
- :func:`wrap_chunkwise_arbitrary_sequence_length` (inference): the
  chunkwise kernel over the segments of :func:`chunk_plan` (greedy
  halving of the chunk), the rest through the recurrent sequence
  function, (C, n) threaded across every boundary, and the stabilizer m
  of an exp-gate kernel between its segments.
"""

from __future__ import annotations

import inspect
from typing import Callable

import torch
import torch.nn.functional as F

from xlstm_yolo_tpu_torch.utils.torch_utils import acc_dtype

__all__ = ["chunk_plan", "pick_chunk_size", "wrap_chunkwise_arbitrary_sequence_length",
           "wrap_chunkwise_pad_zeros"]

def pick_chunk_size(S: int, target: int, strict: bool = False, min_chunk: int = 16) -> int:
    """Largest divisor of S that is <= target (>= min_chunk), else target.

    With ``strict`` the reference behaviour is kept: return ``target``
    and rely on zero-padding.
    """
    if strict or S % target == 0:
        return min(target, S) if S % min(target, S) == 0 or strict else target
    best = 0
    for c in range(min(target, S), min_chunk - 1, -1):
        if S % c == 0:
            best = c
            break
    return best if best >= min_chunk else target


def wrap_chunkwise_pad_zeros(kernel: Callable, q, k, v, i, f, chunk_size: int,
                             auto_divisor: bool = True, **kwargs):
    """Zero-pad S to a multiple of the chunk size, run, slice back.

    q, k, v: (B, NH, S, DH); i, f: (B, NH, S).  Training-mode wrapper (no
    state threading).  With ``auto_divisor`` the chunk is the largest
    divisor of S up to ``chunk_size`` (:func:`pick_chunk_size`).
    """
    if kwargs.get("return_last_states", False):
        raise ValueError("the pad-zeros wrapper must not return states (they would include "
                         "padding)")
    S = q.shape[2]
    if getattr(kernel, "handles_ragged", False):
        return kernel(q, k, v, i, f, chunk_size=chunk_size, **kwargs)
    cs = pick_chunk_size(S, chunk_size) if auto_divisor else chunk_size
    pad = (-S) % cs
    if pad == 0:
        return kernel(q, k, v, i, f, chunk_size=cs, **kwargs)
    h = kernel(F.pad(q, (0, 0, 0, pad)), F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad)),
               F.pad(i, (0, pad)), F.pad(f, (0, pad)), chunk_size=cs, **kwargs)
    return h[:, :, :S, :]


def chunk_plan(S: int, chunk_size: int) -> tuple[list[tuple[int, int, int]], int]:
    """The segments of the inference wrapper: ``[(start, length, chunk), ...]``
    and the length of the tail left to the sequence function.  The chunk
    halves while it is >= 16 and fits in what remains; the first chunk
    that does not fit ends the plan."""
    cs, prefix, remaining, plan = chunk_size, 0, S, []
    while cs >= 16 and remaining >= cs:
        seg = (remaining // cs) * cs
        plan.append((prefix, seg, cs))
        prefix += seg
        remaining -= seg
        cs //= 2
    return plan, remaining


def wrap_chunkwise_arbitrary_sequence_length(chunkwise_kernel: Callable, sequence_kernel: Callable,
                                             step_kernel: Callable, q, k, v, i, f,
                                             c_initial=None, n_initial=None,
                                             chunk_size: int = 64, eps: float = 1e-6,
                                             return_last_states: bool = True, **kwargs):
    """Inference-mode wrapper for any S, threading (C, n).

    S = 1 is one step of ``step_kernel``.  Otherwise the chunkwise kernel
    runs each segment of :func:`chunk_plan` from the state the previous
    one left (zeros or the initial state first), and ``sequence_kernel``
    runs the tail.  A kernel that returns (C, n, m) (exp input gate) gets
    m back as ``m_initial`` from its second segment on (the first starts
    from m = 0), and the tail gets it only if ``sequence_kernel`` takes an
    ``m_initial``: the siging recurrence continues from C and n, which are
    stored relative to the dropped m, as in the JAX wrapper.  Returns h,
    and (C, n) with ``return_last_states``.
    """
    B, NH, S, DH = q.shape
    C, n = _zeros_like_state(c_initial, n_initial, q, v)
    if S == 1:
        h, (C, n) = step_kernel(q[:, :, 0], k[:, :, 0], v[:, :, 0], i[:, :, 0], f[:, :, 0],
                                C, n, eps=eps)
        h = h[:, :, None, :]
        return (h, (C, n)) if return_last_states else h

    plan, remaining = chunk_plan(S, chunk_size)
    h_parts, m = [], None  # m: the running max of an exp-gate kernel
    for start, seg, seg_cs in plan:
        sl = slice(start, start + seg)
        h_seg, st = chunkwise_kernel(q[:, :, sl], k[:, :, sl], v[:, :, sl], i[:, :, sl],
                                     f[:, :, sl], chunk_size=seg_cs, c_initial=C, n_initial=n,
                                     return_last_states=True, eps=eps,
                                     **({"m_initial": m} if m is not None else {}), **kwargs)
        C, n = st[0], st[1]
        m = st[2] if len(st) > 2 else None
        h_parts.append(h_seg)
    if remaining > 0:
        sl = slice(S - remaining, S)
        seq_kw = {}
        if m is not None and "m_initial" in inspect.signature(sequence_kernel).parameters:
            seq_kw["m_initial"] = m
        h_tail, st = sequence_kernel(q[:, :, sl], k[:, :, sl], v[:, :, sl], i[:, :, sl],
                                     f[:, :, sl], c_initial=C, n_initial=n, eps=eps,
                                     return_last_states=True, **seq_kw)
        C, n = st[0], st[1]
        h_parts.append(h_tail)
    h = h_parts[0] if len(h_parts) == 1 else torch.cat(h_parts, dim=2)
    return (h, (C, n)) if return_last_states else h


def _zeros_like_state(c, n, q, v):
    B, NH, _, DHQK = q.shape
    acc = acc_dtype(q.dtype)
    if c is None:
        c = torch.zeros(B, NH, DHQK, v.shape[-1], dtype=acc, device=q.device)
    if n is None:
        n = torch.zeros(B, NH, DHQK, dtype=acc, device=q.device)
    return c, n
