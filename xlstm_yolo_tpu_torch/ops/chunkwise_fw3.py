"""The sub-chunked chunkwise siging mLSTM forward: the CUDA kernel, its
wrapper and its plain PyTorch version.

Counterpart of ``xlstm_yolo_tpu/ops/pallas/chunkwise_fw3.py`` (``fw3``):
the function of the v2 forward (``ops/chunkwise_v2.py``) with each L-row
chunk walked as L/Lb sub-chunks of Lb rows, the (C, n) state carried from
one sub-chunk to the next, and the v2 forward's outputs and saved states,
so that the v2 backward takes them unchanged.

- :func:`pack_gates_sub` — the relative gate rows of each sub-chunk
  (``_pack_gates_sub``), used by the plain version;
- :func:`fw3_plain` — the plain version, any device, float64 too;
- :func:`fw3` — CPU tensors go to the plain version, CUDA tensors to
  ``csrc/chunkwise_fw3.cu``: the gate rows of every sub-chunk
  (``fw3_gates``), a state pass on the tensor cores that writes the state
  before every sub-chunk in the compute type (``fw3_states``), then an
  output pass with one block per (batch, head, sub-chunk, tile of 64 rows)
  (``fw3_out``); the two passes are the v1 forward's kernels
  (``csrc/chunkwise_v1.cuh``) walking fw3's sub-chunks as their chunks.

``LAUNCHES_FW3`` (``save_states=False``) and ``LAUNCHES_FW3_TRAIN``
(``save_states=True``) count kernel launches, ``LAUNCHES_PER_CALL`` (3) a
call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xlstm_yolo_tpu_torch.ops import cuda_build
from xlstm_yolo_tpu_torch.ops.cuda_build import F as CF
from xlstm_yolo_tpu_torch.ops.cuda_build import HEAD_DIMS, I, P
from xlstm_yolo_tpu_torch.utils.torch_utils import acc_dtype

__all__ = ["LAUNCHES_FW3", "LAUNCHES_FW3_TRAIN", "LAUNCHES_PER_CALL", "SUB_CHUNK", "fw3",
           "fw3_plain", "geometry", "pack_gates_sub", "walked_rows"]

LAUNCHES_PER_CALL = 3   # the gate rows, the state pass, the output pass
LAUNCHES_FW3 = 0        # kernel launches of the inference variant
LAUNCHES_FW3_TRAIN = 0  # kernel launches of the train variant

SUB_CHUNK = 128  # Lb when sub_chunk is None
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib):
    lib.fw3_gates.argtypes = [P] * 3 + [I] * 5 + [P]
    lib.fw3_states.argtypes = [P] * 10 + [I] * 8 + [P]
    lib.fw3_out.argtypes = [P] * 8 + [I] * 8 + [CF, CF, P]
    lib.fw3_gates.restype = lib.fw3_states.restype = lib.fw3_out.restype = I


def _count(save_states: bool):
    global LAUNCHES_FW3, LAUNCHES_FW3_TRAIN
    if save_states:
        LAUNCHES_FW3_TRAIN += 1
    else:
        LAUNCHES_FW3 += 1


def geometry(S: int, chunk_size: int, sub_chunk: int | None):
    """(L, Lb, NC, NB): the chunk, the sub-chunk (L itself where the
    sub-chunk does not divide it, as JAX does), the chunks and the
    sub-chunks of a chunk."""
    L = int(chunk_size)
    Lb = int(sub_chunk or SUB_CHUNK)
    if L <= 0 or Lb <= 0:
        raise ValueError(f"chunk_size {L} and sub_chunk {Lb} must be positive")
    if L % Lb:
        Lb = L
    return L, Lb, -(-S // L), L // Lb


def walked_rows(Lb: int) -> int:
    """The rows the kernels walk for a sub-chunk of Lb rows: whole 64-row
    tiles, or Lb rounded up to 16 below 64 (``padded`` in
    ``csrc/chunkwise_fw3.cu``)."""
    t = 64 if Lb >= 64 else -(-Lb // 16) * 16
    return -(-Lb // t) * t


def _check(q, k, v, i, f, num_heads, c_initial, n_initial, compute_dtype):
    if q.ndim != 3:
        raise ValueError(f"q must be (B, S, NH*DHQK), got {tuple(q.shape)}")
    B, S, Hqk = q.shape
    if S == 0 or B == 0:
        raise ValueError("empty input")
    NH = num_heads
    if Hqk % NH or v.ndim != 3 or v.shape[:2] != (B, S) or v.shape[2] % NH:
        raise ValueError(f"q {tuple(q.shape)} and v {tuple(v.shape)} must split into "
                         f"num_heads={NH}")
    DHQK, DHHV = Hqk // NH, v.shape[2] // NH
    if k.shape != q.shape or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"k must match q and v q's dtype: k {tuple(k.shape)} {k.dtype}, "
                         f"v {v.dtype}, q {tuple(q.shape)} {q.dtype}")
    if compute_dtype not in _DTYPE_CODES:
        raise TypeError(f"compute_dtype {compute_dtype} not supported (float32 or bfloat16)")
    acc = acc_dtype(q.dtype)  # gates and states: float32 (float64 for float64 q)
    for name, t in (("i", i), ("f", f)):
        if t.shape != (B, S, NH) or t.dtype != acc:
            raise ValueError(f"{name} must be {acc} {(B, S, NH)}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    if (c_initial is None) != (n_initial is None):
        raise ValueError("give both c_initial and n_initial or neither")
    if c_initial is not None:
        if c_initial.shape != (B, NH, DHQK, DHHV) or c_initial.dtype != acc:
            raise ValueError(f"c_initial must be {acc} {(B, NH, DHQK, DHHV)}")
        if n_initial.shape != (B, NH, DHQK) or n_initial.dtype != acc:
            raise ValueError(f"n_initial must be {acc} {(B, NH, DHQK)}")
    tensors = [q, k, v, i, f] + ([c_initial, n_initial] if c_initial is not None else [])
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got {t.device}")
    return B, S, NH, DHQK, DHHV, tensors


def pack_gates_sub(i, f, NC: int, L: int, Lb: int):
    """(B, S, NH) gate pre-activations -> the relative rows of each
    Lb-row sub-chunk, as ``_pack_gates_sub``:

        b_rel[l] = cumsum_{t<=l} logsig(f)        (from the sub-chunk's start)
        a_rel[l] = (b_rel[Lb-1] - b_rel[l]) + logsig(i)
        gsub     = b_rel[Lb-1]                    (the sub-chunk's log decay)

    Returns b_rel, a_rel and logsig(i) rows, each (B, NC, NH, L), and gsub
    (B, NC, NB, NH), in the gates' type.  Rows past S are padded inert
    (i -> -1e4, f -> +1e4)."""
    B, S, NH = i.shape
    NB = L // Lb
    pad = NC * L - S
    if pad:
        i = F.pad(i, (0, 0, 0, pad), value=-1e4)
        f = F.pad(f, (0, 0, 0, pad), value=1e4)
    logf = F.logsigmoid(f.reshape(B, NC, NB, Lb, NH))
    logi = F.logsigmoid(i.reshape(B, NC, NB, Lb, NH))
    b_rel = torch.cumsum(logf, dim=3)
    total = b_rel[:, :, :, -1:, :]
    a_rel = (total - b_rel) + logi

    def rows(x):
        return x.reshape(B, NC, L, NH).transpose(2, 3)

    return rows(b_rel), rows(a_rel), rows(logi), total.reshape(B, NC, NB, NH)


def fw3_plain(q, k, v, i, f, num_heads: int, c_initial=None, n_initial=None,
              chunk_size: int = 640, sub_chunk: int | None = None,
              qk_scale: float | None = None, eps: float = 1e-6,
              compute_dtype=torch.bfloat16, save_states: bool = True):
    """Plain version of :func:`fw3`, on any device and for any DHHV, float64
    too (float64 gates and states).  The operands of each product are
    rounded to ``compute_dtype`` where JAX rounds them (q k^T, sd v,
    (q e^b) C_prev, (k e^a)^T v) and the products accumulate in float32
    (float64 for float64 q).  The
    intra-sub-chunk terms of all sub-chunks are computed at once; the state
    is carried across sub-chunks in a loop."""
    B, S, NH, DHQK, DHHV, _ = _check(q, k, v, i, f, num_heads, c_initial, n_initial,
                                     compute_dtype)
    L, Lb, NC, NB = geometry(S, chunk_size, sub_chunk)
    NS = NC * NB
    if qk_scale is None:
        qk_scale = DHQK ** -0.5
    acc = acc_dtype(q.dtype)

    def rt(x):  # the operand of a product, rounded to the compute type
        return x.to(compute_dtype).to(acc)

    brow, arow, lirow, gsub = pack_gates_sub(i, f, NC, L, Lb)

    def subs(x):  # (B, NC, NH, L) rows -> (B, NH, NS, Lb)
        return x.transpose(1, 2).reshape(B, NH, NS, Lb)

    b, a, li = subs(brow), subs(arow), subs(lirow)
    g = gsub.permute(0, 3, 1, 2).reshape(B, NH, NS)

    def streams(x, D):  # (B, S, NH*D), rows past S zeroed -> (B, NH, NS, Lb, D)
        x = F.pad(x.to(acc), (0, 0, 0, NC * L - S))
        return x.reshape(B, NS, Lb, NH, D).permute(0, 3, 1, 2, 4)

    qs, ks, vs = streams(q, DHQK), streams(k, DHQK), streams(v, DHHV)
    causal = torch.ones(Lb, Lb, dtype=torch.bool, device=q.device).tril()
    s = (rt(qs) @ rt(ks).transpose(-1, -2)) * qk_scale
    d = (b[..., :, None] - b[..., None, :]) + li[..., None, :]
    sd = torch.where(causal, s * torch.exp(torch.where(causal, d, float("-inf"))), 0.0)
    h_intra = rt(sd) @ rt(vs)
    n_intra = sd.sum(-1)
    qbar = qs * torch.exp(b)[..., None] * qk_scale
    kbar = ks * torch.exp(a)[..., None]
    dC = rt(kbar).transpose(-1, -2) @ rt(vs)  # (B, NH, NS, DHQK, DHHV)
    dn = kbar.sum(-2)

    C = (c_initial.to(acc) if c_initial is not None
         else q.new_zeros((B, NH, DHQK, DHHV), dtype=acc))
    n = n_initial.to(acc) if n_initial is not None else q.new_zeros((B, NH, DHQK), dtype=acc)
    c_prev, n_prev = [], []
    for sb in range(NS):  # the state before each sub-chunk
        c_prev.append(C)
        n_prev.append(n)
        gbar = torch.exp(g[:, :, sb])
        C = gbar[..., None, None] * C + dC[:, :, sb]
        n = gbar[..., None] * n + dn[:, :, sb]
    c_prev, n_prev = torch.stack(c_prev, 2), torch.stack(n_prev, 2)

    h_inter = rt(qbar) @ rt(c_prev)
    n_inter = (qbar * n_prev[..., None, :]).sum(-1)
    den = torch.clamp(torch.abs(n_inter + n_intra), min=1.0)
    h = (h_inter + h_intra) / (den[..., None] + eps)
    h = h.permute(0, 2, 3, 1, 4).reshape(B, NS * Lb, NH * DHHV)[:, :S].to(q.dtype)
    if not save_states:
        return h, None, None, C, n
    n_out = den.reshape(B, NH, NC, L).transpose(1, 2).contiguous()
    cstates = c_prev[:, :, ::NB].transpose(1, 2).contiguous()
    return h, n_out, cstates, C, n


def fw3(q, k, v, i, f, num_heads: int, c_initial=None, n_initial=None, chunk_size: int = 640,
        sub_chunk: int | None = None, qk_scale: float | None = None, eps: float = 1e-6,
        compute_dtype=torch.bfloat16, save_states: bool = True):
    """The sub-chunked chunkwise forward, with ``fw3``'s arguments.

    q, k (B, S, NH*DHQK) and v (B, S, NH*DHHV); i, f (B, S, NH) float32
    pre-activations; optional c_initial (B, NH, DHQK, DHHV) and n_initial
    (B, NH, DHQK) float32.  ``sub_chunk`` None means 128; where it does
    not divide ``chunk_size`` the sub-chunk is the whole chunk.
    JAX's ``head_group`` is not taken: it only groups heads inside one TPU
    grid step and does not change the result.  Returns ``(h, n_out,
    cstates, c_last, n_last)``: h (B, S, NH*DHHV) in q's dtype; with
    ``save_states`` the denominator max(|n . q|, 1) of each row, n_out
    (B, NC, NH, L) (1 on the rows past S), and the state before each chunk,
    cstates (B, NC, NH, DHQK, DHHV), float32 (else both None); the last
    states float32.

    CPU tensors go through :func:`fw3_plain`.  CUDA tensors go through the
    kernels, which take DHQK = DHHV in ``HEAD_DIMS``, q/k/v float32 or
    bfloat16, float32 gates and states, all contiguous and 16-byte
    aligned; anything else raises.  Besides the outputs they use a scratch
    of the state before each sub-chunk, C in ``compute_dtype``, and the
    gate rows, float32.
    """
    kw = dict(chunk_size=chunk_size, sub_chunk=sub_chunk, qk_scale=qk_scale, eps=eps,
              compute_dtype=compute_dtype, save_states=save_states)
    if q.device.type == "cpu":
        return fw3_plain(q, k, v, i, f, num_heads, c_initial, n_initial, **kw)
    B, S, NH, DH, DHHV, tensors = _check(q, k, v, i, f, num_heads, c_initial, n_initial,
                                         compute_dtype)
    if DHHV != DH or DH not in HEAD_DIMS:
        raise ValueError(f"head dims {DH} (q, k) and {DHHV} (v) not supported by the kernel: "
                         f"both must be one of {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q/k/v dtype {q.dtype} not supported by the kernel "
                        "(float32 or bfloat16)")
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    cuda_build.check_kernel_inputs(*tensors)
    L, Lb, NC, NB = geometry(S, chunk_size, sub_chunk)
    NS = NC * NB
    if qk_scale is None:
        qk_scale = DH ** -0.5
    lib = cuda_build.load("chunkwise_fw3", _declare)
    dev = q.device
    empty = lambda *shape: torch.empty(*shape, dtype=torch.float32, device=dev)  # noqa: E731
    gates = empty((3 * walked_rows(Lb) + 1) * B * NH * NS)  # b, logsig(i), e^a; e^g
    # the state before each sub-chunk: C in the compute type, n float32
    c_scr = torch.empty(B, NS, NH, DH, DH, dtype=compute_dtype, device=dev)
    n_scr = empty(B, NS, NH, DH)
    c_last, n_last = empty(B, NH, DH, DH), empty(B, NH, DH)
    h = torch.empty_like(q)
    n_out = cstates = None
    if save_states:
        n_out = empty(B, NC, NH, L)
        alias = NB == 1 and compute_dtype == torch.float32  # c_scr is then cstates
        cstates = c_scr if alias else empty(B, NC, NH, DH, DH)
    dims = (B, S, NH, DH, L, Lb)
    types = (_DTYPE_CODES[q.dtype], _DTYPE_CODES[compute_dtype])
    d = dev.index if dev.index is not None else torch.cuda.current_device()
    cuda_build.launch_on(lib.fw3_gates, "fw3_gates", d, *cuda_build.pointers(i, f, gates),
                         B, S, NH, L, Lb)
    _count(save_states)
    cuda_build.launch_on(
        lib.fw3_states, "fw3_states", d,
        *cuda_build.pointers(k, v, c_initial, n_initial, gates, c_scr, n_scr,
                             None if cstates is None or cstates is c_scr else cstates,
                             c_last, n_last), *dims, *types)
    _count(save_states)
    cuda_build.launch_on(lib.fw3_out, "fw3_out", d,
                         *cuda_build.pointers(q, k, v, gates, c_scr, n_scr, h, n_out),
                         *dims, *types, float(qk_scale), float(eps))
    _count(save_states)
    return h, n_out, cstates, c_last, n_last
