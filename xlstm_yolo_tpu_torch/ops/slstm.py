"""The sLSTM sequence scan: the CUDA kernel, its wrapper and its plain
PyTorch version.

Counterpart of ``xlstm_yolo_tpu/ops/pallas/slstm.py``
(``slstm_sequence_pallas`` :92, ``_kernel`` :42), the fused scan behind
``sLSTMCell``.  Per step, for each head, gate g of (z, i, f, o) and unit e:

    rh_g[e] = sum_d h[d] R[g, head, d, e]
    z = tanh(x_z + rh_z),  i~ = x_i + rh_i,  f~ = x_f + rh_f,  o = sigmoid(x_o + rh_o)
    m' = max(f~ + m, i~),  c' = e^{f~+m-m'} c + e^{i~-m'} z,  n' = e^{f~+m-m'} n + e^{i~-m'}
    h' = o c' / max(n', 1e-6)

:func:`slstm_sequence` launches kernel ``slstm_forward`` (``csrc/slstm.cu``)
for CUDA tensors, or raises; CPU tensors take :func:`slstm_sequence_plain`,
a step loop that mirrors the JAX cell's ``lax.scan``
(``xlstm_yolo_tpu/nn/xlstm.py:107-127``).  Forward only, as the Pallas
kernel is: on the card a call that would need a gradient raises.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from xlstm_yolo_tpu_torch.ops import cuda_build
from xlstm_yolo_tpu_torch.ops.cuda_build import I, P
from xlstm_yolo_tpu_torch.utils.torch_utils import acc_dtype

__all__ = ["LAUNCHES", "MAX_HEAD_DIM", "plan", "slstm_sequence", "slstm_sequence_plain"]

LAUNCHES = 0  # launches of the scan kernel

MAX_HEAD_DIM = 256  # the kernel's largest head dim (a cluster of 16 CTAs of 16 units)


def _declare(lib):
    lib.slstm_forward.argtypes = [P] * 11 + [I] * 4 + [P]
    lib.slstm_forward.restype = I
    lib.slstm_plan.argtypes = [I, I, I, ctypes.POINTER(I)]
    lib.slstm_plan.restype = I


def plan(B: int, NH: int, DH: int) -> dict:
    """The kernel's launch plan for (B, NH, DH) on the current CUDA device
    (``plan_for`` in ``csrc/slstm.cu``): K CTAs a cluster, U units of a
    head a CTA, ND values of d a lane per 32, G batch rows a cluster, NU
    units a warp."""
    out = (I * 5)()
    if cuda_build.load("slstm", _declare).slstm_plan(B, NH, DH, out) != 0:
        raise ValueError(f"no plan for B {B}, NH {NH}, DH {DH}")
    return dict(zip(("K", "U", "ND", "G", "NU"), out))


def _check(wx, R, state):
    if wx.ndim != 5 or wx.shape[2] != 4:
        raise ValueError(f"wx must be (B, S, 4, NH, DH), got {tuple(wx.shape)}")
    B, S, _, NH, DH = wx.shape
    if tuple(R.shape) != (4, NH, DH, DH):
        raise ValueError(f"R must be (4, {NH}, {DH}, {DH}), got {tuple(R.shape)}")
    if state is not None:
        if len(state) != 4 or any(tuple(s.shape) != (B, NH, DH) for s in state):
            raise ValueError(f"state must be four (B, NH, DH) = ({B}, {NH}, {DH}) tensors")
    return B, S, NH, DH


def slstm_sequence_plain(wx, R, state=None):
    """Plain PyTorch version of the kernel: same interface, any device, and
    float64 inputs too (then the scan runs in float64), for a reference."""
    B, S, NH, DH = _check(wx, R, state)
    dt = acc_dtype(wx.dtype)
    x, Rd = wx.to(dt), R.to(dt)
    if state is None:
        zeros = torch.zeros(B, NH, DH, dtype=dt, device=wx.device)
        state = (zeros, zeros, zeros, zeros)
    h, c, n, m = (s.to(dt) for s in state)
    hs = []
    for t in range(S):
        xt = x[:, t]  # (B, 4, NH, DH)
        rh = torch.einsum("bhd,ghde->gbhe", h, Rd)
        z = torch.tanh(xt[:, 0] + rh[0])
        it = xt[:, 1] + rh[1]
        ft = xt[:, 2] + rh[2]
        o = torch.sigmoid(xt[:, 3] + rh[3])
        m_new = torch.maximum(ft + m, it)
        ig = torch.exp(it - m_new)
        fg = torch.exp(ft + m - m_new)
        c = fg * c + ig * z
        n = fg * n + ig
        h = o * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    out = torch.stack(hs, 1) if hs else x.new_zeros(B, 0, NH, DH)
    return out.reshape(B, S, NH * DH).to(wx.dtype), (h, c, n, m)


def slstm_sequence(wx, R, state=None):
    """sLSTM scan over a sequence.

    wx: (B, S, 4, NH, DH) gate pre-activations (the Wx + b part) in gate
    order z, i, f, o; R: (4, NH, DH, DH) recurrent weights; ``state`` an
    optional (h, c, n, m), each (B, NH, DH), zeros by default.  Returns hs
    (B, S, NH*DH) in wx's dtype and the last (h, c, n, m) in float32.

    CUDA tensors go through the hand-written kernel, in float32 (one
    thread-block cluster per head and group of batch rows, :func:`plan`),
    or this raises: also where autograd would need a gradient of the call,
    since the kernel has no backward; CPU tensors go through the plain
    version.
    """
    global LAUNCHES
    if wx.device.type == "cpu":
        return slstm_sequence_plain(wx, R, state)
    B, S, NH, DH = _check(wx, R, state)
    if wx.device.type != "cuda":
        raise ValueError(f"unsupported device {wx.device}")
    tensors = [wx, R] + list(state or ())
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError("the sLSTM kernel is forward-only and has no gradient: on the GPU "
                         "run the sLSTM cell under torch.no_grad() or torch.inference_mode()")
    if not 1 <= DH <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {DH} not supported by the kernel (1 to {MAX_HEAD_DIM})")
    f32 = torch.float32
    wxf, Rf = wx.to(f32).contiguous(), R.to(f32).contiguous()
    st = [None] * 4 if state is None else [s.to(f32).contiguous() for s in state]
    cuda_build.check_kernel_inputs(wxf, Rf, *st)
    hs = torch.empty(B, S, NH * DH, dtype=f32, device=wx.device)
    last = [torch.empty(B, NH, DH, dtype=f32, device=wx.device) for _ in range(4)]
    lib = cuda_build.load("slstm", _declare)
    cuda_build.launch_on(lib.slstm_forward, "slstm_forward", wxf.get_device(),
                         *cuda_build.pointers(wxf, Rf, *st, hs, *last), B, S, NH, DH)
    LAUNCHES += 1
    return hs.to(wx.dtype), tuple(last)
