"""String-keyed mLSTM kernel registry and the backend that binds a config to
a callable.

Counterpart of ``xlstm_yolo_tpu/ops/backend.py``, with the same
``"<module>--<backend>"`` names and modes:

    chunkwise--native_autograd           plain chunkwise siging, autograd
                                         through the max(|.|, 1) denominator
    chunkwise--native_stablef            plain chunkwise exp gate, autograd
    chunkwise--pallas_xl_chunk_siging    the v1 kernels (ops/chunkwise.py)
    chunkwise--pallas_xl_chunk_siging_v2 the v2 kernels (ops/chunkwise_v2.py)
    chunkwise--pallas_xl_chunk           the exp kernels (ops/chunkwise_exp.py)
    parallel--native_siging              the quadratic siging oracle
    parallel--native_stablef             the quadratic exp-gate oracle
    parallel--pallas_limit_headdim       the quadratic kernels (ops/parallel.py)
    sequence--native                     the recurrent siging sequence
    sequence--native_stablef             the recurrent exp-gate sequence
    step--native                         one recurrent siging step
    step--native_stablef                 one recurrent exp-gate step
    step--pallas                         the step kernel (ops/step.py)

These are all the names of the JAX package's registry; any other name
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Literal

from xlstm_yolo_tpu_torch.ops import wrappers
from xlstm_yolo_tpu_torch.ops.chunkwise import mlstm_siging_chunkwise_v1
from xlstm_yolo_tpu_torch.ops.chunkwise_exp import mlstm_chunkwise_exp
from xlstm_yolo_tpu_torch.ops.chunkwise_v2 import mlstm_siging_chunkwise_v2_heads
from xlstm_yolo_tpu_torch.ops.mlstm_chunkwise import (
    mlstm_chunkwise_stabilized,
    mlstm_siging_chunkwise,
)
from xlstm_yolo_tpu_torch.ops.mlstm_parallel import (
    mlstm_parallel_stabilized,
    mlstm_siging_parallel,
)
from xlstm_yolo_tpu_torch.ops.mlstm_recurrent import (
    mlstm_recurrent_sequence_stabilized,
    mlstm_siging_recurrent_sequence,
    mlstm_siging_step,
    mlstm_step_stabilized,
)
from xlstm_yolo_tpu_torch.ops.parallel import mlstm_siging_parallel_kernel
from xlstm_yolo_tpu_torch.ops.step import mlstm_siging_step_kernel

__all__ = ["EXP_KERNEL", "PARALLEL_KERNEL", "STEP_KERNEL", "V1_KERNEL", "V2_KERNEL",
           "get_mlstm_kernel", "mLSTMBackendConfig", "make_backend", "register_kernel"]

ModeName = Literal["train", "train_with_padding", "inference"]
V1_KERNEL = "chunkwise--pallas_xl_chunk_siging"
V2_KERNEL = "chunkwise--pallas_xl_chunk_siging_v2"
EXP_KERNEL = "chunkwise--pallas_xl_chunk"
PARALLEL_KERNEL = "parallel--pallas_limit_headdim"
STEP_KERNEL = "step--pallas"

_REGISTRY: dict[str, dict[str, Callable]] = {
    "chunkwise": {}, "sequence": {}, "step": {}, "parallel": {}}


def register_kernel(kind: str, name: str, fn: Callable | None = None):
    """Register ``fn`` as ``"<kind>--<name>"`` (or decorate it)."""
    reg = _REGISTRY[kind]
    if fn is None:
        return lambda f: (reg.__setitem__(name, f), f)[1]
    reg[name] = fn
    return fn


register_kernel("chunkwise", "native_autograd", mlstm_siging_chunkwise)
register_kernel("chunkwise", "native_stablef", mlstm_chunkwise_stabilized)
register_kernel("chunkwise", "pallas_xl_chunk_siging", mlstm_siging_chunkwise_v1)
register_kernel("chunkwise", "pallas_xl_chunk_siging_v2", mlstm_siging_chunkwise_v2_heads)
register_kernel("chunkwise", "pallas_xl_chunk", mlstm_chunkwise_exp)
register_kernel("parallel", "native_siging", mlstm_siging_parallel)
register_kernel("parallel", "native_stablef", mlstm_parallel_stabilized)
register_kernel("parallel", "pallas_limit_headdim", mlstm_siging_parallel_kernel)
register_kernel("sequence", "native", mlstm_siging_recurrent_sequence)
register_kernel("sequence", "native_stablef", mlstm_recurrent_sequence_stabilized)
register_kernel("step", "native", mlstm_siging_step)
register_kernel("step", "native_stablef", mlstm_step_stabilized)
register_kernel("step", "pallas", mlstm_siging_step_kernel)


def get_mlstm_kernel(name: str) -> Callable:
    """The kernel registered as ``"<module>--<backend>"``; raises for any
    other name."""
    kind, _, backend = name.partition("--")
    reg = _REGISTRY.get(kind)
    if reg is None:
        raise ValueError(f"unknown kernel module '{kind}' in '{name}'")
    if backend not in reg:
        raise ValueError(f"{kind} kernel '{backend}' is unknown; available: {sorted(reg)}")
    return reg[backend]


@dataclasses.dataclass(frozen=True)
class mLSTMBackendConfig:
    chunkwise_kernel: str = "chunkwise--native_autograd"
    sequence_kernel: str = "sequence--native"
    step_kernel: str = "step--native"
    mode: ModeName = "train"
    chunk_size: int = 64
    return_last_states: bool = False
    eps: float = 1e-6
    auto_divisor_chunking: bool = True  # pad mode: the largest divisor chunk of S


def make_backend(config: mLSTMBackendConfig) -> Callable:
    """Bind a config to ``fn(q, k, v, i, f, ...)`` on (B, NH, S, DH) streams
    and (B, NH, S) gates.  ``train`` calls the chunkwise kernel as it is,
    ``train_with_padding`` through the pad-zeros wrapper (h only),
    ``inference`` through the arbitrary-length wrapper, which threads
    (C, n) (and an exp-gate kernel's m between its segments) and takes any
    S."""
    cw = get_mlstm_kernel(config.chunkwise_kernel)
    seq = get_mlstm_kernel(config.sequence_kernel)
    step = get_mlstm_kernel(config.step_kernel)

    if config.mode == "train":
        def fn(q, k, v, i, f, **kw):
            return cw(q, k, v, i, f, chunk_size=config.chunk_size, eps=config.eps,
                      return_last_states=config.return_last_states, **kw)
    elif config.mode == "train_with_padding":
        def fn(q, k, v, i, f, **kw):
            return wrappers.wrap_chunkwise_pad_zeros(
                cw, q, k, v, i, f, chunk_size=config.chunk_size,
                auto_divisor=config.auto_divisor_chunking, eps=config.eps, **kw)
    elif config.mode == "inference":
        def fn(q, k, v, i, f, c_initial=None, n_initial=None, return_last_states=None, **kw):
            rls = config.return_last_states if return_last_states is None else return_last_states
            return wrappers.wrap_chunkwise_arbitrary_sequence_length(
                cw, seq, step, q, k, v, i, f, c_initial=c_initial, n_initial=n_initial,
                chunk_size=config.chunk_size, eps=config.eps, return_last_states=rls, **kw)
    else:
        raise ValueError(f"unknown mode {config.mode!r}")
    return fn
