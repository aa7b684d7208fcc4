"""Smoke run of the PyTorch port (xlstm_yolo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. setup     - print the card's name and power limit; build the eleven CUDA
               sources of csrc/ with nvcc (sm_90a), one nvcc each, all
               started together, and print the build time and what ptxas
               reports;
2. kernel    - the chunkwise mLSTM inference kernel against its plain PyTorch
               version on the card at the flagship shapes (B 8, NH 12, DH 32,
               S 6400/1600/400/100 and a ragged 1000), float32 and bfloat16,
               with and without initial states, and with closed forget gates;
3. model     - vil-det-192 at 640 px, batch 8, and vil-det-tiny at 160 px,
               with random weights from a seed and perturbed ifgates (so no
               cell is inert), float32: one forward makes exactly 20 (tiny:
               14) kernel launches; each of those calls agrees with the plain
               version on the same inputs; and the decode-only output with
               the kernel is as close to a float64 forward of the same model
               as the output with the plain version is (see phase_model);
4. predict   - the predict path: YOLO("vil-det-192.yaml").predict() on
               synthetic images of several sizes in two batches (bf16);
               results are finite and in original image coordinates; 40
               launches of the inference kernel;
5. train_kernels - the four training kernels (train forward, backward,
               epilogue backward, FFN backward) against their plain versions
               at the flagship shapes (B 8, NH 12, DH 32, H 384, D 192,
               U 512; S 6400/1600/400/100 and a ragged 1000), float32 and
               bfloat16, with closed forget gates, initial states and dC_last,
               and |mean| >> std rows for the LayerNorm and the RMSNorm;
6. replay    - one float32 train step of vil-det-192 (640 px, batch 8,
               perturbed ifgates) records the inputs and upstream gradients
               of every cell, epilogue and FFN call; each call is replayed
               through its kernel and its plain version, and each output of
               the kernel is at most E2E_FACTOR times as far from the plain
               version in float64 as the float32 plain version is, or
               within GRAD_REL of it (compare_outputs);
7. e2e_grads - vil-det-tiny: the float32 gradients of a train step with the
               kernels, and with the plain versions, against a float64 step
               with the plain versions; the kernel path may be at most
               E2E_FACTOR times as far from float64 as the plain path;
8. train     - the training path: detect_trainer("vil-det-192.yaml") at
               640 px, batch 8, bf16 compute, float32 parameters, AdEMAMix
               with warmup, clipping at 10 and EMA, 3 steps on synthetic uint8
               images with 8 padded gts per image (some masked): the loss
               and its items are finite, parameters and EMA move, and each
               step launches each kernel exactly the derived number of times
               (phase_train);
9. v1_kernels - the v1 route's three kernels (forward, dC scan, dq/dk/dv)
               against their plain versions at the flagship shapes (B 8,
               NH 12, DH 32) and every (S, L) the route gives them (the
               inference segments with initial states and dC_last, the
               training lengths padded to whole chunks, and a case with
               closed forget gates): float32 streams and products to 1e-4,
               the route's bfloat16 streams and products to 2e-2;
10. v1_predict - YOLO("vil-det-192.yaml", chunkwise_kernel=V1).predict() on
               the images of phase 4: v1 forward launches exactly as derived
               from the wrappers' segment plan (v1_plan), no v2 launch;
11. v1_train - detect_trainer(..., chunkwise_kernel=V1): 3 bf16 steps, the
               loss finite, parameters and EMA moved, and per step exactly
               the derived v1 forward, dC-scan and dq/dk/dv launches (and the
               epilogue and FFN backwards, no v2 cell kernel);
12. exp_kernels - the exp route's three kernels (forward with the m
               stabilizer, dC scan, dq/dk/dv) against their plain versions at
               the flagship shapes and every (S, L) the route gives them (the
               inference segments with initial (C, n, m) and dC_last, the
               training lengths padded to whole chunks), and two more gate
               regimes, closed forget gates and large input gates (i in
               [5, 15]: m far from 0): float32 products to 1e-4, the route's
               bfloat16 to 2e-2 (phase_exp_kernels);
13. exp_predict - YOLO("vil-det-192.yaml", chunkwise_kernel=EXP).predict()
               on the images of phase 4: exact exp forward launches, no v1
               or v2 cell launch;
14. exp_train - detect_trainer(..., chunkwise_kernel=EXP): 3 bf16 steps,
               exact exp forward, dC-scan and dq/dk/dv launches per step;
15. exp_grads - vil-det-tiny on the exp route, float32 products: every exp
               kernel call of a float32 train step replayed through its
               kernel and its plain version (GRAD_REL); and the float32
               gradients of that step with the kernels, and with their plain
               versions, against a float64 step on the plain versions (as
               e2e_grads, at EXP_E2E_FACTOR);
16. parallel_kernels - the quadratic route's three kernels (forward, dq,
               dk/dv) against their plain versions (run over slices of batch *
               head) at the flagship shapes and every S the route pads the
               flagship's sequences to (6656, 2048, 512, 128), float32 and
               bfloat16 (products likewise), open and closed forget gates
               (phase_parallel_kernels);
17. parallel_train - detect_trainer(..., chunkwise_kernel=PAR): 3 bf16
               steps, exact forward, dq and dk/dv launches per step, no v1,
               v2 or exp cell launch;
18. parallel_grads - vil-det-tiny on the quadratic route, float32 products:
               every quadratic kernel call of a float32 train step replayed
               through its kernel and its plain version, and the gradients
               against float64 (as exp_grads);
19. step_kernel - the one-token step kernel against mlstm_siging_step at
               B 8, NH 12, DH 32, float32 and bfloat16 q/k/v, open and closed
               forget gates;
20. decode   - MatrixLSTMCell(384, 12, step_kernel="step--pallas") decodes 64
               tokens one at a time with state=, exactly one step launch
               each, against one stateful call over the 64 tokens; us per
               token and the step kernel's time per call;
21. refusal  - YOLO(..., chunkwise_kernel=PAR).predict raises the port's
               ValueError (the route has no predict path, as in JAX);
22. times    - CUDA-event medians (and every window) of each kernel and its
               plain version at each S (v1, exp: each (S, L); quadratic: each
               padded S); the end-to-end
               predict rate on every route (windows after a warm-up, SM clock
               and power sampled); torch.profiler traces of three forwards;
               the v1 and v2 backward designs on the same work (L = 64); the
               exp route's predict forward and the share of its recurrent
               tails; the v2-, v1-, exp- and quadratic-route train steps in
               turns (v2, v1, exp, parallel, parallel, exp, v1, v2), each
               with the device's busy share from a trace of one step.

Each phase prints its seconds on a line of its own.  Output: JSON lines per
phase, the nvidia-smi line, one {"kernels": [...]} line (fifteen kernels),
and last {"ok": true, "device": {...}}.  Without a CUDA device, or without
the package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOP_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
B, NH, DH = 8, 12, 32
H = NH * DH
D, U = 192, 512  # vil-det-192's embedding and FFN widths
L = 64           # the kernels' chunk length
SEQ_LENS = (6400, 1600, 400, 100)
LAUNCHES_PER_S = {6400: 4, 1600: 6, 400: 6, 100: 4}  # per vil-det-192 forward
EPS = 5e-5  # the model's cell eps
F32_TOL = 1e-4   # kernel vs plain, float32: sums in another order
BF16_TOL = 2e-2  # bfloat16 in, same rounded inputs on both sides; h rounded once
# backward kernels vs plain: atol = REL * the largest |value| of each output,
# rtol = REL (float32: sums over up to B*S rows in another order; bfloat16:
# the plain version rounds intermediate products to bfloat16, the kernels
# keep them in float32 and round each output once)
GRAD_REL = {"float32": 1e-4, "bfloat16": 2e-2}
# float32 model forwards against a float64 one (phase_model): the kernel
# forward may be at most E2E_FACTOR times as far from it as the plain one
E2E_FACTOR = 2.0
E2E_ATOL = {"boxes": 1e-3, "scores": 1e-5}
# phase_exp_grads: the float32 gradients of the random tiny model on the exp
# route hold float32 rounding amplified through its depth (at some ifgate
# perturbations both paths are ~1e-2 from float64 and their ratio is noise);
# the replay of every exp kernel call of the step is the tight check, this
# factor catches a wiring fault, which moves a leaf by O(1)
EXP_E2E_FACTOR = 3.0
EXP_GRADS_SEED = 7
E2E_GRAD_ATOL = 1e-5  # relative to each leaf's largest float64 |g|
TRAIN_OPT = dict(name="AdEMAMix", lr=0.01, momentum=0.937, weight_decay=5e-4,
                 warmup_steps=100, iterations=10000, clip_norm=10.0)
TRAIN_STEPS = 3
M_GTS = 8
KERNELS = ("chunkwise_fw_train", "chunkwise_bw", "epilogue_bw", "ffn_bw")


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_cuda(fn, iters: int, reps: int = 5, warm_s: float = 0.5) -> list[float]:
    """Mean ms per call over ``iters`` calls, for each of ``reps`` windows
    (CUDA events), after warming up for at least ``warm_s`` seconds and 3
    calls."""
    import torch

    t0, n = time.perf_counter(), 0
    while n < 3 or time.perf_counter() - t0 < warm_s:
        fn()
        torch.cuda.synchronize()
        n += 1
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out


class ClockSampler:
    """Samples the card's SM clock, power draw and temperature with
    ``nvidia-smi -lms`` while the ``with`` block runs; stops it on exit."""

    QUERY = "clocks.sm,clocks.mem,power.draw,temperature.gpu"

    def __enter__(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.QUERY}", "--format=csv,noheader,nounits",
                 "-i", "0", "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                text=True)
        except OSError:
            self.proc = None
        return self

    def __exit__(self, *exc):
        self.summary, self.summary_n = "not measured", 0
        if self.proc is None:
            return False
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(x) for x in line.split(",")])
            except ValueError:
                continue
        self.summary = {
            name: {"min": min(col), "median": statistics.median(col), "max": max(col)}
            for name, col in zip(self.QUERY.split(","), zip(*rows))
        } if rows else "not measured"
        self.summary_n = len(rows)
        return False


def device_busy(prof, window_ms: float) -> dict:
    """Device time of the profiled window from its trace: the kernel,
    memcpy and memset events only (not the GPU annotation rows named after
    aten ops, which repeat the time of the kernels they cover).  The busy
    share is the union of those intervals over ``window_ms``, the window's
    own span between two CUDA events."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "?"))
             for e in events if e.get("ph") == "X"
             and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not spans:
        return {"kernel_ms_total": "not measured", "busy_share": "not measured"}
    busy, end = 0.0, float("-inf")
    for t0, t1, _ in sorted(spans):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    by_name: dict[str, list] = {}
    for t0, t1, name in spans:
        row = by_name.setdefault(name, [0.0, 0])
        row[0] += t1 - t0
        row[1] += 1
    total_us = sum(r[0] for r in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"kernel_ms_total": total_us / 1e3, "busy_ms": busy / 1e3, "window_ms": window_ms,
            "busy_share": busy / 1e3 / window_ms, "device_events": len(spans),
            "top": [{"kernel": name[:90], "device_ms": us / 1e3, "calls": c,
                     "share": us / total_us} for name, (us, c) in top[:15]]}


def kernel_inputs(S, dtype, gates="open", states=False, seed=0):
    import torch

    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, S, H, generator=g) for _ in range(3))
    i = torch.rand(B, S, NH, generator=g) * 10 - 6  # U(-6, 4): far from inert
    if gates == "open":
        f = torch.rand(B, S, NH, generator=g) * 10 - 2  # U(-2, 8)
    else:
        f = torch.rand(B, S, NH, generator=g) * 40 - 60  # U(-60, -20): closed
    c0 = torch.randn(B, NH, DH, DH, generator=g) if states else None
    n0 = torch.randn(B, NH, DH, generator=g) if states else None
    cu = lambda t, d=torch.float32: None if t is None else t.to("cuda", d)
    return (cu(q, dtype), cu(k, dtype), cu(v, dtype), cu(i), cu(f), NH, cu(c0), cu(n0))


def row_inputs(S, dtype, offset=0.0, seed=0):
    """Flagship-width inputs of the epilogue (h, x, g, ln_w, ln_b, skip, wd)
    and of the FFN backward (x, gz, g, wn, wgz, wd), bd/bgz for gz."""
    import torch

    from xlstm_yolo_tpu_torch.ops import ffn

    gen = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0, mean=0.0: torch.randn(*s, generator=gen) * scale + mean  # noqa: E731
    cu = lambda t, d=torch.float32: t.to("cuda", d)  # noqa: E731
    epi = (cu(r(B, S, H, mean=offset), dtype), cu(r(B, S, H), dtype), cu(r(B, S, D), dtype),
           cu(r(H, scale=0.1)), cu(r(H, scale=0.1)), cu(r(H, scale=0.1, mean=1.0)),
           cu(r(D, H, scale=H ** -0.5)), NH)
    x, wn = cu(r(B, S, D, mean=offset), dtype), cu(r(D, scale=0.1, mean=1.0))
    wgz, wd = cu(r(2 * U, D, scale=D ** -0.5)), cu(r(D, U, scale=U ** -0.5))
    _, gz = ffn.ffn_forward(x, wn, wgz, cu(r(2 * U, scale=0.1)), wd, cu(r(D, scale=0.1)))
    return epi, (x, gz, cu(r(B, S, D), dtype), wn, wgz, wd)


def bound(S: int, itemsize: int = 2) -> tuple[float, str]:
    """Least time for one inference-forward call in ms, and what sets it: q,
    k, v read and h written once, the gates read once, the last states
    written once, over HBM bandwidth; against 4*B*NH*S*DH*(L+DH) chunkwise
    FLOP at the bf16 peak."""
    nbytes = 4 * B * S * H * itemsize + 2 * B * S * NH * 4 + B * NH * (DH * DH + DH) * 4
    flops = 4 * B * NH * S * DH * (L + DH)
    return _bound(nbytes, flops)


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def train_bound(name: str, S: int, itemsize: int = 2) -> tuple[float, str]:
    """Least time for one call of a training kernel at batch B in ms, each
    input read once and each output written once, against its products at
    the bf16 peak (see PERF.md for the derivation)."""
    NC = -(-S // L)
    M = B * S
    states = B * NC * NH * (DH * DH + DH) * 4 + B * NC * NH * L * 4  # C, n per chunk; den
    gates = 2 * B * S * NH * 4
    if name == "chunkwise_fw_train":
        nbytes = 4 * B * S * H * itemsize + gates + states + B * NH * (DH * DH + DH) * 4
        flops = 4 * B * NH * S * DH * (L + DH)
    elif name == "chunkwise_bw":  # q, k, v, dh in; dq, dk, dv out; C per chunk, den in
        nbytes = 7 * B * S * H * itemsize + gates + B * NC * NH * (DH * DH + L) * 4 \
            + B * NH * DH * DH * 4
        flops = 2 * B * NH * S * (5 * L * DH + 4 * DH * DH)
    elif name == "epilogue_bw":  # h, x, g in; dh, dx out; g Wd and g^T z
        nbytes = 4 * M * H * itemsize + M * D * itemsize + 2 * (D * H + 3 * H + D) * 4
        flops = 4 * M * D * H
    else:  # ffn_bw: x, gz, g in; dx out; four products of M rows at D x U or D x 2U
        nbytes = M * (3 * D + 2 * U) * itemsize + 2 * (3 * D * U + D + 2 * U + D) * 4
        flops = 12 * M * D * U
    return _bound(nbytes, flops)


def perturb_ifgates(model, seed: int):
    """ifgate kernel ~ N(0, 0.01), input-gate bias ~ U(-3, 1)."""
    import torch

    from xlstm_yolo_tpu_torch.nn.layers import MatrixLSTMCell

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MatrixLSTMCell):
                w, b = m.ifgate.weight, m.ifgate.bias
                w.copy_(torch.randn(w.shape, generator=g) * 0.01)
                b[: m.num_heads] = torch.rand(m.num_heads, generator=g) * 4 - 3


def set_cell_kernel(model, fn):
    from xlstm_yolo_tpu_torch.nn.layers import MatrixLSTMCell

    for m in model.modules():
        if isinstance(m, MatrixLSTMCell):
            m.kernel = fn


def use_plain_training_ops(model):
    """Route the model's training cell, epilogue and FFN through their plain
    versions (autograd of the plain forwards), on any device and dtype."""
    from xlstm_yolo_tpu_torch.nn.layers import MatrixLSTMCell, ViLLayer
    from xlstm_yolo_tpu_torch.ops import chunkwise_v2, epilogue, ffn

    for m in model.modules():
        if isinstance(m, MatrixLSTMCell):
            m.train_kernel = chunkwise_v2.mlstm_siging_chunkwise_train_plain
        if isinstance(m, ViLLayer):
            m.epilogue_fn = epilogue.epilogue_forward
            m.ffn_fn = lambda *a: ffn.ffn_forward(*a)[0]


def phase_kernel(cw):
    import torch

    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = [(S, "open", False) for S in SEQ_LENS] + [
        (1000, "open", True), (1600, "closed", False)]
    for dtype in (torch.float32, torch.bfloat16):
        for S, gates, states in cases:
            args = kernel_inputs(S, dtype, gates, states, seed=S)
            h, (c, n) = cw.mlstm_siging_chunkwise_fw(*args, eps=EPS, return_last_states=True)
            torch.cuda.synchronize()
            hp, (cp, np_) = cw.mlstm_siging_chunkwise_fw_plain(
                *args, eps=EPS, return_last_states=True)
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL
            err = (h.float() - hp.float()).abs().max().item()
            err_state = max((c - cp).abs().max().item(), (n - np_).abs().max().item())
            finite = bool(torch.isfinite(h.float()).all())
            emit({"phase": "kernel", "S": S, "dtype": str(dtype).split(".")[-1],
                  "gates": gates, "initial_states": states, "max_abs_err_h": err,
                  "max_abs_err_states": err_state, "tol": tol, "finite": finite})
            torch.testing.assert_close(h.float(), hp.float(), atol=tol, rtol=tol)
            torch.testing.assert_close(c, cp, atol=F32_TOL, rtol=F32_TOL)
            torch.testing.assert_close(n, np_, atol=F32_TOL, rtol=F32_TOL)
            if not finite:
                raise AssertionError(f"non-finite kernel output at S={S} {gates}")
            key = str(dtype).split(".")[-1]
            worst[key] = max(worst[key], err)
    return worst


def record_cell_calls(model, cw, calls: list):
    """Route every mLSTM cell of ``model`` through the kernel wrapper and
    keep a copy of the inputs of each call."""
    def recording_kernel(q, k, v, i, f, num_heads, **kw):
        calls.append(((q.clone(), k.clone(), v.clone(), i.clone(), f.clone(), num_heads), kw))
        return cw.mlstm_siging_chunkwise_fw(q, k, v, i, f, num_heads, **kw)
    set_cell_kernel(model, recording_kernel)


def phase_model(cw, cfg: str, batch: int, size: int, launches_expected: int):
    """float32 forward of a perturbed model (decode-only output).

    1. Every cell call of the forward: the kernel against the plain version
       on the very inputs the model gave it (F32_TOL).
    2. End to end: this random network amplifies float32 rounding through
       its depth (the max |error| of a float32 forward reaches tens of px
       in decoded boxes of magnitude ~1e3), so the kernel forward and the
       plain-version forward are both held against a float64 forward of the
       same model, and the kernel forward must be no further from it than
       E2E_FACTOR times the plain forward's distance (+ a small atol).
    """
    import torch

    from xlstm_yolo_tpu_torch.nn.tasks import build_detection_model

    x = torch.rand(batch, size, size, 3, generator=torch.Generator().manual_seed(1)).cuda()
    model, _ = build_detection_model(cfg, decode_only=True, device="cuda",
                                     generator=torch.Generator().manual_seed(0))
    perturb_ifgates(model, seed=2)
    calls = []
    record_cell_calls(model, cw, calls)
    with torch.inference_mode():
        before = cw.LAUNCHES
        y_kernel = model(x)[0]
        torch.cuda.synchronize()
        launches = cw.LAUNCHES - before
        if launches != launches_expected:
            raise AssertionError(f"one {cfg} forward made {launches} kernel launches, "
                                 f"not {launches_expected}")
        per_call = []
        for args, kw in calls:
            h = cw.mlstm_siging_chunkwise_fw(*args, **kw)
            h_plain = cw.mlstm_siging_chunkwise_fw_plain(*args, **kw)
            per_call.append({"S": args[0].shape[1], "max_abs_err": (h - h_plain).abs().max().item(),
                             "max_abs_h": h_plain.abs().max().item()})
            torch.testing.assert_close(h, h_plain, atol=F32_TOL, rtol=F32_TOL)
        del calls
        set_cell_kernel(model, cw.mlstm_siging_chunkwise_fw_plain)
        y_plain = model(x)[0]
        model64 = copy.deepcopy(model).double()
        y64 = model64(x.double())[0]
    report = {"phase": "model", "cfg": cfg, "batch": batch, "imgsz": size, "dtype": "float32",
              "launches_per_forward": launches, "decode_shape": list(y_kernel.shape),
              "cell_calls": per_call, "cell_tol": F32_TOL, "e2e_factor": E2E_FACTOR,
              "e2e_atol": E2E_ATOL}
    ok = True
    for part, sl in (("boxes", slice(0, 4)), ("scores", slice(4, None))):
        ref = y64[..., sl]
        err_k = (y_kernel[..., sl].double() - ref).abs().max().item()
        err_p = (y_plain[..., sl].double() - ref).abs().max().item()
        report[part] = {"kernel_vs_f64": err_k, "plain_vs_f64": err_p,
                        "kernel_vs_plain": (y_kernel[..., sl] - y_plain[..., sl]).abs().max().item(),
                        "max_abs_f64": ref.abs().max().item()}
        ok &= err_k <= E2E_FACTOR * err_p + E2E_ATOL[part]
    ok &= bool(torch.isfinite(y_kernel).all())
    emit(report)
    if not ok:
        raise AssertionError(f"{cfg}: the kernel forward is further from float64 than allowed")


def synthetic_images(n: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    shapes = [(480, 640), (720, 1280), (640, 640), (375, 500), (1080, 1920)]
    return [rng.integers(0, 256, (*shapes[j % len(shapes)], 3), dtype=np.uint8)
            for j in range(n)]


def phase_predict(cw, yolo):
    import numpy as np

    images = synthetic_images(10, seed=5)  # batches of 8 and 2 (tail padded)
    cw.LAUNCHES = 0
    results = yolo.predict(images, batch=B, conf=0.0)
    launches = cw.LAUNCHES
    if len(results) != len(images):
        raise AssertionError(f"{len(results)} results for {len(images)} images")
    n_boxes = []
    for im, r in zip(images, results):
        h, w = im.shape[:2]
        d = r.boxes.data
        if r.orig_img.shape != im.shape or not np.isfinite(d).all():
            raise AssertionError("non-finite result or wrong original shape")
        if not ((d[:, [0, 2]] >= 0).all() and (d[:, [0, 2]] <= w).all()
                and (d[:, [1, 3]] >= 0).all() and (d[:, [1, 3]] <= h).all()):
            raise AssertionError(f"boxes outside the original {w}x{h} image")
        n_boxes.append(len(r))
    emit({"phase": "predict", "cfg": "vil-det-192", "dtype": "bfloat16", "images": len(images),
          "shapes": sorted({tuple(im.shape[:2]) for im in images}), "batch": B,
          "boxes_per_image": n_boxes, "launches": launches})
    if launches != 2 * 20:
        raise AssertionError(f"predict made {launches} kernel launches, expected 40")
    return launches


def compare_outputs(what: str, got, ref, rel: float, ref64=None) -> tuple[float, float]:
    """Each output within atol = rel * its largest |ref|, rtol = rel.

    With ``ref64`` (the plain version on the same inputs in float64), an
    output may instead be at most E2E_FACTOR times as far from float64 as
    the plain version (``ref``) is, + rel * its largest |ref64|: a
    parameter gradient that cancels to ~0 (a bias ahead of a BatchNorm,
    whose batch sum of the upstream gradient is 0) holds only rounding, so
    no bound relative to its own size can hold.  Returns the largest
    absolute error against ``ref`` and the largest error relative to the
    output's largest |ref|."""
    import torch

    worst_abs = worst_rel = 0.0
    for j, (a, b) in enumerate(zip(got, ref)):
        if b is None:
            continue
        a, b = a.float(), b.float()
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what}: output {j} of the kernel is not finite")
        scale = max(b.abs().max().item(), 1e-30)
        err = (a - b).abs().max().item()
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, err / scale)
        if ref64 is not None:
            r = ref64[j]
            err_k = (a.double() - r).abs().max().item()
            err_p = (b.double() - r).abs().max().item()
            if err_k > E2E_FACTOR * err_p + rel * r.abs().max().item():
                raise AssertionError(f"{what}: output {j} is {err_k:.3g} from float64, the "
                                     f"plain version {err_p:.3g}")
            continue
        torch.testing.assert_close(a, b, atol=rel * scale, rtol=rel, msg=lambda m: f"{what}: {m}")
    return worst_abs, worst_rel


def to64(args):
    """The floating tensors of ``args`` in float64 (the rest as they are)."""
    import torch

    return tuple(a.double() if isinstance(a, torch.Tensor) and a.is_floating_point() else a
                 for a in args)


def phase_train_kernels(cw, epi, ffn):
    """The four training kernels against their plain versions at the
    flagship shapes, float32 and bfloat16."""
    import torch

    worst = {k: {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]} for k in KERNELS}

    def note(name, key, errs):
        worst[name][key] = [max(a, b) for a, b in zip(worst[name][key], errs)]

    cases = [(S, "open", False) for S in SEQ_LENS] + [
        (1000, "open", True), (1600, "closed", False)]
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[-1]
        rel = GRAD_REL[key]
        for S, gates, states in cases:
            args = kernel_inputs(S, dtype, gates, states, seed=S + 1)
            got = cw.mlstm_siging_chunkwise_fw_train(*args, eps=EPS)
            torch.cuda.synchronize()
            ref = cw.mlstm_siging_chunkwise_fw_train_plain(*args, eps=EPS)
            e_fw = compare_outputs(f"fw_train S={S} {key}", [got[0], *got[1], *got[2]],
                                   [ref[0], *ref[1], *ref[2]], rel)
            note("chunkwise_fw_train", key, e_fw)
            g = torch.Generator().manual_seed(S + 2)
            dh = torch.randn(B, S, H, generator=g).to("cuda", dtype)
            dcl = torch.randn(B, NH, DH, DH, generator=g).cuda() if states else None
            _, _, (cs, _, den) = got
            bw_args = (*args[:6], cs, den, dh, dcl)
            gb = cw.mlstm_siging_chunkwise_bw(*bw_args, eps=EPS)
            torch.cuda.synchronize()
            rb = cw.mlstm_siging_chunkwise_bw_plain(*bw_args, eps=EPS)
            e_bw = compare_outputs(f"bw S={S} {key}", gb, rb, rel)
            note("chunkwise_bw", key, e_bw)
            emit({"phase": "train_kernels", "S": S, "dtype": key, "gates": gates,
                  "initial_states": states, "dc_last": states, "rel_tol": rel,
                  "fw_train_max_abs_err": e_fw[0], "fw_train_max_rel_err": e_fw[1],
                  "bw_max_abs_err": e_bw[0], "bw_max_rel_err": e_bw[1]})
            del args, got, ref, gb, rb, bw_args
        for S, offset in [(S, 0.0) for S in SEQ_LENS] + [(1000, 0.0), (1600, 30.0)]:
            e_args, f_args = row_inputs(S, dtype, offset, seed=S + 3)
            ge = epi.epilogue_bwd(*e_args)
            gf = ffn.ffn_bwd(*f_args)
            torch.cuda.synchronize()
            e_epi = compare_outputs(f"epilogue S={S} {key}", ge, epi.epilogue_bwd_plain(*e_args),
                                    rel)
            e_ffn = compare_outputs(f"ffn S={S} {key}", gf, ffn.ffn_bwd_plain(*f_args), rel)
            note("epilogue_bw", key, e_epi)
            note("ffn_bw", key, e_ffn)
            emit({"phase": "train_kernels", "S": S, "dtype": key, "mean_offset": offset,
                  "rel_tol": rel, "epilogue_max_abs_err": e_epi[0],
                  "epilogue_max_rel_err": e_epi[1], "ffn_max_abs_err": e_ffn[0],
                  "ffn_max_rel_err": e_ffn[1]})
    return worst


def train_batch(batch: int, size: int, seed: int, device="cuda"):
    """Synthetic uint8 images and M_GTS padded gts per image (about a
    quarter masked), from a seed."""
    import torch

    g = torch.Generator().manual_seed(seed)
    img = torch.randint(0, 256, (batch, size, size, 3), generator=g, dtype=torch.uint8)
    xy = torch.rand(batch, M_GTS, 2, generator=g) * size * 0.7
    wh = torch.rand(batch, M_GTS, 2, generator=g) * size * 0.3 + 8
    boxes = torch.cat([xy, (xy + wh).clamp(max=size)], -1)
    cls = torch.randint(0, 80, (batch, M_GTS), generator=g, dtype=torch.int32)
    mask = torch.rand(batch, M_GTS, generator=g) > 0.25
    mask[:, 0] = True
    return {k: v.to(device) for k, v in dict(img=img, cls=cls, bboxes=boxes, mask=mask).items()}


def phase_replay(cw, epi, ffn, steps):
    """Record every training-kernel call of one float32 flagship train step
    and replay each through its kernel and its plain version (F32)."""
    import torch

    from xlstm_yolo_tpu_torch.nn.tasks import build_detection_model

    model, _ = build_detection_model("vil-det-192.yaml", device="cuda", training=True,
                                     generator=torch.Generator().manual_seed(0))
    perturb_ifgates(model, seed=3)
    calls = {k: [] for k in KERNELS}
    wrapped = {"chunkwise_fw_train": (cw, "mlstm_siging_chunkwise_fw_train"),
               "chunkwise_bw": (cw, "mlstm_siging_chunkwise_bw"),
               "epilogue_bw": (epi, "epilogue_bwd"), "ffn_bw": (ffn, "ffn_bwd")}
    originals = {k: getattr(mod, attr) for k, (mod, attr) in wrapped.items()}

    def recorder(name):
        fn = originals[name]

        def call(*args, **kw):
            calls[name].append((args, kw))
            return fn(*args, **kw)
        return call

    try:
        for k, (mod, attr) in wrapped.items():
            setattr(mod, attr, recorder(k))
        loss, _ = steps.detect_loss(model, train_batch(B, 640, seed=4))
        torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
    finally:
        for k, (mod, attr) in wrapped.items():
            setattr(mod, attr, originals[k])
    plains = {"chunkwise_fw_train": cw.mlstm_siging_chunkwise_fw_train_plain,
              "chunkwise_bw": cw.mlstm_siging_chunkwise_bw_plain,
              "epilogue_bw": epi.epilogue_bwd_plain, "ffn_bw": ffn.ffn_bwd_plain}
    report = {"phase": "replay", "cfg": "vil-det-192", "batch": B, "imgsz": 640,
              "dtype": "float32", "loss": loss.item(), "rel_tol": GRAD_REL["float32"]}
    for name in KERNELS:
        errs = []
        for args, kw in calls[name]:
            got, ref = originals[name](*args, **kw), plains[name](*args, **kw)
            ref64 = plains[name](*to64(args), **kw)
            if name == "chunkwise_fw_train":
                got, ref, ref64 = ([x[0], *x[1], *x[2]] for x in (got, ref, ref64))
            errs.append(compare_outputs(f"replay {name} S={args[0].shape[1]}", got, ref,
                                        GRAD_REL["float32"], ref64))
            del got, ref, ref64
        report[name] = {"calls": len(calls[name]),
                        "max_abs_err": max(e[0] for e in errs),
                        "max_rel_err": max(e[1] for e in errs)}
    emit(report)
    expected = expected_step_launches(model)
    for name in KERNELS:
        if report[name]["calls"] != expected[name]:
            raise AssertionError(f"replay: {report[name]['calls']} {name} calls in one step, "
                                 f"expected {expected[name]}")


def grads_of_step(model, batch, steps):
    import torch

    params = list(model.parameters())
    loss, _ = steps.detect_loss(model, batch)
    return loss.item(), [g.detach() for g in torch.autograd.grad(loss, params)]


def phase_e2e_grads(steps):
    """vil-det-tiny, perturbed ifgates: float32 gradients with the kernels
    and with the plain versions, each against a float64 step with the plain
    versions.  Per leaf, the error is max |g - g64| over the leaf's largest
    |g64|, floored at 1e-3 of the largest |g64| of all leaves (the biases
    ahead of a BatchNorm have a true gradient of 0 and hold only
    rounding)."""
    import torch

    from xlstm_yolo_tpu_torch.nn.tasks import build_detection_model

    model, _ = build_detection_model("vil-det-tiny.yaml", device="cuda", training=True,
                                     generator=torch.Generator().manual_seed(0))
    perturb_ifgates(model, seed=5)
    batch = train_batch(2, 160, seed=6)
    batch["img"] = batch["img"].float() / 255.0
    loss_k, g_k = grads_of_step(model, batch, steps)
    plain = copy.deepcopy(model)
    use_plain_training_ops(plain)
    loss_p, g_p = grads_of_step(plain, batch, steps)
    model64 = copy.deepcopy(plain).double()
    batch64 = dict(batch, img=batch["img"].double(), bboxes=batch["bboxes"].double())
    loss_64, g_64 = grads_of_step(model64, batch64, steps)
    top = max(g.abs().max().item() for g in g_64)
    err_k = err_p = 0.0
    for a, p, r in zip(g_k, g_p, g_64):
        scale = max(r.abs().max().item(), 1e-3 * top)
        err_k = max(err_k, (a.double() - r).abs().max().item() / scale)
        err_p = max(err_p, (p.double() - r).abs().max().item() / scale)
    ok = err_k <= E2E_FACTOR * err_p + E2E_GRAD_ATOL and all(
        bool(torch.isfinite(g).all()) for g in g_k)
    emit({"phase": "e2e_grads", "cfg": "vil-det-tiny", "batch": 2, "imgsz": 160,
          "loss_kernel": loss_k, "loss_plain": loss_p, "loss_f64": loss_64,
          "kernel_vs_f64_rel": err_k, "plain_vs_f64_rel": err_p, "factor": E2E_FACTOR,
          "atol_rel": E2E_GRAD_ATOL, "leaves": len(g_k)})
    if not ok:
        raise AssertionError("vil-det-tiny: the kernel gradients are further from float64 "
                             "than allowed")


def expected_step_launches(model) -> dict:
    """Launches of each training kernel in one train step, from the model:
    one backward, epilogue and FFN kernel per ViL layer, one train forward
    per layer plus one more per layer of a pair that is rematerialised (the
    backward recomputes its forward).  vil-det-192: 20 layers, 4 of them at
    S = 6400 >= 80 * 80, so 24, 20, 20, 20."""
    from xlstm_yolo_tpu_torch.nn.layers import ViLBlockPair, ViLLayer

    layers = sum(isinstance(m, ViLLayer) for m in model.modules())
    remat = 0
    for m in model.modules():
        if isinstance(m, ViLBlockPair):
            h, w = m.rowwise_from_top_left.layer.conv.seqlens
            remat += 2 * (h * w >= m.ckpt_thresh)
    return {"chunkwise_fw_train": layers + remat, "chunkwise_bw": layers,
            "epilogue_bw": layers, "ffn_bw": layers}


def counts(cw, epi, ffn) -> dict:
    return {"chunkwise_fw": cw.LAUNCHES, "chunkwise_fw_train": cw.LAUNCHES_TRAIN,
            "chunkwise_bw": cw.LAUNCHES_BW, "epilogue_bw": epi.LAUNCHES, "ffn_bw": ffn.LAUNCHES}


def zero_counts(cw, epi, ffn):
    cw.LAUNCHES = cw.LAUNCHES_TRAIN = cw.LAUNCHES_BW = 0
    epi.LAUNCHES = ffn.LAUNCHES = 0


def phase_train(cw, epi, ffn, steps):
    """The slice's path: detect_trainer on vil-det-192, TRAIN_STEPS steps."""
    import torch

    from xlstm_yolo_tpu_torch.engine import optimizers as opt_lib

    model, state, step = steps.detect_trainer(
        "vil-det-192.yaml", device="cuda", compute_dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(0), **TRAIN_OPT)
    perturb_ifgates(model, seed=7)
    state.ema = opt_lib.ema_init(list(state.params.values()))  # of the perturbed model
    expected = expected_step_launches(model)
    p0 = [p.detach().clone() for p in state.params.values()]
    e0 = [e.clone() for e in state.ema.params]
    batches = [train_batch(B, 640, seed=10 + j) for j in range(TRAIN_STEPS)]
    gen = torch.Generator().manual_seed(8)
    per_step, metrics_log = [], []
    zero_counts(cw, epi, ffn)
    for batch in batches:
        before = counts(cw, epi, ffn)
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        after = counts(cw, epi, ffn)
        per_step.append({k: after[k] - before[k] for k in after})
        metrics_log.append({k: v.item() for k, v in metrics.items()})
    total = counts(cw, epi, ffn)
    moved = max((p.detach() - a).abs().max().item() for p, a in zip(state.params.values(), p0))
    ema_moved = max((e - a).abs().max().item() for e, a in zip(state.ema.params, e0))
    emit({"phase": "train", "cfg": "vil-det-192", "batch": B, "imgsz": 640,
          "compute_dtype": "bfloat16", "param_dtype": "float32", "optimizer": TRAIN_OPT,
          "ema": True, "steps": TRAIN_STEPS, "state_step": state.step, "metrics": metrics_log,
          "launches_per_step": per_step, "expected_per_step": expected,
          "param_max_change": moved, "ema_max_change": ema_moved})
    for m in metrics_log:
        if not all(map(lambda v: v == v and abs(v) != float("inf"), m.values())):
            raise AssertionError(f"non-finite loss items {m}")
    if not (moved > 0 and ema_moved > 0):
        raise AssertionError("the parameters or the EMA did not move")
    for s in per_step:
        if s["chunkwise_fw"] != 0 or any(s[k] != expected[k] for k in KERNELS):
            raise AssertionError(f"train step launches {s}, expected {expected}")
    return model, state, step, batches[0], total


def phase_train_times(cw, epi, ffn, card: str):
    """Per-call times of the four training kernels at each S (bf16) with
    their plain versions (the train step's time is phase_v1_times')."""
    import torch

    per = {k: {} for k in KERNELS}
    for S in SEQ_LENS:
        args = kernel_inputs(S, torch.bfloat16, seed=S)
        _, _, (cs, _, den) = cw.mlstm_siging_chunkwise_fw_train(*args, eps=EPS)
        dh = torch.randn(B, S, H, generator=torch.Generator().manual_seed(S)).to(
            "cuda", torch.bfloat16)
        e_args, f_args = row_inputs(S, torch.bfloat16, seed=S)
        pairs = {
            "chunkwise_fw_train": (
                lambda: cw.mlstm_siging_chunkwise_fw_train(*args, eps=EPS),
                lambda: cw.mlstm_siging_chunkwise_fw_train_plain(*args, eps=EPS)),
            "chunkwise_bw": (lambda: cw.mlstm_siging_chunkwise_bw(*args[:6], cs, den, dh, eps=EPS),
                             lambda: cw.mlstm_siging_chunkwise_bw_plain(*args[:6], cs, den, dh,
                                                                        eps=EPS)),
            "epilogue_bw": (lambda: epi.epilogue_bwd(*e_args),
                            lambda: epi.epilogue_bwd_plain(*e_args)),
            "ffn_bw": (lambda: ffn.ffn_bwd(*f_args), lambda: ffn.ffn_bwd_plain(*f_args)),
        }
        for name, (kern, plain) in pairs.items():
            t_plain = time_cuda(plain, iters=3, reps=3)
            t_kern = time_cuda(kern, iters=10, reps=3) + time_cuda(kern, iters=10, reps=3)
            t_plain += time_cuda(plain, iters=3, reps=3)
            row = {"ms": statistics.median(t_kern), "plain_ms": statistics.median(t_plain),
                   **dict(zip(("bound_ms", "bound_by"), train_bound(name, S)))}
            per[name][S] = row
            emit({"phase": "times", "what": name, "card": card, "B": B, "S": S,
                  "dtype": "bfloat16", **row, "ms_runs": t_kern, "plain_ms_runs": t_plain})
        del args, cs, den, dh, e_args, f_args, pairs

    return per


V1 = "chunkwise--pallas_xl_chunk_siging"
V1_KERNELS = ("chunkwise_v1_fw", "chunkwise_v1_bw_dc", "chunkwise_v1_bw_dqkv")


def v1_plan(model) -> dict:
    """The v1 route's kernel calls, derived from the model's layers and the
    wrappers' own plan: per forward in inference, each segment of
    ``chunk_plan(S, chunk)`` (one forward call each) and the tails left to
    the recurrent sequence function; per train step, one forward, dC scan
    and dq/dk/dv call per layer at S padded to whole chunks, and one more
    forward per layer of a rematerialised pair.  Returns
    {"infer": {(S, L): calls}, "tails": n, "train": {(S, L): calls},
    "remat": {(S, L): calls}}."""
    from xlstm_yolo_tpu_torch.nn.layers import ViLBlockPair
    from xlstm_yolo_tpu_torch.ops.wrappers import chunk_plan

    out = {"infer": {}, "tails": 0, "train": {}, "remat": {}}
    for m in model.modules():
        if not isinstance(m, ViLBlockPair):
            continue
        layer = m.rowwise_from_top_left.layer
        h, w = layer.conv.seqlens
        S, L = h * w, layer.mlstm_cell.chunk_size
        plan, tail = chunk_plan(S, L)
        for _, seg, cs in plan:
            out["infer"][(seg, cs)] = out["infer"].get((seg, cs), 0) + 2
        out["tails"] += 2 * (tail > 0)
        key = (-(-S // L) * L, L)
        out["train"][key] = out["train"].get(key, 0) + 2
        if S >= m.ckpt_thresh:
            out["remat"][key] = out["remat"].get(key, 0) + 2
    return out


def v1_expected_step(plan) -> dict:
    n = sum(plan["train"].values())
    return {"chunkwise_v1_fw": n + sum(plan["remat"].values()), "chunkwise_v1_bw_dc": n,
            "chunkwise_v1_bw_dqkv": n}


def v1_counts(v1) -> dict:
    return {"chunkwise_v1_fw": v1.LAUNCHES_FW, "chunkwise_v1_bw_dc": v1.LAUNCHES_BW_DC,
            "chunkwise_v1_bw_dqkv": v1.LAUNCHES_BW_DQKV}


def v1_inputs(S, dtype, gates="open", states=False, seed=0, device="cuda"):
    """Flagship-width (B, NH, S, DH) streams, (B, NH, S) gates, states, dh
    and dC_last on the card."""
    import torch

    g = torch.Generator().manual_seed(seed)
    cu = lambda t, d=torch.float32: None if t is None else t.to(device, d)  # noqa: E731
    q, k, v, dh = (cu(torch.randn(B, NH, S, DH, generator=g), dtype) for _ in range(4))
    i = cu(torch.randn(B, NH, S, generator=g))
    f = cu(torch.randn(B, NH, S, generator=g) + 2 if gates == "open"
           else torch.rand(B, NH, S, generator=g) * 40 - 60)
    c0, n0, dcl = (cu(torch.randn(*s, generator=g)) if states else None
                   for s in ((B, NH, DH, DH), (B, NH, DH), (B, NH, DH, DH)))
    return (q, k, v, i, f, c0, n0), dh, dcl


def v1_bound(name: str, S: int, L: int, itemsize: int = 2, states: bool = False,
             save: bool = True):
    """Least time for one call of a v1 or exp kernel at batch B in ms: each
    input read once and each output written once over HBM bandwidth,
    against the causal products at the bf16 peak (PERF.md).  ``states``:
    the forward reads initial states (the inference segments); ``save``:
    the exp forward writes its saved rows (training), else h and the last
    states only (predict).  The exp kernels move m_comb per row (f32) and m
    (forward) or [m_prev, gbar | m_new] (backward) per chunk besides, and
    write dq, dk, dv in the input dtype."""
    NC = S // L
    rows, st = B * NH * S, B * NH * (DH * DH + DH) * 4
    stream, gate = rows * DH * itemsize, rows * 4
    m_chunk = B * NH * NC * 4
    if name == "chunkwise_v1_fw":  # q, k, v, i, f in; h, den, C/n per chunk, last C/n out
        nbytes = 4 * stream + 3 * gate + B * NC * NH * (DH * DH + DH) * 4 + st * (1 + states)
        flops = rows * (2 * DH * (L + 1) + 4 * DH * DH)
    elif name == "chunkwise_exp_fw":  # + m; saved: den, m_comb, C and m per chunk
        st_m = st + B * NH * 4
        saved = 2 * gate + B * NC * NH * DH * DH * 4 + m_chunk if save else 0
        nbytes = 4 * stream + 2 * gate + saved + st_m * (1 + states)
        flops = rows * (2 * DH * (L + 1) + 4 * DH * DH)
    elif name == "chunkwise_v1_bw_dc":  # q, dh, f, den in; dC per chunk and dC0 out
        nbytes = 2 * stream + 2 * gate + B * NH * (NC + 1) * DH * DH * 4
        flops = rows * 2 * DH * DH
    elif name == "chunkwise_exp_bw_dc":  # + m_comb per row, [m_prev, gbar] per chunk
        nbytes = 2 * stream + 3 * gate + B * NH * (NC + 1) * DH * DH * 4 + 2 * m_chunk
        flops = rows * 2 * DH * DH
    elif name == "chunkwise_v1_bw_dqkv":  # q, k, v, dh, i, f, den, C, dC in; f32 dq, dk, dv
        nbytes = 4 * stream + 3 * gate + 2 * B * NH * NC * DH * DH * 4 + 3 * rows * DH * 4
        flops = rows * (5 * DH * (L + 1) + 6 * DH * DH)
    else:  # exp dq/dk/dv: + m_comb per row, [m_prev, m_new] per chunk; dq, dk, dv as q
        nbytes = 7 * stream + 4 * gate + 2 * B * NH * NC * DH * DH * 4 + 2 * m_chunk
        flops = rows * (5 * DH * (L + 1) + 6 * DH * DH)
    return _bound(nbytes, flops)


def phase_v1_kernels(v1, shapes, device="cuda"):
    """The three v1 kernels against their plain versions at the flagship
    shapes (B 8, NH 12, DH 32) and every (S, L) the route gives them:
    float32 streams with float32 products (1e-4), and the route's own
    bfloat16 streams and products (2e-2), relative to each output's
    largest |value|; initial states and dC_last on the inference segments,
    closed forget gates on one case."""
    import torch

    worst = {k: {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]} for k in V1_KERNELS}
    cases = [(S, L, "open", states) for (S, L), states in shapes] + [(2048, 512, "closed", True)]
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[-1]
        rel = GRAD_REL[key]
        for S, L, gates, states in cases:
            args, dh, dcl = v1_inputs(S, dtype, gates, states, seed=S + L, device=device)
            kw = dict(chunk_size=L, eps=EPS, compute_dtype=dtype)
            got = v1.chunkwise_fw(*args, **kw)
            torch.cuda.synchronize()
            ref = v1.chunkwise_fw_plain(*args, **kw)
            e_fw = compare_outputs(f"v1 fw S={S} L={L} {key}", got, ref, rel)
            q, k, v, i, f = args[:5]
            _, den, cs = ref[:3]
            dcs, dc0 = v1.chunkwise_bw_dc(q, f, dh, den, dcl, **kw)
            torch.cuda.synchronize()
            rdcs, rdc0 = v1.chunkwise_bw_dc_plain(q, f, dh, den, dcl, **kw)
            e_dc = compare_outputs(f"v1 bw_dc S={S} L={L} {key}", (dcs, dc0), (rdcs, rdc0), rel)
            got_b = v1.chunkwise_bw_dqkv(q, k, v, i, f, cs, den, dh, rdcs, **kw)
            torch.cuda.synchronize()
            ref_b = v1.chunkwise_bw_dqkv_plain(q, k, v, i, f, cs, den, dh, rdcs, **kw)
            e_qkv = compare_outputs(f"v1 bw_dqkv S={S} L={L} {key}", got_b, ref_b, rel)
            for name, e in zip(V1_KERNELS, (e_fw, e_dc, e_qkv)):
                worst[name][key] = [max(a, b) for a, b in zip(worst[name][key], e)]
            emit({"phase": "v1_kernels", "S": S, "L": L, "dtype": key, "compute_dtype": key,
                  "gates": gates, "initial_states": states, "dc_last": states, "rel_tol": rel,
                  **{f"{n}_max_rel_err": e[1] for n, e in zip(V1_KERNELS, (e_fw, e_dc, e_qkv))}})
            del args, dh, dcl, got, ref, got_b, ref_b, dcs, rdcs
    return worst


def phase_v1_predict(v1, cw, yolo):
    """The predict path on the v1 route: YOLO(..., chunkwise_kernel=V1)
    on the images of phase_predict, held to the derived launch count."""
    import numpy as np

    plan = v1_plan(yolo.model)
    per_forward = sum(plan["infer"].values())
    images = synthetic_images(10, seed=5)  # batches of 8 and 2: two forwards
    forwards = -(-len(images) // B)
    cw.LAUNCHES = v1.LAUNCHES_FW = v1.LAUNCHES_BW_DC = v1.LAUNCHES_BW_DQKV = 0
    results = yolo.predict(images, batch=B, conf=0.0)
    launches, v2_launches = v1.LAUNCHES_FW, cw.LAUNCHES
    ok = len(results) == len(images) and all(
        np.isfinite(r.boxes.data).all() and r.orig_img.shape == im.shape
        for r, im in zip(results, images))
    emit({"phase": "v1_predict", "cfg": "vil-det-192", "chunkwise_kernel": V1,
          "dtype": "bfloat16", "images": len(images), "batch": B, "launches": launches,
          "forwards": forwards, "expected": forwards * per_forward, "per_forward": per_forward,
          "segments_per_forward": {f"{S}@{L}": n for (S, L), n in sorted(plan["infer"].items())},
          "sequence_tails_per_forward": plan["tails"], "v2_launches": v2_launches,
          "boxes_per_image": [len(r) for r in results]})
    if not ok:
        raise AssertionError("v1 predict: non-finite result or wrong original shape")
    if launches != forwards * per_forward or v2_launches != 0:
        raise AssertionError(f"v1 predict made {launches} v1 forward launches (expected "
                             f"{forwards * per_forward}) and {v2_launches} v2 ones")
    return launches


def phase_v1_train(v1, cw, epi, ffn, steps, cfg="vil-det-192.yaml", imgsz=640, device="cuda"):
    """The training path on the v1 route: detect_trainer(..., chunkwise_kernel
    =V1), TRAIN_STEPS bf16 steps, exact launches per step."""
    import torch

    from xlstm_yolo_tpu_torch.engine import optimizers as opt_lib

    model, state, step = steps.detect_trainer(
        cfg, device=device, compute_dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(0), chunkwise_kernel=V1, **TRAIN_OPT)
    perturb_ifgates(model, seed=7)
    state.ema = opt_lib.ema_init(list(state.params.values()))
    expected = v1_expected_step(v1_plan(model))
    layers = expected["chunkwise_v1_bw_dc"]
    p0 = [p.detach().clone() for p in state.params.values()]
    e0 = [e.clone() for e in state.ema.params]
    batches = [train_batch(B, imgsz, seed=10 + j, device=device) for j in range(TRAIN_STEPS)]
    gen = torch.Generator().manual_seed(8)
    all_counts = lambda: {**counts(cw, epi, ffn), **v1_counts(v1)}  # noqa: E731
    zero_counts(cw, epi, ffn)
    v1.LAUNCHES_FW = v1.LAUNCHES_BW_DC = v1.LAUNCHES_BW_DQKV = 0
    per_step, metrics_log = [], []
    for batch in batches:
        before = all_counts()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        after = all_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        metrics_log.append({k: v.item() for k, v in metrics.items()})
    total = v1_counts(v1)
    moved = max((p.detach() - a).abs().max().item() for p, a in zip(state.params.values(), p0))
    ema_moved = max((e - a).abs().max().item() for e, a in zip(state.ema.params, e0))
    emit({"phase": "v1_train", "cfg": "vil-det-192", "chunkwise_kernel": V1, "batch": B,
          "imgsz": 640, "compute_dtype": "bfloat16", "steps": TRAIN_STEPS,
          "metrics": metrics_log, "launches_per_step": per_step, "expected_per_step": expected,
          "param_max_change": moved, "ema_max_change": ema_moved})
    for m in metrics_log:
        if not all(map(lambda v: v == v and abs(v) != float("inf"), m.values())):
            raise AssertionError(f"v1 train: non-finite loss items {m}")
    if not (moved > 0 and ema_moved > 0):
        raise AssertionError("v1 train: the parameters or the EMA did not move")
    for s in per_step:
        other = {"chunkwise_fw": 0, "chunkwise_fw_train": 0, "chunkwise_bw": 0,
                 "epilogue_bw": layers, "ffn_bw": layers}
        if any(s[k] != n for k, n in {**expected, **other}.items()):
            raise AssertionError(f"v1 train step launches {s}, expected {expected} and {other}")
    return model, state, step, batches[0], total


EXP = "chunkwise--pallas_xl_chunk"
EXP_KERNELS = ("chunkwise_exp_fw", "chunkwise_exp_bw_dc", "chunkwise_exp_bw_dqkv")
EXP_REGIMES = ((6656, 512, False), (1536, 512, True), (128, 64, False))  # closed / large i


def exp_counts(ex) -> dict:
    return {"chunkwise_exp_fw": ex.LAUNCHES_FW, "chunkwise_exp_bw_dc": ex.LAUNCHES_BW_DC,
            "chunkwise_exp_bw_dqkv": ex.LAUNCHES_BW_DQKV}


def zero_route_counts(v1, ex):
    v1.LAUNCHES_FW = v1.LAUNCHES_BW_DC = v1.LAUNCHES_BW_DQKV = 0
    ex.LAUNCHES_FW = ex.LAUNCHES_BW_DC = ex.LAUNCHES_BW_DQKV = 0


def exp_inputs(S, dtype, gates="open", states=False, seed=0, device="cuda"):
    """Flagship-width (B, NH, S, DH) streams, (B, NH, S) gates (open: i ~
    N(0, 1), f ~ N(2, 1); closed: f ~ U(-60, -20); large_i: i ~ U(5, 15)),
    initial (C, n, m), dh and dC_last on the card."""
    import torch

    g = torch.Generator().manual_seed(seed)
    cu = lambda t, d=torch.float32: None if t is None else t.to(device, d)  # noqa: E731
    q, k, v, dh = (cu(torch.randn(B, NH, S, DH, generator=g), dtype) for _ in range(4))
    i = cu(torch.rand(B, NH, S, generator=g) * 10 + 5 if gates == "large_i"
           else torch.randn(B, NH, S, generator=g))
    f = cu(torch.rand(B, NH, S, generator=g) * 40 - 60 if gates == "closed"
           else torch.randn(B, NH, S, generator=g) + 2)
    c0, n0, dcl = (cu(torch.randn(*s, generator=g)) if states else None
                   for s in ((B, NH, DH, DH), (B, NH, DH), (B, NH, DH, DH)))
    m0 = cu(torch.randn(B, NH, generator=g) * 3) if states else None
    return (q, k, v, i, f, c0, n0, m0), dh, dcl


def phase_exp_kernels(ex, shapes, device="cuda"):
    """The three exp kernels against their plain versions at the flagship
    shapes (B 8, NH 12, DH 32) and every (S, L) the route gives them, open
    gates, with initial (C, n, m) and dC_last on the inference segments; and
    at EXP_REGIMES with closed forget gates and with large input gates.
    float32 streams and products (1e-4) and the route's bfloat16 (2e-2),
    relative to each output's largest |value|.  h is held as its numerator
    h (den + eps) beside den: once m is large the floor e^{-m_comb} of the
    denominator is tiny, and a row whose terms nearly cancel turns a float32
    rounding of den into a large relative change of h (its own error is
    reported as h_max_rel_err).  The predict variant's h and last states
    must equal the training variant's bit for bit."""
    import torch

    worst = {k: {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]} for k in EXP_KERNELS}
    cases = [(S, L, "open", states) for (S, L), states in shapes] + [
        (S, L, gates, states) for gates in ("closed", "large_i") for S, L, states in EXP_REGIMES]
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[-1]
        rel = GRAD_REL[key]
        for S, L, gates, states in cases:
            args, dh, dcl = exp_inputs(S, dtype, gates, states, seed=S + L + 1, device=device)
            kw = dict(chunk_size=L, eps=EPS, compute_dtype=dtype)
            got = ex.chunkwise_exp_fw(*args, **kw)
            got_p = ex.chunkwise_exp_fw(*args, save_states=False, **kw)
            torch.cuda.synchronize()
            ref = ex.chunkwise_exp_fw_plain(*args, **kw)
            num = lambda out: out[0].float() * (out[1] + EPS)[..., None]  # noqa: E731
            e_fw = compare_outputs(f"exp fw S={S} L={L} {gates} {key}",
                                   [num(got), *got[1:5], *got[5]], [num(ref), *ref[1:5], *ref[5]],
                                   rel)
            h_rel = ((got[0].float() - ref[0].float()).abs().max()
                     / ref[0].float().abs().max()).item()
            if not (torch.equal(got_p[0], got[0])
                    and all(torch.equal(a, b) for a, b in zip(got_p[5], got[5]))):
                raise AssertionError(f"exp fw S={S} L={L}: the predict variant differs")
            q, k, v, i, f = args[:5]
            _, den, mc, cs, ms, (_, _, m_last) = ref
            mrow_dc, mrow_qkv = ex.m_rows(f, ms, m_last, L)
            dcs, dc0 = ex.chunkwise_exp_bw_dc(q, f, dh, den, mc, mrow_dc, dcl, **kw)
            torch.cuda.synchronize()
            rdcs, rdc0 = ex.chunkwise_exp_bw_dc_plain(q, f, dh, den, mc, mrow_dc, dcl, **kw)
            e_dc = compare_outputs(f"exp bw_dc S={S} L={L} {gates} {key}", (dcs, dc0),
                                   (rdcs, rdc0), rel)
            got_b = ex.chunkwise_exp_bw_dqkv(q, k, v, i, f, cs, den, mc, mrow_qkv, dh, rdcs, **kw)
            torch.cuda.synchronize()
            ref_b = ex.chunkwise_exp_bw_dqkv_plain(q, k, v, i, f, cs, den, mc, mrow_qkv, dh, rdcs,
                                                   **kw)
            e_qkv = compare_outputs(f"exp bw_dqkv S={S} L={L} {gates} {key}", got_b, ref_b, rel)
            for name, e in zip(EXP_KERNELS, (e_fw, e_dc, e_qkv)):
                worst[name][key] = [max(a, b) for a, b in zip(worst[name][key], e)]
            emit({"phase": "exp_kernels", "S": S, "L": L, "dtype": key, "compute_dtype": key,
                  "gates": gates, "initial_states": states, "dc_last": states, "rel_tol": rel,
                  "m_last_range": [m_last.min().item(), m_last.max().item()],
                  "h_max_rel_err": h_rel,
                  **{f"{n}_max_rel_err": e[1] for n, e in zip(EXP_KERNELS, (e_fw, e_dc, e_qkv))}})
            del args, dh, dcl, got, got_p, ref, got_b, ref_b, dcs, rdcs
    return worst


def phase_exp_predict(ex, v1, cw, yolo):
    """The predict path on the exp route: YOLO(..., chunkwise_kernel=EXP)
    on the images of phase_predict, held to the launch count derived from
    the wrappers' segment plan (the v1 route's plan), no v1 or v2 launch."""
    import numpy as np

    plan = v1_plan(yolo.model)
    per_forward = sum(plan["infer"].values())
    images = synthetic_images(10, seed=5)  # batches of 8 and 2: two forwards
    forwards = -(-len(images) // B)
    cw.LAUNCHES = 0
    zero_route_counts(v1, ex)
    results = yolo.predict(images, batch=B, conf=0.0)
    launches, others = ex.LAUNCHES_FW, cw.LAUNCHES + sum(v1_counts(v1).values())
    ok = len(results) == len(images)
    for r, im in zip(results, images):
        h, w = im.shape[:2]
        d = r.boxes.data
        ok &= bool(r.orig_img.shape == im.shape and np.isfinite(d).all()
                   and (d[:, [0, 2]] >= 0).all() and (d[:, [0, 2]] <= w).all()
                   and (d[:, [1, 3]] >= 0).all() and (d[:, [1, 3]] <= h).all())
    emit({"phase": "exp_predict", "cfg": "vil-det-192", "chunkwise_kernel": EXP,
          "dtype": "bfloat16", "images": len(images), "batch": B, "launches": launches,
          "forwards": forwards, "expected": forwards * per_forward, "per_forward": per_forward,
          "segments_per_forward": {f"{S}@{L}": n for (S, L), n in sorted(plan["infer"].items())},
          "sequence_tails_per_forward": plan["tails"], "v1_v2_launches": others,
          "bw_launches": ex.LAUNCHES_BW_DC + ex.LAUNCHES_BW_DQKV,
          "boxes_per_image": [len(r) for r in results]})
    if not ok:
        raise AssertionError("exp predict: non-finite result, wrong original shape or boxes "
                             "outside the image")
    if launches != forwards * per_forward or others != 0:
        raise AssertionError(f"exp predict made {launches} exp forward launches (expected "
                             f"{forwards * per_forward}) and {others} v1/v2 ones")
    return launches


def phase_exp_train(ex, v1, cw, epi, ffn, steps, cfg="vil-det-192.yaml", imgsz=640,
                    device="cuda"):
    """The training path on the exp route: detect_trainer(...,
    chunkwise_kernel=EXP), TRAIN_STEPS bf16 steps, exact launches per step."""
    import torch

    from xlstm_yolo_tpu_torch.engine import optimizers as opt_lib

    model, state, step = steps.detect_trainer(
        cfg, device=device, compute_dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(0), chunkwise_kernel=EXP, **TRAIN_OPT)
    perturb_ifgates(model, seed=7)
    state.ema = opt_lib.ema_init(list(state.params.values()))
    plan = v1_plan(model)
    n = sum(plan["train"].values())
    expected = {"chunkwise_exp_fw": n + sum(plan["remat"].values()), "chunkwise_exp_bw_dc": n,
                "chunkwise_exp_bw_dqkv": n}
    other = {"chunkwise_fw": 0, "chunkwise_fw_train": 0, "chunkwise_bw": 0, "epilogue_bw": n,
             "ffn_bw": n, **{k: 0 for k in V1_KERNELS}}
    p0 = [p.detach().clone() for p in state.params.values()]
    e0 = [e.clone() for e in state.ema.params]
    batches = [train_batch(B, imgsz, seed=10 + j, device=device) for j in range(TRAIN_STEPS)]
    gen = torch.Generator().manual_seed(8)
    all_counts = lambda: {**counts(cw, epi, ffn), **v1_counts(v1), **exp_counts(ex)}  # noqa: E731
    zero_counts(cw, epi, ffn)
    zero_route_counts(v1, ex)
    per_step, metrics_log = [], []
    for batch in batches:
        before = all_counts()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        after = all_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        metrics_log.append({k: v.item() for k, v in metrics.items()})
    total = exp_counts(ex)
    moved = max((p.detach() - a).abs().max().item() for p, a in zip(state.params.values(), p0))
    ema_moved = max((e - a).abs().max().item() for e, a in zip(state.ema.params, e0))
    emit({"phase": "exp_train", "cfg": "vil-det-192", "chunkwise_kernel": EXP, "batch": B,
          "imgsz": imgsz, "compute_dtype": "bfloat16", "steps": TRAIN_STEPS,
          "metrics": metrics_log, "launches_per_step": per_step, "expected_per_step": expected,
          "param_max_change": moved, "ema_max_change": ema_moved})
    for m in metrics_log:
        if not all(map(lambda v: v == v and abs(v) != float("inf"), m.values())):
            raise AssertionError(f"exp train: non-finite loss items {m}")
    if not (moved > 0 and ema_moved > 0):
        raise AssertionError("exp train: the parameters or the EMA did not move")
    for s_ in per_step:
        if any(s_[k] != c for k, c in {**expected, **other}.items()):
            raise AssertionError(f"exp train step launches {s_}, expected {expected} and {other}")
    return model, state, step, batches[0], total, expected


@contextlib.contextmanager
def registry_entry(name: str, fn):
    """The registry's entry ``name`` ("<kind>--<backend>") replaced by
    ``fn`` for the ``with`` block."""
    from xlstm_yolo_tpu_torch.ops import backend

    kind, _, key = name.partition("--")
    reg = backend._REGISTRY[kind]
    old = reg[key]
    reg[key] = fn
    try:
        yield
    finally:
        reg[key] = old


@contextlib.contextmanager
def plain_kernels(mod, names):
    """The kernel wrappers ``names`` of ``mod`` replaced by their plain
    versions (``<name>_plain``, any device and dtype) for the ``with``
    block; the autograd Functions and the backward helpers call them by
    name."""
    old = {name: getattr(mod, name) for name in names}
    try:
        for name in names:
            setattr(mod, name, getattr(mod, f"{name}_plain"))
        yield
    finally:
        for name, fn in old.items():
            setattr(mod, name, fn)


def phase_route_grads(phase: str, route: str, mod, kernels, entry, counts_of, steps,
                      compared=None, device="cuda"):
    """vil-det-tiny on a registry route (``route``, whose entry is ``entry``
    of ``mod``), perturbed ifgates (seed EXP_GRADS_SEED), float32 products
    (the routes' bfloat16 products make this random model chaotic).  Every
    call of the route's kernel wrappers ``kernels`` in a float32 train step
    is recorded and replayed through the kernel and its plain version, each
    output within GRAD_REL["float32"] of its largest |value| (``compared``
    maps a wrapper's name, its arguments and its outputs to the outputs
    compared).  And the float32 gradients of that step with the kernels,
    and with the same route on their plain versions (the autograd Function
    unchanged; the epilogue and FFN plain too), are each held against a
    float64 step on the plain versions (float64 products); the kernel path
    may be at most EXP_E2E_FACTOR times as far from float64 as the plain
    path, per leaf relative to its largest float64 |g| (floored as in
    phase_e2e_grads)."""
    import torch

    from xlstm_yolo_tpu_torch.nn.tasks import build_detection_model

    def entry_f32(q, *args, **kw):
        cd = torch.float64 if q.dtype == torch.float64 else torch.float32
        return entry(q, *args, compute_dtype=cd, **kw)

    model, _ = build_detection_model("vil-det-tiny.yaml", device=device, training=True,
                                     generator=torch.Generator().manual_seed(0),
                                     chunkwise_kernel=route)
    perturb_ifgates(model, seed=EXP_GRADS_SEED)
    batch = train_batch(2, 160, seed=6, device=device)
    batch["img"] = batch["img"].float() / 255.0
    originals = {name: getattr(mod, name) for name in kernels}
    plains = {name: getattr(mod, f"{name}_plain") for name in kernels}
    calls = {name: [] for name in kernels}

    def recorder(name):
        def call(*args, **kw):
            calls[name].append((args, kw))
            return originals[name](*args, **kw)
        return call

    before = counts_of()
    with registry_entry(route, entry_f32):
        try:
            for name in kernels:
                setattr(mod, name, recorder(name))
            loss_k, g_k = grads_of_step(model, batch, steps)
        finally:
            for name, fn in originals.items():
                setattr(mod, name, fn)
        launches = {k: counts_of()[k] - before[k] for k in before}
        plain = copy.deepcopy(model)
        use_plain_training_ops(plain)
        with plain_kernels(mod, kernels):
            loss_p, g_p = grads_of_step(plain, batch, steps)
            batch64 = dict(batch, img=batch["img"].double(), bboxes=batch["bboxes"].double())
            loss_64, g_64 = grads_of_step(plain.double(), batch64, steps)
    replay = {}
    for name in kernels:
        worst = 0.0
        for args, kw in calls[name]:
            got, ref = originals[name](*args, **kw), plains[name](*args, **kw)
            got, ref = ((x,) if torch.is_tensor(x) else x for x in (got, ref))
            if compared is not None:
                got, ref = (compared(name, args, kw, x) for x in (got, ref))
            worst = max(worst, compare_outputs(f"{phase} replay {name} S={args[0].shape[2]}",
                                               got, ref, GRAD_REL["float32"])[1])
            del got, ref
        replay[name] = {"calls": len(calls[name]), "max_rel_err": worst}
    top = max(g.abs().max().item() for g in g_64)
    err_k = err_p = 0.0
    for a, p, r in zip(g_k, g_p, g_64):
        scale = max(r.abs().max().item(), 1e-3 * top)
        err_k = max(err_k, (a.double() - r).abs().max().item() / scale)
        err_p = max(err_p, (p.double() - r).abs().max().item() / scale)
    ok = err_k <= EXP_E2E_FACTOR * err_p + E2E_GRAD_ATOL and all(
        bool(torch.isfinite(g).all()) for g in g_k) and (
        device == "cpu" or min(launches.values()) > 0)
    emit({"phase": phase, "cfg": "vil-det-tiny", "chunkwise_kernel": route, "batch": 2,
          "imgsz": 160, "products": "float32", "loss_kernel": loss_k, "loss_plain": loss_p,
          "loss_f64": loss_64, "kernel_vs_f64_rel": err_k, "plain_vs_f64_rel": err_p,
          "factor": EXP_E2E_FACTOR, "ifgate_seed": EXP_GRADS_SEED, "atol_rel": E2E_GRAD_ATOL,
          "leaves": len(g_k), "replay": replay, "replay_rel_tol": GRAD_REL["float32"],
          "launches": launches})
    if not ok:
        raise AssertionError(f"vil-det-tiny on {route}: the kernel gradients are further from "
                             "float64 than allowed (or no kernel of the route ran)")


def phase_exp_grads(ex, steps, device="cuda"):
    """phase_route_grads on the exp route.  The forward's h is compared as
    its numerator h (den + eps), as in phase_exp_kernels."""
    import inspect

    def compared(name, args, kw, out):
        if name != "chunkwise_exp_fw":
            return out
        eps = inspect.signature(ex.chunkwise_exp_fw_plain).bind(*args, **kw).arguments["eps"]
        return [out[0].float() * (out[1] + eps)[..., None], *out[1:5], *out[5]]

    phase_route_grads("exp_grads", EXP, ex, EXP_KERNELS, ex.mlstm_chunkwise_exp,
                      lambda: exp_counts(ex), steps, compared, device)


PAR = "parallel--pallas_limit_headdim"
PAR_KERNELS = ("parallel_fw", "parallel_bw_dq", "parallel_bw_dkv")
F32_FLOP_PER_S = 67e12  # H100 SXM float32 peak outside the tensor cores
PLAIN_SLICE_BYTES = 1.5e9  # the plain versions' (S, S) matrices, per slice of batch * head
DECODE_TOKENS = 64


def par_counts(pk) -> dict:
    return {"parallel_fw": pk.LAUNCHES_FW, "parallel_bw_dq": pk.LAUNCHES_BW_DQ,
            "parallel_bw_dkv": pk.LAUNCHES_BW_DKV}


def zero_par_counts(pk):
    pk.LAUNCHES_FW = pk.LAUNCHES_BW_DQ = pk.LAUNCHES_BW_DKV = 0


def par_inputs(S, dtype, gates="open", seed=0, device="cuda"):
    """Flagship-width (B, NH, S, DH) streams and dh, (B, NH, S) gates (open:
    i ~ N(0, 1), f ~ U(3, 6), the flagship's forget-gate bias range; closed:
    f ~ U(-60, -20)) on the card."""
    import torch

    g = torch.Generator().manual_seed(seed)
    cu = lambda t, d=torch.float32: t.to(device, d)  # noqa: E731
    q, k, v, dh = (cu(torch.randn(B, NH, S, DH, generator=g), dtype) for _ in range(4))
    i = cu(torch.randn(B, NH, S, generator=g))
    f = cu(torch.rand(B, NH, S, generator=g) * 3 + 3 if gates == "open"
           else torch.rand(B, NH, S, generator=g) * 40 - 60)
    return (q, k, v, i, f), dh


def parallel_bound(name: str, S: int, itemsize: int = 2) -> tuple[float, str]:
    """Least time for one call of a quadratic kernel at batch B in ms: each
    input read once and each output written once over HBM bandwidth (the
    forward: q, k, v, i, f in, h, den out; dq: k, v, dh, i, f, den in, dq
    out; dk/dv: q, k, v, dh, i, f, den in, dk, dv out), against the
    products over the S (S + 1) / 2 causal pairs at the bf16 peak (2 DH
    flop a pair per product: the forward and dq two products, dk/dv
    four)."""
    rows = B * NH * S
    stream, gate = rows * DH * itemsize, rows * 4
    pairs = B * NH * S * (S + 1) / 2
    streams, products = {"parallel_fw": (4, 2), "parallel_bw_dq": (4, 2),
                         "parallel_bw_dkv": (6, 4)}[name]
    return _bound(streams * stream + 3 * gate, products * 2 * DH * pairs)


def step_bound(itemsize: int) -> tuple[float, str]:
    """Least time for one step-kernel call at B 8, NH 12, DH 32 in ms: q, k,
    v, i, f, C, n read and h, C', n' written once over HBM bandwidth,
    against 6 DH^2 + 6 DH float32 operations a head (the C update 4 DH^2,
    q C' 2 DH^2, n and q . n' 6 DH) at the float32 peak."""
    heads = B * NH
    nbytes = heads * (4 * DH * itemsize + 2 * 4 + 2 * (DH * DH + DH) * 4)
    flops = heads * (6 * DH * DH + 6 * DH)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def plain_in_slices(fn, args, S):
    """``fn`` (a plain version) over slices of batch * head, so that its
    (S, S) matrices fit on the card, and the slices' outputs joined back to
    (B, NH, ...).  ``args``: the (B, NH, ...) tensors it takes."""
    import torch

    n = max(1, min(B * NH, int(PLAIN_SLICE_BYTES // (S * S * 4))))
    flat = [a.reshape(B * NH, 1, *a.shape[2:]) for a in args]
    outs = [fn(*(a[j:j + n] for a in flat)) for j in range(0, B * NH, n)]
    outs = [o if isinstance(o, tuple) else (o,) for o in outs]
    joined = [torch.cat(parts).reshape(B, NH, *parts[0].shape[2:]) for parts in zip(*outs)]
    return joined if len(joined) > 1 else joined[0]


def phase_parallel_kernels(pk, lengths):
    """The three quadratic kernels against their plain versions at the
    flagship shapes (B 8, NH 12, DH 32) and at each S the route pads the
    flagship's sequences to, float32 (products float32) and bfloat16
    (products bfloat16), with open and with closed forget gates; the plain
    versions run over slices of batch * head (plain_in_slices).  Each
    output within GRAD_REL of its largest |value|; the backward kernels on
    the forward kernel's den, given to both sides."""
    import torch

    worst = {k: {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]} for k in PAR_KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[-1]
        rel = GRAD_REL[key]
        for S in lengths:
            for gates in ("open", "closed"):
                args, dh = par_inputs(S, dtype, gates, seed=S + (gates == "closed"))
                kw = dict(eps=EPS, compute_dtype=dtype)
                h, den = pk.parallel_fw(*args, **kw)
                dq = pk.parallel_bw_dq(*args, den, dh, **kw)
                dk, dv = pk.parallel_bw_dkv(*args, den, dh, **kw)
                torch.cuda.synchronize()
                plain = {name: functools.partial(getattr(pk, f"{name}_plain"), **kw)
                         for name in PAR_KERNELS}
                errs = {
                    "parallel_fw": compare_outputs(
                        f"parallel fw S={S} {gates} {key}", (h, den),
                        plain_in_slices(plain["parallel_fw"], args, S), rel),
                    "parallel_bw_dq": compare_outputs(
                        f"parallel dq S={S} {gates} {key}", (dq,),
                        (plain_in_slices(plain["parallel_bw_dq"], (*args, den, dh), S),), rel),
                    "parallel_bw_dkv": compare_outputs(
                        f"parallel dkv S={S} {gates} {key}", (dk, dv),
                        plain_in_slices(plain["parallel_bw_dkv"], (*args, den, dh), S), rel)}
                for name, e in errs.items():
                    worst[name][key] = [max(a, b) for a, b in zip(worst[name][key], e)]
                emit({"phase": "parallel_kernels", "S": S, "dtype": key, "compute_dtype": key,
                      "gates": gates, "rel_tol": rel,
                      "den_gt_1_share": (den > 1).float().mean().item(),
                      **{f"{n}_max_rel_err": e[1] for n, e in errs.items()}})
                del args, dh, h, den, dq, dk, dv
    return worst


def phase_parallel_train(pk, ex, v1, cw, epi, ffn, steps, cfg="vil-det-192.yaml", imgsz=640,
                         device="cuda"):
    """The training path on the quadratic route: detect_trainer(...,
    chunkwise_kernel=PAR), TRAIN_STEPS bf16 steps, exact launches per step:
    one forward, dq and dk/dv call per layer at S padded to whole chunks of
    the layer's chunk (the pad wrapper's), one more forward per layer of a
    rematerialised pair; no v1, v2 or exp cell launch."""
    import torch

    from xlstm_yolo_tpu_torch.engine import optimizers as opt_lib

    model, state, step = steps.detect_trainer(
        cfg, device=device, compute_dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(0), chunkwise_kernel=PAR, **TRAIN_OPT)
    perturb_ifgates(model, seed=7)
    state.ema = opt_lib.ema_init(list(state.params.values()))
    plan = v1_plan(model)
    n = sum(plan["train"].values())
    expected = {"parallel_fw": n + sum(plan["remat"].values()), "parallel_bw_dq": n,
                "parallel_bw_dkv": n}
    other = {"chunkwise_fw": 0, "chunkwise_fw_train": 0, "chunkwise_bw": 0, "epilogue_bw": n,
             "ffn_bw": n, **{k: 0 for k in V1_KERNELS + EXP_KERNELS}}
    p0 = [p.detach().clone() for p in state.params.values()]
    e0 = [e.clone() for e in state.ema.params]
    batches = [train_batch(B, imgsz, seed=10 + j, device=device) for j in range(TRAIN_STEPS)]
    gen = torch.Generator().manual_seed(8)
    all_counts = lambda: {**counts(cw, epi, ffn), **v1_counts(v1), **exp_counts(ex),  # noqa: E731
                          **par_counts(pk)}
    zero_counts(cw, epi, ffn)
    zero_route_counts(v1, ex)
    zero_par_counts(pk)
    per_step, metrics_log = [], []
    for batch in batches:
        before = all_counts()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        after = all_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        metrics_log.append({k: v.item() for k, v in metrics.items()})
    total = par_counts(pk)
    moved = max((p.detach() - a).abs().max().item() for p, a in zip(state.params.values(), p0))
    ema_moved = max((e - a).abs().max().item() for e, a in zip(state.ema.params, e0))
    emit({"phase": "parallel_train", "cfg": "vil-det-192", "chunkwise_kernel": PAR, "batch": B,
          "imgsz": imgsz, "compute_dtype": "bfloat16", "steps": TRAIN_STEPS,
          "padded_lengths_per_step": {f"{S}@{L}": c for (S, L), c in sorted(plan["train"].items())},
          "metrics": metrics_log, "launches_per_step": per_step, "expected_per_step": expected,
          "param_max_change": moved, "ema_max_change": ema_moved})
    for m in metrics_log:
        if not all(map(lambda v: v == v and abs(v) != float("inf"), m.values())):
            raise AssertionError(f"parallel train: non-finite loss items {m}")
    if not (moved > 0 and ema_moved > 0):
        raise AssertionError("parallel train: the parameters or the EMA did not move")
    for s_ in per_step:
        if any(s_[k] != c for k, c in {**expected, **other}.items()):
            raise AssertionError(f"parallel train step launches {s_}, expected {expected} and "
                                 f"{other}")
    return model, state, step, batches[0], total, expected


def phase_parallel_grads(pk, steps, device="cuda"):
    """phase_route_grads on the quadratic route."""
    phase_route_grads("parallel_grads", PAR, pk, PAR_KERNELS, pk.mlstm_siging_parallel_kernel,
                      lambda: par_counts(pk), steps, device=device)


def step_inputs(dtype, gates, seed):
    """One token at the flagship's heads: q, k, v (B, NH, DH), gates (B,
    NH) (open: i ~ N(0, 2), f ~ N(2, 1); closed: f ~ U(-60, -20)), C, n."""
    import torch

    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, NH, DH, generator=g).to("cuda", dtype) for _ in range(3))
    i = (torch.randn(B, NH, generator=g) * 2).cuda()
    f = (torch.randn(B, NH, generator=g) + 2 if gates == "open"
         else torch.rand(B, NH, generator=g) * 40 - 60).cuda()
    c, n = torch.randn(B, NH, DH, DH, generator=g).cuda(), torch.randn(B, NH, DH, generator=g).cuda()
    return q, k, v, i, f, c, n


def phase_step_kernel(stp):
    """The step kernel against ``mlstm_siging_step`` at B 8, NH 12, DH 32:
    q, k, v float32 and bfloat16, C and n float32, open and closed forget
    gates; h within GRAD_REL of its largest |value|, (C', n') within
    GRAD_REL["float32"]."""
    import torch

    from xlstm_yolo_tpu_torch.ops.mlstm_recurrent import mlstm_siging_step

    worst = {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]}
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[-1]
        for gates in ("open", "closed"):
            args = step_inputs(dtype, gates, seed=3 + (gates == "closed"))
            h, (c, n) = stp.mlstm_siging_step_kernel(*args, eps=EPS)
            torch.cuda.synchronize()
            hp, (cp, np_) = mlstm_siging_step(*args, eps=EPS)
            e_h = compare_outputs(f"step h {gates} {key}", (h,), (hp,), GRAD_REL[key])
            e_s = compare_outputs(f"step state {gates} {key}", (c, n), (cp, np_),
                                  GRAD_REL["float32"])
            worst[key] = [max(a, b, c_) for a, b, c_ in zip(worst[key], e_h, e_s)]
            emit({"phase": "step_kernel", "dtype": key, "gates": gates, "B": B, "NH": NH,
                  "DH": DH, "h_max_rel_err": e_h[1], "state_max_rel_err": e_s[1],
                  "rel_tol": {"h": GRAD_REL[key], "state": GRAD_REL["float32"]}})
    return worst


def phase_decode(stp, card: str):
    """The stateful cell's decode: MatrixLSTMCell(384, 12, step_kernel=
    "step--pallas") of vil-det-192's width, in eval, weights from seed 0,
    perturbed ifgates, float32.  DECODE_TOKENS tokens one at a time with
    ``state=`` from zeros, each exactly one step-kernel launch; h of every
    token and the final (C, n) against one stateful call over the tokens
    (GRAD_REL["float32"] of each output's largest |value|).  Then the time
    of a decode per token (host clock around the loop, ending in a
    synchronise), and the kernel's and the plain step's time per call."""
    import torch

    from xlstm_yolo_tpu_torch.nn.layers import MatrixLSTMCell, reset_parameters
    from xlstm_yolo_tpu_torch.ops.mlstm_recurrent import mlstm_siging_step

    cell = MatrixLSTMCell(H, NH, step_kernel="step--pallas")
    reset_parameters(cell, torch.Generator().manual_seed(0))
    perturb_ifgates(cell, seed=9)
    cell = cell.cuda().eval()
    g = torch.Generator().manual_seed(10)
    q, k, v = (torch.randn(B, DECODE_TOKENS, H, generator=g).cuda() for _ in range(3))
    zeros = (torch.zeros(B, NH, DH, DH, device="cuda"), torch.zeros(B, NH, DH, device="cuda"))

    def decode():
        hs, st = [], zeros
        for t in range(DECODE_TOKENS):
            h, st = cell(q[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1], state=st)
            hs.append(h)
        return torch.cat(hs, 1), st

    with torch.inference_mode():
        stp.LAUNCHES = 0
        h_dec, (c_dec, n_dec) = decode()
        torch.cuda.synchronize()
        launches = stp.LAUNCHES
        h_all, (c_all, n_all) = cell(q, k, v, state=zeros)
        errs = compare_outputs("decode vs the stateful forward", (h_dec, c_dec, n_dec),
                               (h_all, c_all, n_all), GRAD_REL["float32"])
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) / DECODE_TOKENS * 1e6)
    per_call = {}
    for key, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        args = step_inputs(dtype, "open", seed=11)
        kern = lambda: stp.mlstm_siging_step_kernel(*args, eps=EPS)  # noqa: E731
        plain = lambda: mlstm_siging_step(*args, eps=EPS)  # noqa: E731
        t_plain = time_cuda(plain, iters=50, reps=3)
        t_kern = time_cuda(kern, iters=200, reps=3) + time_cuda(kern, iters=200, reps=3)
        t_plain += time_cuda(plain, iters=50, reps=3)
        per_call[key] = {"ms": statistics.median(t_kern), "plain_ms": statistics.median(t_plain),
                         **dict(zip(("bound_ms", "bound_by"), step_bound(dtype.itemsize))),
                         "ms_runs": t_kern, "plain_ms_runs": t_plain}
    out = {"launches": launches, "max_abs_err": errs[0], "max_rel_err": errs[1],
           "us_per_token": statistics.median(runs), "us_per_token_runs": runs,
           "per_call": per_call}
    emit({"phase": "decode", "card": card, "cell": f"MatrixLSTMCell({H}, {NH})",
          "step_kernel": "step--pallas", "batch": B, "tokens": DECODE_TOKENS,
          "dtype": "float32", **out, "rel_tol": GRAD_REL["float32"],
          "note": "us_per_token: host clock around a decode of 64 tokens (the whole cell: "
                  "ifgate, heads, step kernel, outnorm) ending in a synchronise, 5 runs; "
                  "per_call: CUDA events around 200 step-kernel calls (50 plain calls), "
                  "in turns plain, kernel, kernel, plain"})
    if launches != DECODE_TOKENS:
        raise AssertionError(f"the decode made {launches} step-kernel launches, expected "
                             f"{DECODE_TOKENS}")
    return out


def phase_refusal(pk):
    """The quadratic route has no predict path (the JAX package's inference
    wrapper fails on it): YOLO(..., chunkwise_kernel=PAR).predict raises the
    port's ValueError naming the kernel, and nothing else."""
    import torch

    from xlstm_yolo_tpu_torch.engine.model import YOLO

    yolo = YOLO("vil-det-tiny.yaml", device="cuda", compute_dtype=torch.bfloat16,
                chunkwise_kernel=PAR)
    try:
        yolo.predict(synthetic_images(2, seed=12), batch=2)
    except ValueError as exc:
        if "mlstm_siging_parallel_kernel returned no (h, state) pair" not in str(exc):
            raise
        emit({"phase": "refusal", "chunkwise_kernel": PAR, "error": str(exc)})
        return
    raise AssertionError("predict on the quadratic route was not refused")


def phase_parallel_times(pk, card: str, plan):
    """Per-call times of the three quadratic kernels (bf16 streams and
    products) at each padded S of the route beside their plain versions (in
    slices of batch * head, plain_in_slices, timed as a whole) and bounds,
    in turns plain, kernel, kernel, plain."""
    import torch

    per = {k: {} for k in PAR_KERNELS}
    for S in sorted({S for S, _ in plan["train"]}):
        args, dh = par_inputs(S, torch.bfloat16, seed=S + 2)
        _, den = pk.parallel_fw(*args)
        bw = (*args, den, dh)
        pairs = {"parallel_fw": (lambda: pk.parallel_fw(*args),
                                 lambda: plain_in_slices(pk.parallel_fw_plain, args, S)),
                 "parallel_bw_dq": (lambda: pk.parallel_bw_dq(*bw),
                                    lambda: plain_in_slices(pk.parallel_bw_dq_plain, bw, S)),
                 "parallel_bw_dkv": (lambda: pk.parallel_bw_dkv(*bw),
                                     lambda: plain_in_slices(pk.parallel_bw_dkv_plain, bw, S))}
        for name, (kern, plain) in pairs.items():
            t_plain = time_cuda(plain, iters=1, reps=2, warm_s=0.0)
            t_kern = time_cuda(kern, iters=3, reps=3, warm_s=0.2) + time_cuda(kern, iters=3, reps=3,
                                                                              warm_s=0.0)
            t_plain += time_cuda(plain, iters=1, reps=2, warm_s=0.0)
            row = {"ms": statistics.median(t_kern), "plain_ms": statistics.median(t_plain),
                   **dict(zip(("bound_ms", "bound_by"), parallel_bound(name, S)))}
            per[name][S] = row
            emit({"phase": "times", "what": name, "card": card, "B": B, "S": S,
                  "dtype": "bfloat16", "calls_per_step": sum(
                      n for (s, _), n in plan["train"].items() if s == S) + (sum(
                          n for (s, _), n in plan["remat"].items() if s == S)
                          if name == "parallel_fw" else 0),
                  **row, "ms_runs": t_kern, "plain_ms_runs": t_plain})
        del args, dh, den, bw, pairs
    return per


def time_step(step, state, batch, windows: int):
    """Median ms of a train step over ``windows`` windows of 2 steps after
    a warm-up of >= 3 s (host clock ending in a synchronise), the windows,
    the peak memory, the clocks, and a torch.profiler trace of one step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    box = [state]

    def one_step():
        box[0], _ = step(box[0], batch, torch.Generator().manual_seed(9))

    t0, n = time.perf_counter(), 0
    while n < 3 or time.perf_counter() - t0 < 3.0:
        one_step()
        torch.cuda.synchronize()
        n += 1
    runs = []
    torch.cuda.reset_peak_memory_stats()
    with ClockSampler() as clocks:
        for _ in range(windows):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(2):
                one_step()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t) / 2 * 1e3)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        one_step()
        end.record()
        torch.cuda.synchronize()
    return {"step_ms": statistics.median(runs), "step_ms_runs": runs, "warmup_steps": n,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "clocks_during_step_timing": clocks.summary, "clock_samples": clocks.summary_n,
            **device_busy(prof, start.elapsed_time(end))}


def phase_v1_times(v1, cw, card: str, plan, yolo_v1, device="cuda"):
    """Per-call times of the v1 kernels (bf16) at each (S, L) of the route
    beside their plain versions and bounds; the two backward designs at the
    same chunk, L = 64 (v1: the dC scan, then chunk-parallel dq/dk/dv; v2:
    one serial pass); and the v1 predict forward on device input."""
    import torch

    from xlstm_yolo_tpu_torch.engine.predictor import DetectionPredictor

    shapes = sorted(set(plan["train"]) | set(plan["infer"]))
    per = {k: {} for k in V1_KERNELS}
    for S, L in shapes:
        infer = (S, L) in plan["infer"]
        args, dh, _ = v1_inputs(S, torch.bfloat16, states=infer, seed=S, device=device)
        kw = dict(chunk_size=L, eps=EPS)
        _, den, cs, *_ = v1.chunkwise_fw(*args, **kw)
        q, k, v, i, f = args[:5]
        dcs, _ = v1.chunkwise_bw_dc(q, f, dh, den, **kw)
        pairs = {"chunkwise_v1_fw": (lambda: v1.chunkwise_fw(*args, **kw),
                                     lambda: v1.chunkwise_fw_plain(*args, **kw))}
        if (S, L) in plan["train"]:
            pairs["chunkwise_v1_bw_dc"] = (
                lambda: v1.chunkwise_bw_dc(q, f, dh, den, **kw),
                lambda: v1.chunkwise_bw_dc_plain(q, f, dh, den, **kw))
            pairs["chunkwise_v1_bw_dqkv"] = (
                lambda: v1.chunkwise_bw_dqkv(q, k, v, i, f, cs, den, dh, dcs, **kw),
                lambda: v1.chunkwise_bw_dqkv_plain(q, k, v, i, f, cs, den, dh, dcs, **kw))
        for name, (kern, plain) in pairs.items():
            t_plain = time_cuda(plain, iters=2, reps=2)
            t_kern = time_cuda(kern, iters=10, reps=3) + time_cuda(kern, iters=10, reps=3)
            t_plain += time_cuda(plain, iters=2, reps=2)
            row = {"ms": statistics.median(t_kern), "plain_ms": statistics.median(t_plain),
                   **dict(zip(("bound_ms", "bound_by"),
                              v1_bound(name, S, L, states=infer and name == "chunkwise_v1_fw")))}
            per[name][(S, L)] = row
            emit({"phase": "times", "what": name, "card": card, "B": B, "S": S, "L": L,
                  "dtype": "bfloat16", "calls_per_forward": plan["infer"].get((S, L), 0),
                  "calls_per_step": (plan["train"].get((S, L), 0)
                                     + (plan["remat"].get((S, L), 0) if "fw" in name else 0)),
                  **row, "ms_runs": t_kern, "plain_ms_runs": t_plain})
        del args, dh, den, cs, dcs, pairs

    # the same work on both backward designs at L = 64 (448: 400 padded to whole chunks)
    for S in (6400, 1600, 448):
        args, dh, _ = v1_inputs(S, torch.bfloat16, seed=S + 1, device=device)
        kw = dict(chunk_size=64, eps=EPS)
        _, den, cs, *_ = v1.chunkwise_fw(*args, **kw)
        q, k, v, i, f = args[:5]
        bsh = lambda x: x.transpose(1, 2).reshape(B, S, H).contiguous()  # noqa: E731
        qb, kb, vb, dhb = map(bsh, (q, k, v, dh))
        ib, fb = i.transpose(1, 2).contiguous(), f.transpose(1, 2).contiguous()
        _, _, (cs2, _, den2) = cw.mlstm_siging_chunkwise_fw_train(qb, kb, vb, ib, fb, NH, eps=EPS)

        dcs, _ = v1.chunkwise_bw_dc(q, f, dh, den, **kw)

        def v1_bw():
            v1_dc()
            v1_dqkv()

        def v1_dc():
            v1.chunkwise_bw_dc(q, f, dh, den, **kw)

        def v1_dqkv():
            v1.chunkwise_bw_dqkv(q, k, v, i, f, cs, den, dh, dcs, **kw)

        def v2_bw():
            cw.mlstm_siging_chunkwise_bw(qb, kb, vb, ib, fb, NH, cs2, den2, dhb, eps=EPS)

        t = {"v2": time_cuda(v2_bw, iters=10, reps=3), "v1": time_cuda(v1_bw, iters=10, reps=3)}
        t["v1"] += time_cuda(v1_bw, iters=10, reps=3)
        t["v2"] += time_cuda(v2_bw, iters=10, reps=3)
        split = {"v1_dc_scan_ms": statistics.median(time_cuda(v1_dc, iters=10, reps=3)),
                 "v1_dqkv_ms": statistics.median(time_cuda(v1_dqkv, iters=10, reps=3))}
        emit({"phase": "times", "what": "backward_designs_at_L64", "card": card, "B": B, "S": S,
              "L": 64, "dtype": "bfloat16", "v1_chunk_parallel_ms": statistics.median(t["v1"]),
              "v2_serial_ms": statistics.median(t["v2"]), **split, "v1_runs": t["v1"],
              "v2_runs": t["v2"],
              "note": "v1: chunkwise_v1_bw_dc + chunkwise_v1_bw_dqkv (f32 dq/dk/dv; the gate "
                      "gradients and casts not included); v2: chunkwise_bw (dq/dk/dv in bf16)"})
        del args, dh, den, cs, dcs, qb, kb, vb, dhb, ib, fb, cs2, den2

    predictor = DetectionPredictor({"imgsz": yolo_v1.imgsz, "batch": B}, yolo_v1.model,
                                   yolo_v1.names)
    batch = predictor.preprocess(synthetic_images(B, seed=6))
    with ClockSampler() as clocks:
        runs = time_cuda(lambda: predictor.forward(batch), iters=3, reps=5, warm_s=2.0)
    emit({"phase": "times", "what": "predict_v1", "card": card, "cfg": "vil-det-192",
          "chunkwise_kernel": V1, "imgsz": 640, "batch": B, "dtype": "bfloat16",
          "forward_ms": statistics.median(runs), "forward_ms_runs": runs,
          "img_per_s_device_input": B / statistics.median(runs) * 1e3,
          "clocks_during_forward_timing": clocks.summary, "clock_samples": clocks.summary_n,
          "note": "normalise + forward + top-k on a letterboxed uint8 batch on the card, 5 "
                  "windows of 3 forwards after 2 s of warm-up"})

    return per


def phase_exp_times(ex, card: str, plan, yolo_exp, yolo_v2, device="cuda"):
    """Per-call times of the exp kernels (bf16) at each (S, L) of the route
    beside their plain versions and bounds (the predict variant of the
    forward at the inference segments, the training variant at the padded
    training lengths); the exp and v2 predict forwards on device input in
    turns (v2, exp, exp, v2); a trace of three exp forwards (busy share); and
    the share of the exp forward taken by its recurrent tails (each tail
    timed between two synchronises, in an instrumented forward)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from xlstm_yolo_tpu_torch.engine.predictor import DetectionPredictor
    from xlstm_yolo_tpu_torch.ops import backend

    shapes = sorted(set(plan["train"]) | set(plan["infer"]))
    per = {k: {} for k in EXP_KERNELS}
    for S, L in shapes:
        infer = (S, L) in plan["infer"]
        args, dh, _ = exp_inputs(S, torch.bfloat16, states=infer, seed=S, device=device)
        kw = dict(chunk_size=L, eps=EPS)
        _, den, mc, cs, ms, (_, _, m_last) = ex.chunkwise_exp_fw(*args, **kw)
        q, k, v, i, f = args[:5]
        mrow_dc, mrow_qkv = ex.m_rows(f, ms, m_last, L)
        dcs, _ = ex.chunkwise_exp_bw_dc(q, f, dh, den, mc, mrow_dc, **kw)
        fw_kw = dict(kw, save_states=not infer)
        pairs = {"chunkwise_exp_fw": (lambda: ex.chunkwise_exp_fw(*args, **fw_kw),
                                      lambda: ex.chunkwise_exp_fw_plain(*args, **fw_kw))}
        if (S, L) in plan["train"]:
            pairs["chunkwise_exp_bw_dc"] = (
                lambda: ex.chunkwise_exp_bw_dc(q, f, dh, den, mc, mrow_dc, **kw),
                lambda: ex.chunkwise_exp_bw_dc_plain(q, f, dh, den, mc, mrow_dc, **kw))
            pairs["chunkwise_exp_bw_dqkv"] = (
                lambda: ex.chunkwise_exp_bw_dqkv(q, k, v, i, f, cs, den, mc, mrow_qkv, dh, dcs,
                                                 **kw),
                lambda: ex.chunkwise_exp_bw_dqkv_plain(q, k, v, i, f, cs, den, mc, mrow_qkv, dh,
                                                       dcs, **kw))
        for name, (kern, plain) in pairs.items():
            t_plain = time_cuda(plain, iters=2, reps=2)
            t_kern = time_cuda(kern, iters=10, reps=3) + time_cuda(kern, iters=10, reps=3)
            t_plain += time_cuda(plain, iters=2, reps=2)
            fw = name == "chunkwise_exp_fw"
            row = {"ms": statistics.median(t_kern), "plain_ms": statistics.median(t_plain),
                   **dict(zip(("bound_ms", "bound_by"),
                              v1_bound(name, S, L, states=infer and fw, save=not infer)))}
            per[name][(S, L)] = row
            emit({"phase": "times", "what": name, "card": card, "B": B, "S": S, "L": L,
                  "dtype": "bfloat16", "variant": ("predict" if infer else "train") if fw else "",
                  "calls_per_forward": plan["infer"].get((S, L), 0),
                  "calls_per_step": (plan["train"].get((S, L), 0)
                                     + (plan["remat"].get((S, L), 0) if fw else 0)),
                  **row, "ms_runs": t_kern, "plain_ms_runs": t_plain})
        del args, dh, den, mc, cs, ms, dcs, pairs

    preds = {route: DetectionPredictor({"imgsz": y.imgsz, "batch": B}, y.model, y.names)
             for route, y in (("v2", yolo_v2), ("exp", yolo_exp))}
    batch = preds["exp"].preprocess(synthetic_images(B, seed=6))
    fwd_ms = {}
    with ClockSampler() as clocks:
        for route in ("v2", "exp", "exp", "v2"):
            fwd_ms.setdefault(route, []).extend(
                time_cuda(lambda: preds[route].forward(batch), iters=3, reps=3, warm_s=1.0))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(3):
            preds["exp"].forward(batch)
        end.record()
        torch.cuda.synchronize()
    busy = device_busy(prof, start.elapsed_time(end))

    reg = backend._REGISTRY["sequence"]
    seq, tails = reg["native"], []

    def timed_tail(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = seq(*a, **kw)
        torch.cuda.synchronize()
        tails.append((time.perf_counter() - t) * 1e3)
        return out
    reg["native"] = timed_tail
    try:
        fwd_instr = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            preds["exp"].forward(batch)
            torch.cuda.synchronize()
            fwd_instr.append((time.perf_counter() - t) * 1e3)
    finally:
        reg["native"] = seq
    n_tails = len(tails) // 3
    tail_ms = [sum(tails[j * n_tails:(j + 1) * n_tails]) for j in range(3)]
    out = {"forward_ms": {r: statistics.median(t) for r, t in fwd_ms.items()},
           "forward_ms_runs": fwd_ms,
           "img_per_s_device_input": {r: B / statistics.median(t) * 1e3 for r, t in fwd_ms.items()},
           "tails_per_forward": n_tails, "tail_ms_per_forward": tail_ms,
           "instrumented_forward_ms": fwd_instr,
           "tail_share": statistics.median(a / b for a, b in zip(tail_ms, fwd_instr)),
           "exp_trace": {k: v for k, v in busy.items() if k != "top"},
           "exp_trace_top": busy.get("top", [])[:10]}
    emit({"phase": "times", "what": "predict_exp", "card": card, "cfg": "vil-det-192",
          "chunkwise_kernel": EXP, "imgsz": 640, "batch": B, "dtype": "bfloat16", **out,
          "clocks_during_forward_timing": clocks.summary, "clock_samples": clocks.summary_n,
          "note": "normalise + forward + top-k on a letterboxed uint8 batch on the card; "
                  "routes in turns v2, exp, exp, v2, 3 windows of 3 forwards each after 1 s of "
                  "warm-up; busy share from a trace of 3 exp forwards; tails timed between "
                  "synchronises in 3 instrumented forwards"})
    return per, out


def phase_step_times(card: str, routes):
    """The train step of each route in turns (v2, v1, exp, parallel,
    parallel, exp, v1, v2), each with the device's busy share from a trace
    of one step."""
    steps_ms = {}
    for route in ("v2", "v1", "exp", "parallel", "parallel", "exp", "v1", "v2"):
        _, state, step, batch = routes[route]
        r = time_step(step, state, batch, windows=2)
        steps_ms.setdefault(route, []).append(r)
        emit({"phase": "times", "what": "train_step", "route": route, "card": card,
              "cfg": "vil-det-192", "imgsz": 640, "batch": B, "compute_dtype": "bfloat16",
              **{k: v for k, v in r.items() if k != "top"}, "top": r.get("top", [])[:8],
              "note": "host clock around 2 steps ending in a synchronise, 2 windows after a "
                      ">= 3 s warm-up; busy share from a torch.profiler trace of one step; "
                      "routes timed in turns v2, v1, exp, parallel, parallel, exp, v1, v2"})
    return steps_ms


def phase_times(cw, yolo, card: str):
    import torch

    from xlstm_yolo_tpu_torch.engine.predictor import DetectionPredictor

    per_s = {}
    for S in SEQ_LENS:
        args = kernel_inputs(S, torch.bfloat16, seed=S)
        plain = lambda: cw.mlstm_siging_chunkwise_fw_plain(*args, eps=EPS)
        kern = lambda: cw.mlstm_siging_chunkwise_fw(*args, eps=EPS)
        # plain, kernel, kernel, plain: a drift of the card shows as a spread
        t_plain = time_cuda(plain, iters=3, reps=3)
        t_kern = time_cuda(kern, iters=20) + time_cuda(kern, iters=20)
        t_plain += time_cuda(plain, iters=3, reps=3)
        per_s[S] = {"ms": statistics.median(t_kern), "plain_ms": statistics.median(t_plain),
                    **dict(zip(("bound_ms", "bound_by"), bound(S)))}
        emit({"phase": "times", "what": "chunkwise_fw", "card": card, "B": B, "S": S, "NH": NH,
              "DH": DH, "dtype": "bfloat16", **per_s[S], "ms_runs": t_kern,
              "plain_ms_runs": t_plain})

    predictor = DetectionPredictor({"imgsz": 640, "batch": B}, yolo.model, yolo.names)
    batch = predictor.preprocess(synthetic_images(B, seed=6))  # device-resident uint8
    fwd = lambda: predictor.forward(batch)
    with ClockSampler() as clocks:
        t_fwd_runs = time_cuda(fwd, iters=5, reps=9, warm_s=3.0)
    t_fwd = statistics.median(t_fwd_runs)
    images = synthetic_images(4 * B, seed=7)
    predictor(images[:B])  # warm the letterbox sizes of the host path
    t0 = time.perf_counter()
    predictor(images)
    t_host = time.perf_counter() - t0
    emit({"phase": "times", "what": "predict", "card": card, "cfg": "vil-det-192", "imgsz": 640,
          "batch": B, "dtype": "bfloat16", "forward_ms": t_fwd,
          "forward_ms_runs": t_fwd_runs,
          "img_per_s_device_input": B / t_fwd * 1e3,
          "img_per_s_device_input_range": [B / max(t_fwd_runs) * 1e3, B / min(t_fwd_runs) * 1e3],
          "img_per_s_from_numpy": len(images) / t_host,
          "clocks_during_forward_timing": clocks.summary, "clock_samples": clocks.summary_n,
          "note": "device input: normalise + forward + top-k on a letterboxed uint8 "
                  "batch already on the card, 9 windows of 5 forwards after 3 s of "
                  "warm-up; from numpy: letterbox + copy + forward + postprocess for "
                  "32 images"})

    # where the device time of three forwards goes (torch.profiler trace)
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(3):
            fwd()
        end.record()
        torch.cuda.synchronize()
    emit({"phase": "times", "what": "forward_breakdown", "card": card, "forwards": 3,
          "forward_ms_unprofiled": t_fwd, **device_busy(prof, start.elapsed_time(end))})
    return per_s


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 2
    try:
        from xlstm_yolo_tpu_torch.engine import steps
        from xlstm_yolo_tpu_torch.engine.model import YOLO
        from xlstm_yolo_tpu_torch.ops import chunkwise as v1
        from xlstm_yolo_tpu_torch.ops import chunkwise_exp as ex
        from xlstm_yolo_tpu_torch.ops import chunkwise_v2 as cw
        from xlstm_yolo_tpu_torch.ops import cuda_build
        from xlstm_yolo_tpu_torch.ops import epilogue as epi
        from xlstm_yolo_tpu_torch.ops import ffn
        from xlstm_yolo_tpu_torch.ops import parallel as pk
        from xlstm_yolo_tpu_torch.ops import step as stp
    except ImportError as exc:
        print(f"chip_smoke: the xlstm_yolo_tpu_torch package is missing ({exc})",
              file=sys.stderr)
        return 2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = cuda_build.build_all()
    emit({"phase": "setup", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "card": card,
          "build_s": time.perf_counter() - t0,
          "libraries": {k: v["library"].name for k, v in built.items()},
          "ptxas": {k: [ln.strip() for ln in v["log"].splitlines() if "registers" in ln]
                    for k, v in built.items()}})

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        emit({"phase": name, "seconds": time.perf_counter() - t})
        return out

    worst = timed("kernel", phase_kernel, cw)
    timed("model", phase_model, cw, "vil-det-192.yaml", B, 640, launches_expected=20)
    timed("model", phase_model, cw, "vil-det-tiny.yaml", 2, 160, launches_expected=14)
    yolo = YOLO("vil-det-192.yaml", device="cuda", compute_dtype=torch.bfloat16)
    perturb_ifgates(yolo.model, seed=8)
    launches = timed("predict", phase_predict, cw, yolo)
    worst_train = timed("train_kernels", phase_train_kernels, cw, epi, ffn)
    timed("replay", phase_replay, cw, epi, ffn, steps)
    timed("e2e_grads", phase_e2e_grads, steps)
    model, state, step, batch, train_launches = timed("train", phase_train, cw, epi, ffn, steps)
    yolo_v1 = YOLO("vil-det-192.yaml", device="cuda", compute_dtype=torch.bfloat16,
                   chunkwise_kernel=V1)
    perturb_ifgates(yolo_v1.model, seed=8)
    plan = v1_plan(yolo_v1.model)
    shapes = [(k, True) for k in sorted(plan["infer"])] + [(k, False) for k in sorted(plan["train"])]
    worst_v1 = timed("v1_kernels", phase_v1_kernels, v1, shapes)
    v1_predict_launches = timed("v1_predict", phase_v1_predict, v1, cw, yolo_v1)
    v1_model, v1_state, v1_step, v1_batch, v1_launches = timed(
        "v1_train", phase_v1_train, v1, cw, epi, ffn, steps)
    yolo_exp = YOLO("vil-det-192.yaml", device="cuda", compute_dtype=torch.bfloat16,
                    chunkwise_kernel=EXP)
    perturb_ifgates(yolo_exp.model, seed=8)
    if v1_plan(yolo_exp.model) != plan:
        raise AssertionError("the exp route's segment plan differs from the v1 route's")
    worst_exp = timed("exp_kernels", phase_exp_kernels, ex, shapes)
    exp_predict_launches = timed("exp_predict", phase_exp_predict, ex, v1, cw, yolo_exp)
    exp_model, exp_state, exp_step, exp_batch, exp_launches, exp_per_step = timed(
        "exp_train", phase_exp_train, ex, v1, cw, epi, ffn, steps)
    timed("exp_grads", phase_exp_grads, ex, steps)
    par_lengths = sorted({S for S, _ in plan["train"]})
    worst_par = timed("parallel_kernels", phase_parallel_kernels, pk, par_lengths)
    par_model, par_state, par_step, par_batch, par_launches, par_per_step = timed(
        "parallel_train", phase_parallel_train, pk, ex, v1, cw, epi, ffn, steps)
    if v1_plan(par_model)["train"] != plan["train"]:
        raise AssertionError("the quadratic route's padded lengths differ from the v1 route's")
    timed("parallel_grads", phase_parallel_grads, pk, steps)
    worst_step = timed("step_kernel", phase_step_kernel, stp)
    decode = timed("decode", phase_decode, stp, card)
    timed("refusal", phase_refusal, pk)
    per_s = timed("times", phase_times, cw, yolo, card)
    per_exp, exp_fwd = timed("exp_times", phase_exp_times, ex, card, plan, yolo_exp, yolo)
    del yolo
    per_train = timed("train_times", phase_train_times, cw, epi, ffn, card)
    per_v1 = timed("v1_times", phase_v1_times, v1, cw, card, plan, yolo_v1)
    per_par = timed("parallel_times", phase_parallel_times, pk, card, plan)
    steps_ms = timed("step_times", phase_step_times, card, {
        "v2": (model, state, step, batch), "v1": (v1_model, v1_state, v1_step, v1_batch),
        "exp": (exp_model, exp_state, exp_step, exp_batch),
        "parallel": (par_model, par_state, par_step, par_batch)})

    per_fwd = lambda key: sum(LAUNCHES_PER_S[S] * per_s[S][key] for S in SEQ_LENS)
    calls = expected_step_launches(model)
    per_step_s = {name: dict(LAUNCHES_PER_S) for name in KERNELS}
    per_step_s["chunkwise_fw_train"][6400] += calls["chunkwise_fw_train"] - calls["chunkwise_bw"]
    per_step = lambda name, key: sum(per_step_s[name][S] * per_train[name][S][key]
                                     for S in SEQ_LENS)
    pallas = "xlstm_yolo_tpu/ops/pallas"
    sources = {"chunkwise_fw_train": ("chunkwise_fw.cu", f"{pallas}/chunkwise_v2.py:238"),
               "chunkwise_bw": ("chunkwise_bw.cu", f"{pallas}/chunkwise_v2.py:446"),
               "epilogue_bw": ("epilogue_bw.cu", f"{pallas}/epilogue.py:70"),
               "ffn_bw": ("ffn_bw.cu", f"{pallas}/ffn.py:53")}
    rows = [{
        "name": "chunkwise_fw",
        "route": "cuda",
        "source": "xlstm_yolo_tpu_torch/csrc/chunkwise_fw.cu",
        "replaces": "xlstm_yolo_tpu/ops/pallas/chunkwise_v2.py:245",
        "launches": launches,
        "max_abs_err": worst["bfloat16"],
        "ms": per_fwd("ms"),
        "plain_ms": per_fwd("plain_ms"),
        "bound_ms": per_fwd("bound_ms"),
        "bound_by": per_s[6400]["bound_by"],  # S = 6400 holds two thirds of the bound
        "library_ms": None,
        "note": "predict path; times are per vil-det-192 forward at batch 8, bf16: the 20 "
                "calls (4 at S=6400, 6 at 1600, 6 at 400, 4 at 100) summed; max_abs_err is "
                f"the largest bf16 kernel-vs-plain |h| error (f32: {worst['float32']:.3g})",
    }]
    for name in KERNELS:
        src, replaces = sources[name]
        rows.append({
            "name": name, "route": "cuda", "source": f"xlstm_yolo_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": train_launches[name],
            "max_abs_err": worst_train[name]["bfloat16"][0],
            "ms": per_step(name, "ms"), "plain_ms": per_step(name, "plain_ms"),
            "bound_ms": per_step(name, "bound_ms"),
            "bound_by": per_train[name][6400]["bound_by"], "library_ms": None,
            "max_rel_err": worst_train[name]["bfloat16"][1],
            "max_rel_err_float32": worst_train[name]["float32"][1],
            "note": f"train path; launches over {TRAIN_STEPS} vil-det-192 steps at batch 8, "
                    f"bf16 ({calls[name]} per step); times per step: the calls at each S "
                    f"({per_step_s[name]}) summed; max_abs_err is the largest bf16 "
                    "kernel-vs-plain error over all outputs (max_rel_err: over the output's "
                    "largest |value|)",
        })
    v1_sources = {"chunkwise_v1_fw": ("chunkwise_v1_fw.cu", f"{pallas}/chunkwise.py:96"),
                  "chunkwise_v1_bw_dc": ("chunkwise_v1_bw.cu", f"{pallas}/chunkwise.py:271"),
                  "chunkwise_v1_bw_dqkv": ("chunkwise_v1_bw.cu", f"{pallas}/chunkwise.py:316")}
    step_calls = {"chunkwise_v1_fw": {k: n + plan["remat"].get(k, 0)
                                      for k, n in plan["train"].items()},
                  "chunkwise_v1_bw_dc": plan["train"], "chunkwise_v1_bw_dqkv": plan["train"]}
    per_v1_step = lambda name, key: sum(n * per_v1[name][k][key]  # noqa: E731
                                    for k, n in step_calls[name].items())
    v1_fwd = lambda key: sum(n * per_v1["chunkwise_v1_fw"][k][key]  # noqa: E731
                             for k, n in plan["infer"].items())
    for name in V1_KERNELS:
        src, replaces = v1_sources[name]
        big = max(step_calls[name])
        extra = (f"; per vil-det-192 forward in predict ({sum(plan['infer'].values())} calls "
                 f"at {sorted(plan['infer'])}): {v1_fwd('ms'):.4g} ms, plain "
                 f"{v1_fwd('plain_ms'):.4g}, bound {v1_fwd('bound_ms'):.4g}; launches: "
                 f"{v1_predict_launches} in the v1 predict of 10 images + "
                 f"{v1_launches[name]} in {TRAIN_STEPS} v1 train steps"
                 if name == "chunkwise_v1_fw" else "")
        rows.append({
            "name": name, "route": "cuda", "source": f"xlstm_yolo_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": v1_launches[name] + (v1_predict_launches if name == "chunkwise_v1_fw"
                                             else 0),
            "max_abs_err": worst_v1[name]["bfloat16"][0],
            "ms": per_v1_step(name, "ms"), "plain_ms": per_v1_step(name, "plain_ms"),
            "bound_ms": per_v1_step(name, "bound_ms"), "bound_by": per_v1[name][big]["bound_by"],
            "library_ms": None,
            "max_rel_err": worst_v1[name]["bfloat16"][1],
            "max_rel_err_float32": worst_v1[name]["float32"][1],
            "note": f"v1 route (chunkwise_kernel={V1}); times per vil-det-192 train step at "
                    f"batch 8, bf16: the calls at each (S, L) ({step_calls[name]}) summed"
                    + extra,
        })
    exp_sources = {"chunkwise_exp_fw": ("chunkwise_exp_fw.cu", f"{pallas}/chunkwise_exp.py:55"),
                   "chunkwise_exp_bw_dc": ("chunkwise_exp_bw.cu",
                                           f"{pallas}/chunkwise_exp.py:284"),
                   "chunkwise_exp_bw_dqkv": ("chunkwise_exp_bw.cu",
                                             f"{pallas}/chunkwise_exp.py:330")}
    step_calls_exp = {name: {k: n + (plan["remat"].get(k, 0) if name == "chunkwise_exp_fw"
                                     else 0) for k, n in plan["train"].items()}
                      for name in EXP_KERNELS}
    per_exp_step = lambda name, key: sum(n * per_exp[name][k][key]  # noqa: E731
                                         for k, n in step_calls_exp[name].items())
    exp_fwd_sum = lambda key: sum(n * per_exp["chunkwise_exp_fw"][k][key]  # noqa: E731
                                  for k, n in plan["infer"].items())
    for name in EXP_KERNELS:
        src, replaces = exp_sources[name]
        big = max(step_calls_exp[name])
        fw = name == "chunkwise_exp_fw"
        extra = (f"; per vil-det-192 forward in predict ({sum(plan['infer'].values())} calls "
                 f"of the predict variant at {sorted(plan['infer'])}): {exp_fwd_sum('ms'):.4g} ms, "
                 f"plain {exp_fwd_sum('plain_ms'):.4g}, bound {exp_fwd_sum('bound_ms'):.4g}; "
                 f"launches: {exp_predict_launches} calls (two launches each: the state scan "
                 f"and h) in the exp predict of 10 images + {exp_launches[name]} in "
                 f"{TRAIN_STEPS} exp train steps" if fw else "")
        rows.append({
            "name": name, "route": "cuda", "source": f"xlstm_yolo_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": exp_launches[name] + (exp_predict_launches if fw else 0),
            "max_abs_err": worst_exp[name]["bfloat16"][0],
            "ms": per_exp_step(name, "ms"), "plain_ms": per_exp_step(name, "plain_ms"),
            "bound_ms": per_exp_step(name, "bound_ms"),
            "bound_by": per_exp[name][big]["bound_by"], "library_ms": None,
            "max_rel_err": worst_exp[name]["bfloat16"][1],
            "max_rel_err_float32": worst_exp[name]["float32"][1],
            "note": f"exp route (chunkwise_kernel={EXP}); times per vil-det-192 train step at "
                    f"batch 8, bf16: the calls at each (S, L) ({step_calls_exp[name]}; "
                    f"{exp_per_step[name]} per step) summed" + extra
                    + ("; the forward's errors are of h (den + eps), den, m_comb and the states"
                       if fw else ""),
        })
    par_sources = {"parallel_fw": ("parallel_fw.cu", f"{pallas}/parallel.py:48"),
                   "parallel_bw_dq": ("parallel_bw.cu", f"{pallas}/parallel.py:84"),
                   "parallel_bw_dkv": ("parallel_bw.cu", f"{pallas}/parallel.py:117")}
    par_calls = {name: {S: sum(n for (s, _), n in plan["train"].items() if s == S)
                        + (sum(n for (s, _), n in plan["remat"].items() if s == S)
                           if name == "parallel_fw" else 0) for S in par_lengths}
                 for name in PAR_KERNELS}
    per_par_step = lambda name, key: sum(n * per_par[name][S][key]  # noqa: E731
                                         for S, n in par_calls[name].items())
    for name in PAR_KERNELS:
        src, replaces = par_sources[name]
        rows.append({
            "name": name, "route": "cuda", "source": f"xlstm_yolo_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": par_launches[name],
            "max_abs_err": worst_par[name]["bfloat16"][0],
            "ms": per_par_step(name, "ms"), "plain_ms": per_par_step(name, "plain_ms"),
            "bound_ms": per_par_step(name, "bound_ms"),
            "bound_by": per_par[name][max(par_lengths)]["bound_by"], "library_ms": None,
            "max_rel_err": worst_par[name]["bfloat16"][1],
            "max_rel_err_float32": worst_par[name]["float32"][1],
            "note": f"quadratic route (chunkwise_kernel={PAR}); times per vil-det-192 train "
                    f"step at batch 8, bf16: the calls at each padded S ({par_calls[name]}; "
                    f"{par_per_step[name]} per step) summed; the plain version runs in slices "
                    "of batch * head; no single PyTorch call computes the function (its "
                    "max(|.|, 1) denominator is no softmax)",
        })
    step32 = decode["per_call"]["float32"]
    rows.append({
        "name": "mlstm_step", "route": "cuda", "source": "xlstm_yolo_tpu_torch/csrc/step.cu",
        "replaces": f"{pallas}/step.py:31", "launches": decode["launches"],
        "max_abs_err": worst_step["bfloat16"][0], "ms": step32["ms"],
        "plain_ms": step32["plain_ms"], "bound_ms": step32["bound_ms"],
        "bound_by": step32["bound_by"], "library_ms": None,
        "max_rel_err": worst_step["bfloat16"][1], "max_rel_err_float32": worst_step["float32"][1],
        "note": f"step--pallas; launches: one per token of the decode of {DECODE_TOKENS} tokens "
                f"(MatrixLSTMCell({H}, {NH}), batch 8, float32); times per call at B 8, NH 12, "
                f"DH 32, float32 (bfloat16: {decode['per_call']['bfloat16']['ms']:.4g} ms); the "
                f"decode takes {decode['us_per_token']:.4g} us per token through the whole cell",
    })
    step_line = {route: [r["step_ms"] for r in rs] for route, rs in steps_ms.items()}
    busy_line = {route: [r.get("busy_share") for r in rs] for route, rs in steps_ms.items()}
    emit({"phase": "times", "what": "train_step_routes", "card": card, "step_ms": step_line,
          "busy_share": busy_line,
          "device_ms": {route: [r.get("kernel_ms_total") for r in rs]
                        for route, rs in steps_ms.items()},
          "predict_forward_ms": exp_fwd["forward_ms"], "exp_tail_share": exp_fwd["tail_share"]})
    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
