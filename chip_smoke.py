"""Smoke run of the PyTorch port (xlstm_yolo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. setup     - print the card's name and power limit; build the four CUDA
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
9. times     - CUDA-event medians (and every window) of each kernel and its
               plain version at each S; the end-to-end predict rate and the
               train step's time (windows after a warm-up, SM clock and power
               sampled); torch.profiler traces of three forwards and of one
               train step: device time by kernel and the device's busy share
               of that same window.

Output: JSON lines per phase, the nvidia-smi line, one {"kernels": [...]}
line, and last {"ok": true, "device": {...}}.  Without a CUDA device, or
without the package beside this script, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import copy
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


def phase_train_times(cw, epi, ffn, card: str, model, state, step, batch):
    """Per-call times of the four training kernels at each S (bf16) with
    their plain versions, and the train step's time and breakdown."""
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

    # the train step: windows of 2 steps after a warm-up of >= 3 s, clocks sampled
    def one_step():
        nonlocal state
        state, _ = step(state, batch, torch.Generator().manual_seed(9))

    t0, n = time.perf_counter(), 0
    while n < 3 or time.perf_counter() - t0 < 3.0:
        one_step()
        torch.cuda.synchronize()
        n += 1
    runs = []
    torch.cuda.reset_peak_memory_stats()
    with ClockSampler() as clocks:
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(2):
                one_step()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t) / 2 * 1e3)
    step_ms = statistics.median(runs)
    emit({"phase": "times", "what": "train_step", "card": card, "cfg": "vil-det-192",
          "imgsz": 640, "batch": B, "compute_dtype": "bfloat16", "step_ms": step_ms,
          "step_ms_runs": runs, "img_per_s": B / step_ms * 1e3,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "clocks_during_step_timing": clocks.summary, "clock_samples": clocks.summary_n,
          "note": "host clock around 2 steps ending in a synchronise, 5 windows after "
                  f"{n} warm-up steps (>= 3 s); one step = forward, E2E loss, backward, "
                  "clip, AdEMAMix, EMA on a device-resident uint8 batch"})

    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        one_step()
        end.record()
        torch.cuda.synchronize()
    emit({"phase": "times", "what": "train_step_breakdown", "card": card, "steps": 1,
          "step_ms_unprofiled": step_ms, **device_busy(prof, start.elapsed_time(end))})
    return per


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
        from xlstm_yolo_tpu_torch.ops import chunkwise_v2 as cw
        from xlstm_yolo_tpu_torch.ops import cuda_build
        from xlstm_yolo_tpu_torch.ops import epilogue as epi
        from xlstm_yolo_tpu_torch.ops import ffn
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

    worst = phase_kernel(cw)
    phase_model(cw, "vil-det-192.yaml", B, 640, launches_expected=20)
    phase_model(cw, "vil-det-tiny.yaml", 2, 160, launches_expected=14)
    yolo = YOLO("vil-det-192.yaml", device="cuda", compute_dtype=torch.bfloat16)
    perturb_ifgates(yolo.model, seed=8)
    launches = phase_predict(cw, yolo)
    worst_train = phase_train_kernels(cw, epi, ffn)
    phase_replay(cw, epi, ffn, steps)
    phase_e2e_grads(steps)
    model, state, step, batch, train_launches = phase_train(cw, epi, ffn, steps)
    per_s = phase_times(cw, yolo, card)
    del yolo
    per_train = phase_train_times(cw, epi, ffn, card, model, state, step, batch)

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
    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
