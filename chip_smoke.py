"""Smoke run of the PyTorch port (xlstm_yolo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. setup   - print the card's name and power limit; build the CUDA kernel
             from csrc/ with nvcc (sm_90a) and print the build time;
2. kernel  - the chunkwise mLSTM kernel against its plain PyTorch version
             on the card at the flagship shapes (B 8, NH 12, DH 32,
             S 6400/1600/400/100 and a ragged 1000), float32 and bfloat16,
             with and without initial states, and with closed forget gates;
3. model   - vil-det-192 at 640 px, batch 8, and vil-det-tiny at 160 px,
             with random weights from a seed and perturbed ifgates (so no
             cell is inert), float32: one forward makes exactly 20 (tiny:
             14) kernel launches; each of those calls agrees with the plain
             version on the same inputs; and the decode-only output with
             the kernel is as close to a float64 forward of the same model
             as the output with the plain version is (see phase_model);
4. predict - the main path: YOLO("vil-det-192.yaml").predict() on synthetic
             images of several sizes in two batches (bf16); results are
             finite and in original image coordinates; the launch count of
             this run is what the kernels line reports;
5. times   - CUDA-event medians (and every window) of the kernel and the
             plain version at each S; the end-to-end predict rate at batch 8
             (bf16, device-resident input) with the SM clock and power sampled
             during its windows; and a torch.profiler trace of three
             forwards: device time by kernel, and the device's busy share
             of that same window.

Output: JSON lines per phase, the nvidia-smi line, one {"kernels": [...]}
line, and last {"ok": true, "device": {...}}.  Without a CUDA device, or
without the package beside this script, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOP_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
B, NH, DH = 8, 12, 32
H = NH * DH
SEQ_LENS = (6400, 1600, 400, 100)
LAUNCHES_PER_S = {6400: 4, 1600: 6, 400: 6, 100: 4}  # per vil-det-192 forward
EPS = 5e-5  # the model's cell eps
F32_TOL = 1e-4   # kernel vs plain, float32: sums in another order
BF16_TOL = 2e-2  # bfloat16 in, same rounded inputs on both sides; h rounded once
# float32 model forwards against a float64 one (phase_model): the kernel
# forward may be at most E2E_FACTOR times as far from it as the plain one
E2E_FACTOR = 2.0
E2E_ATOL = {"boxes": 1e-3, "scores": 1e-5}


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


def bound(S: int, itemsize: int = 2, L: int = 64) -> tuple[float, str]:
    """Least time for one call in ms, and what sets it: q, k, v read and h
    written once, the gates read once, the last states written once, over
    HBM bandwidth; against 4*B*NH*S*DH*(L+DH) chunkwise FLOP at the bf16
    peak."""
    nbytes = 4 * B * S * H * itemsize + 2 * B * S * NH * 4 + B * NH * (DH * DH + DH) * 4
    flops = 4 * B * NH * S * DH * (L + DH)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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
    import copy

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
        from xlstm_yolo_tpu_torch.engine.model import YOLO
        from xlstm_yolo_tpu_torch.ops import chunkwise_v2 as cw
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
    lib_path, log = cw.build_kernel()
    build_s = time.perf_counter() - t0
    emit({"phase": "setup", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "card": card, "kernel_library": lib_path.name,
          "build_s": build_s,
          "ptxas": [ln.strip() for ln in log.splitlines() if "registers" in ln]})

    worst = phase_kernel(cw)
    phase_model(cw, "vil-det-192.yaml", B, 640, launches_expected=20)
    phase_model(cw, "vil-det-tiny.yaml", 2, 160, launches_expected=14)
    yolo = YOLO("vil-det-192.yaml", device="cuda", compute_dtype=torch.bfloat16)
    perturb_ifgates(yolo.model, seed=8)
    launches = phase_predict(cw, yolo)
    per_s = phase_times(cw, yolo, card)

    per_fwd = lambda key: sum(LAUNCHES_PER_S[S] * per_s[S][key] for S in SEQ_LENS)
    print(card, flush=True)
    emit({"kernels": [{
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
        "note": "times are per vil-det-192 forward at batch 8, bf16: the 20 calls "
                "(4 at S=6400, 6 at 1600, 6 at 400, 4 at 100) summed; max_abs_err is the "
                f"largest bf16 kernel-vs-plain |h| error (f32: {worst['float32']:.3g})",
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
