"""Quick check of a set of the port's kernels on one GPU, from the root of
the repository:

    python3 scripts/kernels_check.py                 # the sLSTM scan and the step
    python3 scripts/kernels_check.py --times --root DIR --label parent
    python3 scripts/kernels_check.py --set chunkwise # the quadratic, v1 and exp kernels
    python3 scripts/kernels_check.py --set unwired   # fw3 and the TAL metric

Builds the set's sources, prints each kernel's registers and spills
(``nvcc -Xptxas -v``) and its tensor-core (HMMA) instructions, runs the set's
``cuda`` tests, then prints its times as JSON lines.  ``--times`` prints
only the times; ``--root`` takes the package from another checkout (an
unpacked parent commit, to time its kernels on the same card, in turns
parent, change, change, parent).  Exits non-zero without a card or when a
test fails.

``recurrent`` (the default): the sLSTM scan (``csrc/slstm.cu``) at B 3 and
8, NH 4, DH 8, 32, 48, 128 and 256 (the LM's call is B 8, S 128, DH 128),
S 128 and 2048, float32: the device ms a call from a torch.profiler trace
of 10 calls, the microseconds a step (device ms / S), the best of three
CUDA-event windows and the bound (chip_smoke.py's slstm_bound), and the
launch plan (CTAs a cluster, batch rows a cluster) where the package has
one; the one-token step (``csrc/step.cu``) at B 8 and each detector's heads
(NH 3 of DH 16, 12 of 32, 8 of 64, 6 of 128), float32 and bfloat16: the
device microseconds a call from a trace of 200 calls, the host's issue
time a call (host clock around 1000 calls, no synchronise), the call
window (CUDA events around 200 calls, as chip_smoke.py's step_times) and
the bound; and the decode's microseconds a token of MatrixLSTMCell(384,
12) and (768, 6) (chip_smoke.py's phase_decode: 64 tokens, host clock, 5
runs).  About a minute after the build.

``chunkwise``: the quadratic kernels and the v1 and exp chunkwise kernels:
one JSON line per detector's heads and S (6656 and 2048, batch 8, bf16):
the best of three CUDA-event windows of a call of the quadratic forward, dq
and dk/dv, and, at the route's chunk there (512 at 6656, 256 at 2048), of
the v1 and exp forwards (train: no initial state, the exp forward saving
its rows; predict: from initial states, the exp forward saving none), dC
scans and dq/dk/dv, the SM clock, the exps' floors and the bounds (this
checkout's chip_smoke.py helpers); then, per detector's heads, one line of
the v1 and exp forwards' and dC scans' best windows, and one of the device
ms a call of each of their kernels from a profiler trace, at every (S, L)
of the route's plan (chip_smoke.py's v1_plan of vil-det-192: the forwards
at the inference segments from initial states, the exp forward saving
nothing, and both at the padded training lengths, where the dC scans run).
A few minutes, where the full smoke takes ten.

``unwired``: the two kernels no path of the detector runs.  ``fw3``
(``csrc/chunkwise_fw3.cu``) at each (S, L, Lb) of chip_smoke.py's FW3_PATH,
batch 8, bf16 q/k/v and products, at vil-det-192's heads (12 of 32) and
vil-det-384's (6 of 128): one JSON line each with the best of three
CUDA-event windows of a call and the device ms a call of each of its
kernels from a profiler trace of 10 calls, for the inference and train
variants, the port's v2 forward (inference and train) on the same inputs
and, at S 6400, fw3 like for like at v2's L 64 (sub-chunks 32 and 64, both
variants), beside the bounds (chip_smoke.py's fw3_bound).  The TAL metric
(``csrc/tal_metric.cu``) at 640 px, batch 8, M 8 and 128, topk 10: the
device ms a call (trace of 10 calls), the call window (CUDA events around
20 calls, best of three) and the host's issue time a call (host clock
around 200 calls, no synchronise, best of three), and, where the package
has ``cluster_size``, the device ms with each cluster size.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SLSTM_SHAPES = [(B, DH, S) for B in (3, 8) for DH in (8, 32, 48, 128, 256) for S in (128, 2048)]
SLSTM_NH = 4
STEP_HEADS = ((3, 16), (12, 32), (8, 64), (6, 128))  # (NH, DH) at B 8
DECODE_WIDTHS = ((384, 12), (768, 6))  # MatrixLSTMCell(H, NH) of vil-det-192 and -384


def slstm_device_ms(cs, fn, calls: int = 10):
    """Device ms a call of the sLSTM kernel (any version: its name holds
    slstm_kernel), from chip_smoke.py's kernels_device_ms."""
    return cs.kernels_device_ms(fn, {"slstm_kernel": 1}, calls=calls)["slstm_kernel"]


def recurrent_times(cs, label: str):
    """The sLSTM scan's and the step's times (module docstring)."""
    import torch

    from xlstm_yolo_tpu_torch.ops import slstm as sk
    from xlstm_yolo_tpu_torch.ops import step as stp

    for B, DH, S in SLSTM_SHAPES:
        g = torch.Generator().manual_seed(B * DH + S)
        wx = torch.randn(B, S, 4, SLSTM_NH, DH, generator=g).cuda()
        R = torch.empty(4 * SLSTM_NH * DH, DH)
        torch.nn.init.orthogonal_(R, generator=g)
        R = R.reshape(4, SLSTM_NH, DH, DH).cuda()
        with torch.no_grad():
            fn = lambda: sk.slstm_sequence(wx, R)  # noqa: E731
            dev = slstm_device_ms(cs, fn)
            win = cs.time_cuda(fn, iters=3 if S > 128 else 20, reps=3, warm_s=0.1)
        row = {"root": label, "kernel": "slstm", "B": B, "NH": SLSTM_NH, "DH": DH, "S": S,
               "device_ms": dev, "us_per_step": dev * 1e3 / S if isinstance(dev, float) else dev,
               "window_ms": min(win),
               "bound_ms": cs.slstm_bound(B, S, SLSTM_NH, DH, False)[0]}
        if hasattr(sk, "plan"):
            row["plan"] = sk.plan(B, SLSTM_NH, DH)
        print(json.dumps(row), flush=True)
        del wx, R
    for NH, DH in STEP_HEADS:
        ws = cs.Widths(f"NH {NH}, DH {DH}", 8, NH, DH, NH * DH, 0)
        for dtype in (torch.float32, torch.bfloat16):
            args = cs.step_inputs(dtype, "open", seed=11, ws=ws)
            fn = lambda: stp.mlstm_siging_step_kernel(*args, eps=cs.EPS)  # noqa: E731
            dev = cs.kernels_device_ms(fn, {"step_kernel": 1}, calls=200)["step_kernel"]
            win = cs.time_cuda(fn, iters=200, reps=3, warm_s=0.2)
            issue = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(1000):
                    fn()
                issue.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
            print(json.dumps({
                "root": label, "kernel": "step", "B": 8, "NH": NH, "DH": DH,
                "dtype": str(dtype).split(".")[-1],
                "device_us": dev * 1e3 if isinstance(dev, float) else dev,
                "host_issue_us": min(issue), "host_issue_us_runs": issue,
                "window_us": min(win) * 1e3, "window_us_runs": [t * 1e3 for t in win],
                "bound_us": cs.step_bound(dtype.itemsize, ws=ws)[0] * 1e3}), flush=True)
            del args
    for H, NH in DECODE_WIDTHS:
        print(json.dumps({"root": label, "kernel": "decode", "cell": f"MatrixLSTMCell({H}, {NH})",
                          "batch": 8, "tokens": cs.DECODE_TOKENS,
                          "us_per_token_runs": decode_us(cs, stp, H, NH)}), flush=True)


def decode_us(cs, stp, H: int, NH: int) -> list:
    """Microseconds a token of a 64-token float32 decode of MatrixLSTMCell(H,
    NH, step_kernel="step--pallas") at batch 8 from zeros (host clock around
    the loop, ending in a synchronise; 5 runs), as chip_smoke.py's
    phase_decode; each run makes one step launch a token."""
    import torch

    from xlstm_yolo_tpu_torch.nn.layers import MatrixLSTMCell, reset_parameters

    DH = H // NH
    cell = MatrixLSTMCell(H, NH, step_kernel="step--pallas")
    reset_parameters(cell, torch.Generator().manual_seed(0))
    cs.perturb_ifgates(cell, seed=9)
    cell = cell.cuda().eval()
    g = torch.Generator().manual_seed(10)
    q, k, v = (torch.randn(8, cs.DECODE_TOKENS, H, generator=g).cuda() for _ in range(3))
    zeros = (torch.zeros(8, NH, DH, DH, device="cuda"), torch.zeros(8, NH, DH, device="cuda"))

    def decode():
        st = zeros
        for t in range(cs.DECODE_TOKENS):
            _, st = cell(q[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1], state=st)

    runs = []
    with torch.inference_mode():
        decode()
        for _ in range(5):
            torch.cuda.synchronize()
            before = stp.LAUNCHES
            t0 = time.perf_counter()
            decode()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) / cs.DECODE_TOKENS * 1e6)
            assert stp.LAUNCHES - before == cs.DECODE_TOKENS
    return runs


def chunkwise_times(cs, label: str):
    import torch

    from xlstm_yolo_tpu_torch.ops import chunkwise as v1
    from xlstm_yolo_tpu_torch.ops import chunkwise_exp as ex
    from xlstm_yolo_tpu_torch.ops import parallel as pk

    from xlstm_yolo_tpu_torch.engine.model import YOLO

    plan = cs.v1_plan(YOLO("vil-det-192.yaml", device="cpu", chunkwise_kernel=cs.V1).model)
    for ws in (cs.FLAGSHIP, *cs.WIDE):
        for S, L in ((6656, 512), (2048, 256)):
            args, dh = cs.par_inputs(S, torch.bfloat16, seed=S, ws=ws)
            _, den = pk.parallel_fw(*args)
            bw = (*args, den, dh)
            a1, dh1, _ = cs.v1_inputs(S, torch.bfloat16, seed=S, ws=ws)
            a1s = cs.v1_inputs(S, torch.bfloat16, states=True, seed=S + 1, ws=ws)[0]
            kw = dict(chunk_size=L, eps=cs.EPS)
            _, den1, c1, *_ = v1.chunkwise_fw(*a1, **kw)
            dc1, _ = v1.chunkwise_bw_dc(a1[0], a1[4], dh1, den1, **kw)
            a2, dh2, _ = cs.exp_inputs(S, torch.bfloat16, seed=S, ws=ws)
            a2s = cs.exp_inputs(S, torch.bfloat16, states=True, seed=S + 1, ws=ws)[0]
            _, den2, mc2, c2, ms2, (_, _, ml2) = ex.chunkwise_exp_fw(*a2, **kw)
            mrow_dc, mrow_qkv = ex.m_rows(a2[4], ms2, ml2, L)
            dc2, _ = ex.chunkwise_exp_bw_dc(a2[0], a2[4], dh2, den2, mc2, mrow_dc, **kw)
            row = {"root": label, "widths": ws.cfg, "S": S, "L": L}
            sm = []
            for name, fn in (
                    ("fw", lambda: pk.parallel_fw(*args)),
                    ("dq", lambda: pk.parallel_bw_dq(*bw)),
                    ("dkv", lambda: pk.parallel_bw_dkv(*bw)),
                    ("v1_fw_train", lambda: v1.chunkwise_fw(*a1, **kw)),
                    ("v1_fw_predict", lambda: v1.chunkwise_fw(*a1s, **kw)),
                    ("exp_fw_train", lambda: ex.chunkwise_exp_fw(*a2, **kw)),
                    ("exp_fw_predict", lambda: ex.chunkwise_exp_fw(*a2s, save_states=False, **kw)),
                    ("v1_dc", lambda: v1.chunkwise_bw_dc(a1[0], a1[4], dh1, den1, **kw)),
                    ("exp_dc", lambda: ex.chunkwise_exp_bw_dc(a2[0], a2[4], dh2, den2, mc2,
                                                             mrow_dc, **kw)),
                    ("v1_dqkv", lambda: v1.chunkwise_bw_dqkv(*a1[:5], c1, den1, dh1, dc1, **kw)),
                    ("exp_dqkv", lambda: ex.chunkwise_exp_bw_dqkv(*a2[:5], c2, den2, mc2,
                                                                  mrow_qkv, dh2, dc2, **kw))):
                with cs.ClockSampler() as clocks:
                    t = cs.time_cuda(fn, iters=3, reps=3, warm_s=0.2)
                row[name] = min(t)
                if clocks.summary_n:
                    sm.append(clocks.summary["clocks.sm"]["median"])
            row["sm"] = min(sm) if sm else None
            row["exp_floor"] = cs.exp_floor(S, row["sm"], ws)
            row["chunk_exp_floor"] = cs.chunk_exp_floor(S, L, row["sm"], ws)
            row["bound_fw_dq"] = cs.parallel_bound("parallel_bw_dq", S, ws=ws)[0]
            row["bound_dkv"] = cs.parallel_bound("parallel_bw_dkv", S, ws=ws)[0]
            row["bound_v1_fw_train"] = cs.v1_bound("chunkwise_v1_fw", S, L, ws=ws)[0]
            row["bound_v1_fw_predict"] = cs.v1_bound("chunkwise_v1_fw", S, L, states=True,
                                                     ws=ws)[0]
            row["bound_exp_fw_train"] = cs.v1_bound("chunkwise_exp_fw", S, L, ws=ws)[0]
            row["bound_exp_fw_predict"] = cs.v1_bound("chunkwise_exp_fw", S, L, states=True,
                                                      save=False, ws=ws)[0]
            row["bound_v1_dc"] = cs.v1_bound("chunkwise_v1_bw_dc", S, L, ws=ws)[0]
            row["bound_exp_dc"] = cs.v1_bound("chunkwise_exp_bw_dc", S, L, ws=ws)[0]
            row["bound_v1_dqkv"] = cs.v1_bound("chunkwise_v1_bw_dqkv", S, L, ws=ws)[0]
            row["bound_exp_dqkv"] = cs.v1_bound("chunkwise_exp_bw_dqkv", S, L, ws=ws)[0]
            print(json.dumps(row), flush=True)
            del args, dh, den, bw, a1, a1s, dh1, den1, c1, dc1, a2, a2s, dh2, den2, mc2, c2, ms2
            del dc2, mrow_dc, mrow_qkv
        shape_times(cs, label, ws, plan)


def shape_times(cs, label: str, ws, plan):
    """The v1 and exp forwards at every (S, L) of the plan and their dC
    scans at every training (S, L): the best window (ms, CUDA events around
    the calls; at S <= 128 the host's launch time) and the device ms a call
    of each of their kernels (kernels_ms)."""
    import torch

    from xlstm_yolo_tpu_torch.ops import chunkwise as v1
    from xlstm_yolo_tpu_torch.ops import chunkwise_exp as ex

    row = {"root": label, "widths": ws.cfg, "what": "by_shape"}
    dev = {"root": label, "widths": ws.cfg, "what": "device_ms_by_shape"}
    for S, L in sorted(set(plan["train"]) | set(plan["infer"])):
        infer = (S, L) in plan["infer"]
        kw = dict(chunk_size=L, eps=cs.EPS)
        a1, dh1, _ = cs.v1_inputs(S, torch.bfloat16, states=infer, seed=S, ws=ws)
        a2, dh2, _ = cs.exp_inputs(S, torch.bfloat16, states=infer, seed=S, ws=ws)
        fns = [(f"v1_fw {S} {L} {'predict' if infer else 'train'}",
                lambda: v1.chunkwise_fw(*a1, **kw)),
               (f"exp_fw {S} {L} {'predict' if infer else 'train'}",
                lambda: ex.chunkwise_exp_fw(*a2, save_states=not infer, **kw))]
        if (S, L) in plan["train"]:
            den1 = v1.chunkwise_fw(*a1, **kw)[1]
            _, den2, mc2, _, ms2, (_, _, ml2) = ex.chunkwise_exp_fw(*a2, **kw)
            mrow2 = ex.m_rows(a2[4], ms2, ml2, L)[0]
            fns += [(f"v1_dc {S} {L}", lambda: v1.chunkwise_bw_dc(a1[0], a1[4], dh1, den1, **kw)),
                    (f"exp_dc {S} {L}", lambda: ex.chunkwise_exp_bw_dc(a2[0], a2[4], dh2, den2,
                                                                       mc2, mrow2, **kw))]
        for key, fn in fns:
            row[key] = min(cs.time_cuda(fn, iters=5, reps=3, warm_s=0.1))
            dev[key] = kernels_ms(cs, fn, calls=20)
        del a1, a2, dh1, dh2, fns
    print(json.dumps(row), flush=True)
    print(json.dumps(dev), flush=True)


def kernels_ms(cs, fn, calls: int = 10):
    """Device ms a call of each kernel of fn, by its name (up to its
    template arguments), and their "total", from a torch.profiler trace of
    ``calls`` calls; the opening operation's elementwise kernels are left
    out.  A trace that lost a kernel event is taken again, up to three
    times, else "not measured"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device="cuda").add_(1)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ours = {}
        for r in cs.device_busy(prof, 1.0).get("top", []):
            if "elementwise" in r["kernel"]:
                continue
            name = r["kernel"].replace("void ", "").split("<", 1)[0].split("(", 1)[0]
            ms, n = ours.get(name, (0.0, 0))
            ours[name] = (ms + r["device_ms"], n + r["calls"])
        if ours and all(n % calls == 0 for _, n in ours.values()):
            per = {name: ms / calls for name, (ms, _) in ours.items()}
            return {"total": sum(per.values()), **per}
    return "not measured"


def unwired_times(cs, label: str):
    """fw3's and the TAL metric's times (module docstring)."""
    import torch

    from xlstm_yolo_tpu_torch.ops import chunkwise_fw3 as f3
    from xlstm_yolo_tpu_torch.ops import chunkwise_v2 as cw
    from xlstm_yolo_tpu_torch.ops import tal_metric as tk

    for ws in (cs.FLAGSHIP, cs.WIDE[-1]):
        for S, L, Lb in cs.FW3_PATH:
            q, k, v, i, f, _, _ = cs.fw3_args(cs.fw3_streams(S, ws, seed=S), "bfloat16", "open",
                                              False)
            kw = dict(chunk_size=L, sub_chunk=Lb, eps=cs.EPS)
            fns = {"fw3": lambda: f3.fw3(q, k, v, i, f, ws.NH, save_states=False, **kw),
                   "fw3_train": lambda: f3.fw3(q, k, v, i, f, ws.NH, **kw),
                   "v2": lambda: cw.mlstm_siging_chunkwise_fw(q, k, v, i, f, ws.NH, eps=cs.EPS),
                   "v2_train": lambda: cw.mlstm_siging_chunkwise_fw_train(q, k, v, i, f, ws.NH,
                                                                          eps=cs.EPS)}
            bounds = {"fw3": cs.fw3_bound(S, L, Lb, ws=ws)[0],
                      "fw3_train": cs.fw3_bound(S, L, Lb, ws=ws, train=True)[0]}
            if S == cs.FW3_PATH[0][0]:
                for sub in cs.FW3_DROP_IN[1]:
                    for name, train in (("l64", False), ("drop_in", True)):
                        fns[f"{name}_{sub}"] = (
                            lambda sub=sub, train=train: f3.fw3(
                                q, k, v, i, f, ws.NH, chunk_size=cw.CHUNK_SIZE, sub_chunk=sub,
                                eps=cs.EPS, save_states=train))
                        bounds[f"{name}_{sub}"] = cs.fw3_bound(S, cw.CHUNK_SIZE, sub, ws=ws,
                                                               train=train)[0]
            row = {"root": label, "kernel": "fw3", "widths": ws.cfg, "S": S, "L": L, "Lb": Lb,
                   "B": ws.B, "NH": ws.NH, "DH": ws.DH, "window_ms": {}, "device_ms": {},
                   "bound_ms": bounds}
            for name, fn in fns.items():
                row["window_ms"][name] = min(cs.time_cuda(fn, iters=5, reps=3, warm_s=0.1))
                row["device_ms"][name] = kernels_ms(cs, fn)
            print(json.dumps(row), flush=True)
            del q, k, v, i, f, fns
    for M in (8, 128):
        args = cs.tal_inputs(7, 8, M)
        fn = lambda: tk.tal_metric(*args, topk=10)  # noqa: E731
        dev = cs.kernels_device_ms(fn, {"tal_metric_kernel": 1})["tal_metric_kernel"]
        win = cs.time_cuda(fn, iters=20, reps=3, warm_s=0.2)
        issue = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            issue.append((time.perf_counter() - t0) / 200 * 1e3)
            torch.cuda.synchronize()
        row = {"root": label, "kernel": "tal_metric", "B": 8, "M": M, "A": args[0].shape[1],
               "device_ms": dev, "window_ms": min(win), "window_ms_runs": win,
               "host_issue_ms": min(issue), "host_issue_ms_runs": issue,
               "bound_ms": cs.tal_bound(8, M, args[0].shape[1])[0]}
        if hasattr(tk, "cluster_size"):
            chosen, by_size = tk.cluster_size, {}
            try:
                for n in (1, 2, 4, 8):
                    tk.cluster_size = lambda rows, n=n: n
                    by_size[n] = cs.kernels_device_ms(fn, {"tal_metric_kernel": 1})[
                        "tal_metric_kernel"]
            finally:
                tk.cluster_size = chosen
            row["cluster_ctas"] = chosen(8 * M)
            row["device_ms_by_cluster_ctas"] = by_size
        print(json.dumps(row), flush=True)
        del args


SETS = {  # sources, the cuda tests' -k expression, the times
    "recurrent": (["slstm", "step"], "slstm or step", recurrent_times),
    "chunkwise": (["parallel_fw", "parallel_bw", "chunkwise_v1_fw", "chunkwise_v1_bw",
                   "chunkwise_exp_fw", "chunkwise_exp_bw"],
                  "parallel or stateful or v1_kernels or exp_kernels or v1_function or "
                  "exp_function or dc_scans", chunkwise_times),
    "unwired": (["chunkwise_fw3", "tal_metric", "chunkwise_fw", "chunkwise_bw"], "fw3 or tal",
                unwired_times),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT), help="the checkout whose package is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--times", action="store_true", help="only the times")
    ap.add_argument("--set", choices=SETS, default="recurrent", help="the kernels checked")
    opt = ap.parse_args()
    sources, tests_k, times = SETS[opt.set]
    sys.path.insert(0, opt.root)
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    if not torch.cuda.is_available():
        print("no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 2
    from xlstm_yolo_tpu_torch.ops import cuda_build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    built = cuda_build.build_all(sources)
    print("build_s", time.perf_counter() - t0, flush=True)
    rc = 0
    if not opt.times:
        for name, out in built.items():
            for line in cs.ptxas_summary(out["log"]):
                print(name, line)
            print(name, "HMMA", json.dumps(cs.sass_mma_counts(out["library"])), flush=True)
        tests = subprocess.run([sys.executable, "-m", "pytest", "-m", "cuda",
                                "tests/test_torch_kernel_cuda.py", "-q", "-p", "no:cacheprovider",
                                "-k", tests_k], capture_output=True, text=True, cwd=opt.root)
        print(tests.stdout[-6000:], tests.stderr[-3000:], flush=True)
        rc = tests.returncode
    times(cs, opt.label)
    return rc


if __name__ == "__main__":
    sys.exit(main())
