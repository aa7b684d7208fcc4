"""Quick check of the port's quadratic kernels and the v1 and exp chunkwise
kernels on one GPU, from the root of the repository:

    python3 scripts/kernels_check.py            # build, tests, times
    python3 scripts/kernels_check.py --times --root DIR --label parent

Builds ``csrc/parallel_fw.cu``, ``csrc/parallel_bw.cu`` and the v1 and exp
routes' sources, prints each kernel's registers and spills (``nvcc -Xptxas
-v``) and its tensor-core (HMMA) instructions, runs the ``cuda`` tests of
the quadratic kernels, the v1 and exp kernels and the stateful cell, then
prints one JSON line per detector's heads and S (6656 and 2048, batch 8,
bf16): the best of three CUDA-event windows of a call of the quadratic
forward, dq and dk/dv, and, at the route's chunk there (512 at 6656, 256
at 2048), of the v1 and exp forwards (train: no initial state, the exp
forward saving its rows; predict: from initial states, the exp forward
saving none), dC scans and dq/dk/dv, the SM clock, the exps' floors and
the bounds (this checkout's chip_smoke.py helpers); then, per detector's
heads, one line of the v1 and exp forwards' and dC scans' best windows,
and one of the device ms a call of each of their kernels from a profiler
trace, at every (S, L) of the route's plan (chip_smoke.py's v1_plan of
vil-det-192: the forwards at the inference segments from initial states,
the exp forward saving nothing, and both at the padded training lengths,
where the dC scans run).  ``--times`` prints only
the times; ``--root`` takes the package from another checkout (an
unpacked parent commit, to time its kernels on the same card).  Exits
non-zero without a card or when a test fails.  A few minutes, where the
full smoke takes ten.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SOURCES = ["parallel_fw", "parallel_bw", "chunkwise_v1_fw", "chunkwise_v1_bw",
           "chunkwise_exp_fw", "chunkwise_exp_bw"]
TESTS = ("parallel or stateful or v1_kernels or exp_kernels or v1_function or exp_function "
         "or dc_scans")


def times(cs, label: str):
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


def device_ms_by_kernel(cs, fn, calls: int = 20):
    """Device ms a call of each kernel of fn in namespace v1 (the v1 and exp
    forwards' and dC scans' passes, in any version of the package), by the
    kernel's name, and their "total", from a torch.profiler trace of
    ``calls`` calls (chip_smoke.py's device_busy); a small operation opens
    the trace, and a trace that lost any kernel event is taken again, up to
    three times, else "not measured"."""
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
            if "v1::" in r["kernel"]:
                name = r["kernel"].split("v1::", 1)[1].split("<", 1)[0]
                ms, n = ours.get(name, (0.0, 0))
                ours[name] = (ms + r["device_ms"], n + r["calls"])
        if ours and all(n == calls for _, n in ours.values()):
            per = {name: ms / calls for name, (ms, _) in ours.items()}
            return {"total": sum(per.values()), **per}
    return "not measured"


def shape_times(cs, label: str, ws, plan):
    """The v1 and exp forwards at every (S, L) of the plan and their dC
    scans at every training (S, L): the best window (ms, CUDA events around
    the calls; at S <= 128 the host's launch time) and the device ms a call
    of each of their kernels (device_ms_by_kernel)."""
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
            dev[key] = device_ms_by_kernel(cs, fn)
        del a1, a2, dh1, dh2, fns
    print(json.dumps(row), flush=True)
    print(json.dumps(dev), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT), help="the checkout whose package is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--times", action="store_true", help="only the times")
    opt = ap.parse_args()
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
    built = cuda_build.build_all(SOURCES)
    print("build_s", time.perf_counter() - t0, flush=True)
    rc = 0
    if not opt.times:
        for name, out in built.items():
            for line in cs.ptxas_summary(out["log"]):
                print(name, line)
            print(name, "HMMA", json.dumps(cs.sass_mma_counts(out["library"])), flush=True)
        tests = subprocess.run([sys.executable, "-m", "pytest", "-m", "cuda",
                                "tests/test_torch_kernel_cuda.py", "-q", "-p", "no:cacheprovider",
                                "-k", TESTS], capture_output=True, text=True, cwd=opt.root)
        print(tests.stdout[-6000:], tests.stderr[-3000:], flush=True)
        rc = tests.returncode
    times(cs, opt.label)
    return rc


if __name__ == "__main__":
    sys.exit(main())
