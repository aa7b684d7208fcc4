"""Quick check of the port's quadratic and chunkwise backward CUDA kernels
on one GPU, from the root of the repository:

    python3 scripts/kernels_check.py            # build, tests, times
    python3 scripts/kernels_check.py --times --root DIR --label parent

Builds ``csrc/parallel_fw.cu``, ``csrc/parallel_bw.cu`` and the v1 and exp
routes' sources, prints each kernel's registers and spills (``nvcc -Xptxas
-v``) and its tensor-core (HMMA) instructions, runs the ``cuda`` tests of
the quadratic kernels, the v1 and exp kernels and the stateful cell, then
prints one JSON line per detector's heads and S (6656 and 2048, batch 8,
bf16): the best of three CUDA-event windows of a call of the quadratic
forward, dq and dk/dv and of the v1 and exp dq/dk/dv at the route's chunk
there (512 at 6656, 256 at 2048), the SM clock, the exps' floors and the
bounds (this checkout's chip_smoke.py helpers).  ``--times`` prints only
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
TESTS = "parallel or stateful or v1_kernels or exp_kernels or v1_function or exp_function"


def times(cs, label: str):
    import torch

    from xlstm_yolo_tpu_torch.ops import chunkwise as v1
    from xlstm_yolo_tpu_torch.ops import chunkwise_exp as ex
    from xlstm_yolo_tpu_torch.ops import parallel as pk

    for ws in (cs.FLAGSHIP, *cs.WIDE):
        for S, L in ((6656, 512), (2048, 256)):
            args, dh = cs.par_inputs(S, torch.bfloat16, seed=S, ws=ws)
            _, den = pk.parallel_fw(*args)
            bw = (*args, den, dh)
            a1, dh1, _ = cs.v1_inputs(S, torch.bfloat16, seed=S, ws=ws)
            kw = dict(chunk_size=L, eps=cs.EPS)
            _, den1, c1, *_ = v1.chunkwise_fw(*a1, **kw)
            dc1, _ = v1.chunkwise_bw_dc(a1[0], a1[4], dh1, den1, **kw)
            a2, dh2, _ = cs.exp_inputs(S, torch.bfloat16, seed=S, ws=ws)
            _, den2, mc2, c2, ms2, (_, _, ml2) = ex.chunkwise_exp_fw(*a2, **kw)
            mrow_dc, mrow_qkv = ex.m_rows(a2[4], ms2, ml2, L)
            dc2, _ = ex.chunkwise_exp_bw_dc(a2[0], a2[4], dh2, den2, mc2, mrow_dc, **kw)
            row = {"root": label, "widths": ws.cfg, "S": S, "L": L}
            sm = []
            for name, fn in (
                    ("fw", lambda: pk.parallel_fw(*args)),
                    ("dq", lambda: pk.parallel_bw_dq(*bw)),
                    ("dkv", lambda: pk.parallel_bw_dkv(*bw)),
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
            row["bound_v1_dqkv"] = cs.v1_bound("chunkwise_v1_bw_dqkv", S, L, ws=ws)[0]
            row["bound_exp_dqkv"] = cs.v1_bound("chunkwise_exp_bw_dqkv", S, L, ws=ws)[0]
            print(json.dumps(row), flush=True)
            del args, dh, den, bw, a1, dh1, den1, c1, dc1, a2, dh2, den2, mc2, c2, ms2, dc2


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
