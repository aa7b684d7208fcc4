"""Quick check of the quadratic route's CUDA kernels on one GPU (the port,
xlstm_yolo_tpu_torch), from the root of the repository:

    python3 scripts/quadratic_kernels_check.py

Builds ``csrc/parallel_fw.cu`` and ``csrc/parallel_bw.cu``, prints each
kernel's registers and spills (``nvcc -Xptxas -v``) and its tensor-core
(HMMA) instructions, runs the ``cuda`` tests of the quadratic kernels and
of the stateful cell, then prints one JSON line per detector's heads and S
(6656 and 2048, batch 8, bf16): the best of three CUDA-event windows of the
forward, dq and dk/dv a call, the SM clock, the exps' floor and the
products' bounds (chip_smoke.py's helpers).  Exits non-zero without a card
or when a test fails.  A few minutes, where the full smoke takes ten.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 2
    from xlstm_yolo_tpu_torch.ops import cuda_build
    from xlstm_yolo_tpu_torch.ops import parallel as pk

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    built = cuda_build.build_all(["parallel_fw", "parallel_bw"])
    print("build_s", time.perf_counter() - t0, flush=True)
    for name, out in built.items():
        for line in cs.ptxas_summary(out["log"]):
            print(name, line)
        print(name, "HMMA", json.dumps(cs.sass_mma_counts(out["library"])), flush=True)
    tests = subprocess.run([sys.executable, "-m", "pytest", "-m", "cuda",
                            "tests/test_torch_kernel_cuda.py", "-q", "-x", "-p", "no:cacheprovider",
                            "-k", "parallel or stateful"], capture_output=True, text=True)
    print(tests.stdout[-6000:], tests.stderr[-3000:], flush=True)
    for ws in (cs.FLAGSHIP, *cs.WIDE):
        for S in (6656, 2048):
            args, dh = cs.par_inputs(S, torch.bfloat16, seed=S, ws=ws)
            _, den = pk.parallel_fw(*args)
            bw = (*args, den, dh)
            row = {"widths": ws.cfg, "S": S}
            for name, fn in (("fw", lambda: pk.parallel_fw(*args)),
                             ("dq", lambda: pk.parallel_bw_dq(*bw)),
                             ("dkv", lambda: pk.parallel_bw_dkv(*bw))):
                with cs.ClockSampler() as clocks:
                    t = cs.time_cuda(fn, iters=3, reps=3, warm_s=0.2)
                row[name] = min(t)
                row["sm"] = clocks.summary["clocks.sm"]["median"] if clocks.summary_n else None
            row["exp_floor"] = cs.exp_floor(S, row["sm"], ws)
            row["bound_fw"] = cs.parallel_bound("parallel_fw", S, ws=ws)[0]
            row["bound_dkv"] = cs.parallel_bound("parallel_bw_dkv", S, ws=ws)[0]
            print(json.dumps(row), flush=True)
    return tests.returncode


if __name__ == "__main__":
    sys.exit(main())
