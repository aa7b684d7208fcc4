"""Smoke run of the PyTorch port (xlstm_yolo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. setup     - print the card's name and power limit; build the fourteen
               CUDA sources of csrc/ with nvcc (sm_90a), one nvcc each, all
               started together, and print the build time, what ptxas
               reports and, for the v2 forward and backward, the epilogue
               backward, the FFN backward, the quadratic forward and
               backward and the v1 and exp forwards and backwards, the
               tensor-core (HMMA) instructions of each kernel in the machine
               code (cuobjdump -sass; each of these libraries must show
               some, the v1 and exp forwards in both passes, their
               backwards in the dC increments and dq/dk/dv); phases 28-34 run next, then
               2-4, 35 and 5-27;
2. kernel    - the chunkwise mLSTM inference kernel against its plain PyTorch
               version on the card at the flagship shapes (B 8, NH 12, DH 32,
               S 6400/1600/400/100 and a ragged 1000), float32 and bfloat16,
               with and without initial states, and with closed forget gates;
               in bfloat16 against its two plain passes composed (fw_split:
               the state scan, then the output pass, rounding the products'
               operands where the kernel and JAX's forward do): h within
               BF16_TOL, C within BF16_STATE_REL, n within F32_TOL, and h
               and C nearer them in mean error than the passes without the
               rounding are (rounding_shows; also in train_kernels);
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
               and |mean| >> std rows for the LayerNorm and the RMSNorm; also
               each pass of the backward (the dC scan, then dq/dk/dv) alone
               against its plain version, the bfloat16 train forward against
               fw_split and the epilogue backward against its
               rounding-faithful plain version (epilogue_bwd_rounded_plain);
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
               the route's bfloat16 streams and products to 2e-2, and in
               bfloat16 the forward's, the dC scan's and dq/dk/dv's
               outputs nearer their plain version in mean error than the
               plain version with float32 products is (rounding_shows);
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
               bfloat16 to 2e-2, the forward (h as h (den + eps)), the dC
               scan and dq/dk/dv also in mean error as in v1_kernels
               (phase_exp_kernels);
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
               bfloat16 (products likewise), open and closed forget gates;
               in bfloat16 the outputs of all three also nearer their
               plain version in mean error than the plain version with
               float32 products is (rounding_shows)
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
               each, against one stateful call over the 64 tokens, which is
               exactly one launch of the v2 inference kernel; us per token
               and the step kernel's time per call (CUDA-event window,
               device time from a profiler trace, the host's issue time);
21. refusal  - YOLO(..., chunkwise_kernel=PAR).predict raises the port's
               ValueError (the route has no predict path, as in JAX);
22. wide_kernels - phases 2, 5, 9, 12, 16 and 19 again at the widths of
               vil-det-256 (NH 8, DH 64, H 512, D 256, U 704) and vil-det-384
               (NH 6, DH 128, H 768, D 384, U 1024), batch 8: every mLSTM
               kernel and the epilogue and FFN backwards against their plain
               versions at the same lengths, gates, states and tolerances;
23. outnorm  - the inference forward with the per-head LayerNorm fused in
               against its plain version (in bfloat16, fw_split with
               float64 sums, and without the v offset at 2e-2) at DH 32, 64
               and 128, and
               MatrixLSTMCell(768, 6, fuse_outnorm=True) against the unfused
               cell, one fused launch per call (phase_outnorm);
24. predict_384 - YOLO("vil-det-384.yaml").predict() on the images of phase
               4 (40 launches), one batch of vil-det-256 (predict_256), and
               one batch of vil-det-384 on the v1 and on the exp route, each
               with exact launches;
25. train_384 - 3 bf16 steps of detect_trainer("vil-det-384.yaml") as phase
               8, one step of vil-det-256 (train_256), and one step of
               vil-det-384 on each of the v1, exp and quadratic routes, each
               with exact launches (v1 and exp: then one more step, and one
               in a profiler trace, its device time and busy share); then a 64-token decode through
               MatrixLSTMCell(768, 6, step_kernel="step--pallas");
26. wide_grads - a ViLBlockPair of vil-det-384's widths at S = 1600: its
               float32 gradients with the kernels against float64, as
               e2e_grads (phase_wide_grads);
27. times    - CUDA-event medians (and every window) of each kernel and its
               plain version at each S (v1, exp: each (S, L), the forward
               and dq/dk/dv with the floor of their one exp a causal pair of
               a chunk, B NH S (L + 1) / 2 of them, at the sampled SM clock,
               exp_floor_ms;
               quadratic: each padded S, with the floor of its one exp a
               causal pair, exp_floor_ms); for the v2 backward and the
               FFN backward also the
               device time of each of their kernels (the dC scan and dq/dk/dv;
               the row pass, the weight gradients and the sums) from a
               torch.profiler trace, each backward pass alone in CUDA-event
               windows, and the FFN backward's four products as torch.matmul
               on a line of their own (a yardstick, no part of the port); the
               end-to-end
               predict rate on every route (windows after a warm-up, SM clock
               and power sampled); torch.profiler traces of three forwards;
               the v1 and v2 backward designs on the same work (L = 64); the
               exp route's predict forward and the share of its recurrent
               tails; the v2-, v1-, exp- and quadratic-route train steps in
               turns (v2, v1, exp, parallel, parallel, exp, v1, v2), each
               with the device's busy share from a trace of one step; every
               kernel's per-call times at the widths of vil-det-256 and
               vil-det-384 (wide_times); vil-det-384's predict rate and train
               step with busy share, clocks and peak memory.

28. tal_kernel - the fused TAL metric kernel against its plain version at
               640 px (A 8400, nc 80), batch 8 and a stacked 16 with k 10
               for one half and 1 for the other, M 8 (the smoke's gts) and
               128 (the JAX dataset's max_targets): mask_pos equal, align
               and overlaps bit-equal or within 2e-5; then TAL_EXTRA (one
               row, B 8 at M 300, topk 1 and 17, one NaN box: align and
               overlaps bit-equal, mask_pos equal, a NaN metric never
               selected); then the assigner
               entry task_aligned_assign_pallas_metric (one launch a call,
               counted) against task_aligned_assign at the tolerances of
               tests/test_tal_kernel.py (phase_tal_kernel);
29. slstm_kernel - the sLSTM scan kernel (a thread-block cluster per head
               and group of batch rows) against its plain loop at DH 8, 32
               and 128, S 128, 97 and 2048, with and without an initial
               state, and large input gates, and at DH 48 and 256; float32,
               within 1e-5 of each output's largest value, or, where
               rounding compounds over 2048 steps beyond that, against
               float64 (phase_slstm_kernel);
30. lm       - the xLSTM language model at full width (dim 512, 6 blocks,
               sLSTM at 1, vocabulary 50 304), float32, batch 8, 128-token
               prompts: forward logits with the kernels and with the plain
               versions against a float64 forward (E2E_FACTOR), exactly 1
               sLSTM and 5 v2-inference launches a forward and 32 and 160
               in a 32-token greedy generate, the same tokens as the plain
               generate; forward ms, tokens per second, the sLSTM kernel per
               call (device ms from a profiler trace, microseconds a step,
               its launch plan), also at S 2048 (phase_lm);
31. tal_times - the TAL kernel, its plain version and both assigners per
               call at batch 8, M 8 and 128 (phase_tal_times);
32. fw3_kernel - the sub-chunked forward fw3 (gate rows, state pass, output
               pass) against its plain version at every (S, L, Lb) of
               FW3_SHAPES (the v2 cell's S 6400/1600/400/100 with L
               640/400/400/100, tests/test_fw3.py's cases, and sub-chunks
               of 8, 100 and 640 rows) at the widths of all three
               detectors, batch 8: q float32 and bfloat16, products float32
               and bfloat16, open and closed forget gates, with and without
               initial states, both variants; every output within F32_TOL
               or BF16_TOL of its largest value, and with bfloat16 products
               within half the plain version's bfloat16-vs-float32-products
               gap in mean error (a kernel that skipped the operands'
               rounding fails), three launches a call; then
               its path with counts set to 0: the inference variant at the
               v2 cell's (S, L) and the drop-in contract (the train
               variant's states fed to the v2 backward kernel at L 64, the
               gradients at GRAD_REL), exact launches (phase_fw3_kernel);
33. fw3_times - fw3 in both variants beside the port's v2 inference and
               train forwards on the same inputs and the plain version, per
               call at each flagship S, DH 32 and 128, with its bound, each
               kernel's device time at S 6400 and the scratch's size;
               besides the JAX cell's L, both variants at the v2 kernels'
               L 64 with sub-chunks 32 and 64 (bfloat16 products, as v2's:
               like for like; the train variant's states are what the v2
               backward takes) (phase_fw3_times);
34. passes_times - the device time of each kernel of the v2 forward (state
               scan, output pass; inference and train), the v2 backward (dC
               scan, dq/dk/dv), the epilogue backward and the FFN backward
               (row pass, weight gradients, sums) at each S and every
               detector's widths, and of the v1 and exp forwards (state
               pass, output pass; train variant) and dC scans (increments,
               combine) at (6656, 512) at every detector's widths, bf16, from torch.profiler traces, and each
               pass of the v2 forward and backward alone in CUDA-event
               windows (phase_passes_times; the times phases print them
               beside each call's time);
35. val      - the validation path: 48 PNG files of eight shapes (the val
               pre-resize's ceil both ways, 2x and 3x downscales) written
               with the port's writer; the letterboxed batch of 16 made on
               the card and on the CPU byte-equal; YOLO("vil-det-192.yaml")
               (bf16, perturbed ifgates, short random boxes: val_head) .val()
               with save_json, its detections written back as the labels
               (self_label), and .val() again: mAP50 >= 0.99 and mAP50-95
               >= 0.95 (the 101-point AP of a perfect class is 0.995), 20
               inference-kernel launches a batch in each pass; images per
               second and the validator's split (decode + load, forward, host
               matching + AP) (phase_val);
36. train_loop - the trainer: YOLO("vil-det-192.yaml").train() on 64 train
               PNG files with random labels and 16 val ones written here,
               from pretrained random weights (val's ifgates and val_head)
               whose val detections label the val split (self_label), 640 px,
               batch 16, nbs 32 (accumulate 2), 3 epochs (the mosaic off in
               the third), optimizer auto (AdamW), 4 spawned loader
               workers, bf16: a mosaic and a plain batch composed on the card
               byte-equal to the CPU; exact launches a step (accumulate x the
               train phase's) and a val batch (20); finite losses;
               results.csv, last, best and their stripped files; the
               checkpoint round trip bit-equal; a resume from the epoch-2
               checkpoint reading the same files with its first loss within
               1e-3; mAP50 > 0 in every validation; best_stripped.pt equal to
               best.pt's EMA tensors, and its .val() equal to the trainer's
               final metrics to 1e-6; images per second, the loader-wait share, the
               workers' ms per image, the composition ms per batch
               (phase_train_loop; runs after train).
37. multiscale - vil-det-192 at other input sizes, bf16: the v2 inference
               forward, train forward and backward against their plain
               versions at S 9216, 2304, 576, 144 (a ragged 16-row chunk)
               and 4096, B 2, and the epilogue and FFN backwards at M =
               2 * 9216, at the kernel phases' tolerances; then, counts at
               0: predict of 8 images at 512 and 768 px (20 launches a
               batch, ms a batch); the folded-BatchNorm model (fused=True,
               utils/fuse.py) against the unfused one at 512 px, anchor by
               anchor (float64: boxes within 1e-2 px, the same classes;
               float32 on the kernels: phase_model's rule); three steps at
               each bucket 512/640/768 from 640 px batches (imgsz_out),
               exact launches, ms a step; YOLO.train(multi_scale=True), one
               epoch: the printed buckets and JAX's draws; the stripped
               best's .val(imgsz=512) on its own detections: mAP50 >= 0.9
               (phase_multiscale; runs after train_loop).

Each phase prints its seconds on a line of its own.  Output: JSON lines per
phase, the nvidia-smi line, one {"kernels": [...]} line (twenty kernels:
the sixteen of the detector with their numbers on the vil-det-192 paths
and, under "vil_det_384", on vil-det-384's; the TAL metric kernel on the
assigner entry, the sLSTM scan on the LM's generate; fw3's inference and
train variants on their path, with "dh128" at vil-det-384's heads; the
rows of the v2 forward (inference and train), the v2 backward, the
epilogue backward and the FFN backward also "per_call_s6400" with each of
their kernels' device ms; the quadratic kernels' "per_call_s6656" and the
v1 and exp forwards', dC scans' and dq/dk/dv's "per_call_s6656_l512" at
every detector's heads, with each pass's device ms or exp_floor_ms; the
v2 forward's and the four training kernels' rows a "multiscale" object:
their launches in phase multiscale and their errors at its lengths), and
last {"ok": true, "device": {...}}.  Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOP_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak


class Widths(NamedTuple):
    """The batch and widths of one detector's layers: B, NH heads of DH
    (the cell width H = NH * DH), the embedding D and the FFN width U."""

    cfg: str
    B: int
    NH: int
    DH: int
    D: int
    U: int

    @property
    def H(self) -> int:
        return self.NH * self.DH

    @property
    def dims(self) -> tuple:
        return self.B, self.NH, self.DH, self.H, self.D, self.U


FLAGSHIP = Widths("vil-det-192.yaml", 8, 12, 32, 192, 512)
WIDE = (Widths("vil-det-256.yaml", 8, 8, 64, 256, 704),
        Widths("vil-det-384.yaml", 8, 6, 128, 384, 1024))
B, NH, DH, H, D, U = FLAGSHIP.dims  # the flagship's, where a phase takes no Widths
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
# The v1 and exp forwards' outputs the products reach by less than this of
# their mean |value| (C with closed gates, every key scaled to ~0; m, n)
# show no rounding: their bf16-vs-float32 gap is at float32's resolution.
FW_MIN_GAP = 1e-5
# the bfloat16 v2 forward against its two plain passes (fw_split: the same
# operands rounded, float32 sums in another order): h within BF16_TOL, C
# within BF16_STATE_REL of its largest |value|, n and den within F32_TOL,
# and each output that a product feeds nearer fw_split in mean error than
# the passes without the rounding are (rounding_shows).  A float32 sum in
# another order flips the rounding of an operand now and then, and one
# flipped k e^a times v moves its element of C by ~2e-3 of C's largest
# |value| (read on the H100: at most 2.4e-3 in the kernel and train_kernels
# phases; in mean error at most 0.003 of the unrounded passes' distance)
BF16_STATE_REL = 5e-3
# the fused LayerNorm's bfloat16 h of |mean| >> std rows against fw_split
# with float64 sums: the normalisation magnifies each flipped operand, so
# its largest error is held at LN_BF16_MAX of its largest |value| (read: at
# most 0.052; the unrounded version 0.072-0.39) and its mean error at
# LN_BF16_MEAN of its mean |value| (read: at most 2.5e-5; the unrounded
# version 3.0e-3-4.1e-3)
LN_BF16_MAX, LN_BF16_MEAN = 0.1, 1e-4
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


def iters_for(ws, n: int) -> int:
    """Calls per timing window: ``n`` at the flagship's widths, a quarter
    (at least 2) at the wider ones, whose calls take longer."""
    return n if ws == FLAGSHIP else max(2, n // 4)


def in_turns(kern, plain, iters: int, plain_iters: int, plain_reps: int = 3, kern_reps: int = 3,
             ws=FLAGSHIP) -> tuple[list, list]:
    """Per-call ms windows of ``kern`` and ``plain`` (time_cuda), timed in
    turns plain, kernel, kernel, plain, so that a drift of the card shows
    as a spread; after 0.5 s of warm-up at the flagship's widths, 0.1 s at
    the wider ones (whose calls are longer; three calls come first)."""
    warm = 0.5 if ws == FLAGSHIP else 0.1
    t_plain = time_cuda(plain, iters=plain_iters, reps=plain_reps, warm_s=warm)
    t_kern = [t for _ in range(2) for t in time_cuda(kern, iters=iters, reps=kern_reps,
                                                       warm_s=warm)]
    t_plain += time_cuda(plain, iters=plain_iters, reps=plain_reps, warm_s=warm)
    return t_kern, t_plain


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


def kernel_inputs(S, dtype, gates="open", states=False, seed=0, ws=FLAGSHIP):
    import torch

    B, NH, DH, H, D, U = ws.dims
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


def row_inputs(S, dtype, offset=0.0, seed=0, ws=FLAGSHIP):
    """Flagship-width inputs of the epilogue (h, x, g, ln_w, ln_b, skip, wd)
    and of the FFN backward (x, gz, g, wn, wgz, wd), bd/bgz for gz."""
    import torch

    from xlstm_yolo_tpu_torch.ops import ffn

    B, NH, DH, H, D, U = ws.dims
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


def bound(S: int, itemsize: int = 2, ws=FLAGSHIP, fused_ln: bool = False) -> tuple[float, str]:
    """Least time for one inference-forward call in ms, and what sets it: q,
    k, v read and h written once, the gates read once, the last states
    written once (``fused_ln``: and the LayerNorm's weight and bias read
    once), over HBM bandwidth; against 4*B*NH*S*DH*(L+DH) chunkwise FLOP
    at the bf16 peak."""
    B, NH, DH, H, D, U = ws.dims
    nbytes = 4 * B * S * H * itemsize + 2 * B * S * NH * 4 + B * NH * (DH * DH + DH) * 4
    nbytes += 2 * H * 4 if fused_ln else 0
    flops = 4 * B * NH * S * DH * (L + DH)
    return _bound(nbytes, flops)


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def train_bound(name: str, S: int, itemsize: int = 2, ws=FLAGSHIP) -> tuple[float, str]:
    """Least time for one call of a training kernel at batch B in ms, each
    input read once and each output written once, against its products at
    the bf16 peak (see PERF.md for the derivation)."""
    B, NH, DH, H, D, U = ws.dims
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


def fw_split(cw, args, ln=(None, None), acc=None):
    """The v2 forward's two plain passes composed on the card (what the
    kernels compute, bf16 rounding of the products' operands included; sums
    in ``acc``, default float32): h, den, c_states, n_states, c_last,
    n_last."""
    q, k, v, i, f, nh, c0, n0 = args
    cs, ns, (cl, nl) = cw.mlstm_siging_chunkwise_fw_states_plain(k, v, i, f, nh, c0, n0,
                                                                 acc=acc)
    h, den = cw.mlstm_siging_chunkwise_fw_out_plain(q, k, v, i, f, nh, cs, ns, eps=EPS,
                                                    ln_weight=ln[0], ln_bias=ln[1], acc=acc)
    return h, den, cs, ns, cl, nl


def unrounded(args):
    """The forward's arguments with q, k and v in float32: fw_split on
    them skips the products' bf16 rounding."""
    return (*(a.float() for a in args[:3]), *args[3:])


def rounding_shows(what: str, got, ref, unrounded_ref, min_gap: float = 0.0) -> float:
    """Each bf16 output lies nearer its rounding plain version ``ref`` in
    mean |error| than the unrounded version is, by more than half, so a
    kernel that skipped the rounding of its products' operands fails (the
    mean is what a few operands rounded one step the other way barely
    move).  An output whose gap is at most ``min_gap`` of its mean |value|
    is one the products reach below float32's resolution, and is skipped.
    Returns the largest ratio of the two mean distances."""
    worst = 0.0
    for j, (a, b, c) in enumerate(zip(got, ref, unrounded_ref)):
        a, b, c = a.double(), b.double(), c.double()
        gap = (c - b).abs().mean().item()
        if gap <= min_gap * b.abs().mean().item():  # no product reaches it (measurably)
            continue
        ratio = (a - b).abs().mean().item() / gap
        if ratio >= 0.5:
            raise AssertionError(f"{what}: output {j} is {ratio:.3g} of the unrounded version's "
                                 "mean distance from the rounding plain passes (limit 0.5)")
        worst = max(worst, ratio)
    return worst


def phase_kernel(cw, ws=FLAGSHIP):
    """The inference forward against its plain version: h and C within
    F32_TOL in float32, n within F32_TOL.  In bfloat16 the kernel rounds
    its products' operands as JAX's forward does (the plain one-piece
    version keeps them in float32), so h is held within BF16_TOL, C within
    BF16_STATE_REL and n within F32_TOL of their largest value against the
    two plain passes composed (fw_split), which round where the kernel
    does, and h and C nearer them in mean error than the unrounded passes
    are (rounding_shows); the distance from the one-piece plain version is
    printed beside them."""
    import torch

    B, NH, DH, H, D, U = ws.dims
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = [(S, "open", False) for S in SEQ_LENS] + [
        (1000, "open", True), (1600, "closed", False)]
    for dtype in (torch.float32, torch.bfloat16):
        for S, gates, states in cases:
            args = kernel_inputs(S, dtype, gates, states, seed=S, ws=ws)
            h, (c, n) = cw.mlstm_siging_chunkwise_fw(*args, eps=EPS, return_last_states=True)
            torch.cuda.synchronize()
            hp, (cp, np_) = cw.mlstm_siging_chunkwise_fw_plain(
                *args, eps=EPS, return_last_states=True)
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL
            finite = bool(torch.isfinite(h.float()).all())
            split = {}
            if dtype == torch.bfloat16:
                split["max_abs_err_h_vs_unrounded_plain"] = (
                    h.float() - hp.float()).abs().max().item()
                hp, _, _, _, cp, sn = fw_split(cw, args)
                unr = fw_split(cw, unrounded(args))
                split["max_rel_err_vs_passes"] = {
                    "h": compare_outputs(f"fw h vs passes S={S}", [h], [hp], BF16_TOL)[1],
                    "c": compare_outputs(f"fw C vs passes S={S}", [c], [cp], BF16_STATE_REL)[1],
                    "n": compare_outputs(f"fw n vs passes S={S}", [n], [sn], F32_TOL)[1]}
                split["mean_err_over_unrounded"] = rounding_shows(
                    f"fw S={S}", [h, c], [hp, cp], [unr[0], unr[4]])
                del unr
            err = (h.float() - hp.float()).abs().max().item()
            err_state = max((c - cp).abs().max().item(), (n - np_).abs().max().item())
            emit({"phase": "kernel", "widths": ws.cfg, "S": S, "dtype": str(dtype).split(".")[-1],
                  "gates": gates, "initial_states": states, "max_abs_err_h": err,
                  "max_abs_err_states": err_state, "tol": tol, "finite": finite, **split})
            torch.testing.assert_close(h.float(), hp.float(), atol=tol, rtol=tol)
            torch.testing.assert_close(n, np_, atol=F32_TOL, rtol=F32_TOL)
            if dtype == torch.float32:
                torch.testing.assert_close(c, cp, atol=F32_TOL, rtol=F32_TOL)
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


def cfg_name(yolo) -> str:
    from pathlib import Path

    return Path(yolo.model_cfg).stem


def cells_of(model) -> int:
    from xlstm_yolo_tpu_torch.nn.layers import MatrixLSTMCell

    return sum(isinstance(m, MatrixLSTMCell) for m in model.modules())


def phase_predict(cw, yolo, n_images: int = 10):
    """YOLO(...).predict() on ``n_images`` synthetic images (10: batches of
    8 and 2, the tail padded): finite results in original image
    coordinates, and one inference-kernel launch per cell and forward."""
    import numpy as np

    images = synthetic_images(n_images, seed=5)
    expected = -(-n_images // B) * cells_of(yolo.model)
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
    emit({"phase": "predict", "cfg": cfg_name(yolo), "dtype": "bfloat16", "images": len(images),
          "shapes": sorted({tuple(im.shape[:2]) for im in images}), "batch": B,
          "boxes_per_image": n_boxes, "launches": launches, "expected": expected})
    if launches != expected:
        raise AssertionError(f"predict made {launches} kernel launches, expected {expected}")
    return launches


VAL_N = 48          # images of the val phase's synthetic set
VAL_BATCH = 16      # the validator's default batch
VAL_SHAPES = [(480, 640), (375, 500), (333, 500), (1080, 1920), (150, 200), (640, 640),
              (97, 211), (960, 1280)]  # ceil pre-resize both ways, 2x and 3x downscales
VAL_CONF = 0.25     # self-labels: usable detections scoring at least this (self_label),
VAL_LABELS = 100    # at most this many an image (under max_targets, 128)
VAL_CLS = (0.1, -2.0)  # the one-to-one class logits' kernel scale and bias (val_head)


def write_val_set(root, n: int, seed: int, split: str = "val", boxes: int = 0,
                  shapes=VAL_SHAPES):
    """``n`` PNG images cycling through ``shapes`` (gradients plus noise)
    under root/images/<split>, with up to ``boxes`` random labels each (none
    by default); the dataset YAML (COCO's 80 names, the split as val)."""
    from pathlib import Path

    import numpy as np
    import yaml

    from xlstm_yolo_tpu_torch.data.imread import imwrite_png
    from xlstm_yolo_tpu_torch.engine.model import COCO_NAMES

    root = Path(root)
    (root / "images" / split).mkdir(parents=True)
    (root / "labels" / split).mkdir(parents=True)
    rng = np.random.default_rng(seed)
    written = {}
    for j in range(n):
        h, w = shapes[j % len(shapes)]
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 255 // w, yy * 255 // h, (xx * 3 + yy * 5) % 256], -1)
        im = (base + rng.integers(-40, 40, (h, w, 3))).clip(0, 255).astype(np.uint8)
        imwrite_png(root / "images" / split / f"{split}{j:03d}.png", im, level=1)
        written[f"{split}{j:03d}"] = (h, w)
        if boxes:
            rows = [f"{int(rng.integers(0, 80))} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}\n"
                    for cx, cy, bw, bh in zip(*rng.uniform((0.2, 0.2, 0.05, 0.05),
                                                           (0.8, 0.8, 0.4, 0.4),
                                                           (int(rng.integers(1, boxes + 1)), 4)).T)]
            (root / "labels" / split / f"{split}{j:03d}.txt").write_text("".join(rows))
    data = root / f"{split}-set.yaml"
    data.write_text(yaml.safe_dump({"path": str(root), "val": f"images/{split}",
                                    "names": [COCO_NAMES[i] for i in range(80)]}))
    return data, written


def val_head(model, cls_scale: float, cls_bias: float):
    """Make the random detector's one-to-one detections distinct boxes with
    spread scores.

    At random weights each side's DFL distance is ~7.5 bins, so most boxes
    span the whole image once clipped; two of one class then give the same
    label row, which the label dedup merges, and the second detection is a
    false positive.  The box towers' last conv gets its kernel x 0.1 and a
    bias ramp of -0.5 a bin (distances of ~1.5 bins).  The class logits
    saturate the sigmoid: the class towers' last conv gets its kernel x
    ``cls_scale`` and the bias ``cls_bias``."""
    import torch

    from xlstm_yolo_tpu_torch.nn.head import Detect

    head = next(m for m in model.modules() if isinstance(m, Detect))
    with torch.no_grad():
        for box, cls in zip(head.one2one_cv2, head.one2one_cv3):
            box[-1].weight.mul_(0.1)
            box[-1].bias.copy_(-0.5 * torch.arange(head.reg_max, dtype=torch.float32).repeat(4))
            cls[-1].weight.mul_(cls_scale)
            cls[-1].bias.fill_(cls_bias)


def self_label(jdict, shapes: dict, labels_dir, imgsz: int) -> dict:
    """Write each image's labels from its pass-1 detections (COCO rows,
    best first), so that pass 2 must score every class present 0.995 (the
    101-point AP of a perfect class).

    A detection is usable as a label when it is at least 1 px wide and high
    (the dataset drops a zero-width row, and the json's 3-decimal rounding
    moves a thinner one by a large share of its size), its row does not
    repeat an earlier row of its image (the dedup merges those), and its box
    survives the trip through the label file at IoU >= 0.96: the validator
    maps boxes back with h's ratio for both axes (JAX's ``scale_boxes``),
    and ceil makes w's ratio differ (ratio_x below), so a label's x
    coordinates come back scaled by ratio_x while its detection's do not.
    AP is per class, so the cut is too: class c's labels are its usable
    detections scoring at least VAL_CONF and above ``bar[c]``, the highest
    score of an unusable detection of class c, raised where an image would
    get more than VAL_LABELS (under max_targets).  Every detection of c above
    its cut is then a label that it matches at every IoU threshold."""
    from pathlib import Path

    from xlstm_yolo_tpu_torch.data.augment import val_resized_shape

    by_image = {stem: [] for stem in shapes}
    for r in jdict:
        by_image[r["image_id"]].append(r)
    bar = {}
    rows = {}
    for stem, rs in by_image.items():
        h, w = shapes[stem]
        hr, wr = val_resized_shape((h, w), imgsz)
        ratio_x = (wr / w) / (hr / h)
        seen = set()
        for r in rs:
            x, y, bw, bh = r["bbox"]
            text = (f"{r['category_id']} {(x + bw / 2) / w:.7f} {(y + bh / 2) / h:.7f} "
                    f"{bw / w:.7f} {bh / h:.7f}\n")
            gx1, gx2 = min(x * ratio_x, w), min((x + bw) * ratio_x, w)
            iou = (max(0.0, min(x + bw, gx2) - max(x, gx1))
                   / max(1e-9, max(x + bw, gx2) - min(x, gx1)))
            if min(bw, bh) < 1.0 or text in seen or iou < 0.96:
                bar[r["category_id"]] = max(bar.get(r["category_id"], 0.0), r["score"])
            seen.add(text)
            rows[id(r)] = text

    def labels_of(rs):
        return [r for r in rs
                if r["score"] >= VAL_CONF and r["score"] > bar.get(r["category_id"], 0.0)]

    for rs in by_image.values():  # at most VAL_LABELS an image
        for r in labels_of(rs)[VAL_LABELS:]:
            bar[r["category_id"]] = max(bar.get(r["category_id"], 0.0), r["score"])
    counts = []
    for stem, rs in by_image.items():
        keep = labels_of(rs)
        counts.append(len(keep))
        Path(labels_dir, f"{stem}.txt").write_text("".join(rows[id(r)] for r in keep))
    return {"classes_cut": len(bar), "per_image": counts,
            "cut_median": sorted(bar.values())[len(bar) // 2] if bar else None}


def phase_val(cw, card: str) -> int:
    """YOLO("vil-det-192.yaml").val() on VAL_N PNG files written here.

    1. The letterboxed uint8 batch of the first VAL_BATCH images, made on the
       card and on the CPU from the same collated batch, byte-equal; the
       validator's loader gives the same batch (labels, ratio_pad) as the
       dataset's samples collated.
    2. Pass 1 (bf16, random weights from seed 0, ifgates perturbed,
       val_head) with save_json; each image's usable detections above its
       class's cut (at least VAL_CONF) become its labels (self_label), all
       of which the dataset keeps; pass 2 validates the same set against
       them: mAP50 >= 0.99 and mAP50-95 >= 0.95.
    3. Each pass launches the inference kernel 20 times a batch, the tail
       batch padded (exact).
    Returns the launches of both passes."""
    import math
    import shutil
    import tempfile

    import torch

    from xlstm_yolo_tpu_torch.data.build import build_dataloader, build_yolo_dataset
    from xlstm_yolo_tpu_torch.data.dataset import check_det_dataset
    from xlstm_yolo_tpu_torch.engine.model import YOLO

    root = tempfile.mkdtemp(prefix="chip_smoke_val_")
    try:
        t = time.perf_counter()
        data, shapes = write_val_set(root, VAL_N, seed=11)
        write_s = time.perf_counter() - t

        info = check_det_dataset(str(data))
        yolo = YOLO("vil-det-192.yaml", device="cuda", compute_dtype=torch.bfloat16)
        ds = build_yolo_dataset({"imgsz": yolo.imgsz}, info["val"])
        batch = ds.collate([ds.get_sample(i) for i in range(min(VAL_BATCH, len(ds)))])
        loader_batch = next(iter(build_dataloader(ds, VAL_BATCH, workers=0)))
        on_card = ds.images(batch, "cuda").cpu()
        on_cpu = ds.images(batch, "cpu")
        pixels_equal = bool(torch.equal(on_card, on_cpu))
        host_equal = (all((loader_batch[k] == batch[k]).all() for k in ("cls", "bboxes", "mask"))
                      and loader_batch["ratio_pad"] == batch["ratio_pad"])
        if not pixels_equal:
            diff = (on_card.int() - on_cpu.int()).abs()
            raise AssertionError(f"val pixels differ between the card and the CPU: "
                                 f"{int((diff > 0).sum())} bytes, at most {int(diff.max())}")
        if not host_equal:
            raise AssertionError("the validator's loader batch differs from the samples")

        perturb_ifgates(yolo.model, seed=8)
        val_head(yolo.model, *VAL_CLS)
        expected = math.ceil(VAL_N / VAL_BATCH) * cells_of(yolo.model)
        passes = []
        for k, kw in enumerate(({"save_json": True}, {})):
            cw.LAUNCHES = 0
            t = time.perf_counter()
            res = yolo.val(data=str(data), batch=VAL_BATCH, workers=0, plots=True,
                           save_dir=f"{root}/pass{k + 1}", **kw)
            wall = time.perf_counter() - t
            v = yolo.validator
            passes.append({"results": res, "launches": cw.LAUNCHES, "seen": v.seen,
                           "wall_s": wall, "images_per_s": v.seen / wall,
                           "ms_per_image": v.speed,
                           "decode_load_ms": v.speed["preprocess"],
                           "forward_ms": v.speed["inference"],
                           "post_metrics_ms": v.speed["postprocess"] + v.speed["metrics"],
                           "detections": len(v.jdict)})
            if k == 0:
                labels = self_label(v.jdict, shapes, f"{root}/labels/val", yolo.imgsz)
        label_rows = sum(labels["per_image"])
        kept = int(sum(lab["cls"].size for lab in build_yolo_dataset(
            {"imgsz": yolo.imgsz}, info["val"]).labels))
        m = passes[1]["results"]
        emit({"phase": "val", "cfg": "vil-det-192", "dtype": "bfloat16", "card": card,
              "images": VAL_N, "batch": VAL_BATCH, "shapes": VAL_SHAPES,
              "write_png_s": write_s, "pixels_equal": pixels_equal, "pixel_images": VAL_BATCH,
              "cls_scale_bias": list(VAL_CLS), "label_cut_median": labels["cut_median"],
              "classes_cut": labels["classes_cut"], "labels_written": label_rows,
              "labels_kept": kept, "labels_per_image": [min(labels["per_image"]),
                                                       max(labels["per_image"])],
              "expected_launches": expected,
              "pass1": passes[0], "pass2": passes[1],
              "images_per_s": passes[1]["images_per_s"],
              "note": "images_per_s: images over the wall time of one val call (dataset scan, "
                      "PNG decode, device letterbox, forward, host matching and AP); "
                      "ms_per_image: the validator's split"})
        for p in passes:
            if p["launches"] != expected:
                raise AssertionError(f"a val pass made {p['launches']} inference-kernel "
                                     f"launches, expected {expected}")
            if p["seen"] != VAL_N:
                raise AssertionError(f"a val pass saw {p['seen']} of {VAL_N} images")
        if not (m["metrics/mAP50(B)"] >= 0.99 and m["metrics/mAP50-95(B)"] >= 0.95):
            raise AssertionError(f"self-labelled val: mAP50 {m['metrics/mAP50(B)']}, mAP50-95 "
                                 f"{m['metrics/mAP50-95(B)']} (need 0.99 and 0.95)")
        if label_rows < VAL_N or kept != label_rows:
            raise AssertionError(f"{label_rows} self-labels written on {VAL_N} images, "
                                 f"{kept} kept by the dataset")
        return sum(p["launches"] for p in passes)
    finally:
        shutil.rmtree(root, ignore_errors=True)


LOOP_TRAIN, LOOP_VAL = 64, 16  # train_loop's synthetic PNG set
# wider, taller, square, smaller and larger than 640 px; the val set's
# 1080p and 960p images cost the phase ~10 s of PNG writing and decoding
LOOP_SHAPES = [(480, 640), (375, 500), (640, 640), (150, 200), (97, 211), (720, 540)]
LOOP_CLS = (0.3, -1.0)  # val_head's class scale and bias for train_loop's start: the
# trained detector's scores still spread past VAL_CONF (its BatchNorm statistics
# shrink the features that phase_val's VAL_CLS reads)
LOOP_ARGS = dict(imgsz=640, batch=16, nbs=32, epochs=3, close_mosaic=1, optimizer="auto",
                 workers=4, amp=True, seed=0, exist_ok=True)


def loop_state(state) -> list:
    """Every tensor and number of a train state, in order (copies)."""
    import torch

    from xlstm_yolo_tpu_torch.utils.checkpoint import _leaves

    return ([p.detach().clone() for p in state.params.values()]
            + [b.clone() for b in state.batch_stats.values()]
            + [e.clone() for e in state.ema.params]
            + [x.clone() if torch.is_tensor(x) else x for x in _leaves(state.opt_state)]
            + [state.step, state.ema.updates])


def loop_pixels(trainset) -> dict:
    """One mosaic batch and one batch with the mosaic off, composed on the
    card and on the CPU from the same recipes: byte-equal.  Times each
    composition (the card's with a synchronise, best of 5; the CPU's once)."""
    import random

    import torch

    from xlstm_yolo_tpu_torch.data.pixels import compose_batch

    out = {}
    tf = trainset.transforms
    for kind, enabled in (("mosaic", True), ("no_mosaic", False)):
        tf.mosaic_enabled = enabled
        rng = random.Random(17)
        b = trainset.collate([trainset.get_sample(i, rng) for i in range(LOOP_ARGS["batch"])])
        on_card = compose_batch(b["recipe"], b["tiles"], "cuda")
        t = time.perf_counter()
        on_cpu = compose_batch(b["recipe"], b["tiles"], "cpu")
        cpu_ms = (time.perf_counter() - t) * 1e3
        diff = int((on_card.cpu() != on_cpu).sum())
        card_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            compose_batch(b["recipe"], b["tiles"], "cuda")
            torch.cuda.synchronize()
            card_ms.append((time.perf_counter() - t) * 1e3)
        out[kind] = {"bytes_differing": diff, "images": len(b["recipe"]),
                     "card_ms_per_batch": min(card_ms), "cpu_ms_per_batch": cpu_ms,
                     "mosaics": sum(len(r["canvas"]["tiles"]) > 1 for r in b["recipe"])}
        if diff:
            raise AssertionError(f"train pixels ({kind}) differ between the card and the CPU "
                                 f"in {diff} bytes")
    tf.mosaic_enabled = True
    return out


def phase_train_loop(cw, epi, ffn, card: str) -> dict:
    """YOLO("vil-det-192.yaml").train() on a synthetic PNG set written here
    (LOOP_TRAIN train images with random labels and LOOP_VAL val images,
    COCO's 80 names): imgsz 640, batch 16, nbs 32 (accumulate 2), 3 epochs
    with close_mosaic 1, optimizer auto (AdamW at this length), 4 spawned
    loader workers, bf16, seed 0, from ``pretrained`` weights: random ones
    with phase_val's ifgates and val_head (LOOP_CLS), so that the trained detector's
    val detections are usable labels (self_label).  Random labels score 0
    whatever the weights; labels made before training score ~0 too, as
    the BatchNorm statistics' moves in 12 microbatches reorder the random
    detector's detections (mAP50 < 0.001 on the card).

    1. A mosaic batch and a batch with the mosaic off: the pixels composed on
       the card equal those composed on the CPU, byte for byte.
    2. Each optimizer step launches each training kernel exactly
       accumulate times its per-step count (expected_step_launches), and no
       inference kernel; each val batch 20 inference launches (the tail
       batch padded).
    3. Every loss is finite.
    4. results.csv has 3 rows; last, best and their stripped files exist.
    5. load_checkpoint(save_checkpoint(state)) restores every tensor bit for
       bit, and the step, epoch and best fitness.
    6. A second trainer resumes from the checkpoint of epoch 2 (a snapshot
       taken by a callback): it starts at epoch 3, reads the same im_file
       lists a step, and its first step's loss is within 1e-3 relative of
       the uninterrupted run's.
    7. YOLO(best_stripped.pt) loads strictly; its tensors equal best.pt's
       EMA parameters and BatchNorm statistics; its val returns the
       trainer's final metrics to 1e-6.  Its detections then label the val
       split (self_label), and its val (mAP50 >= 0.9) equals, to 1e-6, the
       trainer's final validation repeated on those labels: its validator
       settings on its eval twin, which holds best.pt's EMA.
    Prints images per second, the share of the loop spent waiting on the
    loader, the workers' decode and recipe ms per image, the card's
    composition ms per batch."""
    import math
    import shutil
    import tempfile
    from pathlib import Path

    import torch
    import yaml

    from xlstm_yolo_tpu_torch.cfg import get_cfg
    from xlstm_yolo_tpu_torch.data.build import build_yolo_dataset
    from xlstm_yolo_tpu_torch.engine.model import COCO_NAMES, YOLO
    from xlstm_yolo_tpu_torch.engine.validator import DetectionValidator
    from xlstm_yolo_tpu_torch.utils import checkpoint

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        t = time.perf_counter()
        write_val_set(root, LOOP_TRAIN, seed=21, split="train", boxes=6, shapes=LOOP_SHAPES)
        _, shapes = write_val_set(root, LOOP_VAL, seed=22, split="val", boxes=6,
                                  shapes=LOOP_SHAPES)
        data = root / "data.yaml"
        data.write_text(yaml.safe_dump({"path": str(root), "train": "images/train",
                                        "val": "images/val",
                                        "names": [COCO_NAMES[i] for i in range(80)]}))
        write_s = time.perf_counter() - t

        init = YOLO("vil-det-192.yaml")
        perturb_ifgates(init.model, seed=8)
        val_head(init.model, *LOOP_CLS)
        torch.save(init.model.state_dict(), root / "init.pt")
        del init

        args = {**LOOP_ARGS, "pretrained": str(root / "init.pt")}
        trainset = build_yolo_dataset(get_cfg(overrides={"imgsz": args["imgsz"]}),
                                      str(root / "images" / "train"), mode="train")
        pixels = loop_pixels(trainset)

        def run(name, snap_after=None, **kw):
            """YOLO(...).train() with callbacks that count each step's and
            each val's launches and keep each step's loss and files."""
            log = {"steps": [], "loss": [], "files": [], "val": [], "mark": None}

            def on_start(tr):
                log["mark"] = counts(cw, epi, ffn)

            def on_step(tr):
                now = counts(cw, epi, ffn)
                log["steps"].append({k: now[k] - log["mark"][k] for k in now})
                log["mark"] = now
                log["loss"].append({k: float(v) for k, v in tr.losses[-1].items()})
                log["files"].append(tr.step_files[-1])

            def on_epoch_end(tr):
                now = counts(cw, epi, ffn)
                log["val"].append(now["chunkwise_fw"] - log["mark"]["chunkwise_fw"])
                log["mark"] = now
                if tr.epoch == snap_after:
                    shutil.copytree(tr.wdir, root / "snap" / "weights")
                    shutil.copy(tr.csv_path, root / "snap" / "results.csv")

            y = YOLO("vil-det-192.yaml")
            y.add_callback("on_train_epoch_start", on_start)
            y.add_callback("on_train_batch_end", on_step)
            y.add_callback("on_fit_epoch_end", on_epoch_end)
            zero_counts(cw, epi, ffn)
            t0 = time.perf_counter()
            metrics = y.train(data=str(data), project=str(root), name=name, **args, **kw)
            torch.cuda.synchronize()
            log["wall_s"] = time.perf_counter() - t0
            log["final_val_launches"] = cw.LAUNCHES - sum(log["val"])
            log["totals"] = counts(cw, epi, ffn)
            return y.trainer, metrics, log

        tr, metrics, log = run("full", snap_after=1)
        expected = expected_step_launches(tr.model)
        cells = cells_of(tr.eval_model)
        acc = tr.accumulate
        val_batches = math.ceil(LOOP_VAL / LOOP_ARGS["batch"])
        want = {k: v * acc for k, v in expected.items()}
        bad_steps = [s for s in log["steps"]
                     if s["chunkwise_fw"] != 0 or any(s[k] != want[k] for k in KERNELS)]
        losses_finite = all(math.isfinite(v) for m in log["loss"] for v in m.values())
        rows = tr.csv_path.read_text().splitlines()
        files = {f: (tr.wdir / f).is_file() for f in ("last.pt", "best.pt", "last_stripped.pt",
                                                       "best_stripped.pt")}

        # checkpoint round trip into the live state: save, disturb, load
        st = tr.state
        before = loop_state(st)
        path = checkpoint.save_checkpoint(root / "rt.pt", st, 7, 0.125, {"epochs": 3},
                                          tr.generator)
        with torch.no_grad():
            for p in list(st.params.values()) + list(st.batch_stats.values()) + st.ema.params:
                p.add_(1.0)
        st.step += 5
        st, start, best = checkpoint.load_checkpoint(path, st, tr.generator)
        after = loop_state(st)
        round_trip = (len(before) == len(after) and (start, best) == (8, 0.125) and all(
            torch.equal(a, b) if torch.is_tensor(a) else a == b for a, b in zip(before, after)))

        timing = tr.timing
        images = sum(e["images"] for e in timing)
        epoch_s = sum(e["epoch_s"] for e in timing)
        figures = {
            "images_per_s": images / epoch_s,
            "loader_wait_share": sum(e["wait_s"] for e in timing) / epoch_s,
            "worker_ms_per_image": 1e3 * sum(e["load_s"] for e in timing) / images,
            "compose_host_ms_per_batch": 1e3 * sum(e["compose_s"] for e in timing)
            / (images / LOOP_ARGS["batch"]),
            "compose_card_ms_per_batch": pixels["mosaic"]["card_ms_per_batch"],
            "compose_cpu_ms_per_batch": pixels["mosaic"]["cpu_ms_per_batch"],
            "step_s_per_optimizer_step": sum(e["step_s"] for e in timing) / len(log["steps"]),
        }
        full_log = log

        # resume from the snapshot of epoch 2
        tr2, metrics2, log2 = run("snap", resume=True)
        resumed_at = tr2.start_epoch
        n_last = len(log2["files"])
        same_files = log2["files"] == full_log["files"][-n_last:] and n_last > 0
        first_rel = abs(log2["loss"][0]["loss"] - full_log["loss"][-n_last]["loss"]) / abs(
            full_log["loss"][-n_last]["loss"])
        del tr2

        wdir = root / "full" / "weights"
        stripped = YOLO(str(wdir / "best_stripped.pt"))
        best_ck = checkpoint.read_checkpoint(wdir / "best.pt")
        want_sd = {**best_ck["ema_params"], **best_ck["batch_stats"]}
        got_sd = stripped.model.state_dict()
        stripped_equal = got_sd.keys() == want_sd.keys() and all(
            torch.equal(got_sd[k], want_sd[k].to(got_sd[k].device)) for k in want_sd)
        t = time.perf_counter()
        vkw = dict(data=str(data), batch=args["batch"], imgsz=args["imgsz"], workers=0)
        zero_counts(cw, epi, ffn)
        res = stripped.val(**vkw, save_json=True, save_dir=str(root / "val1"))
        metric_gap = max(abs(float(res[k]) - float(metrics[k])) for k in metrics)
        labels = self_label(stripped.validator.jdict, shapes, root / "labels" / "val",
                            args["imgsz"])
        res2 = stripped.val(**vkw, save_dir=str(root / "val2"))
        stripped_launches = cw.LAUNCHES
        zero_counts(cw, epi, ffn)
        res3 = DetectionValidator({**tr._val_args(args["batch"]), "workers": 0,
                                   "save_dir": str(root / "val3")})(tr.eval_model)
        twin_launches = cw.LAUNCHES
        stripped_s = time.perf_counter() - t
        relabel_gap = max(abs(float(res2[k]) - float(res3[k])) for k in res2)
        del stripped, tr
        torch.cuda.empty_cache()

        emit({"phase": "train_loop", "cfg": "vil-det-192", "card": card, **args,
              "train_images": LOOP_TRAIN, "val_images": LOOP_VAL, "accumulate": acc,
              "write_png_s": write_s, "pixels": pixels, "figures": figures,
              "launches_per_step_expected": want, "steps": len(full_log["steps"]),
              "bad_steps": bad_steps, "val_launches_per_epoch": full_log["val"],
              "final_val_launches": full_log["final_val_launches"],
              "losses": [m["loss"] for m in full_log["loss"]], "losses_finite": losses_finite,
              "results_rows": len(rows) - 1, "files": files, "checkpoint_round_trip": round_trip,
              "resumed_at_epoch": resumed_at, "resume_same_files": same_files,
              "resume_first_loss_rel": first_rel, "stripped_val_launches": stripped_launches,
              "stripped_equals_best_ema": stripped_equal, "stripped_metric_gap": metric_gap,
              "relabelled": {"labels_per_image": [min(labels["per_image"]),
                                                  max(labels["per_image"])],
                             "stripped": {k: float(v) for k, v in res2.items()},
                             "gap_to_twin": relabel_gap, "twin_launches": twin_launches}, "final_metrics": {k: float(v) for k, v in
                                                                  metrics.items()},
              "wall_s": full_log["wall_s"], "resume_wall_s": log2["wall_s"],
              "stripped_checks_s": stripped_s,
              "host": {"torch_threads": torch.get_num_threads(), "cpu_count": os.cpu_count(),
                       "usable_cpus": len(os.sched_getaffinity(0))},
              "timing": timing,
              "note": "figures from the uninterrupted run's three epochs on the card: "
                      "images_per_s = images trained / the epochs' loop seconds (no val); "
                      "loader_wait_share = seconds blocked on the loader / loop seconds; "
                      "worker_ms_per_image = the workers' decode, draws and labels; "
                      "compose_card_ms_per_batch = compose_batch of a 16-image mosaic batch on "
                      "the card, synchronised, best of 5 (cpu: the same on this host's CPU, "
                      "once); timing: per epoch, the first with the workers' start and the "
                      "first steps"})
        per_val = val_batches * cells
        if bad_steps or len(full_log["steps"]) != 3 * (len(trainset) // LOOP_ARGS["batch"]
                                                       // acc):
            raise AssertionError(f"train_loop step launches {bad_steps}, expected {want}")
        if any(v != per_val for v in full_log["val"] + log2["val"]) \
                or full_log["final_val_launches"] != per_val \
                or stripped_launches != 2 * per_val or twin_launches != per_val:
            raise AssertionError(f"train_loop val launches {full_log['val']} / "
                                 f"{full_log['final_val_launches']}, expected {per_val}")
        if not losses_finite or not all(math.isfinite(m["loss"]) for m in log2["loss"]):
            raise AssertionError("train_loop: a non-finite loss")
        if len(rows) != 4 or not all(files.values()):
            raise AssertionError(f"train_loop files: {len(rows) - 1} csv rows, {files}")
        if not round_trip:
            raise AssertionError("train_loop: the checkpoint round trip is not bit-equal")
        if resumed_at != 2 or not same_files or not first_rel <= 1e-3:
            raise AssertionError(f"train_loop resume: epoch {resumed_at}, same files "
                                 f"{same_files}, first loss rel {first_rel}")
        if not stripped_equal:
            raise AssertionError("train_loop: best_stripped.pt differs from best.pt's EMA "
                                 "parameters and BatchNorm statistics")
        if not metric_gap <= 1e-6:
            raise AssertionError(f"train_loop: the stripped best validates {metric_gap} from "
                                 "the trainer's final metrics")
        if not (float(res2["metrics/mAP50(B)"]) >= 0.9 and relabel_gap <= 1e-6):
            raise AssertionError(f"train_loop: on its own detections the stripped best "
                                 f"scores mAP50 {res2['metrics/mAP50(B)']} (need 0.9), "
                                 f"{relabel_gap} from the trainer's eval twin")
        return {k: full_log["totals"][k] + log2["totals"][k] for k in full_log["totals"]} | {
            "chunkwise_fw": full_log["totals"]["chunkwise_fw"] + log2["totals"]["chunkwise_fw"]
            + stripped_launches + twin_launches, "figures": figures}
    finally:
        shutil.rmtree(root, ignore_errors=True)


MS_WS = Widths("vil-det-192.yaml", 2, 12, 32, 192, 512)  # the kernel checks' batch and widths
# (S, the YAML's chunk_size at that stage): the four stages at 768 px, vil-det-192's last
# stage at 768 (ragged: 144 = 2 * 64 + 16 rows at the kernels' L = 64) and its first at
# 512 px; the v2 kernels chunk at L = 64 whatever the YAML's chunk_size says
MS_KERNEL_SHAPES = ((9216, 512), (2304, 512), (576, 256), (144, 64), (4096, 512))
MS_PREDICT = (512, 768)
MS_BUCKETS = (512, 640, 768)
MS_STEPS = 3  # optimizer steps a bucket: the first warms the bucket up, two are checked and timed
# seed 1: its four steps draw [640, 768, 512, 640], every bucket (seed 0 never draws 768)
MS_TRAIN = dict(imgsz=640, batch=16, nbs=16, epochs=1, close_mosaic=0, optimizer="auto",
                workers=4, amp=True, seed=1, exist_ok=True, multi_scale=True)
MS_VAL_IMGSZ = 512
MS_FUSE_TOL = 1e-2  # px: the fused model's float64 boxes against the unfused model's


def ms_kernel_checks(cw, epi, ffn) -> dict:
    """The v2 inference forward, train forward and backward against their
    plain versions at MS_KERNEL_SHAPES' lengths (B 2, NH 12, DH 32), in
    bfloat16 (each length) and float32 (the longest and the ragged one), at
    the kernel phases' tolerances: float32 every output within F32_TOL (the
    backward GRAD_REL); bfloat16 h within BF16_TOL of the two plain passes
    (fw_split), which round where the kernels do, C within BF16_STATE_REL,
    n and den within F32_TOL, the backward within GRAD_REL; then the FFN and
    epilogue backwards at M = 2 * 9216 rows."""
    import torch

    ws, NH_ = MS_WS, MS_WS.NH
    worst = {}

    def note(name, errs):
        worst[name] = [max(a, b) for a, b in zip(worst.get(name, [0.0, 0.0]), errs)]

    def most(*errs):  # the largest absolute and relative error of several outputs
        return tuple(max(e[j] for e in errs) for j in range(2))

    rows = []
    for S, chunk in MS_KERNEL_SHAPES:
        for dtype in ((torch.bfloat16, torch.float32) if S in (9216, 144) else (torch.bfloat16,)):
            key = str(dtype).split(".")[-1]
            rel = GRAD_REL[key]
            args = kernel_inputs(S, dtype, "open", True, seed=S + 7, ws=ws)
            h, (c, n) = cw.mlstm_siging_chunkwise_fw(*args, eps=EPS, return_last_states=True)
            got = cw.mlstm_siging_chunkwise_fw_train(*args, eps=EPS)
            torch.cuda.synchronize()
            outs = [got[0], *got[1], *got[2]]
            if dtype == torch.float32:
                hp, (cp, np_) = cw.mlstm_siging_chunkwise_fw_plain(*args, eps=EPS,
                                                                   return_last_states=True)
                e_fw = compare_outputs(f"ms fw S={S}", [h, c, n], [hp, cp, np_], F32_TOL)
                ref = cw.mlstm_siging_chunkwise_fw_train_plain(*args, eps=EPS)
                e_tr = compare_outputs(f"ms fw_train S={S}", outs, [ref[0], *ref[1], *ref[2]],
                                       F32_TOL)
            else:
                sh, sden, scs, sns, scl, snl = fw_split(cw, args)
                e_fw = most(compare_outputs(f"ms fw h S={S}", [h], [sh], BF16_TOL),
                           compare_outputs(f"ms fw C S={S}", [c], [scl], BF16_STATE_REL),
                           compare_outputs(f"ms fw n S={S}", [n], [snl], F32_TOL))
                h_, cl_, nl_, cs_, ns_, den_ = outs
                e_tr = most(compare_outputs(f"ms fw_train h S={S}", [h_], [sh], BF16_TOL),
                           compare_outputs(f"ms fw_train C S={S}", [cl_, cs_], [scl, scs],
                                           BF16_STATE_REL),
                           compare_outputs(f"ms fw_train n, den S={S}", [nl_, ns_, den_],
                                           [snl, sns, sden], F32_TOL))
                del sh, sden, scs, sns, scl, snl
            g = torch.Generator().manual_seed(S + 8)
            dh = torch.randn(ws.B, S, ws.H, generator=g).to("cuda", dtype)
            dcl = torch.randn(ws.B, NH_, ws.DH, ws.DH, generator=g).cuda()
            bw_args = (*args[:6], got[2][0], got[2][2], dh, dcl)
            gb = cw.mlstm_siging_chunkwise_bw(*bw_args, eps=EPS)
            torch.cuda.synchronize()
            e_bw = compare_outputs(f"ms bw S={S}", gb,
                                   cw.mlstm_siging_chunkwise_bw_plain(*bw_args, eps=EPS), rel)
            note(f"chunkwise_fw_{key}", e_fw)
            note(f"chunkwise_fw_train_{key}", e_tr)
            note(f"chunkwise_bw_{key}", e_bw)
            rows.append({"S": S, "yaml_chunk": chunk, "chunks_of_64": -(-S // L),
                         "tail_rows": S % L or L, "dtype": key, "fw_max_rel_err": e_fw[1],
                         "fw_train_max_rel_err": e_tr[1], "bw_max_rel_err": e_bw[1]})
            del args, h, c, n, got, outs, gb, bw_args, dh
    for dtype in (torch.bfloat16, torch.float32):
        key = str(dtype).split(".")[-1]
        e_args, f_args = row_inputs(9216, dtype, 0.0, seed=9216, ws=ws)
        ge, gf = epi.epilogue_bwd(*e_args), ffn.ffn_bwd(*f_args)
        torch.cuda.synchronize()
        note(f"epilogue_bw_{key}", compare_outputs(
            f"ms epilogue {key}", ge, epi.epilogue_bwd_rounded_plain(*e_args), GRAD_REL[key]))
        note(f"ffn_bw_{key}", compare_outputs(f"ms ffn {key}", gf, ffn.ffn_bwd_plain(*f_args),
                                              GRAD_REL[key]))
        del e_args, f_args, ge, gf
    emit({"phase": "multiscale", "what": "kernels", "B": ws.B, "NH": NH_, "DH": ws.DH,
          "L": L, "cases": rows, "rows_M": ws.B * 9216, "worst_abs_rel": worst,
          "tols": {"float32": F32_TOL, "bf16_h": BF16_TOL, "bf16_state": BF16_STATE_REL,
                   "grad": GRAD_REL}})
    torch.cuda.empty_cache()
    return worst


def bucket_step_launches(model, imgsz: int) -> dict:
    """expected_step_launches at input size ``imgsz``: a pair is
    rematerialised where its sequence at that size is at least 80 * 80."""
    from xlstm_yolo_tpu_torch.nn.layers import ViLBlockPair, ViLLayer

    r2 = (imgsz / 640) ** 2
    layers = sum(isinstance(m, ViLLayer) for m in model.modules())
    remat = sum(2 for m in model.modules() if isinstance(m, ViLBlockPair)
                and math.prod(m.rowwise_from_top_left.layer.conv.seqlens) * r2 >= m.ckpt_thresh)
    return {"chunkwise_fw_train": layers + remat, "chunkwise_bw": layers,
            "epilogue_bw": layers, "ffn_bw": layers}


def phase_multiscale(cw, epi, ffn, steps, card: str) -> dict:
    """vil-det-192 at other input sizes, bfloat16 (phase_multiscale):

    1. The v2 kernels at the new lengths against their plain versions
       (ms_kernel_checks; these comparisons' launches are not counted).
    Then, with every count set to 0:
    2. predict of a batch of 8 at 512 and 768 px (the pos embed and the
       PatchMerger queries resized): 20 inference launches a batch, finite
       results inside the original images; the forward's ms on a device
       batch (normalise + forward + top-k; 512, 640 and 768 px in turns,
       3 windows of 3 each way); and at 512 px
       the model built with fused=True from fuse_state_dict of the same
       weights (BatchNorm statistics drawn off 0/1, default gates),
       decode-only, anchor by anchor: in float64 on the plain cells its
       boxes within MS_FUSE_TOL px of the unfused model's and its classes
       the same; in float32 on the kernels (20 launches each) at most
       E2E_FACTOR times as far from that float64 output as the unfused
       model is (phase_model's rule: a float32 forward of this random
       network amplifies rounding, and folding changes the rounding);
    3. MS_STEPS optimizer steps at each bucket of MS_BUCKETS from 640 px
       batches (make_train_step(imgsz_out=...)): finite losses, the
       parameters move, exact launches a step (bucket_step_launches); the
       host ms of each step (synchronised), the first a warm-up;
    4. YOLO("vil-det-192.yaml").train(multi_scale=True, epochs=1) on
       phase_train_loop's PNG set (written again from its seeds), from the
       same pretrained weights: the printed buckets are
       [512, 640, 768], and the bucket of each step is
       random.Random(seed * 1000 + 0).choice over them; then best.pt's
       stripped weights .val(imgsz=512) with save_json, those detections
       as the val labels (self_label at 512), and .val(imgsz=512) again:
       mAP50 >= 0.9, 20 inference launches a val batch.
    Returns the launches of 2-4 by kernel."""
    import contextlib
    import io
    import random
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    import yaml

    from xlstm_yolo_tpu_torch.engine import optimizers as opt_lib
    from xlstm_yolo_tpu_torch.engine.model import COCO_NAMES, YOLO
    from xlstm_yolo_tpu_torch.engine.predictor import DetectionPredictor
    from xlstm_yolo_tpu_torch.nn.tasks import build_detection_model
    from xlstm_yolo_tpu_torch.utils.fuse import fuse_state_dict

    t_phase = time.perf_counter()
    worst = ms_kernel_checks(cw, epi, ffn)
    kernels_s = time.perf_counter() - t_phase
    zero_counts(cw, epi, ffn)

    # 2. predict at other sizes
    yolo = YOLO("vil-det-192.yaml", device="cuda", compute_dtype=torch.bfloat16)
    perturb_ifgates(yolo.model, seed=8)
    cells = cells_of(yolo.model)
    images = synthetic_images(B, seed=5)
    predict = {}
    for size in MS_PREDICT:
        before = cw.LAUNCHES
        results = yolo.predict(images, imgsz=size, batch=B, conf=0.0)
        launches = cw.LAUNCHES - before
        for im, r in zip(images, results):
            h, w = im.shape[:2]
            d = r.boxes.data
            if not (np.isfinite(d).all() and (d[:, [0, 2]] >= 0).all() and (d[:, [0, 2]] <= w).all()
                    and (d[:, [1, 3]] >= 0).all() and (d[:, [1, 3]] <= h).all()):
                raise AssertionError(f"multiscale predict at {size}: boxes non-finite or outside "
                                     f"the {w}x{h} image")
        predict[size] = {"launches": launches, "forward_ms_runs": []}
        if launches != cells:
            raise AssertionError(f"multiscale predict at {size} made {launches} inference "
                                 f"launches, expected {cells}")
    # the forward's time at each size and at 640 in turns (512, 640, 768, 768, 640, 512)
    fwd = {}
    for size in MS_PREDICT[:1] + (640,) + MS_PREDICT[1:]:
        predictor = DetectionPredictor({"imgsz": size, "batch": B}, yolo.model, yolo.names)
        batch = predictor.preprocess(images)
        fwd[size] = functools.partial(predictor.forward, batch)
    for size in list(fwd) + list(fwd)[::-1]:
        runs = time_cuda(fwd[size], iters=3, reps=3, warm_s=0.5)
        predict.setdefault(size, {"forward_ms_runs": []})["forward_ms_runs"] += runs
    for p in predict.values():
        p["forward_ms"] = statistics.median(p["forward_ms_runs"])
    del yolo, fwd
    # the folded BatchNorms at 512 px, decode-only (no ranking), at the default gate init:
    # float64 on the plain cells, and float32 on the kernels against that float64
    plain, _ = build_detection_model("vil-det-192.yaml", device="cuda", decode_only=True)
    fused, _ = build_detection_model("vil-det-192.yaml", device="cuda", decode_only=True,
                                     fused=True)
    g = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for name, t in plain.state_dict().items():
            if name.endswith("running_mean"):
                t.copy_(torch.randn(t.shape, generator=g) * 0.05)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) * 0.7 + 0.7)
    fused.load_state_dict(fuse_state_dict(plain.state_dict()), strict=True)
    pre = DetectionPredictor({"imgsz": 512, "batch": B}, plain, {})
    with torch.inference_mode():
        x = pre.preprocess(images).float() / 255.0
        before = cw.LAUNCHES
        y32, f32 = plain(x)[0], fused(x)[0]
        fused_launches = cw.LAUNCHES - before
        outs64 = []
        for m in (plain, fused):
            m64 = copy.deepcopy(m).double()
            set_cell_kernel(m64, cw.mlstm_siging_chunkwise_fw_plain)
            outs64.append(m64(x.double())[0])
        y64, f64 = outs64
        fuse = {"decode_shape": list(y64.shape),
                "float64_max_box_err_px": (f64[..., :4] - y64[..., :4]).abs().max().item(),
                "float64_max_score_err": (f64[..., 4:] - y64[..., 4:]).abs().max().item(),
                "float64_same_classes": bool(torch.equal(f64[..., 4:].argmax(-1),
                                                         y64[..., 4:].argmax(-1))),
                "bn_folded": sum(k.endswith("running_mean") for k in plain.state_dict()),
                "kernel_launches": fused_launches}
        for part, sl in (("boxes", slice(0, 4)), ("scores", slice(4, None))):
            ref = y64[..., sl]
            fuse[f"float32_{part}"] = {
                "fused_vs_f64": (f32[..., sl].double() - ref).abs().max().item(),
                "unfused_vs_f64": (y32[..., sl].double() - ref).abs().max().item(),
                "fused_vs_unfused": (f32[..., sl] - y32[..., sl]).abs().max().item()}
    del plain, fused, pre, x, y32, f32, y64, f64, outs64, m64
    ok32 = all(fuse[f"float32_{p}"]["fused_vs_f64"]
               <= E2E_FACTOR * fuse[f"float32_{p}"]["unfused_vs_f64"] + E2E_ATOL[p]
               for p in ("boxes", "scores"))
    if not (fuse["float64_max_box_err_px"] <= MS_FUSE_TOL and fuse["float64_same_classes"]
            and ok32 and fused_launches == 2 * cells):
        raise AssertionError(f"multiscale: the fused model's detections differ: {fuse}")

    # 3. bucket steps from 640 px batches
    model, _ = build_detection_model("vil-det-192.yaml", compute_dtype=torch.bfloat16,
                                     device="cuda", generator=torch.Generator().manual_seed(0),
                                     training=True)
    perturb_ifgates(model, seed=7)
    tx, _, _ = opt_lib.build_optimizer(steps.optimizer_leaves(model), **TRAIN_OPT)
    state = steps.TrainState.create(model, tx)
    gen = torch.Generator().manual_seed(8)
    bucket_steps = {}
    for b in MS_BUCKETS:
        step = steps.make_train_step(model, tx, nc=80, imgsz_out=b)
        expected = bucket_step_launches(model, b)
        p0 = [p.detach().clone() for p in state.params.values()]
        per_step, losses, ms = [], [], []
        for j in range(MS_STEPS):
            batch = train_batch(B, 640, seed=40 + j)
            torch.cuda.synchronize()
            before, t = counts(cw, epi, ffn), time.perf_counter()
            state, metrics = step(state, batch, gen)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            after = counts(cw, epi, ffn)
            per_step.append({k: after[k] - before[k] for k in after})
            losses.append({k: v.item() for k, v in metrics.items()})
        moved = max((p.detach() - a).abs().max().item()
                    for p, a in zip(state.params.values(), p0))
        bucket_steps[b] = {"launches_per_step": per_step, "expected": expected,
                           "losses": losses, "param_max_change": moved, "step_ms": ms}
        if not all(math.isfinite(v) for m in losses for v in m.values()) or not moved > 0:
            raise AssertionError(f"bucket {b}: losses {losses}, parameters moved {moved}")
        for s_ in per_step:
            if s_["chunkwise_fw"] != 0 or any(s_[k] != expected[k] for k in KERNELS):
                raise AssertionError(f"bucket {b}: step launches {s_}, expected {expected}")
    del model, state, tx
    torch.cuda.empty_cache()

    # 4. a multi-scale training run, and validation at 512 px
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ms_"))
    try:
        write_val_set(root, LOOP_TRAIN, seed=21, split="train", boxes=6, shapes=LOOP_SHAPES)
        _, shapes = write_val_set(root, LOOP_VAL, seed=22, split="val", boxes=6,
                                  shapes=LOOP_SHAPES)
        data = root / "data.yaml"
        data.write_text(yaml.safe_dump({"path": str(root), "train": "images/train",
                                        "val": "images/val",
                                        "names": [COCO_NAMES[i] for i in range(80)]}))
        init = YOLO("vil-det-192.yaml")
        perturb_ifgates(init.model, seed=8)
        val_head(init.model, *LOOP_CLS)
        torch.save(init.model.state_dict(), root / "init.pt")
        del init
        y = YOLO("vil-det-192.yaml")
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            y.train(data=str(data), project=str(root), name="ms",
                    pretrained=str(root / "init.pt"), **MS_TRAIN)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        print(out.getvalue(), end="", flush=True)
        tr = y.trainer
        line = [ln for ln in out.getvalue().splitlines() if ln.startswith("multi-scale buckets:")]
        printed = json.loads(line[0].split(":", 1)[1]) if line else None
        rng = random.Random(int(MS_TRAIN["seed"]) * 1000 + 0)
        want = [rng.choice(printed or []) for _ in tr.buckets] if printed else None
        train_losses = [float(m["loss"]) for m in tr.losses]
        del tr
        stripped = YOLO(str(root / "ms" / "weights" / "best_stripped.pt"))
        vkw = dict(data=str(data), batch=MS_TRAIN["batch"], imgsz=MS_VAL_IMGSZ, workers=0)
        before = cw.LAUNCHES
        stripped.val(**vkw, save_json=True, save_dir=str(root / "val1"))
        labels = self_label(stripped.validator.jdict, shapes, root / "labels" / "val",
                            MS_VAL_IMGSZ)
        res = stripped.val(**vkw, save_dir=str(root / "val2"))
        val_launches = cw.LAUNCHES - before
        buckets_drawn = y.trainer.buckets
        del stripped, y
    finally:
        shutil.rmtree(root, ignore_errors=True)
    totals = counts(cw, epi, ffn)
    per_val = math.ceil(LOOP_VAL / MS_TRAIN["batch"]) * cells
    mAP50 = float(res["metrics/mAP50(B)"])
    emit({"phase": "multiscale", "cfg": "vil-det-192", "card": card, "dtype": "bfloat16",
          "kernel_checks_s": kernels_s, "predict_batch": B,
          "predict": {s_: {k: v for k, v in p.items() if k != "forward_ms_runs"}
                      for s_, p in predict.items()},
          "predict_forward_ms_runs": {s_: p["forward_ms_runs"] for s_, p in predict.items()},
          "fuse_float32_512": fuse, "bucket_steps": bucket_steps,
          "train": {**MS_TRAIN, "printed_buckets": printed, "buckets_drawn": buckets_drawn,
                    "jax_rule": want, "losses": train_losses, "wall_s": train_s},
          "val_imgsz": MS_VAL_IMGSZ, "val_labels_per_image": [min(labels["per_image"]),
                                                               max(labels["per_image"])],
          "val": {k: float(v) for k, v in res.items()}, "val_launches": val_launches,
          "launches": totals, "seconds": time.perf_counter() - t_phase,
          "note": "predict forward_ms: normalise + forward + top-k of a letterboxed uint8 batch "
                  "of 8 on the card, median of 6 CUDA-event windows of 3 forwards, the sizes in "
                  "turns 512, 640, 768, 768, 640, 512; step_ms: host clock around each "
                  "synchronised optimizer step at batch 8 (the first warms the bucket up)"})
    if printed != list(MS_BUCKETS) or buckets_drawn != want or not buckets_drawn:
        raise AssertionError(f"multi-scale buckets printed {printed}, drawn {buckets_drawn}, "
                             f"JAX's draw {want}")
    if not all(math.isfinite(v) for v in train_losses):
        raise AssertionError(f"multi-scale train: a non-finite loss {train_losses}")
    if val_launches != 2 * per_val:
        raise AssertionError(f"val at {MS_VAL_IMGSZ}: {val_launches} inference launches, "
                             f"expected {2 * per_val}")
    if not mAP50 >= 0.9:
        raise AssertionError(f"self-labelled val at {MS_VAL_IMGSZ}: mAP50 {mAP50} (need 0.9)")
    return {**totals, "worst": worst, "predict": predict,
            "bucket_ms": {b: statistics.median(v["step_ms"][1:]) for b, v in bucket_steps.items()}}


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


def phase_train_kernels(cw, epi, ffn, ws=FLAGSHIP):
    """The four training kernels against their plain versions at the
    flagship shapes, float32 and bfloat16."""
    import torch

    B, NH, DH, H, D, U = ws.dims
    worst = {k: {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]} for k in KERNELS}

    def note(name, key, errs):
        worst[name][key] = [max(a, b) for a, b in zip(worst[name][key], errs)]

    cases = [(S, "open", False) for S in SEQ_LENS] + [
        (1000, "open", True), (1600, "closed", False)]
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[-1]
        rel = GRAD_REL[key]
        for S, gates, states in cases:
            args = kernel_inputs(S, dtype, gates, states, seed=S + 1, ws=ws)
            got = cw.mlstm_siging_chunkwise_fw_train(*args, eps=EPS)
            torch.cuda.synchronize()
            outs = [got[0], *got[1], *got[2]]
            split = {}
            if dtype == torch.float32:
                ref = cw.mlstm_siging_chunkwise_fw_train_plain(*args, eps=EPS)
                e_fw = compare_outputs(f"fw_train S={S} {key}", outs, [ref[0], *ref[1], *ref[2]],
                                       rel)
            else:  # against the two plain passes, which round where the kernel and JAX do
                ref = cw.mlstm_siging_chunkwise_fw_train_plain(*args, eps=EPS)
                split["fw_train_max_rel_err_vs_unrounded_plain"] = max(
                    (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
                    for a, b in zip(outs, [ref[0], *ref[1], *ref[2]]))
                sh, sden, scs, sns, scl, snl = fw_split(cw, args)
                h_, cl_, nl_, cs_, ns_, den_ = outs
                parts = [compare_outputs(f"fw_train h vs passes S={S}", [h_], [sh], rel),
                         compare_outputs(f"fw_train C vs passes S={S}", [cl_, cs_], [scl, scs],
                                         BF16_STATE_REL),
                         compare_outputs(f"fw_train n, den vs passes S={S}", [nl_, ns_, den_],
                                         [snl, sns, sden], F32_TOL)]
                e_fw = tuple(max(p[j] for p in parts) for j in range(2))
                split["fw_train_max_rel_err_vs_passes"] = {
                    "h": parts[0][1], "c": parts[1][1], "n_den": parts[2][1]}
                unr = fw_split(cw, unrounded(args))
                split["fw_train_mean_err_over_unrounded"] = rounding_shows(
                    f"fw_train S={S}", [h_, cl_, cs_], [sh, scl, scs], [unr[0], unr[4], unr[2]])
                del sh, sden, scs, sns, scl, snl, unr
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
            # each pass of the backward alone against its plain version
            q_, f_ = args[0], args[4]
            dcs = cw.mlstm_siging_chunkwise_bw_dc(q_, f_, NH, den, dh, dcl, eps=EPS)
            rdcs = cw.mlstm_siging_chunkwise_bw_dc_plain(q_, f_, NH, den, dh, dcl, eps=EPS)
            passes = {"bw_dc_max_rel_err": compare_outputs(f"bw_dc S={S}", dcs, rdcs, rel)[1]}
            got_p = cw.mlstm_siging_chunkwise_bw_dqkv(*args[:6], cs, den, dh, rdcs[0], eps=EPS)
            ref_p = cw.mlstm_siging_chunkwise_bw_dqkv_plain(*args[:6], cs, den, dh, rdcs[0],
                                                            eps=EPS)
            passes["bw_dqkv_max_rel_err"] = compare_outputs(f"bw_dqkv S={S}", got_p, ref_p,
                                                            rel)[1]
            del dcs, rdcs, got_p, ref_p
            emit({"phase": "train_kernels", "widths": ws.cfg, "S": S, "dtype": key, "gates": gates,
                  "initial_states": states, "dc_last": states, "rel_tol": rel,
                  "fw_train_max_abs_err": e_fw[0], "fw_train_max_rel_err": e_fw[1],
                  **split, "bw_max_abs_err": e_bw[0], "bw_max_rel_err": e_bw[1], **passes})
            del args, got, ref, gb, rb, bw_args
        for S, offset in [(S, 0.0) for S in SEQ_LENS] + [(1000, 0.0), (1600, 30.0)]:
            e_args, f_args = row_inputs(S, dtype, offset, seed=S + 3, ws=ws)
            ge = epi.epilogue_bwd(*e_args)
            gf = ffn.ffn_bwd(*f_args)
            torch.cuda.synchronize()
            e_epi = compare_outputs(f"epilogue S={S} {key}", ge, epi.epilogue_bwd_plain(*e_args),
                                    rel)
            e_epi_r = compare_outputs(f"epilogue vs rounded S={S} {key}", ge,
                                      epi.epilogue_bwd_rounded_plain(*e_args), rel)
            e_ffn = compare_outputs(f"ffn S={S} {key}", gf, ffn.ffn_bwd_plain(*f_args), rel)
            note("epilogue_bw", key, e_epi)
            note("ffn_bw", key, e_ffn)
            emit({"phase": "train_kernels", "widths": ws.cfg, "S": S, "dtype": key,
                  "mean_offset": offset,
                  "rel_tol": rel, "epilogue_max_abs_err": e_epi[0],
                  "epilogue_max_rel_err": e_epi[1],
                  "epilogue_max_rel_err_vs_rounded_plain": e_epi_r[1], "ffn_max_abs_err": e_ffn[0],
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


def phase_train(cw, epi, ffn, steps, cfg="vil-det-192.yaml", n_steps=TRAIN_STEPS):
    """The training path: detect_trainer on ``cfg``, ``n_steps`` steps."""
    import torch

    from xlstm_yolo_tpu_torch.engine import optimizers as opt_lib

    model, state, step = steps.detect_trainer(
        cfg, device="cuda", compute_dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(0), **TRAIN_OPT)
    perturb_ifgates(model, seed=7)
    state.ema = opt_lib.ema_init(list(state.params.values()))  # of the perturbed model
    expected = expected_step_launches(model)
    p0 = [p.detach().clone() for p in state.params.values()]
    e0 = [e.clone() for e in state.ema.params]
    batches = [train_batch(B, 640, seed=10 + j) for j in range(n_steps)]
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
    emit({"phase": "train", "cfg": cfg, "batch": B, "imgsz": 640,
          "compute_dtype": "bfloat16", "param_dtype": "float32", "optimizer": TRAIN_OPT,
          "ema": True, "steps": n_steps, "state_step": state.step, "metrics": metrics_log,
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


def ffn_matmul_yardstick(f_args, ws) -> float:
    """ms of the FFN backward's four products as ``torch.matmul`` (cuBLAS,
    bf16 operands, float32 sums) at the kernel's shapes: dact = g Wd, dxn =
    dgz Wgz, dWd = g^T act, dWgz = dgz^T xn (gz standing in for dgz and
    its first half for act).  A yardstick of what the tensor cores give
    through a library; the port never calls it."""
    import torch

    x, gz, g, _, wgz, wd = f_args
    D, U = ws.D, ws.U
    gm, xm, gzm = g.reshape(-1, D), x.reshape(-1, D), gz.reshape(-1, 2 * U)
    wdb, wgzb, act = wd.to(gm.dtype), wgz.to(gm.dtype), gzm[:, :U].contiguous()

    def four():
        torch.matmul(gm, wdb)
        torch.matmul(gzm, wgzb)
        torch.matmul(gm.t(), act)
        torch.matmul(gzm.t(), xm)

    return statistics.median(time_cuda(four, iters=iters_for(ws, 10), reps=3, warm_s=0.1))


# the kernels of each redesigned function (bf16), by name in a profiler
# trace, with their launches a call
FW_PASSES = {"fw_state_kernel": 1, "fw_out_kernel": 1}
CHUNK_FW_PASSES = {"fw_scan_kernel": 1, "fw_h_kernel": 1}  # the v1 and exp forwards' template
CHUNK_DC_PASSES = {"dc_inc_kernel": 1, "dc_combine_kernel": 1}  # and their dC scans'
CHUNK_FW_SHAPE = (6656, 512)  # (S, L) of their passes' readings: the routes' largest call
PASSES = {"chunkwise_fw": FW_PASSES, "chunkwise_fw_train": FW_PASSES,
          "chunkwise_bw": {"bw_dc_kernel": 1, "bw_dqkv_kernel": 1},
          "epilogue_bw": {"epilogue_rows_kernel": 1, "wgrad_tc_kernel": 1, "reduce_kernel": 2},
          "ffn_bw": {"ffn_rows_kernel": 1, "wgrad_tc_kernel": 2, "reduce_kernel": 3},
          "chunkwise_v1_fw": CHUNK_FW_PASSES, "chunkwise_exp_fw": CHUNK_FW_PASSES,
          "chunkwise_v1_bw_dc": CHUNK_DC_PASSES, "chunkwise_exp_bw_dc": CHUNK_DC_PASSES}
# the libraries whose kernels run their bf16 products on the tensor cores
TC_LIBRARIES = ("chunkwise_fw", "chunkwise_bw", "epilogue_bw", "ffn_bw", "parallel_fw",
                "parallel_bw", "chunkwise_v1_fw", "chunkwise_v1_bw", "chunkwise_exp_fw",
                "chunkwise_exp_bw")


def ptxas_summary(log: str) -> list:
    """One line per kernel from ``nvcc -Xptxas -v`` output: the entry
    function's mangled name up to its parameter list, its registers and
    its spill stores."""
    out, fn, spill = [], "?", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1].split("EEv")[0]
        elif "spill stores" in line:
            spill = line.strip().split(",")[1].strip()
        elif "registers" in line:
            regs = line.split("Used", 1)[1].split(",")[0].strip()
            out.append(f"{fn}: {regs}, {spill}")
    return out


def sass_mma_counts(library) -> dict | str:
    """Tensor-core instructions (HMMA) in the machine code of each kernel of
    a built library, read with the toolkit's cuobjdump; kernels with none
    are left out."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                              timeout=120).stdout
    except (OSError, subprocess.TimeoutExpired):
        return "not measured"
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
        elif fn and "HMMA" in line:
            counts[fn] = counts.get(fn, 0) + 1
    return counts


def phase_passes_times(cw, epi, ffn, v1, ex, card: str) -> dict:
    """The device time of each kernel of the redesigned functions, the v2
    forward (state scan, output pass; inference and train variants), the v2
    backward (dC scan, dq/dk/dv), the epilogue backward and the FFN backward
    (row pass, weight gradients, sums), at each S, and the v1 and exp
    forwards (state pass, output pass; the train variant) and dC scans
    (increments, combine) at CHUNK_FW_SHAPE, at every detector's widths,
    bf16, from a torch.profiler trace of 10 calls (kernels_device_ms), and
    each pass of the v2 forward and backward alone
    through its wrapper in CUDA-event windows.  It runs early:
    in this script's long process, traces taken after its later phases
    missed most kernel events of these calls (PR 9, run 2), which no probe
    of those traces alone reproduced."""
    import torch

    out = {}
    for ws in (FLAGSHIP, *WIDE):
        B, NH, DH, H, D, U = ws.dims
        per = {name: {} for name in PASSES}
        for S in SEQ_LENS:
            args = kernel_inputs(S, torch.bfloat16, seed=S, ws=ws)
            _, _, (cs, ns, den) = cw.mlstm_siging_chunkwise_fw_train(*args, eps=EPS)
            dh = torch.randn(B, S, H, generator=torch.Generator().manual_seed(S)).to(
                "cuda", torch.bfloat16)
            e_args, f_args = row_inputs(S, torch.bfloat16, seed=S, ws=ws)
            q, f = args[0], args[4]
            dcs = cw.mlstm_siging_chunkwise_bw_dc(q, f, NH, den, dh, eps=EPS)[0]
            n = iters_for(ws, 10)
            for name, fn, save in (
                    ("chunkwise_fw", lambda: cw.mlstm_siging_chunkwise_fw(*args, eps=EPS), False),
                    ("chunkwise_fw_train",
                     lambda: cw.mlstm_siging_chunkwise_fw_train(*args, eps=EPS), True)):
                c_in = cs if save else cs.to(q.dtype)
                per[name][S] = {
                    "passes_device_ms": kernels_device_ms(fn, PASSES[name]),
                    "passes_event_ms": {
                        "fw_state_kernel": statistics.median(time_cuda(
                            lambda: cw.mlstm_siging_chunkwise_fw_states(
                                *args[1:], save_states=save), iters=n, reps=3, warm_s=0.1)),
                        "fw_out_kernel": statistics.median(time_cuda(
                            lambda: cw.mlstm_siging_chunkwise_fw_out(*args[:6], c_in, ns,
                                                                     eps=EPS),
                            iters=n, reps=3, warm_s=0.1))}}
            per["epilogue_bw"][S] = {"passes_device_ms": kernels_device_ms(
                lambda: epi.epilogue_bwd(*e_args), PASSES["epilogue_bw"])}
            per["chunkwise_bw"][S] = {
                "passes_device_ms": kernels_device_ms(
                    lambda: cw.mlstm_siging_chunkwise_bw(*args[:6], cs, den, dh, eps=EPS),
                    PASSES["chunkwise_bw"]),
                "passes_event_ms": {
                    "bw_dc_kernel": statistics.median(time_cuda(
                        lambda: cw.mlstm_siging_chunkwise_bw_dc(q, f, NH, den, dh, eps=EPS),
                        iters=n, reps=3, warm_s=0.1)),
                    "bw_dqkv_kernel": statistics.median(time_cuda(
                        lambda: cw.mlstm_siging_chunkwise_bw_dqkv(*args[:6], cs, den, dh, dcs,
                                                                  eps=EPS),
                        iters=n, reps=3, warm_s=0.1))}}
            per["ffn_bw"][S] = {"passes_device_ms": kernels_device_ms(
                lambda: ffn.ffn_bwd(*f_args), PASSES["ffn_bw"])}
            for name, by_s in per.items():
                if S in by_s:
                    emit({"phase": "times", "what": f"{name}_passes", "widths": ws.cfg,
                          "card": card, "B": B, "S": S, "dtype": "bfloat16", **by_s[S]})
            del args, cs, ns, den, dh, e_args, f_args, dcs
        S, L = CHUNK_FW_SHAPE
        kw = dict(chunk_size=L, eps=EPS)
        a1, dh1, _ = v1_inputs(S, torch.bfloat16, seed=S, ws=ws)
        a2, dh2, _ = exp_inputs(S, torch.bfloat16, seed=S, ws=ws)
        den1 = v1.chunkwise_fw(*a1, **kw)[1]
        _, den2, mc2, _, ms2, (_, _, ml2) = ex.chunkwise_exp_fw(*a2, **kw)
        mrow2 = ex.m_rows(a2[4], ms2, ml2, L)[0]
        for name, fn in (
                ("chunkwise_v1_fw", lambda: v1.chunkwise_fw(*a1, **kw)),
                ("chunkwise_exp_fw", lambda: ex.chunkwise_exp_fw(*a2, **kw)),
                ("chunkwise_v1_bw_dc", lambda: v1.chunkwise_bw_dc(a1[0], a1[4], dh1, den1, **kw)),
                ("chunkwise_exp_bw_dc", lambda: ex.chunkwise_exp_bw_dc(a2[0], a2[4], dh2, den2,
                                                                       mc2, mrow2, **kw))):
            per[name][(S, L)] = {"passes_device_ms": kernels_device_ms(fn, PASSES[name])}
            emit({"phase": "times", "what": f"{name}_passes", "widths": ws.cfg, "card": card,
                  "B": B, "S": S, "L": L, "dtype": "bfloat16",
                  "variant": "train" if name.endswith("fw") else "", **per[name][(S, L)]})
        del a1, a2, dh1, dh2, den1, den2, mc2, ms2, ml2, mrow2
        out[ws.cfg] = per
    return out


def phase_train_times(cw, epi, ffn, card: str, ws=FLAGSHIP, passes=None):
    """Per-call times of the four training kernels at each S (bf16) with
    their plain versions (the train step's time is phase_v1_times'), with
    ``passes``' readings of the backward's and the FFN backward's kernels
    (phase_passes_times) at the same S; beside the FFN backward, on a line
    of its own, its four products as torch.matmul (ffn_matmul_yardstick)."""
    import torch

    B, NH, DH, H, D, U = ws.dims
    passes = passes or {}
    per = {k: {} for k in KERNELS}
    for S in SEQ_LENS:
        args = kernel_inputs(S, torch.bfloat16, seed=S, ws=ws)
        _, _, (cs, _, den) = cw.mlstm_siging_chunkwise_fw_train(*args, eps=EPS)
        dh = torch.randn(B, S, H, generator=torch.Generator().manual_seed(S)).to(
            "cuda", torch.bfloat16)
        e_args, f_args = row_inputs(S, torch.bfloat16, seed=S, ws=ws)
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
        emit({"phase": "times", "what": "ffn_bw_matmul_yardstick", "widths": ws.cfg,
              "card": card, "B": B, "S": S, "D": D, "U": U, "dtype": "bfloat16",
              "matmul_ms": ffn_matmul_yardstick(f_args, ws),
              "note": "the FFN backward's four products (12 M D U flop) as torch.matmul "
                      "(cuBLAS) at the same shapes, without the norm, gate and column sums; "
                      "a yardstick only, no part of the port"})
        for name, (kern, plain) in pairs.items():
            n = iters_for(ws, 10)
            t_kern, t_plain = in_turns(kern, plain, n, 3, ws=ws)
            row = {"ms": statistics.median(t_kern), "plain_ms": statistics.median(t_plain),
                   **dict(zip(("bound_ms", "bound_by"), train_bound(name, S, ws=ws)))}
            row.update(passes.get(name, {}).get(S, {}))
            per[name][S] = row
            emit({"phase": "times", "widths": ws.cfg, "what": name, "card": card, "B": B, "S": S,
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


def v1_inputs(S, dtype, gates="open", states=False, seed=0, device="cuda", ws=FLAGSHIP):
    """Flagship-width (B, NH, S, DH) streams, (B, NH, S) gates, states, dh
    and dC_last on the card."""
    import torch

    B, NH, DH, H, D, U = ws.dims
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
             save: bool = True, ws=FLAGSHIP):
    """Least time for one call of a v1 or exp kernel at batch B in ms: each
    input read once and each output written once over HBM bandwidth,
    against the causal products at the bf16 peak (PERF.md).  ``states``:
    the forward reads initial states (the inference segments); ``save``:
    the exp forward writes its saved rows (training), else h and the last
    states only (predict).  The exp kernels move m_comb per row (f32) and m
    (forward) or [m_prev, gbar | m_new] (backward) per chunk besides, and
    write dq, dk, dv in the input dtype."""
    B, NH, DH, H, D, U = ws.dims
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


def phase_v1_kernels(v1, shapes, device="cuda", ws=FLAGSHIP):
    """The three v1 kernels against their plain versions at the flagship
    shapes (B 8, NH 12, DH 32; or ``ws``) and every (S, L) the route gives them:
    float32 streams with float32 products (1e-4), and the route's own
    bfloat16 streams and products (2e-2), relative to each output's
    largest |value|; initial states and dC_last on the inference segments,
    closed forget gates on one case.  In bfloat16 dq/dk/dv's outputs must
    also lie nearer their plain version in mean error than the plain version
    with float32 products does, by more than half (rounding_shows), and so
    must the forward's and the dC scan's (those the products reach by more
    than FW_MIN_GAP of their mean |value|)."""
    import torch

    B, NH, DH, H, D, U = ws.dims
    worst = {k: {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]} for k in V1_KERNELS}
    cases = [(S, L, "open", states) for (S, L), states in shapes] + [(2048, 512, "closed", True)]
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[-1]
        rel = GRAD_REL[key]
        for S, L, gates, states in cases:
            args, dh, dcl = v1_inputs(S, dtype, gates, states, seed=S + L, device=device, ws=ws)
            kw = dict(chunk_size=L, eps=EPS, compute_dtype=dtype)
            got = v1.chunkwise_fw(*args, **kw)
            torch.cuda.synchronize()
            ref = v1.chunkwise_fw_plain(*args, **kw)
            e_fw = compare_outputs(f"v1 fw S={S} L={L} {key}", got, ref, rel)
            ratio_fw = {} if dtype != torch.bfloat16 else {
                "chunkwise_v1_fw_mean_err_over_unrounded": rounding_shows(
                    f"v1 fw S={S} L={L} {gates}", got, ref,
                    v1.chunkwise_fw_plain(*args, **dict(kw, compute_dtype=torch.float32)),
                    FW_MIN_GAP)}
            q, k, v, i, f = args[:5]
            _, den, cs = ref[:3]
            dcs, dc0 = v1.chunkwise_bw_dc(q, f, dh, den, dcl, **kw)
            torch.cuda.synchronize()
            rdcs, rdc0 = v1.chunkwise_bw_dc_plain(q, f, dh, den, dcl, **kw)
            e_dc = compare_outputs(f"v1 bw_dc S={S} L={L} {key}", (dcs, dc0), (rdcs, rdc0), rel)
            ratio_dc = {} if dtype != torch.bfloat16 else {
                "chunkwise_v1_bw_dc_mean_err_over_unrounded": rounding_shows(
                    f"v1 bw_dc S={S} L={L} {gates}", (dcs, dc0), (rdcs, rdc0),
                    v1.chunkwise_bw_dc_plain(q, f, dh, den, dcl,
                                             **dict(kw, compute_dtype=torch.float32)),
                    FW_MIN_GAP)}
            got_b = v1.chunkwise_bw_dqkv(q, k, v, i, f, cs, den, dh, rdcs, **kw)
            torch.cuda.synchronize()
            ref_b = v1.chunkwise_bw_dqkv_plain(q, k, v, i, f, cs, den, dh, rdcs, **kw)
            e_qkv = compare_outputs(f"v1 bw_dqkv S={S} L={L} {key}", got_b, ref_b, rel)
            # bf16: nearer the plain version than its float32-products twin is
            ratio = {} if dtype != torch.bfloat16 else {
                "chunkwise_v1_bw_dqkv_mean_err_over_unrounded": rounding_shows(
                    f"v1 bw_dqkv S={S} L={L} {gates}", got_b, ref_b, v1.chunkwise_bw_dqkv_plain(
                        q, k, v, i, f, cs, den, dh, rdcs, **dict(kw, compute_dtype=torch.float32)))}
            for name, e in zip(V1_KERNELS, (e_fw, e_dc, e_qkv)):
                worst[name][key] = [max(a, b) for a, b in zip(worst[name][key], e)]
            emit({"phase": "v1_kernels", "widths": ws.cfg, "S": S, "L": L, "dtype": key,
                  "compute_dtype": key,
                  "gates": gates, "initial_states": states, "dc_last": states, "rel_tol": rel,
                  **{f"{n}_max_rel_err": e[1] for n, e in zip(V1_KERNELS, (e_fw, e_dc, e_qkv))},
                  **ratio_fw, **ratio_dc, **ratio})
            del args, dh, dcl, got, ref, got_b, ref_b, dcs, rdcs
    return worst


def phase_v1_predict(v1, cw, yolo, n_images: int = 10):
    """The predict path on the v1 route: YOLO(..., chunkwise_kernel=V1)
    on the images of phase_predict, held to the derived launch count."""
    import numpy as np

    plan = v1_plan(yolo.model)
    per_forward = sum(plan["infer"].values())
    images = synthetic_images(n_images, seed=5)  # 10: batches of 8 and 2, two forwards
    forwards = -(-len(images) // B)
    cw.LAUNCHES = v1.LAUNCHES_FW = v1.LAUNCHES_BW_DC = v1.LAUNCHES_BW_DQKV = 0
    results = yolo.predict(images, batch=B, conf=0.0)
    launches, v2_launches = v1.LAUNCHES_FW, cw.LAUNCHES
    ok = len(results) == len(images) and all(
        np.isfinite(r.boxes.data).all() and r.orig_img.shape == im.shape
        for r, im in zip(results, images))
    emit({"phase": "v1_predict", "cfg": cfg_name(yolo), "chunkwise_kernel": V1,
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


def phase_v1_train(v1, cw, epi, ffn, steps, cfg="vil-det-192.yaml", imgsz=640, device="cuda",
                   n_steps=TRAIN_STEPS):
    """The training path on the v1 route: detect_trainer(..., chunkwise_kernel
    =V1), n_steps bf16 steps, exact launches per step."""
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
    batches = [train_batch(B, imgsz, seed=10 + j, device=device) for j in range(n_steps)]
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
    emit({"phase": "v1_train", "cfg": cfg, "chunkwise_kernel": V1, "batch": B,
          "imgsz": imgsz, "compute_dtype": "bfloat16", "steps": n_steps,
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


def exp_inputs(S, dtype, gates="open", states=False, seed=0, device="cuda", ws=FLAGSHIP):
    """Flagship-width (B, NH, S, DH) streams, (B, NH, S) gates (open: i ~
    N(0, 1), f ~ N(2, 1); closed: f ~ U(-60, -20); large_i: i ~ U(5, 15)),
    initial (C, n, m), dh and dC_last on the card."""
    import torch

    B, NH, DH, H, D, U = ws.dims
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


def phase_exp_kernels(ex, shapes, device="cuda", ws=FLAGSHIP):
    """The three exp kernels against their plain versions at the flagship
    shapes (B 8, NH 12, DH 32; or ``ws``) and every (S, L) the route gives them, open
    gates, with initial (C, n, m) and dC_last on the inference segments; and
    at EXP_REGIMES with closed forget gates and with large input gates.
    float32 streams and products (1e-4) and the route's bfloat16 (2e-2),
    relative to each output's largest |value|.  h is held as its numerator
    h (den + eps) beside den: once m is large the floor e^{-m_comb} of the
    denominator is tiny, and a row whose terms nearly cancel turns a float32
    rounding of den into a large relative change of h (its own error is
    reported as h_max_rel_err).  The predict variant's h and last states
    must equal the training variant's bit for bit.  In bfloat16 the
    forward's outputs (h as its numerator, as above), the dC scan's and
    dq/dk/dv's must also lie nearer their plain version in mean error than
    the plain version with float32 products does, by more than half
    (rounding_shows)."""
    import torch

    B, NH, DH, H, D, U = ws.dims
    worst = {k: {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]} for k in EXP_KERNELS}
    cases = [(S, L, "open", states) for (S, L), states in shapes] + [
        (S, L, gates, states) for gates in ("closed", "large_i") for S, L, states in EXP_REGIMES]
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[-1]
        rel = GRAD_REL[key]
        for S, L, gates, states in cases:
            args, dh, dcl = exp_inputs(S, dtype, gates, states, seed=S + L + 1, device=device,
                                        ws=ws)
            kw = dict(chunk_size=L, eps=EPS, compute_dtype=dtype)
            got = ex.chunkwise_exp_fw(*args, **kw)
            got_p = ex.chunkwise_exp_fw(*args, save_states=False, **kw)
            torch.cuda.synchronize()
            ref = ex.chunkwise_exp_fw_plain(*args, **kw)
            num = lambda out: out[0].float() * (out[1] + EPS)[..., None]  # noqa: E731
            outs = lambda out: [num(out), *out[1:5], *out[5]]  # noqa: E731
            e_fw = compare_outputs(f"exp fw S={S} L={L} {gates} {key}", outs(got), outs(ref), rel)
            ratio_fw = {} if dtype != torch.bfloat16 else {
                "chunkwise_exp_fw_mean_err_over_unrounded": rounding_shows(
                    f"exp fw S={S} L={L} {gates}", outs(got), outs(ref), outs(
                        ex.chunkwise_exp_fw_plain(*args, **dict(kw, compute_dtype=torch.float32))),
                    FW_MIN_GAP)}
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
            ratio_dc = {} if dtype != torch.bfloat16 else {
                "chunkwise_exp_bw_dc_mean_err_over_unrounded": rounding_shows(
                    f"exp bw_dc S={S} L={L} {gates}", (dcs, dc0), (rdcs, rdc0),
                    ex.chunkwise_exp_bw_dc_plain(q, f, dh, den, mc, mrow_dc, dcl,
                                                 **dict(kw, compute_dtype=torch.float32)),
                    FW_MIN_GAP)}
            got_b = ex.chunkwise_exp_bw_dqkv(q, k, v, i, f, cs, den, mc, mrow_qkv, dh, rdcs, **kw)
            torch.cuda.synchronize()
            bw = (q, k, v, i, f, cs, den, mc, mrow_qkv, dh, rdcs)
            ref_b = ex.chunkwise_exp_bw_dqkv_plain(*bw, **kw)
            e_qkv = compare_outputs(f"exp bw_dqkv S={S} L={L} {gates} {key}", got_b, ref_b, rel)
            ratio = {} if dtype != torch.bfloat16 else {
                "chunkwise_exp_bw_dqkv_mean_err_over_unrounded": rounding_shows(
                    f"exp bw_dqkv S={S} L={L} {gates}", got_b, ref_b,
                    ex.chunkwise_exp_bw_dqkv_plain(*bw, **dict(kw, compute_dtype=torch.float32)))}
            for name, e in zip(EXP_KERNELS, (e_fw, e_dc, e_qkv)):
                worst[name][key] = [max(a, b) for a, b in zip(worst[name][key], e)]
            emit({"phase": "exp_kernels", "widths": ws.cfg, "S": S, "L": L, "dtype": key,
                  "compute_dtype": key,
                  "gates": gates, "initial_states": states, "dc_last": states, "rel_tol": rel,
                  "m_last_range": [m_last.min().item(), m_last.max().item()],
                  "h_max_rel_err": h_rel,
                  **{f"{n}_max_rel_err": e[1] for n, e in zip(EXP_KERNELS, (e_fw, e_dc, e_qkv))},
                  **ratio_fw, **ratio_dc, **ratio})
            del args, dh, dcl, got, got_p, ref, got_b, ref_b, dcs, rdcs, bw
    return worst


def phase_exp_predict(ex, v1, cw, yolo, n_images: int = 10):
    """The predict path on the exp route: YOLO(..., chunkwise_kernel=EXP)
    on the images of phase_predict, held to the launch count derived from
    the wrappers' segment plan (the v1 route's plan), no v1 or v2 launch."""
    import numpy as np

    plan = v1_plan(yolo.model)
    per_forward = sum(plan["infer"].values())
    images = synthetic_images(n_images, seed=5)  # 10: batches of 8 and 2, two forwards
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
    emit({"phase": "exp_predict", "cfg": cfg_name(yolo), "chunkwise_kernel": EXP,
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
                    device="cuda", n_steps=TRAIN_STEPS):
    """The training path on the exp route: detect_trainer(...,
    chunkwise_kernel=EXP), n_steps bf16 steps, exact launches per step."""
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
    batches = [train_batch(B, imgsz, seed=10 + j, device=device) for j in range(n_steps)]
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
    emit({"phase": "exp_train", "cfg": cfg, "chunkwise_kernel": EXP, "batch": B,
          "imgsz": imgsz, "compute_dtype": "bfloat16", "steps": n_steps,
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
    return model, state, step, batches[0], total


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


def par_inputs(S, dtype, gates="open", seed=0, device="cuda", ws=FLAGSHIP):
    """Flagship-width (B, NH, S, DH) streams and dh, (B, NH, S) gates (open:
    i ~ N(0, 1), f ~ U(3, 6), the flagship's forget-gate bias range; closed:
    f ~ U(-60, -20)) on the card."""
    import torch

    B, NH, DH, H, D, U = ws.dims
    g = torch.Generator().manual_seed(seed)
    cu = lambda t, d=torch.float32: t.to(device, d)  # noqa: E731
    q, k, v, dh = (cu(torch.randn(B, NH, S, DH, generator=g), dtype) for _ in range(4))
    i = cu(torch.randn(B, NH, S, generator=g))
    f = cu(torch.rand(B, NH, S, generator=g) * 3 + 3 if gates == "open"
           else torch.rand(B, NH, S, generator=g) * 40 - 60)
    return (q, k, v, i, f), dh


def parallel_bound(name: str, S: int, itemsize: int = 2, ws=FLAGSHIP) -> tuple[float, str]:
    """Least time for one call of a quadratic kernel at batch B in ms: each
    input read once and each output written once over HBM bandwidth (the
    forward: q, k, v, i, f in, h, den out; dq: k, v, dh, i, f, den in, dq
    out; dk/dv: q, k, v, dh, i, f, den in, dk, dv out), against the
    products over the S (S + 1) / 2 causal pairs at the bf16 peak (2 DH
    flop a pair per product: the forward and dq two products, dk/dv
    four)."""
    B, NH, DH, H, D, U = ws.dims
    rows = B * NH * S
    stream, gate = rows * DH * itemsize, rows * 4
    pairs = B * NH * S * (S + 1) / 2
    streams, products = {"parallel_fw": (4, 2), "parallel_bw_dq": (4, 2),
                         "parallel_bw_dkv": (6, 4)}[name]
    return _bound(streams * stream + 3 * gate, products * 2 * DH * pairs)


def step_bound(itemsize: int, ws=FLAGSHIP) -> tuple[float, str]:
    """Least time for one step-kernel call at B, NH, DH of ``ws`` in ms: q, k,
    v, i, f, C, n read and h, C', n' written once over HBM bandwidth,
    against 6 DH^2 + 6 DH float32 operations a head (the C update 4 DH^2,
    q C' 2 DH^2, n and q . n' 6 DH) at the float32 peak."""
    B, NH, DH, H, D, U = ws.dims
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

    B, NH = args[0].shape[:2]
    n = max(1, min(B * NH, int(PLAIN_SLICE_BYTES // (S * S * 4))))
    flat = [a.reshape(B * NH, 1, *a.shape[2:]) for a in args]
    outs = [fn(*(a[j:j + n] for a in flat)) for j in range(0, B * NH, n)]
    outs = [o if isinstance(o, tuple) else (o,) for o in outs]
    joined = [torch.cat(parts).reshape(B, NH, *parts[0].shape[2:]) for parts in zip(*outs)]
    return joined if len(joined) > 1 else joined[0]


def phase_parallel_kernels(pk, lengths, ws=FLAGSHIP):
    """The three quadratic kernels against their plain versions at the
    flagship shapes (B 8, NH 12, DH 32; or ``ws``) and at each S the route pads the
    flagship's sequences to, float32 (products float32) and bfloat16
    (products bfloat16), with open and with closed forget gates; the plain
    versions run over slices of batch * head (plain_in_slices).  Each
    output within GRAD_REL of its largest |value|; the backward kernels on
    the forward kernel's den, given to both sides.  In bfloat16 each
    kernel's outputs must also lie nearer their plain version in mean error
    than the plain version with float32 products does, by more than half
    (rounding_shows): a kernel that skipped the rounding of its products'
    operands fails."""
    import torch

    B, NH, DH, H, D, U = ws.dims
    worst = {k: {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]} for k in PAR_KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[-1]
        rel = GRAD_REL[key]
        for S in lengths:
            for gates in ("open", "closed"):
                args, dh = par_inputs(S, dtype, gates, seed=S + (gates == "closed"), ws=ws)
                kw = dict(eps=EPS, compute_dtype=dtype)
                h, den = pk.parallel_fw(*args, **kw)
                dq = pk.parallel_bw_dq(*args, den, dh, **kw)
                dk, dv = pk.parallel_bw_dkv(*args, den, dh, **kw)
                torch.cuda.synchronize()
                bw = (*args, den, dh)

                def plain(name, compute=dtype):  # a tuple of outputs, dq's too
                    fn = functools.partial(getattr(pk, f"{name}_plain"), eps=EPS,
                                           compute_dtype=compute)
                    out = plain_in_slices(fn, bw if "bw" in name else args, S)
                    return tuple(out) if isinstance(out, list) else (out,)

                got = {"parallel_fw": (h, den), "parallel_bw_dq": (dq,),
                       "parallel_bw_dkv": (dk, dv)}
                refs = {name: plain(name) for name in PAR_KERNELS}
                errs = {name: compare_outputs(f"{name} S={S} {gates} {key}", got[name],
                                              refs[name], rel) for name in PAR_KERNELS}
                # bf16: each output nearer the plain version in mean error than
                # its float32-products twin is (rounding_shows)
                ratios = {name: rounding_shows(f"{name} S={S} {gates}", got[name], refs[name],
                                               plain(name, torch.float32))
                          for name in PAR_KERNELS if dtype == torch.bfloat16}
                for name, e in errs.items():
                    worst[name][key] = [max(a, b) for a, b in zip(worst[name][key], e)]
                emit({"phase": "parallel_kernels", "widths": ws.cfg, "S": S, "dtype": key,
                      "compute_dtype": key,
                      "gates": gates, "rel_tol": rel,
                      "den_gt_1_share": (den > 1).float().mean().item(),
                      **{f"{n}_max_rel_err": e[1] for n, e in errs.items()},
                      **{f"{n}_mean_err_over_unrounded": r for n, r in ratios.items()}})
                del args, dh, h, den, dq, dk, dv, bw, got, refs
    return worst


def phase_parallel_train(pk, ex, v1, cw, epi, ffn, steps, cfg="vil-det-192.yaml", imgsz=640,
                         device="cuda", n_steps=TRAIN_STEPS):
    """The training path on the quadratic route: detect_trainer(...,
    chunkwise_kernel=PAR), n_steps bf16 steps, exact launches per step:
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
    batches = [train_batch(B, imgsz, seed=10 + j, device=device) for j in range(n_steps)]
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
    emit({"phase": "parallel_train", "cfg": cfg, "chunkwise_kernel": PAR, "batch": B,
          "imgsz": imgsz, "compute_dtype": "bfloat16", "steps": n_steps,
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
    return model, state, step, batches[0], total


def phase_parallel_grads(pk, steps, device="cuda"):
    """phase_route_grads on the quadratic route."""
    phase_route_grads("parallel_grads", PAR, pk, PAR_KERNELS, pk.mlstm_siging_parallel_kernel,
                      lambda: par_counts(pk), steps, device=device)


def step_inputs(dtype, gates, seed, ws=FLAGSHIP):
    """One token at the flagship's heads: q, k, v (B, NH, DH), gates (B,
    NH) (open: i ~ N(0, 2), f ~ N(2, 1); closed: f ~ U(-60, -20)), C, n."""
    import torch

    B, NH, DH, H, D, U = ws.dims
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, NH, DH, generator=g).to("cuda", dtype) for _ in range(3))
    i = (torch.randn(B, NH, generator=g) * 2).cuda()
    f = (torch.randn(B, NH, generator=g) + 2 if gates == "open"
         else torch.rand(B, NH, generator=g) * 40 - 60).cuda()
    c, n = torch.randn(B, NH, DH, DH, generator=g).cuda(), torch.randn(B, NH, DH, generator=g).cuda()
    return q, k, v, i, f, c, n


def phase_step_kernel(stp, ws=FLAGSHIP):
    """The step kernel against ``mlstm_siging_step`` at B 8, NH 12, DH 32 (or ``ws``):
    q, k, v float32 and bfloat16, C and n float32, open and closed forget
    gates; h within GRAD_REL of its largest |value|, (C', n') within
    GRAD_REL["float32"]."""
    import torch

    from xlstm_yolo_tpu_torch.ops.mlstm_recurrent import mlstm_siging_step

    B, NH, DH, H, D, U = ws.dims
    worst = {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]}
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[-1]
        for gates in ("open", "closed"):
            args = step_inputs(dtype, gates, seed=3 + (gates == "closed"), ws=ws)
            h, (c, n) = stp.mlstm_siging_step_kernel(*args, eps=EPS)
            torch.cuda.synchronize()
            hp, (cp, np_) = mlstm_siging_step(*args, eps=EPS)
            e_h = compare_outputs(f"step h {gates} {key}", (h,), (hp,), GRAD_REL[key])
            e_s = compare_outputs(f"step state {gates} {key}", (c, n), (cp, np_),
                                  GRAD_REL["float32"])
            worst[key] = [max(a, b, c_) for a, b, c_ in zip(worst[key], e_h, e_s)]
            emit({"phase": "step_kernel", "widths": ws.cfg, "dtype": key, "gates": gates, "B": B,
                  "NH": NH,
                  "DH": DH, "h_max_rel_err": e_h[1], "state_max_rel_err": e_s[1],
                  "rel_tol": {"h": GRAD_REL[key], "state": GRAD_REL["float32"]}})
    return worst


def step_times(stp, ws=FLAGSHIP) -> dict:
    """Per-call times of the step kernel and the plain step at one token,
    float32 and bfloat16, in turns plain, kernel, kernel, plain (CUDA-event
    windows of 200 calls: the rate at which the wrapper issues calls); the
    kernel's device ms from a profiler trace of 200 calls; the host's issue
    ms a call (host clock around 1000 calls, no synchronise; best of 3)."""
    import torch

    from xlstm_yolo_tpu_torch.ops.mlstm_recurrent import mlstm_siging_step

    per_call = {}
    for key, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        args = step_inputs(dtype, "open", seed=11, ws=ws)
        kern = lambda: stp.mlstm_siging_step_kernel(*args, eps=EPS)  # noqa: E731
        plain = lambda: mlstm_siging_step(*args, eps=EPS)  # noqa: E731
        t_plain = time_cuda(plain, iters=50, reps=3)
        t_kern = time_cuda(kern, iters=200, reps=3) + time_cuda(kern, iters=200, reps=3)
        t_plain += time_cuda(plain, iters=50, reps=3)
        dev = kernels_device_ms(kern, {"step_kernel": 1}, calls=200)["step_kernel"]
        issue = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(1000):
                kern()
            issue.append(time.perf_counter() - t0)  # s for 1000 calls: ms a call
            torch.cuda.synchronize()
        per_call[key] = {"ms": statistics.median(t_kern), "plain_ms": statistics.median(t_plain),
                         **dict(zip(("bound_ms", "bound_by"), step_bound(dtype.itemsize, ws=ws))),
                         "device_ms": dev, "host_issue_ms": min(issue),
                         "ms_runs": t_kern, "plain_ms_runs": t_plain}
    return per_call


def phase_decode(stp, cw, card: str, ws=FLAGSHIP):
    """The stateful cell's decode: MatrixLSTMCell(H, NH, step_kernel=
    "step--pallas") of the detector's width (vil-det-192: 384, 12;
    vil-det-384: 768, 6), in eval, weights from seed 0,
    perturbed ifgates, float32.  DECODE_TOKENS tokens one at a time with
    ``state=`` from zeros, each exactly one step-kernel launch and no v2
    launch; h of every token and the final (C, n) against one stateful call
    over the tokens, which is exactly one launch of the v2 inference kernel
    and no step launch (GRAD_REL["float32"] of each output's largest
    |value|).  Then the time of a decode per token (host clock around the
    loop, ending in a synchronise), and the kernel's and the plain step's
    time per call."""
    import torch

    from xlstm_yolo_tpu_torch.nn.layers import MatrixLSTMCell, reset_parameters

    B, NH, DH, H, D, U = ws.dims
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
        stp.LAUNCHES = cw.LAUNCHES = 0
        h_dec, (c_dec, n_dec) = decode()
        torch.cuda.synchronize()
        launches, decode_v2 = stp.LAUNCHES, cw.LAUNCHES
        stp.LAUNCHES = cw.LAUNCHES = 0
        h_all, (c_all, n_all) = cell(q, k, v, state=zeros)
        torch.cuda.synchronize()
        reference = {"chunkwise_fw": cw.LAUNCHES, "mlstm_step": stp.LAUNCHES}
        errs = compare_outputs("decode vs the stateful forward", (h_dec, c_dec, n_dec),
                               (h_all, c_all, n_all), GRAD_REL["float32"])
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) / DECODE_TOKENS * 1e6)
    per_call = step_times(stp, ws)
    out = {"launches": launches, "reference_call_launches": reference,
           "max_abs_err": errs[0], "max_rel_err": errs[1],
           "us_per_token": statistics.median(runs), "us_per_token_runs": runs,
           "per_call": per_call}
    emit({"phase": "decode", "widths": ws.cfg, "card": card, "cell": f"MatrixLSTMCell({H}, {NH})",
          "step_kernel": "step--pallas", "batch": B, "tokens": DECODE_TOKENS,
          "dtype": "float32", **out, "rel_tol": GRAD_REL["float32"],
          "note": "us_per_token: host clock around a decode of 64 tokens (the whole cell: "
                  "ifgate, heads, step kernel, outnorm) ending in a synchronise, 5 runs; "
                  "per_call: CUDA events around 200 step-kernel calls (50 plain calls), "
                  "in turns plain, kernel, kernel, plain"})
    if launches != DECODE_TOKENS or decode_v2 != 0:
        raise AssertionError(f"the decode made {launches} step-kernel and {decode_v2} v2 "
                             f"launches, expected {DECODE_TOKENS} and 0")
    if reference != {"chunkwise_fw": 1, "mlstm_step": 0}:
        raise AssertionError(f"the stateful call over {DECODE_TOKENS} tokens made {reference} "
                             "launches, expected one of the v2 inference kernel and no step")
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


def exp_floor(S: int, sm_mhz, ws=FLAGSHIP):
    """Least time in ms for the one exp a causal pair that each quadratic
    kernel takes, B NH S (S + 1) / 2 of them at 16 ex2 a clock on each SM
    (the special-function units) at the SM clock ``sm_mhz`` read during the
    run; "not measured" without a reading."""
    import torch

    if not isinstance(sm_mhz, (int, float)):
        return "not measured"
    B, NH = ws.B, ws.NH
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return B * NH * S * (S + 1) / 2 / (16 * sms * sm_mhz * 1e6) * 1e3


def chunk_exp_floor(S: int, L: int, sm_mhz, ws=FLAGSHIP):
    """Least time in ms for the one exp a causal pair of a chunk that the v1
    and exp dq/dk/dv kernels take, B NH S (L + 1) / 2 of them, at 16 ex2 a
    clock on each SM at the SM clock ``sm_mhz``; "not measured" without a
    reading."""
    floor = exp_floor(S, sm_mhz, ws)
    return floor if isinstance(floor, str) else floor * (L + 1) / (S + 1)


def timed_row(name, kern, plain, n, ws, bound, S, L):
    """ms and plain_ms (in_turns) with the bound; for the forward and
    dq/dk/dv also the exps' floor at the SM clock sampled while the kernel
    ran (chunk_exp_floor)."""
    with ClockSampler() as clocks:
        t_kern, t_plain = in_turns(kern, plain, n, 2, plain_reps=2, ws=ws)
    row = {"ms": statistics.median(t_kern), "plain_ms": statistics.median(t_plain),
           **dict(zip(("bound_ms", "bound_by"), bound))}
    if name.endswith(("dqkv", "_fw")):
        sm = clocks.summary["clocks.sm"]["median"] if clocks.summary_n else None
        row.update(exp_floor_ms=chunk_exp_floor(S, L, sm, ws), sm_mhz=sm)
    return row, t_kern, t_plain


def phase_parallel_times(pk, card: str, plan, ws=FLAGSHIP):
    """Per-call times of the three quadratic kernels (bf16 streams and
    products) at each padded S of the route beside their plain versions (in
    slices of batch * head, plain_in_slices, timed as a whole), bounds and
    the exps' floor at the median SM clock sampled while the kernels ran
    (exp_floor), in turns plain, kernel, kernel, plain."""
    import torch

    B, NH, DH, H, D, U = ws.dims
    per = {k: {} for k in PAR_KERNELS}
    for S in sorted({S for S, _ in plan["train"]}):
        args, dh = par_inputs(S, torch.bfloat16, seed=S + 2, ws=ws)
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
            with ClockSampler() as clocks:
                t_kern = time_cuda(kern, iters=3, reps=3, warm_s=0.2) + time_cuda(
                    kern, iters=3, reps=3, warm_s=0.0)
            t_plain += time_cuda(plain, iters=1, reps=2, warm_s=0.0)
            sm = clocks.summary["clocks.sm"]["median"] if clocks.summary_n else None
            row = {"ms": statistics.median(t_kern), "plain_ms": statistics.median(t_plain),
                   **dict(zip(("bound_ms", "bound_by"), parallel_bound(name, S, ws=ws))),
                   "exp_floor_ms": exp_floor(S, sm, ws), "sm_mhz": sm}
            per[name][S] = row
            emit({"phase": "times", "widths": ws.cfg, "what": name, "card": card, "B": B, "S": S,
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


def v1_times(v1, card: str, plan, ws=FLAGSHIP, device="cuda"):
    """Per-call times of the v1 kernels (bf16) at each (S, L) of the route
    beside their plain versions and bounds."""
    import torch

    shapes = sorted(set(plan["train"]) | set(plan["infer"]))
    per = {k: {} for k in V1_KERNELS}
    for S, L in shapes:
        infer = (S, L) in plan["infer"]
        args, dh, _ = v1_inputs(S, torch.bfloat16, states=infer, seed=S, device=device, ws=ws)
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
            row, t_kern, t_plain = timed_row(
                name, kern, plain, iters_for(ws, 10), ws,
                v1_bound(name, S, L, states=infer and name == "chunkwise_v1_fw", ws=ws), S, L)
            per[name][(S, L)] = row
            emit({"phase": "times", "what": name, "widths": ws.cfg, "card": card, "B": ws.B,
                  "S": S, "L": L, "dtype": "bfloat16",
                  "calls_per_forward": plan["infer"].get((S, L), 0),
                  "calls_per_step": (plan["train"].get((S, L), 0)
                                     + (plan["remat"].get((S, L), 0) if "fw" in name else 0)),
                  **row, "ms_runs": t_kern, "plain_ms_runs": t_plain})
        del args, dh, den, cs, dcs, pairs
    return per


def phase_v1_times(v1, cw, card: str, plan, yolo_v1, device="cuda"):
    """Per-call times of the v1 kernels (v1_times); the two backward designs
    at the same chunk, L = 64 (v1: the dC scan, then chunk-parallel
    dq/dk/dv, float32 FMA; v2: the same split on the tensor cores); and the
    v1 predict forward on device input."""
    import torch

    from xlstm_yolo_tpu_torch.engine.predictor import DetectionPredictor

    per = v1_times(v1, card, plan, device=device)

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
              "v2_ms": statistics.median(t["v2"]), **split, "v1_runs": t["v1"],
              "v2_runs": t["v2"],
              "note": "v1: chunkwise_v1_bw_dc + chunkwise_v1_bw_dqkv (f32 dq/dk/dv; the gate "
                      "gradients and casts not included); v2: chunkwise_bw (bf16: the dC scan, "
                      "then chunk-parallel dq/dk/dv on the tensor cores)"})
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


def exp_times(ex, card: str, plan, ws=FLAGSHIP, device="cuda"):
    """Per-call times of the exp kernels (bf16) at each (S, L) of the route
    beside their plain versions and bounds (the predict variant of the
    forward at the inference segments, the training variant at the padded
    training lengths)."""
    import torch

    shapes = sorted(set(plan["train"]) | set(plan["infer"]))
    per = {k: {} for k in EXP_KERNELS}
    for S, L in shapes:
        infer = (S, L) in plan["infer"]
        args, dh, _ = exp_inputs(S, torch.bfloat16, states=infer, seed=S, device=device, ws=ws)
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
            fw = name == "chunkwise_exp_fw"
            row, t_kern, t_plain = timed_row(
                name, kern, plain, iters_for(ws, 10), ws,
                v1_bound(name, S, L, states=infer and fw, save=not infer, ws=ws), S, L)
            per[name][(S, L)] = row
            emit({"phase": "times", "what": name, "widths": ws.cfg, "card": card, "B": ws.B,
                  "S": S, "L": L, "dtype": "bfloat16",
                  "variant": ("predict" if infer else "train") if fw else "",
                  "calls_per_forward": plan["infer"].get((S, L), 0),
                  "calls_per_step": (plan["train"].get((S, L), 0)
                                     + (plan["remat"].get((S, L), 0) if fw else 0)),
                  **row, "ms_runs": t_kern, "plain_ms_runs": t_plain})
        del args, dh, den, mc, cs, ms, dcs, pairs
    return per


def phase_exp_times(ex, card: str, plan, yolo_exp, yolo_v2, device="cuda"):
    """Per-call times of the exp kernels (exp_times); the exp and v2 predict
    forwards on device input in turns (v2, exp, exp, v2); a trace of three
    exp forwards (busy share); and the share of the exp forward taken by its
    recurrent tails (each tail timed between two synchronises, in an
    instrumented forward)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from xlstm_yolo_tpu_torch.engine.predictor import DetectionPredictor
    from xlstm_yolo_tpu_torch.ops import backend

    per = exp_times(ex, card, plan, device=device)
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


def traced_step(step, state, batch) -> dict:
    """One train step, then one more in a torch.profiler trace: the traced
    step's device time, busy share and largest kernels (device_busy)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(9)
    state, _ = step(state, batch, gen)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        step(state, batch, gen)
        end.record()
        torch.cuda.synchronize()
    busy = device_busy(prof, start.elapsed_time(end))
    return {**{k: v for k, v in busy.items() if k != "top"}, "top": busy.get("top", [])[:8]}


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




def fw_times(cw, card: str, ws=FLAGSHIP, fused_ln: bool = False, passes=None):
    """Per-call times of the inference forward (``fused_ln``: with the
    per-head LayerNorm fused in) at each S (bf16) beside its plain version
    and bound, in turns plain, kernel, kernel, plain, with ``passes``'
    readings of its two kernels (phase_passes_times) at the same S."""
    import torch

    per_s = {}
    for S in SEQ_LENS:
        args = kernel_inputs(S, torch.bfloat16, seed=S, ws=ws)
        what = "chunkwise_fw_ln" if fused_ln else "chunkwise_fw"
        if fused_ln:
            ln = ln_params(ws, seed=S)
            plain = lambda: cw.mlstm_siging_chunkwise_fw_ln_plain(*args[:6], *ln, *args[6:],
                                                                    eps=EPS)
            kern = lambda: cw.mlstm_siging_chunkwise_fw_ln(*args[:6], *ln, *args[6:], eps=EPS)
        else:
            plain = lambda: cw.mlstm_siging_chunkwise_fw_plain(*args, eps=EPS)
            kern = lambda: cw.mlstm_siging_chunkwise_fw(*args, eps=EPS)
        t_kern, t_plain = in_turns(kern, plain, iters_for(ws, 20), 3, kern_reps=5, ws=ws)
        per_s[S] = {"ms": statistics.median(t_kern), "plain_ms": statistics.median(t_plain),
                    **dict(zip(("bound_ms", "bound_by"), bound(S, ws=ws, fused_ln=fused_ln))),
                    **(passes or {}).get(S, {})}
        emit({"phase": "times", "what": what, "widths": ws.cfg, "card": card, "B": ws.B, "S": S,
              "NH": ws.NH, "DH": ws.DH, "dtype": "bfloat16", **per_s[S], "ms_runs": t_kern,
              "plain_ms_runs": t_plain})
    return per_s


def phase_times(cw, yolo, card: str, passes=None):
    import torch

    from xlstm_yolo_tpu_torch.engine.predictor import DetectionPredictor

    per_s = fw_times(cw, card, passes=passes)

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


def ln_params(ws, seed: int):
    """The fused LayerNorm's (1 + w, b), (H,) float32 on the card, w ~ 0.3
    N(0, 1), b ~ 0.1 N(0, 1)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return ((1.0 + 0.3 * torch.randn(ws.H, generator=g)).cuda(),
            (0.1 * torch.randn(ws.H, generator=g)).cuda())


def ln_h_close(what: str, h, ref, ref_unrounded) -> dict:
    """The fused LayerNorm's bf16 h against fw_split with float64 sums:
    at most LN_BF16_MAX of its largest |value|, at most LN_BF16_MEAN in
    mean |error| over mean |value|, and nearer it in mean error than the
    unrounded plain version (``ref_unrounded``) is (rounding_shows)."""
    import torch

    a, b = h.double(), ref.double()
    if not bool(torch.isfinite(a).all()):
        raise AssertionError(f"{what}: not finite")
    out = {"h_max_rel_err": (a - b).abs().max().item() / b.abs().max().item(),
           "h_mean_rel_err": (a - b).abs().mean().item() / b.abs().mean().item(),
           "h_mean_err_over_unrounded": rounding_shows(what, [h], [ref], [ref_unrounded]),
           "h_max_tol": LN_BF16_MAX, "h_mean_tol": LN_BF16_MEAN}
    if out["h_max_rel_err"] > LN_BF16_MAX or out["h_mean_rel_err"] > LN_BF16_MEAN:
        raise AssertionError(f"{what}: {out}")
    return out


def phase_wide_kernels(cw, epi, ffn, v1, ex, pk, stp, shapes, lengths):
    """Every mLSTM kernel and the FFN and epilogue backwards against their
    plain versions at the widths of vil-det-256 (NH 8, DH 64, H 512, D 256,
    U 704) and vil-det-384 (NH 6, DH 128, H 768, D 384, U 1024), batch 8:
    the phases kernel, train_kernels, v1_kernels, exp_kernels,
    parallel_kernels and step_kernel at those widths, at the same lengths,
    gates, states and tolerances as at the flagship's."""
    worst = {}
    for ws in WIDE:
        worst[ws.cfg] = {"chunkwise_fw": phase_kernel(cw, ws),
                         **phase_train_kernels(cw, epi, ffn, ws),
                         **phase_v1_kernels(v1, shapes, ws=ws),
                         **phase_exp_kernels(ex, shapes, ws=ws),
                         **phase_parallel_kernels(pk, lengths, ws),
                         "mlstm_step": phase_step_kernel(stp, ws)}
    return worst


def phase_outnorm(cw):
    """The inference forward with the per-head LayerNorm fused in.

    1. The kernel against its plain version at DH 32, 64 and 128 (the
       three detectors' heads, batch 8) at S 6400/1600/400/100 and a ragged
       1000 with initial states, float32 and bfloat16, non-zero weight and
       bias, and v offset by 20, so that the rows of h have |mean| >> std:
       in float32 each output at most E2E_FACTOR times as far from the
       plain version in float64 as the float32 plain version is (+ 1e-4 of
       its largest |value|: the normalisation divides h's float32 rounding
       by its row's std); in bfloat16 against the two plain passes
       composed (fw_split), which round the products' operands where the
       kernel and JAX's forward do, with float64 sums: C within
       BF16_STATE_REL and n within F32_TOL of their largest |value|, h (the
       normalisation magnifies each operand whose rounding a float32 sum
       flips) within LN_BF16_MAX of its largest |value|, LN_BF16_MEAN in
       mean error, and nearer fw_split in mean error than the unrounded
       plain version is (rounding_shows); and, on the same inputs without
       the offset, h within 2e-2 of fw_split's largest |value|.
    2. MatrixLSTMCell(768, 6, fuse_outnorm=True) in eval (vil-det-384's
       cell, weights from seed 0, perturbed ifgates, random outnorm weight
       and bias, bf16 streams): each call is one fused launch and no other
       inference-forward launch, and it agrees with the unfused cell within
       2e-2 of the output's largest |value|, stateless and stateful at
       S = 1600."""
    import torch

    from xlstm_yolo_tpu_torch.nn.layers import MatrixLSTMCell, reset_parameters

    worst = {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]}
    for ws in (FLAGSHIP, *WIDE):
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).split(".")[-1]
            for S, states in [(S, False) for S in SEQ_LENS] + [(1000, True)]:
                q, k, v, *rest = kernel_inputs(S, dtype, "open", states, seed=S + 5, ws=ws)
                args = (q, k, (v.float() + 20.0).to(dtype), *rest[:3])
                st, ln = rest[3:], ln_params(ws, seed=S)
                got = cw.mlstm_siging_chunkwise_fw_ln(*args, *ln, *st, eps=EPS,
                                                      return_last_states=True)
                torch.cuda.synchronize()
                ref = cw.mlstm_siging_chunkwise_fw_ln_plain(*args, *ln, *st, eps=EPS,
                                                            return_last_states=True)
                ref64 = cw.mlstm_siging_chunkwise_fw_ln_plain(
                    *to64(args), *to64(ln), *to64(st), eps=EPS, return_last_states=True)
                ref64 = [ref64[0], *ref64[1]]
                split = {}
                if dtype == torch.float32:
                    e = compare_outputs(f"fw_ln {ws.cfg} S={S} {key}", [got[0], *got[1]],
                                        [ref[0], *ref[1]], GRAD_REL[key], ref64)
                else:  # the two plain passes with float64 sums, which round where the
                    # kernel and JAX do
                    sh, _, _, _, sc, sn = fw_split(cw, (*args, *st), ln, acc=torch.float64)
                    split = ln_h_close(f"fw_ln h vs passes {ws.cfg} S={S}", got[0], sh, ref64[0])
                    e_c = compare_outputs(f"fw_ln C vs passes {ws.cfg} S={S}", got[1][:1], [sc],
                                          BF16_STATE_REL)
                    e_n = compare_outputs(f"fw_ln n vs passes {ws.cfg} S={S}", got[1][1:], [sn],
                                          F32_TOL)
                    h = cw.mlstm_siging_chunkwise_fw_ln(*args[:2], v, *args[3:], *ln, *st,
                                                        eps=EPS)
                    split["no_offset_h_max_rel_err"] = compare_outputs(
                        f"fw_ln h, no offset, vs passes {ws.cfg} S={S}", [h],
                        fw_split(cw, (*args[:2], v, *args[3:], *st), ln)[:1], BF16_TOL)[1]
                    e = [max(a, b, c) for a, b, c in zip(
                        ((got[0].double() - sh).abs().max().item(), split["h_max_rel_err"]),
                        e_c, e_n)]
                    # the one-piece plain version keeps the products in float32 (read only)
                    split["max_rel_err_vs_unrounded_plain"] = max(
                        (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
                        for a, b in zip([got[0], *got[1]], [ref[0], *ref[1]]))
                worst[key] = [max(a, b) for a, b in zip(worst[key], e)]
                emit({"phase": "outnorm", "widths": ws.cfg, "NH": ws.NH, "DH": ws.DH, "S": S,
                      "dtype": key, "initial_states": states, "v_offset": 20.0,
                      "max_abs_err": e[0], "max_rel_err": e[1],
                      "rel_tol": GRAD_REL[key] if dtype == torch.float32 else BF16_STATE_REL,
                      "float64_arbiter": True, **split})
                del args, got, ref, ref64, v

    ws = WIDE[-1]
    cell = MatrixLSTMCell(ws.H, ws.NH, fuse_outnorm=True)
    reset_parameters(cell, torch.Generator().manual_seed(0))
    perturb_ifgates(cell, seed=13)
    g = torch.Generator().manual_seed(14)
    with torch.no_grad():
        cell.outnorm.weight.copy_(0.3 * torch.randn(ws.H, generator=g))
        cell.outnorm.bias.copy_(0.1 * torch.randn(ws.H, generator=g))
    cell = cell.cuda().eval()
    unfused = copy.deepcopy(cell)
    unfused.fuse_outnorm = False
    S = 1600
    q, k, v = (torch.randn(ws.B, S, ws.H, generator=g).to("cuda", torch.bfloat16)
               for _ in range(3))
    state = (torch.randn(ws.B, ws.NH, ws.DH, ws.DH, generator=g).cuda(),
             torch.randn(ws.B, ws.NH, ws.DH, generator=g).cuda())
    report = {"phase": "outnorm", "cell": f"MatrixLSTMCell({ws.H}, {ws.NH}, fuse_outnorm=True)",
              "S": S, "batch": ws.B, "dtype": "bfloat16"}
    with torch.inference_mode():
        for mode, kw in (("stateless", {}), ("stateful", {"state": state})):
            cw.LAUNCHES = cw.LAUNCHES_LN = 0
            out = cell(q, k, v, **kw)
            torch.cuda.synchronize()
            launches = {"chunkwise_fw_ln": cw.LAUNCHES_LN, "chunkwise_fw": cw.LAUNCHES}
            ref = unfused(q, k, v, **kw)
            got, want = ((out,), (ref,)) if mode == "stateless" else (
                (out[0], *out[1]), (ref[0], *ref[1]))
            e = compare_outputs(f"fused cell {mode}", got, want, GRAD_REL["bfloat16"])
            report[mode] = {"launches": launches, "max_abs_err": e[0], "max_rel_err": e[1]}
            if launches != {"chunkwise_fw_ln": 1, "chunkwise_fw": 0}:
                raise AssertionError(f"the fused cell ({mode}) made {launches} launches, "
                                     "expected one fused launch and no other")
    report["rel_tol"] = GRAD_REL["bfloat16"]
    emit(report)
    return worst, report["stateless"]["launches"]["chunkwise_fw_ln"] + \
        report["stateful"]["launches"]["chunkwise_fw_ln"]


def phase_wide_grads():
    """A ViLBlockPair of vil-det-384's widths (dim 384, qkv_block_size 128:
    6 heads of 128, FFN 1024) in training at S = 1600 (40 x 40), batch 2,
    float32, weights from seed 0, perturbed ifgates: the gradients of
    sum(y * w) with respect to the input and every parameter, with the
    kernels (train forward, fused backward, epilogue and FFN backwards) and
    with their plain versions, each against a float64 run of the plain
    versions.  The kernel path may be at most E2E_FACTOR times as far from
    float64 as the plain path, each leaf's largest error relative to the
    largest float64 |g| of all leaves: the input-gate biases' gradients are
    sums of q.dq - k.dk over all S rows that cancel, so their float32
    rounding is set by their terms and not by their size (the two float32
    paths, which sum them in other orders, are up to 3x apart on one leaf
    of this block in a CPU run), while a wiring fault moves a leaf by O(1)."""
    import torch

    from xlstm_yolo_tpu_torch.nn.layers import ViLBlockPair, reset_parameters
    from xlstm_yolo_tpu_torch.ops import chunkwise_v2, epilogue, ffn

    ws = WIDE[-1]
    block = ViLBlockPair(ws.D, seqlens=(40, 40), qkv_block_size=ws.DH, chunk_size=512)
    reset_parameters(block, torch.Generator().manual_seed(0))
    perturb_ifgates(block, seed=15)
    block = block.cuda().train()
    g = torch.Generator().manual_seed(16)
    x, w = (torch.randn(2, 1600, ws.D, generator=g).cuda() for _ in range(2))

    def grads(model, x, w):
        x = x.clone().requires_grad_()
        y = model(x)
        params = [x, *model.parameters()]
        return [t.detach() for t in torch.autograd.grad((y * w).sum(), params)]

    before = (chunkwise_v2.LAUNCHES_TRAIN, chunkwise_v2.LAUNCHES_BW, epilogue.LAUNCHES,
              ffn.LAUNCHES)
    g_k = grads(block, x, w)
    torch.cuda.synchronize()
    launches = [a - b for a, b in zip((chunkwise_v2.LAUNCHES_TRAIN, chunkwise_v2.LAUNCHES_BW,
                                       epilogue.LAUNCHES, ffn.LAUNCHES), before)]
    plain = copy.deepcopy(block)
    use_plain_training_ops(plain)
    g_p = grads(plain, x, w)
    g_64 = grads(plain.double(), x.double(), w.double())
    top = max(t.abs().max().item() for t in g_64)
    err_k = max((a.double() - r).abs().max().item() for a, r in zip(g_k, g_64)) / top
    err_p = max((p.double() - r).abs().max().item() for p, r in zip(g_p, g_64)) / top
    ok = err_k <= E2E_FACTOR * err_p + E2E_GRAD_ATOL and all(
        bool(torch.isfinite(t).all()) for t in g_k) and launches == [2, 2, 2, 2]
    emit({"phase": "wide_grads", "block": f"ViLBlockPair({ws.D}, qkv_block_size={ws.DH})",
          "S": 1600, "batch": 2, "dtype": "float32", "kernel_vs_f64_rel": err_k,
          "plain_vs_f64_rel": err_p, "factor": E2E_FACTOR, "atol_rel": E2E_GRAD_ATOL,
          "leaves": len(g_k), "launches": dict(zip(
              ("chunkwise_fw_train", "chunkwise_bw", "epilogue_bw", "ffn_bw"), launches))})
    if not ok:
        raise AssertionError("the wide ViLBlockPair's kernel gradients are further from float64 "
                             f"than allowed, or its launches {launches} are not one per layer")


def phase_wide_times(cw, epi, ffn, v1, ex, pk, stp, card: str, plan, passes):
    """Per-call times of every kernel at the widths of vil-det-256 and
    vil-det-384 beside their plain versions and bounds (fw_times, with and
    without the fused LayerNorm; phase_train_times; v1_times; exp_times;
    phase_parallel_times; step_times; with ``passes``' kernel readings,
    phase_passes_times), and of the fused forward at the flagship's."""
    out = {"fw_ln_flagship": fw_times(cw, card, fused_ln=True)}
    for ws in WIDE:
        out[ws.cfg] = {"chunkwise_fw": fw_times(cw, card, ws,
                                                passes=passes[ws.cfg]["chunkwise_fw"]),
                       "chunkwise_fw_ln": fw_times(cw, card, ws, fused_ln=True),
                       **phase_train_times(cw, epi, ffn, card, ws, passes[ws.cfg]),
                       **v1_times(v1, card, plan, ws), **exp_times(ex, card, plan, ws),
                       **phase_parallel_times(pk, card, plan, ws),
                       "mlstm_step": step_times(stp, ws)}
        emit({"phase": "times", "what": "step_kernel", "widths": ws.cfg, "card": card,
              **{k: {kk: vv for kk, vv in v.items() if not kk.endswith("runs")}
                 for k, v in out[ws.cfg]["mlstm_step"].items()}})
    return out


def predict_times(yolo, card: str) -> dict:
    """The predict forward of ``yolo`` on device input (normalise + forward
    + top-k on a letterboxed uint8 batch of 8 on the card), 5 windows of 3
    forwards after 2 s of warm-up with the clocks sampled; the peak device
    memory; and the busy share from a trace of 3 forwards."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from xlstm_yolo_tpu_torch.engine.predictor import DetectionPredictor

    predictor = DetectionPredictor({"imgsz": yolo.imgsz, "batch": B}, yolo.model, yolo.names)
    batch = predictor.preprocess(synthetic_images(B, seed=6))
    fwd = lambda: predictor.forward(batch)  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    with ClockSampler() as clocks:
        runs = time_cuda(fwd, iters=3, reps=5, warm_s=2.0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(3):
            fwd()
        end.record()
        torch.cuda.synchronize()
    busy = device_busy(prof, start.elapsed_time(end))
    out = {"forward_ms": statistics.median(runs), "forward_ms_runs": runs,
           "img_per_s_device_input": B / statistics.median(runs) * 1e3,
           "peak_memory_gib": peak, "clocks_during_forward_timing": clocks.summary,
           "clock_samples": clocks.summary_n,
           **{k: v for k, v in busy.items() if k != "top"}, "top": busy.get("top", [])[:8]}
    emit({"phase": "times", "what": "predict", "card": card, "cfg": cfg_name(yolo),
          "imgsz": yolo.imgsz, "batch": B, "dtype": "bfloat16", **out,
          "note": "device input: normalise + forward + top-k on a letterboxed uint8 batch on "
                  "the card, 5 windows of 3 forwards after 2 s of warm-up; busy share from a "
                  "trace of 3 forwards"})
    return out


# ---------------------------------------------------------------------------
# the TAL metric stage and the sLSTM scan with the xLSTM language model
# ---------------------------------------------------------------------------

TAL_SIZE, TAL_NC = 640, 80  # A = 8400 anchors at strides 8, 16, 32
TAL_CASES = ((8, 8, False), (8, 128, False), (16, 8, True), (16, 128, True))  # B, M, k 10/1
# (B, M, topk, a NaN box): one row (a cluster of 8 CTAs), 2400 rows (a CTA a
# row), topk 1 and 17 (two rounds of the kernel's 16-row lists), a NaN box
TAL_EXTRA = ((1, 1, 10, False), (8, 300, 10, False), (8, 8, 1, False), (8, 128, 17, False),
             (8, 8, 10, True))
# the assigner entries against each other (tests/test_tal_kernel.py's tolerances)
TAL_TOL = {"target_bboxes": dict(rtol=1e-6, atol=0.0), "target_scores": dict(rtol=2e-5, atol=1e-7)}
SLSTM_NH, SLSTM_B = 4, 8
SLSTM_CASES = [(dh, S, state, False) for dh in (8, 32, 128) for S in (128, 97, 2048)
               for state in (False, True)] + [(dh, 512, True, True) for dh in (8, 32, 128)] + [
    (48, 97, True, False), (48, 2048, False, True), (256, 128, True, False),
    (256, 2048, False, False)]  # DH no multiple of the cluster's CTAs; 16 CTAs a cluster
SLSTM_REL = 1e-5  # of each output's largest |value|: float32, recurrent sums in another order
LM = dict(vocab_size=50304, dim=512, num_blocks=6, slstm_at=(1,))  # xLSTM-7B's vocabulary
LM_BATCH, LM_PROMPT, LM_NEW = 8, 128, 32
LM_MLSTM_BLOCKS = LM["num_blocks"] - len(LM["slstm_at"])
TOKEN_TIE_REL = 1e-4  # greedy tokens may part only where the top-2 gap is below this


def tal_inputs(seed: int, B: int, M: int):
    """The assigner's inputs at 640 px on the card: sigmoid scores (B, A,
    80), predicted boxes around the anchors (strides 8, 16, 32), (B, M)
    padded gts of 8-300 px, about half valid (the rest zeros, as the
    dataset pads to its max_targets), labels and mask; k 10/1 halves."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    pts = []
    for s in (8, 16, 32):
        n = TAL_SIZE // s
        gy, gx = np.meshgrid(np.arange(n) + 0.5, np.arange(n) + 0.5, indexing="ij")
        pts.append(np.stack([gx, gy], -1).reshape(-1, 2) * s)
    anc = np.concatenate(pts)
    A = len(anc)
    scores = 1 / (1 + np.exp(-rng.normal(-2, 1.5, (B, A, TAL_NC))))
    wh = rng.uniform(4, 160, (B, A, 2))
    ctr = anc[None] + rng.normal(0, 8, (B, A, 2))
    pboxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    gxy = rng.uniform(0, TAL_SIZE - 40, (B, M, 2))
    gboxes = np.concatenate([gxy, np.minimum(gxy + rng.uniform(8, 300, (B, M, 2)), TAL_SIZE)], -1)
    mask = rng.uniform(0, 1, (B, M)) < 0.5
    gboxes[~mask] = 0.0
    cu = lambda a, d=torch.float32: torch.from_numpy(np.asarray(a)).to("cuda", d)  # noqa: E731
    return (cu(scores), cu(pboxes), cu(anc), cu(rng.integers(0, TAL_NC, (B, M)), torch.int32),
            cu(gboxes), cu(mask, torch.bool))


def tal_k(B: int, halves: bool):
    """The per-sample k of the stacked E2E loss: top-10 for the first half
    of the batch, top-1 for the second; None for one k of 10."""
    import torch

    if not halves:
        return None
    return torch.tensor([10] * (B // 2) + [1] * (B - B // 2), dtype=torch.int32, device="cuda")


def tal_bound(B: int, M: int, A: int) -> tuple[float, str]:
    """Least time of one metric-stage call in ms: the gathered scores (B M A
    floats), boxes, atan terms, anchors, gts and k read once, align,
    overlaps (float32) and mask_pos (bytes) written once, over HBM
    bandwidth; against ~60 float32 operations an element at the float32
    peak."""
    nbytes = B * M * A * 4 + B * A * 5 * 4 + A * 2 * 4 + B * M * (6 * 4 + 1) + B * 4 \
        + B * M * A * 9
    flops = 60 * B * M * A
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def kernels_device_ms(fn, launches: dict, calls: int = 10) -> dict:
    """Device ms a call of the kernels of ``fn`` whose names hold each key of
    ``launches`` (the value: its launches a call), from one torch.profiler
    trace of ``calls`` calls (kernel events only, as device_busy reads
    them): the mean event times the launches a call, beside the events
    each key had ("events").  A trace can miss a kernel event or two at its
    start (seen on the H100: 9 of 10), so a small operation opens it and
    the mean, not the sum, is read; a trace that lacks a key (seen: 0 of
    10 events) is taken again, up to three times, and a key still missing
    is "not measured"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace that caught no event of a key is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device="cuda").add_(1)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        top = device_busy(prof, 1.0).get("top", [])
        if all(any(m in r["kernel"] for r in top) for m in launches):
            break
    out, events = {}, {}
    for m, per_call in launches.items():
        hits = [r for r in top if m in r["kernel"]]
        events[m] = sum(r["calls"] for r in hits)
        out[m] = (sum(r["device_ms"] for r in hits) / events[m] * per_call if events[m]
                  else "not measured")
    return {**out, "events": events, "calls": calls}


def tal_mask_without_nan(args, align, topk: int, eps: float = 1e-9):
    """mask_pos with a NaN metric never taken, as the kernel takes it: the
    plain version's top-k rounds over align with each NaN as -inf, and its
    in-box mask.  (The plain version's row max is NaN on such a row, and it
    takes none of the row.)"""
    import torch

    _, _, anc, _, gb, mask_gt = args
    B, M, A = align.shape
    ax, ay = anc[:, 0][None, None], anc[:, 1][None, None]
    gx1, gy1, gx2, gy2 = (gb[..., j][..., None] for j in range(4))
    valid = ((ax - gx1 > eps) & (ay - gy1 > eps) & (gx2 - ax > eps) & (gy2 - ay > eps)
             & mask_gt[..., None])
    live = torch.where(torch.isnan(align), float("-inf"), align)
    iota = torch.arange(A, device=align.device)
    sel = torch.zeros_like(valid)
    for _ in range(topk):
        idx = torch.where(live == live.amax(-1, keepdim=True), iota, A).amin(-1, keepdim=True)
        oh = iota == idx
        sel |= oh
        live = torch.where(oh, float("-inf"), live)
    return sel & valid


def phase_tal_extra(tk) -> dict:
    """TAL_EXTRA against the plain version: align and overlaps bit-equal (NaN
    where it has NaN), mask_pos equal; with a NaN box (a predicted box of
    image 0 inside a valid gt), mask_pos as tal_mask_without_nan."""
    import torch

    out = {"bit_equal": True}
    for j, (Bt, M, topk, nan) in enumerate(TAL_EXTRA):
        args = tal_inputs(200 + j, Bt, M)
        if nan:
            scores, pb, anc, labels, gb, mask = args
            m = int(mask[0].nonzero()[0, 0])
            x1, y1, x2, y2 = gb[0, m].tolist()
            a = int(((anc[:, 0] > x1) & (anc[:, 0] < x2) & (anc[:, 1] > y1)
                     & (anc[:, 1] < y2)).nonzero()[0, 0])
            pb = pb.clone()
            pb[0, a, 2] = float("nan")
            args = (scores, pb, anc, labels, gb, mask)
        got = tk.tal_metric(*args, topk=topk)
        torch.cuda.synchronize()
        ref = tk.tal_metric_plain(*args, topk=topk)
        for a, b in zip(got[:2], ref[:2]):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        want = tal_mask_without_nan(args, ref[0], topk) if nan else ref[2]
        if not torch.equal(got[2], want):
            raise AssertionError(f"tal_metric: mask_pos differs at B {Bt}, M {M}, topk {topk}"
                                 f"{', NaN box' if nan else ''}")
        emit({"phase": "tal_kernel", "what": "extra", "B": Bt, "M": M, "topk": topk,
              "nan_box": nan, "nan_metrics": int(torch.isnan(got[0]).sum().item()),
              "positives": int(got[2].sum().item()), "bit_equal": True,
              "cluster_ctas": tk.cluster_size(Bt * M)})
    return out


def phase_tal_kernel(tk):
    """The TAL metric kernel against its plain version on the card (and
    TAL_EXTRA, phase_tal_extra), then the assigner entry with the kernel
    (the path: one launch a call, counted) against the default eager
    ``task_aligned_assign``."""
    import torch

    from xlstm_yolo_tpu_torch.utils import tal

    worst = {"max_abs_err": 0.0, "bit_equal": True}
    calls = []
    for j, (Bt, M, halves) in enumerate(TAL_CASES):
        args, k = tal_inputs(100 + j, Bt, M), tal_k(Bt, halves)
        got = tk.tal_metric(*args, topk=10, topk_arr=k)
        torch.cuda.synchronize()
        ref = tk.tal_metric_plain(*args, topk=10, topk_arr=k)
        errs = [(a - b).abs().max().item() for a, b in zip(got[:2], ref[:2])]
        bits = all(torch.equal(a, b) for a, b in zip(got[:2], ref[:2]))
        masks = torch.equal(got[2], ref[2])
        emit({"phase": "tal_kernel", "B": Bt, "M": M, "A": args[0].shape[1], "nc": TAL_NC,
              "k": "10/1" if halves else 10, "mask_pos_equal": masks, "align_overlaps_bit_equal": bits,
              "max_abs_err_align": errs[0], "max_abs_err_overlaps": errs[1],
              "positives": int(got[2].sum().item())})
        if not masks:
            raise AssertionError(f"tal_metric: mask_pos differs from the plain version at B {Bt}, "
                                 f"M {M}")
        for a, b in zip(got[:2], ref[:2]):
            torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-7)
        worst["max_abs_err"] = max(worst["max_abs_err"], *errs)
        worst["bit_equal"] &= bits
        calls.append((args, k))
    phase_tal_extra(tk)
    # the path: the assigner entry, counts set to 0 just before
    tk.LAUNCHES = 0
    fused = [tal.task_aligned_assign_pallas_metric(*args, topk=10, num_classes=TAL_NC,
                                                   topk_arr=k) for args, k in calls]
    torch.cuda.synchronize()
    launches = tk.LAUNCHES
    if launches != len(calls):
        raise AssertionError(f"{len(calls)} assigner calls made {launches} kernel launches")
    for (args, k), r1, (Bt, M, halves) in zip(calls, fused, TAL_CASES):
        r0 = tal.task_aligned_assign(*args, topk=10, num_classes=TAL_NC, topk_arr=k)
        for name in ("fg_mask", "target_labels", "target_gt_idx"):
            if not torch.equal(getattr(r0, name), getattr(r1, name)):
                raise AssertionError(f"assigner: {name} differs from task_aligned_assign at "
                                     f"B {Bt}, M {M}")
        for name, tol in TAL_TOL.items():
            torch.testing.assert_close(getattr(r1, name), getattr(r0, name), **tol)
        emit({"phase": "tal_kernel", "what": "assigner", "B": Bt, "M": M,
              "foreground": int(r1.fg_mask.sum().item()),
              "max_abs_err_scores": (r1.target_scores - r0.target_scores).abs().max().item()})
    return worst, launches


def phase_tal_times(tk, card: str) -> dict:
    """Per call at 640 px (A 8400, nc 80), batch 8, M 8 (the smoke's gts)
    and 128 (the JAX dataset's max_targets): the kernel, its plain version,
    the assigner with the kernel against the default eager assigner, and
    the shared steps 4-6 (``_assign_from_metric``), in turns."""
    import torch

    from xlstm_yolo_tpu_torch.utils import tal

    out = {}
    for M in (8, 128):
        args = tal_inputs(7, 8, M)
        metric = tk.tal_metric(*args, topk=10)
        fns = {"kernel": lambda: tk.tal_metric(*args, topk=10),  # noqa: E731
               "plain": lambda: tk.tal_metric_plain(*args, topk=10),  # noqa: E731
               "assign_fused": lambda: tal.task_aligned_assign_pallas_metric(*args),  # noqa: E731
               "assign_eager": lambda: tal.task_aligned_assign(*args),  # noqa: E731
               "assign_tail": lambda: tal._assign_from_metric(  # noqa: E731
                   *metric, args[3], args[4], fg_eps=1e-9, num_classes=TAL_NC)}
        runs = {name: [] for name in fns}
        for name in list(fns) + list(reversed(fns)):
            runs[name] += time_cuda(fns[name], iters=20, reps=3, warm_s=0.2)
        med = {name: statistics.median(r) for name, r in runs.items()}
        bound_ms, bound_by = tal_bound(8, M, args[0].shape[1])
        dev_ms = kernels_device_ms(fns["kernel"], {"tal_metric_kernel": 1})["tal_metric_kernel"]
        out[M] = {"ms": dev_ms if isinstance(dev_ms, float) else med["kernel"],
                  "wrapper_ms": med["kernel"], "plain_ms": med["plain"], "bound_ms": bound_ms,
                  "bound_by": bound_by, "assign_fused_ms": med["assign_fused"],
                  "assign_eager_ms": med["assign_eager"], "assign_tail_ms": med["assign_tail"],
                  "eager_metric_stage_ms": med["assign_eager"] - med["assign_tail"],
                  "runs": runs}
        emit({"phase": "times", "what": "tal_metric", "card": card, "B": 8, "M": M,
              "A": args[0].shape[1], "nc": TAL_NC, **out[M],
              "note": "ms: the kernel's device time a call (torch.profiler trace of 10 "
                      "calls; the wrapper's time where the trace has no kernel event); the rest CUDA-event windows of 20 calls, in turns wrapper, plain, "
                      "fused assign, eager assign, tail, then back (the wrapper's host ops "
                      "included); eager metric stage = eager assign - tail"})
    return out


def slstm_inputs(DH: int, S: int, state: bool, big_i: bool, seed: int):
    """wx (B, S, 4, NH, DH) ~ N(0, 1) (input gates + 12 with ``big_i``: m
    far from 0), R with orthonormal columns per gate and head (not
    symmetric), and an optional (h, c, n, m), on the card in float32."""
    import torch

    g = torch.Generator().manual_seed(seed)
    wx = torch.randn(SLSTM_B, S, 4, SLSTM_NH, DH, generator=g)
    if big_i:
        wx[:, :, 1] += 12.0
    R = torch.empty(4 * SLSTM_NH * DH, DH)
    torch.nn.init.orthogonal_(R, generator=g)
    st = None
    if state:
        shape = (SLSTM_B, SLSTM_NH, DH)
        st = tuple(t.cuda() for t in (torch.randn(*shape, generator=g),
                                      torch.randn(*shape, generator=g),
                                      torch.rand(*shape, generator=g) * 1.5 + 0.5,
                                      torch.rand(*shape, generator=g) * 10 - 2))
    return wx.cuda(), R.reshape(4, SLSTM_NH, DH, DH).cuda(), st


def slstm_bound(B: int, S: int, NH: int, DH: int, state: bool) -> tuple[float, str]:
    """Least time of one scan call in ms: wx read and hs written once, R and
    the states read once, the last states written once, over HBM
    bandwidth; against the recurrent products' 8 B S NH DH^2 float32
    operations at the float32 peak."""
    D = NH * DH
    nbytes = 4 * (4 * B * S * D + B * S * D + 4 * NH * DH * DH + (8 if state else 4) * B * D)
    flops = 8 * B * S * D * DH
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_slstm_kernel(sk):
    """The sLSTM scan kernel against its plain loop on the card: DH 8, 32
    and 128, S 128, a ragged 97 and 2048, with and without an initial
    state, and large input gates; float32.  Each output within SLSTM_REL of
    its largest |value| of the plain loop's; or, where float32 rounding
    compounds over a long scan beyond that, at most E2E_FACTOR times as far
    from the plain loop in float64 as the float32 plain loop is (+
    SLSTM_REL of the largest |value|): the criterion each output took is
    printed."""
    import torch

    worst = 0.0
    for j, (DH, S, state, big_i) in enumerate(SLSTM_CASES):
        wx, R, st = slstm_inputs(DH, S, state, big_i, seed=j)
        with torch.no_grad():
            hs, last = sk.slstm_sequence(wx, R, st)
            torch.cuda.synchronize()
            hp, lp = sk.slstm_sequence_plain(wx, R, st)
            h64, l64 = sk.slstm_sequence_plain(wx.double(), R.double(),
                                               None if st is None else tuple(t.double() for t in st))
        errs, via = {}, {}
        for name, a, b, r in zip(("hs", "h", "c", "n", "m"), (hs, *last), (hp, *lp), (h64, *l64)):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"slstm: {name} is not finite at DH {DH}, S {S}")
            scale = b.abs().max().item()
            err = (a - b).abs().max().item()
            errs[name] = err / max(scale, 1e-30)
            if err <= SLSTM_REL * scale:
                via[name] = "direct"
                continue
            err_k, err_p = ((t.double() - r).abs().max().item() for t in (a, b))
            via[name] = {"kernel_vs_f64": err_k, "plain_vs_f64": err_p}
            if err_k > E2E_FACTOR * err_p + SLSTM_REL * scale:
                raise AssertionError(f"slstm: {name} at DH {DH}, S {S} is {err:.3g} from the "
                                     f"plain loop ({err / scale:.3g} of its largest value) and "
                                     f"{err_k:.3g} from float64, the plain loop {err_p:.3g}")
        emit({"phase": "slstm_kernel", "B": SLSTM_B, "NH": SLSTM_NH, "DH": DH, "S": S,
              "initial_state": state, "large_input_gates": big_i, "max_rel_err": errs,
              "criterion": via, "max_abs_err_hs": (hs - hp).abs().max().item(),
              "m_mean": lp[3].mean().item(), "tol": SLSTM_REL})
        worst = max(worst, (hs - hp).abs().max().item())
    return worst


def per_step_us(device_ms, S: int):
    """Microseconds a step of a scan of S steps that took ``device_ms``."""
    return device_ms * 1e3 / S if isinstance(device_ms, float) else device_ms


def lm_cells(model):
    from xlstm_yolo_tpu_torch.nn.layers import MatrixLSTMCell
    from xlstm_yolo_tpu_torch.nn.xlstm import sLSTMCell

    return ([m for m in model.modules() if isinstance(m, sLSTMCell)],
            [m for m in model.modules() if isinstance(m, MatrixLSTMCell)])


def set_lm_kernels(model, plain: bool):
    """The LM's sLSTM and mLSTM cells on their kernels' wrappers, or on the
    plain versions (any device, float64 too)."""
    from xlstm_yolo_tpu_torch.ops import chunkwise_v2 as cw
    from xlstm_yolo_tpu_torch.ops import slstm as sk

    scells, mcells = lm_cells(model)
    for m in scells:
        m.kernel = sk.slstm_sequence_plain if plain else sk.slstm_sequence
    for m in mcells:
        m.kernel = cw.mlstm_siging_chunkwise_fw_plain if plain else cw.mlstm_siging_chunkwise_fw


def lm_counts(cw, sk) -> dict:
    return {"slstm_forward": sk.LAUNCHES, "chunkwise_fw": cw.LAUNCHES}


def phase_lm(cw, sk, card: str):
    """The xLSTM language model at full width (LM: dim 512, 6 blocks, sLSTM
    at 1; 5 mLSTM cells of 16 heads of 64, one sLSTM cell of 4 heads of
    128; vocabulary 50 304), float32, random weights from seed 0; batch 8,
    prompts of 128 tokens from a seed.

    1. One forward with the kernels, and one with the plain versions,
       against a float64 forward on the plain versions: the kernel logits
       at most E2E_FACTOR times as far from float64 as the plain ones (+
       1e-6 of the largest |logit|); exactly 1 sLSTM and 5 v2-inference
       launches.
    2. ``generate`` of 32 new tokens with the kernels (counts set to 0 just
       before: exactly 32 and 160 launches) and with the plain versions:
       the same tokens; where they part, the plain path's top-2 logit gap
       at that step is printed, and the run fails unless it is below
       TOKEN_TIE_REL of the largest |logit| there.
    3. Times: forward ms (kernels, plain), generate tokens per second,
       the sLSTM kernel per call at the LM's shape."""
    import torch

    from xlstm_yolo_tpu_torch.nn.xlstm import generate, xLSTMLarge

    lm = xLSTMLarge(**LM, device="cuda", generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(0, LM["vocab_size"], (LM_BATCH, LM_PROMPT),
                           generator=torch.Generator().manual_seed(3)).cuda()
    scells, mcells = lm_cells(lm)
    if len(scells) != 1 or len(mcells) != LM_MLSTM_BLOCKS:
        raise AssertionError(f"the LM has {len(scells)} sLSTM and {len(mcells)} mLSTM cells")
    with torch.inference_mode():
        cw.LAUNCHES = sk.LAUNCHES = 0
        logits = lm(tokens)
        torch.cuda.synchronize()
        fwd_launches = lm_counts(cw, sk)
        set_lm_kernels(lm, plain=True)
        logits_plain = lm(tokens)
        lm64 = copy.deepcopy(lm).double()
        logits64 = lm64(tokens)
        del lm64
        set_lm_kernels(lm, plain=False)
    want = {"slstm_forward": 1, "chunkwise_fw": LM_MLSTM_BLOCKS}
    if fwd_launches != want:
        raise AssertionError(f"one LM forward launched {fwd_launches}, not {want}")
    err_k = (logits.double() - logits64).abs().max().item()
    err_p = (logits_plain.double() - logits64).abs().max().item()
    scale = logits64.abs().max().item()
    emit({"phase": "lm", "what": "forward", **LM, "batch": LM_BATCH, "prompt": LM_PROMPT,
          "dtype": "float32", "launches_per_forward": fwd_launches,
          "kernel_vs_f64": err_k, "plain_vs_f64": err_p,
          "kernel_vs_plain": (logits - logits_plain).abs().max().item(), "max_abs_logit": scale,
          "e2e_factor": E2E_FACTOR})
    if not bool(torch.isfinite(logits).all()) or err_k > E2E_FACTOR * err_p + 1e-6 * scale:
        raise AssertionError(f"LM logits {err_k:.3g} from float64, the plain path {err_p:.3g}")
    del logits, logits_plain, logits64

    cw.LAUNCHES = sk.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(lm, tokens, max_new_tokens=LM_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = lm_counts(cw, sk)
    want = {"slstm_forward": LM_NEW, "chunkwise_fw": LM_NEW * LM_MLSTM_BLOCKS}
    if gen_launches != want:
        raise AssertionError(f"generate launched {gen_launches}, not {want}")
    set_lm_kernels(lm, plain=True)
    t0 = time.perf_counter()
    out_plain = generate(lm, tokens, max_new_tokens=LM_NEW)
    torch.cuda.synchronize()
    gen_plain_s = time.perf_counter() - t0
    report = {"phase": "lm", "what": "generate", "new_tokens": LM_NEW, "batch": LM_BATCH,
              "launches": gen_launches, "same_tokens": bool(torch.equal(out, out_plain))}
    if not report["same_tokens"]:
        b, j = map(int, (out != out_plain).nonzero()[0])
        with torch.inference_mode():
            last = lm(out_plain[b:b + 1, :j])[0, -1]
        top2 = last.topk(2).values
        report.update(first_parting={"sequence": b, "position": j},
                      plain_top2_gap=(top2[0] - top2[1]).item(),
                      max_abs_logit=last.abs().max().item())
    set_lm_kernels(lm, plain=False)
    emit(report)
    if not report["same_tokens"] and (
            report["plain_top2_gap"] > TOKEN_TIE_REL * report["max_abs_logit"]):
        raise AssertionError("generate's tokens part from the plain path's where the plain "
                             f"path's top-2 gap is {report['plain_top2_gap']:.3g}")

    # times
    with torch.inference_mode():
        fwd = time_cuda(lambda: lm(tokens), iters=5, reps=3, warm_s=0.2)
        set_lm_kernels(lm, plain=True)
        fwd_plain = time_cuda(lambda: lm(tokens), iters=2, reps=2, warm_s=0.0)
        set_lm_kernels(lm, plain=False)
        fwd += time_cuda(lambda: lm(tokens), iters=5, reps=3, warm_s=0.0)
        t0 = time.perf_counter()
        generate(lm, tokens, max_new_tokens=LM_NEW)
        torch.cuda.synchronize()
        gen2_s = time.perf_counter() - t0
        # the sLSTM cell's call in that forward: its inputs at the LM's shape
        cell = scells[0]
        block = lm.backbone.block_1
        x = lm.embedding(tokens)
        x = lm.backbone.block_0(x)
        xc = torch.nn.functional.silu(block.conv(block.norm(x)))
        wx = cell.wx(xc).reshape(LM_BATCH, LM_PROMPT, 4, cell.num_heads, -1).float()
        R = cell.recurrent_kernel
        kern = lambda: sk.slstm_sequence(wx, R)  # noqa: E731
        plain = lambda: sk.slstm_sequence_plain(wx, R)  # noqa: E731
        t_plain = time_cuda(plain, iters=2, reps=2, warm_s=0.0)
        t_kern = time_cuda(kern, iters=20, reps=3, warm_s=0.2) + time_cuda(kern, iters=20, reps=3)
        t_plain += time_cuda(plain, iters=2, reps=2, warm_s=0.0)
        dev_ms = kernels_device_ms(kern, {"slstm_kernel": 1})["slstm_kernel"]
        wx_long, R_long, _ = slstm_inputs(128, 2048, False, False, seed=99)
        long = lambda: sk.slstm_sequence(wx_long, R_long)  # noqa: E731
        t_long = time_cuda(long, iters=3, reps=3)
        dev_long = kernels_device_ms(long, {"slstm_kernel": 1}, calls=5)["slstm_kernel"]
    DH = wx.shape[-1]
    bound_ms, bound_by = slstm_bound(LM_BATCH, LM_PROMPT, cell.num_heads, DH, False)
    bound_long = slstm_bound(SLSTM_B, 2048, SLSTM_NH, 128, False)
    gen_tokens = LM_BATCH * LM_NEW
    times = {"forward_ms": statistics.median(fwd), "forward_ms_runs": fwd,
             "forward_plain_ms": statistics.median(fwd_plain),
             "generate_s": [gen_s, gen2_s], "generate_plain_s": gen_plain_s,
             "generate_tokens_per_s": gen_tokens / min(gen_s, gen2_s),
             "generate_plain_tokens_per_s": gen_tokens / gen_plain_s,
             "slstm": {"ms": statistics.median(t_kern), "device_ms": dev_ms,
                       "us_per_step": per_step_us(dev_ms, LM_PROMPT),
                       "plain_ms": statistics.median(t_plain),
                       "bound_ms": bound_ms, "bound_by": bound_by, "ms_runs": t_kern,
                       "plain_ms_runs": t_plain, "shape": list(wx.shape),
                       "plan": sk.plan(LM_BATCH, cell.num_heads, DH)},
             "slstm_S2048": {"ms": statistics.median(t_long), "device_ms": dev_long,
                             "us_per_step": per_step_us(dev_long, 2048),
                             "bound_ms": bound_long[0], "bound_by": bound_long[1],
                             "shape": list(wx_long.shape)}}
    emit({"phase": "times", "what": "lm", "card": card, **LM, "batch": LM_BATCH,
          "prompt": LM_PROMPT, **times,
          "note": "forward: CUDA-event windows of 5 forwards at (8, 128) tokens, in turns "
                  "kernels, plain, kernels; generate: host clock around 32 new tokens of 8 "
                  "sequences (full-prefix recompute), the second run after the first; slstm: "
                  "ms the CUDA-event window of a call, device_ms from a profiler trace, plan "
                  "the kernel's CTAs a cluster (K) and batch rows a cluster (G)"})
    return {"launches": gen_launches, "forward_launches": fwd_launches, **times}


# the sub-chunked forward fw3 (ops/chunkwise_fw3.py): the (S, L) pairs the
# JAX v2 cell hands its forward (S 6400 -> L 640, five sub-chunks of 128;
# 1600 -> 400; 400 and 100 in one chunk, Lb = L) and tests/test_fw3.py's
# cases, (S, L, Lb)
FW3_PATH = ((6400, 640, 128), (1600, 400, 128), (400, 400, 128), (100, 100, 128))
# and sub-chunks of 8, 100 and (sub_chunk 300 not dividing 640) 640 rows
FW3_SHAPES = FW3_PATH + ((1024, 256, 128), (900, 256, 128), (512, 512, 256), (1000, 16, 8),
                         (1000, 400, 100), (1500, 640, 300))
FW3_KERNELS = {"fw3_gates": 1, "fw_scan_kernel": 1, "fw_h_kernel": 1}  # a call's kernels
FW3_WIDTHS = (FLAGSHIP,) + WIDE
# (q/k/v type, product type, forget gates, initial states): each shape and
# width runs all four, so every type pair, gate regime and state option runs
FW3_CONFIGS = (("float32", "float32", "open", True), ("float32", "bfloat16", "closed", False),
               ("bfloat16", "float32", "closed", True), ("bfloat16", "bfloat16", "open", False))
FW3_OUTPUTS = ("h", "n_out", "cstates", "c_last", "n_last")
FW3_DROP_IN = (1000, (32, 64))  # S, the sub-chunks at the v2 kernels' L = 64


def fw3_counts(f3) -> dict:
    return {"chunkwise_fw3": f3.LAUNCHES_FW3, "chunkwise_fw3_train": f3.LAUNCHES_FW3_TRAIN}


def fw3_streams(S: int, ws, seed: int):
    """q, k, v (B, S, H) float32, i, open and closed f (B, S, NH), initial
    states, and an upstream dh and dC_last, made on the card from a seed
    (as kernel_inputs draws them)."""
    import torch

    B, NH, DH, H, D, U = ws.dims
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    u = lambda lo, hi: torch.rand(B, S, NH, generator=g, device="cuda") * (hi - lo) + lo  # noqa: E731
    return {"qkv": (r(B, S, H), r(B, S, H), r(B, S, H)), "i": u(-6, 4),
            "f": {"open": u(-2, 8), "closed": u(-60, -20)},
            "states": (r(B, NH, DH, DH), r(B, NH, DH)), "grads": (r(B, S, H), r(B, NH, DH, DH))}


def fw3_args(streams, dtype: str, gates: str, states: bool):
    import torch

    q, k, v = (t.to(getattr(torch, dtype)) for t in streams["qkv"])
    c0, n0 = streams["states"] if states else (None, None)
    return q, k, v, streams["i"], streams["f"][gates], c0, n0


def fw3_rounding(got, ref, ref_f32) -> dict:
    """With bfloat16 products: for each output that a product feeds (all
    but n_last), the mean |kernel - plain| and the mean |plain with float32
    products - plain|, each over the mean |plain|; raise where the first is
    not under half the second, as it would not be for a kernel that skipped
    the operands' rounding (a few operands rounded one step the other way
    barely move a mean).  Outputs no product reaches (the initial or zero
    state) are skipped."""
    out = {}
    for name, a, b, c in list(zip(FW3_OUTPUTS, got, ref, ref_f32))[:4]:
        if a is None:
            continue
        a, b, c = a.double(), b.double(), c.double()
        size = b.abs().mean().item()
        gap = (c - b).abs().mean().item()
        if size == 0 or gap == 0:
            continue
        err = (a - b).abs().mean().item()
        out[name] = {"mean_err": err / size, "gap": gap / size}
        if err >= gap / 2:
            raise AssertionError(f"fw3: {name} {err / size:.3g} from the plain version in mean "
                                 f"error, not under half its gap to float32 products "
                                 f"({gap / size:.3g}): the products' rounding does not show")
    return out


def fw3_errors(got, ref, tols) -> dict:
    """Each output's largest |kernel - plain| over its largest |plain|
    (outputs that either side lacks are skipped); raise where that passes
    its tolerance or the kernel's output is not finite."""
    import torch

    out = {}
    for name, a, b, tol in zip(FW3_OUTPUTS, got, ref, tols):
        if a is None or b is None:
            continue
        a, b = a.float(), b.float()
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"fw3: {name} of the kernel is not finite")
        err = (a - b).abs().max().item()
        rel = err / max(b.abs().max().item(), 1e-30)
        out[name] = {"max_abs_err": err, "rel": rel, "tol": tol}
        if rel > tol:
            raise AssertionError(f"fw3: {name} {rel:.3g} of its largest value from the plain "
                                 f"version (tolerance {tol})")
    return out


def phase_fw3_kernel(f3, cw):
    """1. The kernel against ``fw3_plain`` on the card at every (S, L, Lb)
    of FW3_SHAPES and every width of FW3_WIDTHS (B 8), in each of
    FW3_CONFIGS, both variants against the plain train variant: h within
    F32_TOL of its largest value (BF16_TOL where q or the products are
    bfloat16), n_out and the states within F32_TOL (BF16_TOL with bfloat16
    products, and then also nearer the plain version than its
    float32-products twin is, fw3_rounding); two launches a call, exactly.
    2. The path, counts set to 0 just before: the inference variant at the
    v2 cell's (S, L) pairs at vil-det-192's widths, bfloat16 (JAX's
    default products), against the plain version; then the drop-in
    contract at the v2 kernels' L = 64, S 1000, sub-chunks 32 and 64, q in
    float32 and bfloat16, products in q's type (the v2 kernels'): the train
    variant's cstates and n_out are the v2 train forward's c_states and den
    (F32_TOL; BF16_TOL with bfloat16 products), and the v2 backward kernel
    fed them gives the v2 path's dq, dk, dv and dC0 (GRAD_REL).  Returns
    the worst errors and the path's launches."""
    import torch

    worst = {"float32": {}, "bfloat16": {}, "max_abs_err_h_bf16": 0.0,
             "rounding_err_over_gap": 0.0}
    for ws in FW3_WIDTHS:
        for S, L, Lb in FW3_SHAPES:
            streams = fw3_streams(S, ws, seed=S + ws.DH)
            for dtype, compute, gates, states in FW3_CONFIGS:
                q, k, v, i, f, c0, n0 = fw3_args(streams, dtype, gates, states)
                kw = dict(chunk_size=L, sub_chunk=Lb, eps=EPS,
                          compute_dtype=getattr(torch, compute))
                ref = f3.fw3_plain(q, k, v, i, f, ws.NH, c0, n0, **kw)
                ref_f32 = (f3.fw3_plain(q, k, v, i, f, ws.NH, c0, n0,
                                        **{**kw, "compute_dtype": torch.float32})
                           if compute == "bfloat16" else None)
                h_tol = F32_TOL if dtype == compute == "float32" else BF16_TOL
                s_tol = F32_TOL if compute == "float32" else BF16_TOL
                tols = (h_tol,) + (s_tol,) * 4
                for save in (True, False):
                    before = fw3_counts(f3)
                    got = f3.fw3(q, k, v, i, f, ws.NH, c0, n0, save_states=save, **kw)
                    torch.cuda.synchronize()
                    name = "chunkwise_fw3_train" if save else "chunkwise_fw3"
                    made = fw3_counts(f3)[name] - before[name]
                    if made != f3.LAUNCHES_PER_CALL:
                        raise AssertionError(f"one fw3 call made {made} launches, not "
                                             f"{f3.LAUNCHES_PER_CALL}")
                    if not save and (got[1] is not None or got[2] is not None):
                        raise AssertionError("the inference variant returned saved states")
                    errs = fw3_errors(got, ref, tols)
                    rounding = fw3_rounding(got, ref, ref_f32) if ref_f32 is not None else {}
                    emit({"phase": "fw3_kernel", "widths": ws.cfg, "S": S, "L": L, "Lb": Lb,
                          "dtype": dtype, "compute": compute, "gates": gates,
                          "initial_states": states, "variant": "train" if save else "inference",
                          "errors": errs, "rounding": rounding})
                    for r in rounding.values():
                        worst["rounding_err_over_gap"] = max(worst["rounding_err_over_gap"],
                                                             r["mean_err"] / r["gap"])
                    for out, e in errs.items():
                        w = worst[compute]
                        w[out] = max(w.get(out, 0.0), e["rel"])
                    if "bfloat16" in (dtype, compute):
                        worst["max_abs_err_h_bf16"] = max(worst["max_abs_err_h_bf16"],
                                                          errs["h"]["max_abs_err"])
                del ref_f32
            del streams

    # the path
    f3.LAUNCHES_FW3 = f3.LAUNCHES_FW3_TRAIN = 0
    for S, L, Lb in FW3_PATH:
        q, k, v, i, f, c0, n0 = fw3_args(fw3_streams(S, FLAGSHIP, seed=S), "bfloat16", "open",
                                         False)
        got = f3.fw3(q, k, v, i, f, NH, chunk_size=L, sub_chunk=Lb, eps=EPS,
                     save_states=False)
        torch.cuda.synchronize()
        ref = f3.fw3_plain(q, k, v, i, f, NH, chunk_size=L, sub_chunk=Lb, eps=EPS,
                           save_states=False)
        emit({"phase": "fw3_kernel", "what": "path", "S": S, "L": L, "Lb": Lb,
              "dtype": "bfloat16", "compute": "bfloat16",
              "errors": fw3_errors(got, ref, (BF16_TOL,) * 5)})
    S, subs = FW3_DROP_IN
    for dtype in ("float32", "bfloat16"):
        streams = fw3_streams(S, FLAGSHIP, seed=11)
        q, k, v, i, f, c0, n0 = fw3_args(streams, dtype, "open", True)
        dh, dcl = streams["grads"]
        dh = dh.to(q.dtype)
        _, _, (c_states, _, den) = cw.mlstm_siging_chunkwise_fw_train(
            q, k, v, i, f, NH, c0, n0, eps=EPS)
        ref = cw.mlstm_siging_chunkwise_bw(q, k, v, i, f, NH, c_states, den, dh, dcl, eps=EPS)
        tol = F32_TOL if dtype == "float32" else BF16_TOL
        for sub in subs:
            _, n_out, cstates, _, _ = f3.fw3(q, k, v, i, f, NH, c0, n0, chunk_size=cw.CHUNK_SIZE,
                                             sub_chunk=sub, eps=EPS, compute_dtype=q.dtype)
            states = fw3_errors((None, n_out, cstates), (None, den, c_states), (None, tol, tol))
            got = cw.mlstm_siging_chunkwise_bw(q, k, v, i, f, NH, cstates, n_out, dh, dcl,
                                               eps=EPS)
            torch.cuda.synchronize()
            grads = {}
            for name, a, b in zip(("dq", "dk", "dv", "dc0"), got, ref):
                a, b = a.float(), b.float()
                rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                grads[name] = rel
                if not bool(torch.isfinite(a).all()) or rel > GRAD_REL[dtype]:
                    raise AssertionError(f"fw3 drop-in: {name} {rel:.3g} of its largest value "
                                         f"from the v2 path's (GRAD_REL {GRAD_REL[dtype]})")
            emit({"phase": "fw3_kernel", "what": "drop-in", "S": S, "L": cw.CHUNK_SIZE,
                  "Lb": sub, "dtype": dtype, "states": states, "grads_rel": grads,
                  "grad_rel": GRAD_REL[dtype]})
    torch.cuda.synchronize()
    launches = fw3_counts(f3)
    n = f3.LAUNCHES_PER_CALL
    want = {"chunkwise_fw3": n * len(FW3_PATH), "chunkwise_fw3_train": n * 2 * len(subs)}
    if launches != want:
        raise AssertionError(f"the fw3 path made {launches} launches, not {want}")
    return worst, launches


def fw3_bound(S: int, L: int, Lb: int, itemsize: int = 2, ws=FLAGSHIP,
              train: bool = False) -> tuple[float, str]:
    """Least time for one fw3 call in ms, and what sets it: q, k, v read and
    h written once, the gates read once, the last states written once (the
    train variant also cstates per chunk and den per row), over HBM
    bandwidth; against 4*B*NH*S*DH*(Lb+DH) FLOP at the bf16 peak."""
    from xlstm_yolo_tpu_torch.ops.chunkwise_fw3 import geometry

    B, NH, DH, H, D, U = ws.dims
    L_, Lb_, NC, _ = geometry(S, L, Lb)
    nbytes = 4 * B * S * H * itemsize + 2 * B * S * NH * 4 + B * NH * (DH * DH + DH) * 4
    if train:
        nbytes += B * NC * NH * (DH * DH + L_) * 4
    flops = 4 * B * NH * S * DH * (Lb_ + DH)
    return _bound(nbytes, flops)


def phase_fw3_times(f3, cw, card: str) -> dict:
    """Per call at B 8 and each (S, L) of FW3_PATH (Lb 128, Lb = L where
    128 does not divide L), bfloat16 q/k/v and products, at vil-det-192's
    heads (DH 32) and vil-det-384's (DH 128): CUDA-event windows of the
    kernel in both variants, the port's v2 inference and train forwards
    on the same inputs, and the plain version, in turns (and back); the
    bound; at S 6400 the device time of each kernel (FW3_KERNELS) from a
    torch.profiler trace, and the scratch's size (the state before each
    sub-chunk, C in the compute type, and the gate rows).  In the same turns, the
    configurations that compare like with like with the v2 kernels (L 64,
    bfloat16 products, as theirs): the inference variant (``l64_32``,
    ``l64_64``) and the train variant (``drop_in_32``, ``drop_in_64``, whose
    states the v2 backward takes) at the v2 kernels' L 64 with sub-chunks 32
    and 64."""
    import torch

    out = {}
    for ws in (FLAGSHIP, WIDE[-1]):
        per = {}
        for S, L, Lb in FW3_PATH:
            q, k, v, i, f, _, _ = fw3_args(fw3_streams(S, ws, seed=S), "bfloat16", "open", False)
            kw = dict(chunk_size=L, sub_chunk=Lb, eps=EPS)
            fns = {"fw3": lambda: f3.fw3(q, k, v, i, f, ws.NH, save_states=False, **kw),
                   "fw3_train": lambda: f3.fw3(q, k, v, i, f, ws.NH, **kw),
                   **{f"l64_{sub}": functools.partial(
                       f3.fw3, q, k, v, i, f, ws.NH, chunk_size=cw.CHUNK_SIZE, sub_chunk=sub,
                       eps=EPS, save_states=False) for sub in FW3_DROP_IN[1]},
                   **{f"drop_in_{sub}": functools.partial(
                       f3.fw3, q, k, v, i, f, ws.NH, chunk_size=cw.CHUNK_SIZE, sub_chunk=sub,
                       eps=EPS) for sub in FW3_DROP_IN[1]},
                   "v2": lambda: cw.mlstm_siging_chunkwise_fw(q, k, v, i, f, ws.NH, eps=EPS),
                   "v2_train": lambda: cw.mlstm_siging_chunkwise_fw_train(
                       q, k, v, i, f, ws.NH, eps=EPS),
                   "plain": lambda: f3.fw3_plain(q, k, v, i, f, ws.NH, save_states=False, **kw),
                   "plain_train": lambda: f3.fw3_plain(q, k, v, i, f, ws.NH, **kw)}
            runs = {name: [] for name in fns}
            for name in list(fns) + list(reversed(fns)):
                iters = 2 if name.startswith("plain") else iters_for(ws, 10)
                runs[name] += time_cuda(fns[name], iters=iters, reps=2, warm_s=0.1)
            med = {name: statistics.median(r) for name, r in runs.items()}
            _, Lb_, NC, NB = f3.geometry(S, L, Lb)
            row = {"ms": med["fw3"], "train_ms": med["fw3_train"], "v2_ms": med["v2"],
                   "v2_train_ms": med["v2_train"], "plain_ms": med["plain"],
                   "plain_train_ms": med["plain_train"],
                   **{f"{name}_{sub}_{key}": val for sub in FW3_DROP_IN[1]
                      for name, train in (("l64", False), ("drop_in", True))
                      for key, val in (("ms", med[f"{name}_{sub}"]),
                                       ("bound_ms", fw3_bound(S, cw.CHUNK_SIZE, sub, ws=ws,
                                                              train=train)[0]))},
                   **dict(zip(("bound_ms", "bound_by"), fw3_bound(S, L, Lb, ws=ws))),
                   **dict(zip(("train_bound_ms", "train_bound_by"),
                              fw3_bound(S, L, Lb, ws=ws, train=True))),
                   "scratch_mb": ws.B * NC * NB * ws.NH * (
                       ws.DH ** 2 * 2 + ws.DH * 4 + (3 * f3.walked_rows(Lb_) + 1) * 4) / 1e6,
                   "Lb": Lb_, "runs": runs}
            if S == FW3_PATH[0][0]:
                for name in ("fw3", "fw3_train"):
                    passes = kernels_device_ms(fns[name], FW3_KERNELS)
                    row[f"{name}_passes_device_ms"] = {p: passes[p] for p in FW3_KERNELS}
            per[S] = row
            emit({"phase": "times", "what": "fw3", "widths": ws.cfg, "card": card, "B": ws.B,
                  "S": S, "L": L, "NH": ws.NH, "DH": ws.DH, "dtype": "bfloat16",
                  "compute": "bfloat16", **row,
                  "note": "CUDA-event windows in turns fw3, fw3_train, l64_*, drop_in_*, v2, "
                          "v2_train, plain, plain_train and back; v2 is the port's v2 forward "
                          "(L 64, bfloat16 products) on the same inputs, fw3 runs at the JAX "
                          "cell's L; l64_<Lb> and drop_in_<Lb> are fw3's inference and train "
                          "variants at v2's L 64, like for like; passes_device_ms from a "
                          "torch.profiler trace of 10 calls: the gate rows, the state pass "
                          "(fw_scan_kernel) and the output pass (fw_h_kernel)"})
        out[ws.cfg] = per
    return out


def fw3_numbers(t: dict, train: bool) -> dict:
    """One width's numbers of a variant for the kernels line: per call at S
    6400, and summed over the 20 calls of a forward (LAUNCHES_PER_S) beside
    the v2 forward's."""
    key = "train_" if train else ""
    t0 = t[FW3_PATH[0][0]]

    def per_forward(k):
        return sum(n * t[S][k] for S, n in LAUNCHES_PER_S.items())

    name = "drop_in" if train else "l64"
    like = {f"{name}_{sub}": {"ms": t0[f"{name}_{sub}_ms"],
                              "bound_ms": t0[f"{name}_{sub}_bound_ms"],
                              "forward_ms": per_forward(f"{name}_{sub}_ms")}
            for sub in FW3_DROP_IN[1]}
    return {"ms": t0[f"{key}ms"], "plain_ms": t0[f"plain_{key}ms"],
            "bound_ms": t0[f"{key}bound_ms"], "bound_by": t0[f"{key}bound_by"],
            "v2_ms": t0[f"v2_{key}ms"], "forward_ms": per_forward(f"{key}ms"),
            "v2_forward_ms": per_forward(f"v2_{key}ms"), "scratch_mb": t0["scratch_mb"],
            "passes_device_ms": t0["fw3_train_passes_device_ms" if train
                                   else "fw3_passes_device_ms"],
            "like_for_like": like}


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
        from xlstm_yolo_tpu_torch.ops import chunkwise_fw3 as f3
        from xlstm_yolo_tpu_torch.ops import chunkwise_v2 as cw
        from xlstm_yolo_tpu_torch.ops import cuda_build
        from xlstm_yolo_tpu_torch.ops import epilogue as epi
        from xlstm_yolo_tpu_torch.ops import ffn
        from xlstm_yolo_tpu_torch.ops import parallel as pk
        from xlstm_yolo_tpu_torch.ops import slstm as sk
        from xlstm_yolo_tpu_torch.ops import step as stp
        from xlstm_yolo_tpu_torch.ops import tal_metric as tk
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
    sass_mma = {k: sass_mma_counts(built[k]["library"]) for k in TC_LIBRARIES}
    emit({"phase": "setup", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "card": card,
          "build_s": time.perf_counter() - t0,
          "libraries": {k: v["library"].name for k, v in built.items()},
          "ptxas": {k: ptxas_summary(v["log"]) for k, v in built.items()},
          "sass_mma": sass_mma})
    for lib, counts in sass_mma.items():  # "" is in every kernel's name
        need = (CHUNK_FW_PASSES if lib in ("chunkwise_v1_fw", "chunkwise_exp_fw") else
                {"dc_inc_kernel": 1, "dqkv_kernel": 1}
                if lib in ("chunkwise_v1_bw", "chunkwise_exp_bw") else {"": 1})
        if isinstance(counts, dict) and not all(any(k in fn for fn in counts) for k in need):
            raise AssertionError(f"{lib}: no HMMA in the machine code of {list(need)}: {counts}")

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        emit({"phase": name, "seconds": time.perf_counter() - t})
        return out

    # the assigner's metric stage and the language model
    worst_tal, tal_launches = timed("tal_kernel", phase_tal_kernel, tk)
    worst_slstm = timed("slstm_kernel", phase_slstm_kernel, sk)
    lm_out = timed("lm", phase_lm, cw, sk, card)
    tal_t = timed("tal_times", phase_tal_times, tk, card)
    # the sub-chunked forward fw3, beside the v2 forward
    worst_fw3, fw3_launches = timed("fw3_kernel", phase_fw3_kernel, f3, cw)
    fw3_t = timed("fw3_times", phase_fw3_times, f3, cw, card)
    passes_t = timed("passes_times", phase_passes_times, cw, epi, ffn, v1, ex, card)

    worst = timed("kernel", phase_kernel, cw)
    timed("model", phase_model, cw, "vil-det-192.yaml", B, 640, launches_expected=20)
    timed("model", phase_model, cw, "vil-det-tiny.yaml", 2, 160, launches_expected=14)
    yolo = YOLO("vil-det-192.yaml", device="cuda", compute_dtype=torch.bfloat16)
    perturb_ifgates(yolo.model, seed=8)
    launches = timed("predict", phase_predict, cw, yolo)
    val_launches = timed("val", phase_val, cw, card)
    worst_train = timed("train_kernels", phase_train_kernels, cw, epi, ffn)
    timed("replay", phase_replay, cw, epi, ffn, steps)
    timed("e2e_grads", phase_e2e_grads, steps)
    model, state, step, batch, train_launches = timed("train", phase_train, cw, epi, ffn, steps)
    loop = timed("train_loop", phase_train_loop, cw, epi, ffn, card)
    ms = timed("multiscale", phase_multiscale, cw, epi, ffn, steps, card)
    emit({"phase": "times", "what": "multiscale", "card": card, "cfg": "vil-det-192",
          "batch": B, "dtype": "bfloat16",
          "predict_forward_ms": {s: p["forward_ms"] for s, p in ms["predict"].items()},
          "bucket_step_ms": ms["bucket_ms"],
          "note": "predict_forward_ms: normalise + forward + top-k of a letterboxed uint8 "
                  "batch of 8 on the card at each imgsz (CUDA events, the sizes in turns); "
                  "bucket_step_ms: the median of two optimizer steps at batch 8 from 640 px "
                  "batches resized to the bucket on the card, after one warm-up step (host "
                  "clock, synchronised)"})
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
    exp_model, exp_state, exp_step, exp_batch, exp_launches = timed(
        "exp_train", phase_exp_train, ex, v1, cw, epi, ffn, steps)
    timed("exp_grads", phase_exp_grads, ex, steps)
    par_lengths = sorted({S for S, _ in plan["train"]})
    worst_par = timed("parallel_kernels", phase_parallel_kernels, pk, par_lengths)
    par_model, par_state, par_step, par_batch, par_launches = timed(
        "parallel_train", phase_parallel_train, pk, ex, v1, cw, epi, ffn, steps)
    if v1_plan(par_model)["train"] != plan["train"]:
        raise AssertionError("the quadratic route's padded lengths differ from the v1 route's")
    timed("parallel_grads", phase_parallel_grads, pk, steps)
    worst_step = timed("step_kernel", phase_step_kernel, stp)
    decode = timed("decode", phase_decode, stp, cw, card)
    timed("refusal", phase_refusal, pk)

    # the larger detectors: their kernels, the fused LayerNorm, their paths
    wide = timed("wide_kernels", phase_wide_kernels, cw, epi, ffn, v1, ex, pk, stp, shapes,
                 par_lengths)
    worst_ln, ln_launches = timed("outnorm", phase_outnorm, cw)
    yolo384 = YOLO("vil-det-384.yaml", device="cuda", compute_dtype=torch.bfloat16)
    perturb_ifgates(yolo384.model, seed=8)
    if v1_plan(yolo384.model) != plan:
        raise AssertionError("vil-det-384's segment plan differs from vil-det-192's")
    p384 = {"chunkwise_fw": timed("predict_384", phase_predict, cw, yolo384)}
    yolo256 = YOLO("vil-det-256.yaml", device="cuda", compute_dtype=torch.bfloat16)
    perturb_ifgates(yolo256.model, seed=8)
    timed("predict_256", phase_predict, cw, yolo256, n_images=B)
    del yolo256
    for route, fn, args in (("v1", phase_v1_predict, (v1, cw)),
                            ("exp", phase_exp_predict, (ex, v1, cw))):
        y = YOLO("vil-det-384.yaml", device="cuda", compute_dtype=torch.bfloat16,
                 chunkwise_kernel={"v1": V1, "exp": EXP}[route])
        perturb_ifgates(y.model, seed=8)
        p384[f"chunkwise_{route}_fw"] = timed("predict_384", fn, *args, y, n_images=B)
        del y
    m384, st384, step384, batch384, t384 = timed("train_384", phase_train, cw, epi, ffn, steps,
                                                 cfg="vil-det-384.yaml")
    timed("train_256", phase_train, cw, epi, ffn, steps, cfg="vil-det-256.yaml", n_steps=1)
    for route, fn, args in (("v1", phase_v1_train, (v1, cw, epi, ffn, steps)),
                            ("exp", phase_exp_train, (ex, v1, cw, epi, ffn, steps))):
        out = timed("train_384", fn, *args, cfg="vil-det-384.yaml", n_steps=1)
        t384.update(out[4])
        emit({"phase": "times", "what": "train_step_traced", "route": route, "card": card,
              "cfg": "vil-det-384", "imgsz": 640, "batch": B, "compute_dtype": "bfloat16",
              **traced_step(out[2], out[1], out[3])})
        del out
    t384.update(timed("train_384", phase_parallel_train, pk, ex, v1, cw, epi, ffn, steps,
                      cfg="vil-det-384.yaml", n_steps=1)[4])
    decode384 = timed("decode", phase_decode, stp, cw, card, WIDE[-1])
    timed("wide_grads", phase_wide_grads)

    per_s = timed("times", phase_times, cw, yolo, card, passes_t[FLAGSHIP.cfg]["chunkwise_fw"])
    per_exp, exp_fwd = timed("exp_times", phase_exp_times, ex, card, plan, yolo_exp, yolo)
    del yolo
    per_train = timed("train_times", phase_train_times, cw, epi, ffn, card,
                      passes=passes_t[FLAGSHIP.cfg])
    per_v1 = timed("v1_times", phase_v1_times, v1, cw, card, plan, yolo_v1)
    per_par = timed("parallel_times", phase_parallel_times, pk, card, plan)
    steps_ms = timed("step_times", phase_step_times, card, {
        "v2": (model, state, step, batch), "v1": (v1_model, v1_state, v1_step, v1_batch),
        "exp": (exp_model, exp_state, exp_step, exp_batch),
        "parallel": (par_model, par_state, par_step, par_batch)})
    wide_t = timed("wide_times", phase_wide_times, cw, epi, ffn, v1, ex, pk, stp, card, plan,
                   passes_t)
    predict384 = timed("times", predict_times, yolo384, card)
    ts384 = time_step(step384, st384, batch384, windows=2)
    emit({"phase": "times", "what": "train_step", "route": "v2", "card": card,
          "cfg": "vil-det-384", "imgsz": 640, "batch": B, "compute_dtype": "bfloat16",
          **{k: v for k, v in ts384.items() if k != "top"}, "top": ts384.get("top", [])[:8],
          "note": "host clock around 2 steps ending in a synchronise, 2 windows after a "
                  ">= 3 s warm-up; busy share from a torch.profiler trace of one step"})

    # each kernel's calls on the main paths, to sum its per-call times over a
    # forward or a step (vil-det-384 has vil-det-192's layers, so the same)
    calls = expected_step_launches(model)
    per_step_s = {name: dict(LAUNCHES_PER_S) for name in KERNELS}
    per_step_s["chunkwise_fw_train"][6400] += calls["chunkwise_fw_train"] - calls["chunkwise_bw"]
    step_calls = {"chunkwise_v1_fw": {k: n + plan["remat"].get(k, 0)
                                      for k, n in plan["train"].items()},
                  "chunkwise_v1_bw_dc": plan["train"], "chunkwise_v1_bw_dqkv": plan["train"]}
    step_calls.update({name.replace("v1", "exp"): c for name, c in step_calls.items()})
    par_calls = {name: {S: sum(n for (s, _), n in plan["train"].items() if s == S)
                        + (sum(n for (s, _), n in plan["remat"].items() if s == S)
                           if name == "parallel_fw" else 0) for S in par_lengths}
                 for name in PAR_KERNELS}
    dist = {"chunkwise_fw": LAUNCHES_PER_S, "chunkwise_fw_ln": LAUNCHES_PER_S, **per_step_s,
            **step_calls, **par_calls}

    def sums(t, name):
        """Kernel, plain and bound ms of ``name`` summed over its calls on
        the main path (t: per-call times by S or (S, L)); the step kernel's
        per call at float32."""
        if name == "mlstm_step":
            return {k: t[name]["float32"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                        "device_ms", "host_issue_ms")}
        d = dist[name]
        out = {key: sum(n * t[name][k][key] for k, n in d.items())
               for key in ("ms", "plain_ms", "bound_ms")}
        return {**out, "bound_by": t[name][max(d)]["bound_by"]}

    flag_t = {"chunkwise_fw": per_s, **per_train, **per_v1, **per_exp, **per_par,
              "mlstm_step": decode["per_call"], "chunkwise_fw_ln": wide_t["fw_ln_flagship"]}
    w384_t = wide_t["vil-det-384.yaml"]
    w384 = wide["vil-det-384.yaml"]
    launches384 = {**t384, "chunkwise_fw": p384["chunkwise_fw"],
                   "mlstm_step": decode384["launches"], "chunkwise_fw_ln": ln_launches}
    launches384["chunkwise_v1_fw"] += p384["chunkwise_v1_fw"]
    launches384["chunkwise_exp_fw"] += p384["chunkwise_exp_fw"]

    def at_384(name):
        err = w384[name]["bfloat16"] if name in w384 else worst_ln["bfloat16"]
        return {"launches": launches384[name], **sums(w384_t, name),
                "max_abs_err": err if name == "chunkwise_fw" else err[0],
                "note": "vil-det-384 (NH 6, DH 128, batch 8, bf16): launches on its "
                        "paths (predict of 10 images on v2, one predict batch on v1 and exp, "
                        "3 train steps on v2 and one on v1, exp and the quadratic route, a "
                        f"{DECODE_TOKENS}-token decode of MatrixLSTMCell(768, 6)); times "
                        "summed over one forward or one step as at vil-det-192"}

    pallas = "xlstm_yolo_tpu/ops/pallas"
    sources = {
        "chunkwise_fw": ("chunkwise_fw.cu", "chunkwise_v2.py:245",
                         launches + val_launches + loop["chunkwise_fw"] + ms["chunkwise_fw"],
                         worst["bfloat16"]),
        "chunkwise_fw_train": ("chunkwise_fw.cu", "chunkwise_v2.py:238"),
        "chunkwise_bw": ("chunkwise_bw.cu", "chunkwise_v2.py:446"),
        "epilogue_bw": ("epilogue_bw.cu", "epilogue.py:70"),
        "ffn_bw": ("ffn_bw.cu", "ffn.py:53"),
        "chunkwise_v1_fw": ("chunkwise_v1_fw.cu", "chunkwise.py:96"),
        "chunkwise_v1_bw_dc": ("chunkwise_v1_bw.cu", "chunkwise.py:271"),
        "chunkwise_v1_bw_dqkv": ("chunkwise_v1_bw.cu", "chunkwise.py:316"),
        "chunkwise_exp_fw": ("chunkwise_exp_fw.cu", "chunkwise_exp.py:55"),
        "chunkwise_exp_bw_dc": ("chunkwise_exp_bw.cu", "chunkwise_exp.py:284"),
        "chunkwise_exp_bw_dqkv": ("chunkwise_exp_bw.cu", "chunkwise_exp.py:330"),
        "parallel_fw": ("parallel_fw.cu", "parallel.py:48"),
        "parallel_bw_dq": ("parallel_bw.cu", "parallel.py:84"),
        "parallel_bw_dkv": ("parallel_bw.cu", "parallel.py:117"),
        "mlstm_step": ("step.cu", "step.py:31"),
        "chunkwise_fw_ln": ("chunkwise_fw.cu", "chunkwise_v2.py:252"),
    }
    worst_all = {**worst_train, **worst_v1, **worst_exp, **worst_par, "mlstm_step": worst_step,
                 "chunkwise_fw_ln": worst_ln}
    launches_all = {**train_launches, **v1_launches, **exp_launches, **par_launches,
                    "mlstm_step": decode["launches"], "chunkwise_fw_ln": ln_launches}
    for name in KERNELS:
        launches_all[name] += loop[name] + ms[name]
    launches_all["chunkwise_v1_fw"] += v1_predict_launches
    launches_all["chunkwise_exp_fw"] += exp_predict_launches
    notes = {
        "chunkwise_fw": "predict and val paths; times per forward at batch 8, bf16: the 20 "
                        "calls (4 at S=6400, 6 at 1600, 6 at 400, 4 at 100) summed; launches in "
                        f"the predict of 10 images ({launches}) and the two val passes over "
                        f"{VAL_N} images at batch {VAL_BATCH} ({val_launches})",
        "train": f"train path; launches over {TRAIN_STEPS} steps at batch 8, bf16 ({calls}); "
                 f"times per step: the calls at each S ({per_step_s['chunkwise_fw_train']} for "
                 "the forward) summed",
        "v1": f"v1 route (chunkwise_kernel={V1}); launches over {TRAIN_STEPS} train steps (and "
              "the forward's in the predict of 10 images); times per train step at batch 8, "
              "bf16, the calls at each (S, L) summed",
        "exp": f"exp route (chunkwise_kernel={EXP}); as v1 (the forward: two launches a call, "
               "counted once); the forward's errors are of h (den + eps), den, m_comb and the "
               "states",
        "parallel": f"quadratic route (chunkwise_kernel={PAR}); launches over {TRAIN_STEPS} "
                    f"train steps; times per step at the padded S ({par_calls}); the plain "
                    "version in slices of batch * head; its max(|.|, 1) denominator is no "
                    "softmax, so no single PyTorch call computes the function",
        "mlstm_step": f"step--pallas; launches: one per token of a {DECODE_TOKENS}-token decode "
                      "(MatrixLSTMCell(384, 12), batch 8, float32); times per call at B 8, "
                      "NH 12, DH 32, float32: ms the CUDA-event window of 200 calls (the "
                      "wrapper's issue rate), device_ms from a profiler trace, host_issue_ms "
                      f"the host's time a call; the decode {decode['us_per_token']:.4g} us per "
                      "token",
        "chunkwise_fw_ln": "the inference forward with the per-head LayerNorm fused in "
                           "(MatrixLSTMCell(fuse_outnorm=True), which no config sets); "
                           "launches: the stateless and the stateful call of the vil-det-384 "
                           "cell at S = 1600 in phase outnorm; times summed as chunkwise_fw's "
                           "at vil-det-192's heads (DH 32)",
    }
    rows = []
    for name, (src, replaces, *given) in sources.items():
        group = ("train" if name in KERNELS else "v1" if "v1" in name else "exp"
                 if "exp" in name else "parallel" if name in PAR_KERNELS else name)
        err = given[1] if given else worst_all[name]["bfloat16"][0]
        row = {"name": name, "route": "cuda", "source": f"xlstm_yolo_tpu_torch/csrc/{src}",
               "replaces": f"{pallas}/{replaces}",
               "launches": given[0] if given else launches_all[name], "max_abs_err": err,
               **sums(flag_t, name), "library_ms": None}
        if name == "chunkwise_fw":
            row["launches_val"] = val_launches
        if name == "chunkwise_fw" or name in KERNELS:
            row["launches_train_loop"] = loop[name]
            row["multiscale"] = {
                "launches": ms[name], "max_abs_err": ms["worst"][f"{name}_bfloat16"][0],
                "max_rel_err": ms["worst"][f"{name}_bfloat16"][1],
                "max_rel_err_float32": ms["worst"][f"{name}_float32"][1],
                "note": "phase multiscale: launches on vil-det-192's paths at 512/640/768 px "
                        "(predict, the fused model, bucket steps, a multi-scale train run, val "
                        "at 512); errors against the plain version at S 9216/2304/576/144/4096 "
                        "(B 2; the row kernels at M = 2 * 9216)"}
        if not given:
            row["max_rel_err"] = worst_all[name]["bfloat16"][1]
            row["max_rel_err_float32"] = worst_all[name]["float32"][1]
        row["note"] = notes[group] + "; vil_det_384: the same at vil-det-384's widths"
        row["vil_det_384"] = at_384(name)
        if name in PAR_KERNELS:  # per call at the longest padded S, every detector's heads
            row["per_call_s6656"] = {
                cfg: {k: v for k, v in t[name][max(par_lengths)].items()
                      if k in ("ms", "plain_ms", "bound_ms", "exp_floor_ms", "sm_mhz")}
                for cfg, t in (("vil_det_192", flag_t), ("vil_det_256", wide_t[WIDE[0].cfg]),
                               ("vil_det_384", w384_t))}
        if name.endswith(("dqkv", "bw_dc", "v1_fw", "exp_fw")):  # per call at (6656, 512)
            row["per_call_s6656_l512"] = {
                cfg: {**{k: v for k, v in t[name][CHUNK_FW_SHAPE].items()
                         if k in ("ms", "plain_ms", "bound_ms", "exp_floor_ms", "sm_mhz")},
                      **passes_t[ws.cfg].get(name, {}).get(CHUNK_FW_SHAPE, {})}
                for cfg, t, ws in (("vil_det_192", flag_t, FLAGSHIP),
                                   ("vil_det_256", wide_t[WIDE[0].cfg], WIDE[0]),
                                   ("vil_det_384", w384_t, WIDE[-1]))}
        elif name in PASSES:  # per call at S 6400: each kernel's device ms
            row["per_call_s6400"] = {
                cfg: {k: v for k, v in t[name][SEQ_LENS[0]].items()
                      if k in ("ms", "bound_ms", "passes_device_ms", "passes_event_ms")}
                for cfg, t in (("vil_det_192", flag_t), ("vil_det_384", w384_t))}
        rows.append(row)
    t8 = tal_t[M_GTS]
    rows.append({
        "name": "tal_metric", "route": "cuda", "source": "xlstm_yolo_tpu_torch/csrc/tal_metric.cu",
        "replaces": f"{pallas}/tal_metric.py:39", "launches": tal_launches,
        "max_abs_err": worst_tal["max_abs_err"], "bit_equal": worst_tal["bit_equal"],
        **{k: t8[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}, "library_ms": None,
        "wrapper_ms": t8["wrapper_ms"], "eager_metric_stage_ms": t8["eager_metric_stage_ms"],
        "m128": {k: tal_t[128][k] for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms",
                                            "bound_by", "eager_metric_stage_ms")},
        "note": "task_aligned_assign_pallas_metric; launches: one per assigner call of phase "
                f"tal_kernel ({len(TAL_CASES)} calls); times per call at 640 px, batch 8, "
                f"M {M_GTS} (m128: M 128), topk 10, ms the kernel's device time, wrapper_ms "
                "the wrapper's call (its host ops: casts only where an operand is not in the "
                "kernel's type); no one PyTorch call computes the stage"})
    rows.append({
        "name": "slstm_forward", "route": "cuda", "source": "xlstm_yolo_tpu_torch/csrc/slstm.cu",
        "replaces": f"{pallas}/slstm.py:42", "launches": lm_out["launches"]["slstm_forward"],
        "max_abs_err": worst_slstm,
        **{k: lm_out["slstm"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "device_ms": lm_out["slstm"]["device_ms"],
        "us_per_step": lm_out["slstm"]["us_per_step"], "plan": lm_out["slstm"]["plan"],
        "S2048": lm_out["slstm_S2048"],
        "note": f"the LM's sLSTM cell; launches in a {LM_NEW}-token greedy generate of the LM "
                f"(batch {LM_BATCH}); times per call at the LM's forward (B 8, S 128, 4 heads "
                "of 128, float32); no one PyTorch call computes the scan"})
    for name, replaces, train in (("chunkwise_fw3", "chunkwise_fw3.py:203", False),
                                  ("chunkwise_fw3_train", "chunkwise_fw3.py:196", True)):
        rows.append({
            "name": name, "route": "cuda", "source": "xlstm_yolo_tpu_torch/csrc/chunkwise_fw3.cu",
            "replaces": f"{pallas}/{replaces}", "launches": fw3_launches[name],
            "max_abs_err": worst_fw3["max_abs_err_h_bf16"],
            **fw3_numbers(fw3_t[FLAGSHIP.cfg], train), "library_ms": None,
            "max_rel_err": worst_fw3["bfloat16"], "max_rel_err_float32": worst_fw3["float32"],
            "rounding_err_over_gap": worst_fw3["rounding_err_over_gap"],
            "dh128": fw3_numbers(fw3_t[WIDE[-1].cfg], train),
            "note": "fw3 (unwired, as in JAX); launches (three a call: the gate rows, the "
                    "state pass and the output pass) on its path in phase fw3_kernel: the "
                    "inference variant at "
                    "the v2 cell's (S, L) pairs, the train variant feeding the v2 backward at "
                    "L 64; times per call at B 8, S 6400, L 640, Lb 128, bf16 q/k/v and "
                    "products, NH 12 x DH 32 (dh128: NH 6 x DH 128); forward_ms summed over "
                    "a forward's 20 calls as chunkwise_fw's, v2 the port's v2 forward on the "
                    "same inputs (L 64, bf16 products: ms at L 640 is not a drop-in time; "
                    "like_for_like holds fw3 at v2's L 64: l64_<Lb> the inference variant, "
                    "drop_in_<Lb> the train variant); max_abs_err of h over the cases with "
                    "bf16 q or products; no one PyTorch call computes the function"})
    for row in rows:
        if row["launches"] == 0 or row.get("vil_det_384", {"launches": 1})["launches"] == 0:
            raise AssertionError(f"{row['name']} was not launched on its path")
    emit({"phase": "times", "what": "vil-det-384", "card": card, "predict": {
        k: v for k, v in predict384.items() if k not in ("top", "forward_ms_runs")},
        "train_step_ms": ts384["step_ms"], "train_step_busy_share": ts384.get("busy_share"),
        "train_step_peak_memory_gib": ts384["peak_memory_gib"],
        "train_step_clocks": ts384["clocks_during_step_timing"]})
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
