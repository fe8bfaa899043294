#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rootba_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (one nvcc per source, in
parallel), checks each kernel against its plain PyTorch twin on the card
(and the block-sparse CG operators against the CPU), drives the port's
main path through its CLI entry point (`run_app`) on four seeded
synthetic twins of BAL problems -- ladybug-49 (whose dense RCS fits the
full-row cluster CG kernel), trafalgar-126 (the half cluster CG kernel),
trafalgar-257 (above the CG kernels' gate; and once more with
pallas_cg="on", the grid CG kernel) and final-3068 (above
dense_rcs_max_cameras: the block-sparse RCS, BSR mode; in float64 also
with the half table and in dense mode, which must agree, and in float32
also with the implicit operator; every K1/K2 call of one float32 and
one float64 BSR solve held against the kernel's twin) -- and
`bundle_adjust` in process on final-4585 (above fused_obs_threshold:
the host LM driver; in float64 the BSR half table and the fused-W
stream factors, held to the attempt loop with the packed table and W
tables; float32 timed and held to float64; every K1/K2 call of the
float64 solve and of one float32 solve held against the kernel's twin),
drives the einsum layout at final-3068 (float32 through the CLI, float64
held to the flat layout's implicit mode) and the landmark mesh (a world
of 1 rank over NCCL in this process, a world of 2 ranks in two processes
on the one card over gloo, at trafalgar-257 and final-3068, each held to
the other, with a checkpoint written by each resumed in the other) --
resumes the final-3068 (CLI, host LM driver) and ladybug-49 solves from
a checkpoint and holds them to the straight solves bit for bit, holds
the numpy LM baseline (host) to the card's trajectory and scipy's TRF
to its final cost, the native BAL tokenizer to the Python one and a
solve from a `.cereal` file to the solve from the text, holds the "obs"
pair gather to the default "stream" (SC at trafalgar-257, dense; the
default solver at final-3068, BSR, where both are timed warm, in turns),
with every K1/K2 call of one obs attempt held against its twin,
builds the evaluation tools' batch report (eval/) over three ladybug-49
logs that the card wrote and runs the live viewer's solve on the card,
held bit for bit to a direct solve of the same twin --
cross-checks small solves on the card against the CPU, shows from the
wrappers' launch counts in one more solve of each path (under a
profiler trace, which must hold the same launches) that each path went
through its kernels and what they took per LM attempt, times every
kernel beside its bound, its plain twin and a one-call PyTorch
yardstick (device time from a profiler trace, with the names of the
kernels in it), times the CG operators at the final-3068 system, and
prints

    {"einsum_mesh": {...}, "card": ...}
    {"pair_gathers": {...}, "card": ...}
    {"checkpoint_baselines_formats": {...}, "eval": {...}, "card": ...}
    {"sc": {...}, "phase_walls_s": {...}}
    {"bsr_operators": [...]}
    <nvidia-smi name, power limit>
    {"kernels": [...]}
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

as its last eight lines. Exits non-zero, printing no result, without a
CUDA device or without the repository's package beside it. It imports
nothing of JAX or of the JAX package. Scratch files go to
build/chip_smoke/ (listed in .gitignore).
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# BAL twins: sizes and covisibility knobs of benchmarks/scale_bench.py
# (SIZES, STRUCTURE), copied so that this script imports nothing of the
# JAX package
TWINS = {
    "ladybug": dict(num_cams=49, num_lms=7776, num_obs=31843,
                    structure="clustered", track_sigma=0.8,
                    window_stretch=0.5, p_far=0.005, max_window_frac=1.0),
    "trafalgar": dict(num_cams=257, num_lms=65132, num_obs=225911,
                      structure="clustered", track_sigma=1.0,
                      window_stretch=2.0, p_far=0.02, max_window_frac=0.5),
    # BAL's trafalgar problem-126-40037 (cameras, landmarks) with
    # trafalgar-257's observations per landmark and knobs: above the
    # cluster CG kernel's capacity, below the 128-camera gate
    "trafalgar126": dict(num_cams=126, num_lms=40037, num_obs=138869,
                         structure="clustered", track_sigma=1.0,
                         window_stretch=2.0, p_far=0.02,
                         max_window_frac=0.5),
    # BAL's final problem-3068-310854-1653812 with scale_bench.py's
    # final4585 knobs: above dense_rcs_max_cameras, so the block-sparse
    # RCS (BSR mode, packed table)
    "final3068": dict(num_cams=3068, num_lms=310854, num_obs=1653812,
                      structure="clustered", track_sigma=1.1,
                      window_stretch=3.0, p_far=0.03,
                      max_window_frac=0.08),
    # BAL's final problem-4585-1324582-9125125 with the final4585 knobs:
    # above fused_obs_threshold (the host LM driver); in float64 its
    # packed table passes bsr_pack_max_gb (the half table) and its W
    # tables _FUSED_W_MIN_BYTES (the fused-W stream factors)
    "final4585": dict(num_cams=4585, num_lms=1324582, num_obs=9125125,
                      structure="clustered", track_sigma=1.1,
                      window_stretch=3.0, p_far=0.03,
                      max_window_frac=0.08),
}
# the kernel each row of the table times, as its name appears in a
# profiler trace
KERNEL_NAMES = {"outer81_fold": "outer81_fold_kernel",
                "w_build": "w_build_kernel",
                "pcg_dense_cluster": "pcg_dense_cluster_kernel",
                "pcg_dense_half": "pcg_dense_half_kernel",
                "pcg_dense_grid": "pcg_dense_kernel"}
# the JAX package's 20-iteration run of the ladybug twin on a TPU v5e
# (BENCH_r05.json): printed as a loose cross-check, never asserted
LADYBUG_TPU_FINAL_COST = 20066.39
# the port's final cost of the same solve on the card (f32, 7 digits;
# index_add_ moves the last ones from run to run): held to rel 1e-4
LADYBUG_CARD_FINAL_COST = 20066.38
# the trafalgar-126 twin's final cost after 5 f32 LM iterations on the
# card with the grid K3 (the tree before the half kernel; printed by
# scripts/kernel_ab.py): held to rel 1e-4
TRAFALGAR126_CARD_FINAL_COST = 78704.86278591496
# the CLI flag that takes K3 above its gate
K3_ON = ("--pallas-cg", "on")

# preprocessing of bench.py:28-42 (normalize 100, perturb 0/0.01/0.01
# with seed 38401, filter 0.1) as CLI flags
PREPROCESS = ["--normalization-scale", "100", "--rotation-sigma", "0",
              "--translation-sigma", "0.01", "--point-sigma", "0.01",
              "--random-seed", "38401", "--init-depth-threshold", "0.1"]


class Failure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failure(what)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean time of fn() in ms over `reps` back-to-back calls, by CUDA
    events after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces and argument
    list: "void (anonymous namespace)::k<float>(float const*)" ->
    "k<float>"."""
    base = name.replace("(anonymous namespace)::", "")
    if base.startswith("void "):
        base = base[5:]
    return base.split("(")[0][:80]


# host seconds kept free of launches at both edges of a profiler step:
# the trace keeps a kernel only if its start and end, on the host clock,
# fall inside the step, and the card's timestamps can sit a millisecond
# off that clock (scripts/trace_edges.py counts what a trace keeps with
# and without the margin)
TRACE_MARGIN_S = 0.02


def device_ms(fn, reps: int = 20, margin_s: float = TRACE_MARGIN_S):
    """(device time of one fn() call in ms, {kernel: launches per call})
    from a torch.profiler trace of `reps` calls: the summed duration of
    the CUDA kernels (and copies) in the trace over reps, so host launch
    overhead between calls does not count. The trace is the second of two
    profiler steps of `reps` calls each (warm-up, then active), each call
    window margin_s from the step's edges."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            time.sleep(margin_s)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(margin_s)
            prof.step()
    us = 0.0
    counts = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us += e.time_range.elapsed_us()
            n = short_name(e.name)
            counts[n] = counts.get(n, 0) + 1
    return us / reps / 1e3, {k: v / reps for k, v in sorted(counts.items())}


def traced_ms(fn, expect: str = None, reps: int = 20, tries: int = 5):
    """device_ms of fn from the first of at most `tries` traces that
    holds the kernel `expect` names exactly once per call (without
    `expect`: some kernel): (ms, {kernel: launches per call}, traces
    taken), ms None where no trace did."""
    for n in range(1, tries + 1):
        ms, names = device_ms(fn, reps)
        if expect is None:
            ok = ms > 0 and bool(names)
        else:
            ok = sum(v for k, v in names.items() if expect in k) == 1.0
        if ok:
            return ms, names, n
    return None, names, tries


def both(key: str, fn, reps: int, warmup: int = 3,
         expect: str = None) -> dict:
    """{key: device time of fn's kernels (traced_ms), key_per_call: time
    per call of back-to-back calls (CUDA events), which includes the
    host's launch overhead where it exceeds the device work, key_trace:
    the kernels in the trace and their launches per call, key_traces: the
    traces taken}. The row fails unless a trace holds the kernel `expect`
    names once per call."""
    per_call = cuda_ms(fn, reps, warmup)
    dev, names, tries = traced_ms(fn, expect, min(reps, 20))
    check(dev is not None, f"{key}: {expect or 'no kernel'} not once per "
                           f"call in the trace {names} ({tries} traces)")
    return {key: dev, f"{key}_per_call": per_call, f"{key}_trace": names,
            f"{key}_traces": tries}


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def close(a, b, rtol: float, atol: float) -> bool:
    a, b = a.double(), b.double()
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain twin on the card

# systems above this many cameras are built on the card (spd_system):
# numpy's A0 A0' at N = 2048 would take 12.5 TFLOP of host time
SPD_HOST_MAX_N = 500


def spd_system(N: int, Nc: int, seed: int, dev=None):
    """A random SPD system in the x-space [9N, 9N] layout and its padded
    z-space form Hz[a*Nc+i, b*Nc+j] = A[i*9+a, j*9+b] (float32): (Hz, its
    9x9 diagonal blocks, b), numpy arrays from seed; above SPD_HOST_MAX_N
    cameras made on the card `dev` from a torch.Generator seeded with
    seed, A symmetrized (the card's product is not), as tensors there."""
    import numpy as np

    if N > SPD_HOST_MAX_N:
        import torch

        g = torch.Generator(device=dev).manual_seed(seed)
        n = 9 * N
        A = torch.randn(n, n, generator=g, device=dev) / n ** 0.5
        A = A @ A.T
        A = 0.5 * (A + A.T) + 2.0 * torch.eye(n, device=dev)
        b = torch.randn(N, 9, generator=g, device=dev)
        A4 = A.view(N, 9, N, 9)
        blocks = torch.diagonal(A4, dim1=0, dim2=2).permute(2, 0, 1)
        Hz = torch.zeros((9, Nc, 9, Nc), device=dev)
        Hz[:, :N, :, :N] = A4.permute(1, 0, 3, 2)
        return Hz.view(9 * Nc, 9 * Nc), blocks.contiguous(), b
    rng = np.random.default_rng(seed)
    n = 9 * N
    A0 = rng.normal(size=(n, n)) / np.sqrt(n)
    A = (A0 @ A0.T + 2.0 * np.eye(n)).astype(np.float32)
    b = rng.normal(size=(N, 9)).astype(np.float32)
    Hz = np.zeros((9, Nc, 9, Nc), np.float32)
    Hz[:, :N, :, :N] = A.reshape(N, 9, N, 9).transpose(1, 0, 3, 2)
    blocks = np.stack([A[9 * i:9 * i + 9, 9 * i:9 * i + 9]
                       for i in range(N)])
    return Hz.reshape(9 * Nc, 9 * Nc), blocks, b


def check_k1(dev, errs: dict) -> None:
    """K1 against its twin: run widths 1..64, K = 2 (Jp) and 3 (W), f32
    and f64, slot counts ragged against the 64-slot tile, per (dtype, K)
    one stream of ~5,000 tiles, so that every block walks through both
    stages of its copy pipeline several times, and one full chunk of
    the obs reducer (at the obs index's run width, 64:
    linearization._chunk_slots of its rows)."""
    import torch

    from rootba_tpu_torch.ops import fold
    from rootba_tpu_torch.solver.linearization import _chunk_slots

    W64 = 64  # bucketing.build_pair_csr's run width

    g = torch.Generator(device="cpu").manual_seed(5)
    for dtype in (torch.float32, torch.float64):
        worst = 0.0
        # tolerances: f32 sums of W*K products in another order
        # (rtol/atol 1e-5, the JAX package's kernel-vs-XLA test); f64
        # at its precision
        rtol = atol = 1e-5 if dtype == torch.float32 else 1e-12
        itemsize = torch.empty((), dtype=dtype).element_size()
        for K in (2, 3):
            chunk = _chunk_slots(9 * K * itemsize, W64) // W64
            for W, R in [(w, 3 * max(1, 64 // w) + 5)
                         for w in (1, 2, 4, 8, 16, 32, 64)] + [
                             (8, 40003), (W64, chunk)]:
                # wider runs scaled to W = 16's spread of run sums, so
                # that the same tolerance holds the same relative error
                scale = min(1.0, (16 / W) ** 0.5)
                s1 = (torch.randn(R * W, K * 9, generator=g, dtype=dtype)
                      * scale).to(dev)
                s2 = (torch.randn(R * W, K * 9, generator=g, dtype=dtype)
                      * scale).to(dev)
                got = fold.outer81_fold(s1, s2, W)
                ref = fold.fold_plain(s1, s2, W)
                torch.cuda.synchronize()
                err = max_abs(got, ref)
                worst = max(worst, err)
                if dtype == torch.float32:
                    errs["outer81_fold"] = max(errs["outer81_fold"], err)
                check(close(got, ref, rtol, atol),
                      f"K1 {dtype} K={K} W={W} R={R}: max abs err {err}")
        print(f"[phase 2] K1 {str(dtype)[6:]}: W 1..64, K 2 and 3, ragged "
              f"tiles, a 40,003-run stream and an obs chunk of "
              f"{chunk} runs at W = 64 (K = 3): max abs err {worst:.3e} "
              f"(tol rtol=atol={rtol:g})", flush=True)


def check_k2(dev, errs: dict) -> None:
    import torch

    from rootba_tpu_torch.ops import fold

    g = torch.Generator(device="cpu").manual_seed(6)
    for dtype in (torch.float32, torch.float64):
        worst = 0.0
        for n in (2, 3, 5, 8, 16, 32, 64):
            L = 257
            q = torch.randn(L, n * 6, generator=g, dtype=dtype).to(dev)
            jp = torch.randn(L, n * 18, generator=g, dtype=dtype).to(dev)
            got = fold.w_build(q, jp, n)
            ref = fold.w_build_plain(q, jp, n)
            torch.cuda.synchronize()
            err = max_abs(got, ref)
            worst = max(worst, err)
            if dtype == torch.float32:
                errs["w_build"] = max(errs["w_build"], err)
            # products and sum rounded separately in both: equal bits
            check(err == 0.0, f"K2 {dtype} n={n}: max abs err {err}")
        print(f"[phase 2] K2 {str(dtype)[6:]}: max abs err {worst:.3e} "
              f"(tol 0)", flush=True)


# K3 test systems (N, Nc), each from seed N: on both sides of k3_plan's
# switches between the full-row cluster kernel (N <= 96), the half
# kernel (N <= 128) and the grid kernel, trafalgar-126's size, one
# unpadded system (the half kernel also takes every N <= 96 here), and
# the grid kernel's sizes: trafalgar-257 (Nc 384), the last N whose rows
# all stay in shared memory (264) and the first that streams some
# (265; unpadded too, its rows not 16-byte aligned: the 4-byte copies),
# 400, and two that stream nearly all (1025 on Nc 1152, 2048)
K3_SYSTEMS = ((12, 128), (49, 128), (92, 128), (93, 128), (96, 128),
              (97, 128), (126, 128), (128, 128), (129, 256), (49, 49),
              (257, 384), (264, 384), (265, 384), (265, 265), (400, 512),
              (1025, 1152), (2048, 2048))
# A zeta test with q_tol below 2^-24 stops a float32 CG where q1 - q0
# falls to about one ulp of q1, so two correct implementations may stop
# one iteration apart where q's exact decrease is within float32's
# rounding (PERF.md, "Stopping ties"). Such a pair passes only where
# the exact (float64) zeta at the earlier stop m lies within m * 2^-21
# of q_tol: q's exact decrease within 4-8 ulps of q1.
ZETA_BAND = 2.0 ** -21


def zeta64(Hz, b2, Lp, kw: dict, m: int) -> float:
    """The exact zeta of the twin's iteration m, m (q1_m - q1_{m-1}) /
    q1_m, in float64 with q1 = -x . (2b - Hx) (r = b - Hx exactly) for
    the twin's x after m - 1 and m fixed iterations (as
    scripts/k3_checks.py prints it)."""
    from rootba_tpu_torch.ops import cg_dense

    H = Hz.double()
    b = b2.double().reshape(-1)

    def q1(n: int) -> float:
        if n == 0:
            return 0.0
        x = cg_dense.pcg_dense_plain(Hz, b2, Lp, **{
            **kw, "max_iters": n, "q_tol": float("-inf")})[0]
        x = x.double().reshape(-1)
        return float(-(x @ (2 * b - H @ x)))

    q_prev, q_m = q1(m - 1), q1(m)
    return m * (q_m - q_prev) / q_m


def compare_k3(name: str, launch, Hz, b2, Lp, N: int, kw: dict,
               errs: dict) -> str:
    """A K3 launcher against the twin with the CG options kw: equal
    iteration counts and terminations, x to rtol 2e-4 / atol 2e-5 (the
    test of the JAX package's kernel against pcg, test_cg.py), zeros in
    x's padded lanes. Under a zeta test below 2^-24, stops one iteration
    apart pass as a tie within ZETA_BAND, with x compared at the shorter
    count. Returns the line to print."""
    from rootba_tpu_torch.ops import cg_dense
    from rootba_tpu_torch.solver.cg import CG_SUCCESS

    x_p, st_p = cg_dense.pcg_dense_plain(Hz, b2, Lp, **kw)
    x_k, st_k = launch(Hz, b2, Lp, **kw)
    it_p, term_p = int(st_p[0]), int(st_p[1])
    it_k, term_k = int(st_k[0]), int(st_k[1])
    what = (f"{name} N={N} Nc={Hz.shape[0] // 9} q_tol={kw['q_tol']:g} "
            f"reset every {kw['reset_period']}")
    check(not x_k[:, N:].any(), f"{what}: nonzero padded lanes of x")
    tie = ""
    m = min(it_k, it_p)
    if it_k != it_p:
        z = zeta64(Hz, b2, Lp, kw, m)
        check(kw["q_tol"] < 2.0 ** -24 and abs(it_k - it_p) == 1
              and term_k == term_p == CG_SUCCESS
              and abs(z - kw["q_tol"]) <= m * ZETA_BAND,
              f"{what}: iterations/termination {it_k}/{term_k} vs "
              f"{it_p}/{term_p}, exact zeta at {m}: {z:.3e} (tie band "
              f"{m * ZETA_BAND:.3e})")
        fixed = {**kw, "max_iters": m, "q_tol": float("-inf")}
        if it_k > m:
            x_k = launch(Hz, b2, Lp, **fixed)[0]
        else:
            x_p = cg_dense.pcg_dense_plain(Hz, b2, Lp, **fixed)[0]
        tie = (f", a stopping tie (exact zeta at {m}: {z:.3e}, band "
               f"{m * ZETA_BAND:.3e}; x compared at {m})")
    check(term_k == term_p, f"{what}: termination {term_k} vs {term_p}")
    err = max_abs(x_k, x_p)
    errs[name] = max(errs[name], err)
    check(close(x_k, x_p, 2e-4, 2e-5), f"{what}: max abs err {err}")
    if kw["reset_period"] == 3 or kw["q_tol"] == float("-inf"):
        check(m > kw["reset_period"], f"{what}: {m} iterations cross no "
                                      f"reset")
    return (f"{what}: iterations {it_k}/{it_p} (kernel/plain), "
            f"termination {term_k}/{term_p}, max abs err {err:.3e} (tol "
            f"rtol=2e-4, atol=2e-5){tie}")


# k3_plan is held to the kernels' own plans up to this many cameras,
# and the grid kernel's capacity edge beyond (check_k3_plan)
K3_PLAN_MAX_N = 2048


def check_k3_plan() -> None:
    """k3_plan (ops/cg_dense.py) against the capacity checks of the
    cluster kernels' launches (rb_pcg_dense_cluster_plan in
    csrc/cg_dense.cu) and the grid kernel's plan (rb_pcg_dense_grid_plan)
    on this card's SMs at every N up to K3_PLAN_MAX_N: the same choice,
    for a cluster kernel the same rows per CTA and shared memory, for the
    grid kernel the same CTAs, resident and streamed rows, ring stages
    and shared memory; and the same largest N for the grid kernel."""
    import ctypes

    from rootba_tpu_torch.ops import cg_dense, kernels

    lib = kernels.load("cg_dense")
    sms = cg_dense.card_sms(0)
    rows, smem = ctypes.c_int(), ctypes.c_longlong()
    out = (ctypes.c_int * 7)()

    def grid(N):
        ok = lib.rb_pcg_dense_grid_plan(N, sms, ctypes.addressof(out),
                                        ctypes.addressof(smem))
        return ((out[0], out[3], out[4], out[5], out[6], smem.value) if ok
                else None)

    largest = {}
    for N in range(1, K3_PLAN_MAX_N + 1):
        code = lib.rb_pcg_dense_cluster_plan(N, ctypes.addressof(rows),
                                             ctypes.addressof(smem))
        kernel = (cg_dense.PLAN_KERNELS[code]
                  if 0 <= code < len(cg_dense.PLAN_KERNELS) else str(code))
        plan = cg_dense.k3_plan(N, N, sms)
        if kernel == "grid":
            want = grid(N)
            got = (plan.ctas, plan.rows_per_cta, plan.streamed, plan.stages,
                   plan.stage_rows, plan.smem_bytes)
        else:
            want = (rows.value, smem.value)
            got = (plan.rows_per_cta, plan.smem_bytes)
        check(plan.kernel == kernel and got == want,
              f"k3_plan({N}) = {plan}; the kernel's plan: {kernel} {want}")
        largest[kernel] = N
    edge = cg_dense.grid_max_cameras(sms)
    check(grid(edge) is not None and grid(edge + 1) is None,
          f"grid kernel capacity: k3_plan's {edge}, the kernel's plan at "
          f"{edge} / {edge + 1}: {grid(edge)} / {grid(edge + 1)}")
    print(f"[phase 2] k3_plan equals the cluster kernels' capacity checks "
          f"and the grid kernel's plan on {sms} SMs at N = "
          f"1..{K3_PLAN_MAX_N}: largest N per kernel {largest}; the grid "
          f"kernel takes up to {edge} cameras", flush=True)


def check_k3(dev, errs: dict) -> None:
    """The K3 kernels against the twin: the full-row cluster kernel
    wherever k3_plan gives it, the half kernel wherever it fits, the grid
    kernel on every system, with the zeta
    test at both ends and two runs that cross the exact residual reset
    r = b - Hx (every 3rd iteration, and a fixed 25 iterations with the
    main path's period 10); then the wrapper pcg_dense on the card
    against the same call on the CPU."""
    import torch

    from rootba_tpu_torch.ops import cg_dense, kernels
    from rootba_tpu_torch.ops.block9 import chol9

    check_k3_plan()
    for N, Nc in K3_SYSTEMS:
        Hz, blocks, b = spd_system(N, Nc, seed=N, dev=dev)
        Hz = torch.as_tensor(Hz, device=dev)
        chol = chol9(torch.as_tensor(blocks, device=dev))
        bt = torch.as_tensor(b, device=dev)
        Lp = cg_dense.chol_planes(chol, Nc)
        b2 = torch.zeros((9, Nc), dtype=torch.float32, device=dev)
        b2[:, :N] = bt.T
        plan = cg_dense.k3_plan(N, Nc, cg_dense.card_sms(dev))
        launchers = {"pcg_dense_grid": lambda *a, **k:
                     cg_dense._launch_grid(*a, N, **k)}
        for kernel in ("cluster", "half"):
            if kernel == plan.kernel or (kernel == "half"
                                         and cg_dense.half_fits(N)):
                launchers[f"pcg_dense_{kernel}"] = (
                    lambda *a, kernel=kernel, **k:
                    cg_dense._launch_in_cluster(kernel, *a, N, **k))
        for q_tol, max_it, period in ((1e-1, 100, 10), (1e-8, 200, 10),
                                      (1e-8, 200, 3),
                                      (float("-inf"), 25, 10)):
            kw = dict(min_iters=0, max_iters=max_it, q_tol=q_tol,
                      r_tol=-1.0, reset_period=period)
            for name, launch in launchers.items():
                line = compare_k3(name, launch, Hz, b2, Lp, N, kw, errs)
                print(f"[phase 2] {line} ({plan.kernel} plan)", flush=True)
        # the wrapper the main path calls (chol planes, b's padding, the
        # float32 casts, x's layout, the plan): on the card against the
        # same call on CPU copies, which takes the plain twin
        name = f"pcg_dense_{plan.kernel}"
        for q_tol in (1e-1, float("-inf")):
            wk = dict(max_num_iterations=25, q_tolerance=q_tol)
            before = kernels.LAUNCHES[name]
            r_k = cg_dense.pcg_dense(Hz, chol, bt, **wk)
            check(kernels.LAUNCHES[name] == before + 1,
                  f"K3 wrapper N={N}: did not launch {name}")
            r_p = cg_dense.pcg_dense(Hz.cpu(), chol.cpu(), bt.cpu(), **wk)
            it_k, it_p = int(r_k.num_iterations), int(r_p.num_iterations)
            term_k = int(r_k.termination_type)
            term_p = int(r_p.termination_type)
            err = max_abs(r_k.x.cpu(), r_p.x)
            errs[name] = max(errs[name], err)
            print(f"[phase 2] K3 wrapper ({name}) N={N} q_tol={q_tol:g}: "
                  f"iterations {it_k}/{it_p} (card/cpu), termination "
                  f"{term_k}/{term_p}, max abs err {err:.3e} "
                  f"(tol rtol=2e-4, atol=2e-5)", flush=True)
            check(r_k.x.is_cuda and r_k.x.shape == bt.shape
                  and r_k.x.dtype == bt.dtype,
                  f"K3 wrapper N={N}: x {r_k.x.device} {r_k.x.dtype} "
                  f"{tuple(r_k.x.shape)}")
            check(it_k == it_p and term_k == term_p,
                  f"K3 wrapper N={N} q_tol={q_tol}: iterations/"
                  f"termination {it_k}/{term_k} vs {it_p}/{term_p}")
            check(close(r_k.x.cpu(), r_p.x, 2e-4, 2e-5),
                  f"K3 wrapper N={N} q_tol={q_tol}: max abs err {err}")


def check_kernels(dev) -> dict:
    """Each kernel against its plain twin on the card; returns the
    largest error per kernel."""
    errs = dict.fromkeys(KERNEL_NAMES, 0.0)
    check_k1(dev, errs)
    check_k2(dev, errs)
    check_k3(dev, errs)
    return errs


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path through the CLI

class Recorder:
    """Wraps the three kernel wrappers while a path runs and keeps a
    copy of the inputs of each kernel's largest call, for the timing
    phase. The wrappers themselves keep the launch counts; the
    recording (input copies, a host read of K3's iteration count) runs
    only in untimed solves."""

    def __init__(self):
        from rootba_tpu_torch.ops import cg_dense, fold

        self.mods = {"outer81_fold": fold, "w_build": fold,
                     "pcg_dense": cg_dense}
        self.orig = {k: getattr(m, k) for k, m in self.mods.items()}
        self.largest = {}
        self.k3_calls = []  # (inputs, options, iterations) of every call

    def _wrap(self, name):
        orig = self.orig[name]

        def wrapped(*args, **kw):
            best = self.largest.get(name, (0,))[0]
            # K1/K2: the largest call; K3: the call with the most CG
            # iterations (its work depends on the data)
            size = None if name == "pcg_dense" else args[0].numel()
            kept = None
            if size is None or size > best:
                kept = tuple(a.clone() if hasattr(a, "clone") else a
                             for a in args)
            out = orig(*args, **kw)
            if size is None:
                size = int(out.num_iterations)
                self.k3_calls.append((kept, dict(kw), size))
            if size > best:
                self.largest[name] = (size, kept, dict(kw))
            return out
        return wrapped

    def __enter__(self):
        for k, m in self.mods.items():
            setattr(m, k, self._wrap(k))
        return self

    def __exit__(self, *exc):
        for k, m in self.mods.items():
            setattr(m, k, self.orig[k])
        return False


def write_twin(name: str, seed: int = 17, npz: bool = False) -> Path:
    """The seeded twin as a BAL text file, or with npz as the port's
    .npz problem file (bal/problem.py's load_npz; seconds to write and
    read where the text of 9M observations takes minutes)."""
    from rootba_tpu_torch.bal.synthetic import (
        generate_synthetic_bal,
        write_bal_file,
    )

    t = dict(TWINS[name])
    cams, lms, obs = t.pop("num_cams"), t.pop("num_lms"), t.pop("num_obs")
    p = generate_synthetic_bal(num_cams=cams, num_lms=lms,
                               mean_obs_per_lm=obs / lms, pixel_noise=1.0,
                               seed=seed, **t)
    path = WORK / f"problem-{cams}-{lms}-twin.{'npz' if npz else 'txt'}"
    if npz:
        p.save_npz(str(path))
    else:
        write_bal_file(p, str(path))
    return path


def run_cli(bal_path: Path, iters: int, tag: str, extra=(),
            use_double: bool = False, solver: str = None) -> dict:
    """One solve through the port's CLI entry point on the card (extra:
    more CLI flags), float32 unless use_double; solver forces the solver
    type as the `bal_sc` / `bal_power_sc` executables do; returns the
    ba_log.json it wrote."""
    from rootba_tpu_torch.cli.bal import run_app

    wd = WORK / tag
    wd.mkdir(parents=True, exist_ok=True)
    log = wd / "ba_log.json"
    if log.exists():
        log.unlink()
    argv = ["-C", str(wd), "--input", str(bal_path), "--device", "cuda",
            "--use-double", str(use_double).lower(),
            "--max-num-iterations", str(iters),
            "--function-tolerance", "0", "--verbosity-level", "1",
            "--quiet", *PREPROCESS, *extra]
    rc = run_app("chip smoke", argv, forced_solver_type=solver)
    check(rc == 0, f"{tag}: run_app returned {rc}")
    check(log.exists(), f"{tag}: no ba_log.json written")
    return json.loads(log.read_text())


def summarize_log(d: dict, tag: str) -> dict:
    cost = d["cost"]
    check(all(c == c and abs(c) != float("inf") for c in cost),
          f"{tag}: non-finite cost")
    check(cost[-1] < cost[0], f"{tag}: cost did not decrease "
                              f"({cost[0]} -> {cost[-1]})")
    return dict(initial_cost=cost[0], final_cost=cost[-1],
                minimizer_s=d["_static"]["solver"][
                    "minimizer_time_in_seconds"],
                iteration_s=d["iteration_time"][1:],
                cg_iters=d["linear_solver_iterations"][1:],
                stage_s={k: sum(d[k][1:]) for k in (
                    "stage1_time", "stage2_time", "prepare_time",
                    "solve_reduced_system_time", "back_substitution_time",
                    "residual_evaluation_time")})


# phase 5's small solves: (options, sqrt_flat globals patched,
# precisions) of each: the default (dense RCS), BSR mode with the packed
# and with the half table, the host LM driver, and BSR mode with the
# fused-W stream factors; then SCHUR_COMPLEMENT in dense, BSR and scatter
# mode, under the DIAGONAL and POWER_SCHUR_COMPLEMENT preconditioners
# and through the host LM driver, PoBA with dense E0, BSR E0 and the
# implicit sweep, the obs pair gather (dense), SC and PoBA on obs in BSR
# mode, and the einsum layout
SC = dict(solver_type="SCHUR_COMPLEMENT")
POBA = dict(solver_type="POWER_SCHUR_COMPLEMENT")
SMALL_MODES = {
    "dense": ({}, {}, (True, False)),
    "bsr": (dict(sqrt_rcs_mode="bsr"), {}, (True, False)),
    "bsr_sym": (dict(sqrt_rcs_mode="bsr", bsr_pack_max_gb=0.0), {},
                (True, False)),
    "host": (dict(lm_loop="host"), {}, (True,)),
    "bsr_fused_w": (dict(sqrt_rcs_mode="bsr"), dict(_FUSED_W_MIN_BYTES=0),
                    (True, False)),
    "sc_dense": (SC, {}, (True, False)),
    "sc_bsr": (dict(SC, dense_rcs_max_cameras=4), {}, (True, False)),
    "sc_scatter": (dict(SC, dense_rcs_max_cameras=0), {}, (True, False)),
    "sc_diagonal": (dict(SC, preconditioner_type="DIAGONAL"), {},
                    (True, False)),
    "sc_power": (dict(SC, preconditioner_type="POWER_SCHUR_COMPLEMENT"), {},
                 (True, False)),
    "sc_host": (dict(SC, lm_loop="host"), {}, (True, False)),
    "poba_dense": (POBA, {}, (True, False)),
    "poba_bsr": (dict(POBA, dense_rcs_max_cameras=4), {}, (True, False)),
    "poba_implicit": (dict(POBA, dense_rcs_max_cameras=0), {},
                      (True, False)),
    "obs": (dict(pair_gather="obs"), {}, (True, False)),
    "sc_obs_bsr": (dict(SC, dense_rcs_max_cameras=4, pair_gather="obs"),
                   {}, (True, False)),
    "poba_obs_bsr": (dict(POBA, dense_rcs_max_cameras=4, pair_gather="obs"),
                     {}, (True, False)),
    "einsum": (dict(kernel_layout="einsum"), {}, (True, False))}


def solver_options(**kw):
    """SolverOptions from plain values (enum options by name)."""
    from rootba_tpu_torch.config.options import (
        PreconditionerType,
        SolverOptions,
        SolverType,
    )

    enums = {"solver_type": SolverType,
             "preconditioner_type": PreconditionerType}
    return SolverOptions(**{k: enums[k](v) if k in enums else v
                            for k, v in kw.items()})


def small_cross_check(only=None) -> None:
    """A small solve (12 cameras) on the card against the same solve on
    the CPU through the plain twins, in each of SMALL_MODES (or the
    modes named in `only`): float64 to rel 1e-8 with identical
    accept/reject and CG (power-series) counts; float32 final cost to
    rel 1e-4."""
    from rootba_tpu_torch.bal.synthetic import generate_synthetic_bal
    from rootba_tpu_torch.solver import sqrt_flat
    from rootba_tpu_torch.solver.lm import bundle_adjust

    for mode, (kw, globs, precisions) in SMALL_MODES.items():
        if only is not None and mode not in only:
            continue
        # the flat SQUARE_ROOT layout (the only one with W factors)
        sqrt_mode = "solver_type" not in kw and "kernel_layout" not in kw
        for use_double in precisions:
            out = {}
            for dev in ("cuda", "cpu"):
                p = generate_synthetic_bal(num_cams=12, num_lms=200,
                                           mean_obs_per_lm=4.5, seed=3)
                p.normalize(100.0)
                p.perturb(0.001, 0.05, 0.05, 38401)
                p.filter_obs(0.1)
                opts = solver_options(use_double=use_double,
                                      verbosity_level=0,
                                      max_num_iterations=20,
                                      initial_trust_region_radius=10.0,
                                      function_tolerance=1e-5, **kw)
                with patched(sqrt_flat, **globs), LoopSpy() as loops, \
                        FactorSpy() as factors:
                    s = bundle_adjust(p, opts, device=dev)
                # the SC solvers and the einsum layout build no W
                # factors
                kinds = (set() if not sqrt_mode
                         else {"fused" if globs else "tables"})
                check(loops.loops == [kw.get("lm_loop", "fused")]
                      and set(factors.kinds) == kinds,
                      f"small {mode} solve on {dev}: LM loop "
                      f"{loops.loops}, W factors {set(factors.kinds)}")
                out[dev] = ([i.cost.all.error for i in s.iterations],
                            [i.step_is_successful for i in s.iterations],
                            [i.linear_solver_iterations
                             for i in s.iterations])
            (cg, fg, ig), (cc, fc, ic) = out["cuda"], out["cpu"]
            rel = abs(cg[-1] - cc[-1]) / abs(cc[-1])
            what = f"small {mode} solve {'f64' if use_double else 'f32'}"
            print(f"[phase 5] {what}: final cost {cg[-1]:.10g} (card) vs "
                  f"{cc[-1]:.10g} (cpu), rel {rel:.2e}; {len(cg)}/"
                  f"{len(cc)} iterations; CG {ig} / {ic}", flush=True)
            check(cg[-1] < cg[0], f"{what}: cost did not decrease")
            if use_double:
                check(fg == fc and ig == ic and len(cg) == len(cc),
                      f"{what}: accept/reject or CG counts differ between "
                      f"card and CPU")
                check(max(abs(a - b) / abs(b) for a, b in zip(cg, cc))
                      < 1e-8, f"{what}: costs differ beyond rel 1e-8")
            else:
                check(rel < 1e-4, f"{what}: final cost rel {rel}")


# ---------------------------------------------------------------------------
# timing at the main path's inputs

def k3_inputs(Hz, chol, b):
    """The planar preconditioner and padded right-hand side that the
    wrapper pcg_dense hands to the kernels."""
    import torch

    from rootba_tpu_torch.ops import cg_dense

    Nc = Hz.shape[0] // 9
    Lp = cg_dense.chol_planes(chol.float(), Nc)
    b2 = torch.zeros((9, Nc), dtype=torch.float32, device=Hz.device)
    b2[:, :b.shape[0]] = b.float().T
    return Lp, b2


def check_k3_main_path(calls: list, tag: str) -> tuple:
    """K3 against its twin on every K3 call of a main-path solve (the
    real RCS, preconditioner and RHS of each LM attempt), through the
    kernel k3_plan gives, each run for a fixed min(its own count, 11)
    iterations: the first 11 cross the residual reset at 10. x is held
    to 2e-4 of its largest entry (the test system's rtol). The full
    counts are only reported: on these ill-conditioned systems the
    reordered float32 sums grow with every iteration, and at about 20
    iterations the difference reaches 2e-3 of max|x| on some runs.
    Returns (max abs err over the checked window, max relative err over
    each call's full count)."""
    from rootba_tpu_torch.ops import cg_dense

    worst = worst_rel = worst_full = 0.0
    crossed = 0
    for (Hz, chol, b), kw, iters in calls:
        Lp, b2 = k3_inputs(Hz, chol, b)
        N = b.shape[0]
        base = dict(min_iters=0, q_tol=float("-inf"), r_tol=-1.0,
                    reset_period=kw.get("residual_reset_period", 10))
        for n, full in ((min(iters, 11), False), (iters, True)):
            x_k, st_k = cg_dense._launch(Hz, b2, Lp, N, max_iters=n, **base)
            x_p, st_p = cg_dense.pcg_dense_plain(Hz, b2, Lp, max_iters=n,
                                                 **base)
            err = max_abs(x_k, x_p)
            scale = max(float(x_p.abs().max()), 1e-30)
            if full:
                worst_full = max(worst_full, err / scale)
                continue
            worst = max(worst, err)
            worst_rel = max(worst_rel, err / scale)
            crossed += n > base["reset_period"]
            check(int(st_k[0]) == int(st_p[0]) == n
                  and err <= 2e-4 * scale,
                  f"{tag}: K3 at main-path inputs ({n} iterations): "
                  f"iterations {int(st_k[0])}/{int(st_p[0])}, max abs err "
                  f"{err} (rel {err / scale})")
    check(crossed > 0, f"{tag}: K3 at main-path inputs: no call crossed a "
                       f"reset")
    print(f"[{tag}] K3 at the main path's {len(calls)} calls ({crossed} "
          f"through the reset): max abs err {worst:.3e}, {worst_rel:.3e} "
          f"of max|x|, over min(count, 11) iterations (tol 2e-4 of "
          f"max|x|); over the full counts "
          f"{worst_full:.3e} of max|x| (reported)", flush=True)
    return worst, worst_full


def bound(nbytes: float, flops: float) -> dict:
    """The least time for the work: bytes over the HBM rate or f32
    flops over the f32 peak, whichever is larger."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return dict(bound_ms=1e3 * max(tb, tf),
                bound_by="bytes" if tb >= tf else "operations")


def k3_bound(n_rows: int, lanes: int, iters: int, resets: int) -> dict:
    """K3's bound for `iters` CG iterations on an n_rows-square system
    over `lanes` camera lanes: Hz, b, Lp read once, x and the stats
    written once; a GEMV, the preconditioner and the vector work per
    iteration and one more GEMV per residual reset."""
    flops = (iters * (2 * n_rows * n_rows + 162 * lanes + 14 * n_rows)
             + resets * (2 * n_rows * n_rows + n_rows))
    nbytes = (n_rows * n_rows + 9 * lanes + 81 * lanes + 9 * lanes + 4) * 4
    return bound(nbytes, flops)


def counted_run(bal_path: Path, iters: int, tag: str, extra=(),
                run=None, tries: int = 3) -> tuple:
    """One solve of the main path through the CLI (or run(), a callable
    that solves and returns the ba_log), with the launch counts set to 0
    just before it and read just after, under a profiler trace of the
    card: (its ba_log, {kernel: launches}, {kernel: device ms summed
    over the solve}). Each kernel's launches in the trace must equal its
    wrapper's count. The trace's warm-up step (one small kernel) and
    TRACE_MARGIN_S at the active step's edges keep it from losing the
    solve's first or last launch; a trace that still lost launches (one
    has lost all of a solve's) is taken again with the solve, up to
    `tries` traces, as traced_ms does."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from rootba_tpu_torch.ops import kernels

    by_name = {v: k for k, v in KERNEL_NAMES.items()}
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)
            prof.step()
            time.sleep(TRACE_MARGIN_S)
            kernels.reset_launches()
            log = run() if run is not None else run_cli(bal_path, iters,
                                                        tag, extra)
            launches = dict(kernels.LAUNCHES)
            torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)
            prof.step()
        us = dict.fromkeys(KERNEL_NAMES, 0.0)
        seen = dict.fromkeys(KERNEL_NAMES, 0)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                k = by_name.get(short_name(e.name).split("<")[0])
                if k is not None:
                    us[k] += e.time_range.elapsed_us()
                    seen[k] += 1
        if seen == launches:
            break
        print(f"[phase 6] {tag}: trace {attempt} of {tries} holds the "
              f"launches {seen}, the wrappers counted {launches}",
              flush=True)
    check(seen == launches, f"{tag}: launches in the trace {seen}, by "
                            f"the wrappers' counts {launches}, in each "
                            f"of {tries} traces")
    return log, launches, {k: v / 1e3 for k, v in us.items()}


# runs of K1's plain twin per chunk in k1_held: bounds its [runs, K9,
# K9] product at final-3068's largest calls
HELD_CHUNK_RUNS = 1 << 16


def k1_held(s1, s2, W: int, got, what: str) -> float:
    """K1's result `got` for (s1, s2, W) against fold_plain on the same
    inputs, chunk of runs by chunk: the W'W sums cancel, so each entry
    is held to the sum of its products' magnitudes (W*K terms summed in
    another order: 1e-5 of it in f32, 1e-12 in f64). Returns the max
    abs error."""
    import torch

    from rootba_tpu_torch.ops import fold

    tol = 1e-5 if s1.dtype == torch.float32 else 1e-12
    worst = 0.0
    for r in range(0, got.shape[0], HELD_CHUNK_RUNS):
        a = s1[r * W:(r + HELD_CHUNK_RUNS) * W]
        c = s2[r * W:(r + HELD_CHUNK_RUNS) * W]
        diff = (got[r:r + HELD_CHUNK_RUNS].double()
                - fold.fold_plain(a, c, W).double()).abs()
        scale = fold.fold_plain(a.abs(), c.abs(), W).double()
        err = float(diff.max())
        check(bool((diff <= tol * scale + 1e-30).all()),
              f"K1 {what} (M={s1.shape[0]} K={s1.shape[1] // 9} W={W}): "
              f"max abs err {err}")
        worst = max(worst, err)
    return worst


def k2_held(q, jp, n: int, got, what: str) -> float:
    """K2's result against w_build_plain on the same inputs: products
    and sum rounded separately in both, so equal bits."""
    from rootba_tpu_torch.ops import fold

    err = max_abs(got, fold.w_build_plain(q, jp, n))
    check(err == 0.0, f"K2 {what} (L={q.shape[0]} n={n}): max abs err "
                      f"{err}")
    return err


class TwinCheck:
    """While an untimed solve runs, holds the result of every K1 and K2
    call against the kernel's plain twin on the same inputs (k1_held,
    k2_held) and keeps, per kernel, the calls checked, the largest
    call's shape and the largest error."""

    def __init__(self):
        from rootba_tpu_torch.ops import fold

        self.fold = fold
        self.orig = {k: getattr(fold, k) for k in ("outer81_fold",
                                                   "w_build")}
        self.stats = {k: dict(calls=0, largest="", max_abs_err=0.0)
                      for k in self.orig}
        self._size = dict.fromkeys(self.orig, -1)
        # host seconds of the checks, each from a drained queue
        self.seconds = 0.0

    def _held(self, fn, *args) -> float:
        import torch

        torch.cuda.synchronize()
        t = time.monotonic()
        err = fn(*args)
        self.seconds += time.monotonic() - t
        return err

    def _note(self, name, size, shape, err):
        st = self.stats[name]
        st["calls"] += 1
        st["max_abs_err"] = max(st["max_abs_err"], err)
        if size > self._size[name]:
            self._size[name] = size
            st["largest"] = shape

    def _k1(self, s1, s2, width):
        out = self.orig["outer81_fold"](s1, s2, width)
        self._note("outer81_fold", s1.numel(),
                   f"M={s1.shape[0]} K={s1.shape[1] // 9} W={width}",
                   self._held(k1_held, s1, s2, width, out, str(s1.dtype)))
        return out

    def _k2(self, q, jp, n):
        out = self.orig["w_build"](q, jp, n)
        self._note("w_build", q.numel(), f"L={q.shape[0]} n={n}",
                   self._held(k2_held, q, jp, n, out, str(q.dtype)))
        return out

    def __enter__(self):
        self.fold.outer81_fold = self._k1
        self.fold.w_build = self._k2
        return self

    def __exit__(self, *exc):
        for k, f in self.orig.items():
            setattr(self.fold, k, f)
        return False

    def report(self, tag: str, expect=("outer81_fold", "w_build")) -> str:
        """The checks' summary; fails unless exactly the kernels in
        `expect` were called."""
        for k, st in self.stats.items():
            check((st["calls"] > 0) == (k in expect),
                  f"{tag}: {st['calls']} {k} calls checked, expected "
                  f"{'some' if k in expect else 'none'}")
        return "; ".join(f"{k} {st['calls']} calls, largest "
                         f"{st['largest']}, max abs err "
                         f"{st['max_abs_err']:.3e}"
                         for k, st in self.stats.items()) + (
            f"; {self.seconds:.3f} s of checks")


def k1_times(a, c, W: int, sfx: str = "") -> dict:
    """K1's device time on (a, c, W) beside its bound, its plain twin's
    and torch.bmm's (the batched product without the diagonal-block
    sum), keys suffixed with sfx."""
    import torch

    from rootba_tpu_torch.ops import fold

    M, K9 = a.shape
    R = M // W
    a3 = a.view(R, W * K9 // 9, 9)
    b3 = c.view(R, W * K9 // 9, 9)
    # the operations bound takes the f32 peak in both precisions; bytes
    # bound K1 either way (2.25 flops per f32 byte)
    bnd = bound((2 * M * K9 + R * 81) * a.element_size(),
                2 * M * (K9 // 9) * 81)
    return {**both(f"ms{sfx}", lambda: fold.outer81_fold(a, c, W), 50,
                   expect=KERNEL_NAMES["outer81_fold"]),
            **both(f"plain_ms{sfx}", lambda: fold.fold_plain(a, c, W), 50),
            f"bound_ms{sfx}": bnd["bound_ms"],
            f"bound_by{sfx}": bnd["bound_by"],
            **both(f"library_ms{sfx}",
                   lambda: torch.bmm(a3.transpose(1, 2), b3), 50)}


def k1_row(rec: "Recorder", errs: dict) -> dict:
    """K1 at its largest main-path call, in f32 (the working precision
    of the traced paths) and, as *_f64 keys, in f64 (the default CLI's
    precision) on the same inputs."""
    import torch

    from rootba_tpu_torch.ops import fold

    _, (s1, s2, W), _ = rec.largest["outer81_fold"]
    M, K9 = s1.shape
    row = dict(name="outer81_fold", route="cuda",
               source="rootba_tpu_torch/csrc/fold.cu",
               replaces="rootba_tpu/ops/pallas_fold.py:191",
               shape=f"M={M} K={K9 // 9} W={W} {str(s1.dtype)[6:]}")
    for dt, sfx in ((torch.float32, ""), (torch.float64, "_f64")):
        a, c = s1.to(dt), s2.to(dt)
        err = k1_held(a, c, W, fold.outer81_fold(a, c, W),
                      f"{dt} at main-path inputs")
        row.update({f"max_abs_err{sfx}": (max(err, errs["outer81_fold"])
                                          if not sfx else err),
                    **k1_times(a, c, W, sfx)})
    return row


def k1_w64(rec: "Recorder") -> dict:
    """K1 at the largest call of the obs route's checked final-3068
    attempt (a full chunk of slot rows at run width 64)."""
    from rootba_tpu_torch.ops import fold

    _, (a, c, W), _ = rec.largest["outer81_fold"]
    check(W == 64, f"the obs route's largest K1 call has W = {W}")
    err = k1_held(a, c, W, fold.outer81_fold(a, c, W), "at W = 64")
    return dict(shape=f"M={a.shape[0]} K={a.shape[1] // 9} W={W} "
                      f"{str(a.dtype)[6:]}", max_abs_err=err,
                **k1_times(a, c, W))


def k2_row(rec: "Recorder", errs: dict) -> dict:
    import torch

    from rootba_tpu_torch.ops import fold

    _, (q, jp, n), _ = rec.largest["w_build"]
    S = q.shape[0] * n
    err = k2_held(q, jp, n, fold.w_build(q, jp, n), "at main-path inputs")
    q3 = q.view(S, 2, 3)
    j3 = jp.view(S, 2, 9)
    return dict(
        name="w_build", route="cuda",
        source="rootba_tpu_torch/csrc/w_build.cu",
        replaces="rootba_tpu/ops/pallas_fold.py:95",
        max_abs_err=max(err, errs["w_build"]),
        **both("ms", lambda: fold.w_build(q, jp, n), 50,
               expect=KERNEL_NAMES["w_build"]),
        **both("plain_ms", lambda: fold.w_build_plain(q, jp, n), 50),
        **bound(S * (6 + 18 + 27) * q.element_size(), S * 27 * 3),
        **both("library_ms",
               lambda: torch.einsum("src,sra->sca", q3, j3), 50),
        shape=f"L={q.shape[0]} n={n} {str(q.dtype)[6:]}")


def k3_row(name: str, call: tuple, errs: dict, path_errs: tuple,
           compare_grid: bool) -> dict:
    """A K3 kernel at a main-path call (the real Hz, chol, b of the call
    with the most CG iterations): device time, time per CG iteration,
    the bound on the real 9N system that every K3 kernel works on (and,
    beside it, on the padded 9 Nc one), the twin; with compare_grid,
    the grid kernel on the same call."""
    from rootba_tpu_torch.ops import cg_dense

    _, (Hz, chol, b), kw = call
    Mz = Hz.shape[0]
    Nc = Mz // 9
    N = b.shape[0]
    plan = cg_dense.k3_plan(N, Nc, cg_dense.card_sms(Hz.device))
    check(f"pcg_dense_{plan.kernel}" == name,
          f"{name}: the call (N={N}) plans the {plan.kernel} kernel")
    Lp, b2 = k3_inputs(Hz, chol, b)
    ckw = dict(min_iters=kw["min_num_iterations"],
               max_iters=kw["max_num_iterations"],
               q_tol=kw["q_tolerance"], r_tol=kw["r_tolerance"],
               reset_period=10)
    iters = int(cg_dense._launch(Hz, b2, Lp, N, **ckw)[1][0])
    resets = iters // 10
    row = dict(
        name=name, route="cuda",
        source="rootba_tpu_torch/csrc/cg_dense.cu",
        replaces="rootba_tpu/ops/pallas_cg.py:169",
        max_abs_err=max(path_errs[0], errs[name]),
        max_rel_err_main_path_full_count=path_errs[1],
        **both("ms", lambda: cg_dense._launch(Hz, b2, Lp, N, **ckw), 20,
               expect=KERNEL_NAMES[name]),
        **both("plain_ms", lambda: cg_dense.pcg_dense_plain(Hz, b2, Lp,
                                                            **ckw), 5, 1),
        **k3_bound(9 * N, N, iters, resets),
        library_ms=None,
        cluster=plan.cluster, rows_per_cta=plan.rows_per_cta,
        smem_bytes=plan.smem_bytes,
        shape=f"M={Mz} N={N} cg_iters={iters}")
    row["us_per_cg_iter"] = 1e3 * row["ms"] / iters
    row["bound_ms_real"] = row["bound_ms"]
    padded = k3_bound(Mz, Nc, iters, resets)
    row["bound_ms_padded"] = padded["bound_ms"]
    row["bound_by_padded"] = padded["bound_by"]
    if compare_grid:
        row.update(both("grid_ms_same_call",
                        lambda: cg_dense._launch_grid(Hz, b2, Lp, N, **ckw),
                        20, expect=KERNEL_NAMES["pcg_dense_grid"]))
    if plan.kernel == "grid":
        # the plan, and the default route's loop on the same call as a
        # yardstick: no single library call computes the whole loop
        row.update(ctas=plan.ctas, streamed_rows=plan.streamed,
                   stages=plan.stages, stage_rows=plan.stage_rows)
        row["pcg_gemv_cg_iters"] = int(pcg_gemv(Hz, chol, b,
                                                kw).num_iterations)
        row.update(both("pcg_gemv_ms", lambda: pcg_gemv(Hz, chol, b, kw),
                        5, 1))
    return row


def pcg_gemv(Hz, chol, b, kw: dict):
    """The dense route's linear solve without K3 (sqrt_flat's solve with
    pallas_cg off): solver.cg.pcg over the z-space GEMV (torch.mv) with
    the block-Jacobi inverse, on a recorded K3 call's inputs and CG
    options."""
    from rootba_tpu_torch.ops.block9 import chol9_inv, inv9_apply
    from rootba_tpu_torch.solver.cg import pcg
    from rootba_tpu_torch.solver.explicit_sc import sc_matvec_dense

    pinv = chol9_inv(chol)
    return pcg(lambda x: sc_matvec_dense(Hz, x),
               lambda r: inv9_apply(pinv, r), b, **kw)


# ---------------------------------------------------------------------------
# BSR mode: the block-sparse reduced camera system (plain PyTorch; no
# kernel of its own)

def random_pairs(rng, N: int, P: int):
    """P distinct camera pairs (row <= col, sorted), a few self-pairs."""
    import numpy as np

    iu, ju = np.triu_indices(N)
    sel = np.sort(rng.choice(iu.size, P, replace=False))
    return iu[sel].astype(np.int32), ju[sel].astype(np.int32)


def bsr_scale(table, diag, bsr, x):
    """|H| |x| through the packed operator: the sum of the magnitudes of
    each y entry's products, against which a reordered sum is held."""
    from rootba_tpu_torch.solver.linearization import bsr_matvec_packed

    return bsr_matvec_packed(table.abs(), diag.abs(), bsr, x.abs())


def check_bsr(dev) -> None:
    """The BSR table build and both operators on the card against the
    port on the CPU, from the same seeded inputs: the packed table equal
    (data movement), the packed and the half-table matvec to 1e-5 (f32)
    / 1e-12 (f64) of |H| |x|; the larger system runs several chunks."""
    import numpy as np
    import torch

    from rootba_tpu_torch.bal.bucketing import build_bsr_matvec
    from rootba_tpu_torch.solver import linearization as lz

    rng = np.random.default_rng(8)
    for N, P in ((300, 6000), (3068, 300000)):
        pr, pc = random_pairs(rng, N, P)
        host = build_bsr_matvec(pr, pc, N)
        idx = {d: lz.BsrMatvecIndex.from_host(host, d)
               for d in ("cpu", dev)}
        for dtype in (torch.float32, torch.float64):
            tol = 1e-5 if dtype == torch.float32 else 1e-12
            half = torch.as_tensor(rng.normal(size=(P, 81)), dtype=dtype)
            diag = torch.as_tensor(rng.normal(size=(N, 9, 9)), dtype=dtype)
            x = torch.as_tensor(rng.normal(size=(N, 9)), dtype=dtype)
            out = {}
            for d in ("cpu", dev):
                h, g, v = half.to(d), diag.to(d), x.to(d)
                packed = lz.bsr_pack_from_half(h, idx[d])
                out[d] = (packed.cpu(),
                          lz.bsr_matvec_packed(packed, g, idx[d], v).cpu(),
                          lz.bsr_matvec_sym(h, g, idx[d], v).cpu())
            scale = bsr_scale(out["cpu"][0], diag, idx["cpu"], x)
            check(torch.equal(out[dev][0], out["cpu"][0]),
                  f"BSR pack N={N} P={P} {dtype}: card != cpu")
            errs = []
            for k, name in ((1, "packed"), (2, "sym")):
                err = (out[dev][k] - out["cpu"][k]).abs()
                errs.append(float(err.max()))
                check(bool((err <= tol * scale + 1e-30).all()),
                      f"BSR {name} matvec N={N} P={P} {dtype}: max abs err "
                      f"{errs[-1]}")
            print(f"[phase 2] BSR N={N} P={P} {str(dtype)[6:]} (E = "
                  f"{host.blk_idx.size}, W = {idx['cpu'].width}): pack "
                  f"equal, matvec packed / sym max abs err {errs[0]:.3e} / "
                  f"{errs[1]:.3e} (tol {tol:g} of |H||x|)", flush=True)


class RouteSpy:
    """While a solve runs, records the regime of each BSR linear solve
    (the symmetric flag that sqrt_flat passes to bsr_table_matvec; none
    in dense mode). With keep, also the last stage2's half table, packed
    table, diagonal blocks, index and pair list, for the timing phase."""

    def __init__(self, keep: bool = False):
        from rootba_tpu_torch.solver import sqrt_flat

        self.mod = sqrt_flat
        self.keep = keep
        self.regimes = []
        self.system = {}
        self.orig = {k: getattr(sqrt_flat, k) for k in (
            "flat_assemble_rcs_bsr", "bsr_table_matvec")}

    def _assemble(self, lin, stage2, pairs, *a, **kw):
        half, diag = self.orig["flat_assemble_rcs_bsr"](lin, stage2, pairs,
                                                        *a, **kw)
        if self.keep:
            self.system.update(half=half, pr=pairs.pair_row,
                               pc=pairs.pair_col)
        return half, diag

    def _matvec(self, table, diag, bsr, symmetric):
        self.regimes.append(bool(symmetric))
        if self.keep:
            self.system.update(table=table, diag=diag, bsr=bsr)
        return self.orig["bsr_table_matvec"](table, diag, bsr, symmetric)

    def __enter__(self):
        self.mod.flat_assemble_rcs_bsr = self._assemble
        self.mod.bsr_table_matvec = self._matvec
        return self

    def __exit__(self, *exc):
        for k, f in self.orig.items():
            setattr(self.mod, k, f)
        return False


@contextlib.contextmanager
def patched(mod, **values):
    """Module globals set to `values` while the block runs."""
    old = {k: getattr(mod, k) for k in values}
    for k, v in values.items():
        setattr(mod, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(mod, k, v)


class LoopSpy:
    """While a solve runs, records which LM driver ran each solve:
    "host" (solver/lm.optimize_lm) or "fused" (the attempt loop,
    solver/fused_lm.optimize_lm_fused)."""

    def __init__(self):
        from rootba_tpu_torch.solver import fused_lm, lm

        self.loops = []
        self.targets = ((lm, "optimize_lm", "host"),
                        (fused_lm, "optimize_lm_fused", "fused"))
        self.orig = [getattr(m, k) for m, k, _ in self.targets]

    def _spy(self, fn, tag):
        def wrapped(*a, **kw):
            self.loops.append(tag)
            return fn(*a, **kw)
        return wrapped

    def __enter__(self):
        for (m, k, tag), fn in zip(self.targets, self.orig):
            setattr(m, k, self._spy(fn, tag))
        return self

    def __exit__(self, *exc):
        for (m, k, _), fn in zip(self.targets, self.orig):
            setattr(m, k, fn)
        return False


class FactorSpy:
    """While a solve runs, records the kind of the W factors of each
    reduced-camera-system assembly: "fused" (StreamFactors: W rows built
    after each slot gather) or "tables" (W tables built by K2)."""

    def __init__(self):
        from rootba_tpu_torch.solver import sqrt_flat

        self.mod = sqrt_flat
        self.orig = sqrt_flat._rcs_factors
        self.kinds = []

    def _spy(self, *a):
        from rootba_tpu_torch.solver.linearization import StreamFactors

        out = self.orig(*a)
        self.kinds.append("fused" if isinstance(out, StreamFactors)
                          else "tables")
        return out

    def __enter__(self):
        self.mod._rcs_factors = self._spy
        return self

    def __exit__(self, *exc):
        self.mod._rcs_factors = self.orig
        return False


def check_fused_w(dev) -> None:
    """Fused-W rows (K2 at n = 1 on the gathered Q1h and Jp rows,
    solver/linearization._gather_slot_rows) on the card against the same
    on the CPU (K2's plain twin): equal bits, pads included (the
    gather's zero row)."""
    import numpy as np
    import torch

    from rootba_tpu_torch.solver.linearization import (
        _gather_slot_rows,
        _slot_table,
    )

    rng = np.random.default_rng(9)
    L, n = 4000, 6
    for dtype in (torch.float32, torch.float64):
        q = torch.as_tensor(rng.normal(size=(L, n * 6)), dtype=dtype)
        jp = torch.as_tensor(rng.normal(size=(L, n * 18)), dtype=dtype)
        # slot ids, every 97th the fill sentinel L*n
        idx = torch.as_tensor(rng.integers(0, L * n, size=65536))
        idx[::97] = L * n
        rows = {}
        for d in ("cpu", dev):
            tab = _slot_table((q.to(d), jp.to(d)), n)
            rows[d] = _gather_slot_rows(tab, idx.to(d))
        pads = idx == L * n
        check(bool(pads.any()) and not rows[dev][pads.to(dev)].any(),
              f"fused-W rows {dtype}: pad rows not zero")
        err = max_abs(rows[dev].cpu(), rows["cpu"])
        check(err == 0.0, f"fused-W rows {dtype} on the card vs the CPU: "
                          f"max abs err {err}")
        print(f"[phase 2] fused-W rows {str(dtype)[6:]}: {idx.numel()} "
              f"gathered slots ({int(pads.sum())} pads), card equal to "
              f"the CPU", flush=True)


def dense_from_half(half, diag, pr, pc):
    """The dense z-space system Hz[a*N+i, b*N+j] = block(i,j)[a,b] that
    the dense mode would assemble for the same blocks: each pair's block
    at (row, col), its transpose at (col, row), the diagonal blocks."""
    import torch

    from rootba_tpu_torch.solver.linearization import _block_transpose

    N = diag.shape[0]
    d81 = half.new_zeros((N * N, 81))
    d81.index_add_(0, pr * N + pc, half)
    d81.index_add_(0, pc * N + pr, half[:, _block_transpose(half.device)])
    d81.index_add_(0, torch.arange(N, device=half.device) * (N + 1),
                   diag.reshape(N, 81))
    return d81.T.reshape(9, 9, N, N).permute(0, 2, 1, 3).reshape(
        9 * N, 9 * N)


def bsr_library_matrix(half, diag, pr, pc):
    """The same system as a torch sparse BSR tensor of 9x9 blocks (one
    block per camera pair in each direction, the diagonal blocks summed
    with self-pairs): what `torch.mv` hands to the sparse library."""
    import torch

    from rootba_tpu_torch.solver.linearization import _block_transpose

    N = diag.shape[0]
    dev = half.device
    keys = torch.cat([pr * N + pc, pc * N + pr,
                      torch.arange(N, device=dev) * (N + 1)])
    vals = torch.cat([half, half[:, _block_transpose(dev)],
                      diag.reshape(N, 81)])
    uniq, inv = torch.unique(keys, return_inverse=True)
    blocks = vals.new_zeros((uniq.numel(), 81)).index_add_(0, inv, vals)
    crow = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(uniq // N, minlength=N), 0)
    return torch.sparse_bsr_tensor(crow, uniq % N, blocks.view(-1, 9, 9),
                                   size=(9 * N, 9 * N),
                                   check_invariants=False)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bsr_operator_rows(system: dict, smi: str) -> list:
    """One application of each CG operator at the final-3068 system:
    bsr_matvec_packed (the default regime), bsr_matvec_sym (the half
    table) and the dense GEMV (torch.mv on the same system assembled
    densely), each against its byte bound (each input read once, y
    written once), with the sparse library's BSR product beside the
    packed one; the three y held to 1e-5 of |H| |x|."""
    import torch

    from rootba_tpu_torch.solver.explicit_sc import sc_matvec_dense
    from rootba_tpu_torch.solver.linearization import (
        bsr_matvec_packed,
        bsr_matvec_sym,
    )

    half, table, diag, bsr = (system[k] for k in ("half", "table", "diag",
                                                  "bsr"))
    pr, pc = system["pr"], system["pc"]
    N = diag.shape[0]
    g = torch.Generator(device="cpu").manual_seed(9)
    x = torch.randn(N, 9, generator=g, dtype=table.dtype).to(table.device)
    y_pack = bsr_matvec_packed(table, diag, bsr, x)
    scale = bsr_scale(table, diag, bsr, x)

    def held(y, what):
        err = (y - y_pack).abs()
        check(bool((err <= 1e-5 * scale + 1e-30).all()),
              f"final3068 {what}: max abs err {float(err.max())} against "
              f"the packed matvec")
        return float(err.max())

    y_bytes = N * 9 * x.element_size()
    common = dict(route="torch", card=smi, dtype=str(table.dtype)[6:],
                  cameras=N, pairs=half.shape[0], entries=table.shape[0],
                  width=bsr.width)
    rows = []
    xf = x.reshape(-1)
    try:  # a torch build without the sparse BSR product on the card
        A = bsr_library_matrix(half, diag, pr, pc)
        y_lib = torch.mv(A, xf)
    except NotImplementedError as e:
        A = None
        lib_err, lib = None, {"library_ms": None,
                              "library_error": str(e)[:200]}
    if A is not None:
        lib_err = held(y_lib.view(N, 9), "library BSR product")
        lib = both("library_ms", lambda: torch.mv(A, xf), 20)
    A = y_lib = None
    nb = nbytes(table, bsr.col_idx, bsr.idx2, diag, x) + y_bytes
    rows.append(dict(name="bsr_matvec_packed", **common, bytes=nb,
                     **bound(nb, 2 * 81 * (table.shape[0] + N)),
                     **both("ms", lambda: bsr_matvec_packed(
                         table, diag, bsr, x), 20),
                     **lib, library_max_abs_err=lib_err))
    sym_err = held(bsr_matvec_sym(half, diag, bsr, x), "sym matvec")
    nb = nbytes(half, bsr.blk_idx, bsr.col_idx, bsr.idx2, diag, x) + y_bytes
    rows.append(dict(name="bsr_matvec_sym", **common, bytes=nb,
                     max_abs_err=sym_err,
                     **bound(nb, 2 * 81 * (table.shape[0] + N)),
                     **both("ms", lambda: bsr_matvec_sym(
                         half, diag, bsr, x), 20)))
    Hz = dense_from_half(half, diag, pr, pc)
    dense_err = held(sc_matvec_dense(Hz, x), "dense GEMV")
    z = x.T.reshape(-1).contiguous()
    nb = nbytes(Hz, z) + y_bytes
    rows.append(dict(name="dense_gemv", **common, bytes=nb,
                     max_abs_err=dense_err,
                     **bound(nb, 2 * Hz.shape[0] * Hz.shape[1]),
                     **both("ms", lambda: torch.mv(Hz, z), 20)))
    print("[timing] CG operators at the final-3068 system on "
          f"{torch.cuda.get_device_name(0)}: " + "; ".join(
              f"{r['name']}: {r['ms']:.5f} ms (per call "
              f"{r['ms_per_call']:.5f}, bound {r['bound_ms']:.5f}, "
              f"{r['bytes'] / 1e9:.4f} GB)" for r in rows)
          + f"; library BSR product {rows[0]['library_ms']}", flush=True)
    return rows


# ---------------------------------------------------------------------------
# in-process solves of one twin on one host setup


class SharedSetup:
    """One load, one `bucketize` and one build of each host index for the
    in-process solves of one twin: while active, bundle_adjust's
    bucketize returns `bp`, and the pair, camera and BSR index builders of
    bal.bucketing return their first result for the same buckets and
    arguments (the device uploads still run per linearizer; the stream
    route's pair index is built on the card per linearizer,
    solver.pair_stream, so only scripts reach build_pair_stream). The
    twin is loaded as the CLI loads it (bench.py's preprocessing)."""

    BUILDERS = ("build_pair_stream", "build_cam_stream", "build_bsr_matvec",
                "build_pair_csr")

    def __init__(self, path: Path):
        from rootba_tpu_torch.bal.bucketing import bucketize
        from rootba_tpu_torch.bal.problem import load_normalized_bal_problem
        from rootba_tpu_torch.cli.common import parse_bal_app_arguments

        t = time.monotonic()
        self.options = parse_bal_app_arguments("chip smoke", [
            "--input", str(path), "--quiet", *PREPROCESS])[0]
        self.problem = load_normalized_bal_problem(self.options.dataset)
        self.load_s = time.monotonic() - t
        t = time.monotonic()
        self.bp = bucketize(self.problem,
                            pow2_from=self.options.solver.bucket_pow2_from)
        self.bucketize_s = time.monotonic() - t
        self.memo = {}
        self.builds_s = 0.0  # host seconds of the builders' first calls
        self._saved = []

    def _memo(self, name, fn):
        def wrapped(*a, **kw):
            key = (name, tuple(id(x) if hasattr(x, "__len__") else x
                               for x in a), tuple(sorted(kw.items())))
            if key not in self.memo:
                t = time.monotonic()
                self.memo[key] = (fn(*a, **kw), a)  # a keeps the ids live
                self.builds_s += time.monotonic() - t
            return self.memo[key][0]
        return wrapped

    def __enter__(self):
        from rootba_tpu_torch.bal import bucketing
        from rootba_tpu_torch.solver import lm

        bp = self.bp
        self._saved = [(lm, "bucketize", lm.bucketize)] + [
            (bucketing, k, getattr(bucketing, k)) for k in self.BUILDERS]
        lm.bucketize = lambda *a, **kw: bp
        for k in self.BUILDERS:
            setattr(bucketing, k, self._memo(k, getattr(bucketing, k)))
        return self

    def __exit__(self, *exc):
        for mod, k, v in self._saved:
            setattr(mod, k, v)
        return False

    def solver(self, **kw):
        """The CLI's solver options of the twin, with kw (enum options by
        name) on top; verbosity 1, no function tolerance, and float32
        unless kw has use_double (as run_cli; the CLI's own default is
        float64)."""
        import copy

        from rootba_tpu_torch.config.options import (
            PreconditionerType,
            SolverType,
        )

        opts = copy.deepcopy(self.options.solver)
        opts.verbosity_level, opts.function_tolerance = 1, 0.0
        opts.use_double = False
        enums = {"solver_type": SolverType,
                 "preconditioner_type": PreconditionerType}
        for k, v in kw.items():
            setattr(opts, k, enums[k](v) if k in enums else v)
        return opts

    def solve(self, **kw) -> dict:
        """bundle_adjust on the card with solver(**kw); its ba_log."""
        from rootba_tpu_torch.log.ba_log import build_log_dict
        from rootba_tpu_torch.solver.lm import bundle_adjust

        with self:
            return build_log_dict(bundle_adjust(self.problem,
                                                self.solver(**kw),
                                                device="cuda"))

    def linearizer(self, dtype, **kw):
        """A linearizer of the twin on the card and the initial state."""
        from rootba_tpu_torch.solver.lm import (
            create_linearizer,
            initial_state,
        )

        from rootba_tpu_torch.utils.device import resolve_device

        with self:
            lin = create_linearizer(self.bp, self.solver(**kw), dtype,
                                    resolve_device("cuda"))
        st = initial_state(self.bp, dtype, lin.device)
        return lin, st


class MatvecSpy:
    """While a solve runs, records the regime of each BSR CG operator
    that `mod` (solver.explicit_sc or solver.sqrt_flat) builds: the
    symmetric flag passed to bsr_table_matvec (True = half table)."""

    def __init__(self, mod):
        self.mod = mod
        self.orig = mod.bsr_table_matvec
        self.regimes = []

    def _spy(self, table, diag, bsr, symmetric):
        self.regimes.append(bool(symmetric))
        return self.orig(table, diag, bsr, symmetric)

    def __enter__(self):
        self.mod.bsr_table_matvec = self._spy
        return self

    def __exit__(self, *exc):
        self.mod.bsr_table_matvec = self.orig
        return False


def _tensors(x) -> list:
    """The tensors in a stage's output, in a fixed order."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def repeats_bit_for_bit(fn, what: str) -> str:
    """fn() twice: every tensor of the second output equal, bit for bit,
    to the first's (right-hand side, preconditioner factors, tables)."""
    import torch

    first = [t.clone() for t in _tensors(fn())]
    again = _tensors(fn())
    check(len(first) == len(again) > 0, f"{what}: outputs differ in form")
    bad = [i for i, (a, b) in enumerate(zip(first, again))
           if not torch.equal(a, b)]
    n = sum(t.numel() for t in first)
    check(not bad, f"{what}: {len(bad)} of {len(first)} output tensors "
                   f"differ between two runs on the same input (indices "
                   f"{bad[:8]})")
    return f"{len(first)} tensors, {n} values bit-equal"


def determinism_phase(final_setup: "SharedSetup", traf: Path) -> None:
    """Stage1 and stage2 twice on the same input, bit for bit: final-3068
    in SQUARE_ROOT BSR mode (packed table) in f32 and f64 and in SC BSR
    mode (f32), trafalgar-257 in SQUARE_ROOT dense mode (f32), and in the
    routes of segment sums (f64): the einsum layout with
    reduction_alg=0 and SC's scatter assembly."""
    import torch

    traf_setup = SharedSetup(traf)
    cases = (("final-3068 SQUARE_ROOT BSR f32", final_setup, torch.float32,
              {}, "bsr"),
             ("final-3068 SQUARE_ROOT BSR f64", final_setup, torch.float64,
              {}, "bsr"),
             ("final-3068 SC BSR f32", final_setup, torch.float32,
              dict(solver_type="SCHUR_COMPLEMENT"), "bsr"),
             ("trafalgar-257 SQUARE_ROOT dense f32", traf_setup,
              torch.float32, {}, "dense"),
             ("trafalgar-257 SQUARE_ROOT einsum, segment sums, f64",
              traf_setup, torch.float64,
              dict(kernel_layout="einsum", reduction_alg=0), "implicit"),
             ("trafalgar-257 SC scatter f64", traf_setup, torch.float64,
              dict(solver_type="SCHUR_COMPLEMENT", dense_rcs_max_cameras=0),
              "implicit"))
    for what, setup, dtype, kw, mode in cases:
        t = time.monotonic()
        lin, st = setup.linearizer(dtype, use_double=dtype == torch.float64,
                                   **kw)
        explicit = getattr(lin, "explicit_rcs", getattr(lin, "dense_rcs",
                                                        False))
        bsr, sym = getattr(lin, "bsr_rcs", False), getattr(lin, "bsr_sym",
                                                           False)
        check(bsr == (mode == "bsr") and explicit == (mode == "dense")
              and not sym, f"{what}: route (bsr {bsr}, sym {sym})")
        s1 = repeats_bit_for_bit(lambda: lin.stage1(st.cams, st.lm_ps),
                                 f"{what} stage1")
        lins = lin.stage1(st.cams, st.lm_ps)[0]
        lam = torch.full((), 1e-4, dtype=dtype, device=lin.device)
        s2 = repeats_bit_for_bit(lambda: lin.stage2(lins, lam),
                                 f"{what} stage2")
        torch.cuda.synchronize()
        print(f"[phase 9] {what}: stage1 twice: {s1}; stage2 twice: {s2} "
              f"({time.monotonic() - t:.1f} s)", flush=True)
        del lin, st, lins
        torch.cuda.empty_cache()


def path_readout(log: dict, wall: float, peak: int) -> dict:
    """Seconds per LM iteration, prepare (stage2) and linear-solve time
    per iteration, CG counts, costs, wall and peak device memory of a
    solve's ba_log."""
    its = log["iteration_time"][1:]
    n = len(its)
    prep = log["prepare_time"][1:]
    st2 = log["stage2_time"][1:]
    return dict(s_per_iteration=sum(its) / n, iterations=n,
                prepare_s_per_iteration=sum(prep) / n,
                stage2_s_per_iteration=sum(st2) / n,
                linear_solve_s=sum(log["solve_reduced_system_time"][1:]),
                linear_solve_s_per_iteration=sum(
                    log["solve_reduced_system_time"][1:]) / n,
                stage1_s=sum(log["stage1_time"][1:]),
                cg_iterations=log["linear_solver_iterations"][1:],
                costs=log["cost"], accepted=log["step_is_successful"],
                wall_s=wall, peak_mib=peak / 2**20,
                solver_type=log["_static"]["solver"]["solver_type"])


def timed_path(tag: str, fn) -> tuple:
    """(log, readout) of one solve fn() with the peak memory reset and
    the host clock around it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.monotonic()
    log = fn()
    wall = time.monotonic() - t
    summarize_log(log, tag)
    r = path_readout(log, wall, torch.cuda.max_memory_allocated())
    print(f"[{tag}] {r['solver_type']}: {r['s_per_iteration']:.4f} s per "
          f"LM iteration ({r['iterations']}), stage2 "
          f"{r['stage2_s_per_iteration']:.4f} s, prepare "
          f"{r['prepare_s_per_iteration']:.4f} s and linear solve "
          f"{r['linear_solve_s_per_iteration']:.4f} s per iteration, CG "
          f"{r['cg_iterations']}, costs {r['costs']}, accepted "
          f"{r['accepted']}, wall {wall:.3f} s, peak "
          f"{r['peak_mib']:.1f} MiB", flush=True)
    return log, r


def held_logs(what: str, log: dict, ref: dict, tol: float,
              cg: bool = True) -> float:
    """log's costs within rel tol of ref's over ref's iterations, with
    the same accept/reject flags (and CG counts)."""
    k = len(ref["cost"])
    rel = max(abs(x - y) / abs(y) for x, y in zip(log["cost"][:k],
                                                  ref["cost"]))
    check(len(log["cost"]) >= k and rel < tol
          and log["step_is_successful"][:k] == ref["step_is_successful"]
          and (not cg or log["linear_solver_iterations"][:k]
               == ref["linear_solver_iterations"]),
          f"{what}: costs {log['cost'][:k]}, accepted "
          f"{log['step_is_successful'][:k]}, CG "
          f"{log['linear_solver_iterations'][:k]} against {ref['cost']}, "
          f"{ref['step_is_successful']}, {ref['linear_solver_iterations']}"
          f": rel {rel} (tol {tol:g})")
    return rel


def sc_poba_phase(lady: Path, traf: Path, final: Path,
                  final_setup: "SharedSetup", errs: dict) -> tuple:
    """Phases 10 (SCHUR_COMPLEMENT) and 11 (PoBA): the new solvers on the
    ladybug-49, trafalgar-257 (SC also on the obs pair gather, held to
    the default stream) and final-3068 twins. Returns ({path:
    readout}, {solver and precision: TwinCheck stats} of the final-3068
    checks); the f32 check's K1 error goes into errs."""
    import torch

    from rootba_tpu_torch.ops import kernels
    from rootba_tpu_torch.solver import explicit_sc

    SCT, PBT = "SCHUR_COMPLEMENT", "POWER_SCHUR_COMPLEMENT"
    out = {}
    checked = {}

    def only_k1(tag, n):
        for k in n:
            check((n[k] > 0) == (k == "outer81_fold"),
                  f"{tag}: kernel {k} launched {n[k]} times {n}")

    # phase 10: bal_sc, dense RCS, through the CLI; at trafalgar-257 on
    # the default stream and on the obs pair gather, held to each other
    logs = {}
    for tag, bal, iters, flags in (("sc_ladybug", lady, 20, ()),
                                   ("sc_trafalgar", traf, 5, ()),
                                   ("sc_obs_trafalgar", traf, 5, OBS)):
        kernels.reset_launches()
        logs[tag], out[tag] = timed_path(f"phase 10 {tag}", lambda: run_cli(
            bal, iters, tag, flags, solver=SCT))
        only_k1(tag, dict(kernels.LAUNCHES))
    rel = held_logs("sc trafalgar f32 obs vs stream",
                    logs["sc_obs_trafalgar"], logs["sc_trafalgar"], 1e-4,
                    cg=False)
    out["sc_obs_trafalgar"]["rel_to_stream"] = rel
    print(f"[phase 10] trafalgar-257 SC f32: obs vs stream costs within rel "
          f"{rel:.2e} (tol 1e-4)", flush=True)
    # final-3068: BSR with the packed table, 3 timed f32 iterations
    with MatvecSpy(explicit_sc) as spy:
        kernels.reset_launches()
        fl, out["sc_final3068"] = timed_path(
            "phase 10 sc_final3068", lambda: run_cli(final, 3,
                                                     "sc_final3068",
                                                     solver=SCT))
    only_k1("sc_final3068", dict(kernels.LAUNCHES))
    check(spy.regimes and set(spy.regimes) == {False},
          f"sc_final3068: BSR operators by regime {spy.regimes}")
    # one untimed f32 iteration in process, every K1 call held against
    # its twin at this path's shapes
    with TwinCheck() as tw:
        final_setup.solve(solver_type=SCT, max_num_iterations=1)
    print(f"[phase 10] final-3068 SC f32, 1 untimed LM iteration with every "
          f"K1 call held against its twin: "
          f"{tw.report('final3068 SC f32', expect=('outer81_fold',))}",
          flush=True)
    checked["sc_float32"] = tw.stats
    # f64, 2 iterations: the packed table against the half table
    f64 = {}
    for mode, extra, sym in (("packed", {}, False),
                             ("half", dict(bsr_pack_max_gb=0.0), True)):
        with MatvecSpy(explicit_sc) as spy:
            f64[mode], out[f"sc_final3068_f64_{mode}"] = timed_path(
                f"phase 10 sc_final3068_f64_{mode}",
                lambda: final_setup.solve(solver_type=SCT, use_double=True,
                                          max_num_iterations=2, **extra))
        check(spy.regimes and set(spy.regimes) == {sym},
              f"sc final3068 f64 {mode}: regimes {spy.regimes}")
    rel = held_logs("sc final3068 f64 packed vs half", f64["packed"],
                    f64["half"], 1e-8)
    print(f"[phase 10] final-3068 SC f64: packed vs half table identical "
          f"accept/reject and CG counts, costs within rel {rel:.2e} (tol "
          f"1e-8)", flush=True)
    rel = held_logs("sc final3068 f32 vs f64", fl, f64["packed"], 2e-3,
                    cg=False)
    print(f"[phase 10] final-3068 SC f32 vs f64 over 2 iterations: costs "
          f"within rel {rel:.2e} (tol 2e-3)", flush=True)

    # phase 11: bal_power_sc on ladybug, dense E0, f32 and f64
    for use_double in (False, True):
        tag = f"poba_ladybug{'_f64' if use_double else ''}"
        kernels.reset_launches()
        _, out[tag] = timed_path(f"phase 11 {tag}", lambda: run_cli(
            lady, 10, tag, use_double=use_double, solver=PBT))
        only_k1(tag, dict(kernels.LAUNCHES))
    # final-3068: BSR E0, 2 f64 iterations timed, then once more with
    # every K1 call held against its twin (the same run)
    with MatvecSpy(explicit_sc) as spy:
        kernels.reset_launches()
        pl, out["poba_final3068_f64"] = timed_path(
            "phase 11 poba_final3068_f64", lambda: final_setup.solve(
                solver_type=PBT, use_double=True, max_num_iterations=2))
    only_k1("poba_final3068_f64", dict(kernels.LAUNCHES))
    check(spy.regimes and set(spy.regimes) == {False},
          f"poba final3068: E0 operators by regime {spy.regimes}")
    with TwinCheck() as tw:
        pc = final_setup.solve(solver_type=PBT, use_double=True,
                               max_num_iterations=2)
    rel = held_logs("poba final3068 f64 checked vs timed", pc, pl, 1e-8)
    print(f"[phase 11] final-3068 PoBA f64 (BSR E0, packed), 2 LM "
          f"iterations once more with every K1 call held against its twin "
          f"(the timed run's flags and term counts, costs within rel "
          f"{rel:.2e}): "
          f"{tw.report('final3068 PoBA f64', expect=('outer81_fold',))}",
          flush=True)
    checked["poba_float64"] = tw.stats
    errs["outer81_fold"] = max(
        errs["outer81_fold"],
        checked["sc_float32"]["outer81_fold"]["max_abs_err"])
    torch.cuda.empty_cache()
    return out, checked


# ---------------------------------------------------------------------------
# phase 15: the obs pair gather against the default stream

OBS = ("--pair-gather", "obs")


def final_state(problem) -> dict:
    """Copies of a solved problem's cameras and landmarks (bundle_adjust
    writes them in place)."""
    import numpy as np

    return {k: np.array(getattr(problem, k))
            for k in ("cam_q", "cam_t", "cam_intr", "lm_p")}


def held_states(what: str, got: dict, ref: dict, tol: float) -> float:
    """Each array of `got` within tol of its `ref` array's largest
    magnitude; returns the largest such relative difference."""
    import numpy as np

    rel = max(float(np.abs(got[k] - ref[k]).max())
              / max(float(np.abs(ref[k]).max()), 1e-300) for k in ref)
    check(rel < tol, f"{what}: final states differ by rel {rel} (tol "
                     f"{tol:g})")
    return rel


def gathers_phase(final: Path, final_setup: "SharedSetup",
                  errs: dict) -> tuple:
    """Phase 15: the "obs" pair gather against the default "stream" at
    final-3068 (BSR, packed table, one load and bucketize). Checks: the
    stream in process and obs through the CLI (3 f32 LM iterations each),
    both in process in f64 (2); obs's f64 run held to the stream's at rel
    1e-8 (costs, flags, CG counts, final state), its f32 run within 1e-4
    of the stream's f32 costs and 2e-3 of its f64 costs; every K1/K2
    call of one obs f32 attempt held against its twin. Timing: after
    those runs (each route's first use), four f32 solves in process, 3
    LM iterations each, in the order stream, obs, obs, stream; a route's
    warm seconds per LM iteration are the mean of its two. Returns
    ({path: readout}, {run: TwinCheck stats}, the recorder of the
    checked obs attempt)."""
    from rootba_tpu_torch.ops import kernels

    sqrt_k = ("outer81_fold", "w_build")
    out, checked = {}, {}

    def launched(tag, kern):
        n = dict(kernels.LAUNCHES)
        for k in n:
            check((n[k] > 0) == (k in kern),
                  f"{tag}: kernel {k} launched {n[k]} times {n}")
        return n

    # final-3068: each route's f32 and f64 runs
    logs32, logs64, states64 = {}, {}, {}
    for name, flags in (("stream", None), ("obs", OBS)):
        kw = {} if flags is None else dict(pair_gather=flags[1])
        tag = f"{name}_final3068"
        built = final_setup.builds_s
        kernels.reset_launches()
        with RouteSpy() as spy:
            if flags is None:
                logs32[name], r = timed_path(
                    f"phase 15 {tag}", lambda: final_setup.solve(
                        max_num_iterations=3))
            else:
                # through the CLI, on the shared load's buckets and index
                # builds (the CLI still reads the text)
                with final_setup:
                    logs32[name], r = timed_path(
                        f"phase 15 {tag}", lambda: run_cli(
                            final, 3, f"{tag}_f32", flags))
        r["launches"] = launched(tag, sqrt_k)
        r["host_index_builds_s"] = final_setup.builds_s - built
        check(spy.regimes and set(spy.regimes) == {False},
              f"{tag}: linear solves by regime {spy.regimes}: not BSR "
              f"packed")
        out[tag] = r
        kernels.reset_launches()
        logs64[name], out[f"{tag}_f64"] = timed_path(
            f"phase 15 {tag}_f64", lambda: final_setup.solve(
                use_double=True, max_num_iterations=2, **kw))
        launched(f"{tag}_f64", sqrt_k)
        states64[name] = final_state(final_setup.problem)
        print(f"[phase 15] {tag}: host index builds "
              f"{r['host_index_builds_s']:.3f} s (first use)", flush=True)
    tag = "obs_final3068"
    rel = held_logs(f"{tag} f64 vs stream", logs64["obs"],
                    logs64["stream"], 1e-8)
    srel = held_states(f"{tag} f64 vs stream", states64["obs"],
                       states64["stream"], 1e-8)
    rel32 = held_logs(f"{tag} f32 vs stream f32", logs32["obs"],
                      logs32["stream"], 1e-4, cg=False)
    rel64 = held_logs(f"{tag} f32 vs stream f64", logs32["obs"],
                      logs64["stream"], 2e-3, cg=False)
    out[tag].update(rel_to_stream_f32=rel32, rel_to_stream_f64=rel64)
    out[f"{tag}_f64"].update(rel_to_stream=rel, state_rel=srel)
    print(f"[phase 15] final-3068 obs vs stream: f64 flags and CG counts "
          f"equal, costs within rel {rel:.2e}, final state {srel:.2e} "
          f"(tol 1e-8); f32 costs within {rel32:.2e} of the stream's f32 "
          f"(tol 1e-4) and {rel64:.2e} of its f64 (tol 2e-3)", flush=True)
    # the warm timing: both routes the same way, each first and last once
    warm = {"stream": [], "obs": []}
    for name in ("stream", "obs", "obs", "stream"):
        tag = f"{name}_final3068"
        kw = {} if name == "stream" else dict(pair_gather=name)
        lg, r = timed_path(f"phase 15 {tag}_warm{len(warm[name])}",
                           lambda: final_setup.solve(max_num_iterations=3,
                                                     **kw))
        held_logs(f"{tag} warm f32 vs its first f32", lg, logs32[name],
                  1e-4, cg=False)
        warm[name].append(r["s_per_iteration"])
    for name, ts in warm.items():
        out[f"{name}_final3068"].update(warm_s_per_iteration=ts,
                                        warm_mean_s_per_iteration=sum(ts)
                                        / len(ts))
    print(f"[phase 15] final-3068 f32 warm, in process, 3 LM iterations "
          f"each in the order stream, obs, obs, stream: s per LM iteration "
          f"stream {out['stream_final3068']['warm_mean_s_per_iteration']:.4f}"
          f" {warm['stream']}, obs "
          f"{out['obs_final3068']['warm_mean_s_per_iteration']:.4f} "
          f"{warm['obs']}", flush=True)
    # every K1/K2 call of one obs f32 attempt against its twin; the
    # largest K1 call's inputs kept for the W = 64 timing
    with TwinCheck() as tw, Recorder() as rec:
        final_setup.solve(pair_gather="obs", max_num_iterations=1)
    print(f"[phase 15] final-3068 obs f32, 1 untimed LM iteration with "
          f"every kernel call held against its twin: "
          f"{tw.report('final3068 obs f32')}", flush=True)
    checked["obs_final3068_f32"] = tw.stats
    rec.k3_calls.clear()
    for k in sqrt_k:
        errs[k] = max(errs[k], tw.stats[k]["max_abs_err"])
    return out, checked, rec


def final4585_phase() -> dict:
    """Phase 8: the final-4585 twin (9.1M observations, above
    fused_obs_threshold) through bundle_adjust's main path and the routes
    it selects, on one load, bucketize and index build (SharedSetup, the
    CLI's own loader and preprocessing), each run with the launch counts
    set to 0 just before it and read just after. Returns, for the kernel
    table, the launch counts and attempts of 8a and 8c, and the twin
    checks (TwinCheck.stats) of 8a (float64) and of 8c's untimed solve
    (float32)."""
    import torch

    from rootba_tpu_torch.ops import kernels
    from rootba_tpu_torch.solver import sqrt_flat

    t = time.monotonic()
    big = write_twin("final4585", npz=True)
    print(f"[phase 8] final-4585 twin written ({big.stat().st_size / 1e6:.1f}"
          f" MB npz) in {time.monotonic() - t:.1f} s", flush=True)
    counts = {}

    def route(tag, log, loops, spy, factors, n, loop, sym, kind, k2):
        attempts = len(log["iteration_time"]) - 1
        check(loops.loops == [loop], f"{tag}: LM loops {loops.loops}")
        check(len(spy.regimes) == attempts and set(spy.regimes) == {sym},
              f"{tag}: linear solves by regime (True = half table) "
              f"{spy.regimes}, {attempts} attempts")
        check(len(factors.kinds) == attempts
              and set(factors.kinds) == {kind},
              f"{tag}: W factors {factors.kinds}")
        for k in n:
            want = k == "outer81_fold" or (k == "w_build" and k2)
            check((n[k] > 0) == want, f"{tag}: kernel {k} launched "
                                      f"{n[k]} times {n}")
        return attempts

    def held(what, log, ref, tol, cg=True) -> float:
        """log's costs within rel tol of ref's over the iterations both
        ran (at least one), with the same accept/reject flags (and CG
        counts)."""
        k = min(len(log["cost"]), len(ref["cost"]))
        rel = max(abs(x - y) / abs(y) for x, y in zip(log["cost"][:k],
                                                      ref["cost"][:k]))
        check(k >= 2 and rel < tol
              and log["step_is_successful"][:k]
              == ref["step_is_successful"][:k]
              and (not cg or log["linear_solver_iterations"][:k]
                   == ref["linear_solver_iterations"][:k]),
              f"final4585: {what}: costs {log['cost'][:k]}, accepted "
              f"{log['step_is_successful'][:k]}, CG "
              f"{log['linear_solver_iterations'][:k]} against "
              f"{ref['cost'][:k]}, {ref['step_is_successful'][:k]}, "
              f"{ref['linear_solver_iterations'][:k]}: rel {rel} (tol "
              f"{tol:g})")
        return rel

    def readout(tag, log, wall, peak, wall_of="CLI"):
        s = summarize_log(log, tag)
        per_it = sum(s["iteration_s"]) / len(s["iteration_s"])
        return (f"{per_it:.4f} s per LM iteration (iteration times "
                f"{[round(x, 4) for x in s['iteration_s']]}), {wall_of} "
                f"wall {wall:.3f} s, minimizer {s['minimizer_s']:.3f} s, "
                f"costs {log['cost']}, accepted "
                f"{log['step_is_successful']}, CG iterations "
                f"{s['cg_iters']}, stage seconds "
                f"{s['stage_s']}, peak device memory "
                f"{peak / 2**20:.1f} MiB")

    # every run shares one load, one bucketize and one build of each host
    # index (SharedSetup): the host setup split by step
    shared = SharedSetup(big)
    print(f"[phase 8] final-4585 twin loaded and preprocessed in "
          f"{shared.load_s:.3f} s, bucketized in {shared.bucketize_s:.3f} s",
          flush=True)

    # 8a: float64, default options, 2 LM iterations through
    # bundle_adjust: the host LM driver, the half table and the fused-W
    # factors, whose W rows K2 builds after each slot gather; every K1
    # and K2 call held against its twin
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t = time.monotonic()
    with LoopSpy() as loops, RouteSpy() as spy, FactorSpy() as factors, \
            TwinCheck() as tw:
        la = shared.solve(use_double=True, max_num_iterations=2)
    wall = time.monotonic() - t
    n = dict(kernels.LAUNCHES)
    peak_a = torch.cuda.max_memory_allocated()
    attempts = route("final4585 f64", la, loops, spy, factors, n, "host",
                     True, "fused", True)
    counts["final4585_f64"] = (n, attempts)
    print(f"[phase 8a] final-4585 twin f64, default options (host LM "
          f"driver, BSR half table, fused-W), 2 LM iterations with every "
          f"K1 and K2 call held against its twin (the times include the "
          f"checks; the host index builds {shared.builds_s:.3f} s): "
          f"{readout('final4585_f64', la, wall, peak_a, 'bundle_adjust')},"
          f" launches {n}; {tw.report('final4585 f64')}", flush=True)

    # 8b: the same problem in float64, 1 LM iteration, through the
    # routes that the final-3068 phases check: the attempt loop, the
    # packed table and W tables by K2
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t = time.monotonic()
    with patched(sqrt_flat, _FUSED_W_MIN_BYTES=1 << 62), LoopSpy() as loops, \
            RouteSpy() as spy, FactorSpy() as factors:
        lb = shared.solve(use_double=True, max_num_iterations=1,
                          lm_loop="fused", bsr_pack_max_gb=64.0)
    wall = time.monotonic() - t
    n = dict(kernels.LAUNCHES)
    peak_b = torch.cuda.max_memory_allocated()
    route("final4585 f64 packed", lb, loops, spy, factors, n, "fused",
          False, "tables", True)
    rb = readout("final4585_f64_packed", lb, wall, peak_b, "bundle_adjust")
    print(f"[phase 8b] final-4585 twin f64, attempt loop, BSR packed "
          f"table, W tables (K2), 1 LM iteration: {rb}, launches {n}",
          flush=True)
    rel = held("f64 packed route vs the default route", lb, la, 1e-8)
    print(f"[phase 8b] default route vs packed route: identical "
          f"accept/reject and CG counts, costs within rel {rel:.2e} (tol "
          f"1e-8); peak device memory {peak_a / 2**20:.1f} MiB (half "
          f"table, fused-W, twin checks) vs {peak_b / 2**20:.1f} MiB "
          f"(packed, W tables)", flush=True)

    # 8d: 8a's route once more, 1 LM iteration, without the twin
    # checks, so that its times and peak are the route's own
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t = time.monotonic()
    with LoopSpy() as loops, RouteSpy() as spy, FactorSpy() as factors:
        ld = shared.solve(use_double=True, max_num_iterations=1)
    wall = time.monotonic() - t
    n = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    route("final4585 f64 timed", ld, loops, spy, factors, n, "host", True,
          "fused", True)
    rel = held("f64 unchecked vs checked", ld, la, 1e-8)
    rd = readout("final4585_f64_timed", ld, wall, peak, "bundle_adjust")
    print(f"[phase 8d] final-4585 twin f64, default options in process, "
          f"no twin checks, 1 LM iteration: {rd}, launches {n}; against "
          f"8a: identical accept/reject and CG counts, costs within rel "
          f"{rel:.2e} (tol 1e-8)", flush=True)

    # 8c, first untimed: float32, default options, 1 LM iteration in
    # process with every K1 and K2 call held against its twin at this
    # route's shapes (the host LM driver, the packed table, W tables)
    kernels.reset_launches()
    t = time.monotonic()
    with LoopSpy() as loops, RouteSpy() as spy, FactorSpy() as factors, \
            TwinCheck() as tw32:
        le = shared.solve(use_double=False, max_num_iterations=1)
    wall = time.monotonic() - t
    route("final4585 f32 checked", le, loops, spy, factors,
          dict(kernels.LAUNCHES), "host", False, "tables", True)
    print(f"[phase 8c] final-4585 twin f32, default options in process, 1 "
          f"untimed LM iteration with every K1 and K2 call held against "
          f"its twin ({wall:.3f} s): {tw32.report('final4585 f32')}",
          flush=True)

    # 8c: float32, default options, 2 LM iterations, timed, in process
    # on the shared setup: the host LM driver, the packed table and W
    # tables, so K1 and K2
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t = time.monotonic()
    with LoopSpy() as loops, RouteSpy() as spy, FactorSpy() as factors:
        lc = shared.solve(use_double=False, max_num_iterations=2)
    wall = time.monotonic() - t
    n = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    attempts = route("final4585 f32", lc, loops, spy, factors, n, "host",
                     False, "tables", True)
    counts["final4585"] = (n, attempts)
    print(f"[phase 8c] final-4585 twin f32, default options in process "
          f"(host LM driver, BSR packed table, W tables), 2 LM iterations: "
          f"{readout('final4585_f32', lc, wall, peak, 'bundle_adjust')}, "
          f"launches {n}", flush=True)
    shared = None
    rel = held("f32 vs f64", lc, la, 2e-3, cg=False)
    print(f"[phase 8c] f32 vs f64 (8a) over {len(la['cost']) - 1} "
          f"iterations: identical accept/reject, costs within rel "
          f"{rel:.2e} (tol 2e-3)", flush=True)
    return counts, {"float64": tw.stats, "float32": tw32.stats}


# ---------------------------------------------------------------------------
# phases 12-14: checkpoint/resume, the CERES baselines, the host formats

# LM iterations of the straight checkpoint runs, and the iteration whose
# checkpoint the resumed runs start from
CKPT_ITERS = {"final3068": (3, 2), "ladybug": (10, 5)}


def same_trajectory(what: str, got: dict, want: dict) -> None:
    """Two ba_logs with the same costs, trust-region radii, flags and CG
    counts, bit for bit."""
    for key in ("cost", "trust_region_radius", "step_is_successful",
                "linear_solver_iterations"):
        check(got[key] == want[key], f"{what}: {key} {got[key]} against "
                                     f"the straight run's {want[key]}")


def checkpoint_phase(final: Path, lady_setup: "SharedSetup") -> dict:
    """Phase 12: a solve resumed from a checkpoint equals the straight
    solve bit for bit. final-3068 f32 through the CLI with the host LM
    driver (BSR packed): a straight run, run A writing a checkpoint
    after every iteration up to the split, run B resumed from A's file;
    then the same in process on the ladybug-49 twin (dense RCS, the
    cluster K3). B's launch counts show K1 and K2 (and K3 at ladybug)."""
    import numpy as np
    import torch

    from rootba_tpu_torch.log.ba_log import build_log_dict
    from rootba_tpu_torch.ops import kernels
    from rootba_tpu_torch.solver import lm
    from rootba_tpu_torch.utils import checkpoint as ck
    from rootba_tpu_torch.utils.device import resolve_device

    wd = WORK / "checkpoint"
    wd.mkdir(parents=True, exist_ok=True)
    out = {}
    writes = []
    real_save = ck.save_checkpoint

    def timed_save(*a, **kw):
        t = time.monotonic()
        real_save(*a, **kw)
        writes.append(time.monotonic() - t)

    def expect_launches(tag, n, kern):
        for k in kern:
            check(n[k] > 0, f"{tag}: kernel {k} launched {n[k]} times {n}")

    # final-3068 through the CLI
    iters, split = CKPT_ITERS["final3068"]
    path = wd / "final3068.npz"
    if path.exists():
        path.unlink()
    host = ("--lm-loop", "host")

    def state_to(tag):
        return ("--save-output", "--output-optimized-path",
                str(wd / f"final3068_{tag}.npz"))

    t = time.monotonic()
    straight = run_cli(final, iters, "ckpt_straight",
                       host + state_to("straight"))
    straight_s = time.monotonic() - t
    with patched(ck, save_checkpoint=timed_save):
        run_cli(final, split, "ckpt_a", host + (
            "--checkpoint-path", str(path), "--checkpoint-interval", "1"))
    check(len(writes) == split + 1, f"final3068 run A: {len(writes)} "
                                    f"checkpoint writes, want {split + 1}")
    kernels.reset_launches()
    resumed = run_cli(final, iters, "ckpt_b", host + (
        "--checkpoint-path", str(path)) + state_to("resumed"))
    n = dict(kernels.LAUNCHES)
    expect_launches("final3068 run B", n, ("outer81_fold", "w_build"))
    same_trajectory("final3068 f32 resumed", resumed, straight)
    with np.load(wd / "final3068_straight.npz") as a, \
            np.load(wd / "final3068_resumed.npz") as b:
        check(sorted(a.files) == sorted(b.files)
              and all(np.array_equal(a[k], b[k]) for k in a.files),
              "final3068 f32 resumed: final state differs from the "
              "straight run's")
    out["final3068"] = dict(
        iterations=iters, split=split, costs=straight["cost"],
        cg_iterations=straight["linear_solver_iterations"][1:],
        run_b_launches=n, checkpoint_bytes=path.stat().st_size,
        write_s=list(writes), straight_cli_wall_s=straight_s)
    print(f"[phase 12] final-3068 twin f32, host LM driver: resumed at "
          f"iteration {split + 1} of {iters}, costs, radii, flags, CG "
          f"counts and final state bit-equal to the straight run "
          f"({straight['cost']}); run B launches {n}; checkpoint "
          f"{path.stat().st_size} bytes, written in "
          f"{[round(w, 4) for w in writes]} s", flush=True)

    # ladybug-49 in process
    iters, split = CKPT_ITERS["ladybug"]
    path = wd / "ladybug.npz"
    if path.exists():
        path.unlink()
    dev = resolve_device("cuda")

    def solve(**kw):
        with lady_setup:
            return lm.optimize_lm(lady_setup.bp, lady_setup.solver(
                use_double=False, lm_loop="host", **kw), device=dev)

    st0, s0 = solve(max_num_iterations=iters)
    writes.clear()
    with patched(ck, save_checkpoint=timed_save):
        solve(max_num_iterations=split, checkpoint_path=str(path),
              checkpoint_interval=1)
    kernels.reset_launches()
    st1, s1 = solve(max_num_iterations=iters, checkpoint_path=str(path))
    n = dict(kernels.LAUNCHES)
    expect_launches("ladybug run B", n,
                    ("outer81_fold", "w_build", "pcg_dense_cluster"))
    same_trajectory("ladybug f32 resumed", build_log_dict(s1),
                    build_log_dict(s0))
    check(all(torch.equal(a, b) for a, b in zip(
        (*st0.cams, *st0.lm_ps), (*st1.cams, *st1.lm_ps))),
        "ladybug f32 resumed: final state differs from the straight run's")
    costs = [i.cost.all.error for i in s0.iterations]
    out["ladybug"] = dict(iterations=iters, split=split, costs=costs,
                          run_b_launches=n,
                          checkpoint_bytes=path.stat().st_size,
                          write_s=list(writes))
    print(f"[phase 12] ladybug-49 twin f32 in process: resumed at "
          f"iteration {split + 1} of {iters} bit-equal to the straight run "
          f"(costs {costs}); run B launches {n}; checkpoint "
          f"{path.stat().st_size} bytes, written in "
          f"{[round(w, 4) for w in writes]} s", flush=True)
    return out


def baselines_phase(lady: Path) -> dict:
    """Phase 13: the CERES baselines on the host against the card, on
    the ladybug-49 twin in f64, 10 LM iterations, eta 1e-5. The numpy
    LM (`bal_ceres --baseline-method lm`): accepted costs within rel
    5e-3 of the port's SQUARE_ROOT host-loop solve on the card
    (tests/test_lm_end2end.py::test_numpy_lm_step_comparable). scipy's
    TRF (`--baseline-method trf`, 10 evaluations): the card's solve
    reaches a cost at most 1.02 times TRF's
    (tests/test_lm_end2end.py::test_against_external_baseline).
    Importing scipy is the check that the machine has it."""
    import scipy

    flags = ("--eta", "1e-5")
    t = time.monotonic()
    card = run_cli(lady, 10, "baseline_card", flags + ("--lm-loop", "host"),
                   use_double=True)
    card_s = time.monotonic() - t
    summarize_log(card, "baseline_card")
    out = {"scipy": scipy.__version__, "card_cli_s": card_s,
           "card_costs": card["cost"]}
    for name, method in (("numpy_lm", "lm"), ("trf", "trf")):
        t = time.monotonic()
        base = run_cli(lady, 10, f"baseline_{name}",
                       flags + ("--baseline-method", method),
                       use_double=True, solver="CERES")
        base_s = time.monotonic() - t
        summarize_log(base, f"baseline_{name}")
        r = dict(host_s=base_s, costs=base["cost"],
                 solver_type=base["_static"]["solver"]["solver_type"])
        if method == "lm":
            c1 = [c for c, ok in zip(card["cost"], card["step_is_successful"])
                  if ok]
            c2 = [c for c, ok in zip(base["cost"], base["step_is_successful"])
                  if ok]
            rel = max(abs(a - b) / max(a, 1.0) for a, b in zip(c1, c2))
            check(len(c2) >= 5 and rel < 5e-3,
                  f"numpy LM accepted costs {c2} against the card's {c1}: "
                  f"rel {rel} (tol 5e-3)")
            r["max_rel"] = rel
            what = f"accepted costs within rel {rel:.2e} of the card's"
        else:
            ratio = card["cost"][-1] / base["cost"][-1]
            check(ratio <= 1.02, f"TRF final cost {base['cost'][-1]}, the "
                                 f"card's {card['cost'][-1]}: ratio {ratio}")
            r["card_over_trf"] = ratio
            what = f"the card's final cost {ratio:.6f} of TRF's"
        out[name] = r
        print(f"[phase 13] {r['solver_type']} on the ladybug-49 twin, f64, "
              f"10 iterations: {base_s:.3f} s on the host (the card's CLI "
              f"solve {card_s:.3f} s), costs {base['cost'][0]:.6f} -> "
              f"{base['cost'][-1]:.6f}; {what}", flush=True)
    return out


def formats_phase(final: Path, lady: Path) -> dict:
    """Phase 14: the host formats. The native tokenizer (built with g++;
    unavailable is a failure) against the Python tokenizer on the
    final-3068 twin's text, equal arrays, both timed; the ladybug-49
    twin through `.cereal` and back, equal arrays, and its CLI solve
    from the `.cereal` file bit-equal to the solve from the text."""
    import numpy as np

    from rootba_tpu_torch.bal import problem as P
    from rootba_tpu_torch.bal import rootba_io
    from rootba_tpu_torch.native import runtime as native

    t = time.monotonic()
    check(native.available(), "the native tokenizer is not available "
                              "(g++ build of native/src failed)")
    build_s = time.monotonic() - t
    t = time.monotonic()
    a = native.tokenize_file(str(final))
    native_s = time.monotonic() - t
    t = time.monotonic()
    b = P.tokenize_numbers_plain(str(final))
    python_s = time.monotonic() - t
    check(a.shape == b.shape and np.array_equal(a, b),
          f"final3068 text: native tokens {a.shape} differ from Python's "
          f"{b.shape}")
    p = P.load_bal(str(lady), quiet=True)
    cer = WORK / "ladybug-twin.cereal"
    rootba_io.save_rootba(p, str(cer))
    q = rootba_io.load_rootba(str(cer), quiet=True)
    check(all(np.array_equal(getattr(p, k), getattr(q, k)) for k in (
        "cam_q", "cam_t", "cam_intr", "lm_p", "obs_lm", "obs_cam",
        "obs_uv")), "ladybug .cereal round trip changed the problem")
    txt_log = run_cli(lady, 5, "formats_txt")
    cer_log = run_cli(cer, 5, "formats_cereal")
    check(txt_log["cost"] == cer_log["cost"],
          f"ladybug from .cereal: costs {cer_log['cost']} against "
          f"{txt_log['cost']} from the text")
    out = dict(tokens=int(a.size), text_bytes=final.stat().st_size,
               native_available_s=build_s, native_s=native_s,
               python_s=python_s, cereal_bytes=cer.stat().st_size,
               costs=txt_log["cost"])
    print(f"[phase 14] final-3068 text ({final.stat().st_size} bytes, "
          f"{a.size} tokens): native tokenizer {native_s:.3f} s, Python "
          f"{python_s:.3f} s, equal arrays (library ready in "
          f"{build_s:.3f} s); ladybug .cereal ({cer.stat().st_size} bytes) "
          f"round trip exact, its 5-iteration f32 solve bit-equal to the "
          f"text's ({txt_log['cost'][-1]!r})", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 16: the einsum layout; phase 17: the landmark mesh

# the routes a mesh takes (the einsum layout, SC's scatter assembly,
# PoBA's implicit E0 sweep), float64; an unsharded run with
# reduction_alg=0 takes the same segment sums
MESH_OPTS = dict(use_double=True, kernel_layout="einsum",
                 dense_rcs_max_cameras=0)
MESH_SOLVERS = ("SQUARE_ROOT", "SCHUR_COMPLEMENT", "POWER_SCHUR_COMPLEMENT")
MESH_WORKER_TIMEOUT_S = 420


def einsum_phase(final: Path, final_setup: "SharedSetup") -> dict:
    """Phase 16: the einsum layout (kernel_layout="einsum") at the
    final-3068 twin. float32, 3 LM iterations through the CLI, timed,
    with the launch counts set to 0 just before and read just after (the
    layout launches none of K1-K3); float64, 2 LM iterations in process,
    held to the flat layout's implicit mode at rel 1e-8 with the same
    flags and CG counts; the float32 costs held to the float64 einsum
    run at 2e-3."""
    import torch

    from rootba_tpu_torch.ops import kernels

    out = {}
    kernels.reset_launches()
    with LoopSpy() as loops:
        lf, out["einsum_final3068_f32"] = timed_path(
            "phase 16", lambda: run_cli(final, 3, "einsum_final3068_f32",
                                        ("--kernel-layout", "einsum")))
    n = dict(kernels.LAUNCHES)
    check(loops.loops == ["fused"] and not any(n.values()),
          f"einsum f32: LM loops {loops.loops}, launches {n}")
    ref = {}
    for tag, kw in (("einsum", dict(kernel_layout="einsum")),
                    ("implicit", dict(sqrt_rcs_mode="implicit"))):
        ref[tag], out[f"{tag}_final3068_f64"] = timed_path(
            "phase 16", lambda kw=kw: final_setup.solve(
                use_double=True, max_num_iterations=2, **kw))
    rel = held_logs("final3068: einsum f64 vs flat implicit f64",
                    ref["einsum"], ref["implicit"], 1e-8)
    rel32 = held_logs("final3068: einsum f32 vs einsum f64", lf,
                      ref["einsum"], 2e-3, cg=False)
    out["einsum_vs_implicit_f64_rel"] = rel
    out["einsum_f32_vs_f64_rel"] = rel32
    print(f"[phase 16] final-3068 einsum f64 vs flat implicit f64: the "
          f"same flags and CG counts, costs within rel {rel:.2e} (tol "
          f"1e-8); einsum f32 (CLI) vs f64: rel {rel32:.2e} (tol 2e-3); "
          f"no kernel launched {n}", flush=True)
    torch.cuda.empty_cache()
    return out


def mesh_solve(setup: "SharedSetup", **kw) -> dict:
    """setup.solve(**kw) with the all-reduce counters set to 0 just
    before: flags, CG counts, costs, the final state, seconds per LM
    iteration and the all-reduces per iteration with their host seconds'
    share of the minimizer time."""
    from rootba_tpu_torch.parallel import mesh

    mesh.reset_stats()
    log = setup.solve(**kw)
    its = len(log["iteration_time"]) - 1
    mini = log["_static"]["solver"]["minimizer_time_in_seconds"]
    return dict(cost=log["cost"], ok=log["step_is_successful"],
                cg=log["linear_solver_iterations"],
                s_per_iteration=sum(log["iteration_time"][1:]) / its,
                all_reduces_per_iteration=mesh.STATS["all_reduces"] / its,
                all_reduce_share=mesh.STATS["all_reduce_s"] / mini,
                state=final_state(setup.problem))


def _mesh_runs(traf: "SharedSetup", world: int, ckpt_dir: Path) -> dict:
    """The trafalgar-257 runs of one world: SQUARE_ROOT, SC and PoBA (3
    LM iterations each) and a host-loop run writing its checkpoint after
    each of 2 iterations."""
    out = {s: mesh_solve(traf, solver_type=s, max_num_iterations=3,
                         **MESH_OPTS) for s in MESH_SOLVERS}
    path = ckpt_dir / f"ckpt_w{world}.npz"
    out["written"] = mesh_solve(traf, lm_loop="host", max_num_iterations=2,
                                checkpoint_interval=1,
                                checkpoint_path=str(path), **MESH_OPTS)
    return out


def _resumed(traf: "SharedSetup", ckpt_dir: Path, world: int) -> dict:
    """Resume the other world's checkpoint to 4 LM iterations."""
    return mesh_solve(traf, lm_loop="host", max_num_iterations=4,
                      checkpoint_path=str(ckpt_dir / f"ckpt_w{3 - world}"
                                                     f".npz"), **MESH_OPTS)


def mesh_worker(rank: int, port: int) -> int:
    """One rank of phase 17's world of 2: gloo (two ranks, one card), on
    cuda:0; its runs go to WORK/mesh/w2_r{rank}.json and .npz."""
    import numpy as np
    import torch.distributed as dist

    from rootba_tpu_torch.parallel.mesh import init_distributed

    wd = WORK / "mesh"
    init_distributed(f"localhost:{port}", 2, rank)
    check(dist.get_backend() == "gloo", f"world 2 on one card: backend "
                                        f"{dist.get_backend()}")
    traf = SharedSetup(wd / "trafalgar.npz")
    out = _mesh_runs(traf, 2, wd)
    out["resumed"] = _resumed(traf, wd, 2)
    out["final3068"] = mesh_solve(SharedSetup(wd / "final3068.npz"),
                                  max_num_iterations=1, **MESH_OPTS)
    dist.destroy_process_group()
    np.savez(wd / f"w2_r{rank}.npz", **{f"{k}.{a}": v for k, r in
                                        out.items()
                                        for a, v in r.pop("state").items()})
    (wd / f"w2_r{rank}.json").write_text(json.dumps(out))
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_phase() -> dict:
    """Phase 17: the landmark mesh (parallel/mesh.py) on the card, f64.
    (a) A world of 1 rank over NCCL in this process: trafalgar-257 with
    SQUARE_ROOT (einsum), SC (scatter) and PoBA (implicit E0), 3 LM
    iterations each, a straight host-loop solve of 4 and one writing its
    checkpoint after each of 2; final-3068 SQUARE_ROOT, 1 LM iteration.
    (b) A world of 2 ranks, two processes on cuda:0 over gloo: the same
    runs, each rank's summaries and final states identical, held to
    world 1 at rel 1e-10 (final-3068 1e-8) with the same flags and CG
    counts; each world resumes the other's checkpoint to 4 iterations,
    held to the straight solve at rel 1e-8. Then world 1's trafalgar
    solves equal the unsharded ones with the same reductions
    (reduction_alg=0) bit for bit: an all-reduce over one rank is the
    identity. The twins are written once as .npz, which both ranks read.
    """
    import numpy as np
    import torch
    import torch.distributed as dist

    from rootba_tpu_torch.parallel.mesh import init_distributed

    wd = WORK / "mesh"
    wd.mkdir(parents=True, exist_ok=True)
    for f in wd.glob("*"):
        f.unlink()
    t = time.monotonic()
    for name in ("trafalgar", "final3068"):
        write_twin(name, npz=True).rename(wd / f"{name}.npz")
    traf = SharedSetup(wd / "trafalgar.npz")
    fin = SharedSetup(wd / "final3068.npz")
    print(f"[phase 17] twins written as .npz and loaded in "
          f"{time.monotonic() - t:.1f} s", flush=True)

    init_distributed(f"localhost:{_free_port()}", 1, 0)
    try:
        check(dist.get_backend() == "nccl", f"world 1 on one card: "
                                            f"backend {dist.get_backend()}")
        w1 = _mesh_runs(traf, 1, wd)
        w1["straight"] = mesh_solve(traf, lm_loop="host",
                                    max_num_iterations=4, **MESH_OPTS)
        w1["final3068"] = mesh_solve(fin, max_num_iterations=1, **MESH_OPTS)
        fin = None
        torch.cuda.empty_cache()
        # (b): the world of 2, this script's own mesh_worker per rank
        port = _free_port()
        t = time.monotonic()
        logs = [open(wd / f"w2_r{r}.log", "w") for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--mesh-worker",
             str(r), str(port)], stdout=logs[r], stderr=subprocess.STDOUT,
            cwd=str(ROOT)) for r in range(2)]
        try:
            rcs = [p.wait(timeout=MESH_WORKER_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        w2_wall = time.monotonic() - t
        for r, rc in enumerate(rcs):
            check(rc == 0, f"mesh world 2 rank {r} exited {rc}: "
                           f"{(wd / f'w2_r{r}.log').read_text()[-3000:]}")
        w1["resumed"] = _resumed(traf, wd, 1)
    finally:
        dist.destroy_process_group()

    w2 = []
    for r in range(2):
        d = json.loads((wd / f"w2_r{r}.json").read_text())
        with np.load(wd / f"w2_r{r}.npz") as z:
            for k in z.files:
                run, a = k.split(".")
                d[run].setdefault("state", {})[a] = z[k]
        w2.append(d)
    out = {"world2_wall_s": w2_wall}
    for run, want in w1.items():
        if run == "straight":
            continue
        a, b = w2[0][run], w2[1][run]
        check(a["cost"] == b["cost"] and a["ok"] == b["ok"]
              and a["cg"] == b["cg"] and all(
                  np.array_equal(a["state"][k], b["state"][k])
                  for k in a["state"]),
              f"mesh {run}: the ranks' summaries differ: {a['cost']} / "
              f"{b['cost']}, CG {a['cg']} / {b['cg']}")
        if run == "resumed":
            # each world's resume of the other's file against world 1's
            # straight solve
            for what, got in (("2 -> 1", want), ("1 -> 2", a)):
                rel = held_logs(f"mesh resume {what}", dict(
                    cost=got["cost"], step_is_successful=got["ok"],
                    linear_solver_iterations=got["cg"]), dict(
                    cost=w1["straight"]["cost"],
                    step_is_successful=w1["straight"]["ok"],
                    linear_solver_iterations=w1["straight"]["cg"]), 1e-8)
                out[f"resume_{what.replace(' -> ', 'to')}_rel"] = rel
                print(f"[phase 17] checkpoint of world {what[0]} resumed "
                      f"in world {what[-1]} to 4 LM iterations: the "
                      f"straight solve's flags and CG counts, costs within "
                      f"rel {rel:.2e} (tol 1e-8)", flush=True)
            continue
        tol = 1e-8 if run == "final3068" else 1e-10
        rel = held_logs(f"mesh {run}: world 2 vs world 1", dict(
            cost=a["cost"], step_is_successful=a["ok"],
            linear_solver_iterations=a["cg"]), dict(
            cost=want["cost"], step_is_successful=want["ok"],
            linear_solver_iterations=want["cg"]), tol)
        srel = held_states(f"mesh {run}: world 2 vs world 1", a["state"],
                           want["state"], tol)
        out[run] = {f"world{w}": {k: r[k] for k in (
            "s_per_iteration", "all_reduces_per_iteration",
            "all_reduce_share", "cg")} for w, r in ((1, want), (2, a))}
        out[run].update(cost_rel=rel, state_rel=srel)
        print(f"[phase 17] {run}: world 2 (gloo, two ranks on cuda:0) vs "
              f"world 1 (NCCL): the same flags and CG counts {a['cg'][1:]},"
              f" costs within rel {rel:.2e}, states within {srel:.2e} (tol "
              f"{tol:g}); s per LM iteration {a['s_per_iteration']:.4f} / "
              f"{want['s_per_iteration']:.4f}; all-reduces per LM "
              f"iteration {a['all_reduces_per_iteration']:.1f} / "
              f"{want['all_reduces_per_iteration']:.1f}, their host share "
              f"of the minimizer {a['all_reduce_share']:.3f} / "
              f"{want['all_reduce_share']:.3f}", flush=True)

    # world 1 against the unsharded solves with the same reductions
    for s in MESH_SOLVERS:
        got = mesh_solve(traf, solver_type=s, max_num_iterations=3,
                         reduction_alg=0, **MESH_OPTS)
        want = w1[s]
        check(got["cost"] == want["cost"] and got["cg"] == want["cg"]
              and all(np.array_equal(got["state"][k], want["state"][k])
                      for k in want["state"]),
              f"mesh {s}: world 1 {want['cost']} and the unsharded solve "
              f"{got['cost']} differ")
    print(f"[phase 17] world 1 (NCCL) equals the unsharded solves of "
          f"{', '.join(MESH_SOLVERS)} with reduction_alg=0 bit for bit "
          f"(costs, CG counts, final states)", flush=True)
    return out


# ---------------------------------------------------------------------------
# the eval phase: the evaluation tools on the card's logs, and the live
# viewer's solve on the card

# experiment -> (the smoke's run directory whose ba_log.json it reads,
# the CLI solve that wrote it: LM iterations, solver type)
EVAL_LOGS = {"sqrt": ("ladybug_timed", 20, None),
             "sc": ("sc_ladybug", 20, "SCHUR_COMPLEMENT"),
             "poba": ("poba_ladybug", 10, "POWER_SCHUR_COMPLEMENT")}
# LM iterations of the live viewer's solve, and the phase's wall budget
EVAL_LIVE_ITERS = 3
EVAL_BUDGET_S = 5.0


def eval_report() -> dict:
    """The batch report (`eval.experiments.load_all`, cache off, and
    `eval.report.generate_report`) over three ladybug-49 logs that the
    card wrote in phases 3, 10 and 11 (SQUARE_ROOT, SC, PoBA): every
    experiment named, each table's final cost that of its log's last
    `cost`."""
    import shutil

    from rootba_tpu_torch.eval.experiments import load_all
    from rootba_tpu_torch.eval.report import generate_report

    wd = WORK / "eval"
    shutil.rmtree(wd, ignore_errors=True)
    spec = [f'[options]\nbase_path = "{wd}"\n']
    last = {}
    for exp, (tag, _, _) in EVAL_LOGS.items():
        src = WORK / tag / "ba_log.json"
        check(src.exists(), f"eval: no log {src} (run phase 3, 10 and 11 "
                            f"first)")
        d = wd / "runs" / exp / "ladybug"
        d.mkdir(parents=True)
        shutil.copy(src, d / "ba_log.json")
        last[exp] = json.loads(src.read_text())["cost"][-1]
        spec.append(f'\n[[experiments]]\nname = "{exp}"\n'
                    f'display_name = "{exp} f32"\n'
                    f'pattern = "runs/{exp}/*"\n')
    (wd / "spec.toml").write_text("".join(spec))
    exps = load_all(str(wd / "spec.toml"), use_cache=False)
    check(list(exps) == list(EVAL_LOGS)
          and all(list(e.runs) == ["ladybug"] for e in exps.values()),
          f"eval: experiments {[(k, list(e.runs)) for k, e in exps.items()]}")
    md = Path(generate_report(exps, str(wd / "report"))).read_text()
    tex = (wd / "report" / "report.tex").read_text()
    lines = md.splitlines()
    head = next(ln for ln in lines if ln.startswith("| sequence |"))
    row = next(ln for ln in lines if ln.startswith("| ladybug |"))
    head = [c.strip() for c in head.strip("|").split("|")]
    row = [c.strip().strip("*") for c in row.strip("|").split("|")]
    tex_row = next(ln for ln in tex.splitlines() if ln.startswith("ladybug"))
    for exp, cost in last.items():
        check(exps[exp].runs["ladybug"].status == "completed",
              f"eval: {exp} run {exps[exp].runs['ladybug'].status}")
        cell = row[head.index(f"{exp} f32: final cost")]
        check(cell == f"{cost:.6f}" and f"{cost:.6f}" in tex_row,
              f"eval: {exp}'s final cost {cell} in the report, {cost} in "
              f"its log")
    skipped = [ln.strip("()") for ln in lines if "skipped" in ln]
    return dict(experiments=list(exps), final_costs=last,
                plots_skipped=skipped)


def eval_live(lady_setup: "SharedSetup") -> dict:
    """The live viewer (`eval.live_view.make_server`) on the ladybug-49
    twin on the card: POST /optimize solves f32 for EVAL_LIVE_ITERS LM
    iterations on the server's thread; /state is polled until done. Its
    final iteration counter, cost and payload points equal, bit for bit,
    a direct `optimize_lm` of the same twin and options on the card in
    this thread; the points are finite and moved; the solve launched K1,
    K2 and the cluster K3 (counts set to 0 just before it)."""
    import base64
    import threading
    import urllib.request

    import numpy as np
    import torch

    from rootba_tpu_torch.eval import live_view
    from rootba_tpu_torch.eval.html_view import viewer_payload
    from rootba_tpu_torch.ops import kernels
    from rootba_tpu_torch.solver import lm
    from rootba_tpu_torch.utils.device import resolve_device

    def options():
        return lady_setup.solver(lm_loop="host", verbosity_level=0,
                                 max_num_iterations=EVAL_LIVE_ITERS)

    problem = lady_setup.problem
    first = viewer_payload(problem)
    srv = live_view.make_server(problem, options(), port=0, device="cuda")
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        req = urllib.request.Request(base + "/optimize", method="POST")
        kernels.reset_launches()
        t = time.monotonic()
        started = json.loads(urllib.request.urlopen(req, timeout=10).read())
        check(started["status"] == "started", f"eval live: {started}")
        deadline = t + 60
        while True:
            d = json.loads(urllib.request.urlopen(
                base + "/state?since=-1", timeout=10).read())
            if d["done"]:
                break
            check(time.monotonic() < deadline,
                  "eval live: the solve did not end in 60 s")
            time.sleep(0.01)
        live_s = time.monotonic() - t
        n = dict(kernels.LAUNCHES)
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(10)
    check(not th.is_alive(), "eval live: the server did not stop")
    check(d["error"] is None, f"eval live: the solve raised {d['error']}")
    for k in n:
        want = k in ("outer81_fold", "w_build", "pcg_dense_cluster")
        check((n[k] > 0) == want, f"eval live: kernel {k} launched {n[k]} "
                                  f"times {n}")
    dev = resolve_device("cuda")
    t = time.monotonic()
    with lady_setup:
        state, s = lm.optimize_lm(lady_setup.bp, options(), device=dev)
    torch.cuda.synchronize()
    direct_s = time.monotonic() - t
    want = live_view._snapshot(problem.copy(), lady_setup.bp, state,
                               400_000)
    cost = s.iterations[-1].cost.all.error
    check(d["it"] == len(s.iterations) == EVAL_LIVE_ITERS + 1,
          f"eval live: final it {d['it']}, the direct solve's "
          f"{len(s.iterations)} iterations")
    check(d["cost"] == cost, f"eval live: final cost {d['cost']!r} against "
                             f"the direct solve's {cost!r}")
    check(d["payload"]["points"] == want["points"]
          and d["payload"]["cam_c"] == want["cam_c"],
          "eval live: the final points differ from the direct solve's")
    pts = np.frombuffer(base64.b64decode(d["payload"]["points"]), "<f4")
    check(bool(np.isfinite(pts).all())
          and d["payload"]["points"] != first["points"],
          "eval live: final points not finite or not moved")
    return dict(iterations=EVAL_LIVE_ITERS, final_it=d["it"],
                initial_cost=s.iterations[0].cost.all.error,
                final_cost=cost, live_s=live_s, direct_s=direct_s,
                launches=n)


def eval_phase(lady_setup: "SharedSetup") -> dict:
    """The eval phase: the batch report over the card's logs and the
    live viewer's solve on the card."""
    t = time.monotonic()
    out = {"report": eval_report()}
    report_s = time.monotonic() - t
    out["live"] = eval_live(lady_setup)
    out["wall_s"] = time.monotonic() - t
    r, lv = out["report"], out["live"]
    print(f"[eval] report over {', '.join(r['experiments'])} (final costs "
          f"{r['final_costs']}) in {report_s:.3f} s; plots: "
          f"{r['plots_skipped'] or 'drawn'}", flush=True)
    print(f"[eval] live viewer on the card, f32, {lv['iterations']} LM "
          f"iterations: final it {lv['final_it']}, cost "
          f"{lv['initial_cost']:.6f} -> {lv['final_cost']!r}, equal bit "
          f"for bit (cost, points) to the direct optimize_lm; launches "
          f"{lv['launches']}; live {lv['live_s']:.3f} s (server, polls, "
          f"snapshots), direct {lv['direct_s']:.3f} s; phase "
          f"{out['wall_s']:.3f} s (budget {EVAL_BUDGET_S:g} s)", flush=True)
    return out


def eval_rehearsal_logs(lady: Path) -> None:
    """The three ladybug-49 solves whose logs the eval phase reads, as
    phases 3, 10 and 11 run them (for `--only eval`)."""
    for tag, iters, solver in EVAL_LOGS.values():
        summarize_log(run_cli(lady, iters, tag, solver=solver), tag)


PHASES = ("kernels", "ladybug", "trafalgar126", "trafalgar", "small",
          "final3068", "determinism", "sc", "gathers", "einsum", "mesh",
          "checkpoint", "baselines", "formats", "eval", "final4585",
          "traced")


def main(argv=None) -> int:
    """The whole smoke, or with `--only P,Q` (names in PHASES) the kernel
    build and the phases named: a partial run prints no result line."""
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None,
                    help=f"comma-separated subset of {', '.join(PHASES)} "
                         f"(eval also runs the three ladybug solves, "
                         f"SQUARE_ROOT, SC and PoBA, whose logs it reads)")
    # phase 17 starts this script once per rank of its world of 2
    ap.add_argument("--mesh-worker", nargs=2, type=int, default=None,
                    metavar=("RANK", "PORT"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    only = None if args.only is None else set(args.only.split(","))
    if only is not None and not only <= set(PHASES):
        ap.error(f"unknown phases {sorted(only - set(PHASES))}")

    def want(phase: str) -> bool:
        return only is None or phase in only

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.mesh_worker is not None:
        return mesh_worker(*args.mesh_worker)
    from rootba_tpu_torch.ops import kernels
    from rootba_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    smi = smi_line()
    print(f"[phase 1] card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)
    WORK.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    last = [t0]
    walls = {}

    def lap(phase: str) -> None:
        now = time.monotonic()
        walls[phase] = now - last[0]
        print(f"[{phase}] phase wall {now - last[0]:.1f} s (run so far "
              f"{now - t0:.1f} s)", flush=True)
        last[0] = now

    kernels.build_all(verbose=True)
    print(f"[phase 1] built {', '.join(kernels.SOURCES)} in "
          f"{time.monotonic() - t0:.1f} s (parallel nvcc)", flush=True)
    lap("phase 1")
    if only is not None:
        return partial_run(only, want, lap, dev)
    return full_run(smi, lap, walls, dev, t0)


def partial_run(only, want, lap, dev) -> int:
    """A rehearsal of the phases in `only` (their checks hold as in the
    whole run); no result line."""
    errs = {"outer81_fold": 0.0, "w_build": 0.0}
    if want("kernels"):
        errs = check_kernels(dev)
        check_bsr(dev)
        check_fused_w(dev)
        lap("phase 2")
    if want("small"):
        small_cross_check()
        lap("phase 5")
    # the twins each phase reads
    need = {"ladybug": ("ladybug", "sc", "checkpoint", "baselines",
                        "formats", "eval"),
            "trafalgar": ("trafalgar", "sc", "determinism"),
            "final3068": ("final3068", "sc", "determinism", "gathers",
                          "einsum", "checkpoint", "formats")}
    lady, traf, final = (write_twin(n) if any(map(want, ps)) else None
                         for n, ps in need.items())
    if any(map(want, ("determinism", "sc", "gathers", "einsum"))):
        final_setup = SharedSetup(final)
        if want("determinism"):
            determinism_phase(final_setup, traf)
            lap("phase 9")
        if want("sc"):
            sc_poba_phase(lady, traf, final, final_setup, errs)
            lap("phases 10-11")
        if want("gathers"):
            gathers_phase(final, final_setup, errs)
            lap("phase 15")
        if want("einsum"):
            einsum_phase(final, final_setup)
            lap("phase 16")
    if want("mesh"):
        mesh_phase()
        lap("phase 17")
    lady_setup = (SharedSetup(lady)
                  if want("checkpoint") or want("eval") else None)
    if want("checkpoint"):
        checkpoint_phase(final, lady_setup)
        lap("phase 12")
    if want("baselines"):
        baselines_phase(lady)
        lap("phase 13")
    if want("formats"):
        formats_phase(final, lady)
        lap("phase 14")
    if want("eval"):
        eval_rehearsal_logs(lady)
        lap("eval logs")
        eval_phase(lady_setup)
        lap("eval")
    if want("final4585"):
        final4585_phase()
        lap("phase 8")
    print(json.dumps({"partial": sorted(only)}))
    return 0


def full_run(smi, lap, walls, dev, t0) -> int:
    import torch

    from rootba_tpu_torch.ops import kernels

    errs = check_kernels(dev)
    check_bsr(dev)
    check_fused_w(dev)
    lap("phase 2")

    # phases 3 and 4 drive each path untraced: a recording solve (which
    # keeps the kernels' main-path inputs for the timing phase) and, for
    # ladybug and trafalgar-257, a solve timed on the host clock. Every
    # profiler trace comes later: a solve that follows a traced one in
    # the same process runs slower on the host (PERF.md).

    # phase 3: ladybug-49 twin, f32, 20 LM iterations
    lady = write_twin("ladybug")
    with Recorder() as rec:
        run_cli(lady, 20, "ladybug_warmup")
    lady_k3 = check_k3_main_path(rec.k3_calls, "phase 3")
    rec.k3_calls.clear()  # ~5 MB of Hz per call, not needed past here
    t = time.monotonic()
    ls = summarize_log(run_cli(lady, 20, "ladybug_timed"), "ladybug")
    lady_s = time.monotonic() - t
    print(f"[phase 3] ladybug-49 twin f32, 20 LM iterations: "
          f"{lady_s:.3f} s per CLI solve (minimizer "
          f"{ls['minimizer_s']:.3f} s), cost {ls['initial_cost']:.6f} -> "
          f"{ls['final_cost']:.6f} (TPU run of the JAX package: "
          f"{LADYBUG_TPU_FINAL_COST}); CG iterations {ls['cg_iters']}; "
          f"stage seconds {ls['stage_s']}", flush=True)

    lap("phase 3")

    # phase 3b: trafalgar-126 twin, f32, 5 LM iterations: below the K3
    # gate but above the full-row kernel's capacity, so the half kernel
    mid = write_twin("trafalgar126")
    with Recorder() as rec_m:
        run_cli(mid, 5, "trafalgar126_record")
    mid_k3 = check_k3_main_path(rec_m.k3_calls, "phase 3b")
    rec_m.k3_calls.clear()
    ms_ = summarize_log(run_cli(mid, 5, "trafalgar126_timed"),
                        "trafalgar126")
    mid_it = sum(ms_["iteration_s"]) / len(ms_["iteration_s"])
    print(f"[phase 3b] trafalgar-126 twin f32, 5 LM iterations: "
          f"{mid_it:.4f} s per LM iteration (iteration times "
          f"{[round(x, 4) for x in ms_['iteration_s']]}), cost "
          f"{ms_['initial_cost']:.6f} -> {ms_['final_cost']:.6f} (the "
          f"parent tree on the card: {TRAFALGAR126_CARD_FINAL_COST}), CG "
          f"iterations {ms_['cg_iters']}, stage seconds {ms_['stage_s']}",
          flush=True)

    lap("phase 3b")

    # phase 4: trafalgar-257 twin, f32, 5 LM iterations; above the K3
    # gate, so CG runs pcg on dense GEMVs
    traf = write_twin("trafalgar")
    with Recorder() as rec_t:  # untimed: keeps main-path inputs
        run_cli(traf, 1, "trafalgar_record")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the kept inputs, not the solve's
    traf_log = run_cli(traf, 5, "trafalgar_timed")
    ts = summarize_log(traf_log, "trafalgar")
    per_it = sum(ts["iteration_s"]) / len(ts["iteration_s"])
    print(f"[phase 4] trafalgar-257 twin f32, 5 LM iterations: "
          f"{per_it:.4f} s per LM iteration (iteration times "
          f"{[round(x, 4) for x in ts['iteration_s']]}), cost "
          f"{ts['initial_cost']:.6f} -> {ts['final_cost']:.6f}, CG "
          f"iterations {ts['cg_iters']}, stage seconds {ts['stage_s']}, "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
          f"({held / 2**20:.1f} MiB of it held by this script before "
          f"the solve)", flush=True)

    lap("phase 4")

    # phase 4b: the trafalgar-257 twin with pallas_cg="on", f32, 3 LM
    # iterations (the third's K3 call crosses the residual reset): K3
    # above the gate (Nc = 384), so the grid kernel
    with Recorder() as rec_on:
        on = summarize_log(run_cli(traf, 3, "trafalgar_on_record", K3_ON),
                           "trafalgar_on")
    on_k3 = check_k3_main_path(rec_on.k3_calls, "phase 4b")
    rec_on.k3_calls.clear()
    print(f"[phase 4b] trafalgar-257 twin f32, pallas_cg on, 3 LM "
          f"iterations: cost {on['initial_cost']:.6f} -> "
          f"{on['final_cost']:.6f}, CG iterations {on['cg_iters']}",
          flush=True)
    # timed beside phase 4's default route (pcg + GEMV) over the same
    # first three LM iterations, and held to its costs
    on_log = run_cli(traf, 3, "trafalgar_on_timed", K3_ON)
    per_lm = {}
    for what, lg in (("pallas_cg on (grid K3)", on_log),
                     ("default route (phase 4)", traf_log)):
        n = len(on_log["iteration_time"]) - 1
        per_lm[what] = (sum(lg["iteration_time"][1:n + 1]) / n,
                        sum(lg["solve_reduced_system_time"][1:n + 1]) / n,
                        lg["linear_solver_iterations"][1:n + 1])
    n = len(on_log["cost"])
    rel = max(abs(x - y) / abs(y) for x, y in zip(on_log["cost"],
                                                  traf_log["cost"][:n]))
    check(on_log["step_is_successful"] == traf_log["step_is_successful"][:n]
          and rel < 1e-4,
          f"trafalgar pallas_cg on: costs {on_log['cost']} (accepted "
          f"{on_log['step_is_successful']}) against the default route's "
          f"{traf_log['cost'][:n]}: rel {rel}")
    print(f"[phase 4b] trafalgar-257 twin f32, first {n - 1} LM iterations, "
          f"s per LM iteration / linear solve per LM iteration / CG "
          f"iterations: " + "; ".join(
              f"{k} {v[0]:.4f} / {v[1]:.5f} / {v[2]}"
              for k, v in per_lm.items())
          + f"; costs within rel {rel:.2e} of the default route's (tol "
          f"1e-4)", flush=True)

    lap("phase 4b")

    small_cross_check()
    lap("phase 5")

    # phase 7: the final-3068 twin, f32, default options, 3 LM
    # iterations: above dense_rcs_max_cameras, so BSR mode with the
    # packed table; host-timed, launch counts set to 0 just before
    final = write_twin("final3068")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    kernels.reset_launches()
    t = time.monotonic()
    with RouteSpy() as spy:
        fl = run_cli(final, 3, "final3068_timed")
    wall = time.monotonic() - t
    n7 = dict(kernels.LAUNCHES)
    peak7 = torch.cuda.max_memory_allocated()
    fs = summarize_log(fl, "final3068")
    attempts7 = len(fl["iteration_time"]) - 1
    check(len(spy.regimes) == attempts7 and set(spy.regimes) == {False},
          f"final3068: linear solves by regime (True = half table) "
          f"{spy.regimes}, {attempts7} attempts: not BSR packed")
    for k in n7:
        want = k in ("outer81_fold", "w_build")
        check((n7[k] > 0) == want, f"final3068: kernel {k} launched "
                                   f"{n7[k]} times {n7}")
    f_it = sum(fs["iteration_s"]) / len(fs["iteration_s"])
    print(f"[phase 7] final-3068 twin f32 (BSR, packed table), 3 LM "
          f"iterations: {f_it:.4f} s per LM iteration (iteration times "
          f"{[round(x, 4) for x in fs['iteration_s']]}), CLI wall "
          f"{wall:.3f} s, minimizer {fs['minimizer_s']:.3f} s, costs "
          f"{fl['cost']}, CG "
          f"iterations per attempt {fs['cg_iters']}, stage seconds "
          f"{fs['stage_s']}, launches {n7}, peak device memory "
          f"{peak7 / 2**20:.1f} MiB ({held / 2**20:.1f} MiB of it held "
          f"by this script before the solve)", flush=True)
    # the twin loaded once for the in-process solves from here on
    # (phases 7-11, 15-16 and 6's final-3068 paths)
    final_setup = SharedSetup(final)
    print(f"[phase 7] final-3068 twin loaded in {final_setup.load_s:.3f} s, "
          f"bucketized in {final_setup.bucketize_s:.3f} s (shared by the "
          f"in-process solves of phases 7-11, 15-16 and 6)", flush=True)
    # K1 and K2 held against their twins at this path's own shapes (pair
    # sub-streams and buckets up to width 1024), in an untimed solve
    with TwinCheck() as tw32:
        final_setup.solve(max_num_iterations=1)
    print(f"[phase 7] final-3068 twin f32, 1 untimed LM iteration in "
          f"process with every kernel call held against its twin: "
          f"{tw32.report('final3068 f32')}", flush=True)
    for k, st in tw32.stats.items():
        errs[k] = max(errs[k], st["max_abs_err"])

    lap("phase 7")

    # phase 7b: the same twin in f64, 2 LM iterations in process on the
    # shared load, in BSR mode with the packed table, with the half table,
    # and in dense mode: the same accept/reject flags and costs to rel
    # 1e-8 between every two; the BSR packed run holds every K1/K2 call
    # against its twin
    f64_modes = {"bsr": ({}, {False}),
                 "bsr_sym": (dict(bsr_pack_max_gb=0.0), {True}),
                 "dense": (dict(dense_rcs_max_cameras=4096), set())}
    f64 = {}
    for mode, (extra, regimes) in f64_modes.items():
        torch.cuda.reset_peak_memory_stats()
        t = time.monotonic()
        with RouteSpy() as spy, (TwinCheck() if mode == "bsr"
                                 else contextlib.nullcontext()) as tw:
            lg = final_setup.solve(use_double=True, max_num_iterations=2,
                                   **extra)
        wall = time.monotonic() - t
        if tw is not None:
            tw64 = tw
            print(f"[phase 7b] final-3068 twin f64 {mode}, every kernel "
                  f"call held against its twin (so its wall is not "
                  f"comparable): {tw.report('final3068 f64')}", flush=True)
        check(set(spy.regimes) == regimes
              and (not regimes or len(spy.regimes)
                   == len(lg["iteration_time"]) - 1),
              f"final3068 f64 {mode}: linear solves by regime "
              f"{spy.regimes}")
        summarize_log(lg, f"final3068_f64_{mode}")
        f64[mode] = lg
        print(f"[phase 7b] final-3068 twin f64 {mode}, 2 LM iterations: "
              f"costs {lg['cost']}, accepted {lg['step_is_successful']}, "
              f"CG iterations {lg['linear_solver_iterations'][1:]}, "
              f"bundle_adjust wall {wall:.3f} s, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB",
              flush=True)
    names = list(f64)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            ca, cb = f64[a]["cost"], f64[b]["cost"]
            rel = max(abs(x - y) / abs(y) for x, y in zip(ca, cb))
            check(f64[a]["step_is_successful"] == f64[b][
                "step_is_successful"] and len(ca) == len(cb) and rel < 1e-8,
                  f"final3068 f64: {a} and {b} differ (accepted "
                  f"{f64[a]['step_is_successful']} / "
                  f"{f64[b]['step_is_successful']}, costs rel {rel})")
            print(f"[phase 7b] {a} vs {b}: identical accept/reject, costs "
                  f"within rel {rel:.2e} (tol 1e-8)", flush=True)
    # phase 7's timed f32 BSR solve over the first 2 iterations against
    # an f32 solve with the implicit operator (no reduced camera system,
    # so none of BSR mode's code) at rel 1e-4 (phase 5's f32 tolerance),
    # and against the f64 BSR solve at rel 2e-3 (the f32 CG-amplified
    # tolerance of tests/test_torch_solve.py): at this twin every f32
    # mode, the implicit one too, sits up to 1.55e-3 from f64 (PERF.md,
    # PR 4 call 4); the same accept/reject flags in each pair
    with RouteSpy() as spy:
        imp = final_setup.solve(max_num_iterations=2,
                                sqrt_rcs_mode="implicit")
    check(not spy.regimes, f"final3068 f32 implicit: BSR linear solves "
                           f"{spy.regimes}")
    summarize_log(imp, "final3068_f32_implicit")
    print(f"[phase 7b] final-3068 twin f32 implicit, 2 LM iterations: "
          f"costs {imp['cost']}, CG iterations "
          f"{imp['linear_solver_iterations'][1:]}", flush=True)
    for what, ref, tol in (("f32 implicit", imp, 1e-4),
                           ("f64 bsr", f64["bsr"], 2e-3)):
        n = len(ref["cost"])
        rel = max(abs(x - y) / abs(y) for x, y in zip(fl["cost"][:n],
                                                      ref["cost"]))
        check(fl["step_is_successful"][:n] == ref["step_is_successful"]
              and len(fl["cost"]) >= n and rel < tol,
              f"final3068: f32 BSR costs {fl['cost'][:n]} (accepted "
              f"{fl['step_is_successful'][:n]}) against {what} "
              f"{ref['cost']} ({ref['step_is_successful']}): rel {rel}")
        print(f"[phase 7b] f32 bsr (phase 7) vs {what} over {n - 1} "
              f"iterations: identical accept/reject, costs within rel "
              f"{rel:.2e} (tol {tol:g})", flush=True)
    f64 = imp = ref = None
    lap("phase 7b")

    # phase 9: stage1 and stage2 repeat bit for bit on the card
    determinism_phase(final_setup, traf)
    lap("phase 9")

    # phases 10 and 11: SCHUR_COMPLEMENT and PoBA
    sc_out, sc_checked = sc_poba_phase(lady, traf, final, final_setup, errs)
    lap("phases 10-11")

    # phase 15: the obs pair gather against the default stream
    gathers_out, gathers_checked, obs_rec = gathers_phase(
        final, final_setup, errs)
    lap("phase 15")

    # phases 16 and 17: the einsum layout, the landmark mesh
    layout_out = {"einsum": einsum_phase(final, final_setup)}
    lap("phase 16")
    layout_out["mesh"] = mesh_phase()
    lap("phase 17")

    # phases 12-14: checkpoint/resume, the CERES baselines, the formats
    lady_setup = SharedSetup(lady)  # phase 12's and the eval phase's
    host_out = {"checkpoint": checkpoint_phase(final, lady_setup)}
    lap("phase 12")
    host_out["baselines"] = baselines_phase(lady)
    lap("phase 13")
    host_out["formats"] = formats_phase(final, lady)
    lap("phase 14")

    # the eval phase: the report over phases 3, 10 and 11's logs, and
    # the live viewer's solve on the card
    eval_out = eval_phase(lady_setup)
    lap("eval")

    phase8, tw4585 = final4585_phase()
    for k, st in tw4585["float32"].items():
        errs[k] = max(errs[k], st["max_abs_err"])
    lap("phase 8")

    # phase 6: the counted solve of each path, under a trace: the launch
    # counts set to 0 just before it and read just after
    paths = {}
    logs = {}
    final_spy = RouteSpy(keep=True)
    SCT, PBT = "SCHUR_COMPLEMENT", "POWER_SCHUR_COMPLEMENT"
    sqrt_k = ("outer81_fold", "w_build")
    for path, bal, iters, kern, extra, run in (
            ("ladybug", lady, 20, sqrt_k + ("pcg_dense_cluster",), (), None),
            ("trafalgar126", mid, 5, sqrt_k + ("pcg_dense_half",), (), None),
            ("trafalgar", traf, 5, sqrt_k, (), None),
            ("trafalgar_on", traf, 3, sqrt_k + ("pcg_dense_grid",), K3_ON,
             None),
            ("final3068", final, 2, sqrt_k, (),
             lambda: final_setup.solve(max_num_iterations=2)),
            # the SC and PoBA paths: K1 only
            ("sc_ladybug", lady, 5, ("outer81_fold",), (),
             lambda: run_cli(lady, 5, "sc_ladybug_counted", solver=SCT)),
            ("sc_trafalgar", traf, 3, ("outer81_fold",), (),
             lambda: run_cli(traf, 3, "sc_trafalgar_counted", solver=SCT)),
            ("sc_final3068", final, 2, ("outer81_fold",), (),
             lambda: final_setup.solve(solver_type=SCT,
                                       max_num_iterations=2)),
            ("poba_ladybug", lady, 5, ("outer81_fold",), (),
             lambda: run_cli(lady, 5, "poba_ladybug_counted", solver=PBT)),
            ("poba_final3068_f64", final, 2, ("outer81_fold",), (),
             lambda: final_setup.solve(solver_type=PBT, use_double=True,
                                       max_num_iterations=2)),
            # the obs pair gather: K1 and K2 (and the padded grid's K3
            # at ladybug); final-3068 on phase 15's index builds
            ("obs_ladybug", lady, 2, sqrt_k + ("pcg_dense_cluster",), OBS,
             None),
            ("obs_final3068", final, 1, sqrt_k, (),
             lambda: final_setup.solve(pair_gather="obs",
                                       max_num_iterations=1))):
        if path == "final3068":
            # keeps the last stage2's system for the operator timing
            with final_spy:
                log, n, ms = counted_run(bal, iters, path, extra, run=run)
        else:
            log, n, ms = counted_run(bal, iters, path, extra, run=run)
        logs[path] = log
        paths[path] = (n, ms)
        summarize_log(log, path)
        for k in n:
            check((n[k] > 0) == (k in kern), f"{path}: kernel {k} launched "
                                             f"{n[k]} times {n}")
        print(f"[phase 6] {path}: {iters} LM iterations, launches {n}, "
              f"device ms summed over the solve "
              f"{ {k: round(v, 5) for k, v in ms.items()} }", flush=True)
    lap("phase 6")
    rel = abs(logs["ladybug"]["cost"][-1] / LADYBUG_CARD_FINAL_COST - 1)
    check(rel < 1e-4, f"ladybug: final cost {logs['ladybug']['cost'][-1]} "
                      f"is rel {rel} from {LADYBUG_CARD_FINAL_COST}")
    rel = abs(ls["final_cost"] / LADYBUG_CARD_FINAL_COST - 1)
    check(rel < 1e-4, f"ladybug: final cost {ls['final_cost']} is rel "
                      f"{rel} from {LADYBUG_CARD_FINAL_COST}")
    for cost in (ms_["final_cost"], logs["trafalgar126"]["cost"][-1]):
        rel = abs(cost / TRAFALGAR126_CARD_FINAL_COST - 1)
        check(rel < 1e-4, f"trafalgar126: final cost {cost} is rel {rel} "
                          f"from {TRAFALGAR126_CARD_FINAL_COST}")
    # phase 9, continued: the f32 trafalgar-257 solve twice (phase 4's
    # timed solve and phase 6's counted one) gives the same CG counts and
    # the same costs, bit for bit; ladybug's two 20-iteration solves
    # (phase 3 and 6; K3) are reported
    a, b = traf_log, logs["trafalgar"]
    check(a["linear_solver_iterations"] == b["linear_solver_iterations"]
          and a["cost"] == b["cost"],
          f"trafalgar f32 solved twice: CG {a['linear_solver_iterations']} "
          f"/ {b['linear_solver_iterations']}, costs {a['cost']} / "
          f"{b['cost']}")
    lady_same = ls["final_cost"] == logs["ladybug"]["cost"][-1]
    print(f"[phase 9] trafalgar-257 f32 solved twice (phases 4 and 6): "
          f"the same CG counts {a['linear_solver_iterations'][1:]} and "
          f"bit-equal costs {a['cost']}; ladybug-49 (K3) final costs "
          f"{ls['final_cost']!r} / {logs['ladybug']['cost'][-1]!r}: "
          f"{'equal' if lady_same else 'different'}", flush=True)

    # K1/K2 timed at the largest (trafalgar-257) path's inputs, the
    # full-row K3 at ladybug's, the half K3 at trafalgar-126's, the grid
    # K3 at the pallas_cg="on" trafalgar-257 path's
    attempts = {p: len(lg["iteration_time"]) - 1 for p, lg in logs.items()}
    rows = [k1_row(rec_t, errs), k2_row(rec_t, errs)]
    # the final-3068 path's every call, checked in phases 7 and 7b, and
    # the final-4585 paths' (8a in f64, 8c's untimed solve in f32)
    for r in rows[:2]:
        st32, st64 = tw32.stats[r["name"]], tw64.stats[r["name"]]
        r["final3068_checked"] = {"float32": st32, "float64": st64}
        r["final4585_checked"] = {p: st[r["name"]]
                                  for p, st in tw4585.items()}
        if "max_abs_err_f64" in r:
            r["max_abs_err_f64"] = max(
                r["max_abs_err_f64"], st64["max_abs_err"],
                tw4585["float64"][r["name"]]["max_abs_err"])
    # K1 on the SC and PoBA paths of final-3068 (phases 10 and 11)
    rows[0]["final3068_sc_poba_checked"] = {
        k: st["outer81_fold"] for k, st in sc_checked.items()}
    rows[0]["max_abs_err_f64"] = max(
        rows[0]["max_abs_err_f64"],
        sc_checked["poba_float64"]["outer81_fold"]["max_abs_err"])
    # the obs route (phase 15): every K1/K2 call of its checked attempt,
    # and K1 timed at its largest call, run width 64
    for r in rows[:2]:
        r["obs_checked"] = {
            k: st[r["name"]] for k, st in gathers_checked.items()}
    rows[0]["w64"] = k1_w64(obs_rec)
    obs_rec = None
    rows.append(k3_row("pcg_dense_cluster", rec.largest["pcg_dense"], errs,
                       lady_k3, compare_grid=True))
    rows.append(k3_row("pcg_dense_half", rec_m.largest["pcg_dense"], errs,
                       mid_k3, compare_grid=True))
    rows.append(k3_row("pcg_dense_grid", rec_on.largest["pcg_dense"], errs,
                       on_k3, compare_grid=False))
    rows[-1]["trafalgar_per_lm_iteration_s"] = {
        k: dict(iteration=v[0], linear_solve=v[1], cg_iters=v[2])
        for k, v in per_lm.items()}
    # launches and summed device time per LM attempt, from each path's
    # counted solve; phase 8's final-4585 runs (8c in f32, 8a in f64)
    # add their launches per attempt (counted, not traced)
    attempts.update({p: a for p, (_, a) in phase8.items()})
    for r in rows:
        k = r["name"]
        r["launches_by_path"] = {p: n[k] for p, (n, _) in paths.items()}
        r["launches_by_path"].update(
            {p: n[k] for p, (n, _) in phase8.items()})
        r["launches"] = sum(r["launches_by_path"].values())
        r["attempts_by_path"] = attempts
        r["launches_per_attempt_by_path"] = {
            p: v / attempts[p] for p, v in r["launches_by_path"].items()}
        r["ms_per_attempt_by_path"] = {
            p: ms[k] / attempts[p] for p, (_, ms) in paths.items()}
        r["card"] = smi
    print(f"[timing] on {torch.cuda.get_device_name(0)}: "
          + "; ".join(f"{r['name']} {r['shape']}: {r['ms']:.5f} ms "
                      f"(bound {r['bound_ms']:.5f}, plain "
                      f"{r['plain_ms']:.5f}), trace {r['ms_trace']}"
                      for r in rows), flush=True)
    lap("timing")
    ops = bsr_operator_rows(final_spy.system, smi)
    final_spy.system.clear()
    # the SC and PoBA paths: the timed solves of phases 10-11 with K1's
    # launches and device time per LM attempt from their counted solves
    # (phase 6)
    for p, r in sc_out.items():
        if p in paths:  # not the f64 reruns of a counted path
            n, ms = paths[p]
            r["k1_launches_per_attempt"] = n["outer81_fold"] / attempts[p]
            r["k1_device_ms_per_attempt"] = ms["outer81_fold"] / attempts[p]
        r["card"] = smi
    lap("sc line")
    # the stream and obs routes at final-3068: K1/K2 launches and device
    # time per LM attempt from their counted solves (phase 6)
    for tag, p in (("stream_final3068", "final3068"),
                   ("obs_final3068", "obs_final3068")):
        n, ms = paths[p]
        gathers_out[tag]["launches_per_attempt"] = {
            k: v / attempts[p] for k, v in n.items() if v}
        gathers_out[tag]["device_ms_per_attempt"] = {
            k: ms[k] / attempts[p] for k, v in n.items() if v}
    print(json.dumps({"einsum_mesh": layout_out, "card": smi}))
    print(json.dumps({"pair_gathers": gathers_out, "card": smi}))
    print(json.dumps({"checkpoint_baselines_formats": host_out,
                      "eval": eval_out, "card": smi}))
    print(json.dumps({"sc": sc_out, "phase_walls_s": walls}))
    print(json.dumps({"bsr_operators": ops}))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
