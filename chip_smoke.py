#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device  — the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build   — nvcc builds the port's CUDA kernels from ``src/``;
3. kernels — each kernel against its plain PyTorch version on the card, on
   seeded inputs with edge buckets (all zero, −0.0, NaN, ±tiny), at
   nb = 1,024 and again at the main path's full shape (nb = 18,858,
   bs = 65,536, W = 2), where both are then timed beside the kernel's bound;
4. main path — ``repro_torch.train.loop.run_training`` trains full-width
   llama3.2-1b for a few steps with bucketed EF-signSGD (``ef_allgather``,
   ``scaled_sign``) over an in-process EF world of W = 2, and the kernels'
   launch counts show that the step went through them;
5. profile — two more steps under ``torch.profiler``: device busy and idle
   share of a step, device time by kernel kind, host time by op.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repository's ``src/repro_torch`` beside this file, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and non-tensor fp32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# main path: full-width llama3.2-1b, W = 2 in-process EF workers
STEPS, WORLD, BATCH, SEQ, BUCKET, LR, SEED = 4, 2, 4, 256, 65536, 0.02, 0
FULL_NB = 18858  # buckets of 65,536 in the 1,235,814,400 fp32 params
PARITY_NB, TIMED_RUNS = 1024, 20
STATS_RTOL = 1e-5  # fp32 sums over 65,536 terms in another order than torch's

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/ef_sign.cu"
REPLACES = {
    "bucket_stats": "src/repro/kernels/ef_sign.py:151",
    "bucket_ef_sign_compress": "src/repro/kernels/ef_sign.py:190",
    "bucket_sign_decompress_mean": "src/repro/kernels/ef_sign.py:259",
}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def bitwise_equal(a, b) -> bool:
    """Same bits everywhere, except that any NaN matches any NaN."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if not torch.equal(nan_a, nan_b):
        return False
    return torch.equal(a.view(torch.int32).masked_fill(nan_a, 0),
                       b.view(torch.int32).masked_fill(nan_b, 0))


def max_abs_err(a, b) -> float:
    import torch

    a, b = a.float(), b.float()
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a - b).abs().masked_fill_(~fin, 0.0).max()) if a.numel() else 0.0


def time_ms(fn, runs: int = TIMED_RUNS, warmup: int = 2) -> float:
    """Median of ``runs`` single-call times (CUDA events), after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, fp32_ops: float) -> tuple[float, str]:
    mem_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = fp32_ops / FP32_OPS_PER_S * 1e3
    return (mem_ms, "bytes") if mem_ms >= ops_ms else (ops_ms, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log("== 1. device")
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build

    log("== 2. build")
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info
    log(f"kernels: {info.path.name} cached={info.cached} nvcc_s={info.seconds:.2f} "
        f"load_s={time.perf_counter() - t0:.2f}")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())


def edge_inputs(nb: int, bs: int, gen):
    """Seeded (g, e) with edge buckets: 0 all zero, 1 −0.0, 2 NaN, 3 ±tiny."""
    import torch

    g = torch.randn((nb, bs), generator=gen, device="cuda")
    e = torch.randn((nb, bs), generator=gen, device="cuda") * 0.1
    g[0], e[0] = 0.0, 0.0
    g[1, ::3], e[1, ::3] = -0.0, -0.0  # p = −0.0 packs as 1
    g[2, ::7] = float("nan")
    sign = torch.where(torch.rand(bs, generator=gen, device="cuda") < 0.5, -1.0, 1.0)
    g[3] = sign * 1e-38
    e[3] = -sign * 1e-45  # subnormal: survives only without flush-to-zero
    return g.contiguous(), e.contiguous()


def phase_kernels() -> dict:
    import torch

    from repro_torch.kernels import ef_sign, ops, ref

    log("== 3. kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bs = BUCKET
    g, e = edge_inputs(PARITY_NB, bs, gen)
    results = {k.name: {"max_abs_err": 0.0} for k in ef_sign.KERNELS}

    def note_err(name: str, err: float) -> None:
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)

    l1, l2 = ef_sign.bucket_stats(g, e)
    r1, r2 = ref.bucket_stats_ref(g, e)
    torch.cuda.synchronize()
    torch.testing.assert_close(l1, r1, rtol=STATS_RTOL, atol=0.0, equal_nan=True)
    torch.testing.assert_close(l2, r2, rtol=STATS_RTOL, atol=0.0, equal_nan=True)
    note_err("bucket_stats", max(max_abs_err(l1, r1), max_abs_err(l2, r2)))
    log(f"bucket_stats: l1/l2sq within rtol {STATS_RTOL}; max_abs_err "
        f"{results['bucket_stats']['max_abs_err']:.3e}")

    scales = r1 * ref.reciprocal_f32(bs)
    words, e_new = ef_sign.bucket_ef_sign_compress(g, e, scales)
    rw, re_ = ref.bucket_ef_sign_compress_ref(g, e, scales)
    torch.cuda.synchronize()
    if not (torch.equal(words, rw) and bitwise_equal(e_new, re_)):
        raise AssertionError("bucket_ef_sign_compress differs from its plain version")
    if not bool(words[0].eq(-1).all()):
        raise AssertionError("an all-zero bucket must pack to all-ones words")
    note_err("bucket_ef_sign_compress", max_abs_err(e_new, re_))
    log("bucket_ef_sign_compress: words and residual bitwise equal")
    ow, _, _, dens = ops.ef_sign_bucket_step(g, e)  # the dispatch a CUDA tensor takes
    if not (torch.equal(ow, words) and float(dens[0]) == 1.0):
        raise AssertionError("ops.ef_sign_bucket_step: words differ or an all-zero bucket's density != 1")

    err = 0.0
    for w in (1, 2, 3, 8):
        ws = torch.randint(-(2**31), 2**31 - 1, (w, PARITY_NB, bs // 32), generator=gen,
                           device="cuda", dtype=torch.int32)
        ws[0] = words
        ss = torch.rand((w, PARITY_NB), generator=gen, device="cuda")
        out = ef_sign.bucket_sign_decompress_mean(ws, ss)
        want = ref.bucket_decompress_mean_ref(ws, ss)
        torch.cuda.synchronize()
        if not bitwise_equal(out, want):
            raise AssertionError(f"bucket_sign_decompress_mean differs at W={w}")
        err = max(err, max_abs_err(out, want))
    note_err("bucket_sign_decompress_mean", err)
    log("bucket_sign_decompress_mean: bitwise equal at W = 1, 2, 3, 8")
    del g, e, l1, l2, r1, r2, words, e_new, rw, re_, ws, ss, out, want
    torch.cuda.empty_cache()

    # the main path's full shape: each kernel against its plain version on
    # the same inputs (edge buckets included), then both timed
    nb, w = FULL_NB, WORLD
    n = nb * bs
    g, e = edge_inputs(nb, bs, gen)
    l1, l2 = ef_sign.bucket_stats(g, e)
    r1, r2 = ref.bucket_stats_ref(g, e)
    torch.cuda.synchronize()
    torch.testing.assert_close(l1, r1, rtol=STATS_RTOL, atol=0.0, equal_nan=True)
    torch.testing.assert_close(l2, r2, rtol=STATS_RTOL, atol=0.0, equal_nan=True)
    stats_err = max(max_abs_err(l1, r1), max_abs_err(l2, r2))
    note_err("bucket_stats", stats_err)
    del r1, r2
    scales = l1 * ref.reciprocal_f32(bs)  # as the main path computes them
    words, e_new = ef_sign.bucket_ef_sign_compress(g, e, scales)
    rw, re_ = ref.bucket_ef_sign_compress_ref(g, e, scales)
    torch.cuda.synchronize()
    if not (torch.equal(words, rw) and bitwise_equal(e_new, re_)):
        raise AssertionError(f"bucket_ef_sign_compress differs from its plain version at nb={nb}")
    compress_err = max_abs_err(e_new, re_)
    note_err("bucket_ef_sign_compress", compress_err)
    del rw, re_, e_new
    torch.cuda.empty_cache()
    log(f"full shape nb={nb} bs={bs}: bucket_stats within rtol {STATS_RTOL} (max_abs_err "
        f"{stats_err:.3e}), bucket_ef_sign_compress bitwise (max_abs_err {compress_err:.3e})")
    rows = []
    k_ms = time_ms(lambda: ef_sign.bucket_stats(g, e))
    p_ms = time_ms(lambda: ref.bucket_stats_ref(g, e))
    rows.append(("bucket_stats", k_ms, p_ms, nbytes(g, e, l1, l2), 5.0 * n))
    k_ms = time_ms(lambda: ef_sign.bucket_ef_sign_compress(g, e, scales))
    p_ms = time_ms(lambda: ref.bucket_ef_sign_compress_ref(g, e, scales))
    rows.append(("bucket_ef_sign_compress", k_ms, p_ms,
                 nbytes(g, e, scales, words) + nbytes(g), 3.0 * n))
    del g, e
    torch.cuda.empty_cache()
    ws = torch.stack([words, words.roll(1, dims=1)])
    ss = torch.stack([scales, scales * 0.5])
    out = ef_sign.bucket_sign_decompress_mean(ws, ss)
    want = ref.bucket_decompress_mean_ref(ws, ss)
    torch.cuda.synchronize()
    if not bitwise_equal(out, want):
        raise AssertionError(f"bucket_sign_decompress_mean differs at W={w} nb={nb}")
    mean_err = max_abs_err(out, want)
    note_err("bucket_sign_decompress_mean", mean_err)
    del want
    torch.cuda.empty_cache()
    log(f"full shape W={w} nb={nb} bs={bs}: bucket_sign_decompress_mean bitwise "
        f"(max_abs_err {mean_err:.3e})")
    k_ms = time_ms(lambda: ef_sign.bucket_sign_decompress_mean(ws, ss))
    p_ms = time_ms(lambda: ref.bucket_decompress_mean_ref(ws, ss))
    rows.append(("bucket_sign_decompress_mean", k_ms, p_ms, nbytes(ws, ss, out),
                 (2.0 * w + 1.0) * n))
    del ws, ss, out, words, scales, l1, l2
    torch.cuda.empty_cache()
    for name, k_ms, p_ms, moved, ops in rows:
        b_ms, b_by = bound(moved, ops)
        results[name].update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"{name}: {k_ms:.3f} ms (plain {p_ms:.3f} ms), bound {b_ms:.3f} ms by {b_by} "
            f"at 3.35 TB/s; {moved / k_ms / 1e6:.1f} GB/s achieved, "
            f"{b_ms / k_ms:.1%} of bound  [nb={nb} bs={bs} W={w}]")
    return results


def phase_main_path() -> tuple[dict, float]:
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.aggregation import bucketed_sign_allgather_wire_bytes
    from repro_torch.kernels import ef_sign
    from repro_torch.models import transformer
    from repro_torch.train.loop import TrainJob, run_training

    log("== 4. main path: full-width llama3.2-1b, ef_allgather + scaled_sign, W = 2")
    cfg = get_config("llama3.2-1b")
    job = TrainJob(
        cfg=cfg, world=WORLD, steps=STEPS, batch=BATCH, seq=SEQ, lr=LR, optimizer="sgd",
        strategy="ef_allgather", compressor="scaled_sign", seed=SEED, log_every=1,
        lr_schedule="constant", bucket_size=BUCKET,
    )
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = transformer.init_params(cfg, gen, "cuda")
    n_params = sum(v.numel() for v in params.values())
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} params, config says {cfg.param_count()}")
    before = {k: v.reshape(-1)[:4096].clone() for k, v in params.items()}
    log(f"params {n_params:,} fp32; batch {BATCH} x seq {SEQ}; bucket {BUCKET}; steps {STEPS}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    records = []

    def on_step(rec):
        prev = records[-1]["wall_s"] if records else 0.0
        step_s = rec["wall_s"] - prev
        records.append(rec)
        log(f"step {rec['step']}: loss {rec['loss']:.4f} wall {step_s * 1e3:.1f} ms "
            f"tokens/s {BATCH * SEQ / step_s:.0f} wire_bytes {rec['wire_bytes']:.0f} "
            f"density {rec['density']:.4f} max_mem {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    ef_sign.reset_launch_counts()  # the main path's run alone is counted
    state, _ = run_training(job, log_fn=on_step, device="cuda", params=params)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in ef_sign.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    log(f"launches {launches}; peak memory {peak / 1e9:.2f} GB")

    losses = [r["loss"] for r in records]
    if len(losses) != STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses {losses}")
    if abs(losses[0] - math.log(cfg.padded_vocab)) > 2.0:
        raise AssertionError(f"step-0 loss {losses[0]} far from ln V at a random init")
    nb = -(-n_params // BUCKET)
    if nb != FULL_NB:
        raise AssertionError(f"{nb} buckets, expected {FULL_NB}")
    wire = bucketed_sign_allgather_wire_bytes(nb, BUCKET, WORLD)
    if any(r["wire_bytes"] != wire for r in records):
        raise AssertionError(f"wire_bytes != the analytic {wire}")
    if not all(0.0 < r["density"] <= 1.0 for r in records):
        raise AssertionError("density outside (0, 1]")
    unchanged = [k for k, v in state.params.items() if torch.equal(v.reshape(-1)[:4096], before[k])]
    if unchanged:
        raise AssertionError(f"params unchanged after {STEPS} steps: {unchanged}")
    want = {"bucket_stats": STEPS * WORLD, "bucket_ef_sign_compress": STEPS * WORLD,
            "bucket_sign_decompress_mean": STEPS}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if peak > 60e9:
        raise AssertionError(f"peak memory {peak / 1e9:.1f} GB exceeds the 60 GB plan")
    del state, params
    torch.cuda.empty_cache()
    walls = [b["wall_s"] - a["wall_s"] for a, b in zip(records, records[1:])]
    return launches, statistics.median(walls) * 1e3


def kernel_category(name: str) -> str:
    for k in ("bucket_stats", "bucket_ef_sign_compress", "bucket_decompress_mean"):
        if k in name:
            return k
    low = name.lower()
    if "gemm" in low or "xmma" in low or "cutlass" in low or "cublas" in low:
        return "matmul (cuBLAS)"
    if "copy" in low or "cat" in low or "fill" in low:
        return "copies and fills"
    if "reduce" in low or "softmax" in low or "norm" in low:
        return "reductions and softmax"
    return "other elementwise"


def phase_profile(step_ms: float) -> None:
    """Device and host time by kernel and op over two steady-state steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.train.loop import TrainJob, run_training

    active = 2  # steps 1 and 2 of a fresh run; step 0 (allocator warm-up) is skipped
    log(f"== 5. where a step's time goes (torch.profiler, {active} steady-state steps)")
    cfg = get_config("llama3.2-1b")
    job = TrainJob(cfg=cfg, world=WORLD, steps=1 + active, batch=BATCH, seq=SEQ, lr=LR,
                   optimizer="sgd", seed=SEED + 1, log_every=1, lr_schedule="constant",
                   bucket_size=BUCKET)
    params = transformer.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED + 1), "cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=active, repeat=1)) as prof:
        run_training(job, device="cuda", params=params, log_fn=lambda rec: prof.step())
    by_kernel: dict[str, float] = {}
    host_ops: dict[str, tuple[float, int]] = {}
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0.0)
        if evt.key.startswith("ProfilerStep"):  # the step span: its device time double-counts
            t = 0.0
        if t > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + t / 1e3 / active  # ms per step
        elif evt.device_type == torch.autograd.DeviceType.CPU and evt.self_cpu_time_total > 0:
            host_ops[evt.key] = (evt.self_cpu_time_total / 1e3 / active, evt.count // active)
    if not by_kernel:
        raise AssertionError("the profiler recorded no device time")
    total = sum(by_kernel.values())
    cats: dict[str, float] = {}
    for name, ms in by_kernel.items():
        cats[kernel_category(name)] = cats.get(kernel_category(name), 0.0) + ms
    log(f"device busy {total:.1f} ms per step = {total / step_ms:.1%} of the {step_ms:.1f} ms "
        f"median unprofiled step; idle {1 - total / step_ms:.1%}")
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        log(f"  {cat}: {ms:.2f} ms/step ({ms / total:.1%} of device time)")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]:
        log(f"  kernel {ms:7.2f} ms/step  {name[:110]}")
    host = sum(ms for ms, _ in host_ops.values())
    log(f"host: {host:.1f} ms/step of self CPU time under the profiler (ProfilerStep* is "
        "Python and other host time outside any op); top ops:")
    for name, (ms, n) in sorted(host_ops.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"  host {ms:7.2f} ms/step  {n:5d} calls/step  {name[:80]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    smi = phase_device()
    phase_build()
    results = phase_kernels()
    launches, step_ms = phase_main_path()
    for name, n in launches.items():
        results[name]["launches"] = n
    phase_profile(step_ms)
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES[name],
            "launches": r["launches"],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,  # no single PyTorch call computes any of the three
        }
        for name, r in results.items()
    ]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
