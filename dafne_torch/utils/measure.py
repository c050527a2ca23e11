"""The card's published peaks and the timers every measurement shares.

The peaks are one NVIDIA H100 SXM's (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit): a bound computed from
them is the least time the card could take for the work.  ``bound`` turns
a count of operations and bytes into that time; the kernels' own counts
live beside them (``ops/kernels/quad_nms.py::suppression_bound``,
``greedy_bound``, ``ops/kernels/assign.py::assign_bound``,
``quant.conv_ops``, ``deform_conv.forward_bytes``).

The timers: ``cuda_ms`` (CUDA events around each call, the median),
``events_ms`` (CUDA events around `iters` calls in a row, the mean),
``host_ms`` (the host clock between synchronizations) and ``device_ms``
(the kernels' own device time from ``torch.profiler`` traces).  They need
the card; nothing here falls back to the CPU.
"""

from __future__ import annotations

import logging
import statistics
import time
from typing import Callable, Optional, Tuple

import torch

#: bf16 (and fp16) dense tensor-core rate, FLOP/s
BF16_FLOPS = 989e12
#: float32 outside the tensor cores, FLOP/s (a fused multiply-add counted as 2)
F32_FLOPS = 67e12
#: the kernels are built with -fmad=false, so each add, mul or compare is an
#: instruction of its own, issued at most once per FP32 lane per cycle: half
#: of F32_FLOPS
F32_OPS_NO_FMA = F32_FLOPS / 2
#: int8 dense tensor-core rate, OP/s
INT8_OPS_PER_S = 1979e12
#: HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12
#: boost clock, and the latency of one dependent integer ALU step: the
#: greedy walk's serial floor
SM_CLOCK_HZ = 1.98e9
SERIAL_STEP_CYCLES = 4


def bound(ops: float, ops_per_s: float, nbytes: float) -> Tuple[float, str]:
    """(least ms, "operations" or "bytes"): the larger of `ops` at
    `ops_per_s` and `nbytes` at HBM_BYTES_PER_S."""
    t_ops = ops / ops_per_s * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def cuda_ms(fn: Callable[[], object], reps: int = 20, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timings of fn(), after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def events_ms(fn: Callable[[], object], iters: int, warmup: int) -> float:
    """Mean ms per call of fn() from one pair of CUDA events around `iters`
    calls in a row, after `warmup` calls: launches queue behind each other,
    as a loop of steps does."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn: Callable[[], object], reps: int = 3) -> float:
    """Median host-clock ms of fn(), synchronised with the card on both ends."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn: Callable[[], object], kernel: str, reps: int = 20, traces: int = 5,
              launches: Optional[int] = 1) -> Optional[float]:
    """Mean device ms per call of fn() of the CUDA kernels whose name holds
    `kernel`, from a torch.profiler trace of `reps` calls after one warm-up
    call: the kernels alone, without the host time that CUDA events around
    a call (``cuda_ms``) also hold when the card waits for a launch.

    The profiler drops events, and a trace that dropped some reads low.
    A session's first events go missing (3 of 20 calls of K1 or K3, every
    trace, on an H100), so each trace records a warm-up step of `reps`
    calls that the profiler's schedule discards, then the `reps` calls it
    keeps.  A trace counts only when it holds `reps` x `launches` such
    kernels (`launches`: one call's launches of them).  Otherwise it is
    taken again, up to `traces` times; then None: not measured, and the
    count each trace held is logged as a warning ("dafne_torch").  With
    `launches` None (``kernel`` "": every kernel, copies and fills
    included, the device's busy time) all `traces` traces are taken, one
    call's launches are the most any trace holds, and the time is the mean
    of the traces that hold that many."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):  # the warm-up step, then the kept one
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events = [e for e in prof.key_averages()
                  if kernel in e.key and e.self_device_time_total > 0]
        count = sum(e.count for e in events)
        total_us = sum(e.self_device_time_total for e in events)
        if launches is not None and count == reps * launches:
            return total_us / reps / 1e3
        seen.append((count, total_us))
    if launches is not None or not any(c for c, _ in seen):
        logging.getLogger("dafne_torch").warning(
            f"device_ms: no trace of {kernel or 'the device'} held "
            f"{'a call' if launches is None else reps * launches}'s kernels: "
            f"{[c for c, _ in seen]} in {traces} traces: not measured")
        return None
    most = max(c for c, _ in seen)
    full = [t for c, t in seen if c == most]  # the busy time of the fullest traces
    return sum(full) / len(full) / reps / 1e3
