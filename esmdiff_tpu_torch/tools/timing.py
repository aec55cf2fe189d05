"""Device and host time of a call on a CUDA card, for the measurement
scripts (``chip_smoke.py`` and the tools of this package)."""

import time

import torch

# at or above an H100's SM clock (1.98 GHz at most), so a spin of n cycles
# lasts at least n / SPIN_HZ seconds
SPIN_HZ = 2.0e9


def device_ms(fn, iters=50, warmup=5):
    """Mean device time of ``fn`` over ``iters`` back-to-back launches
    (CUDA events).  A spin kernel first holds the stream for twice as long
    as the host took to enqueue the warmup calls, scaled to ``iters``, so
    every launch is queued before the first one runs: the events time the
    device's work, not the host's enqueue (``host_ms`` reports that).

    The spin is ``torch.cuda._sleep`` (a kernel that waits a number of
    clock cycles), a private PyTorch API: if a PyTorch release drops it,
    this function fails rather than time the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    enqueue_s = (time.perf_counter() - t0) / warmup * iters
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(2 * enqueue_s * SPIN_HZ) + 1)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, calls=200):
    """Host wall time per call of ``calls`` back-to-back calls, with no
    synchronise between them: what a call costs the CPU that enqueues it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * elapsed / calls
