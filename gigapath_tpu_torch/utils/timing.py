"""Per-iteration time of a chained step (the port's counterpart of
``gigapath_tpu/utils/timing.py``).

``step(carry, *args) -> carry`` is run ``n`` times in a chain, each call
reading the carry the previous one returned, so no call can start before
the one it depends on has produced its input. Two loop counts are timed and
their difference divided by the difference of the counts: what every run
pays once (the launch queue filling, the first read back) cancels out.

On a CUDA carry the loops are timed with CUDA events on the current stream
(device time, read after one wait at the loop's end); on a CPU carry with
``time.perf_counter``.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple


def _chain(step: Callable, x, args: Tuple, n: int):
    for _ in range(n):
        x = step(x, *args)
    return x


def _loop_seconds(step: Callable, x0, args: Tuple, n: int) -> float:
    """Seconds of one chain of ``n`` steps."""
    import torch

    if getattr(x0, "is_cuda", False):
        stream = torch.cuda.current_stream(x0.device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        _chain(step, x0, args, n)
        end.record(stream)
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    _chain(step, x0, args, n)
    return time.perf_counter() - t0


def chained_seconds_per_iter(
    step: Callable,
    x0,
    *,
    args: Tuple = (),
    iters_low: int = 2,
    iters_high: int = 12,
    repeats: int = 2,
) -> Tuple[float, float]:
    """Seconds per iteration of ``step(carry, *args) -> carry``.

    Returns ``(sec_per_iter, overhead_sec)``: the best of ``repeats`` runs
    of each loop count, their difference over ``iters_high - iters_low``,
    and what the short loop took beyond its iterations. One untimed chain
    of each count runs first (kernel builds, allocator warm-up)."""
    if iters_high <= iters_low:
        raise ValueError(f"chained_seconds_per_iter: iters_high ({iters_high}) must exceed iters_low ({iters_low})")
    for n in (iters_low, iters_high):
        _loop_seconds(step, x0, args, n)

    def best(n: int) -> float:
        return min(_loop_seconds(step, x0, args, n) for _ in range(max(int(repeats), 1)))

    t_lo, t_hi = best(iters_low), best(iters_high)
    per_iter = (t_hi - t_lo) / (iters_high - iters_low)
    overhead = t_lo - iters_low * per_iter
    return max(per_iter, 1e-9), overhead
