"""Timing helpers (reference qfloat_matrix_inversion.py:747-755)."""

from __future__ import annotations

import time


def measure_time(function, description, verbose=True, *inputs):
    """Run ``function(*inputs)``, print and return (output, seconds)."""
    if verbose:
        print(description + " ...", end="", flush=True)
        print("\r", end="")
    start = time.time()
    output = function(*inputs)
    end = time.time()
    if verbose:
        print(f"|  {description} : {end - start:.2f} s  |")
    return output, end - start


def block_until_ready(x):
    """Wait for async device computation (the analog of circuit.run
    returning)."""
    import jax

    return jax.block_until_ready(x)


def timed_chain(step, fence, state, reps, repeats=3):
    """Data-dependency-chained throughput timing with dispersion.

    Runs ``repeats`` independent timing passes; each pass chains ``reps``
    calls of ``step(state) -> state`` and ends with ``fence(state)``, which
    must wait for the device (``jax.block_until_ready``).

    Returns ``(elapsed_median_s, stats)`` where ``stats`` carries the
    median/min/max/all elapsed seconds plus run metadata, so every
    recorded number keeps its spread.
    """
    import datetime

    import jax

    elapsed = []
    for _ in range(repeats):
        s = state
        t0 = time.perf_counter()
        for _ in range(reps):
            s = step(s)
        fence(s)
        elapsed.append(time.perf_counter() - t0)
    med = sorted(elapsed)[len(elapsed) // 2]
    dev = jax.devices()[0]
    stats = {
        "elapsed_median_s": med,
        "elapsed_min_s": min(elapsed),
        "elapsed_max_s": max(elapsed),
        "elapsed_all_s": elapsed,
        "spread_pct": 100.0 * (max(elapsed) - min(elapsed)) / med,
        "reps": reps,
        "timing_repeats": repeats,
        "date": datetime.date.today().isoformat(),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
    }
    return med, stats
