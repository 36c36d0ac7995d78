"""Headline benchmark: batched n=4 High-precision QFloat inversions/s on one GPU
(the first visible card only).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "inversions/s", "device_kind": ...,
   "power_limit": ..., ...}

The measured step is the full compiled device program: packed int64
magnitudes and signs in, the inverse magnitudes and signs out.  Host-side
quantization is pipelined in production (runtime/stream.py) and excluded
here.  Without a GPU the benchmark fails; it never reports a CPU number.

Environment: BENCH_BATCH (default 1048576), BENCH_REPS (10),
BENCH_REPEATS (3).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np


def main():
    # one card: on a host with several, auto would build the data-parallel
    # program and the rate would not be per device
    os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {dev.platform}")
    assert len(jax.devices()) == 1, jax.devices()
    power_limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    from matrix_inversion_tpu import HIGH
    from matrix_inversion_tpu.runtime.api import BatchedMatrixInversion
    from matrix_inversion_tpu.utils.timing import timed_chain

    batch = int(os.environ.get("BENCH_BATCH", 1048576))
    reps = int(os.environ.get("BENCH_REPS", 10))
    repeats = int(os.environ.get("BENCH_REPEATS", 3))

    params = HIGH.replace(n=4)
    t0 = time.time()
    inv = BatchedMatrixInversion(params, batch, backend="packed", io="packed")
    compile_s = time.time() - t0

    rng = np.random.RandomState(0)
    M = rng.randn(batch, 4, 4) * 100
    mags, signs = inv.quantize(M)
    mags = jax.device_put(jnp.asarray(mags))
    signs = jax.device_put(jnp.asarray(signs))

    # warmup (also the correctness sample)
    warm = jax.block_until_ready(inv.run_raw(mags, signs))

    step = lambda st: inv.run_raw(*st)
    elapsed, stats = timed_chain(step, jax.block_until_ready, (mags, signs),
                                 reps, repeats)
    throughput = batch * reps / elapsed

    res = inv.dequantize((np.asarray(warm[0])[:64], np.asarray(warm[1])[:64]))
    err = float(np.mean(np.abs(res - np.linalg.inv(M[:64]))))

    result = {
        "metric": "n4_high_precision_inversions_per_s_per_device",
        "value": round(throughput, 1),
        "unit": "inversions/s",
        "batch": batch,
        "reps": reps,
        "compile_s": round(compile_s, 2),
        "mean_abs_error": err,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "power_limit": power_limit,
        "spread_pct": stats["spread_pct"],
        "timing_repeats": stats["timing_repeats"],
        "date": stats["date"],
    }
    print(json.dumps(result))


if __name__ == "__main__":
    sys.exit(main())
