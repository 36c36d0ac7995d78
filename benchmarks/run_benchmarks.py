"""Benchmark driver: precision tables, throughput, and scaling efficiency.

Reproduces the reference's published benchmark methodology (README Tables
1-3; BASELINE.md) on this framework and writes JSON results under
``benchmarks/results/``.

Usage:
  python benchmarks/run_benchmarks.py precision [--N 10000] [--sizes 2,3,4,5,10]
  python benchmarks/run_benchmarks.py throughput [--batch 262144]
  python benchmarks/run_benchmarks.py scaling [--batch 65536]
  python benchmarks/run_benchmarks.py fused [--blocks 64,128] [--warps 1,4]

``--results-dir`` writes the JSON to another directory.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")


def write_result(name, payload):
    os.makedirs(RESULTS_DIR, exist_ok=True)
    payload = dict(payload, device=_device_label())
    path = os.path.join(RESULTS_DIR, f"{name}.json")
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=2)
    print(json.dumps(payload))
    print("wrote", path)


def _device_label():
    """The device every number in a result was measured on."""
    import subprocess

    import jax

    dev = jax.devices()[0]
    label = {"platform": dev.platform, "kind": dev.device_kind,
             "count": len(jax.devices())}
    if dev.platform == "gpu":
        label["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    return label


def cmd_precision(args):
    """README Table 1: mean error + big-error rate per preset and size."""
    import matrix_inversion_tpu as mi
    from matrix_inversion_tpu.utils.precision import precision_benchmark

    sizes = [int(s) for s in args.sizes.split(",")]
    presets = args.presets.split(",")
    # merge into prior results so partial sweeps extend the table
    table = {}
    prior = os.path.join(RESULTS_DIR, "precision.json")
    if os.path.exists(prior):
        with open(prior) as fh:
            table = json.load(fh)
    for preset_name in presets:
        preset = mi.PRESETS[preset_name]
        for n in sizes:
            p = preset.replace(n=n)
            t0 = time.time()
            stats = precision_benchmark(
                p, N=args.N, batch_size=min(args.N, args.batch), seed=0
            )
            stats["wall_s"] = round(time.time() - t0, 2)
            table[f"{preset_name}/n={n}"] = stats
            print(preset_name, n, stats)
    write_result("precision", table)


def cmd_throughput(args):
    """Per-chip throughput across sizes/presets (packed IO)."""
    import jax
    import jax.numpy as jnp
    import matrix_inversion_tpu as mi
    from matrix_inversion_tpu.runtime.api import BatchedMatrixInversion

    results = {}
    for preset_name, n in [("low", 2), ("medium", 3), ("high", 4), ("high", 5)]:
        p = mi.PRESETS[preset_name].replace(n=n)
        inv = BatchedMatrixInversion(p, args.batch, backend="packed", io="packed")
        rng = np.random.RandomState(0)
        M = rng.randn(args.batch, n, n) * 100
        mags, signs = inv.quantize(M)
        m = jax.device_put(jnp.asarray(mags))
        s = jax.device_put(jnp.asarray(signs))
        out = inv.run_raw(m, s)
        jax.block_until_ready(out)
        _ = np.asarray(out[0][0, 0])
        t0 = time.time()
        mm, ss = m, s
        for _ in range(args.reps):
            mm, ss = inv.run_raw(mm, ss)
        jax.block_until_ready((mm, ss))
        _ = np.asarray(mm[0, 0])
        elapsed = time.time() - t0
        results[f"{preset_name}/n={n}"] = {
            "inversions_per_s": round(args.batch * args.reps / elapsed, 1),
            "batch": args.batch,
            "reps": args.reps,
            "elapsed_s": round(elapsed, 4),
        }
        print(results[f"{preset_name}/n={n}"])
    write_result("throughput", results)


def cmd_lowering(args):
    """Scan vs unroll lowering ablation: compile time + throughput per n.

    The scanned lowering (models/qfloat_lu_scan.py) trades some execution
    speed for compile time independent of n; this measures both sides so
    the auto thresholds (models/inverse.py) stay grounded in device
    numbers.
    """
    import jax
    import jax.numpy as jnp
    import matrix_inversion_tpu as mi
    from matrix_inversion_tpu.runtime.api import BatchedMatrixInversion

    results = {}
    sizes = [int(s) for s in args.sizes.split(",")]
    for n in sizes:
        for lowering in args.lowerings.split(","):
            p = mi.PRESETS[args.preset].replace(n=n, lowering=lowering)
            t0 = time.time()
            try:
                inv = BatchedMatrixInversion(
                    p, args.batch, backend="packed", io="packed"
                )
            except Exception as e:  # e.g. unroll at huge n timing out
                results[f"n={n}/{lowering}"] = {"error": str(e)}
                continue
            compile_s = time.time() - t0
            rng = np.random.RandomState(0)
            M = rng.randn(args.batch, n, n) * 100
            mags, signs = inv.quantize(M)
            m = jax.device_put(jnp.asarray(mags))
            s = jax.device_put(jnp.asarray(signs))
            out = inv.run_raw(m, s)
            jax.block_until_ready(out)
            _ = np.asarray(out[0][0, 0])
            t0 = time.time()
            mm, ss = m, s
            for _ in range(args.reps):
                mm, ss = inv.run_raw(mm, ss)
            jax.block_until_ready((mm, ss))
            _ = np.asarray(mm[0, 0])
            elapsed = time.time() - t0
            results[f"n={n}/{lowering}"] = {
                "compile_s": round(compile_s, 1),
                "inversions_per_s": round(args.batch * args.reps / elapsed, 1),
                "batch": args.batch,
                "reps": args.reps,
            }
            print(f"n={n}/{lowering}", results[f"n={n}/{lowering}"], flush=True)
    write_result("lowering", results)


def cmd_fused(args):
    """Fused-kernel throughput per n at a fixed batch, swept over the
    kernel's ``block`` and ``num_warps`` (ops/fused_inverse.block_config),
    with dispersion.  ``--tracked`` adds the overflow-tracked kernel and
    the tracked XLA unroll lowering.  Writes results/fused.json."""
    import functools

    import jax
    import jax.numpy as jnp
    import matrix_inversion_tpu as mi
    from matrix_inversion_tpu.models.inverse import (
        qfloat_matrix_inverse_with_overflow,
    )
    from matrix_inversion_tpu.models.marshal import float_matrix_to_mags_and_signs
    from matrix_inversion_tpu.ops.fused_inverse import fused_matrix_inverse
    from matrix_inversion_tpu.utils.timing import timed_chain

    results = {}
    sizes = [int(s) for s in args.sizes.split(",")]
    blocks = [int(b) for b in args.blocks.split(",")] if args.blocks else [None]
    warps = [int(w) for w in args.warps.split(",")] if args.warps else [None]
    for n in sizes:
        p = mi.PRESETS[args.preset].replace(n=n)
        rng = np.random.RandomState(0)
        M = rng.randn(args.batch, n, n) * 100
        mags, signs = float_matrix_to_mags_and_signs(
            M, p.qfloat_len, p.qfloat_ints, p.qfloat_base
        )
        m = jax.device_put(jnp.asarray(mags, jnp.int64))
        s = jax.device_put(jnp.asarray(signs, jnp.int64))
        static = dict(n=n, qfloat_len=p.qfloat_len, qfloat_ints=p.qfloat_ints,
                      base=p.qfloat_base, true_division=p.true_division)

        variants = [("fused", blk, w, False) for blk in blocks for w in warps]
        if args.tracked:
            variants += [("fused_tracked", None, None, True),
                         ("unroll_tracked", None, None, True)]
        for vname, blk, w, tracked in variants:
            if vname == "unroll_tracked":
                fn = jax.jit(functools.partial(
                    qfloat_matrix_inverse_with_overflow, n=n,
                    qfloat_len=p.qfloat_len, qfloat_ints=p.qfloat_ints,
                    qfloat_base=p.qfloat_base, true_division=p.true_division,
                    lowering="unroll",
                ))
            else:
                fn = jax.jit(functools.partial(
                    fused_matrix_inverse, block=blk, num_warps=w,
                    track=tracked, **static,
                ))
            t0 = time.time()
            compiled = fn.lower(m, s).compile()
            compile_s = time.time() - t0
            jax.block_until_ready(compiled(m, s))
            step = lambda st: compiled(st[0], st[1])[:2]
            elapsed, stats = timed_chain(
                step, jax.block_until_ready, (m, s), args.reps, args.repeats
            )
            key = f"{args.preset}/n={n}/{vname}"
            if blk or w:
                key += f"/block={blk}/warps={w}"
            results[key] = {
                "inversions_per_s": args.batch * args.reps / elapsed,
                "batch": args.batch,
                "compile_s": compile_s,
                **stats,
            }
            print(key, results[key], flush=True)
    write_result("fused", results)


def cmd_e2e(args):
    """Sustained END-TO-END throughput: quantize -> invert -> dequantize.

    The headline rate is device-only; this measures what a production
    caller actually gets for float-in/float-out
    batches, with the native C++ marshaller on vs off and the streaming
    (pipelined) vs serial execution, and names the host-side bottleneck.
    Mirrors the reference's total-lifecycle row ("Total, 1 run w/
    encryption", reference README.md:141).  Writes results/e2e.json.
    """
    import datetime

    import jax
    import jax.numpy as jnp
    import matrix_inversion_tpu as mi
    from matrix_inversion_tpu.runtime import native
    from matrix_inversion_tpu.runtime.api import BatchedMatrixInversion
    from matrix_inversion_tpu.runtime.stream import StreamingInverter

    p = mi.PRESETS[args.preset].replace(n=args.n)
    inv = BatchedMatrixInversion(p, args.batch, backend="packed", io="packed")
    rng = np.random.RandomState(0)
    M = rng.randn(args.batch, args.n, args.n) * 100

    results = {}
    results.update({
        "config": f"{args.preset}/n={args.n}",
        "batch": args.batch,
        "n_batches_streamed": args.nbatches,
        "date": datetime.date.today().isoformat(),
        "methodology_note": (
            "serial_measured = the same quantize->device_put->run->fetch->"
            "dequantize stages the streamed path runs, executed "
            "sequentially (transfers included, measured); "
            "serial_est_no_transfer = host phases + device compute only; "
            "streamed-vs-serial_measured is the fair overlap A/B."
        ),
    })

    # device-only reference rate (chained reps, same as the headline bench)
    a, b = inv.quantize(M)
    m = jax.device_put(jnp.asarray(a))
    s = jax.device_put(jnp.asarray(b))
    out = inv.run_raw(m, s)
    jax.block_until_ready(out)
    _ = np.asarray(out[0][0, 0])
    t0 = time.time()
    mm, ss = m, s
    for _ in range(args.nbatches):
        mm, ss = inv.run_raw(mm, ss)
    _ = np.asarray(jax.block_until_ready(mm)[0, 0])
    dev_elapsed = time.time() - t0
    results["device_only_inversions_per_s"] = round(
        args.batch * args.nbatches / dev_elapsed, 1
    )

    legs = (True, False) if native.available() else (False,)
    if args.native_only and native.available():
        legs = (True,)
    for native_on in legs:
        saved = (native._LIB, native._TRIED)
        if not native_on:
            native._LIB, native._TRIED = None, True
        try:
            label = "native" if native_on else "numpy"
            # host-only phase rates (values/s through quantize/dequantize)
            t0 = time.time()
            a, b = inv.quantize(M)
            tq = time.time() - t0
            host_out = (np.asarray(out[0]), np.asarray(out[1]))
            t0 = time.time()
            _ = inv.dequantize(host_out)
            tdq = time.time() - t0
            results[f"{label}/quantize_s_per_batch"] = round(tq, 3)
            results[f"{label}/dequantize_s_per_batch"] = round(tdq, 3)
            # arithmetic estimate: host phases + device compute, NO
            # host<->device transfer time (the co-located-host floor)
            results[f"{label}/serial_est_no_transfer_inversions_per_s"] = round(
                args.batch / (tq + dev_elapsed / args.nbatches + tdq), 1
            )

            # MEASURED serial pipeline: the exact same stages the streamed
            # path runs (quantize -> device_put -> run -> fetch ->
            # dequantize), executed sequentially.  This is the honest
            # baseline for the streamed A/B: both pay the transfers.
            serial_rates = []
            for _ in range(args.repeats):
                t0 = time.time()
                count = 0
                for _ in range(args.nbatches):
                    a, b = inv.quantize(M)
                    dm = jax.device_put(jnp.asarray(a, jnp.int64))
                    ds = jax.device_put(jnp.asarray(b, jnp.int64))
                    o = inv.run_raw(dm, ds)
                    jax.block_until_ready(o)
                    host = tuple(np.asarray(x) for x in o)
                    r = inv.dequantize(host)
                    count += r.shape[0]
                serial_rates.append(count / (time.time() - t0))
            serial_rates.sort()
            results[f"{label}/serial_measured_inversions_per_s"] = round(
                serial_rates[len(serial_rates) // 2], 1
            )
            results[f"{label}/serial_measured_inversions_per_s_all"] = [
                round(r, 1) for r in serial_rates
            ]

            # streamed (pipelined) sustained rate, >= 2 timing passes
            rates = []
            for _ in range(args.repeats):
                stream = StreamingInverter(
                    inv, depth=args.depth, finish_workers=args.finish_workers
                )
                t0 = time.time()
                count = 0
                for r in stream.run([M] * args.nbatches):
                    count += r.shape[0]
                elapsed = time.time() - t0
                assert count == args.batch * args.nbatches
                rates.append(count / elapsed)
            rates.sort()
            results[f"{label}/streamed_inversions_per_s"] = round(
                rates[len(rates) // 2], 1
            )
            results[f"{label}/streamed_inversions_per_s_all"] = [
                round(r, 1) for r in rates
            ]
        finally:
            native._LIB, native._TRIED = saved
        print(label, {k: v for k, v in results.items() if k.startswith(label)},
              flush=True)

    dev = results["device_only_inversions_per_s"]
    best = results.get(
        "native/streamed_inversions_per_s",
        results.get("numpy/streamed_inversions_per_s", 0),
    )
    results["streamed_fraction_of_device_rate"] = round(best / dev, 3)
    for label in ("native", "numpy"):
        st = results.get(f"{label}/streamed_inversions_per_s")
        se = results.get(f"{label}/serial_measured_inversions_per_s")
        if st and se:
            results[f"{label}/streamed_over_serial_measured"] = round(
                st / se, 2
            )
    write_result("e2e", results)


def cmd_scaling(args):
    """Data-parallel scaling efficiency across mesh sizes.

    On a real pod this measures ICI/DCN scaling; on the CPU test mesh it
    validates the sharded program structure end-to-end.
    """
    import jax
    import jax.numpy as jnp
    import matrix_inversion_tpu as mi
    from matrix_inversion_tpu.models.marshal import float_matrix_to_qfloat_arrays
    from matrix_inversion_tpu.parallel.mesh import data_parallel_inverse, make_mesh

    p = mi.PRESETS["high"].replace(n=4)
    n_dev_total = len(jax.devices())
    rng = np.random.RandomState(0)
    M = rng.randn(args.batch, 4, 4) * 100
    digits, signs = float_matrix_to_qfloat_arrays(
        M, p.qfloat_len, p.qfloat_ints, p.qfloat_base
    )

    collectives = (
        "all-reduce", "all-gather", "all-to-all", "collective-permute",
        "reduce-scatter", "collective-broadcast",
    )
    on_cpu = jax.devices()[0].platform == "cpu"
    results = {
        "methodology": (
            "Batched inversions are data-parallel by construction: the "
            "compiled dp program is checked below for cross-device "
            "collectives.  Timing N virtual CPU devices on one host is "
            "meaningless (they share the same physical cores) and is not "
            "reported."
        ),
    }
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev_total]
    for nd in sizes:
        mesh = make_mesh(nd, ("data",))
        fn = data_parallel_inverse(p, mesh, "packed")
        d = jnp.asarray(digits)
        s = jnp.asarray(signs)
        compiled = fn.lower(d, s).compile()
        hlo = compiled.as_text()
        n_coll = sum(hlo.count(op) for op in collectives)
        entry = {"collective_ops_in_hlo": n_coll}
        if not on_cpu:
            out = compiled(d, s)
            jax.block_until_ready(out)
            t0 = time.time()
            for _ in range(args.reps):
                out = compiled(d, s)
            jax.block_until_ready(out)
            _ = np.asarray(out).ravel()[0]
            elapsed = time.time() - t0
            entry["inversions_per_s"] = round(args.batch * args.reps / elapsed, 1)
        results[f"devices={nd}"] = entry
        print(nd, entry)
    if all(
        results[f"devices={nd}"]["collective_ops_in_hlo"] == 0 for nd in sizes
    ):
        results["scaling_by_construction"] = (
            "zero collectives at every mesh size: aggregate rate = "
            "per-chip rate x N"
        )
    write_result("scaling", results)


def main():
    global RESULTS_DIR
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None,
                    help="force a jax platform (e.g. 'cpu')")
    ap.add_argument("--results-dir", default=RESULTS_DIR,
                    help="where the JSON results are written")
    ap.add_argument("--host-devices", type=int, default=None,
                    help="virtual host device count (cpu platform)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("precision")
    pr.add_argument("--N", type=int, default=10000)
    pr.add_argument("--sizes", default="2,3,4,5,10")
    pr.add_argument("--presets", default="low,medium,medium+,high")
    pr.add_argument("--batch", type=int, default=4096)
    th = sub.add_parser("throughput")
    th.add_argument("--batch", type=int, default=262144)
    th.add_argument("--reps", type=int, default=10)
    sc = sub.add_parser("scaling")
    sc.add_argument("--batch", type=int, default=65536)
    sc.add_argument("--reps", type=int, default=3)
    ee = sub.add_parser("e2e")
    ee.add_argument("--n", type=int, default=4)
    ee.add_argument("--preset", default="high")
    ee.add_argument("--batch", type=int, default=262144)
    ee.add_argument("--nbatches", type=int, default=8)
    ee.add_argument("--depth", type=int, default=2)
    ee.add_argument("--repeats", type=int, default=3)
    ee.add_argument("--finish-workers", type=int, default=2)
    ee.add_argument("--native-only", action="store_true")
    fu = sub.add_parser("fused")
    fu.add_argument("--sizes", default="2,3,4,5")
    fu.add_argument("--preset", default="high")
    fu.add_argument("--batch", type=int, default=1048576)
    fu.add_argument("--reps", type=int, default=10)
    fu.add_argument("--repeats", type=int, default=3)
    fu.add_argument("--blocks", default=None,
                    help="comma list of kernel blocks to sweep (default: per-n)")
    fu.add_argument("--warps", default=None,
                    help="comma list of num_warps to sweep (default: per-n)")
    fu.add_argument("--tracked", action="store_true",
                    help="also measure overflow-tracked fused + unroll")
    lo = sub.add_parser("lowering")
    lo.add_argument("--sizes", default="4,5,6,8,10")
    lo.add_argument("--lowerings", default="scan,unroll")
    lo.add_argument("--preset", default="high")
    lo.add_argument("--batch", type=int, default=65536)
    lo.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    RESULTS_DIR = args.results_dir
    if args.host_devices:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.host_devices}"
        )
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    {
        "precision": cmd_precision,
        "throughput": cmd_throughput,
        "scaling": cmd_scaling,
        "lowering": cmd_lowering,
        "fused": cmd_fused,
        "e2e": cmd_e2e,
    }[args.cmd](args)


if __name__ == "__main__":
    main()
