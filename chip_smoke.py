#!/usr/bin/env python3
"""On-card smoke test of the batched QFloat inverse, through the user API.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the data-parallel path
                                       # and the one-card result it must equal

One-card phases, all in this one process:

* ``main``     BatchedMatrixInversion, n=4 High, 1,048,576 float matrices in
               and float inverses out (default ``lowering="auto"``, which
               picks the fused Triton kernel); its compiled program must
               hold the Triton custom call.
* ``exact``    fused == XLA ``unroll`` on the card for n=2 Low, n=4 High and
               n=5 High, over 65,536 rows each,
               singular and near-singular rows included; GPU ``unroll`` ==
               CPU ``unroll`` on 1,024 rows.  Zero tolerance on magnitudes,
               signs and overflow flags.
* ``track``    track_overflow=True at n=4 High, flags == tracked ``unroll``.
* ``stream``   StreamingInverter over 4 batches of 262,144.
* ``single``   EncryptedMatrixInversion(3, ...) once, as the README shows.
* ``sizes``    n=2 Low and n=5 High at 262,144 through auto, each against
               the other lowering.  ``--n10`` adds n=10 High at 131,072
               through auto (``vec``; its cold compile alone takes ~5 min,
               PERF.md).  The fused kernels are not compared at n=10: by
               their op counts they would compile for hours.
* ``gpu tests`` the ``gpu``-marked tests (tests/test_gpu.py), among them
               pair_math.div_float compiled by Triton on the division floor
               boundary cases, exact against numpy.

Each configuration prints its compile seconds, ``memory_analysis()``, the
mean absolute error against ``np.linalg.inv`` in float64 on the host (beside
the reference's published value; not a gate) and an inversions/s reading
labelled with the card.  Any failure exits non-zero; success ends with one
JSON line naming the device.  Without a GPU it fails before any phase.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
TRITON_CALL = "__gpu$xla.gpu.triton"
SEED = 0
MAIN_BATCH = 1 << 20   # n=4 High through BatchedMatrixInversion.run
BATCH = 1 << 18        # stream batches, track, n=2 and n=5
N10_BATCH = 1 << 17    # n=10 High, the largest published size
EXACT_ROWS = 1 << 16   # rows compared bit for bit with another lowering
CPU_ROWS = 1024        # rows compared with the CPU backend
DEGENERATE = 128       # singular and near-singular rows at the batch head
SIZES = [("Low", 2, BATCH), ("High", 5, BATCH)]
N10 = [("High", 10, N10_BATCH)]

# mean |QFloat inverse - scipy inverse| the reference publishes for its
# 10,000-matrix precision run (BASELINE.md)
REFERENCE_ERROR = {("low", 2): 8.19e-2, ("high", 4): 8.6e-6,
                   ("high", 5): 1.40e-6, ("high", 10): 1.2e-4}


def card_label():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown card"


def sample(n, batch, seed=SEED, degenerate=0):
    """The reference's sampler, randn * 100; the first ``degenerate`` rows
    are made singular and the next ``degenerate`` nearly singular."""
    import numpy as np

    M = np.random.RandomState(seed).randn(batch, n, n) * 100
    if degenerate:
        d = degenerate
        M[:d, -1] = M[:d, 0] + M[:d, 1 % n]
        M[d:2 * d, -1] = M[d:2 * d, 0] * (1 + 1e-9)
    return M


def mean_error(inverses, M, skip=0):
    import numpy as np

    ref = np.linalg.inv(M[skip:])
    return float(np.mean(np.abs(inverses[skip:] - ref)))


def compile_report(name, compiled, seconds, fused):
    """Print compile time and memory; check that the compiled program holds
    the Triton custom call exactly when the fused kernels should run (no
    interpreter, no XLA fallback)."""
    text = compiled.as_text()
    print(f"[{name}] compile {seconds:.1f} s; triton call: "
          f"{TRITON_CALL in text}; {compiled.memory_analysis()}", flush=True)
    if (TRITON_CALL in text) != fused:
        raise AssertionError(f"{name}: expected the fused kernels: {fused}")


def auto_lowering(n):
    from matrix_inversion_tpu.models.inverse import _resolve_lowering

    return _resolve_lowering("auto", n, packed_ok=True)


def rate(name, step, args, batch, card, reps=10):
    """Inversions/s from chains of ``reps`` and ``2*reps`` calls; their
    difference also shows any fixed per-chain sync cost."""
    import jax

    jax.block_until_ready(step(*args))
    times = {}
    for r in (reps, 2 * reps):
        t0 = time.perf_counter()
        out = None
        for _ in range(r):
            out = step(*args)
        jax.block_until_ready(out)
        times[r] = time.perf_counter() - t0
    per_rep = (times[2 * reps] - times[reps]) / reps
    fixed = times[reps] - reps * per_rep
    print(f"[{name}] {batch / (times[2 * reps] / (2 * reps)):.6g} inversions/s "
          f"on {card} ({2 * reps} calls of {batch}); marginal "
          f"{batch / per_rep:.6g}/s, fixed cost per chain {fixed * 1e3:.3f} ms",
          flush=True)


def device_args(inv, M):
    import jax
    import jax.numpy as jnp

    a, b = inv.quantize(M)
    return (jax.device_put(jnp.asarray(a, jnp.int64)),
            jax.device_put(jnp.asarray(b, jnp.int64)))


def packed_fn(p, lowering, track=False):
    import jax
    from matrix_inversion_tpu.models.inverse import (
        qfloat_matrix_inverse_packed_io,
        qfloat_matrix_inverse_with_overflow,
    )

    body = (qfloat_matrix_inverse_with_overflow if track
            else qfloat_matrix_inverse_packed_io)
    return jax.jit(functools.partial(
        body, n=p.n, qfloat_len=p.qfloat_len, qfloat_ints=p.qfloat_ints,
        qfloat_base=p.qfloat_base, true_division=p.true_division,
        lowering=lowering,
    ))


def assert_same(name, got, ref):
    import numpy as np

    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = np.asarray(g), np.asarray(r)
        if g.shape != r.shape or not np.array_equal(g, r):
            bad = int(np.sum(g != r)) if g.shape == r.shape else "shape"
            raise AssertionError(f"{name}: output {i} differs ({bad})")
    print(f"[{name}] bit-exact over {np.asarray(ref[0]).shape[0]} rows",
          flush=True)


def batched(name, p, batch, card, M, skip=0):
    """BatchedMatrixInversion.run on float matrices: compile report, error,
    rate.  Returns the API object, its device inputs and raw outputs, and
    the lowering auto picked."""
    import numpy as np
    from matrix_inversion_tpu.runtime.api import BatchedMatrixInversion

    lowering = auto_lowering(p.n)
    t0 = time.perf_counter()
    inv = BatchedMatrixInversion(p, batch, backend="packed", io="packed")
    compile_report(f"{name} ({lowering})", inv.circuit,
                   time.perf_counter() - t0, lowering == "fused")
    out = inv.run(M)
    assert out.shape == M.shape and np.all(np.isfinite(out)), name
    key = ("high" if p.true_division else "low", p.n)
    print(f"[{name}] mean abs error vs np.linalg.inv {mean_error(out, M, skip):.3e}"
          f" (reference publishes {REFERENCE_ERROR.get(key, 'n/a')})",
          flush=True)
    args = device_args(inv, M)
    rate(name, inv.run_raw, args, batch, card)
    return inv, args, inv.run_raw(*args), lowering


def exact_vs(name, p, lowering, raw, args, rows=None):
    """Rows [:rows] of ``raw`` against ``lowering`` on the card."""
    import jax

    rows = rows or EXACT_ROWS
    ref_fn = packed_fn(p, lowering)
    sl = tuple(a[:rows] for a in args)
    t0 = time.perf_counter()
    ref = jax.block_until_ready(ref_fn(*sl))
    print(f"[{name}] {lowering} compile+run {time.perf_counter() - t0:.1f} s",
          flush=True)
    assert_same(name, [o[:rows] for o in raw], ref)
    return ref


def phase_main(card, state):
    from matrix_inversion_tpu import HIGH

    p = HIGH.replace(n=4)
    M = sample(4, MAIN_BATCH, degenerate=DEGENERATE)
    inv, args, raw, _ = batched("main n=4 High", p, MAIN_BATCH, card, M,
                                skip=2 * DEGENERATE)
    state.update(main_p=p, main_M=M, main_out=inv.dequantize(raw),
                 main_args=args, main_raw=raw)


def phase_exact_n4(card, state):
    import jax

    p, args, raw = state["main_p"], state["main_args"], state["main_raw"]
    ref = exact_vs("exact n=4 High fused/unroll", p, "unroll", raw, args)
    # the card against the CPU semantics the test suite pins
    cpu = jax.devices("cpu")[0]
    sl = [jax.device_put(a[:CPU_ROWS], cpu) for a in args]
    host = packed_fn(p, "unroll")(*sl)
    assert_same("exact n=4 High unroll gpu/cpu",
                [r[:CPU_ROWS] for r in ref], host)


def phase_track(card, state):
    import numpy as np
    from matrix_inversion_tpu.runtime.api import BatchedMatrixInversion

    p, M = state["main_p"], state["main_M"][:BATCH]
    t0 = time.perf_counter()
    inv = BatchedMatrixInversion(p, BATCH, backend="packed", io="packed",
                                 track_overflow=True)
    compile_report("track n=4 High", inv.circuit, time.perf_counter() - t0,
                   auto_lowering(p.n) == "fused")
    out, flags = inv.run(M)
    np.testing.assert_array_equal(out, state["main_out"][:BATCH])
    args = device_args(inv, M)
    raw = inv.run_raw(*args)
    ref = packed_fn(p, "unroll", track=True)(*(a[:EXACT_ROWS] for a in args))
    assert_same("exact n=4 High tracked fused/unroll",
                [o[:EXACT_ROWS] for o in raw], ref)
    print(f"[track n=4 High] {int(np.sum(flags))} of {len(flags)} rows "
          "flag overflow", flush=True)
    rate("track n=4 High", inv.run_raw, args, BATCH, card)


def phase_stream(card, state):
    import numpy as np
    from matrix_inversion_tpu.runtime.api import BatchedMatrixInversion
    from matrix_inversion_tpu.runtime.stream import StreamingInverter

    p, M = state["main_p"], state["main_M"]
    batch = MAIN_BATCH // 4
    t0 = time.perf_counter()
    inv = BatchedMatrixInversion(p, batch, backend="packed", io="packed")
    compile_report("stream n=4 High", inv.circuit, time.perf_counter() - t0,
                   auto_lowering(p.n) == "fused")
    batches = [M[i * batch:(i + 1) * batch] for i in range(4)]
    t0 = time.perf_counter()
    outs = list(StreamingInverter(inv).run(batches))
    elapsed = time.perf_counter() - t0
    np.testing.assert_array_equal(np.concatenate(outs), state["main_out"])
    print(f"[stream n=4 High] 4 x {batch} float matrices in, inverses out: "
          f"{4 * batch / elapsed:.6g} inversions/s on {card} (host marshalling "
          "included, first pass)", flush=True)


def phase_single(card, state):
    import numpy as np
    import matrix_inversion_tpu as mi

    rng = np.random.RandomState(SEED)
    sampler = lambda: rng.randn(3, 3) * 100
    t0 = time.perf_counter()
    inv = mi.EncryptedMatrixInversion(3, sampler)
    compile_report("single n=3", inv.circuit, time.perf_counter() - t0,
                   auto_lowering(3) == "fused")
    M = sampler()
    out = inv.run(M)
    err = float(np.mean(np.abs(out - np.linalg.inv(M))))
    print(f"[single n=3] mean abs error {err:.3e}", flush=True)
    assert err < 1e-2, err


def phase_sizes(card, state, sizes=None):
    """Each size through auto, bit-exact against the other lowering (the
    fused kernels against ``unroll``); n=10 is not compared."""
    from matrix_inversion_tpu import HIGH, LOW

    for pname, n, batch in sizes or SIZES:
        name = f"n={n} {pname}"
        preset = {"Low": LOW, "High": HIGH}[pname]
        p = preset.replace(n=n)
        M = sample(n, batch, seed=SEED + n, degenerate=DEGENERATE)
        _, args, raw, lowering = batched(name, p, batch, card, M,
                                         skip=2 * DEGENERATE)
        if n >= 10:
            print(f"[{name}] not compared with the fused kernels", flush=True)
            continue
        other = "fused" if lowering != "fused" else "unroll"
        exact_vs(f"exact {name} {lowering}/{other}", p, other, raw, args)


def phase_gpu_tests(card, state):
    import pytest

    rc = pytest.main([
        "-q", "-p", "no:cacheprovider", "--noconftest", "-m", "gpu",
        os.path.join(REPO, "tests", "test_gpu.py"),
    ])
    if rc != 0:
        raise AssertionError(f"gpu tests failed (pytest exit {rc})")


def four_cards(card):
    """The data-parallel fused path on 4 cards vs one card, bit for bit."""
    import jax
    from matrix_inversion_tpu import HIGH
    from matrix_inversion_tpu.runtime.api import BatchedMatrixInversion

    assert len(jax.devices()) == 4, jax.devices()
    p = HIGH.replace(n=4)
    batch = 4 * BATCH
    M = sample(4, batch, degenerate=DEGENERATE)
    t0 = time.perf_counter()
    # auto data_parallel: shard_map around the fused kernel, one per card
    inv = BatchedMatrixInversion(p, batch, backend="packed", io="packed")
    compile_report("4 cards n=4 High", inv.circuit, time.perf_counter() - t0,
                   True)
    args = device_args(inv, M)
    out = inv.run_raw(*args)
    assert len(out[0].sharding.device_set) == 4, out[0].sharding
    rate("4 cards n=4 High", inv.run_raw, args, batch, card)

    # the one-card result: unroll on card 0 — the program the one-card run
    # proves equal to the fused kernels — over every row, in slices of the
    # size that run already compiled (a compile cache may hold it)
    import numpy as np

    dev0 = jax.devices()[0]
    one = packed_fn(p, "unroll")
    refs = [one(*(jax.device_put(a[i:i + EXACT_ROWS], dev0) for a in args))
            for i in range(0, batch, EXACT_ROWS)]
    assert_same("4 cards vs 1 card n=4 High", out,
                [np.concatenate([np.asarray(r[k]) for r in refs])
                 for k in range(2)])


ONE_CARD_PHASES = [
    ("main", phase_main),
    ("exact n=4", phase_exact_n4),
    ("track", phase_track),
    ("stream", phase_stream),
    ("single", phase_single),
    ("sizes", phase_sizes),
    ("gpu tests", phase_gpu_tests),
]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU data-parallel path and its "
                         "one-card comparison")
    ap.add_argument("--n10", action="store_true",
                    help="also run n=10 High through auto (vec; ~5 min of "
                         "cold compile)")
    args = ap.parse_args()
    if not args.four_cards:
        os.environ["CUDA_VISIBLE_DEVICES"] = "0"

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU, JAX found {dev.platform}")
    sys.path.insert(0, REPO)
    from matrix_inversion_tpu.runtime import native

    card = card_label()
    print(card, flush=True)
    print(f"jax {jax.__version__}, devices {jax.devices()}", flush=True)

    failures = []
    try:
        print(f"native marshalling built: {native.build()}", flush=True)
    except (RuntimeError, subprocess.CalledProcessError) as exc:
        failures.append("native build")
        print(f"native build failed: {exc}", flush=True)
    print(f"marshalling native: {native.available()}", flush=True)
    if args.four_cards:
        phases = [("four cards", lambda c, s: four_cards(c))]
    else:
        phases = list(ONE_CARD_PHASES)
        if args.n10:
            phases.append(("n=10", functools.partial(phase_sizes, sizes=N10)))

    state = {}
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn(card, state)
        except Exception:  # report every phase, then fail the run
            failures.append(name)
            traceback.print_exc()
        print(f"--- phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    if failures:
        sys.exit(f"chip_smoke: failed phases: {failures}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))


if __name__ == "__main__":
    main()
