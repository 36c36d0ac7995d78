"""Circuit entry points: full inverse and the partial pivot/L/U circuits.

Mirrors reference qfloat_matrix_inversion.py:592-720.  These functions are
the jittable bodies: digit/sign tensors in, digit tensors out, with all
QFloat object machinery existing only at trace time.
"""

from __future__ import annotations

import numpy as np

from .marshal import (
    mags_and_signs_to_qfloat_matrix,
    qfloat_arrays_to_qfloat_matrix,
    qfloat_matrix_to_arrays_and_signs,
    qfloat_matrix_to_mags_and_signs,
)
from .qfloat_lu import (
    qfloat_inverse_2x2,
    qfloat_inverse_2x2_multi,
    qfloat_lu_decomposition,
    qfloat_lu_inverse,
    qfloat_pivot_matrix,
)


def _check_shapes(qfloat_arrays, n, qfloat_len):
    assert n * n == qfloat_arrays.shape[-2]
    assert qfloat_len == qfloat_arrays.shape[-1]


def qfloat_matrix_inverse(
    qfloat_arrays,
    qfloat_signs,
    n,
    qfloat_len,
    qfloat_ints,
    qfloat_base,
    true_division,
    tensorize=False,
    backend="limb",
    lowering=None,
):
    """Full inverse circuit body (reference qfloat_matrix_inversion.py:672-720).

    Input: ``(..., n*n, len)`` digit arrays + ``(..., n*n)`` signs.
    Output: ``(..., n*n, len+1)`` digit arrays with the sign appended.
    """
    _check_shapes(qfloat_arrays, n, qfloat_len)
    style = _resolve_lowering(lowering, n, packed_ok=(backend == "packed"))
    if backend != "packed" and lowering in ("scan", "vec", "fused"):
        # the scaled lowerings are built on the packed int64 magnitude
        # representation; a non-power-of-two base (or an encoding too wide
        # for int64) has only the unrolled limb path, whose graph grows
        # O(n^3) — fail loudly rather than silently unrolling
        raise ValueError(
            f"lowering='{lowering}' requires the packed backend (base=2^k "
            f"encoding that fits int64); backend='{backend}' only supports "
            "the 'unroll' lowering. See README 'Lowerings and bases'."
        )
    if backend == "packed" and style == "fused" or (
        backend == "packed" and n >= 3 and style in ("scan", "vec")
    ):
        # pack digits -> magnitudes, run the fixed-size scanned program or
        # the fused Pallas kernel, unpack back to the digit-array output
        # layout (bit-identical to the unrolled object path; see
        # models/qfloat_lu_scan.py and ops/fused_inverse.py)
        import jax.numpy as jnp

        from ..ops.packed import MAG_DTYPE, _digit_bits

        bits = _digit_bits(qfloat_base)
        L = qfloat_len
        place = jnp.asarray(
            [1 << (bits * (L - 1 - j)) for j in range(L)], MAG_DTYPE
        )
        mags = jnp.sum(jnp.asarray(qfloat_arrays, MAG_DTYPE) * place, axis=-1)
        if style == "fused":
            from ..ops.fused_inverse import fused_matrix_inverse as fn

            out_mags, out_signs = fn(
                mags, qfloat_signs, n, L, qfloat_ints, qfloat_base,
                true_division,
            )
        else:
            from .qfloat_lu_scan import (
                qfloat_matrix_inverse_scan,
                qfloat_matrix_inverse_vec,
            )

            fn = (
                qfloat_matrix_inverse_vec
                if style == "vec"
                else qfloat_matrix_inverse_scan
            )
            out_mags, out_signs = fn(
                mags, qfloat_signs, n, L, qfloat_ints, qfloat_base,
                true_division,
            )
        shifts = jnp.asarray([bits * (L - 1 - j) for j in range(L)], MAG_DTYPE)
        digits = (
            (out_mags[..., None] >> shifts) & (qfloat_base - 1)
        ).astype(jnp.int32)
        return jnp.concatenate(
            [digits, out_signs[..., None].astype(jnp.int32)], axis=-1
        )
    qfloat_M = qfloat_arrays_to_qfloat_matrix(
        qfloat_arrays, qfloat_signs, qfloat_ints, qfloat_base, backend
    )

    if n == 2:
        if tensorize:
            qfloat_Minv = qfloat_inverse_2x2_multi(qfloat_M, qfloat_len, qfloat_ints)
        else:
            qfloat_Minv = qfloat_inverse_2x2(qfloat_M, qfloat_len, qfloat_ints)
    else:
        bin_P, qfloat_L, qfloat_U = qfloat_lu_decomposition(
            qfloat_M, qfloat_len, qfloat_ints, true_division, tensorize
        )
        qfloat_Minv = qfloat_lu_inverse(
            bin_P, qfloat_L, qfloat_U, qfloat_len, qfloat_ints, true_division, tensorize
        )

    return qfloat_matrix_to_arrays_and_signs(
        qfloat_Minv, qfloat_len, qfloat_ints, qfloat_base
    )


# Auto lowering policy.  One rule: the lowering with the highest device
# rate measured on the H100; set-up (lower + compile) is reported beside it
# but does not decide.  Measured (H100 80GB HBM3 at 700 W, High preset,
# 1,048,576 rows, one process; PERF.md):
#   n=4  fused 497M inversions/s, set-up 61 s; unroll 211M/s, ~30 s
#   n=5  fused 196M/s, set-up 216 s; unroll 96M/s, 77 s
# A persistent-cache hit does not shorten the fused set-up (loading the
# n=4 program took 54 s), so every process pays it: the fused rate pays
# back its extra set-up only past ~10^10 matrices per process.  Callers
# with less work and no cached program save time with lowering="unroll".
#   fused:  the staged Pallas-Triton kernels (ops/fused_inverse.py), up to
#           the largest n measured.  Single-GPU processes only; several
#           GPUs get the shard_map form via
#           BatchedMatrixInversion(data_parallel) or
#           parallel.mesh.data_parallel_inverse_fused.
#   unroll: every QFloat op traced; compile grows ~n^3;
#   vec:    O(n^2) graph, for mid-size n;
#   scan:   compile nearly flat in n, the only practical choice for huge n.
# UNROLL_MAX_N / VEC_MAX_N are not re-measured on the GPU yet.
FUSED_MAX_N = 5
UNROLL_MAX_N = 8
VEC_MAX_N = 12


def _fused_auto_ok():
    """Auto-pick the fused kernel only where it compiles: the GPU backend
    (Triton; the CPU would run the slow Pallas interpreter) in a
    single-device process (under jit-with-shardings XLA would have to
    partition the custom call; explicit lowering='fused' + shard_map still
    works on several devices)."""
    import jax

    return jax.default_backend() == "gpu" and jax.device_count() == 1


def _resolve_lowering(lowering, n, packed_ok=False):
    if lowering in (None, "auto"):
        if packed_ok and n <= FUSED_MAX_N and _fused_auto_ok():
            return "fused"
        if n <= UNROLL_MAX_N:
            return "unroll"
        if n <= VEC_MAX_N:
            return "vec"
        return "scan"
    return lowering


def qfloat_matrix_inverse_packed_io(
    mags,
    signs,
    n,
    qfloat_len,
    qfloat_ints,
    qfloat_base,
    true_division,
    tensorize=False,
    vectorize_rows=None,
    lowering=None,
):
    """Full inverse with packed I/O: (..., n*n) int64 magnitudes + signs in,
    the same out.

    Production fast path: one magnitude word per cell instead of
    ``qfloat_len`` digit words on both sides of the circuit (40x less I/O
    and no per-cell pack/unpack stage at High precision).  Numerically
    identical to :func:`qfloat_matrix_inverse` on the packed backend.
    ``vectorize_rows`` runs the substitution phase with the output-row loop
    collapsed into a tensor axis (models/qfloat_lu_vec.py) — bit-identical
    results, n times fewer traced ops.  None = auto: on for n >= 6 (compile
    relief), off below.
    ``lowering`` selects "unroll" (trace every op) vs "scan" (fixed-size
    lax.scan program, models/qfloat_lu_scan.py) vs "vec" vs "fused"
    (whole-inversion Triton kernels, ops/fused_inverse.py) — bit-identical
    results; None/"auto" picks by n and platform (``_resolve_lowering``).
    """
    style = _resolve_lowering(lowering, n, packed_ok=True)
    if style == "fused":
        from ..ops.fused_inverse import fused_matrix_inverse

        return fused_matrix_inverse(
            mags, signs, n, qfloat_len, qfloat_ints, qfloat_base, true_division
        )
    if n >= 3 and style in ("scan", "vec"):
        from .qfloat_lu_scan import (
            qfloat_matrix_inverse_scan,
            qfloat_matrix_inverse_vec,
        )

        fn = qfloat_matrix_inverse_vec if style == "vec" else qfloat_matrix_inverse_scan
        return fn(
            mags, signs, n, qfloat_len, qfloat_ints, qfloat_base, true_division
        )
    if vectorize_rows is None:
        vectorize_rows = n >= 6
    assert n * n == mags.shape[-1]
    qfloat_M = mags_and_signs_to_qfloat_matrix(
        mags, signs, qfloat_len, qfloat_ints, qfloat_base
    )
    if n == 2:
        if tensorize:
            qfloat_Minv = qfloat_inverse_2x2_multi(qfloat_M, qfloat_len, qfloat_ints)
        else:
            qfloat_Minv = qfloat_inverse_2x2(qfloat_M, qfloat_len, qfloat_ints)
    else:
        bin_P, qfloat_L, qfloat_U = qfloat_lu_decomposition(
            qfloat_M, qfloat_len, qfloat_ints, true_division, tensorize
        )
        if vectorize_rows:
            from .qfloat_lu_vec import qfloat_lu_inverse_vec

            qfloat_Minv = qfloat_lu_inverse_vec(
                bin_P, qfloat_L, qfloat_U, qfloat_len, qfloat_ints,
                true_division, tensorize,
            )
        else:
            qfloat_Minv = qfloat_lu_inverse(
                bin_P, qfloat_L, qfloat_U, qfloat_len, qfloat_ints,
                true_division, tensorize,
            )
    return qfloat_matrix_to_mags_and_signs(
        qfloat_Minv, qfloat_len, qfloat_ints, qfloat_base
    )


def qfloat_matrix_inverse_with_overflow(
    mags,
    signs,
    n,
    qfloat_len,
    qfloat_ints,
    qfloat_base,
    true_division,
    tensorize=False,
    lowering=None,
):
    """Packed-I/O inverse that also reports a per-matrix overflow flag.

    Implements the reference's open TODO (reference qfloat.py:255-257):
    overflow past the top digit — the documented main big-error source
    (reference README.md:119-121) — is detected at every normalization and
    OR-reduced into one int flag per batch element, so callers can reject
    or retry saturated results instead of silently consuming them.
    Returns ``(out_mags, out_signs, overflowed)``.

    All four lowerings support tracking with bit-identical flags
    (tests/test_overflow.py).  On the fused path the PairQFloat ops record
    into the same scope inside the Pallas kernel and the flag rides out as
    an extra kernel output; its multiplies use the windowed form inside the
    scope (the truncated form cannot expose the dropped carries).
    """
    style = _resolve_lowering(lowering, n, packed_ok=True)
    if style == "fused":
        from ..ops.fused_inverse import fused_matrix_inverse

        return fused_matrix_inverse(
            mags, signs, n, qfloat_len, qfloat_ints, qfloat_base,
            true_division, track=True,
        )
    if n >= 3 and style in ("scan", "vec"):
        from .qfloat_lu_scan import (
            qfloat_matrix_inverse_scan,
            qfloat_matrix_inverse_vec,
        )

        fn = qfloat_matrix_inverse_vec if style == "vec" else qfloat_matrix_inverse_scan
        return fn(
            mags, signs, n, qfloat_len, qfloat_ints, qfloat_base,
            true_division, track=True,
        )
    from ..ops.packed import track_overflow

    with track_overflow() as tracker:
        out_mags, out_signs = qfloat_matrix_inverse_packed_io(
            mags, signs, n, qfloat_len, qfloat_ints, qfloat_base,
            true_division, tensorize, lowering="unroll",
        )
        flag = tracker.combined(mags.shape[:-1])
    return out_mags, out_signs, flag


def qfloat_pivot(qfloat_arrays, qfloat_signs, params, backend="limb"):
    """Pivot-only partial circuit (reference qfloat_matrix_inversion.py:592-609)."""
    [n, qfloat_len, qfloat_ints, qfloat_base, *_] = params
    _check_shapes(qfloat_arrays, n, qfloat_len)
    qfloat_M = qfloat_arrays_to_qfloat_matrix(
        qfloat_arrays, qfloat_signs, qfloat_ints, qfloat_base, backend
    )
    return qfloat_pivot_matrix(qfloat_M)


def qfloat_lu_L(qfloat_arrays, qfloat_signs, params, backend="limb"):
    """PLU partial circuit returning L (reference qfloat_matrix_inversion.py:612-639)."""
    [n, qfloat_len, qfloat_ints, qfloat_base, true_division, *_] = params
    _check_shapes(qfloat_arrays, n, qfloat_len)
    qfloat_M = qfloat_arrays_to_qfloat_matrix(
        qfloat_arrays, qfloat_signs, qfloat_ints, qfloat_base, backend
    )
    _, qfloat_L, _ = qfloat_lu_decomposition(
        qfloat_M, qfloat_len, qfloat_ints, true_division
    )
    return qfloat_matrix_to_arrays_and_signs(
        qfloat_L, qfloat_len, qfloat_ints, qfloat_base
    )


def qfloat_lu_U(qfloat_arrays, qfloat_signs, params, backend="limb"):
    """PLU partial circuit returning U (reference qfloat_matrix_inversion.py:642-669)."""
    [n, qfloat_len, qfloat_ints, qfloat_base, true_division, *_] = params
    _check_shapes(qfloat_arrays, n, qfloat_len)
    qfloat_M = qfloat_arrays_to_qfloat_matrix(
        qfloat_arrays, qfloat_signs, qfloat_ints, qfloat_base, backend
    )
    _, _, qfloat_U = qfloat_lu_decomposition(
        qfloat_M, qfloat_len, qfloat_ints, true_division
    )
    return qfloat_matrix_to_arrays_and_signs(
        qfloat_U, qfloat_len, qfloat_ints, qfloat_base
    )
