"""uint32-pair division/multiply routines (ops/pair_math.py) — the code the
fused kernel runs — bit-exact against the int64 XLA paths and numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from matrix_inversion_tpu.ops import pair_math as pm
from pair_cases import adversarial_pairs


def _pairs(x):
    return pm.split64(jnp.asarray(x, jnp.int64))


def _int64(hi, lo):
    return np.asarray(pm.join64(hi, lo).astype(jnp.int64))


@pytest.mark.parametrize("bits", [1, 2])
@pytest.mark.parametrize("n", [17, 1024, 5000])
def test_division_parity(rng, bits, n):
    n_digits = 60 // bits
    maxv = 1 << (n_digits * bits)
    dividend = rng.randint(0, maxv, size=n).astype(np.int64)
    divisor = rng.randint(0, 1 << 40, size=n).astype(np.int64)
    divisor[:3] = 0  # include saturation cases
    q = _int64(*pm.div_classic(*_pairs(dividend), *_pairs(divisor),
                               n_digits, bits))
    nz = divisor != 0
    np.testing.assert_array_equal(q[nz], dividend[nz] // divisor[nz])
    np.testing.assert_array_equal(q[~nz], np.full(np.sum(~nz), maxv - 1))


def test_division_scalar_dividend(rng):
    # the invert() case: one constant dividend against a batch of divisors
    n_digits, bits = 61, 1
    divisor = rng.randint(1, 1 << 40, size=300).astype(np.int64)
    dividend = np.full_like(divisor, 1 << 60)
    q = _int64(*pm.div_classic(*_pairs(dividend), *_pairs(divisor),
                               n_digits, bits))
    np.testing.assert_array_equal(q, (1 << 60) // divisor)


def test_packed_division_has_no_pallas_call(rng):
    """Packed division at a large batch stays plain XLA: no kernel call."""
    from matrix_inversion_tpu.ops.packed import PackedQFloat

    d1 = rng.randint(0, 2, size=(4200, 23))
    d2 = rng.randint(0, 2, size=(4200, 23))
    d2[:, :12] = 0
    s = np.ones(4200, dtype=np.int64)

    def divide(x, y):
        a = PackedQFloat.from_digits(x, 9, 2, s)
        b = PackedQFloat.from_digits(y, 9, 2, s)
        return (a / b).to_digits()

    jaxpr = str(jax.make_jaxpr(divide)(d1, d2))
    assert "pallas_call" not in jaxpr
    assert jnp.asarray(divide(d1, d2)).shape == (4200, 23)


@pytest.mark.parametrize(
    "a_fmt,b_fmt,out_fmt",
    [
        ((16, 40), (16, 40), (16, 40)),   # High dot product
        ((16, 40), (0, 40), (16, 40)),    # mul by reciprocal
        ((9, 23), (9, 23), (9, 23)),      # Low dot product
        ((9, 23), (9, 23), (21, 21)),     # widened 2x2 intermediate
    ],
)
@pytest.mark.parametrize("n", [64, 4096])
def test_mul_window_parity(rng, a_fmt, b_fmt, out_fmt, n):
    """pair_math.mul_window == XLA _mul_window_packed, bit for bit."""
    from matrix_inversion_tpu.ops.packed import (
        _mul_window_consts,
        _mul_window_packed,
    )

    (a_ints, a_len), (b_ints, b_len), (newints, newlength) = a_fmt, b_fmt, out_fmt
    a = rng.randint(0, 1 << 62, size=n).astype(np.int64) & ((1 << a_len) - 1)
    b = rng.randint(0, 1 << 62, size=n).astype(np.int64) & ((1 << b_len) - 1)
    a[:2] = 0  # zero operands
    consts = _mul_window_consts(a_ints, a_len, b_ints, b_len, newlength, newints, 1)
    expected = np.asarray(
        _mul_window_packed(
            jnp.asarray(a, jnp.int64), a_ints, a_len,
            jnp.asarray(b, jnp.int64), b_ints, b_len, newlength, newints, 1,
        )
    )
    got = _int64(*pm.mul_window(*_pairs(a), *_pairs(b), consts,
                                (1 << newlength) - 1))
    np.testing.assert_array_equal(expected, got)


def test_mul_window_broadcast(rng):
    # scalar coefficient against a lane vector (the scan-lowering shape)
    from matrix_inversion_tpu.ops.packed import (
        _mul_window_consts,
        _mul_window_packed,
    )

    a = rng.randint(0, 1 << 40, size=(300, 1)).astype(np.int64)
    b = rng.randint(0, 1 << 40, size=(300, 7)).astype(np.int64)
    consts = _mul_window_consts(16, 40, 16, 40, 40, 16, 1)
    expected = np.asarray(
        _mul_window_packed(
            jnp.asarray(a), 16, 40, jnp.asarray(b), 16, 40, 40, 16, 1
        )
    )
    ahi, alo = _pairs(np.broadcast_to(a, b.shape))
    got = _int64(*pm.mul_window(ahi, alo, *_pairs(b), consts, (1 << 40) - 1))
    np.testing.assert_array_equal(expected, got)


def test_mul_group_parity(rng):
    """Grouped multiply-scan (G products per step) is bit-exact for any G."""
    from matrix_inversion_tpu.ops import packed
    from matrix_inversion_tpu.ops.packed import _mul_window_packed

    a = jnp.asarray(rng.randint(0, 1 << 40, size=2000), jnp.int64)
    b = jnp.asarray(rng.randint(0, 1 << 40, size=2000), jnp.int64)
    ref = np.asarray(_mul_window_packed(a, 16, 40, b, 16, 40, 40, 16, 1))
    try:
        for g in (3, 8, 64):
            packed.set_mul_group(g)
            got = np.asarray(
                jax.jit(
                    lambda a, b: _mul_window_packed(a, 16, 40, b, 16, 40, 40, 16, 1)
                )(a, b)
            )
            np.testing.assert_array_equal(ref, got)
    finally:
        packed.set_mul_group(1)


# ---------------------------------------------------------------------------
# float-assisted exact division (f32 estimate + integer fixups)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("divisor_bits,n_bits", [(40, 61), (23, 46), (47, 61)])
def test_float_division_xla_exact(rng, divisor_bits, n_bits):
    from matrix_inversion_tpu.ops import packed as P

    k = P._float_div_chunk_bits(n_bits, divisor_bits)
    assert k >= 4
    n = 4000
    dividend = rng.randint(0, 1 << n_bits, size=n, dtype=np.uint64).astype(np.int64)
    divisor = rng.randint(0, 1 << divisor_bits, size=n, dtype=np.uint64).astype(np.int64)
    divisor[:5] = 0
    dividend[5:8] = 0
    dividend[8] = (1 << n_bits) - 1
    divisor[9] = 1
    av, bv = adversarial_pairs(rng, divisor_bits, n_bits, 500)
    dividend = np.concatenate([dividend, av])
    divisor = np.concatenate([divisor, bv])

    q = np.asarray(P._long_division_float(
        jnp.asarray(dividend), jnp.asarray(divisor), n_bits, k))
    nz = divisor != 0
    np.testing.assert_array_equal(
        q[nz].astype(np.uint64), dividend[nz].astype(np.uint64) // divisor[nz].astype(np.uint64))
    np.testing.assert_array_equal(q[~nz], np.full(np.sum(~nz), (1 << n_bits) - 1))


@pytest.mark.parametrize("divisor_bits,n_bits", [(40, 61), (23, 46)])
def test_float_division_pair_exact(rng, divisor_bits, n_bits):
    from matrix_inversion_tpu.ops import packed as P

    k = P._float_div_chunk_bits(n_bits, divisor_bits)
    n = 2000
    dividend = rng.randint(0, 1 << n_bits, size=n, dtype=np.uint64).astype(np.int64)
    divisor = rng.randint(0, 1 << divisor_bits, size=n, dtype=np.uint64).astype(np.int64)
    divisor[:5] = 0
    av, bv = adversarial_pairs(rng, divisor_bits, n_bits, 400)
    dividend = np.concatenate([dividend, av])
    divisor = np.concatenate([divisor, bv])

    q = _int64(*pm.div_float(*_pairs(dividend), *_pairs(divisor), n_bits, k))
    nz = divisor != 0
    np.testing.assert_array_equal(
        q[nz].astype(np.uint64), dividend[nz].astype(np.uint64) // divisor[nz].astype(np.uint64))
    np.testing.assert_array_equal(q[~nz], np.full(np.sum(~nz), (1 << n_bits) - 1))


def test_float_division_matches_restoring_loop(rng):
    """End-to-end packed division: float lowering == classic loop, bit-exact."""
    from matrix_inversion_tpu.ops import packed as P
    from matrix_inversion_tpu.ops.packed import PackedQFloat

    d1 = rng.randint(0, 2, size=(700, 40))
    d2 = rng.randint(0, 2, size=(700, 40))
    d2[:, :20] = 0
    d2[:4] = 0  # zero divisors saturate
    s1 = rng.choice([-1, 1], size=700).astype(np.int64)
    s2 = rng.choice([-1, 1], size=700).astype(np.int64)

    outs = {}
    for impl in ("classic", "float"):
        P.set_division_impl(impl)
        try:
            a = PackedQFloat.from_digits(d1, 20, 2, s1)
            b = PackedQFloat.from_digits(d2, 20, 2, s2)
            div = a.copy() / b.copy()
            inv = b.invert(1, 40, 0)
            outs[impl] = (np.asarray(div.to_digits()), np.asarray(div.sign),
                          np.asarray(inv.to_digits()), np.asarray(inv.sign))
        finally:
            P.set_division_impl(None)
    for x, y in zip(outs["classic"], outs["float"]):
        np.testing.assert_array_equal(x, y)
