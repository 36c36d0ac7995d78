"""Bit-exactness of the packed int64 backend vs the limb backend.

The packed backend is the performance path; these property tests prove
it reproduces the digit-array semantics EXACTLY (same digits, same signs)
across every operation, including the cropping corner cases that make
``from_mul``/``invert`` non-value-functions.
"""

import numpy as np
import pytest

from matrix_inversion_tpu.core.qfloat import QFloat, SignedBinary
from matrix_inversion_tpu.ops.packed import PackedQFloat


def rand_pair(rng, B=64, length=23, ints=9, base=2):
    digits1 = rng.randint(0, base, size=(B, length))
    digits2 = rng.randint(0, base, size=(B, length))
    signs1 = rng.choice([-1, 1], size=B)
    signs2 = rng.choice([-1, 1], size=B)
    limb1 = QFloat(digits1, ints, base, True, signs1)
    limb2 = QFloat(digits2, ints, base, True, signs2)
    pk1 = PackedQFloat.from_digits(digits1, ints, base, signs1)
    pk2 = PackedQFloat.from_digits(digits2, ints, base, signs2)
    return (limb1, limb2), (pk1, pk2)


def assert_same(limb_qf, packed_qf):
    np.testing.assert_array_equal(
        np.asarray(limb_qf.array), np.asarray(packed_qf.to_digits())
    )
    np.testing.assert_array_equal(
        np.broadcast_to(np.asarray(limb_qf.sign), limb_qf.bshape),
        np.broadcast_to(np.asarray(packed_qf.sign), packed_qf.bshape),
    )


@pytest.mark.parametrize("base", [2, 4])
def test_add_parity(rng, base):
    (l1, l2), (p1, p2) = rand_pair(rng, base=base)
    assert_same(l1 + l2, p1 + p2)
    assert_same(l1 - l2, p1 - p2)
    assert_same(l1 + 3, p1 + 3)
    assert_same(l1 + SignedBinary(-1), p1 + SignedBinary(-1))


@pytest.mark.parametrize("base", [2, 4])
def test_compare_parity(rng, base):
    (l1, l2), (p1, p2) = rand_pair(rng, base=base)
    np.testing.assert_array_equal(np.asarray(l1 > l2), np.asarray(p1 > p2))
    np.testing.assert_array_equal(np.asarray(l1 >= l2), np.asarray(p1 >= p2))
    np.testing.assert_array_equal(np.asarray(l1 == l2), np.asarray(p1 == p2))


@pytest.mark.parametrize("base", [2, 4])
def test_mul_parity(rng, base):
    (l1, l2), (p1, p2) = rand_pair(rng, base=base)
    assert_same(QFloat.from_mul(l1, l2), PackedQFloat.from_mul(p1, p2))
    assert_same(l1 * l2, p1 * p2)
    assert_same(l1 * 5, p1 * 5)
    assert_same(l1 * SignedBinary(-1), p1 * SignedBinary(-1))


@pytest.mark.parametrize(
    "fmt",
    [
        # (len1, ints1, len2, ints2, newlen, newints) crop corner cases
        (23, 9, 23, 9, 23, 9),
        (18, 18, 25, 0, 18, 1),
        (23, 9, 23, 9, 21, 18),
        (16, 2, 16, 14, 30, 7),
        (23, 9, 23, 9, 46, 4),
    ],
)
def test_from_mul_crop_parity(rng, fmt):
    l1len, l1i, l2len, l2i, nl, ni = fmt
    d1 = rng.randint(0, 2, size=(32, l1len))
    d2 = rng.randint(0, 2, size=(32, l2len))
    s1 = rng.choice([-1, 1], size=32)
    s2 = rng.choice([-1, 1], size=32)
    l1, l2 = QFloat(d1, l1i, 2, True, s1), QFloat(d2, l2i, 2, True, s2)
    p1 = PackedQFloat.from_digits(d1, l1i, 2, s1)
    p2 = PackedQFloat.from_digits(d2, l2i, 2, s2)
    assert_same(QFloat.from_mul(l1, l2, nl, ni), PackedQFloat.from_mul(p1, p2, nl, ni))


@pytest.mark.parametrize(
    "base", [2, pytest.param(4, marks=pytest.mark.slow)]
)
def test_div_parity(rng, base):
    # base 4 at full width would need a >62-bit dividend; use a narrower
    # encoding there (the auto backend select makes the same decision)
    length, ints = (23, 9) if base == 2 else (14, 6)
    (l1, l2), (p1, p2) = rand_pair(rng, B=32, length=length, ints=ints, base=base)
    assert_same(l1 / l2, p1 / p2)  # includes zero divisors by chance
    assert_same(l1 / SignedBinary(0), p1 / SignedBinary(0))
    assert_same(l1 / SignedBinary(-1), p1 / SignedBinary(-1))


@pytest.mark.slow
def test_div_by_zero_parity(rng):
    # force zero divisors: saturation must match digit for digit
    d1 = rng.randint(0, 2, size=(8, 23))
    z = np.zeros((8, 23), dtype=int)
    l1 = QFloat(d1, 9, 2, True, 1)
    lz = QFloat(z, 9, 2, True, 1)
    p1 = PackedQFloat.from_digits(d1, 9, 2, 1)
    pz = PackedQFloat.from_digits(z, 9, 2, 1)
    assert_same(l1 / lz, p1 / pz)
    assert_same(l1.invert(1, 23, 0), p1.invert(1, 23, 0))
    assert_same(lz.invert(1, 23, 0), pz.invert(1, 23, 0))


@pytest.mark.parametrize(
    "fmt",
    [(23, 9, 23, 0)]
    + [pytest.param(f, marks=pytest.mark.slow)
       for f in [(23, 9, 23, 9), (23, 9, 31, 12), (23, 9, 12, 3)]],
)
def test_invert_parity(rng, fmt):
    length, ints, nl, ni = fmt
    d = rng.randint(0, 2, size=(32, length))
    s = rng.choice([-1, 1], size=32)
    l1 = QFloat(d, ints, 2, True, s)
    p1 = PackedQFloat.from_digits(d, ints, 2, s)
    assert_same(l1.invert(1, nl, ni), p1.invert(1, nl, ni))
    assert_same(l1.invert(-1, nl, ni), p1.invert(-1, nl, ni))


def test_set_len_ints_parity(rng):
    for nl, ni in [(30, 12), (16, 4), (23, 15), (40, 9)]:
        d = rng.randint(0, 2, size=(16, 23))
        s = rng.choice([-1, 1], size=16)
        l1 = QFloat(d, 9, 2, True, s)
        p1 = PackedQFloat.from_digits(d, 9, 2, s)
        assert_same(l1.set_len_ints(nl, ni), p1.set_len_ints(nl, ni))


def test_imul_equals_from_mul(rng):
    # reference __imul__ window == from_mul at the same format
    (l1, l2), (p1, p2) = rand_pair(rng)
    ref = QFloat.from_mul(l1.copy(), l2, len(l1), l1.ints)
    via_imul = l1.copy()
    via_imul *= l2
    assert_same(via_imul, ref)
    via_imul_p = p1.copy()
    via_imul_p *= p2
    assert_same(ref, via_imul_p)


def test_iadd_chain_matches_loop(rng):
    """Scanned iadd chain == sequential += loop, including overflow cases."""
    B, L, ints = 64, 23, 9
    digits = [rng.randint(0, 2, size=(B, L)) for _ in range(6)]
    signs = [rng.choice([-1, 1], size=B) for _ in range(6)]
    qs = [PackedQFloat.from_digits(d, ints, 2, s) for d, s in zip(digits, signs)]
    # force overflow on some lanes: all-ones magnitudes
    qs[2]._mag = qs[2]._mag | qs[2]._mask()

    loop = qs[0].copy()
    for q in qs[1:]:
        loop += q
    chained = qs[0].copy().iadd_chain([q.copy() for q in qs[1:]])
    np.testing.assert_array_equal(
        np.asarray(loop.mag), np.asarray(chained.mag)
    )
    np.testing.assert_array_equal(
        np.asarray(loop.sign), np.asarray(chained.sign)
    )
