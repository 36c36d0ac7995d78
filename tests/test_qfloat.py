"""QFloat semantics tests — port of reference tests/test_qfloat.py.

Run for BOTH backends.  Where the reference draws 100 random scalars in a
Python loop, we draw the same distribution as one batch (the batched execution
model).  Oracles use absolute error (fixing the reference's weak
``x - y < 0.1`` assertions, see SURVEY.md 2.3).
"""

import numpy as np
import pytest

from matrix_inversion_tpu.core.qfloat import QFloat, SignedBinary, Zero
from matrix_inversion_tpu.ops.packed import PackedQFloat

BASE = 2
SIZE = 32

BACKENDS = [QFloat, PackedQFloat]


def ff(cls, f, size=SIZE, ints=16, base=BASE):
    return cls.from_float(f, size, ints, base)


@pytest.mark.parametrize("cls", BACKENDS)
def test_conversion(rng, cls):
    f = (rng.randint(0, 20000, size=100) - 10000) / 100.0
    qf = ff(cls, f, SIZE, 10)
    np.testing.assert_allclose(qf.to_float(), f, atol=1e-2)


@pytest.mark.parametrize("cls", BACKENDS)
def test_str(cls):
    qf = cls.from_float(13.75, 10, 5, 2)
    assert str(qf) == "01101.11000"
    qf = cls.from_float(-13.75, 10, 5, 2)
    assert str(qf) == "-01101.11000"
    qf = cls.from_float(0, 10, 5, 2)
    assert str(qf) == "00000.00000"
    qf = cls.from_float(1, 10, 5, 2)
    qf._sign = 0
    assert str(qf) == "00000.00000"


@pytest.mark.parametrize("cls", BACKENDS)
def test_sign(rng, cls):
    qf = cls.from_float(0.0, 10, 5, 2)
    assert int(np.asarray(qf.sign)) == 1  # sign of 0 is 1

    f = (rng.randint(0, 20000, size=100) - 10000) / 100.0
    f = np.where(f == 0, 1.0, f)
    qf = ff(cls, f, SIZE, 10)
    np.testing.assert_array_equal(np.asarray(qf.sign), np.sign(f))


@pytest.mark.parametrize("cls", BACKENDS)
def test_add_sub(rng, cls):
    f1 = (rng.randint(0, 20000, size=100) - 10000) / 100.0
    f2 = (rng.randint(0, 20000, size=100) - 10000) / 100.0
    qf1 = ff(cls, f1)
    qf2 = ff(cls, f2)

    np.testing.assert_allclose((2 + qf1).to_float(), 2 + f1, atol=0.1)
    np.testing.assert_allclose((qf1 + 2).to_float(), 2 + f1, atol=0.1)
    np.testing.assert_allclose(
        (SignedBinary(1) + qf1).to_float(), 1 + f1, atol=0.1
    )
    np.testing.assert_allclose((2 - qf1).to_float(), 2 - f1, atol=0.1)
    np.testing.assert_allclose((qf1 - 2).to_float(), f1 - 2, atol=0.1)
    np.testing.assert_allclose(
        (SignedBinary(1) - qf1).to_float(), 1 - f1, atol=0.1
    )
    np.testing.assert_allclose((qf1 + qf2).to_float(), f1 + f2, atol=0.1)
    np.testing.assert_allclose((qf1 - qf2).to_float(), f1 - f2, atol=0.1)
    qf1 += qf2
    np.testing.assert_allclose(qf1.to_float(), f1 + f2, atol=0.1)

    # sign forced to 0 must behave like a 0
    qf1 = ff(cls, f1)
    qf1._sign = np.zeros_like(f1, dtype=np.int64) if f1.ndim else 0
    np.testing.assert_allclose((qf1 + qf2).to_float(), f2, atol=0.1)

    # adding Zero leaves the value unchanged (conscious fix of the
    # reference's `return None`, reference qfloat.py:803-804)
    qf3 = ff(cls, f1)
    qf3 += Zero()
    np.testing.assert_allclose(qf3.to_float(), f1, atol=1e-3)


@pytest.mark.parametrize("cls", BACKENDS)
def test_mul(rng, cls):
    ints = 12
    f1 = (rng.randint(0, 200, size=100) - 100) / 10.0
    f2 = (rng.randint(0, 200, size=100) - 100) / 10.0
    integer = int(rng.randint(-2, 3))
    qf1 = ff(cls, f1, SIZE, ints)
    qf2 = ff(cls, f2, SIZE, ints)

    np.testing.assert_allclose((2 * qf1).to_float(), 2 * f1, atol=0.1)
    np.testing.assert_allclose((qf1 * 2).to_float(), 2 * f1, atol=0.1)
    np.testing.assert_allclose((SignedBinary(1) * qf1).to_float(), f1, atol=0.1)
    np.testing.assert_allclose((qf1 * qf2).to_float(), f1 * f2, atol=0.1)
    np.testing.assert_allclose((integer * qf2).to_float(), integer * f2, atol=0.1)
    np.testing.assert_allclose(
        cls.from_mul(qf1, qf2).to_float(), f1 * f2, atol=0.1
    )
    qf1 *= qf2
    np.testing.assert_allclose(qf1.to_float(), f1 * f2, atol=0.1)

    qf1 = ff(cls, f1, SIZE, ints)
    qf1._sign = np.zeros_like(f1, dtype=np.int64)
    np.testing.assert_array_equal((qf1 * qf2).to_float(), np.zeros_like(f1))

    # cross-format crop case (reference tests/test_qfloat.py:137-143)
    f1 = rng.randint(1, 100, size=50) / 1.0
    f2 = rng.randint(1, 10000, size=50) / 10000000.0
    qf1 = cls.from_float(f1, 18, 18, 2)
    qf2 = cls.from_float(f2, 25, 0, 2)
    np.testing.assert_allclose(
        cls.from_mul(qf1, qf2, 18, 1).to_float(), f1 * f2, atol=0.1
    )


@pytest.mark.parametrize(
    "cls",
    [pytest.param(BACKENDS[0], id="QFloat", marks=pytest.mark.slow),
     BACKENDS[1]],
)
def test_div(rng, cls):
    ints = 12
    f1 = (rng.randint(0, 200, size=100) - 100) / 10.0
    f2 = (rng.randint(0, 200, size=100) - 100) / 10.0
    f1 = np.where(f1 == 0, 1.0, f1)
    f2 = np.where(f2 == 0, 1.0, f2)
    qf1 = ff(cls, f1, SIZE, ints)
    qf2 = ff(cls, f2, SIZE, ints)

    np.testing.assert_allclose(
        (SignedBinary(1) / qf1).to_float(), 1.0 / f1, atol=0.1
    )
    np.testing.assert_allclose(
        (SignedBinary(-1) / qf1).to_float(), -1.0 / f1, atol=0.1
    )
    # dividing by (Signed)0 overflows
    assert np.all(np.abs((qf1 / SignedBinary(0)).to_float()) > 1000)

    newlen, newints = 35, 11
    np.testing.assert_allclose(
        qf1.invert(1, newlen, newints).to_float(), 1.0 / f1, atol=0.1
    )
    np.testing.assert_allclose((qf1 / qf2).to_float(), f1 / f2, atol=0.1)


@pytest.mark.parametrize("cls", BACKENDS)
def test_abs(rng, cls):
    f1 = (rng.randint(0, 200, size=100) - 100) / 10.0
    qf1 = ff(cls, f1, SIZE, 12)
    np.testing.assert_allclose(abs(qf1).to_float(), np.abs(f1), atol=0.1)


def test_tidy(rng):
    # mixed-sign untidy arrays (limb backend only — packed is always tidy)
    for _ in range(20):
        size, ints = SIZE, int(rng.randint(SIZE // 2 - 2, SIZE // 2 + 2))
        arr = np.zeros(size)
        i1, i2 = size // 4, 3 * (size // 4)
        arr[i1:i2] = rng.randint(-4 * BASE, 4 * BASE, i2 - i1)
        qf = QFloat(arr, ints, BASE, False)
        f = float(qf.to_float())
        qf.tidy()
        assert abs(f - float(qf.to_float())) <= 1e-4
        assert int(np.asarray(qf.sign)) == (np.sign(f) or 1)


@pytest.mark.parametrize("cls", BACKENDS)
def test_ge(rng, cls):
    f1 = (rng.randint(0, 20, size=100) - 10) / 10.0
    f2 = (rng.randint(0, 20, size=100) - 10) / 10.0
    qf1 = ff(cls, f1, SIZE, 12)
    qf2 = ff(cls, f2, SIZE, 12)
    np.testing.assert_array_equal(
        np.asarray(qf1 >= qf2).astype(int), (f1 >= f2).astype(int)
    )


@pytest.mark.parametrize("cls", BACKENDS)
def test_zero_one_factories(cls):
    z = cls.zero(16, 8, 2)
    assert float(np.asarray(z.to_float())) == 0.0
    o = cls.one(16, 8, 2)
    assert float(np.asarray(o.to_float())) == 1.0
    z2 = cls.zero_like(o)
    assert float(np.asarray(z2.to_float())) == 0.0
    o2 = cls.one_like(z)
    assert float(np.asarray(o2.to_float())) == 1.0


@pytest.mark.parametrize("cls", BACKENDS)
def test_set_len_ints(rng, cls):
    f = (rng.randint(0, 2000, size=20) - 1000) / 100.0
    qf = ff(cls, f, SIZE, 16)
    qf.set_len_ints(40, 20)
    assert len(qf) == 40 and qf.ints == 20
    np.testing.assert_allclose(qf.to_float(), f, atol=1e-2)
    qf.set_len_ints(24, 12)
    np.testing.assert_allclose(qf.to_float(), f, atol=1e-2)
