"""Native marshalling library: bit-exactness vs the numpy reference path."""

from pathlib import Path

import numpy as np
import pytest

from matrix_inversion_tpu.runtime import native
from matrix_inversion_tpu.ops import radix

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def built_lib():
    if not native.available():
        try:
            native.build()
        except RuntimeError as exc:  # no compiler on this host
            pytest.skip(str(exc))
    assert native.available()


def test_library_path_is_stamped():
    """The loader only looks in a directory keyed to host and source."""
    import hashlib
    import platform

    path = Path(native.library_path())
    digest = hashlib.sha256(
        (REPO / "native" / "qmarshal.cc").read_bytes()
    ).hexdigest()[:12]
    assert path.parent.parent == REPO / "native" / "build"
    assert path.parent.name == (
        f"{platform.node()}-{platform.machine()}-{digest}"
    )


def test_quantize_digits_exact(rng):
    f = rng.standard_normal(5000) * 1000
    f[0] = 0.0
    dn, sn = native.quantize_digits(f, 40, 20, 2)
    dr, sr = radix.float_to_digits_and_sign(f, 40, 20, 2)
    np.testing.assert_array_equal(dn, dr)
    np.testing.assert_array_equal(sn, sr)


@pytest.mark.parametrize("base", [2, 16])
def test_quantize_packed_exact(rng, base):
    length, ints = (40, 20) if base == 2 else (12, 6)
    f = rng.standard_normal(5000) * 1000
    mn, sn = native.quantize_packed(f, length, ints, base)
    dr, sr = radix.float_to_digits_and_sign(f, length, ints, base)
    mr = radix.pack_digits(dr, base)
    np.testing.assert_array_equal(mn, mr)
    np.testing.assert_array_equal(sn, sr)


def test_dequantize_digits_exact(rng):
    digits = rng.randint(0, 2, size=(5000, 23)).astype(np.int32)
    signs = rng.choice([-1, 1], size=5000).astype(np.int32)
    arr = np.concatenate([digits, signs[:, None]], axis=-1)
    out_n = native.dequantize_digits(arr, 23, 9, 2)
    out_r = radix.digits_and_sign_to_float(digits, signs, 9, 2)
    np.testing.assert_array_equal(out_n, out_r)


def test_pack_digits_exact(rng):
    digits = rng.randint(0, 2, size=(5000, 40)).astype(np.int32)
    np.testing.assert_array_equal(
        native.pack_digits(digits, 2), radix.pack_digits(digits, 2)
    )


def test_dequantize_packed(rng):
    mags = rng.randint(0, 2 ** 40, size=5000).astype(np.int64)
    signs = rng.choice([-1, 1], size=5000).astype(np.int64)
    out = native.dequantize_packed(mags, signs, 40, 20, 2)
    expected = mags.astype(np.float64) * 2.0 ** -20 * signs
    np.testing.assert_array_equal(out, expected)


def test_radix_dispatches_to_native(rng):
    # above the size threshold the public converters hit the native path
    # and must agree with the pure numpy implementation exactly
    f = rng.standard_normal(6000) * 100
    dn, sn = radix.float_to_digits_and_sign(f, 31, 16, 2)  # native path
    ds, ss = radix.float_to_digits_and_sign(f[:100], 31, 16, 2)  # numpy path
    np.testing.assert_array_equal(dn[:100], ds)
    np.testing.assert_array_equal(sn[:100], ss)
