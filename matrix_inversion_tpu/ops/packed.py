"""Packed int64 QFloat backend — the fast path of every XLA lowering.

A *base-tidy* QFloat with ``base**len < 2**62`` is uniquely determined by
``(magnitude, sign)`` where ``magnitude = sum_j digit_j * base**(L-1-j)``.
For power-of-two bases this backend reproduces every reference semantic
exactly (verified bit-for-bit against the limb backend in
tests/test_packed_parity.py) while replacing O(L)–O(L^2) digit chains with
O(1)–O(L) int64 scalar ops:

=====================  ===============================  ====================
reference operation     limb cost                        packed cost
=====================  ===============================  ====================
tidy / base_tidy        O(L) sequential carry scan       mask (free)
add (qfloat.py:798)     carry scan + 2 borrow scans      1 add + mask
compare (:711)          O(L) borrow scan                 1 compare
mul (:955 from_mul)     O(L^2) partial products + scan   L shift/mask-accum
divide (:1183/:1263)    O(L^2 (p-1)) subtract-select     L-step int64 loop
=====================  ===============================  ====================

Two semantics notes (why this is exact, not approximate):

* ``from_mul`` crops each partial product to the output window *before*
  summation (reference qfloat.py:997-1010) — not a value function of the
  operands.  We reproduce it term by term with shifts and masks; partial
  sums are accumulated in uint64 (wraparound ≡ mod 2^64) and the final
  ``& mask`` equals the reference's dropped-carry base_tidy because
  ``k * newlength <= 62 < 64``.
* division by an (encrypted) zero saturates the quotient digits to
  ``base-1`` (reference qfloat.py:1204-1209 and base_p_arrays.py:189-201);
  the restoring loop below reproduces that naturally since ``r >= 0`` always
  holds.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.qfloat import (
    QFloatBase,
    SignedBinary,
    Zero,
    Array,
    _is_number_like,
    _sign_of,
    _check_invert_sign,
)
from . import radix

MAG_DTYPE = jnp.int64

# Optional overflow tracking — implements the reference's open TODO
# (reference qfloat.py:255-257, 623-624): overflow past the top digit is
# the reference's main big-error source and is silently dropped there.
# Inside a `track_overflow()` scope, every normalization records whether
# the pre-mask value exceeded the representable range.
_OVERFLOW_TRACKER = None


class OverflowTracker:
    def __init__(self):
        self.flags = []

    def record(self, flag):
        self.flags.append(flag)

    def combined(self, batch_shape=None):
        """OR of all recorded flags, reduced to ``batch_shape``.

        Flags recorded by grouped (stacked) ops carry extra leading axes;
        those are any-reduced away so the result is one flag per batch
        element.
        """
        if not self.flags:
            return jnp.zeros(batch_shape or (), jnp.int32)
        if batch_shape is None:
            batch_shape = min((f.shape for f in self.flags), key=len)
        out = jnp.zeros(batch_shape, jnp.bool_)
        for f in self.flags:
            while f.ndim > len(batch_shape):
                f = jnp.any(f, axis=0)
            out = out | f
        return out.astype(jnp.int32)


class track_overflow:
    """Context manager enabling overflow recording at trace time."""

    def __enter__(self):
        global _OVERFLOW_TRACKER
        self._prev = _OVERFLOW_TRACKER
        _OVERFLOW_TRACKER = OverflowTracker()
        return _OVERFLOW_TRACKER

    def __exit__(self, *exc):
        global _OVERFLOW_TRACKER
        _OVERFLOW_TRACKER = self._prev
        return False


def _digit_bits(base: int) -> int:
    if base < 2 or base & (base - 1):
        raise ValueError("packed backend requires a power-of-two base")
    return base.bit_length() - 1


def _signed_value(mag, sign):
    """``mag * sign`` for ``sign`` in {-1, 0, +1}.

    A 64-bit integer multiply is emulated with several 32-bit ops on
    32-bit integer hardware, so applying a dynamic sign via multiply is
    one of the most expensive elementwise ops in the circuit.  For signs
    restricted to {-1, 0, +1} two selects are value-identical and much
    cheaper.  Static (Python int) signs stay multiplies: XLA folds
    them to a copy/negate.
    """
    if isinstance(sign, (int, float, np.integer)):
        return mag * int(sign)
    mag = jnp.asarray(mag, MAG_DTYPE)
    return jnp.where(sign < 0, -mag, jnp.where(sign == 0, jnp.zeros_like(mag), mag))


class PackedQFloat(QFloatBase):
    """int64-magnitude QFloat (power-of-two bases, ``base**len < 2**62``)."""

    def __init__(self, mag, length, ints=None, base=2, sign=1):
        self._length = int(length)
        if ints is None:
            ints = length // 2
        self._ints = int(ints)
        if not (0 <= self._ints <= self._length):
            raise ValueError("ints must be in range [0, length]")
        self._base = int(base)
        self._bits = _digit_bits(self._base)
        if self._bits * self._length > 62:
            raise ValueError("encoding too wide for the packed backend")
        self._mag = jnp.asarray(mag, dtype=MAG_DTYPE)
        if isinstance(sign, float):
            sign = int(sign)
        self._sign = sign

    # ---- shape / metadata -------------------------------------------------
    def __len__(self):
        return self._length

    @property
    def bshape(self):
        return self._mag.shape

    @property
    def mag(self):
        return self._mag

    @property
    def is_base_tidy(self):
        return True  # packed QFloats are always normalized

    @property
    def encrypted(self):
        return isinstance(self._mag, jax.Array)

    def _mask(self, ndigits=None):
        n = self._length if ndigits is None else ndigits
        return (1 << (self._bits * n)) - 1

    # ---- conversions ------------------------------------------------------
    @classmethod
    def from_float(cls, f, length=10, ints=None, base=2):
        if ints is None:
            ints = length // 2
        digits, sign = radix.float_to_digits_and_sign(f, length, ints, base)
        mag = radix.pack_digits(digits, base)
        if np.ndim(sign) == 0:
            sign = int(sign)
            mag = int(mag)
        return cls(mag, length, ints, base, sign)

    @classmethod
    def from_digits(cls, digits, ints=None, base=2, sign=1):
        """Pack a (device) digit array [..., L] into magnitudes."""
        digits = jnp.asarray(digits, dtype=MAG_DTYPE)
        length = digits.shape[-1]
        bits = _digit_bits(base)
        place = jnp.asarray(
            [1 << (bits * (length - 1 - j)) for j in range(length)], MAG_DTYPE
        )
        mag = jnp.sum(digits * place, axis=-1)
        return cls(mag, length, ints, base, sign)

    def to_digits(self):
        """Unpack magnitudes to a digit array [..., L] (device)."""
        shifts = jnp.asarray(
            [self._bits * (self._length - 1 - j) for j in range(self._length)],
            MAG_DTYPE,
        )
        return (
            (self._mag[..., None] >> shifts) & (self._base - 1)
        ).astype(jnp.int32)

    def to_array(self):
        return self.to_digits()

    def to_float(self):
        frac = self._length - self._ints
        scale = float(self._base) ** (-frac)
        return np.asarray(self._mag, dtype=np.float64) * scale * np.asarray(
            self._sign, dtype=np.float64
        )

    def to_limb(self):
        """Convert to the digit-array backend (for parity tests / any-base ops)."""
        from ..core.qfloat import QFloat

        return QFloat(self.to_digits(), self._ints, self._base, True, self._sign)

    def to_str(self, tidy=True):
        return self.to_limb().to_str(tidy)

    def __str__(self):
        return self.to_str(True)

    # ---- factories --------------------------------------------------------
    @classmethod
    def zero(cls, length, ints, base, bshape=()):
        return cls(jnp.zeros(bshape, MAG_DTYPE), length, ints, base, 1)

    @classmethod
    def zero_like(cls, other):
        return cls.zero(len(other), other.ints, other.base, other.bshape)

    @classmethod
    def one(cls, length, ints, base, bshape=()):
        bits = _digit_bits(base)
        mag = jnp.full(bshape, 1 << (bits * (length - ints)), MAG_DTYPE)
        return cls(mag, length, ints, base, 1)

    @classmethod
    def one_like(cls, other):
        return cls.one(len(other), other.ints, other.base, other.bshape)

    def copy(self):
        return PackedQFloat(self._mag, self._length, self._ints, self._base, self._sign)

    def set_len_ints(self, newlen, newints):
        """Crop/pad semantics of reference qfloat.py:565-589 on magnitudes."""
        mag = self._mag
        length = self._length
        if self._ints != newints:
            if newints < self._ints:
                # drop leading (ints - newints) digits -> mod base**remaining
                length = length - (self._ints - newints)
                mag = mag & self._mask(length)
            else:
                length = length + (newints - self._ints)
            self._ints = int(newints)
        difflen = int(newlen) - length
        if difflen > 0:
            mag = mag << (self._bits * difflen)
        elif difflen < 0:
            mag = mag >> (self._bits * (-difflen))
        self._length = int(newlen)
        self._mag = mag
        return self

    # ---- normalization (trivial here) -------------------------------------
    def base_tidy(self):
        return

    def tidy(self):
        return

    def _tidy_signed(self, v):
        """Signed value -> (mag, sign), the packed form of base_tidy + tidy.

        Equals reference qfloat.py:607-673: overflow past the top digit is
        dropped (mod base**L on the absolute value), sign of zero is +1.
        Inside a ``track_overflow()`` scope the dropped carry is recorded.
        """
        av = jnp.abs(v)
        mag = av & self._mask()
        sign = jnp.where((v < 0) & (mag != 0), -1, 1).astype(MAG_DTYPE)
        if _OVERFLOW_TRACKER is not None:
            _OVERFLOW_TRACKER.record(av > self._mask())
        return mag, sign

    # ---- comparisons ------------------------------------------------------
    def __eq__(self, other):
        self.check_compatibility(other)
        eq = (self._mag == other._mag) & jnp.equal(self._sign, other._sign)
        return eq.astype(MAG_DTYPE)

    __hash__ = None

    def __gt__(self, other):
        """Reference qfloat.py:711-739 on magnitudes (select form — the
        reference's flag products are emulated s64 multiplies)."""
        self.check_compatibility(other)
        sgn_eq = jnp.equal(self._sign, other._sign)
        self_gt_other = self._mag > other._mag
        inverse = jnp.less(self._sign, 0) & (self._mag != other._mag)
        return jnp.where(
            sgn_eq, self_gt_other ^ inverse, jnp.greater(self._sign, other._sign)
        ).astype(MAG_DTYPE)

    # ---- addition ---------------------------------------------------------
    def __iadd__(self, other):
        if isinstance(other, Zero):
            return self
        QFloatBase.ADDITIONS += 1

        v = _signed_value(self._mag, self._sign)
        if isinstance(other, SignedBinary):
            unit = jnp.asarray(
                1 << (self._bits * (self._length - self._ints)), MAG_DTYPE
            )
            v = v + _signed_value(unit, other.value)
        elif _is_number_like(other):
            v = v + jnp.asarray(other, MAG_DTYPE) * (
                1 << (self._bits * (self._length - self._ints))
            )
        else:
            self.check_compatibility(other)
            v = v + _signed_value(other._mag, other._sign)
        self._mag, self._sign = self._tidy_signed(v)
        return self

    def iadd_chain(self, others):
        """Sequential in-place adds ``self += o`` for each of ``others``,
        replayed as one ``lax.scan``.

        Bit-identical to the equivalent Python loop of ``__iadd__`` calls
        (the scan body is exactly the iadd+tidy recurrence, applied in list
        order — order matters in overflow cases), but costs O(1) graph
        nodes instead of O(len(others)).
        """
        for o in others:
            self.check_compatibility(o)
        QFloatBase.ADDITIONS += len(others)
        shape = jnp.broadcast_shapes(
            self._mag.shape, *[o._mag.shape for o in others]
        )
        mags = jnp.stack([jnp.broadcast_to(o._mag, shape) for o in others])
        signs = jnp.stack(
            [
                jnp.broadcast_to(jnp.asarray(o._sign, MAG_DTYPE), shape)
                for o in others
            ]
        )
        mask = self._mask()

        # apply signs vectorized over the chain axis, then carry the SIGNED
        # value through the scan: the per-step tidy (mag = |v| mod base**L,
        # re-signed) needs only abs/and/selects — no emulated s64 multiply
        sv = _signed_value(mags, signs)

        def body(v, x):
            v = v + x
            av = jnp.abs(v)
            mag = av & mask
            return jnp.where(v < 0, -mag, mag), (av > mask)

        init = jnp.broadcast_to(_signed_value(self._mag, self._sign), shape)
        v, ovf = lax.scan(body, init, sv)
        if _OVERFLOW_TRACKER is not None:
            _OVERFLOW_TRACKER.record(jnp.any(ovf, axis=0))
        self._mag = jnp.abs(v)
        self._sign = jnp.where(v < 0, -1, 1).astype(MAG_DTYPE)
        return self

    # ---- multiplication ---------------------------------------------------
    def __imul__(self, other):
        if _is_number_like(other):
            sign = _sign_of(other)
            scale = jnp.asarray(other * sign, jnp.uint64)
            mag = (self._mag.astype(jnp.uint64) * scale) & jnp.uint64(self._mask())
            self._mag = mag.astype(MAG_DTYPE)
            self._sign = self._sign * sign
        elif isinstance(other, SignedBinary):
            self._sign = self._sign * other.value
        else:
            # identical to from_mul at the same format (see core/qfloat.py
            # _mul_window note; reference qfloat.py:852-910)
            QFloatBase.MULTIPLICATION += 1
            self.check_compatibility(other)
            mag = _mul_window_packed(
                self._mag,
                self._ints,
                self._length,
                other._mag,
                other.ints,
                other._length,
                self._length,
                self._ints,
                self._bits,
            )
            self._mag = mag
            self._sign = self._sign * other._sign
        return self

    @classmethod
    def from_mul(cls, a, b, newlength=None, newints=None):
        """Windowed multiply; digit-exact with reference qfloat.py:955-1021."""
        if newlength is None:
            newlength = len(a)
        if newints is None:
            newints = a.ints
        if isinstance(a, Zero) or isinstance(b, Zero):
            return Zero()
        if isinstance(a, SignedBinary) or isinstance(b, SignedBinary):
            if isinstance(a, SignedBinary) and isinstance(b, SignedBinary):
                return a * b
            multiplication = a * b
            multiplication.set_len_ints(newlength, newints)
            return multiplication

        QFloatBase.MULTIPLICATION += 1
        if not a.base == b.base:
            raise ValueError("bases are different")
        mag = _mul_window_packed(
            a._mag, a.ints, a._length, b._mag, b.ints, b._length,
            newlength, newints, a._bits,
        )
        return cls(mag, newlength, newints, a.base, a.sign * b.sign)

    @classmethod
    def multi_from_mul(cls, list_a, list_b, newlength=None, newints=None):
        """Grouped multiply: stack the QFloat x QFloat pairs on a new leading
        axis and run ONE scanned window multiply (reference qfloat.py:
        1023-1181).  Results are bit-identical to per-pair :meth:`from_mul`;
        the win is O(1) graph nodes for the whole group (compile time for
        large-n LU circuits).
        """
        a0 = next((a for a in list_a if isinstance(a, QFloatBase)), None)
        b0 = next((b for b in list_b if isinstance(b, QFloatBase)), None)
        if newlength is None:
            newlength = len(a0) if a0 is not None else len(b0)
        if newints is None:
            newints = a0.ints if a0 is not None else b0.ints
        assert len(list_a) == len(list_b)

        list_ab = [None] * len(list_a)
        idx_qf = []
        for i, (a, b) in enumerate(zip(list_a, list_b)):
            if isinstance(a, Zero) or isinstance(b, Zero):
                list_ab[i] = Zero()
            elif isinstance(a, SignedBinary) or isinstance(b, SignedBinary):
                if isinstance(a, SignedBinary) and isinstance(b, SignedBinary):
                    list_ab[i] = a * b
                else:
                    ab = a * b
                    ab.set_len_ints(newlength, newints)
                    list_ab[i] = ab
            else:
                idx_qf.append(i)

        QFloatBase.MULTIPLICATION += len(idx_qf)
        if not idx_qf:
            return list_ab
        if len(idx_qf) == 1:
            i = idx_qf[0]
            QFloatBase.MULTIPLICATION -= 1  # from_mul counts it
            list_ab[i] = cls.from_mul(list_a[i], list_b[i], newlength, newints)
            return list_ab

        shape = jnp.broadcast_shapes(
            *[list_a[i]._mag.shape for i in idx_qf],
            *[list_b[i]._mag.shape for i in idx_qf],
        )
        a_stack = jnp.stack(
            [jnp.broadcast_to(list_a[i]._mag, shape) for i in idx_qf], axis=0
        )
        b_stack = jnp.stack(
            [jnp.broadcast_to(list_b[i]._mag, shape) for i in idx_qf], axis=0
        )
        mags = _mul_window_packed(
            a_stack, a0.ints, a0._length, b_stack, b0.ints, b0._length,
            newlength, newints, a0._bits,
        )
        for k, i in enumerate(idx_qf):
            sign = list_a[i].sign * list_b[i].sign
            list_ab[i] = cls(mags[k], newlength, newints, a0.base, sign)
        return list_ab

    # ---- division ---------------------------------------------------------
    def _long_division(self, dividend, n_digits):
        """Restoring long division: q = dividend // divisor, digit-exact with
        reference base_p_arrays.py:173-203 including zero-divisor saturation.

        ``dividend``: int64 magnitudes; ``n_digits``: static digit count of
        the dividend (also the quotient length).
        """
        return packed_long_division(
            dividend, self._mag, n_digits, self._bits,
            divisor_bits=self._bits * self._length,
        )

    def __itruediv__(self, other):
        if isinstance(other, Zero):
            raise ValueError("division by Zero")
        if isinstance(other, SignedBinary):
            # unchanged or saturated (reference qfloat.py:1199-1210)
            v = other.value
            if isinstance(v, (int, np.integer)):
                is_zero = v == 0
                self._mag = jnp.full_like(self._mag, self._mask()) if is_zero else self._mag
                self._sign = self._sign if is_zero else v
                return self
            is_zero = v == 0
            self._mag = jnp.where(is_zero, self._mask(), self._mag)
            self._sign = jnp.where(
                is_zero, jnp.asarray(self._sign, MAG_DTYPE), jnp.asarray(v, MAG_DTYPE)
            )
            return self

        QFloatBase.DIVISION += 1
        self.check_compatibility(other)
        fp = self._length - self._ints
        n_digits = self._length + fp
        if self._bits * n_digits > 62:
            raise ValueError("division dividend too wide for packed backend")
        dividend = self._mag << (self._bits * fp)
        q = other._long_division(dividend, n_digits)
        if _OVERFLOW_TRACKER is not None:
            # quotient digits beyond the kept window are dropped overflow
            _OVERFLOW_TRACKER.record((q >> (self._bits * self._length)) != 0)
        self._mag = q & self._mask()  # keep the trailing `length` digits
        self._sign = self.sign * other.sign
        return self

    def invert(self, sign=1, newlength=None, newints=None):
        """Signed reciprocal (reference qfloat.py:1263-1309)."""
        _check_invert_sign(sign)
        QFloatBase.DIVISION += 1
        if newlength is None:
            newlength = self._length
        if newints is None:
            newints = self._ints
        fp = newlength - newints
        fpself = self._length - self._ints
        n_digits = 1 + fpself + fp
        if self._bits * n_digits > 62:
            raise ValueError("invert dividend too wide for packed backend")
        dividend = jnp.asarray(1 << (self._bits * (fpself + fp)), MAG_DTYPE)
        q = self._long_division(dividend, n_digits)
        diff = newlength - n_digits
        if diff < 0:
            if _OVERFLOW_TRACKER is not None:
                _OVERFLOW_TRACKER.record((q >> (self._bits * newlength)) != 0)
            q = q & ((1 << (self._bits * newlength)) - 1)
        sb = sign.value if isinstance(sign, SignedBinary) else sign
        return PackedQFloat(q, newlength, newints, self._base, sb * self.sign)

    @classmethod
    def multi_invert(cls, list_qfloats, sign=1, newlength=None, newints=None):
        """Grouped reciprocal: one long-division over the stacked divisors
        (reference qfloat.py:1311-1376).  Bit-identical to per-element
        :meth:`invert`."""
        _check_invert_sign(sign)
        qf0 = list_qfloats[0]
        for q in list_qfloats:
            assert isinstance(q, cls)
            assert len(q) == len(qf0) and q.base == qf0.base and q.ints == qf0.ints
        if len(list_qfloats) == 1:
            return [qf0.invert(sign, newlength, newints)]
        QFloatBase.DIVISION += len(list_qfloats)
        if newlength is None:
            newlength = qf0._length
        if newints is None:
            newints = qf0._ints
        fp = newlength - newints
        fpself = qf0._length - qf0._ints
        n_digits = 1 + fpself + fp
        if qf0._bits * n_digits > 62:
            raise ValueError("invert dividend too wide for packed backend")
        divisors = jnp.stack([q._mag for q in list_qfloats], axis=0)
        dividend = jnp.asarray(1 << (qf0._bits * (fpself + fp)), MAG_DTYPE)
        stacked = cls(divisors, qf0._length, qf0._ints, qf0._base, 1)
        q_mags = stacked._long_division(dividend, n_digits)
        diff = newlength - n_digits
        if diff < 0:
            if _OVERFLOW_TRACKER is not None:
                _OVERFLOW_TRACKER.record(
                    jnp.any((q_mags >> (qf0._bits * newlength)) != 0, axis=0)
                )
            q_mags = q_mags & ((1 << (qf0._bits * newlength)) - 1)
        sb = sign.value if isinstance(sign, SignedBinary) else sign
        return [
            cls(q_mags[i], newlength, newints, qf0._base, sb * q.sign)
            for i, q in enumerate(list_qfloats)
        ]

    # ---- pivot support ----------------------------------------------------
    def blend_from(self, other, cond):
        """Magnitude-only branchless select (reference qfloat.py:323-326).

        Deliberately bug-compatible: the sign is NOT blended, exactly like
        ``qfloat_argmax`` in the reference.
        """
        self._mag = jnp.where(jnp.not_equal(cond, 0), other._mag, self._mag)
        return self


import functools


# Division lowering: "float" = f32-estimate + exact integer fixup chunks
# (default where applicable), "classic" = 1 digit per restoring step.
_DIVISION_IMPL = None


def set_division_impl(impl):
    """Force the division lowering: None = auto, "float", or "classic"."""
    global _DIVISION_IMPL
    _DIVISION_IMPL = impl


def _float_div_chunk_bits(n_bits, divisor_bits):
    """Quotient bits per float-assisted step, or 0 if inapplicable.

    Constraints: q_est < 2**16 keeps the 16-bit-limb partial products of
    ``q_est * divisor`` inside uint32 in the Pallas kernel; the remainder
    ``r < divisor * 2**k`` and the fixup value ``q_est * divisor`` must
    stay below 2**62 (signed-int64 headroom in the XLA path); and the
    downward-biased estimate's deficit 2**k * eps (eps < 2**-16, see
    pair_math.div_float) must stay under 1 so a single add-back fixup is
    enough — k <= 15 keeps it < 1/2.
    """
    if divisor_bits is None:
        return 0
    k = min(15, 61 - divisor_bits, n_bits)
    return k if k >= 4 else 0


def _long_division_float(dividend, divisor, n_bits, k):
    """q = dividend // divisor via f32-estimated radix-2**k long division.

    Exact (not approximate): the loop-invariant reciprocal is DOWNWARD-
    BIASED by 2**-17, so each chunk's floored estimate is never above the
    true quotient digit and at most one below it; a single add-back fixup
    restores exactness (proof note in pair_math.div_float — same bound,
    same boundary property test).  Zero divisors saturate the full n_bits
    window, digit-exact with the restoring loop (reference
    base_p_arrays.py:189-201).
    """
    v = jnp.asarray(dividend, MAG_DTYPE)
    d = jnp.asarray(divisor, MAG_DTYPE)
    is_zero = d == 0
    ds = jnp.where(is_zero, jnp.ones_like(d), d)  # divide by 1, mask later
    rdf = (1.0 - 2.0 ** -17) / ds.astype(jnp.float32)

    n_chunks = -(-n_bits // k)
    first = n_bits - k * (n_chunks - 1)

    r = jnp.zeros_like(v) + v * 0 + ds * 0  # carry sharding/varying axes
    q = jnp.zeros_like(r)
    consumed = 0
    for c in range(n_chunks):
        kc = first if c == 0 else k
        consumed += kc
        chunk = (v >> (n_bits - consumed)) & ((1 << kc) - 1)
        r = (r << kc) | chunk
        qc = jnp.floor(r.astype(jnp.float32) * rdf).astype(MAG_DTYPE)
        qc = jnp.clip(qc, 0, (1 << kc) - 1)
        rem = r - qc * ds
        # estimate never too high (downward bias), at most one too low
        ge = rem >= ds
        qc = qc + ge.astype(MAG_DTYPE)
        rem = rem - jnp.where(ge, ds, jnp.zeros_like(ds))
        r = rem
        q = (q << kc) | qc
    mask = jnp.asarray((1 << n_bits) - 1, MAG_DTYPE)
    return jnp.where(is_zero, mask, q)


def packed_long_division(dividend, divisor, n_digits, bits, divisor_bits=None):
    """Long division on int64 magnitudes: q = dividend // divisor.

    Digit-exact with reference base_p_arrays.py:173-203 including
    zero-divisor saturation (every quotient digit -> base-1 when the
    divisor is 0, because the remainder never decreases).  Free-function
    form so scanned circuit lowerings (models/qfloat_lu_scan.py) can call
    it on raw magnitude tensors inside ``lax.scan`` bodies.

    ``divisor_bits``: static upper bound on the divisor width (bits *
    divisor_length at the call site).  When given, the f32-assisted
    lowering processes ~14 quotient bits per step instead of one digit per
    restoring step — same exact results, ~4x fewer sequential ops.
    """
    p = 1 << bits
    n_bits = bits * n_digits
    k = _float_div_chunk_bits(n_bits, divisor_bits)
    use_float = k > 0 and _DIVISION_IMPL in (None, "float") \
        and _DIVISION_IMPL != "classic"

    if use_float:
        return _long_division_float(dividend, divisor, n_bits, k)

    def body(i, state):
        r, q = state
        digit = (dividend >> (bits * (n_digits - 1 - i))) & (p - 1)
        r = (r << bits) | digit
        qdigit = jnp.zeros_like(r)
        for _ in range(p - 1):
            ge = (r >= divisor).astype(MAG_DTYPE)
            # divisor & (0 - ge) == divisor * ge for ge in {0, 1}: one AND
            # instead of an emulated 64-bit multiply
            r = r - (divisor & (0 - ge))
            qdigit = qdigit + ge
        q = (q << bits) | qdigit
        return (r, q)

    # derive the zero carries from the operands so their sharding/varying
    # axes match the loop outputs under shard_map
    zero = jnp.asarray(dividend, MAG_DTYPE) * 0 + jnp.asarray(divisor, MAG_DTYPE) * 0
    _, q = lax.fori_loop(0, n_digits, body, (zero, zero))
    return q


@functools.lru_cache(maxsize=None)
def _mul_window_consts(a_ints, a_len, b_ints, b_len, newlength, newints, bits):
    """Per-partial-product shift/mask constants for the scanned multiply."""
    a_sh, b_sh, b_mask, o_sh = [], [], [], []
    for i in range(a_len):
        indb = newints - a_ints + i + 1 - b_ints
        ind1 = 0 if indb >= 0 else -indb
        ind2 = min(b_len, newlength - indb)
        if ind2 <= ind1:
            a_sh.append(0)
            b_sh.append(0)
            b_mask.append(0)  # zero mask -> zero contribution
            o_sh.append(0)
            continue
        a_sh.append(bits * (a_len - 1 - i))
        b_sh.append(bits * (b_len - ind2))
        b_mask.append((1 << (bits * (ind2 - ind1))) - 1)
        o_sh.append(bits * (newlength - indb - ind2))
    u = lambda xs: np.asarray(xs, dtype=np.uint64)
    return u(a_sh), u(b_sh), u(b_mask), u(o_sh)


# Multiply lowering style: "scan" keeps O(1) graph nodes per multiply;
# "unroll" emits the ~40 dependent uint64 steps as straight-line ops and is
# kept for experiments.  None = auto: scan.
_MUL_SCAN = None

# Partial products accumulated per scan step (the loop body stays one
# fused elementwise kernel; fewer iterations amortize the loop carry).
_MUL_GROUP = 2


def set_mul_scan(enabled):
    global _MUL_SCAN
    _MUL_SCAN = enabled


def set_mul_group(g):
    """Partial products per multiply-scan step (1 = one per step)."""
    global _MUL_GROUP
    _MUL_GROUP = int(g)


# Algebraic truncated multiply (see pair_math.mul_truncated for the
# derivation): one wide multiply for the unfloored digits + ~t1 per-digit
# floors, instead of one masked shift-add per digit of ``a``.  Digit-exact
# with the windowed scan (tests/test_packed_parity.py) but incompatible with
# overflow tracking (its flag reads the carry bits above the output window,
# which the uncropped high parts pollute), so those paths keep the scan.
# None = auto (on).
_MUL_TRUNC = None


def set_mul_trunc(enabled):
    """Force the algebraic truncated multiply on/off (None = auto: on)."""
    global _MUL_TRUNC
    _MUL_TRUNC = enabled


def _mul_trunc_packed(au, bu, a_len, a_ints, b_len, b_ints,
                      newlength, newints, bits, base_mask, out_mask):
    """acc = cropped partial-product sum, algebraic form (uint64)."""
    t_dig = (a_len - a_ints) + (b_len - b_ints) - (newlength - newints)
    t1 = bits * t_dig
    if t1 <= 0:
        return ((au * bu) << jnp.uint64(-t1)) & out_mask
    # The single-word floor-correction form (pair_math.mul_truncated:
    # out = ((a*b - C) >> t1) & mask, C in one uint32) is not used on this
    # XLA path: its uint64<->uint32 dtype boundary splits XLA's elementwise
    # fusions, and every boundary is a round trip through device memory.
    # Inside the fused kernel, where everything stays in registers, pair_math
    # uses it.
    acc = (au >> jnp.uint64(t1)) * bu
    for p in range(max(0, t_dig - b_len + 1), min(t_dig, a_len)):
        w = bu >> jnp.uint64(bits * (t_dig - p))
        a_i = (au >> jnp.uint64(bits * p)) & base_mask
        if bits == 1:
            acc = acc + (w & (jnp.uint64(0) - a_i))
        else:
            acc = acc + w * a_i
    return acc & out_mask


def _mul_window_packed(a_mag, a_ints, a_len, b_mag, b_ints, b_len,
                       newlength, newints, bits, with_ovf=False):
    """Packed form of the cropped partial-product sum (see module docstring).

    ``with_ovf=True`` returns ``(mag, overflow_flag)`` instead of recording
    into the ambient tracker — for callers inside ``lax.scan`` bodies where
    flags must travel through the scan carry (models/qfloat_lu_scan.py).
    """
    base_mask = jnp.uint64((1 << bits) - 1)
    out_mask = jnp.uint64((1 << (bits * newlength)) - 1)
    consts = _mul_window_consts(a_ints, a_len, b_ints, b_len, newlength, newints, bits)

    au = a_mag.astype(jnp.uint64)
    bu = b_mag.astype(jnp.uint64)

    if (
        not with_ovf
        and _OVERFLOW_TRACKER is None
        and _MUL_TRUNC in (None, True)
    ):
        acc = _mul_trunc_packed(
            au, bu, a_len, a_ints, b_len, b_ints,
            newlength, newints, bits, base_mask, out_mask,
        )
        return acc.astype(MAG_DTYPE)

    # For base 2 the digit a_i is 0/1, so the partial product is a mask:
    # (window << o_sh) & (0 - a_i) replaces a 64-bit multiply (emulated
    # with several 32-bit ops) with one AND.
    if bits == 1:
        mac = lambda acc, a_i, window, o_sh: acc + (
            (window << o_sh) & (jnp.uint64(0) - a_i)
        )
    else:
        mac = lambda acc, a_i, window, o_sh: acc + ((a_i * window) << o_sh)

    if _MUL_SCAN is None or _MUL_SCAN:
        G = max(1, _MUL_GROUP)
        arrs = [np.asarray(c) for c in consts]
        if G > 1 and len(arrs[0]) % G:
            # pad with zero-mask (no-op) product slots
            pad = G - len(arrs[0]) % G
            arrs = [np.concatenate([c, np.zeros(pad, c.dtype)]) for c in arrs]
        if G > 1:
            cs = tuple(jnp.asarray(c).reshape(-1, G) for c in arrs)

            def step(acc, c):
                a_shs, b_shs, b_masks, o_shs = c
                for g in range(G):
                    a_i = (au >> a_shs[g]) & base_mask
                    window = (bu >> b_shs[g]) & b_masks[g]
                    acc = mac(acc, a_i, window, o_shs[g])
                return acc, None

        else:
            cs = tuple(jnp.asarray(c) for c in arrs)

            def step(acc, c):
                a_sh, b_sh, b_mask, o_sh = c
                a_i = (au >> a_sh) & base_mask
                window = (bu >> b_sh) & b_mask
                return mac(acc, a_i, window, o_sh), None

        # zero carry derived from the operands (keeps shard_map varying axes)
        acc, _ = lax.scan(step, au * jnp.uint64(0) + bu * jnp.uint64(0), cs)
    else:
        a_shs, b_shs, b_masks, o_shs = consts
        acc = au * jnp.uint64(0) + bu * jnp.uint64(0)
        for i in range(a_len):
            if b_masks[i] == 0:
                continue
            a_i = (au >> jnp.uint64(a_shs[i])) & base_mask
            window = (bu >> jnp.uint64(b_shs[i])) & jnp.uint64(b_masks[i])
            acc = mac(acc, a_i, window, jnp.uint64(o_shs[i]))

    if with_ovf:
        return (acc & out_mask).astype(MAG_DTYPE), (acc & ~out_mask) != jnp.uint64(0)
    if _OVERFLOW_TRACKER is not None:
        # carry out of the output window = dropped overflow (best effort:
        # bits above 2**64 wrap and are undetectable)
        _OVERFLOW_TRACKER.record((acc & ~out_mask) != jnp.uint64(0))
    return (acc & out_mask).astype(MAG_DTYPE)
