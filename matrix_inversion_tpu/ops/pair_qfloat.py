"""PairQFloat — the packed QFloat backend on explicit uint32 (hi, lo) pairs.

Same numeric semantics as :class:`matrix_inversion_tpu.ops.packed.PackedQFloat`
(itself digit-exact with the reference, see that module's docstring), but the
magnitude lives in two uint32 words instead of one int64.  Why it exists:

* The fused kernel keeps its state in 32-bit registers, so QFloat
  arithmetic inside it runs on pairs.  PairQFloat lets the *existing*
  trace-time circuit machinery (models/qfloat_lu.py — pivoting, LU
  decomposition, substitution, the 2x2 closed form) run unmodified INSIDE a
  Pallas kernel body: the fused whole-inversion kernel
  (ops/fused_inverse.py) is just ``qfloat_lu`` code executed with PairQFloat
  cells.
* It is plain jnp on uint32 arrays, so it also runs eagerly / under jit on
  any backend — which is how its bit-exactness against PackedQFloat is
  property-tested (tests/test_pair_qfloat.py) without a GPU.

Semantics notes (mirroring ops/packed.py):

* sign is an int32 array (or static python int) in {-1, 0, +1}; sign 0
  behaves as zero (reference qfloat.py:299);
* every normalization is ``mag = |v| mod base**L``, ``sign(0) = +1``
  (reference qfloat.py:607-673);
* division by zero saturates all quotient digits to ``base-1`` (reference
  qfloat.py:1204-1209, base_p_arrays.py:189-201);
* all ``jnp.where`` operands are materialized arrays (``full_like``), never
  python scalars — scalar where-operands become closed_calls Mosaic cannot
  lower.
"""

from __future__ import annotations

import numbers

import jax.numpy as jnp
import numpy as np

from ..core.qfloat import (
    QFloatBase,
    SignedBinary,
    Zero,
    _check_invert_sign,
    _is_number_like,
)
from . import packed as _packed
from . import pair_math as pm
from .packed import _digit_bits, _float_div_chunk_bits, _mul_window_consts

_U32 = jnp.uint32
_I32 = jnp.int32

# Multiply lowering: "trunc" (default) = one wide multiply for the unfloored
# digits + per-digit floors (pair_math.mul_truncated); "window" = one masked
# shift-add per digit of ``a`` (pair_math.mul_window).  Bit-identical
# (property-tested); "trunc" needs far fewer ops per multiply.
_MUL_IMPL = "trunc"


def set_mul_impl(impl):
    """Force the pair multiply lowering: "trunc" or "window"."""
    global _MUL_IMPL
    assert impl in ("trunc", "window"), impl
    _MUL_IMPL = impl


# Signed-add lowering: "magnitude" (default) computes sum AND both
# differences of the magnitudes and selects; "twos" converts operands to
# two's-complement pairs, adds once, and converts back.  Bit-identical
# (property-tested); kept as a measured A/B knob (round-3 NOTES item 0:
# the untried ~1k-op lever).
_SADD_IMPL = "magnitude"


def set_sadd_impl(impl):
    """Force the pair signed-add lowering: "magnitude" or "twos"."""
    global _SADD_IMPL
    assert impl in ("magnitude", "twos"), impl
    _SADD_IMPL = impl


def _pair_mul(ahi, alo, a_ints, a_len, bhi, blo, b_ints, b_len,
              newlength, newints, bits):
    tracker = _packed._OVERFLOW_TRACKER
    if _MUL_IMPL == "trunc" and tracker is None:
        return pm.mul_truncated(
            ahi, alo, bhi, blo, a_len, a_ints, b_len, b_ints,
            newlength, newints, bits,
        )
    consts = _mul_window_consts(
        a_ints, a_len, b_ints, b_len, newlength, newints, bits
    )
    out_mask = (1 << (bits * newlength)) - 1
    if tracker is not None:
        # tracked multiplies keep the windowed form: its mod-2**64 partial
        # sum exposes exactly the carries out of the output window (the
        # truncated form's un-cropped high product parts pollute them) —
        # same fallback the packed backend makes (ops/packed.py)
        hi, lo, ovf = pm.mul_window_ovf(
            ahi, alo, bhi, blo, consts, out_mask, bits
        )
        tracker.record(ovf)
        return hi, lo
    return pm.mul_window(ahi, alo, bhi, blo, consts, out_mask, bits)


def _is_static(sign) -> bool:
    return isinstance(sign, (int, np.integer))


def _sign_arr(sign, like):
    """Sign (python int or array) -> int32 array shaped like ``like``."""
    if _is_static(sign):
        return jnp.full_like(like, int(sign), dtype=_I32)
    return jnp.broadcast_to(jnp.asarray(sign, _I32), like.shape)


class PairQFloat(QFloatBase):
    """uint32-pair QFloat (power-of-two bases, ``base**len < 2**62``)."""

    def __init__(self, hi, lo, length, ints=None, base=2, sign=1):
        self._length = int(length)
        if ints is None:
            ints = length // 2
        self._ints = int(ints)
        if not (0 <= self._ints <= self._length):
            raise ValueError("ints must be in range [0, length]")
        self._base = int(base)
        self._bits = _digit_bits(self._base)
        if self._bits * self._length > 62:
            raise ValueError("encoding too wide for the pair backend")
        self._hi = jnp.asarray(hi, _U32)
        self._lo = jnp.asarray(lo, _U32)
        if isinstance(sign, float):
            sign = int(sign)
        self._sign = sign

    # ---- shape / metadata --------------------------------------------------
    def __len__(self):
        return self._length

    @property
    def bshape(self):
        return self._hi.shape

    @property
    def hi(self):
        return self._hi

    @property
    def lo(self):
        return self._lo

    @property
    def is_base_tidy(self):
        return True

    def _mask64(self, ndigits=None) -> int:
        n = self._length if ndigits is None else ndigits
        return (1 << (self._bits * n)) - 1

    # ---- conversions (host/test side; the kernel never calls these) --------
    @classmethod
    def from_packed(cls, packed):
        """PackedQFloat -> PairQFloat (splits the int64 magnitudes)."""
        hi, lo = pm.split64(packed.mag)
        return cls(hi, lo, len(packed), packed.ints, packed.base, packed.sign)

    def to_packed(self):
        """PairQFloat -> PackedQFloat (joins the words into int64)."""
        from .packed import PackedQFloat

        mag = pm.join64(self._hi, self._lo).astype(jnp.int64)
        return PackedQFloat(mag, self._length, self._ints, self._base, self._sign)

    def to_float(self):
        return self.to_packed().to_float()

    def to_str(self, tidy=True):
        return self.to_packed().to_str(tidy)

    # ---- factories ----------------------------------------------------------
    @classmethod
    def zero(cls, length, ints, base, bshape=()):
        z = jnp.zeros(bshape, _U32)
        return cls(z, z, length, ints, base, 1)

    @classmethod
    def zero_like(cls, other):
        return cls.zero(len(other), other.ints, other.base, other.bshape)

    @classmethod
    def one(cls, length, ints, base, bshape=()):
        bits = _digit_bits(base)
        v = 1 << (bits * (length - ints))
        hi = jnp.full(bshape, (v >> 32) & 0xFFFFFFFF, _U32)
        lo = jnp.full(bshape, v & 0xFFFFFFFF, _U32)
        return cls(hi, lo, length, ints, base, 1)

    @classmethod
    def one_like(cls, other):
        return cls.one(len(other), other.ints, other.base, other.bshape)

    def copy(self):
        return PairQFloat(
            self._hi, self._lo, self._length, self._ints, self._base, self._sign
        )

    def set_len_ints(self, newlen, newints):
        """Crop/pad semantics of reference qfloat.py:565-589 on pairs."""
        hi, lo = self._hi, self._lo
        length = self._length
        if self._ints != newints:
            if newints < self._ints:
                length = length - (self._ints - newints)
                hi, lo = pm.and_const(hi, lo, self._mask64(length))
            else:
                length = length + (newints - self._ints)
            self._ints = int(newints)
        difflen = int(newlen) - length
        if difflen > 0:
            hi, lo = pm.shl(hi, lo, self._bits * difflen)
        elif difflen < 0:
            hi, lo = pm.shr(hi, lo, self._bits * (-difflen))
        self._length = int(newlen)
        self._hi, self._lo = hi, lo
        return self

    # ---- normalization (trivial: always tidy) --------------------------------
    def base_tidy(self):
        return

    def tidy(self):
        return

    # ---- comparisons ----------------------------------------------------------
    def __eq__(self, other):
        self.check_compatibility(other)
        ss = _sign_arr(self._sign, self._hi)
        os_ = _sign_arr(other._sign, other._hi)
        eqm = pm.eq(self._hi, self._lo, other._hi, other._lo)
        return (eqm & (ss == os_)).astype(_I32)

    __hash__ = None

    def __gt__(self, other):
        """Reference qfloat.py:711-739 (same select form as PackedQFloat).

        Signs are materialized as int32 arrays so every where-operand is a
        vector (Mosaic requirement).
        """
        self.check_compatibility(other)
        ss = _sign_arr(self._sign, self._hi)
        os_ = _sign_arr(other._sign, other._hi)
        sgn_eq = ss == os_
        mag_gt = pm.gt(self._hi, self._lo, other._hi, other._lo)
        mag_ne = ~pm.eq(self._hi, self._lo, other._hi, other._lo)
        inverse = (ss < 0) & mag_ne
        # int32 where-operands: Mosaic cannot select on i1 vectors
        return jnp.where(
            sgn_eq, (mag_gt ^ inverse).astype(_I32), (ss > os_).astype(_I32)
        )

    # ---- addition ---------------------------------------------------------------
    def _sadd(self, ohi, olo, osign):
        """Signed add + tidy: identical values to PackedQFloat's
        ``v = mag*sign + omag*osign; mag = |v| & mask; sign = v<0 & mag!=0``
        — without ever forming a 64-bit signed value.

        Two lowerings (``set_sadd_impl``), bit-identical: "magnitude"
        computes the sum and both |differences| of the magnitudes and
        selects by sign agreement; "twos" negates negative operands into
        two's-complement pairs, adds once, and takes |v| back.
        """
        mask = self._mask64()
        # magnitudes with sign==0 zeroed (their contribution to v is 0)
        ah, al = self._zeroed(self._hi, self._lo, self._sign)
        bh, bl = self._zeroed(ohi, olo, osign)
        a_neg = self._neg_flag(self._sign, self._hi)
        b_neg = self._neg_flag(osign, ohi)

        if _SADD_IMPL == "twos":
            # x -> x or -x (two's complement, 64-bit pair): with
            # m = 0 or ~0, -x == (x ^ m) - m; magnitudes < 2**62 so the
            # signed sum fits and its top bit is the sign
            ma = _U32(0) - a_neg.astype(_U32)
            mb = _U32(0) - b_neg.astype(_U32)
            tah, tal = pm.sub(ah ^ ma, al ^ ma, ma, ma)
            tbh, tbl = pm.sub(bh ^ mb, bl ^ mb, mb, mb)
            vh, vl = pm.add(tah, tal, tbh, tbl)
            neg = (vh >> _U32(31)) != 0
            mv = _U32(0) - neg.astype(_U32)
            vh, vl = pm.sub(vh ^ mv, vl ^ mv, mv, mv)
        else:
            same = a_neg == b_neg
            sh, sl = pm.add(ah, al, bh, bl)
            a_ge = pm.ge(ah, al, bh, bl)
            d1h, d1l = pm.sub(ah, al, bh, bl)
            d2h, d2l = pm.sub(bh, bl, ah, al)
            dh, dl = pm.select(a_ge, d1h, d1l, d2h, d2l)
            vh, vl = pm.select(same, sh, sl, dh, dl)
            # boolean algebra, not where: Mosaic cannot select on i1 vectors
            keep_a = same | a_ge
            neg = (keep_a & a_neg) | (~keep_a & b_neg)

        if _packed._OVERFLOW_TRACKER is not None:
            # |v| exceeded the representable range — same flag as the packed
            # backend's ``av > mask`` in ``_tidy_signed`` (reference open
            # TODO, qfloat.py:623-624).  (v, not the masked magnitude: the
            # signed-magnitude add never wraps 2**64 since bits*len <= 62.)
            mkh, mkl = pm.const_pair(mask, vh)
            _packed._OVERFLOW_TRACKER.record(pm.gt(vh, vl, mkh, mkl))
        mh, ml = pm.and_const(vh, vl, mask)
        sign = jnp.where(
            neg & pm.nonzero(mh, ml),
            jnp.full_like(mh, -1, dtype=_I32),
            jnp.full_like(mh, 1, dtype=_I32),
        )
        self._hi, self._lo = mh, ml
        self._sign = sign
        return self

    @staticmethod
    def _zeroed(hi, lo, sign):
        if _is_static(sign):
            if int(sign) == 0:
                return jnp.zeros_like(hi), jnp.zeros_like(lo)
            return hi, lo
        m = _U32(0) - jnp.not_equal(jnp.asarray(sign), 0).astype(_U32)
        return hi & m, lo & m

    @staticmethod
    def _neg_flag(sign, like):
        if _is_static(sign):
            return jnp.full_like(like, int(sign) < 0, dtype=jnp.bool_)
        return jnp.less(jnp.asarray(sign), 0)

    def __iadd__(self, other):
        if isinstance(other, Zero):
            return self
        QFloatBase.ADDITIONS += 1
        if isinstance(other, SignedBinary):
            unit = 1 << (self._bits * (self._length - self._ints))
            uh, ul = pm.const_pair(unit, self._hi)
            return self._sadd(uh, ul, other.value)
        if _is_number_like(other):
            if not isinstance(other, numbers.Integral):
                raise NotImplementedError(
                    "PairQFloat += array scalar is not supported (unused on "
                    "circuit paths; use PackedQFloat)"
                )
            k = int(other)
            unit = abs(k) * (1 << (self._bits * (self._length - self._ints)))
            uh, ul = pm.const_pair(unit & ((1 << 64) - 1), self._hi)
            return self._sadd(uh, ul, 1 if k >= 0 else -1)
        self.check_compatibility(other)
        return self._sadd(other._hi, other._lo, other._sign)

    # ---- multiplication -----------------------------------------------------------
    def __imul__(self, other):
        if _is_number_like(other):
            if not isinstance(other, numbers.Integral):
                raise NotImplementedError(
                    "PairQFloat *= array scalar is not supported (unused on "
                    "circuit paths; use PackedQFloat)"
                )
            k = int(other)
            sign = (k > 0) - (k < 0)
            # |k| * mag mod 2**64 by binary expansion (static shift-adds)
            acc_h, acc_l = jnp.zeros_like(self._hi), jnp.zeros_like(self._lo)
            ak, s = abs(k), 0
            while ak:
                if ak & 1:
                    th, tl = pm.shl(self._hi, self._lo, s)
                    acc_h, acc_l = pm.add(acc_h, acc_l, th, tl)
                ak >>= 1
                s += 1
            self._hi, self._lo = pm.and_const(acc_h, acc_l, self._mask64())
            self._sign = self._sign * sign
        elif isinstance(other, SignedBinary):
            self._sign = self._sign * other.value
        else:
            QFloatBase.MULTIPLICATION += 1
            self.check_compatibility(other)
            self._hi, self._lo = _pair_mul(
                self._hi, self._lo, self._ints, self._length,
                other._hi, other._lo, other.ints, other._length,
                self._length, self._ints, self._bits,
            )
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
        hi, lo = _pair_mul(
            a._hi, a._lo, a.ints, a._length,
            b._hi, b._lo, b.ints, b._length, newlength, newints, a._bits,
        )
        return cls(hi, lo, newlength, newints, a.base, a.sign * b.sign)

    @classmethod
    def multi_from_mul(cls, list_a, list_b, newlength=None, newints=None):
        """Per-pair from_mul.  Inside a fused kernel every op is unrolled
        anyway, so the packed backend's stacking trick buys nothing here."""
        return [
            cls.from_mul(a, b, newlength, newints)
            for a, b in zip(list_a, list_b)
        ]

    # ---- division -------------------------------------------------------------------
    def _long_division(self, divh, divl, n_digits):
        """q = (divh, divl) // self, pair long division.

        Uses the float-assisted exact lowering when applicable (always at
        power-of-two bases with our widths), else the restoring loop —
        digit-exact either way (see pair_math).
        """
        n_bits = self._bits * n_digits
        k = _float_div_chunk_bits(n_bits, self._bits * self._length)
        if k > 0:
            return pm.div_float(
                divh, divl, self._hi, self._lo, n_bits, k,
                d_bits=self._bits * self._length,
            )
        return pm.div_classic(divh, divl, self._hi, self._lo, n_digits, self._bits)

    def __itruediv__(self, other):
        if isinstance(other, Zero):
            raise ValueError("division by Zero")
        if isinstance(other, SignedBinary):
            # unchanged or saturated (reference qfloat.py:1199-1210)
            v = other.value
            mask = self._mask64()
            if _is_static(v):
                if int(v) == 0:
                    self._hi, self._lo = pm.const_pair(mask, self._hi)
                else:
                    self._sign = v
                return self
            is_zero = jnp.equal(jnp.asarray(v), 0)
            sh, sl = pm.const_pair(mask, self._hi)
            self._hi, self._lo = pm.select(is_zero, sh, sl, self._hi, self._lo)
            self._sign = jnp.where(
                is_zero, _sign_arr(self._sign, self._hi), _sign_arr(v, self._hi)
            )
            return self

        QFloatBase.DIVISION += 1
        self.check_compatibility(other)
        fp = self._length - self._ints
        n_digits = self._length + fp
        if self._bits * n_digits > 62:
            raise ValueError("division dividend too wide for pair backend")
        dh, dl = pm.shl(self._hi, self._lo, self._bits * fp)
        qh, ql = other._long_division(dh, dl, n_digits)
        if _packed._OVERFLOW_TRACKER is not None:
            # quotient digits beyond the kept window are dropped overflow
            # (same flag as ops/packed.py __itruediv__)
            oh, ol = pm.shr(qh, ql, self._bits * self._length)
            _packed._OVERFLOW_TRACKER.record(pm.nonzero(oh, ol))
        self._hi, self._lo = pm.and_const(qh, ql, self._mask64())
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
            raise ValueError("invert dividend too wide for pair backend")
        dh, dl = pm.const_pair(1 << (self._bits * (fpself + fp)), self._hi)
        qh, ql = self._long_division(dh, dl, n_digits)
        if newlength - n_digits < 0:
            if _packed._OVERFLOW_TRACKER is not None:
                oh, ol = pm.shr(qh, ql, self._bits * newlength)
                _packed._OVERFLOW_TRACKER.record(pm.nonzero(oh, ol))
            qh, ql = pm.and_const(qh, ql, (1 << (self._bits * newlength)) - 1)
        sb = sign.value if isinstance(sign, SignedBinary) else sign
        return PairQFloat(qh, ql, newlength, newints, self._base, sb * self.sign)

    @classmethod
    def multi_invert(cls, list_qfloats, sign=1, newlength=None, newints=None):
        return [q.invert(sign, newlength, newints) for q in list_qfloats]

    # ---- pivot support -------------------------------------------------------------
    def blend_from(self, other, cond):
        """Magnitude-only branchless select — deliberately bug-compatible
        with the reference's qfloat_argmax (sign is NOT blended)."""
        c = jnp.not_equal(cond, 0)
        self._hi, self._lo = pm.select(c, other._hi, other._lo, self._hi, self._lo)
        return self
