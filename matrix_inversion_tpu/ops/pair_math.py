"""uint32 (hi, lo) pair arithmetic — the register-level number format.

The fused kernel keeps its state in 32-bit registers: a 64-bit integer op
costs several 32-bit instructions, and the shifts, masks and compares the
packed circuit needs map one to one onto 32-bit words.  This module
implements the <2**64 unsigned arithmetic the packed QFloat
backend needs (see ops/packed.py) on explicit ``(hi, lo)`` uint32 pairs:

* plain jnp on arrays -> usable eagerly, under jit, AND inside Pallas
  kernel bodies (the fused whole-inversion kernel builds on it);
* every routine is a pure function with static shift/mask/width arguments,
  so inside a kernel the whole chain stays in vector registers/VMEM.

Bit-exactness contract: each function reproduces the corresponding int64
routine in ops/packed.py digit for digit (property-tested in
tests/test_pair_qfloat.py); the division/multiply bodies here are the
single source of truth for the fused kernel in ops/fused_inverse.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32
_MASK32 = 0xFFFFFFFF


def split64(x):
    """int64/uint64 array -> (hi, lo) uint32 pair."""
    x = jnp.asarray(x).astype(jnp.uint64)
    return (x >> jnp.uint64(32)).astype(_U32), (x & jnp.uint64(_MASK32)).astype(_U32)


def join64(hi, lo):
    """(hi, lo) uint32 pair -> uint64 array."""
    return (hi.astype(jnp.uint64) << jnp.uint64(32)) | lo.astype(jnp.uint64)


def const_pair(value, like_hi):
    """Static python int < 2**64 -> broadcast (hi, lo) pair shaped like ``like_hi``."""
    v = int(value)
    return (
        jnp.full_like(like_hi, (v >> 32) & _MASK32),
        jnp.full_like(like_hi, v & _MASK32),
    )


def shr(hi, lo, s: int):
    """Logical right shift by a STATIC amount s in [0, 63]."""
    if s == 0:
        return hi, lo
    if s >= 32:
        return jnp.zeros_like(hi), hi >> _U32(s - 32)
    return hi >> _U32(s), (lo >> _U32(s)) | (hi << _U32(32 - s))


def shl(hi, lo, s: int):
    """Logical left shift by a STATIC amount s in [0, 63] (mod 2**64)."""
    if s == 0:
        return hi, lo
    if s >= 32:
        return lo << _U32(s - 32), jnp.zeros_like(lo)
    return (hi << _U32(s)) | (lo >> _U32(32 - s)), lo << _U32(s)


def and_const(hi, lo, mask64: int):
    """Bitwise AND with a STATIC 64-bit mask."""
    return hi & _U32((mask64 >> 32) & _MASK32), lo & _U32(mask64 & _MASK32)


def add(h1, l1, h2, l2):
    """(h1,l1) + (h2,l2) mod 2**64."""
    lo = l1 + l2
    carry = (lo < l2).astype(_U32)
    return h1 + h2 + carry, lo


def sub(h1, l1, h2, l2):
    """(h1,l1) - (h2,l2) mod 2**64."""
    borrow = (l1 < l2).astype(_U32)
    return h1 - h2 - borrow, l1 - l2


def ge(h1, l1, h2, l2):
    """(h1,l1) >= (h2,l2), bool array."""
    return (h1 > h2) | ((h1 == h2) & (l1 >= l2))


def gt(h1, l1, h2, l2):
    """(h1,l1) > (h2,l2), bool array."""
    return (h1 > h2) | ((h1 == h2) & (l1 > l2))


def eq(h1, l1, h2, l2):
    return (h1 == h2) & (l1 == l2)


def nonzero(hi, lo):
    return (hi | lo) != 0


def select(cond, ah, al, bh, bl):
    """where(cond, a, b) on pairs; ``cond`` is a bool array."""
    return jnp.where(cond, ah, bh), jnp.where(cond, al, bl)


def and_mask(hi, lo, m):
    """AND both words with a dynamic uint32 mask (0 or 0xffffffff)."""
    return hi & m, lo & m


def mul_small(hi, lo, k):
    """(hi, lo) * k mod 2**64 for a dynamic u32 factor k < 2**16.

    16-bit-limb partial products keep every intermediate < 2**32.
    """
    k = k.astype(_U32) if hasattr(k, "astype") else _U32(k)
    l0 = lo & _U32(0xFFFF)
    l1 = lo >> _U32(16)
    p1 = (l1 * k) << _U32(16)
    new_lo = l0 * k + p1
    carry = (new_lo < p1).astype(_U32)
    new_hi = hi * k + ((l1 * k) >> _U32(16)) + carry
    return new_hi, new_lo


def to_f32(hi, lo):
    """(hi, lo) pair -> f32, in signed-int-safe pieces.

    Every piece goes through an s32->f32 convert, so it is kept below
    2**31: hi < 2**30 for our < 2**62 values, lo is split 8/24.
    lo >> 8 < 2**24 and lo & 255 convert exactly; the two adds round once
    each, so the total relative error is <= ~2**-23 — far inside the +-1
    fixup budget of the float-assisted division.
    """
    return (
        hi.astype(jnp.int32).astype(jnp.float32) * 4294967296.0
        + (lo >> _U32(8)).astype(jnp.int32).astype(jnp.float32) * 256.0
        + (lo & _U32(255)).astype(jnp.int32).astype(jnp.float32)
    )


def div_float(vhi, vlo, dhi, dlo, n_bits: int, k: int, d_bits: int = None):
    """q = v // d via radix-2**k long division, f32 estimate + exact fixup.

    Pair form of ``ops.packed._long_division_float`` — EXACT, not
    approximate.  The reciprocal is loop-invariant (one f32 divide total)
    and DOWNWARD-BIASED by 2**-17, so the chunk estimate is provably never
    above the true quotient digit and at most one below it (proof note
    inline); a single add-back fixup round restores exactness.  Zero
    divisors saturate the full n_bits window, digit-exact with the
    restoring loop (reference base_p_arrays.py:189-201).

    ``d_bits``: static upper bound on the divisor width; prunes the
    statically-zero 16-bit divisor limbs from the ``q_est * divisor``
    partial products.
    """
    zero = jnp.zeros_like(vhi)

    is_zero = (dhi | dlo) == 0
    # divide by 1 when the divisor is 0, saturate later
    dslo = jnp.where(is_zero, jnp.ones_like(dlo), dlo)
    # loop-invariant biased reciprocal: the 1 - 2**-17 factor dominates the
    # <= ~4 rounding errors (each <= ~2**-23: two to_f32 adds, the divide,
    # the per-chunk multiply), so the total relative error is in
    # (2**-18, 2**-16) and ALWAYS downward.  A compiler may lower the f32
    # divide to an approximate reciprocal (Triton on the GPU: <= 2 ulp,
    # ~2**-22) and contract a*b + c into one FMA (one rounding instead of
    # two); both keep each op's error far below the 2**-17 bias, so the
    # bound holds.  tests/test_gpu.py checks it on the card on the floor
    # boundary cases.
    rdf = (1.0 - 2.0 ** -17) / to_f32(dhi, dslo)
    # 16-bit limbs of the divisor for the q_est * divisor partial products;
    # limbs above d_bits are statically zero and skipped
    use_d2 = d_bits is None or d_bits > 32
    use_d3 = d_bits is None or d_bits > 48
    d0 = dslo & _U32(0xFFFF)
    d1 = dslo >> _U32(16)
    if use_d2:
        d2 = dhi & _U32(0xFFFF) if use_d3 else dhi
    if use_d3:
        d3 = dhi >> _U32(16)

    rhi, rlo = zero, zero
    qhi, qlo = zero, zero
    n_chunks = -(-n_bits // k)
    first = n_bits - k * (n_chunks - 1)
    consumed = 0
    for c in range(n_chunks):
        kc = first if c == 0 else k
        consumed += kc
        _, clo = shr(vhi, vlo, n_bits - consumed)
        chunk = clo & _U32((1 << kc) - 1)
        rhi, rlo = shl(rhi, rlo, kc)
        rlo = rlo | chunk

        qc = jnp.floor(to_f32(rhi, rlo) * rdf).astype(jnp.int32)
        qc = jnp.minimum(jnp.maximum(qc, 0), (1 << kc) - 1).astype(_U32)

        # qd = qc * ds, 16-bit-limb partial products (all < 2**32: qc and
        # each limb are < 2**16)
        p1s = (qc * d1) << _U32(16)
        qdlo = qc * d0 + p1s
        carry = (qdlo < p1s).astype(_U32)
        qdhi = ((qc * d1) >> _U32(16)) + carry
        if use_d2:
            qdhi = qdhi + qc * d2
        if use_d3:
            qdhi = qdhi + ((qc * d3) << _U32(16))

        # rem = r - qd  (never negative: the biased estimate cannot exceed
        # the true digit)
        borrow = (rlo < qdlo).astype(_U32)
        remlo = rlo - qdlo
        remhi = rhi - qdhi - borrow

        # ONE add-back round is provably enough: the true digit q_true =
        # floor(r/d) < 2**kc <= 2**15 (incoming remainder < divisor, so
        # r < d * 2**kc), and the estimate is r/d * (1 - eps) with eps in
        # (2**-18, 2**-16) — strictly positive, so floor(est) <= q_true;
        # and the deficit r/d * eps < 2**15 * 2**-16 < 1/2, so floor(est)
        # >= q_true - 1.  Exactly one `rem >= d` check/add-back lands the
        # remainder in [0, d).  Property-tested exhaustively around floor
        # boundaries in tests/test_pair_qfloat.py::test_div_float_fixup_bound.
        geq = ((remhi > dhi) | ((remhi == dhi) & (remlo >= dslo))).astype(_U32)
        m = _U32(0) - geq
        qc = qc + geq
        slo = dslo & m
        b = (remlo < slo).astype(_U32)
        remlo = remlo - slo
        remhi = remhi - (dhi & m) - b

        rhi, rlo = remhi, remlo
        qhi, qlo = shl(qhi, qlo, kc)
        qlo = qlo | qc

    mask64 = (1 << n_bits) - 1
    qhi = jnp.where(is_zero, jnp.full_like(qhi, (mask64 >> 32) & _MASK32), qhi)
    qlo = jnp.where(is_zero, jnp.full_like(qlo, mask64 & _MASK32), qlo)
    return qhi, qlo


def div_classic(vhi, vlo, dhi, dlo, n_digits: int, bits: int):
    """q = v // d, one base-2**bits digit per restoring step.

    Pair form of the ``ops.packed.packed_long_division`` fori_loop body
    (reference base_p_arrays.py:173-203), fully unrolled.
    """
    base_mask = _U32((1 << bits) - 1)
    zero = jnp.zeros_like(vhi)
    rhi, rlo = zero, zero
    qhi, qlo = zero, zero

    for i in range(n_digits):
        shift = (n_digits - 1 - i) * bits
        # power-of-two digit widths never straddle the 32-bit boundary
        if shift >= 32:
            digit = (vhi >> _U32(shift - 32)) & base_mask
        else:
            digit = (vlo >> _U32(shift)) & base_mask
        # r = (r << bits) | digit
        rhi = (rhi << _U32(bits)) | (rlo >> _U32(32 - bits))
        rlo = (rlo << _U32(bits)) | digit

        qdigit = zero
        for _ in range((1 << bits) - 1):
            geq = (rhi > dhi) | ((rhi == dhi) & (rlo >= dlo))
            borrow = (rlo < dlo) & geq
            rlo = jnp.where(geq, rlo - dlo, rlo)
            rhi = jnp.where(geq, rhi - dhi - borrow.astype(_U32), rhi)
            qdigit = qdigit + geq.astype(_U32)
        # q = (q << bits) | qdigit
        qhi = (qhi << _U32(bits)) | (qlo >> _U32(32 - bits))
        qlo = (qlo << _U32(bits)) | qdigit

    return qhi, qlo


def _limbs16(hi, lo, n_limbs: int):
    """Low-first 16-bit limbs of a pair (at most 4)."""
    out = []
    for i in range(min(n_limbs, 4)):
        w = lo if i < 2 else hi
        out.append(w & _U32(0xFFFF) if i % 2 == 0 else w >> _U32(16))
    return out


def mul_wide(ahi, alo, bhi, blo, a_bits: int, b_bits: int):
    """Low 64 bits of a * b via 16-bit-limb partial products.

    ``a_bits`` / ``b_bits`` are STATIC width upper bounds; statically-zero
    limbs and partial products that only feed bits >= 64 are skipped at
    trace time, so narrow operands cost fewer VPU ops.
    """
    na = max(1, -(-a_bits // 16))
    nb = max(1, -(-b_bits // 16))
    A = _limbs16(ahi, alo, na)
    B = _limbs16(bhi, blo, nb)
    hi = jnp.zeros_like(ahi)
    lo = jnp.zeros_like(alo)
    for i in range(len(A)):
        for j in range(len(B)):
            k = i + j
            if k > 3:
                continue
            p = A[i] * B[j]
            if k == 0:
                nl = lo + p
                hi = hi + (nl < p).astype(_U32)
                lo = nl
            elif k == 1:
                pl = p << _U32(16)
                nl = lo + pl
                hi = hi + (p >> _U32(16)) + (nl < pl).astype(_U32)
                lo = nl
            elif k == 2:
                hi = hi + p
            else:  # k == 3: only the low 16 bits land below 2**64
                hi = hi + (p << _U32(16))
    return hi, lo


def mul_truncated(ahi, alo, bhi, blo, a_len: int, a_ints: int, b_len: int,
                  b_ints: int, newlength: int, newints: int, bits: int):
    """Exact algebraic form of the cropped partial-product sum.

    Digit-exact with :func:`mul_window` on the same formats (property-tested
    in tests/test_pair_qfloat.py), but O(1) multiplies instead of one
    masked shift-add per digit of ``a``.  Derivation from the window
    constants (ops/packed.py:_mul_window_consts): partial product i (digit
    position p = a_len-1-i of ``a``) contributes

        a_p * floor(b / 2**t_p) * 2**(bits*p - t1)   with
        t_p = max(0, t1 - bits*p),  t1 = bits * (fp_a + fp_b - fp_new)

    and every HIGH-side window crop only removes bits that land at/above
    the output window, where addition carries cannot flow back down — so a
    single final ``& out_mask`` replaces all of them.  The digits with
    t_p == 0 share one exponent and collapse into ONE wide multiply
    ``(a >> t1) * b``; only the ``t1/bits`` low digits of ``a`` keep their
    individual floors (reference qfloat.py:997-1010 crops each mularray row
    before summation, which floors each partial product separately).
    """
    fp_a = a_len - a_ints
    fp_b = b_len - b_ints
    fp_new = newlength - newints
    t_dig = fp_a + fp_b - fp_new
    t1 = bits * t_dig
    out_mask = (1 << (bits * newlength)) - 1
    a_bits = bits * a_len
    b_bits = bits * b_len
    base_mask = _U32((1 << bits) - 1)

    if t1 <= 0:
        hi, lo = mul_wide(ahi, alo, bhi, blo, a_bits, b_bits)
        hi, lo = shl(hi, lo, -t1)
        return and_const(hi, lo, out_mask)

    # Fast path: single-word floor correction.  The floored-digit sum
    # factors one step further (validated digit-exactly against the
    # windowed form across random formats, tests/test_pair_qfloat.py):
    #
    #   sum_p a_p * floor(b / 2**tau_p) = (A_low * b - C) >> t1   with
    #   C = sum_p a_p * 2**(bits*p) * (b mod 2**tau_p),  A_low = a mod 2**t1
    #
    # (each p-term of A_low*b - C carries the factor 2**tau_p * 2**(bits*p)
    # = 2**t1, so the shift is exact), and folding S1 = (a >> t1) * b back
    # in gives   out = ((a*b - C) >> t1) & out_mask   in ONE wide multiply.
    # Every C term is (b*2**sh mod 2**t1) masked/scaled by a digit, i.e.
    # < base * 2**t1 — so when t1 + bits + log2(#terms) <= 32 the WHOLE
    # correction accumulates in one uint32 word with no carry chains at
    # all.  Needs the output window below 2**64: t1 + bits*newlength <= 64.
    nt = min(t_dig, a_len)
    if (
        0 < t1 <= 32
        and nt > 0
        and t1 + bits + nt.bit_length() <= 32
        and t1 + bits * newlength <= 64
    ):
        mask_t1 = _U32((1 << t1) - 1)
        blo_t = blo & mask_t1  # t1 <= 32: b's floored bits live in lo
        terms = []
        for p in range(nt):
            sh = bits * p  # sh < t1 <= 32: digits of a come from alo
            d = (alo >> _U32(sh)) & base_mask
            w = (blo_t << _U32(sh)) & mask_t1 if sh else blo_t
            if bits == 1:
                terms.append(w & (_U32(0) - d))
            else:
                terms.append(d * w)
        while len(terms) > 1:  # balanced tree: same op count, log depth
            terms = [
                terms[i] + terms[i + 1] if i + 1 < len(terms) else terms[i]
                for i in range(0, len(terms), 2)
            ]
        C = terms[0]
        hi, lo = mul_wide(ahi, alo, bhi, blo, a_bits, b_bits)
        borrow = (lo < C).astype(_U32)
        lo = lo - C
        hi = hi - borrow
        hi, lo = shr(hi, lo, t1)
        return and_const(hi, lo, out_mask)

    # S1: all digits p with bits*p >= t1, one multiply (a >> t1 drops the
    # floored digits exactly — their bits never reach the shifted value)
    if a_bits > t1:
        sh_hi, sh_lo = shr(ahi, alo, t1)
        hi, lo = mul_wide(sh_hi, sh_lo, bhi, blo, a_bits - t1, b_bits)
    else:
        hi = jnp.zeros_like(ahi)
        lo = jnp.zeros_like(alo)

    # S2: the floored digits, narrowest arithmetic that holds each term
    p_lo = max(0, t_dig - b_len + 1)  # t_p >= bits*b_len floors to zero
    p_hi = min(t_dig, a_len)
    for p in range(p_lo, p_hi):
        t = bits * (t_dig - p)
        sh = bits * p
        # digit of a (power-of-two widths never straddle the word boundary)
        if sh >= 32:
            d = (ahi >> _U32(sh - 32)) & base_mask
        else:
            d = (alo >> _U32(sh)) & base_mask
        w_bits = b_bits - t
        # w = b >> t as a single u32 when it fits
        if t >= 32:
            w = bhi >> _U32(t - 32)
            narrow = True
        elif w_bits <= 32:
            w = (blo >> _U32(t)) | (bhi << _U32(32 - t))
            narrow = True
        else:
            wh, wl = shr(bhi, blo, t)
            narrow = False
        if bits == 1:
            if narrow:
                term = w & (_U32(0) - d)
                nl = lo + term
                hi = hi + (nl < term).astype(_U32)
                lo = nl
            else:
                m = _U32(0) - d
                nl = lo + (wl & m)
                hi = hi + (wh & m) + (nl < (wl & m)).astype(_U32)
                lo = nl
        else:
            if narrow and w_bits + bits <= 32:
                term = d * w
                nl = lo + term
                hi = hi + (nl < term).astype(_U32)
                lo = nl
            else:
                if narrow:
                    th, tl = mul_small(jnp.zeros_like(w), w, d)
                else:
                    th, tl = mul_small(wh, wl, d)
                nl = lo + tl
                hi = hi + th + (nl < tl).astype(_U32)
                lo = nl

    return and_const(hi, lo, out_mask)


def mul_window(ahi, alo, bhi, blo, consts, out_mask64: int, bits: int = 1):
    """Cropped partial-product sum on pairs — the packed windowed multiply.

    ``consts`` is the (a_shift, b_shift, b_mask, out_shift) tuple from
    ``ops.packed._mul_window_consts``.  Per digit i of ``a``: select the
    statically-cropped window of ``b``, shift it to its output position,
    scale by the digit (an AND mask at base 2, a 16-bit-limb multiply for
    wider power-of-two bases), and accumulate mod 2**64.  Digit-exact with
    ``ops.packed._mul_window_packed`` (reference qfloat.py:955-1021).
    """
    acc_hi, acc_lo = _mul_window_acc(ahi, alo, bhi, blo, consts, bits)
    return and_const(acc_hi, acc_lo, out_mask64)


def mul_window_ovf(ahi, alo, bhi, blo, consts, out_mask64: int, bits: int = 1):
    """:func:`mul_window` + overflow flag: carries out of the output window.

    Returns ``(hi, lo, ovf)`` where ``ovf`` is a bool array, true when the
    accumulated (cropped) partial-product sum had nonzero bits above the
    output window — dropped overflow, exactly the flag the packed tracked
    multiply records (``ops.packed._mul_window_packed`` with a live
    tracker: ``(acc & ~out_mask) != 0``).  The truncated multiply cannot
    compute this flag (its un-cropped high product parts pollute the bits
    above the window), which is why tracked paths use the windowed form.
    """
    acc_hi, acc_lo = _mul_window_acc(ahi, alo, bhi, blo, consts, bits)
    inv_mask = ((1 << 64) - 1) ^ (out_mask64 & ((1 << 64) - 1))
    oh, ol = and_const(acc_hi, acc_lo, inv_mask)
    hi, lo = and_const(acc_hi, acc_lo, out_mask64)
    return hi, lo, nonzero(oh, ol)


def _mul_window_acc(ahi, alo, bhi, blo, consts, bits: int = 1):
    """Raw mod-2**64 accumulation of the cropped partial products."""
    a_shs, b_shs, b_masks, o_shs = consts
    acc_hi = jnp.zeros_like(ahi)
    acc_lo = jnp.zeros_like(alo)
    base_mask = _U32((1 << bits) - 1)

    for i in range(len(a_shs)):
        m64 = int(b_masks[i])
        if m64 == 0:
            continue
        s = int(a_shs[i])
        digit = ((ahi >> _U32(s - 32)) if s >= 32 else (alo >> _U32(s))) & base_mask
        # ((b >> b_sh) & m) << o_sh == (b <<net>> |net|) & ((m << o_sh) mod
        # 2**64) for logical shifts — one net shift + one combined mask
        # instead of shift/mask/shift (all amounts are static here, so the
        # net direction resolves at trace time; for bits > 1 the scale by
        # the digit commutes with the shift mod 2**64)
        net = int(o_shs[i]) - int(b_shs[i])
        pm64 = (m64 << int(o_shs[i])) & ((1 << 64) - 1)
        if net >= 0:
            whi, wlo = shl(bhi, blo, net)
        else:
            whi, wlo = shr(bhi, blo, -net)
        whi, wlo = and_const(whi, wlo, pm64)
        if bits == 1:
            neg = _U32(0) - digit
            xhi = whi & neg
            xlo = wlo & neg
        else:
            # (window * digit) << o_sh == ((window << o_sh) * digit) mod
            # 2**64 — no extra mask: carry bits above the window are kept
            # by both forms identically
            xhi, xlo = mul_small(whi, wlo, digit)
        new_lo = acc_lo + xlo
        carry = (new_lo < xlo).astype(_U32)
        acc_hi = acc_hi + xhi + carry
        acc_lo = new_lo

    return acc_hi, acc_lo
