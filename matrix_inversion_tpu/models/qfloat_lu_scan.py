"""Scanned LU inversion: O(1) graph nodes in n for the packed backend.

The unrolled LU layer (models/qfloat_lu.py) mirrors the reference's circuit
construction (reference qfloat_matrix_inversion.py:377-518): every QFloat op
of the O(n^3) Doolittle recurrence becomes a node in the traced graph, so
XLA compile time grows with n^3.
This module lowers the SAME arithmetic as a fixed-size program of nested
``lax.scan``s over magnitude/sign tensors, so graph size — and compile
time — is independent of n.

Bit-exactness argument (property-tested in tests/test_lu_scan.py):

* Every reference dot product is a sequential chain ``acc = term_0;
  acc += term_k`` where ``__iadd__`` recomputes ``v = acc.mag * acc.sign +
  term.mag * term.sign`` and re-tidies (reference qfloat.py:798-834).  The
  chain state only ever influences the next step — and every consumer of a
  dot result — through the product ``v = mag * sign``.  Starting the chain
  from the neutral ``(mag=0, sign=+1)`` and iadd-ing every term in order
  therefore reproduces each ``v`` exactly; masked (out-of-range) terms add
  ``v_term = 0``, which is a tidy fixed point.  That turns every
  variable-length dot into one fixed-length masked scan.
* Doolittle cells are pure functions of earlier cells; re-scheduling the
  column-major reference sweep (reference qfloat_matrix_inversion.py:
  404-448) into a row-of-U / column-of-L sweep computes identical values,
  and lets one triangle sweep vectorize across a full tensor axis while a
  single ``lax.scan`` walks the other.
* Raw copies (``U[0][j] = PM[0][j].copy()``, ``Y[i][0] = P[i][0].copy()``,
  the last backward column) preserve sign-0 cells verbatim, unlike a tidy;
  those steps are replayed with explicit ``where(t == 0, raw, computed)``.

Overflow flags (the ``track_overflow`` feature) are threaded through the
scan carries and OR-reduced per batch element, masked to the lanes the
reference actually computes, so flags also match the unrolled path.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.packed import (
    MAG_DTYPE,
    PackedQFloat,
    _digit_bits,
    _mul_window_packed,
    packed_long_division,
)
from .qfloat_lu import qfloat_pivot_matrix


def _tidy_v(v, mask):
    """(mag, sign, overflow) of a signed value — reference qfloat.py:607-673."""
    av = jnp.abs(v)
    mag = av & mask
    sign = jnp.where((v < 0) & (mag != 0), MAG_DTYPE(-1), MAG_DTYPE(1))
    return mag, sign, av > mask


def _masked_dot(a_mags, a_signs, b_mags, b_signs, ks, active_of_k, fmt, mask,
                track, unroll=False):
    """Masked replay of a reference dot-product chain.

    ``a_mags``/``b_mags``: (n, ...) stacked per-term operand magnitudes
    (trailing dims broadcast against each other — one side is usually a
    scalar coefficient, the other a lane vector).  ``active_of_k`` maps the
    term index to the chain membership predicate (``k < bound`` for prefix
    dots, ``k > bound`` for the backward-substitution suffix dots).
    ``fmt`` = (a_ints, a_len, b_ints, b_len, newlength, newints, bits) of
    the ``from_mul`` every term goes through.

    ``unroll=True`` emits the k-loop as straight-line ops instead of a
    ``lax.scan`` — identical values, O(n) graph nodes per dot, two fewer
    levels of while-loop overhead at run time.

    Returns (mag, sign, per-lane overflow) of the chain result.
    """
    shape = jnp.broadcast_shapes(a_mags.shape[1:], b_mags.shape[1:])
    acc_mag = jnp.zeros(shape, MAG_DTYPE)
    acc_sign = jnp.ones(shape, MAG_DTYPE)
    ovf0 = jnp.zeros(shape, jnp.bool_)

    def step(carry, x):
        am, asg, bm, bsg, k = x
        m, s, ovf = carry
        active = active_of_k(k)
        if track:
            pm, wovf = _mul_window_packed(am, fmt[0], fmt[1], bm, fmt[2], fmt[3],
                                          fmt[4], fmt[5], fmt[6], with_ovf=True)
        else:
            pm = _mul_window_packed(am, fmt[0], fmt[1], bm, fmt[2], fmt[3],
                                    fmt[4], fmt[5], fmt[6])
        term_v = pm * (asg * bsg)
        v = m * s + jnp.where(active, term_v, 0)
        mag, sign, tovf = _tidy_v(v, mask)
        if track:
            ovf = ovf | (active & (wovf | tovf))
        return (mag, sign, ovf), None

    if unroll:
        carry = (acc_mag, acc_sign, ovf0)
        for k in range(a_mags.shape[0]):
            carry, _ = step(
                carry, (a_mags[k], a_signs[k], b_mags[k], b_signs[k], ks[k])
            )
        return carry

    (mag, sign, ovf), _ = lax.scan(
        step, (acc_mag, acc_sign, ovf0), (a_mags, a_signs, b_mags, b_signs, ks)
    )
    return mag, sign, ovf


def _invert(u_mag, u_sign, qfloat_len, qfloat_ints, bits, mask):
    """invert(1, qfloat_len, 0) on raw magnitudes (reference qfloat.py:1263-1309)."""
    fpself = qfloat_len - qfloat_ints
    fp = qfloat_len  # newints = 0
    n_digits = 1 + fpself + fp
    dividend = jnp.asarray(1 << (bits * (fpself + fp)), MAG_DTYPE)
    q = packed_long_division(dividend, u_mag, n_digits, bits,
                             divisor_bits=bits * qfloat_len)
    ovf = (q >> (bits * qfloat_len)) != 0
    return q & mask, u_sign, ovf


def _truediv(num_mag, num_sign, den_mag, den_sign, qfloat_len, qfloat_ints,
             bits, mask):
    """``/=`` on raw magnitudes (reference qfloat.py:1183-1234)."""
    fp = qfloat_len - qfloat_ints
    n_digits = qfloat_len + fp
    q = packed_long_division(num_mag << (bits * fp), den_mag, n_digits, bits,
                             divisor_bits=bits * qfloat_len)
    ovf = (q >> (bits * qfloat_len)) != 0
    return q & mask, num_sign * den_sign, ovf


def qfloat_matrix_inverse_scan(mags, signs, n, qfloat_len, qfloat_ints,
                               qfloat_base, true_division, track=False,
                               unroll_dots=False):
    # unroll_dots=True emits the k-loops as straight-line ops (more graph,
    # no measured gain), so the default stays False.
    """Packed-I/O matrix inverse with scanned lowering.

    Same contract as :func:`..models.inverse.qfloat_matrix_inverse_packed_io`
    (``(..., n*n)`` int64 magnitudes + signs in and out), bit-identical
    results, but a fixed-size compiled program regardless of n.  With
    ``track=True`` also returns the per-matrix overflow flag.
    """
    assert n >= 3, "n == 2 uses the closed form (models/qfloat_lu.py)"
    L, I = int(qfloat_len), int(qfloat_ints)
    bits = _digit_bits(qfloat_base)
    if bits * (1 + 2 * L - I) > 62:
        raise ValueError("encoding too wide for the packed backend")
    mask = (1 << (bits * L)) - 1
    unit = 1 << (bits * (L - I))

    mags = jnp.asarray(mags, MAG_DTYPE)
    signs = jnp.asarray(signs, MAG_DTYPE)
    batch = mags.shape[:-1]
    M_mag = mags.reshape(batch + (n, n))
    M_sign = signs.reshape(batch + (n, n))

    # ---- pivot (reference qfloat_matrix_inversion.py:331-369) -------------
    # O(n^2) cheap compare/blend ops; reuses the object path unrolled.
    cells = [
        [
            PackedQFloat(M_mag[..., i, j], L, I, qfloat_base, M_sign[..., i, j])
            for j in range(n)
        ]
        for i in range(n)
    ]
    P = qfloat_pivot_matrix(cells).astype(MAG_DTYPE)  # (..., n, n) one-hot

    # ---- PM = P @ M (reference :403) ---------------------------------------
    # One-hot rows => each output cell's iadd chain has at most one nonzero
    # term, so the chain equals a single signed sum + final tidy, exactly.
    v = M_mag * M_sign
    pm_v = jnp.sum(P[..., :, :, None] * v[..., None, :, :], axis=-2)
    PM_mag = jnp.abs(pm_v) & mask
    PM_sign = jnp.where((pm_v < 0) & (PM_mag != 0), MAG_DTYPE(-1), MAG_DTYPE(1))
    # Chain overflow: quantization does NOT crop out-of-range inputs (the
    # top digit absorbs the excess, reference base_p_arrays.py:24-48), so
    # the selected element's magnitude can exceed the window; each unrolled
    # chain's OR of iadd flags reduces to |v| > mask for one-hot rows.
    pm_ovf = jnp.any(jnp.abs(pm_v) > mask, axis=(-1, -2))

    fmt_dot = (I, L, I, L, L, I, bits)   # (L,I) x (L,I) -> (L,I)
    fmt_inv = (I, L, 0, L, L, I, bits)   # (L,I) x (L,0) -> (L,I)
    idx = jnp.arange(n)
    ks = jnp.arange(n)

    # ---- LU decomposition (reference :377-453), row-of-U / col-of-L sweep --
    def decomp_step(carry, x):
        U_mag, U_sign, L_mag, L_sign, inv_mag, inv_sign, ovf = carry
        t, pmr_mag, pmr_sign, pmc_mag, pmc_sign = x
        oh = (idx == t).astype(MAG_DTYPE)  # (n,)
        is0 = t == 0

        # Phase A: U[t][j] = PM[t][j] - dot_{k<t}(U[k][j] * L[t][k]), all j>=t
        L_row_t_mag = jnp.sum(L_mag * oh[:, None], axis=-2)   # (..., n_k)
        L_row_t_sign = jnp.sum(L_sign * oh[:, None], axis=-2)
        dm, ds, dovf = _masked_dot(
            jnp.moveaxis(U_mag, -2, 0), jnp.moveaxis(U_sign, -2, 0),
            jnp.moveaxis(L_row_t_mag, -1, 0)[..., None],
            jnp.moveaxis(L_row_t_sign, -1, 0)[..., None],
            ks, lambda k: k < t, fmt_dot, mask, track, unroll_dots,
        )
        va = pmr_mag * pmr_sign - dm * ds
        nm, ns, tovf = _tidy_v(va, mask)
        row_mag = jnp.where(is0, pmr_mag, nm)
        row_sign = jnp.where(is0, pmr_sign, ns)
        jvalid = idx >= t
        if track:
            ovf = ovf | jnp.any((dovf | tovf) & jvalid, axis=-1)
        wmask = (idx[:, None] == t) & jvalid[None, :]
        U_mag = jnp.where(wmask, row_mag[..., None, :], U_mag)
        U_sign = jnp.where(wmask, row_sign[..., None, :], U_sign)

        # Phase B: reciprocal of the new diagonal element
        oh64 = oh
        u_tt_mag = jnp.sum(row_mag * oh64, axis=-1)
        u_tt_sign = jnp.sum(row_sign * oh64, axis=-1)
        if not true_division:
            iv_mag, iv_sign, iovf = _invert(u_tt_mag, u_tt_sign, L, I, bits, mask)
            inv_mag = jnp.where(idx == t, iv_mag[..., None], inv_mag)
            inv_sign = jnp.where(idx == t, iv_sign[..., None], inv_sign)
            if track:
                ovf = ovf | iovf

        # Phase C: L[i][t] = (PM[i][t] - dot_{k<t}(U[k][t] * L[i][k])) * inv,
        # all i>t at once (no dependency between rows within one column)
        U_col_t_mag = jnp.sum(U_mag * oh64, axis=-1)   # (..., n_k)
        U_col_t_sign = jnp.sum(U_sign * oh64, axis=-1)
        d2m, d2s, d2ovf = _masked_dot(
            jnp.moveaxis(U_col_t_mag, -1, 0)[..., None],
            jnp.moveaxis(U_col_t_sign, -1, 0)[..., None],
            jnp.moveaxis(L_mag, -1, 0), jnp.moveaxis(L_sign, -1, 0),
            ks, lambda k: k < t, fmt_dot, mask, track, unroll_dots,
        )
        vc = pmc_mag * pmc_sign - d2m * d2s
        tm, ts, tovf2 = _tidy_v(vc, mask)
        temp_mag = jnp.where(is0, pmc_mag, tm)
        temp_sign = jnp.where(is0, pmc_sign, ts)
        if true_division:
            l_mag, l_sign, lovf = _truediv(
                temp_mag, temp_sign, u_tt_mag[..., None], u_tt_sign[..., None],
                L, I, bits, mask,
            )
        else:
            if track:
                l_mag, lovf = _mul_window_packed(
                    temp_mag, I, L, iv_mag[..., None], 0, L, L, I, bits,
                    with_ovf=True,
                )
            else:
                l_mag = _mul_window_packed(
                    temp_mag, I, L, iv_mag[..., None], 0, L, L, I, bits
                )
                lovf = False
            l_sign = temp_sign * iv_sign[..., None]
        ivalid = idx > t
        if track:
            ovf = ovf | jnp.any((d2ovf | tovf2 | lovf) & ivalid, axis=-1)
        wmask = ivalid[:, None] & (idx[None, :] == t)
        L_mag = jnp.where(wmask, l_mag[..., :, None], L_mag)
        L_sign = jnp.where(wmask, l_sign[..., :, None], L_sign)

        return (U_mag, U_sign, L_mag, L_sign, inv_mag, inv_sign, ovf), None

    zmat = jnp.zeros(batch + (n, n), MAG_DTYPE)
    omat = jnp.ones(batch + (n, n), MAG_DTYPE)
    zvec = jnp.zeros(batch + (n,), MAG_DTYPE)
    ovec = jnp.ones(batch + (n,), MAG_DTYPE)
    ovf0 = pm_ovf if track else jnp.zeros(batch, jnp.bool_)
    xs = (
        jnp.arange(n),
        jnp.moveaxis(PM_mag, -2, 0), jnp.moveaxis(PM_sign, -2, 0),
        jnp.moveaxis(PM_mag, -1, 0), jnp.moveaxis(PM_sign, -1, 0),
    )
    (U_mag, U_sign, L_mag, L_sign, inv_mag, inv_sign, ovf), _ = lax.scan(
        decomp_step, (zmat, omat, zmat, omat, zvec, ovec, ovf0), xs
    )

    # ---- forward substitution L Y = P^T (reference :474-485) --------------
    # Rows i are independent; scan walks columns j.  P here is the
    # decomposition's transposed pivot (reference :516 + :461).
    PT = jnp.moveaxis(P, -1, -2)

    def fwd_step(carry, x):
        Y_mag, Y_sign, ovf = carry
        j, p_col = x  # p_col: (..., n_i) in {0, 1}
        oh = (idx == j).astype(MAG_DTYPE)
        L_row_j_mag = jnp.sum(L_mag * oh[:, None], axis=-2)
        L_row_j_sign = jnp.sum(L_sign * oh[:, None], axis=-2)
        dm, ds, dovf = _masked_dot(
            jnp.moveaxis(L_row_j_mag, -1, 0)[..., None],
            jnp.moveaxis(L_row_j_sign, -1, 0)[..., None],
            jnp.moveaxis(Y_mag, -1, 0), jnp.moveaxis(Y_sign, -1, 0),
            ks, lambda k: k < j, fmt_dot, mask, track, unroll_dots,
        )
        v = p_col * unit - dm * ds
        nm, ns, tovf = _tidy_v(v, mask)
        is0 = j == 0
        ym = jnp.where(is0, p_col * unit, nm)
        ysgn = jnp.where(is0, p_col, ns)
        if track:
            ovf = ovf | jnp.any(dovf | tovf, axis=-1)
        wmask = idx[None, :] == j
        Y_mag = jnp.where(wmask, ym[..., :, None], Y_mag)
        Y_sign = jnp.where(wmask, ysgn[..., :, None], Y_sign)
        return (Y_mag, Y_sign, ovf), None

    (Y_mag, Y_sign, ovf), _ = lax.scan(
        fwd_step, (zmat, omat, ovf),
        (jnp.arange(n), jnp.moveaxis(PT, -1, 0).astype(MAG_DTYPE)),
    )

    # ---- backward substitution U X = Y (reference :487-513) ---------------
    rev = jnp.arange(n)[::-1]

    def bwd_step(carry, x):
        X_mag, X_sign, ovf = carry
        j, y_mag_col, y_sign_col, u_row_mag, u_row_sign, iv_m, iv_s = x
        dm, ds, dovf = _masked_dot(
            jnp.moveaxis(u_row_mag, -1, 0)[..., None],
            jnp.moveaxis(u_row_sign, -1, 0)[..., None],
            jnp.moveaxis(X_mag, -1, 0), jnp.moveaxis(X_sign, -1, 0),
            ks, lambda k: k > j, fmt_dot, mask, track, unroll_dots,
        )
        v = y_mag_col * y_sign_col - dm * ds
        tm, ts, tovf = _tidy_v(v, mask)
        islast = j == n - 1
        temp_mag = jnp.where(islast, y_mag_col, tm)
        temp_sign = jnp.where(islast, y_sign_col, ts)
        if true_division:
            oh64 = (idx == j).astype(MAG_DTYPE)
            u_jj_mag = jnp.sum(u_row_mag * oh64, axis=-1)
            u_jj_sign = jnp.sum(u_row_sign * oh64, axis=-1)
            xm, xsgn, xovf = _truediv(
                temp_mag, temp_sign, u_jj_mag[..., None], u_jj_sign[..., None],
                L, I, bits, mask,
            )
        else:
            if track:
                xm, xovf = _mul_window_packed(
                    temp_mag, I, L, iv_m[..., None], 0, L, L, I, bits,
                    with_ovf=True,
                )
            else:
                xm = _mul_window_packed(
                    temp_mag, I, L, iv_m[..., None], 0, L, L, I, bits
                )
                xovf = False
            xsgn = temp_sign * iv_s[..., None]
        if track:
            ovf = ovf | jnp.any(dovf | tovf | xovf, axis=-1)
        wmask = idx[None, :] == j
        X_mag = jnp.where(wmask, xm[..., :, None], X_mag)
        X_sign = jnp.where(wmask, xsgn[..., :, None], X_sign)
        return (X_mag, X_sign, ovf), None

    take_rev = lambda a, ax: jnp.flip(jnp.moveaxis(a, ax, 0), axis=0)
    (X_mag, X_sign, ovf), _ = lax.scan(
        bwd_step, (zmat, omat, ovf),
        (
            rev,
            take_rev(Y_mag, -1), take_rev(Y_sign, -1),
            take_rev(U_mag, -2), take_rev(U_sign, -2),
            take_rev(inv_mag, -1), take_rev(inv_sign, -1),
        ),
    )

    # inverse[a][b] = X[b][a] (reference :516 transpose), flattened row-major
    out_mag = jnp.swapaxes(X_mag, -1, -2).reshape(batch + (n * n,))
    out_sign = jnp.swapaxes(X_sign, -1, -2).reshape(batch + (n * n,))
    if track:
        return out_mag, out_sign, ovf.astype(jnp.int32)
    return out_mag, out_sign


def _dot_static(terms, fmt, mask, track):
    """Static-length dot-chain replay: ``terms`` is a list of
    (a_mag, a_sign, b_mag, b_sign) per-term operands (pre-sliced, no
    masking).  Same v-exact recurrence as :func:`_masked_dot` with
    ``unroll=True`` but zero wasted lanes.  Returns (mag, sign, flags)."""
    shape = jnp.broadcast_shapes(
        *[jnp.broadcast_shapes(jnp.shape(am), jnp.shape(bm))
          for am, _, bm, _ in terms]
    )
    m = jnp.zeros(shape, MAG_DTYPE)
    s = jnp.ones(shape, MAG_DTYPE)
    flags = []
    for am, asg, bm, bsg in terms:
        if track:
            pm, wovf = _mul_window_packed(am, fmt[0], fmt[1], bm, fmt[2], fmt[3],
                                          fmt[4], fmt[5], fmt[6], with_ovf=True)
        else:
            pm = _mul_window_packed(am, fmt[0], fmt[1], bm, fmt[2], fmt[3],
                                    fmt[4], fmt[5], fmt[6])
        v = m * s + pm * (asg * bsg)
        m, s, tovf = _tidy_v(v, mask)
        if track:
            flags.append(wovf)
            flags.append(tovf)
    return m, s, flags


def qfloat_matrix_inverse_vec(mags, signs, n, qfloat_len, qfloat_ints,
                              qfloat_base, true_division, track=False):
    """Packed-I/O matrix inverse, vectorized lowering with a static sweep.

    Same row-of-U / column-of-L re-scheduling as
    :func:`qfloat_matrix_inverse_scan` (and the same bit-exactness
    argument), but the outer index is a Python loop: masks become static
    slices, no lanes are wasted, and the graph is O(n^2) nodes — between
    the O(1) scanned form (fastest compile) and the O(n^3) unrolled object
    path (fastest execution at small n).
    """
    assert n >= 3, "n == 2 uses the closed form (models/qfloat_lu.py)"
    L, I = int(qfloat_len), int(qfloat_ints)
    bits = _digit_bits(qfloat_base)
    if bits * (1 + 2 * L - I) > 62:
        raise ValueError("encoding too wide for the packed backend")
    mask = (1 << (bits * L)) - 1
    unit = 1 << (bits * (L - I))

    mags = jnp.asarray(mags, MAG_DTYPE)
    signs = jnp.asarray(signs, MAG_DTYPE)
    batch = mags.shape[:-1]
    M_mag = mags.reshape(batch + (n, n))
    M_sign = signs.reshape(batch + (n, n))

    cells = [
        [
            PackedQFloat(M_mag[..., i, j], L, I, qfloat_base, M_sign[..., i, j])
            for j in range(n)
        ]
        for i in range(n)
    ]
    P = qfloat_pivot_matrix(cells).astype(MAG_DTYPE)

    v = M_mag * M_sign
    pm_v = jnp.sum(P[..., :, :, None] * v[..., None, :, :], axis=-2)
    PM_mag = jnp.abs(pm_v) & mask
    PM_sign = jnp.where((pm_v < 0) & (PM_mag != 0), MAG_DTYPE(-1), MAG_DTYPE(1))
    flags = [jnp.any(jnp.abs(pm_v) > mask, axis=(-1, -2))] if track else []

    fmt_dot = (I, L, I, L, L, I, bits)
    fmt_inv = (I, L, 0, L, L, I, bits)

    U_mag = jnp.zeros(batch + (n, n), MAG_DTYPE)
    U_sign = jnp.ones(batch + (n, n), MAG_DTYPE)
    L_mag = jnp.zeros(batch + (n, n), MAG_DTYPE)
    L_sign = jnp.ones(batch + (n, n), MAG_DTYPE)
    inv_mag = [None] * n
    inv_sign = [None] * n

    for t in range(n):
        # Phase A: U[t][j] for j >= t
        if t == 0:
            row_mag, row_sign = PM_mag[..., 0, :], PM_sign[..., 0, :]
            U_mag = U_mag.at[..., 0, :].set(row_mag)
            U_sign = U_sign.at[..., 0, :].set(row_sign)
            u_tt_mag, u_tt_sign = row_mag[..., 0], row_sign[..., 0]
        else:
            terms = [
                (U_mag[..., k, t:], U_sign[..., k, t:],
                 L_mag[..., t, k][..., None], L_sign[..., t, k][..., None])
                for k in range(t)
            ]
            dm, ds, dflags = _dot_static(terms, fmt_dot, mask, track)
            va = PM_mag[..., t, t:] * PM_sign[..., t, t:] - dm * ds
            row_mag, row_sign, tovf = _tidy_v(va, mask)
            U_mag = U_mag.at[..., t, t:].set(row_mag)
            U_sign = U_sign.at[..., t, t:].set(row_sign)
            if track:
                flags += [jnp.any(f, axis=-1) for f in dflags]
                flags.append(jnp.any(tovf, axis=-1))
            u_tt_mag, u_tt_sign = row_mag[..., 0], row_sign[..., 0]

        # Phase B: reciprocal of the diagonal
        if not true_division:
            iv_mag, iv_sign, iovf = _invert(u_tt_mag, u_tt_sign, L, I, bits, mask)
            inv_mag[t], inv_sign[t] = iv_mag, iv_sign
            if track:
                flags.append(iovf)

        # Phase C: L[i][t] for i > t
        if t == n - 1:
            continue
        if t == 0:
            temp_mag = PM_mag[..., 1:, 0]
            temp_sign = PM_sign[..., 1:, 0]
        else:
            terms = [
                (U_mag[..., k, t][..., None], U_sign[..., k, t][..., None],
                 L_mag[..., t + 1:, k], L_sign[..., t + 1:, k])
                for k in range(t)
            ]
            d2m, d2s, dflags = _dot_static(terms, fmt_dot, mask, track)
            vc = PM_mag[..., t + 1:, t] * PM_sign[..., t + 1:, t] - d2m * d2s
            temp_mag, temp_sign, tovf2 = _tidy_v(vc, mask)
            if track:
                flags += [jnp.any(f, axis=-1) for f in dflags]
                flags.append(jnp.any(tovf2, axis=-1))
        if true_division:
            l_mag, l_sign, lovf = _truediv(
                temp_mag, temp_sign, u_tt_mag[..., None], u_tt_sign[..., None],
                L, I, bits, mask,
            )
            if track:
                flags.append(jnp.any(lovf, axis=-1))
        else:
            if track:
                l_mag, lovf = _mul_window_packed(
                    temp_mag, I, L, iv_mag[..., None], 0, L, L, I, bits,
                    with_ovf=True,
                )
                flags.append(jnp.any(lovf, axis=-1))
            else:
                l_mag = _mul_window_packed(
                    temp_mag, I, L, iv_mag[..., None], 0, L, L, I, bits
                )
            l_sign = temp_sign * iv_sign[..., None]
        L_mag = L_mag.at[..., t + 1:, t].set(l_mag)
        L_sign = L_sign.at[..., t + 1:, t].set(l_sign)

    # forward substitution L Y = P^T, rows vectorized
    PT = jnp.moveaxis(P, -1, -2)
    Y_mag = jnp.zeros(batch + (n, n), MAG_DTYPE)
    Y_sign = jnp.ones(batch + (n, n), MAG_DTYPE)
    for j in range(n):
        p_col = PT[..., :, j]
        if j == 0:
            ym, ysgn = p_col * unit, p_col
        else:
            terms = [
                (L_mag[..., j, k][..., None], L_sign[..., j, k][..., None],
                 Y_mag[..., :, k], Y_sign[..., :, k])
                for k in range(j)
            ]
            dm, ds, dflags = _dot_static(terms, fmt_dot, mask, track)
            vy = p_col * unit - dm * ds
            ym, ysgn, tovf = _tidy_v(vy, mask)
            if track:
                flags += [jnp.any(f, axis=-1) for f in dflags]
                flags.append(jnp.any(tovf, axis=-1))
        Y_mag = Y_mag.at[..., :, j].set(ym)
        Y_sign = Y_sign.at[..., :, j].set(ysgn)

    # backward substitution U X = Y, rows vectorized
    X_mag = jnp.zeros(batch + (n, n), MAG_DTYPE)
    X_sign = jnp.ones(batch + (n, n), MAG_DTYPE)
    for j in range(n - 1, -1, -1):
        if j == n - 1:
            temp_mag = Y_mag[..., :, j]
            temp_sign = Y_sign[..., :, j]
        else:
            terms = [
                (U_mag[..., j, k][..., None], U_sign[..., j, k][..., None],
                 X_mag[..., :, k], X_sign[..., :, k])
                for k in range(j + 1, n)
            ]
            dm, ds, dflags = _dot_static(terms, fmt_dot, mask, track)
            vx = Y_mag[..., :, j] * Y_sign[..., :, j] - dm * ds
            temp_mag, temp_sign, tovf = _tidy_v(vx, mask)
            if track:
                flags += [jnp.any(f, axis=-1) for f in dflags]
                flags.append(jnp.any(tovf, axis=-1))
        if true_division:
            xm, xsgn, xovf = _truediv(
                temp_mag, temp_sign,
                U_mag[..., j, j][..., None], U_sign[..., j, j][..., None],
                L, I, bits, mask,
            )
            if track:
                flags.append(jnp.any(xovf, axis=-1))
        else:
            if track:
                xm, xovf = _mul_window_packed(
                    temp_mag, I, L, inv_mag[j][..., None], 0, L, L, I, bits,
                    with_ovf=True,
                )
                flags.append(jnp.any(xovf, axis=-1))
            else:
                xm = _mul_window_packed(
                    temp_mag, I, L, inv_mag[j][..., None], 0, L, L, I, bits
                )
            xsgn = temp_sign * inv_sign[j][..., None]
        X_mag = X_mag.at[..., :, j].set(xm)
        X_sign = X_sign.at[..., :, j].set(xsgn)

    out_mag = jnp.swapaxes(X_mag, -1, -2).reshape(batch + (n * n,))
    out_sign = jnp.swapaxes(X_sign, -1, -2).reshape(batch + (n * n,))
    if track:
        ovf = jnp.zeros(batch, jnp.bool_)
        for f in flags:
            ovf = ovf | f
        return out_mag, out_sign, ovf.astype(jnp.int32)
    return out_mag, out_sign
