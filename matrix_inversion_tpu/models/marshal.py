"""Marshalling between float matrices, digit-array I/O, and QFloat matrices.

Mirrors reference qfloat_matrix_inversion.py:222-309 with two device-first
changes:

* every converter accepts leading batch dimensions (``(..., n*n, len)``
  instead of ``(n*n, len)``), since batched inversion is the primary
  execution model;
* the device-side converters can target either QFloat backend ("limb"
  digit arrays or "packed" int64 magnitudes).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.qfloat import QFloat, QFloatBase, SignedBinary, Zero
from ..ops import radix
from ..ops.packed import PackedQFloat


def float_matrix_to_qfloat_arrays(M, qfloat_len, qfloat_ints, qfloat_base):
    """Float matrix (..., n, n) -> ((..., n*n, len) digits, (..., n*n) signs).

    Host-side quantization (reference qfloat_matrix_inversion.py:222-236),
    vectorized: one numpy pass for the whole batch.
    """
    M = np.asarray(M, dtype=np.float64)
    batch = M.shape[:-2]
    flat = M.reshape(batch + (-1,))
    # radix dispatches large batches to the native kernel itself and always
    # returns int64, so the dtype contract is batch-size-independent.
    digits, signs = radix.float_to_digits_and_sign(
        flat, qfloat_len, qfloat_ints, qfloat_base
    )
    return digits, signs


def qfloat_arrays_to_qfloat_matrix(
    qfloat_arrays, qfloat_signs, qfloat_ints, qfloat_base, backend="limb"
):
    """Digit/sign arrays -> n x n 2D list of QFloats (device side).

    Reference qfloat_matrix_inversion.py:239-262; ``backend`` selects the
    number representation used for the computation.
    """
    qfloat_arrays = jnp.asarray(qfloat_arrays)
    n = int(np.sqrt(qfloat_arrays.shape[-2]))
    M = []
    index = 0
    for _ in range(n):
        row = []
        for _ in range(n):
            digits = qfloat_arrays[..., index, :]
            sign = qfloat_signs[..., index]
            if backend == "packed":
                qf = PackedQFloat.from_digits(digits, qfloat_ints, qfloat_base, sign)
            else:
                qf = QFloat(digits, qfloat_ints, qfloat_base, True, sign)
            row.append(qf)
            index += 1
        M.append(row)
    return M


def qfloat_matrix_to_arrays_and_signs(M, qfloat_len, qfloat_ints, qfloat_base):
    """QFloat 2D-list matrix -> (..., n*n, len+1) output arrays.

    The sign is appended as the last column; SignedBinary/Zero cells are
    written as a scalar digit at position ``ints-1``
    (reference qfloat_matrix_inversion.py:286-309).
    """
    n = len(M)
    assert n == len(M[0])

    # find batch shape and an array dtype from any QFloat cell
    bshape = ()
    for row in M:
        for cell in row:
            if isinstance(cell, QFloatBase):
                bshape = cell.bshape
                break

    rows = []
    for i in range(n):
        for j in range(n):
            cell = M[i][j]
            if isinstance(cell, QFloatBase):
                digits = cell.to_array().astype(jnp.int32)
                digits = jnp.broadcast_to(digits, bshape + (qfloat_len,))
                sign = jnp.broadcast_to(
                    jnp.asarray(cell.sign, jnp.int32), bshape
                )[..., None]
                rows.append(jnp.concatenate([digits, sign], axis=-1))
            elif isinstance(cell, SignedBinary):
                v = jnp.broadcast_to(jnp.asarray(cell.value, jnp.int32), bshape)
                out = jnp.zeros(bshape + (qfloat_len + 1,), jnp.int32)
                out = out.at[..., qfloat_ints - 1].set(v)
                out = out.at[..., qfloat_len].set(v)
                rows.append(out)
            elif isinstance(cell, Zero):
                rows.append(jnp.zeros(bshape + (qfloat_len + 1,), jnp.int32))
            else:
                v = jnp.broadcast_to(jnp.asarray(cell, jnp.int32), bshape)
                out = jnp.zeros(bshape + (qfloat_len + 1,), jnp.int32)
                out = out.at[..., qfloat_ints - 1].set(v)
                out = out.at[..., qfloat_len].set(jnp.sign(v))
                rows.append(out)
    return jnp.stack(rows, axis=-2)


def float_matrix_to_mags_and_signs(M, qfloat_len, qfloat_ints, qfloat_base):
    """Float matrix (..., n, n) -> ((..., n*n) int64 magnitudes, signs).

    The packed-I/O production path: 1 magnitude word per cell instead of
    ``qfloat_len`` digit words — 40x less host->device traffic at High
    precision.  Uses the native quantizer when built.
    """
    M = np.asarray(M, dtype=np.float64)
    flat = M.reshape(M.shape[:-2] + (-1,))
    from ..runtime import native

    if native.available() and flat.size >= 4096:
        return native.quantize_packed(flat, qfloat_len, qfloat_ints, qfloat_base)
    digits, signs = radix.float_to_digits_and_sign(
        flat, qfloat_len, qfloat_ints, qfloat_base
    )
    return radix.pack_digits(digits, qfloat_base), signs


def mags_and_signs_to_qfloat_matrix(mags, signs, qfloat_len, qfloat_ints, qfloat_base):
    """Packed magnitudes/signs -> n x n 2D list of PackedQFloats (device)."""
    mags = jnp.asarray(mags)
    n = int(np.sqrt(mags.shape[-1]))
    M = []
    index = 0
    for _ in range(n):
        row = []
        for _ in range(n):
            row.append(
                PackedQFloat(
                    mags[..., index], qfloat_len, qfloat_ints, qfloat_base,
                    signs[..., index],
                )
            )
            index += 1
        M.append(row)
    return M


def qfloat_matrix_to_mags_and_signs(M, qfloat_len, qfloat_ints, qfloat_base):
    """QFloat 2D-list matrix -> ((..., n*n) magnitudes, (..., n*n) signs).

    Packed-I/O analog of :func:`qfloat_matrix_to_arrays_and_signs`; cells
    follow the same encoding scheme (SignedBinary/plain cells land at digit
    ``ints-1``; such cells are only ever 0/+1 on real output paths).
    """
    import jax.numpy as jnp

    n = len(M)
    bshape = ()
    for row in M:
        for cell in row:
            if isinstance(cell, QFloatBase):
                bshape = cell.bshape
                break

    bits = (qfloat_base).bit_length() - 1
    unit = 1 << (bits * (qfloat_len - qfloat_ints))
    mags, signs = [], []
    for i in range(n):
        for j in range(n):
            cell = M[i][j]
            if isinstance(cell, PackedQFloat):
                mag, sign = cell.mag, cell.sign
            elif isinstance(cell, QFloatBase):
                mag = PackedQFloat.from_digits(
                    cell.to_digits(), cell.ints, cell.base, cell.sign
                ).mag
                sign = cell.sign
            elif isinstance(cell, SignedBinary):
                v = cell.value
                mag, sign = jnp.abs(jnp.asarray(v)) * unit, v
            elif isinstance(cell, Zero):
                mag, sign = 0, 0
            else:
                mag = jnp.abs(jnp.asarray(cell)) * unit
                sign = jnp.sign(jnp.asarray(cell))
            mags.append(jnp.broadcast_to(jnp.asarray(mag, jnp.int64), bshape))
            signs.append(jnp.broadcast_to(jnp.asarray(sign, jnp.int64), bshape))
    return jnp.stack(mags, axis=-1), jnp.stack(signs, axis=-1)


def mags_and_signs_to_float_matrix(mags, signs, qfloat_len, qfloat_ints, qfloat_base):
    """Packed output -> float matrix (..., n, n) (host side)."""
    mags = np.asarray(mags)
    signs = np.asarray(signs)
    n = int(np.sqrt(mags.shape[-1]))
    from ..runtime import native

    if native.available() and mags.size >= 4096:
        values = native.dequantize_packed(
            mags, signs, qfloat_len, qfloat_ints, qfloat_base
        )
    else:
        frac = qfloat_len - qfloat_ints
        values = (
            mags.astype(np.float64)
            * float(qfloat_base) ** (-frac)
            * signs.astype(np.float64)
        )
    return values.reshape(values.shape[:-1] + (n, n))


def qfloat_and_signs_arrays_to_float_matrix(qfloat_arrays, qfloat_ints, qfloat_base):
    """(..., n*n, len+1) output arrays -> float matrix (..., n, n).

    Host-side dequantization (reference qfloat_matrix_inversion.py:265-283),
    vectorized over the batch.
    """
    arr = np.asarray(qfloat_arrays)
    n = int(np.sqrt(arr.shape[-2]))
    digits = arr[..., :-1]
    signs = arr[..., -1]
    values = radix.digits_and_sign_to_float(digits, signs, qfloat_ints, qfloat_base)
    return values.reshape(values.shape[:-1] + (n, n))
