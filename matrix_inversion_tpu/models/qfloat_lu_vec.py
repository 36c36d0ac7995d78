"""Row-vectorized LU substitution for the packed backend.

The reference's forward/backward substitution loops over output rows ``i``
at trace time (reference qfloat_matrix_inversion.py:461-518); each row is
computed independently with an identical op sequence, so the whole
row loop collapses into one extra leading tensor axis: n times fewer ops
in the graph (compile time) and n times wider lanes per op (device
utilization).  Per-lane arithmetic is exactly the reference sequence, so
results are bit-identical to :func:`..models.qfloat_lu.qfloat_lu_inverse`
(property-tested in tests/test_lu_vec.py).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.qfloat import SignedBinary, qf_from_mul, qf_multi_invert
from ..ops.packed import PackedQFloat
from .qfloat_lu import qfloat_list_dot_product


def _stack_signed_binary(cells):
    """Stack SignedBinary cells [c_0..c_{n-1}] into one with a leading axis."""
    vals = [jnp.asarray(c.value) for c in cells]
    shape = jnp.broadcast_shapes(*[v.shape for v in vals])
    return SignedBinary(jnp.stack([jnp.broadcast_to(v, shape) for v in vals]))


def qfloat_lu_inverse_vec(P, L, U, qfloat_len, qfloat_ints,
                          true_division=False, tensorize=False):
    """Compute the inverse from P, L, U with the row axis vectorized.

    Inputs are the same 2D lists as :func:`qfloat_lu_decomposition`
    produces (P: SignedBinary cells; L/U: Zero/SignedBinary/PackedQFloat).
    Returns the inverse as an n x n list of cells whose leading axis has
    been *consumed*: cell (a, b) of the result equals what the reference's
    ``transpose_2D_list(X)[a][b]`` would hold.
    """
    n = len(L)

    # Forward substitution, all rows i at once: Y[:, j] has leading axis i.
    Y_cols = [None] * n
    Y_cols[0] = _stack_signed_binary([P[i][0] for i in range(n)])
    for j in range(1, n):
        P_j = _stack_signed_binary([P[i][j] for i in range(n)])
        dot = qfloat_list_dot_product(
            [L[j][k] for k in range(j)], [Y_cols[k] for k in range(j)], tensorize
        )
        Y_cols[j] = P_j - dot

    # Backward substitution.
    X_cols = [None] * n
    if not true_division:
        if tensorize:
            Ujj_inv = qf_multi_invert([U[j][j] for j in range(n)], 1, qfloat_len, 0)
        else:
            Ujj_inv = [U[j][j].invert(1, qfloat_len, 0) for j in range(n)]
    if true_division:
        X_cols[n - 1] = Y_cols[n - 1] / U[n - 1][n - 1]
    else:
        X_cols[n - 1] = qf_from_mul(
            Y_cols[n - 1], Ujj_inv[-1], qfloat_len, qfloat_ints
        )
    for j in range(n - 2, -1, -1):
        temp = Y_cols[j] - qfloat_list_dot_product(
            [U[j][k] for k in range(j + 1, n)],
            [X_cols[k] for k in range(j + 1, n)],
            tensorize,
        )
        if true_division:
            X_cols[j] = temp / U[j][j]
        else:
            X_cols[j] = qf_from_mul(temp, Ujj_inv[j], qfloat_len, qfloat_ints)

    # Unstack: result[a][b] = X[b][a] = X_cols[a] at leading index b.
    result = [[None] * n for _ in range(n)]
    for a in range(n):
        col = X_cols[a]
        for b in range(n):
            if isinstance(col, PackedQFloat):
                sign = col.sign
                if hasattr(sign, "ndim") and sign.ndim == col.mag.ndim:
                    sign = sign[b]
                result[a][b] = PackedQFloat(
                    col.mag[b], len(col), col.ints, col.base, sign
                )
            elif isinstance(col, SignedBinary):
                result[a][b] = SignedBinary(jnp.asarray(col.value)[b])
            else:
                result[a][b] = col
    return result
