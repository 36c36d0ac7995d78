"""QFloat pivoting, LU decomposition, LU inverse and the 2x2 closed form.

Algorithm mirror of reference qfloat_matrix_inversion.py:140-584, written
backend-neutrally: matrices are n x n Python lists whose cells are
``Zero`` / ``SignedBinary`` / QFloat (either backend), so the static
type-level pruning of the reference survives tracing, while every cell op
is batched over leading dims.  The n-loops unroll at trace time exactly
like the reference's circuit construction.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.qfloat import (
    QFloatBase,
    SignedBinary,
    Zero,
    qf_from_mul,
    qf_multi_from_mul,
    qf_multi_invert,
)


# ---------------------------------------------------------------------------
# 2D-list matrix utils (reference qfloat_matrix_inversion.py:145-180)
# ---------------------------------------------------------------------------


def matrix_column(M, j):
    return [row[j] for row in M]


def transpose_2D_list(list2D):
    return [list(row) for row in zip(*list2D)]


def map_2D_list(list2D, function):
    return [[function(f) for f in row] for row in list2D]


def binary_list_matrix(M):
    """Wrap a (..., n, n) 0/1 integer tensor as SignedBinary cells."""
    n = M.shape[-1]
    return [[SignedBinary(M[..., i, j]) for j in range(n)] for i in range(n)]


def zero_list_matrix(n):
    return [[Zero() for _ in range(n)] for _ in range(n)]


# ---------------------------------------------------------------------------
# dot / matmul (reference qfloat_matrix_inversion.py:183-219)
# ---------------------------------------------------------------------------


def qfloat_list_dot_product(list1, list2, tensorize=False):
    if len(list1) != len(list2):
        raise ValueError("Lists should have the same length.")
    if len(list1) >= 6 and _all_packed(list1) and _all_packed(list2):
        # Packed backend: the tensorize=False and tensorize=True variants of
        # the reference are value-identical (verified in tests), so always
        # take the grouped path, and replay the sequential iadd chain as one
        # scan (PackedQFloat.iadd_chain) — same results, O(1) graph nodes.
        multiplications = qf_multi_from_mul(list1, list2, None, None)
        result = multiplications[0]
        run = []
        from ..ops.packed import PackedQFloat

        def flush(result, run):
            # the scan pays off only for long chains; short ones are faster
            # unrolled (XLA fuses them into one kernel)
            if len(run) >= 6:
                return result.iadd_chain(run)
            for m in run:
                result += m
            return result

        for m in multiplications[1:]:
            if (
                isinstance(result, PackedQFloat)
                and isinstance(m, PackedQFloat)
                and len(m) == len(result)
                and m.ints == result.ints
            ):
                run.append(m)
            else:
                if run:
                    result = flush(result, run)
                    run = []
                result += m
        if run:
            result = flush(result, run)
        return result
    if tensorize:
        multiplications = qf_multi_from_mul(list1, list2, None, None)
        result = multiplications[0]
        for m in multiplications[1:]:
            result += m
    else:
        result = list1[0] * list2[0]
        for i in range(1, len(list1)):
            result += list1[i] * list2[i]
    return result


def _all_packed(cells):
    """All QFloat cells in the list are packed (Zero/SignedBinary allowed)."""
    from ..core.qfloat import QFloatBase
    from ..ops.packed import PackedQFloat

    any_qf = False
    for c in cells:
        if isinstance(c, QFloatBase):
            any_qf = True
            if not isinstance(c, PackedQFloat):
                return False
    return any_qf


def qfloat_list_matrix_multiply(matrix1, matrix2):
    return [qfloat_list_row_product(row, matrix2) for row in matrix1]


def qfloat_list_row_product(row, matrix):
    """One row of ``[row] x matrix``."""
    return [
        qfloat_list_dot_product(row, matrix_column(matrix, j))
        for j in range(len(matrix[0]))
    ]


# ---------------------------------------------------------------------------
# pivoting (reference qfloat_matrix_inversion.py:317-369)
# ---------------------------------------------------------------------------


def qfloat_argmax(indices, qfloats):
    """Index of the largest QFloat via a branchless max-scan.

    Bug-compatible with reference qfloat_matrix_inversion.py:317-328: only
    the magnitude of the running max is blended, not its sign.
    """
    max_qf = qfloats[0].copy()
    maxi = indices[0]
    for i in range(1, len(indices)):
        is_gt = qfloats[i] > max_qf
        max_qf.blend_from(qfloats[i], is_gt)
        maxi = is_gt * indices[i] + (1 - is_gt) * maxi
    return maxi


def qfloat_pivot_matrix(M):
    """Pivot permutation built from one-hot row swaps.

    Reference qfloat_matrix_inversion.py:331-369, batched: returns a
    (..., n, n) 0/1 integer tensor.
    """
    assert len(M) == len(M[0])
    n = len(M)
    bshape = None
    for row in M:
        for cell in row:
            if isinstance(cell, QFloatBase):
                bshape = cell.bshape
                break
        if bshape is not None:
            break

    pivot_mat = jnp.broadcast_to(jnp.eye(n, dtype=jnp.int32), bshape + (n, n))
    for j in range(n - 1):
        r = qfloat_argmax(
            [i for i in range(j, n)], [abs(M[i][j]) for i in range(j, n)]
        )
        temp_mat = pivot_mat

        # row j becomes row r
        bsum = temp_mat[..., j, :] * ((j == r) * 1)[..., None]
        for i in range(j + 1, n):
            bsum = bsum + temp_mat[..., i, :] * ((i == r) * 1)[..., None]
        pivot_mat = pivot_mat.at[..., j, :].set(bsum)

        # row r becomes row j
        for jj in range(j + 1, n):
            jj_eq_r = ((jj == r) * 1)[..., None]
            pivot_mat = pivot_mat.at[..., jj, :].set(
                (1 - jj_eq_r) * temp_mat[..., jj, :] + jj_eq_r * temp_mat[..., j, :]
            )
    return pivot_mat


def qfloat_pivot_cells(M):
    """Pivot permutation as an n x n list of 0/1 integer arrays (one per cell).

    Same math as :func:`qfloat_pivot_matrix` cell by cell — row j of the
    permutation becomes one-hot row ``r = argmax_i |M[i][j]|`` — but with no
    stacked (..., n, n) tensor, no ``.at[].set``: just elementwise int ops on
    batch-shaped arrays.  This is the form the fused kernels need (they
    hold 1-D per-cell vectors, not scatter updates on trailing matrix
    axes).  Reference qfloat_matrix_inversion.py:331-369.
    """
    assert len(M) == len(M[0])
    n = len(M)
    P = [[1 if i == j else 0 for j in range(n)] for i in range(n)]
    for j in range(n - 1):
        pivot_step(j, M, P)
    return P


def pivot_step(j, M, P):
    """Pivot on column ``j``, in place: swap row ``j`` of ``P`` with the
    row of the largest ``|M[i][j]|``, i >= j."""
    n = len(M)
    # int32 one-hot masks throughout: under x64, ``bool * 1`` would promote
    # to int64
    onehot = lambda i, r: (i == r).astype(jnp.int32)
    r = qfloat_argmax(
        [i for i in range(j, n)], [abs(M[i][j]) for i in range(j, n)]
    )
    temp = [row[:] for row in P]
    # row j becomes row r
    for c in range(n):
        bsum = temp[j][c] * onehot(j, r)
        for i in range(j + 1, n):
            bsum = bsum + temp[i][c] * onehot(i, r)
        P[j][c] = bsum
    # row r becomes row j
    for jj in range(j + 1, n):
        e = onehot(jj, r)
        for c in range(n):
            P[jj][c] = (1 - e) * temp[jj][c] + e * temp[j][c]


# ---------------------------------------------------------------------------
# LU decomposition (reference qfloat_matrix_inversion.py:377-453)
# ---------------------------------------------------------------------------


def qfloat_lu_decomposition(M, qfloat_len, qfloat_ints, true_division=False, tensorize=False):
    """PM = LU on a QFloat 2D-list matrix; returns (P, L, U) with M = PLU."""
    P = binary_list_matrix(qfloat_pivot_matrix(M))
    return lu_from_pivot(P, M, qfloat_len, qfloat_ints, true_division, tensorize)


def lu_from_pivot(P, M, qfloat_len, qfloat_ints, true_division=False, tensorize=False):
    """Doolittle LU given a prebuilt SignedBinary pivot matrix ``P``.

    Split out of :func:`qfloat_lu_decomposition` so the fused kernel
    (ops/fused_inverse.py), which builds its pivot from per-cell masks
    (:func:`qfloat_pivot_cells`), can run the identical op sequence — one
    :func:`lu_column` per kernel stage.
    """
    assert len(M) == len(M[0])
    PM, L, U = lu_begin(P, M)
    for j in range(len(M)):
        lu_column(j, PM, L, U, qfloat_len, qfloat_ints, true_division, tensorize)
    return transpose_2D_list(P), L, U


def lu_begin(P, M):
    """``(PM, L, U)``: the permuted matrix and empty L, U factors."""
    n = len(M)
    return qfloat_list_matrix_multiply(P, M), zero_list_matrix(n), zero_list_matrix(n)


def lu_column(j, PM, L, U, qfloat_len, qfloat_ints, true_division=False,
              tensorize=False):
    """Column ``j`` of the Doolittle factors, in place: ``U[0..j][j]`` and
    ``L[j..n-1][j]``.  Reads ``PM[:][j]`` and the earlier columns only."""
    n = len(PM)
    L[j][j] = SignedBinary(1)
    # u_{ij} = a_{ij} - sum_k u_{kj} l_{ik}
    for i in range(j + 1):
        if i > 0:
            s1 = qfloat_list_dot_product(
                [U[k][j] for k in range(0, i)],
                [L[i][k] for k in range(0, i)],
                tensorize,
            )
            U[i][j] = PM[i][j] + s1.neg()
        else:
            U[i][j] = PM[i][j].copy()

    # l_{ij} = (a_{ij} - sum_k u_{kj} l_{ik}) / u_{jj}
    if not true_division:
        inv_Ujj = U[j][j].invert(1, qfloat_len, 0)
    for i in range(j + 1, n):
        if j > 0:
            s2 = qfloat_list_dot_product(
                [U[k][j] for k in range(0, j)],
                [L[i][k] for k in range(0, j)],
                tensorize,
            )
            if true_division:
                L[i][j] = (PM[i][j] + s2.neg()) / U[j][j]
            else:
                L[i][j] = qf_from_mul(
                    (PM[i][j] + s2.neg()), inv_Ujj, qfloat_len, qfloat_ints
                )
        else:
            if true_division:
                L[i][j] = PM[i][j] / U[j][j]
            else:
                L[i][j] = qf_from_mul(PM[i][j], inv_Ujj, qfloat_len, qfloat_ints)


# ---------------------------------------------------------------------------
# LU inverse (reference qfloat_matrix_inversion.py:461-518)
# ---------------------------------------------------------------------------


def qfloat_lu_inverse(
    P, L, U, qfloat_len, qfloat_ints, true_division=False, tensorize=False, debug=False
):
    """Inverse from the P, L, U decomposition (QFloat 2D-lists).

    Row ``i`` of the solution depends only on row ``i`` of ``P`` (and on
    L, U), so each row is one :func:`lu_inverse_row`.
    """
    Ujj_inv = lu_inverse_diagonal(U, qfloat_len, true_division, tensorize)
    Y, X = [], []
    for Prow in P:
        Xi, Yi = lu_inverse_row(
            Prow, L, U, Ujj_inv, qfloat_len, qfloat_ints, true_division, tensorize
        )
        X.append(Xi)
        Y.append(Yi)
    if not debug:
        return transpose_2D_list(X)
    return transpose_2D_list(X), Y, X


def lu_inverse_diagonal(U, qfloat_len, true_division=False, tensorize=False):
    """Reciprocals of U's diagonal for the multiply-by-reciprocal solve
    (``None`` with true division)."""
    if true_division:
        return None
    n = len(U)
    if tensorize:
        return qf_multi_invert([U[j][j] for j in range(n)], 1, qfloat_len, 0)
    return [U[j][j].invert(1, qfloat_len, 0) for j in range(n)]


def lu_inverse_row(Prow, L, U, Ujj_inv, qfloat_len, qfloat_ints,
                   true_division=False, tensorize=False):
    """Row ``i`` of the solution: ``(X[i], Y[i])`` from row ``i`` of P."""
    n = len(L)
    Yi = []
    for j in range(n):
        Yi.append(lu_forward_step(j, Prow, L, Yi, tensorize))
    Xi = [Zero() for _ in range(n)]
    for j in range(n - 1, -1, -1):
        Xi[j] = lu_backward_step(j, Yi, U, Ujj_inv, Xi, qfloat_len,
                                 qfloat_ints, true_division, tensorize)
    return Xi, Yi


def lu_forward_step(j, Prow, L, Yi, tensorize=False):
    """``Y[i][j]`` of the forward substitution L * Y = P (L's diagonal is 1,
    no division needed), from ``Y[i][:j]``."""
    if j == 0:
        return Prow[0].copy()
    return Prow[j] - qfloat_list_dot_product(
        [L[j][k] for k in range(j)], [Yi[k] for k in range(j)], tensorize
    )


def lu_backward_step(j, Yi, U, Ujj_inv, Xi, qfloat_len, qfloat_ints,
                     true_division=False, tensorize=False):
    """``X[i][j]`` of the backward substitution U * X = Y, from
    ``X[i][j+1:]``."""
    n = len(U)
    if j == n - 1:
        temp = Yi[-1]
    else:
        temp = Yi[j] - qfloat_list_dot_product(
            [U[j][k] for k in range(j + 1, n)],
            [Xi[k] for k in range(j + 1, n)],
            tensorize,
        )
    if true_division:
        return temp / U[j][j]
    return qf_from_mul(temp, Ujj_inv[j], qfloat_len, qfloat_ints)


# ---------------------------------------------------------------------------
# 2x2 closed form (reference qfloat_matrix_inversion.py:526-584)
# ---------------------------------------------------------------------------


def qfloat_inverse_2x2(qfloat_M, qfloat_len, qfloat_ints):
    """M_inv = adj(M) / det(M) with widened intermediate formats."""
    [a, b] = qfloat_M[0]
    [c, d] = qfloat_M[1]

    ad = qf_from_mul(a, d, 2 * qfloat_ints + 3, 2 * qfloat_ints)
    bc = qf_from_mul(b, c, 2 * qfloat_ints + 3, 2 * qfloat_ints)

    det = ad + bc.neg()
    det_inv = det.invert(1, qfloat_len, 0)

    mul = lambda x, y: qf_from_mul(x, y, qfloat_len, qfloat_ints)
    return [
        [mul(d, det_inv), mul(b, det_inv).neg()],
        [mul(c, det_inv).neg(), mul(a, det_inv)],
    ]


def qfloat_inverse_2x2_multi(qfloat_M, qfloat_len, qfloat_ints):
    """Tensorized variant (reference qfloat_matrix_inversion.py:558-584)."""
    [a, b] = qfloat_M[0]
    [c, d] = qfloat_M[1]

    [ad, bc] = qf_multi_from_mul([a, b], [d, c], 2 * qfloat_ints + 3, 2 * qfloat_ints)
    det = ad + bc.neg()
    det_inv = det.invert(1, qfloat_len, 0)
    [mula, mulb, mulc, muld] = qf_multi_from_mul(
        [a, b, c, d], [det_inv] * 4, qfloat_len, qfloat_ints
    )
    return [
        [muld, mulb.neg()],
        [mulc.neg(), mula],
    ]
