"""Debug drivers: PLU comparison dumps and single-shot python inversion.

Analogs of the reference debug harness
(reference qfloat_matrix_inversion.py:763-880): run the QFloat circuit
eagerly on one matrix and compare P/L/U/Y/X against the float oracle.
"""

from __future__ import annotations

import numpy as np

from ..config import QFloatParams
from ..models import lu_float
from ..models.marshal import (
    float_matrix_to_qfloat_arrays,
    qfloat_and_signs_arrays_to_float_matrix,
    qfloat_arrays_to_qfloat_matrix,
    qfloat_matrix_to_arrays_and_signs,
)
from ..models.qfloat_lu import (
    map_2D_list,
    qfloat_lu_decomposition,
    qfloat_lu_inverse,
)
from ..models.inverse import qfloat_matrix_inverse


def run_qfloat_inverse(M, params: QFloatParams, backend=None):
    """One eager QFloat inversion -> float matrix (reference :831-845)."""
    p = params
    backend = backend or p.resolve_backend()
    digits, signs = float_matrix_to_qfloat_arrays(
        M, p.qfloat_len, p.qfloat_ints, p.qfloat_base
    )
    out = qfloat_matrix_inverse(
        digits, signs, p.n, p.qfloat_len, p.qfloat_ints, p.qfloat_base,
        p.true_division, p.tensorize, backend,
    )
    return qfloat_and_signs_arrays_to_float_matrix(
        np.asarray(out), p.qfloat_ints, p.qfloat_base
    )


def compare_plu(M, params: QFloatParams, backend=None, verbose=True):
    """QFloat PLU vs float-oracle PLU (reference test_qfloat_PLU_python,
    :763-828).  Returns dict of (P, L, U) pairs and max abs deviations."""
    p = params
    backend = backend or p.resolve_backend()
    digits, signs = float_matrix_to_qfloat_arrays(
        M, p.qfloat_len, p.qfloat_ints, p.qfloat_base
    )
    qfloat_M = qfloat_arrays_to_qfloat_matrix(
        digits, signs, p.qfloat_ints, p.qfloat_base, backend
    )
    bin_P, qf_L, qf_U = qfloat_lu_decomposition(
        qfloat_M, p.qfloat_len, p.qfloat_ints, p.true_division, p.tensorize
    )
    P = np.array(map_2D_list(bin_P, lambda x: np.asarray(x.value)))
    L = qfloat_and_signs_arrays_to_float_matrix(
        np.asarray(
            qfloat_matrix_to_arrays_and_signs(
                qf_L, p.qfloat_len, p.qfloat_ints, p.qfloat_base
            )
        ),
        p.qfloat_ints,
        p.qfloat_base,
    )
    U = qfloat_and_signs_arrays_to_float_matrix(
        np.asarray(
            qfloat_matrix_to_arrays_and_signs(
                qf_U, p.qfloat_len, p.qfloat_ints, p.qfloat_base
            )
        ),
        p.qfloat_ints,
        p.qfloat_base,
    )
    P_, L_, U_ = lu_float.lu_decomposition(np.asarray(M, dtype=np.float64))
    result = {
        "P": (P, P_),
        "L": (L, L_),
        "U": (U, U_),
        "max_dev": {
            "P": float(np.max(np.abs(P - P_))),
            "L": float(np.max(np.abs(L - L_))),
            "U": float(np.max(np.abs(U - U_))),
        },
    }
    if verbose:
        for name in ("P", "L", "U"):
            qf, fl = result[name]
            print(f" {name} MATRIX\n============")
            print(f"QFloat {name} :\n{qf}\n")
            print(f"PLU {name} :\n{fl}\n")
    return result


def debug_inverse(M, params: QFloatParams, backend=None, verbose=True):
    """Full L/U/Y/X dump vs the float oracle for a suspect matrix
    (reference debug path, :921-967)."""
    p = params
    backend = backend or p.resolve_backend()
    digits, signs = float_matrix_to_qfloat_arrays(
        M, p.qfloat_len, p.qfloat_ints, p.qfloat_base
    )
    qfloat_M = qfloat_arrays_to_qfloat_matrix(
        digits, signs, p.qfloat_ints, p.qfloat_base, backend
    )
    bin_P, qf_L, qf_U = qfloat_lu_decomposition(
        qfloat_M, p.qfloat_len, p.qfloat_ints, p.true_division, p.tensorize
    )
    Minv, qf_Y, qf_X = qfloat_lu_inverse(
        bin_P, qf_L, qf_U, p.qfloat_len, p.qfloat_ints, p.true_division,
        p.tensorize, debug=True,
    )
    to_float = lambda x: float(np.asarray(x.to_float())) if hasattr(x, "to_float") else float(np.asarray(x))
    L = map_2D_list(qf_L, to_float)
    U = map_2D_list(qf_U, to_float)
    Y = map_2D_list(qf_Y, to_float)
    X = map_2D_list(qf_X, to_float)
    P_, L_, U_ = lu_float.lu_decomposition(np.asarray(M, dtype=np.float64))
    Minv_, Y_, X_ = lu_float.lu_inverse(P_, L_, U_, debug=True)
    if verbose:
        print("\nL", L, L_, "\nU", U, U_, "\nX", X, X_, "\nY", Y, Y_, sep="\n")
    return {"L": (L, L_), "U": (U, U_), "Y": (Y, Y_), "X": (X, X_)}
