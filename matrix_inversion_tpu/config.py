"""Configuration objects for the matrix-inversion framework.

The reference threads a positional ``params`` list
``[n, qfloat_len, qfloat_ints, qfloat_base, true_division, tensorize]``
through every entry point (reference qfloat_matrix_inversion.py:1230) and
keeps the Low/Medium/High precision presets as comments in code
(reference main.py:135-155, README.md:107-116).  Here they are first-class.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class QFloatParams:
    """Static QFloat encoding + algorithm configuration.

    Attributes:
      n:             matrix dimension (n x n).
      qfloat_len:    total number of base-p digits per QFloat.
      qfloat_ints:   number of digits before the dot.
      qfloat_base:   digit base p (2 = binary).
      true_division: use true long divisions in LU instead of multiplying by
                     a precomputed reciprocal (more precise, slower;
                     reference qfloat_matrix_inversion.py:384-385).
      tensorize:     group independent scalar QFloat muls/inverts into one
                     wide tensor op (reference qfloat.py:1023-1181).  Every
                     op is already batched here, so this only changes the
                     limb-backend op grouping; results are identical.
      backend:       "packed" (int64 fast path), "limb" (digit arrays), or
                     "auto" (packed whenever the encoding fits in int64).
      lowering:      circuit lowering style for the packed-I/O path:
                     "unroll" traces every QFloat op into the graph (fastest
                     execution at small n), "scan" lowers the LU recurrence
                     as nested ``lax.scan``s (graph size — and XLA compile
                     time — independent of n), "vec" vectorizes each sweep
                     with a static outer loop (O(n^2) graph, no wasted
                     lanes; both in models/qfloat_lu_scan.py), "fused" runs
                     the whole inversion as a few register-resident
                     Pallas kernels through Triton (ops/fused_inverse.py),
                     "auto" picks by n and backend.  Results are bit-identical.
    """

    n: int = 2
    qfloat_len: int = 23
    qfloat_ints: int = 9
    qfloat_base: int = 2
    true_division: bool = False
    tensorize: bool = False
    backend: str = "auto"
    lowering: str = "auto"

    def __post_init__(self):
        if self.qfloat_base < 2:
            raise ValueError("qfloat_base must be >= 2")
        if not (0 <= self.qfloat_ints <= self.qfloat_len):
            raise ValueError("qfloat_ints must be in [0, qfloat_len]")
        if self.backend not in ("auto", "packed", "limb"):
            raise ValueError("backend must be auto|packed|limb")
        if self.lowering not in ("auto", "scan", "vec", "unroll", "fused"):
            raise ValueError("lowering must be auto|scan|vec|unroll|fused")

    @property
    def frac(self) -> int:
        """Number of digits after the dot."""
        return self.qfloat_len - self.qfloat_ints

    def digit_bits(self) -> Optional[int]:
        """log2(base) if base is a power of two, else None."""
        b = self.qfloat_base
        if b & (b - 1) == 0:
            return b.bit_length() - 1
        return None

    def packed_ok(self) -> bool:
        """Whether the int64 packed backend can represent this encoding.

        The widest intermediate is the ``invert``/division dividend of
        ``1 + frac_self + frac_new`` digits (reference qfloat.py:1287-1295),
        bounded here by 3*qfloat_len digits of headroom under 2**62.
        """
        bits = self.digit_bits()
        if bits is None:
            return False
        # dividend for invert(1, len, 0): 1 + frac + len digits; keep margin.
        max_digits = 1 + self.frac + self.qfloat_len
        return max_digits * bits <= 62

    def resolve_backend(self) -> str:
        if self.backend == "auto":
            return "packed" if self.packed_ok() else "limb"
        if self.backend == "packed" and not self.packed_ok():
            raise ValueError(
                f"packed backend cannot represent base={self.qfloat_base} "
                f"len={self.qfloat_len} (needs base**(~3*len) < 2**62)"
            )
        return self.backend

    def replace(self, **kw) -> "QFloatParams":
        return dataclasses.replace(self, **kw)

    def as_list(self):
        """Positional params list, for reference-shaped call sites."""
        return [
            self.n,
            self.qfloat_len,
            self.qfloat_ints,
            self.qfloat_base,
            self.true_division,
            self.tensorize,
        ]


def knob_state() -> tuple:
    """Current values of every module-global performance knob.

    The lowering knobs (`set_mul_group`, `set_division_impl`,
    `set_mul_impl`, ...) change the TRACED program, so any
    compiled-circuit memoization must key on them — otherwise flipping a
    knob between two API constructions silently returns the program compiled
    under the old knob values (results are bit-identical either way, but A/B
    perf sweeps would measure nothing).  runtime/api.py includes this tuple
    in its jit/AOT cache keys; changing any knob therefore retraces.
    """
    from .ops import packed, pair_qfloat

    return (
        packed._DIVISION_IMPL,
        packed._MUL_SCAN,
        packed._MUL_GROUP,
        packed._MUL_TRUNC,
        pair_qfloat._MUL_IMPL,
        pair_qfloat._SADD_IMPL,
    )


@contextlib.contextmanager
def pinned_knob_state(knobs: tuple):
    """Temporarily set every perf knob to a previous :func:`knob_state` tuple.

    jax.jit traces lazily, so a jitted circuit cached under one knob tuple
    can be *called* (and hence traced, on a new batch shape) after a knob
    was flipped.  Wrapping the circuit body in this context pins the trace
    to the knob values it was cached under (runtime/api.py).
    """
    from .ops import packed, pair_qfloat

    names = [
        (packed, "_DIVISION_IMPL"),
        (packed, "_MUL_SCAN"),
        (packed, "_MUL_GROUP"),
        (packed, "_MUL_TRUNC"),
        (pair_qfloat, "_MUL_IMPL"),
        (pair_qfloat, "_SADD_IMPL"),
    ]
    saved = [getattr(mod, name) for mod, name in names]
    for (mod, name), value in zip(names, knobs):
        setattr(mod, name, value)
    try:
        yield
    finally:
        for (mod, name), value in zip(names, saved):
            setattr(mod, name, value)


# Precision presets (reference README.md:107-116, main.py:135-155).
LOW = QFloatParams(qfloat_len=23, qfloat_ints=9, true_division=False)
MEDIUM = QFloatParams(qfloat_len=31, qfloat_ints=16, true_division=False)
MEDIUM_PLUS = QFloatParams(qfloat_len=31, qfloat_ints=16, true_division=True)
HIGH = QFloatParams(qfloat_len=40, qfloat_ints=20, true_division=True)

PRESETS = {
    "low": LOW,
    "medium": MEDIUM,
    "medium+": MEDIUM_PLUS,
    "high": HIGH,
}
