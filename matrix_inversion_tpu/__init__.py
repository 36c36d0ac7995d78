"""matrix_inversion_tpu — an exact-matrix-inversion framework for accelerators.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of Zama's
``bounty-matrix-inversion`` (exact LU matrix inversion over QFloat fixed-point
numbers encoded as base-p digit arrays, reference: /root/reference).

Architecture:

* ``ops.radix``   — host-side float/int <-> base-p digit conversion (L1).
* ``ops.limbs``   — batched digit-array device kernels: carry/borrow
  propagation via ``lax.scan``, long division, comparison.  Works for any
  base; semantically 1:1 with the reference limb functions
  (reference ``matrix_inversion/base_p_arrays.py``).
* ``core.qfloat`` — the QFloat / SignedBinary / Zero number types
  (reference ``matrix_inversion/qfloat.py``), natively *batched*: every op
  broadcasts over leading batch dimensions instead of the reference's
  trace-time scalar loops.
* ``ops.packed``  — the fast path: a base-tidy QFloat with
  ``base**len < 2**62`` is represented exactly as ``(magnitude: int64,
  sign: int32)``.  All reference semantics (including the non-value-function
  per-partial-product cropping of ``from_mul`` and division-by-zero
  saturation) are reproduced with shift/mask arithmetic; carry propagation
  ("tidy") becomes a single mod-mask.
* ``models``      — float LU oracle, QFloat pivot/LU/inverse, 2x2 closed
  form, and the circuit entry points
  (reference ``matrix_inversion/qfloat_matrix_inversion.py``).
* ``runtime.api`` — the user API (``EncryptedMatrixInversion``:
  quantize/encrypt/evaluate/decrypt/dequantize/run; reference
  ``matrix_inversion/main.py``) where "compile" is ``jax.jit`` lowering and
  "simulate" is eager execution.
* ``ops.fused_inverse`` — the whole inversion as a few Pallas kernels
  through Triton, one per group of algorithm stages (the default on a
  single GPU for small n).
* ``parallel``    — ``jax.sharding.Mesh`` data/cell-parallel execution of
  large inversion batches over several devices and hosts.
"""

import os as _os

import jax

# The packed fast path stores QFloat magnitudes in int64 (base**len < 2**62).
# This must happen before any jax computation runs.
jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache (the analog of the reference's FHE key
# cache, reference qfloat_matrix_inversion.py:997-998 `.keys`): circuit
# compilation takes minutes, so executables are kept across processes.
# JAX_COMPILATION_CACHE_DIR, when set, is honoured by JAX itself; otherwise
# the cache lives at a fixed path inside the checkout, because the path is
# part of the cache key.
if "JAX_COMPILATION_CACHE_DIR" not in _os.environ:
    jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache",
        ),
    )
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from .config import QFloatParams, PRESETS, LOW, MEDIUM, MEDIUM_PLUS, HIGH  # noqa: E402
from .core.qfloat import QFloat, SignedBinary, Zero, QFloatBase  # noqa: E402
from .ops.packed import PackedQFloat  # noqa: E402
from .models.inverse import (  # noqa: E402
    qfloat_matrix_inverse,
    qfloat_pivot,
    qfloat_lu_L,
    qfloat_lu_U,
)
from .models.marshal import (  # noqa: E402
    float_matrix_to_qfloat_arrays,
    qfloat_and_signs_arrays_to_float_matrix,
)
from .runtime.api import EncryptedMatrixInversion, BatchedMatrixInversion  # noqa: E402

__all__ = [
    "QFloatParams",
    "PRESETS",
    "LOW",
    "MEDIUM",
    "MEDIUM_PLUS",
    "HIGH",
    "QFloat",
    "PackedQFloat",
    "QFloatBase",
    "SignedBinary",
    "Zero",
    "qfloat_matrix_inverse",
    "qfloat_pivot",
    "qfloat_lu_L",
    "qfloat_lu_U",
    "float_matrix_to_qfloat_arrays",
    "qfloat_and_signs_arrays_to_float_matrix",
    "EncryptedMatrixInversion",
    "BatchedMatrixInversion",
]

__version__ = "0.1.0"
