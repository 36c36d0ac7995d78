"""User-facing API: compile/quantize/encrypt/evaluate/decrypt/dequantize/run.

Re-design of the reference driver (reference matrix_inversion/main.py:
17-116) for an XLA device.  The mapping of the FHE lifecycle onto the XLA
runtime:

=================  =========================================================
reference step      equivalent here
=================  =========================================================
compiler.compile    ``jax.jit(...).lower(shapes).compile()`` (AOT, cached)
circuit.keygen      no-op (kept for API parity; XLA has no key material)
circuit.encrypt     quantize + pack + ``jax.device_put`` (commit to device)
circuit.run         run the compiled executable on device buffers
circuit.decrypt     ``np.asarray`` (device -> host)
circuit.simulate    eager (uncompiled) execution of the same function
=================  =========================================================

Unlike the reference, compilation needs example *shapes*, not an input set
of 100 samples — the sampler argument is kept for interface parity and for
shape/dtype validation.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import QFloatParams, knob_state, pinned_knob_state
from ..models.inverse import qfloat_matrix_inverse
from ..models.marshal import (
    float_matrix_to_qfloat_arrays,
    qfloat_and_signs_arrays_to_float_matrix,
)


def _circuit_fn(params: QFloatParams, backend: str, io: str,
                track: bool = False):
    """Shared circuit body per (params, backend, io, track, perf knobs) —
    one jit entry per configuration regardless of how many API objects are
    constructed.  The perf-knob state is part of the key so flipping a knob
    (``set_mul_group``, ``set_mul_impl``, ...) retraces instead of silently
    reusing the program compiled under the old knob values."""
    return _circuit_fn_cached(params, backend, io, track, knob_state())


@functools.lru_cache(maxsize=128)
def _circuit_fn_cached(params: QFloatParams, backend: str, io: str, track,
                       knobs):
    p = params
    if track:
        from ..models.inverse import qfloat_matrix_inverse_with_overflow

        return functools.partial(
            qfloat_matrix_inverse_with_overflow,
            n=p.n,
            qfloat_len=p.qfloat_len,
            qfloat_ints=p.qfloat_ints,
            qfloat_base=p.qfloat_base,
            true_division=p.true_division,
            tensorize=p.tensorize,
            lowering=p.lowering,
        )
    if io == "packed":
        from ..models.inverse import qfloat_matrix_inverse_packed_io

        return functools.partial(
            qfloat_matrix_inverse_packed_io,
            n=p.n,
            qfloat_len=p.qfloat_len,
            qfloat_ints=p.qfloat_ints,
            qfloat_base=p.qfloat_base,
            true_division=p.true_division,
            tensorize=p.tensorize,
            lowering=p.lowering,
        )
    return functools.partial(
        qfloat_matrix_inverse,
        n=p.n,
        qfloat_len=p.qfloat_len,
        qfloat_ints=p.qfloat_ints,
        qfloat_base=p.qfloat_base,
        true_division=p.true_division,
        tensorize=p.tensorize,
        backend=backend,
        lowering=p.lowering,
    )


def _jitted_circuit(params: QFloatParams, backend: str, io: str,
                    track: bool = False):
    return _jitted_circuit_cached(params, backend, io, track, knob_state())


@functools.lru_cache(maxsize=128)
def _jitted_circuit_cached(params: QFloatParams, backend: str, io: str,
                           track, knobs):
    fn = _circuit_fn_cached(params, backend, io, track, knobs)

    # jax.jit traces lazily: a cached jitted fn called on a NEW batch shape
    # after a knob flip would otherwise trace under the new knob values while
    # staying cached under the old knob key.  Pin every trace to the knob
    # tuple this entry was cached under.
    @functools.wraps(fn)
    def pinned(*args, **kwargs):
        with pinned_knob_state(knobs):
            return fn(*args, **kwargs)

    return jax.jit(pinned)


def _compiled_circuit(params: QFloatParams, backend: str, io: str,
                      batch_shape, track: bool = False):
    return _compiled_circuit_cached(
        params, backend, io, batch_shape, track, knob_state()
    )


@functools.lru_cache(maxsize=128)
def _compiled_circuit_cached(
    params: QFloatParams, backend: str, io: str, batch_shape, track, knobs
):
    """AOT-compiled executable, memoized per configuration, batch shape, and
    perf-knob state (see ``_circuit_fn``)."""
    p = params
    if io == "packed":
        arg0 = jax.ShapeDtypeStruct(batch_shape + (p.n * p.n,), jnp.int64)
        arg1 = arg0
    else:
        arg0 = jax.ShapeDtypeStruct(
            batch_shape + (p.n * p.n, p.qfloat_len), jnp.int64
        )
        arg1 = jax.ShapeDtypeStruct(batch_shape + (p.n * p.n,), jnp.int64)
    return (
        _jitted_circuit_cached(params, backend, io, track, knobs)
        .lower(arg0, arg1)
        .compile()
    )


class EncryptedMatrixInversion:
    """Single-matrix inversion API, mirroring reference main.py:17-116."""

    def __init__(
        self,
        n,
        sampler: Optional[Callable] = None,
        qfloat_base=2,
        qfloat_len=32,
        qfloat_ints=16,
        true_division=False,
        tensorize=False,
        backend="auto",
        io="digits",
        track_overflow=False,
    ):
        """``track_overflow=True`` (packed io only): ``run`` returns
        ``(inverse, overflowed)`` with a scalar int overflow flag (the
        reference's open TODO — see BatchedMatrixInversion)."""
        self.shape = (n, n)
        self.params = QFloatParams(
            n=n,
            qfloat_len=qfloat_len,
            qfloat_ints=qfloat_ints,
            qfloat_base=qfloat_base,
            true_division=true_division,
            tensorize=tensorize,
            backend=backend,
        )
        self.backend = self.params.resolve_backend()
        if io not in ("digits", "packed"):
            raise ValueError("io must be digits|packed")
        if io == "packed" and self.backend != "packed":
            raise ValueError(
                "packed io requires the packed backend (base=2^k encoding "
                "that fits in int64)"
            )
        if track_overflow and io != "packed":
            raise ValueError("track_overflow requires io='packed'")
        # packed io: 1 magnitude word per cell on both sides of the circuit
        # instead of `qfloat_len` digit words (qfloat_len x less I/O)
        self.io = io
        self.track_overflow = track_overflow

        if sampler is not None:
            # interface parity with the reference input set validation
            # (reference main.py:41-46); 3 samples are plenty to check shape
            for _ in range(3):
                sample = sampler()
                assert isinstance(sample, np.ndarray)
                assert np.issubdtype(sample.dtype, np.floating)
                assert sample.shape == self.shape

        self._fn = _circuit_fn(self.params, self.backend, io, track_overflow)
        self._jitted = _jitted_circuit(
            self.params, self.backend, io, track_overflow
        )
        # "compile" — the reference's minutes-long concrete step is an XLA
        # AOT compile here (reference main.py:66), memoized per config
        self.circuit = _compiled_circuit(
            self.params, self.backend, io, (), track_overflow
        )

    # ---- lifecycle steps (reference main.py:68-91) ------------------------
    def keygen(self):
        """FHE key generation has no XLA analog; kept for API parity."""
        return None

    def quantize(self, matrix: np.ndarray):
        p = self.params
        if self.io == "packed":
            from ..models.marshal import float_matrix_to_mags_and_signs

            return float_matrix_to_mags_and_signs(
                matrix, p.qfloat_len, p.qfloat_ints, p.qfloat_base
            )
        return float_matrix_to_qfloat_arrays(
            matrix, p.qfloat_len, p.qfloat_ints, p.qfloat_base
        )

    def encrypt(self, quantized_matrix, qfloat_signs):
        """Commit plaintext digits to the device ("ciphertext" buffers)."""
        return (
            jax.device_put(jnp.asarray(quantized_matrix, jnp.int64)),
            jax.device_put(jnp.asarray(qfloat_signs, jnp.int64)),
        )

    def evaluate(self, encrypted):
        digits, signs = encrypted
        return self.circuit(digits, signs)

    def decrypt(self, encrypted_result):
        out = jax.block_until_ready(encrypted_result)
        if isinstance(out, tuple):
            return tuple(np.asarray(o) for o in out)
        return np.asarray(out)

    def dequantize(self, quantized_inverted_matrix):
        p = self.params
        if self.io == "packed":
            from ..models.marshal import mags_and_signs_to_float_matrix

            mags, signs = quantized_inverted_matrix[:2]
            matrix = mags_and_signs_to_float_matrix(
                np.asarray(mags), np.asarray(signs),
                p.qfloat_len, p.qfloat_ints, p.qfloat_base,
            )
            if self.track_overflow:
                return matrix, int(np.asarray(quantized_inverted_matrix[2]))
            return matrix
        return qfloat_and_signs_arrays_to_float_matrix(
            quantized_inverted_matrix, p.qfloat_ints, p.qfloat_base
        )

    def run(self, matrix: np.ndarray, simulate=False):
        """Invert one matrix.  Returns the (n, n) inverse, or
        ``(inverse, overflowed)`` when ``track_overflow`` is set."""
        assert np.issubdtype(matrix.dtype, np.floating)
        assert matrix.shape == self.shape

        quantized_matrix, qfloat_signs = self.quantize(matrix)
        if not simulate:
            encrypted = self.encrypt(quantized_matrix, qfloat_signs)
            encrypted_result = self.evaluate(encrypted)
            quantized_inverted = self.decrypt(encrypted_result)
        else:
            # eager execution of the same traced body (reference main.py:107)
            quantized_inverted = self._fn(
                jnp.asarray(quantized_matrix, jnp.int64),
                jnp.asarray(qfloat_signs, jnp.int64),
            )
            if isinstance(quantized_inverted, tuple):
                quantized_inverted = tuple(
                    np.asarray(o) for o in quantized_inverted
                )
            else:
                quantized_inverted = np.asarray(quantized_inverted)
        out = self.dequantize(quantized_inverted)
        inverted = out[0] if self.track_overflow else out
        assert np.issubdtype(inverted.dtype, np.floating)
        assert inverted.shape == self.shape
        return out


class BatchedMatrixInversion:
    """Flagship batched API: invert (B, n, n) matrices in one device program.

    This is the batched execution model the reference lacks: the entire
    10^4-inversion precision benchmark (reference
    qfloat_matrix_inversion.py:883-970) becomes ONE compiled program over a
    batch axis, optionally sharded over a device mesh (see
    ``parallel.mesh``).
    """

    def __init__(
        self,
        params: QFloatParams,
        batch_size: int,
        backend: str = "auto",
        io: str = "digits",
        in_shardings=None,
        out_shardings=None,
        donate: bool = False,
        data_parallel: bool = None,
        track_overflow: bool = False,
    ):
        """``data_parallel``: None = auto.  In a multi-GPU process with
        packed io and a fused-eligible config, auto builds the
        shard_map-wrapped fused kernel over all devices
        (``parallel.mesh.data_parallel_inverse_fused``) — the
        ``lowering="auto"`` policy for several devices.  True forces it
        (any backend incl. the CPU test mesh, where the kernel runs in
        interpret mode); False disables.

        ``track_overflow=True`` (packed io only) compiles the tracked
        circuit (``qfloat_matrix_inverse_with_overflow``): ``run`` then
        returns ``(inverses, overflowed)`` where ``overflowed`` is an
        int (B,) flag per matrix — the reference's open TODO (its
        qfloat.py:255-257; overflow is its documented main big-error
        source), so production callers can reject saturated results."""
        if backend != "auto":
            params = params.replace(backend=backend)
        self.params = params
        self.backend = params.resolve_backend()
        if io not in ("digits", "packed"):
            raise ValueError("io must be digits|packed")
        if io == "packed" and self.backend != "packed":
            raise ValueError("packed io requires the packed backend")
        if track_overflow and io != "packed":
            raise ValueError("track_overflow requires io='packed'")
        self.io = io
        self.track_overflow = track_overflow
        self.batch_size = batch_size
        p = params

        if data_parallel is None:
            from ..models.inverse import FUSED_MAX_N

            data_parallel = (
                io == "packed"
                and in_shardings is None
                and out_shardings is None
                and not donate
                and params.lowering in ("auto", "fused")
                and params.n <= FUSED_MAX_N
                and jax.default_backend() == "gpu"
                and jax.device_count() > 1
                and batch_size % jax.device_count() == 0
            )
        if data_parallel:
            if io != "packed":
                raise ValueError("data_parallel requires io='packed'")
            if batch_size % jax.device_count():
                raise ValueError(
                    "data_parallel needs batch_size divisible by "
                    f"device_count ({jax.device_count()})"
                )
            from ..parallel.mesh import data_parallel_inverse_fused, make_mesh

            mesh = make_mesh(axis_names=("data",))
            self._jitted = data_parallel_inverse_fused(
                params, mesh, track=track_overflow
            )
            self._fn = self._jitted  # simulate path == compiled path here
            arg0 = jax.ShapeDtypeStruct((batch_size, p.n * p.n), jnp.int64)
            self.circuit = self._jitted.lower(arg0, arg0).compile()
            return

        self._fn = _circuit_fn(self.params, self.backend, io, track_overflow)
        if in_shardings is not None or out_shardings is not None or donate:
            kw = {}
            if in_shardings is not None:
                kw["in_shardings"] = in_shardings
            if out_shardings is not None:
                kw["out_shardings"] = out_shardings
            if donate:
                kw["donate_argnums"] = (0, 1)
            self._jitted = jax.jit(self._fn, **kw)
            if io == "packed":
                arg0 = jax.ShapeDtypeStruct((batch_size, p.n * p.n), jnp.int64)
                arg1 = arg0
            else:
                arg0 = jax.ShapeDtypeStruct(
                    (batch_size, p.n * p.n, p.qfloat_len), jnp.int64
                )
                arg1 = jax.ShapeDtypeStruct((batch_size, p.n * p.n), jnp.int64)
            self.circuit = self._jitted.lower(arg0, arg1).compile()
        else:
            self._jitted = _jitted_circuit(
                self.params, self.backend, io, track_overflow
            )
            self.circuit = _compiled_circuit(
                self.params, self.backend, io, (batch_size,), track_overflow
            )

    def quantize(self, matrices: np.ndarray):
        p = self.params
        if self.io == "packed":
            from ..models.marshal import float_matrix_to_mags_and_signs

            return float_matrix_to_mags_and_signs(
                matrices, p.qfloat_len, p.qfloat_ints, p.qfloat_base
            )
        return float_matrix_to_qfloat_arrays(
            matrices, p.qfloat_len, p.qfloat_ints, p.qfloat_base
        )

    def dequantize(self, out):
        p = self.params
        if self.io == "packed":
            from ..models.marshal import mags_and_signs_to_float_matrix

            mags, signs = out[0], out[1]
            matrices = mags_and_signs_to_float_matrix(
                np.asarray(mags), np.asarray(signs),
                p.qfloat_len, p.qfloat_ints, p.qfloat_base,
            )
            if self.track_overflow:
                return matrices, np.asarray(out[2])
            return matrices
        return qfloat_and_signs_arrays_to_float_matrix(
            np.asarray(out), p.qfloat_ints, p.qfloat_base
        )

    def run_raw(self, *device_args):
        """Device input tensors -> device output tensors (async)."""
        return self.circuit(*device_args)

    def run(self, matrices: np.ndarray):
        """Invert a (B, n, n) float batch.  Returns the (B, n, n) inverses,
        or ``(inverses, overflowed)`` when ``track_overflow`` is set."""
        p = self.params
        assert matrices.shape == (self.batch_size, p.n, p.n)
        a, b = self.quantize(matrices)
        out = self.circuit(jnp.asarray(a, jnp.int64), jnp.asarray(b, jnp.int64))
        return self.dequantize(jax.block_until_ready(out))
