"""Per-op compiled circuits — the reference FHE integration tier.

Reference tests/test_qfloat_fhe.py compiles one Concrete circuit per QFloat
operator and runs real encrypt/run/decrypt; the analog here compiles one XLA
executable per operator and checks (a) |circuit result - float result| <
0.01 and (b) compiled == eager bit-parity (SURVEY.md section 4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from matrix_inversion_tpu.core.qfloat import QFloat, SignedBinary
from matrix_inversion_tpu.ops.packed import PackedQFloat
from matrix_inversion_tpu.ops import radix

POWER = 1
BASE = 2 ** POWER
SIZE = int(np.ceil(32 / POWER))
INTS = SIZE // 2


class QFloatCircuit:
    """Compile a QFloat-list circuit function into an XLA executable.

    Mirror of reference tests/test_qfloat_fhe.py:120-180: float lists are
    quantized to digit/sign arrays, the circuit body reconstructs QFloats,
    applies ``circuit_fn``, and emits a (len+1)-wide digit+sign array.
    """

    def __init__(self, n_values, circuit_fn, backend):
        self.backend = backend
        self.n = n_values

        def body(digit_arrays, signs):
            qfs = []
            for i in range(n_values):
                if backend == "packed":
                    qf = PackedQFloat.from_digits(
                        digit_arrays[i], INTS, BASE, signs[i]
                    )
                else:
                    qf = QFloat(digit_arrays[i], INTS, BASE, True, signs[i])
                qfs.append(qf)
            out = circuit_fn(qfs)
            digits = out.to_digits().astype(jnp.int64)
            sign = jnp.broadcast_to(jnp.asarray(out.sign, jnp.int64), ())
            return jnp.concatenate([digits, sign[None]], axis=-1)

        self._eager = body
        self._compiled = jax.jit(body)

    def run(self, float_list):
        digits, signs = radix.float_to_digits_and_sign(
            np.asarray(float_list), SIZE, INTS, BASE
        )
        digits = jnp.asarray(digits)
        signs = jnp.asarray(signs)
        compiled = np.asarray(self._compiled(digits, signs))
        eager = np.asarray(self._eager(digits, signs))
        np.testing.assert_array_equal(compiled, eager)  # jit == eager
        return radix.digits_and_sign_to_float(
            compiled[:-1], compiled[-1], INTS, BASE
        )


BACKENDS = ["limb", "packed"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_add_circuit(rng, backend):
    circuit = QFloatCircuit(2, lambda qfs: qfs[0] + qfs[1], backend)
    for _ in range(3):
        f = rng.uniform(-100, 100, 2)
        assert abs(circuit.run(f) - (f[0] + f[1])) < 0.01


@pytest.mark.parametrize("backend", BACKENDS)
def test_mul_circuit(rng, backend):
    circuit = QFloatCircuit(2, lambda qfs: qfs[0] * qfs[1], backend)
    for _ in range(3):
        f = rng.uniform(-10, 10, 2)
        assert abs(circuit.run(f) - (f[0] * f[1])) < 0.01


@pytest.mark.parametrize("backend", BACKENDS)
def test_mul_signed_binary_circuit(rng, backend):
    circuit = QFloatCircuit(
        2, lambda qfs: qfs[0] * SignedBinary(qfs[1].sign), backend
    )
    f = rng.uniform(-10, 10, 2)
    assert abs(circuit.run(f) - (f[0] * np.sign(f[1]))) < 0.01


@pytest.mark.parametrize("backend", BACKENDS)
def test_from_mul_cross_format_circuit(rng, backend):
    cls = {"limb": QFloat, "packed": PackedQFloat}[backend]
    circuit = QFloatCircuit(
        2, lambda qfs: cls.from_mul(qfs[0], qfs[1], SIZE, INTS), backend
    )
    f = rng.uniform(-10, 10, 2)
    assert abs(circuit.run(f) - (f[0] * f[1])) < 0.01


@pytest.mark.parametrize("backend", BACKENDS)
def test_neg_circuit(rng, backend):
    circuit = QFloatCircuit(1, lambda qfs: -qfs[0], backend)
    f = rng.uniform(-100, 100, 1)
    assert abs(circuit.run(f) - (-f[0])) < 0.01


@pytest.mark.parametrize("backend", BACKENDS)
def test_div_circuit(rng, backend):
    circuit = QFloatCircuit(2, lambda qfs: qfs[0] / qfs[1], backend)
    for _ in range(3):
        f = rng.uniform(1, 10, 2) * rng.choice([-1, 1], 2)
        assert abs(circuit.run(f) - (f[0] / f[1])) < 0.01


@pytest.mark.parametrize("backend", BACKENDS)
def test_fused_chain_circuit(rng, backend):
    # (a + a + a - b) * a — the reference's timing probe circuit
    # (tests/test_qfloat_fhe.py:315-335)
    circuit = QFloatCircuit(
        2, lambda qfs: (qfs[0] + qfs[0] + qfs[0] - qfs[1]) * qfs[0], backend
    )
    f = rng.uniform(-5, 5, 2)
    assert abs(circuit.run(f) - ((3 * f[0] - f[1]) * f[0])) < 0.1
