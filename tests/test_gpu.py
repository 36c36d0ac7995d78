"""Card-only tests: the compiled Triton kernels on a GPU.

Every test here is marked ``gpu`` and takes the ``gpu`` fixture, which
skips unless JAX's default backend is a GPU.  The decision is made when the
test runs, never at import.  The CPU suite therefore skips them;
``python chip_smoke.py`` runs them on the card (in its own process, without
tests/conftest.py, which would force the CPU).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from matrix_inversion_tpu import LOW
from matrix_inversion_tpu.models.inverse import qfloat_matrix_inverse_packed_io
from matrix_inversion_tpu.models.marshal import float_matrix_to_mags_and_signs
from matrix_inversion_tpu.ops import pair_math as pm
from matrix_inversion_tpu.ops.fused_inverse import fused_matrix_inverse
from matrix_inversion_tpu.ops.packed import _float_div_chunk_bits
from pair_cases import adversarial_pairs

pytestmark = pytest.mark.gpu

_BLOCK = 1024


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; run `python chip_smoke.py` on the card")


@pytest.fixture
def rng():
    return np.random.RandomState(42)


def _div_float_kernel(n_bits, k, vhi, vlo, dhi, dlo, qhi, qlo):
    qhi[...], qlo[...] = pm.div_float(
        vhi[...], vlo[...], dhi[...], dlo[...], n_bits, k
    )


def _div_float_triton(dividend, divisor, n_bits, k):
    """pair_math.div_float compiled by Triton, one block per program."""
    n = dividend.shape[0]
    spec = pl.BlockSpec((_BLOCK,), lambda i: (i,))
    out = jax.ShapeDtypeStruct((n,), jnp.uint32)
    call = pl.pallas_call(
        functools.partial(_div_float_kernel, n_bits, k),
        grid=(n // _BLOCK,),
        in_specs=[spec] * 4,
        out_specs=(spec, spec),
        out_shape=(out, out),
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=1),
        backend="triton",
    )
    qhi, qlo = jax.jit(call)(*pm.split64(dividend), *pm.split64(divisor))
    return np.asarray(pm.join64(qhi, qlo).astype(jnp.int64))


@pytest.mark.parametrize("divisor_bits,n_bits", [(40, 61), (23, 46), (47, 61)])
def test_div_float_triton_exact(gpu, rng, divisor_bits, n_bits):
    """The f32 estimate inside Triton (approximate divide, FMA contraction)
    stays inside the fixup budget: exact against numpy on the floor
    boundary cases."""
    k = _float_div_chunk_bits(n_bits, divisor_bits)
    av, bv = adversarial_pairs(rng, divisor_bits, n_bits, 16 * _BLOCK)
    dividend = np.concatenate([
        av,
        rng.randint(0, 1 << n_bits, size=4 * _BLOCK, dtype=np.uint64).astype(np.int64),
    ])
    divisor = np.concatenate([
        bv,
        rng.randint(0, 1 << divisor_bits, size=4 * _BLOCK, dtype=np.uint64).astype(np.int64),
    ])
    divisor[-5:] = 0
    q = _div_float_triton(jnp.asarray(dividend), jnp.asarray(divisor), n_bits, k)
    nz = divisor != 0
    np.testing.assert_array_equal(
        q[nz].astype(np.uint64),
        dividend[nz].astype(np.uint64) // divisor[nz].astype(np.uint64),
    )
    np.testing.assert_array_equal(q[~nz], np.full(np.sum(~nz), (1 << n_bits) - 1))


def test_fused_triton_matches_unroll(gpu):
    """Compiled fused kernel == XLA unroll lowering on the card, bit for bit,
    singular rows included."""
    p = LOW.replace(n=3)
    M = np.random.RandomState(7).randn(4096 + 3, 3, 3) * 100
    M[:64, 2] = M[:64, 0] + M[:64, 1]  # singular rows
    mags, signs = float_matrix_to_mags_and_signs(
        M, p.qfloat_len, p.qfloat_ints, p.qfloat_base
    )
    mags, signs = jnp.asarray(mags), jnp.asarray(signs)
    args = (3, p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division)
    got = jax.jit(lambda m, s: fused_matrix_inverse(m, s, *args))(mags, signs)
    ref = jax.jit(
        lambda m, s: qfloat_matrix_inverse_packed_io(m, s, *args, lowering="unroll")
    )(mags, signs)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
