"""Fused whole-inversion kernel: bit-exactness vs the unrolled lowering.

Two layers of proof:
* the staged composition (the stage functions, their merging into kernels,
  the state passed between them and the row-grid substitution) is run
  eagerly on whole arrays (``pallas=False``) against the packed unrolled
  circuit — full digit/sign equality across presets and sizes, fast
  enough for the core tier;
* the actual ``pallas_call`` plumbing (block grid, padding, per-n block
  choice) runs in interpret mode on small cases, and the kernel is lowered
  for CUDA through Triton without a card (``jax.export``), which catches a
  primitive with no Triton lowering before any run on the GPU.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from matrix_inversion_tpu import HIGH, LOW, MEDIUM
from matrix_inversion_tpu.models.inverse import qfloat_matrix_inverse_packed_io
from matrix_inversion_tpu.models.marshal import float_matrix_to_qfloat_arrays
from matrix_inversion_tpu.ops import pair_math as pm
from matrix_inversion_tpu.ops import radix
from matrix_inversion_tpu.ops import fused_inverse as fi
from matrix_inversion_tpu.ops.fused_inverse import fused_matrix_inverse


def quantize(p, n, B, seed):
    rng = np.random.RandomState(seed)
    M = rng.randn(B, n, n) * 100
    digits, signs = float_matrix_to_qfloat_arrays(
        M, p.qfloat_len, p.qfloat_ints, p.qfloat_base
    )
    mags = jnp.asarray(radix.pack_digits(digits, p.qfloat_base))
    return mags, jnp.asarray(signs)


def unroll_reference(p, n, mags, signs):
    return qfloat_matrix_inverse_packed_io(
        mags, signs, n, p.qfloat_len, p.qfloat_ints, p.qfloat_base,
        p.true_division, lowering="unroll",
    )


@pytest.mark.parametrize(
    "preset,n",
    [(HIGH, 2), (HIGH, 3), (HIGH, 4), (HIGH, 5), (LOW, 4), (MEDIUM, 3)],
)
def test_fused_body_bit_exact(preset, n):
    """The stages the kernels run, applied to the whole batch."""
    p = preset.replace(n=n)
    mags, signs = quantize(p, n, 64, seed=n)
    ref_m, ref_s = unroll_reference(p, n, mags, signs)
    got_m, got_s = fused_matrix_inverse(
        mags, signs, n, p.qfloat_len, p.qfloat_ints, p.qfloat_base,
        p.true_division, pallas=False,
    )
    np.testing.assert_array_equal(np.asarray(ref_m), np.asarray(got_m))
    np.testing.assert_array_equal(np.asarray(ref_s), np.asarray(got_s))


@pytest.mark.parametrize("preset,n", [(HIGH, 3), (HIGH, 4)])
def test_fused_stages_one_per_kernel(monkeypatch, preset, n):
    """A budget below every stage's size gives each stage a kernel of its
    own: the state crosses every seam, and the result is unchanged."""
    monkeypatch.setattr(fi, "STAGE_BUDGET", 1)
    p = preset.replace(n=n)
    mags, signs = quantize(p, n, 32, seed=10 + n)
    ref_m, ref_s = unroll_reference(p, n, mags, signs)
    args = (n, p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division)
    got_m, got_s = fused_matrix_inverse(mags, signs, *args, pallas=False)
    np.testing.assert_array_equal(np.asarray(ref_m), np.asarray(got_m))
    np.testing.assert_array_equal(np.asarray(ref_s), np.asarray(got_s))
    jaxpr = str(jax.make_jaxpr(
        lambda m, s: fused_matrix_inverse(m, s, *args, interpret=False)
    )(mags, signs))
    # pivot n-1, P*M rows n, columns n, forward n, backward n
    assert jaxpr.count("pallas_call[") == 5 * n - 1


def test_fused_body_singular_saturates():
    """Singular matrices run the division-by-zero saturation path."""
    p = LOW.replace(n=3)
    rng = np.random.RandomState(0)
    M = rng.randn(8, 3, 3)
    M[:, 2, :] = M[:, 0, :] + M[:, 1, :]  # rank-deficient
    digits, signs = float_matrix_to_qfloat_arrays(
        M, p.qfloat_len, p.qfloat_ints, p.qfloat_base
    )
    mags = jnp.asarray(radix.pack_digits(digits, p.qfloat_base))
    signs = jnp.asarray(signs)
    ref_m, ref_s = unroll_reference(p, 3, mags, signs)
    got_m, got_s = fused_matrix_inverse(
        mags, signs, 3, p.qfloat_len, p.qfloat_ints, p.qfloat_base,
        p.true_division, interpret=True,
    )
    np.testing.assert_array_equal(np.asarray(ref_m), np.asarray(got_m))
    np.testing.assert_array_equal(np.asarray(ref_s), np.asarray(got_s))


@pytest.mark.slow
def test_fused_pallas_interpret_tiling():
    """pallas_call plumbing: padding + multi-block grid, interpret mode."""
    p = LOW.replace(n=3)
    # B chosen to force padding (not a multiple of the block) and >= 2 blocks
    B = 3 * 128 + 17
    mags, signs = quantize(p, 3, B, seed=1)
    ref_m, ref_s = unroll_reference(p, 3, mags, signs)
    got_m, got_s = fused_matrix_inverse(
        mags, signs, 3, p.qfloat_len, p.qfloat_ints, p.qfloat_base,
        p.true_division, block=128, interpret=True,
    )
    np.testing.assert_array_equal(np.asarray(ref_m), np.asarray(got_m))
    np.testing.assert_array_equal(np.asarray(ref_s), np.asarray(got_s))


@pytest.mark.parametrize("preset,n", [(LOW, 2), (LOW, 3)])
def test_fused_triton_wrapper_pads_and_grids(preset, n):
    """B not a multiple of the block, several grid steps, batch dims kept."""
    p = preset.replace(n=n)
    B = 2 * 16 + 5  # 3 blocks of 16, the last one padded
    mags, signs = quantize(p, n, B, seed=3)
    ref_m, ref_s = unroll_reference(p, n, mags, signs)
    got_m, got_s = jax.jit(
        lambda m, s: fused_matrix_inverse(
            m, s, n, p.qfloat_len, p.qfloat_ints, p.qfloat_base,
            p.true_division, block=16, num_warps=1,
        )
    )(mags.reshape(1, B, n * n), signs.reshape(1, B, n * n))
    assert got_m.shape == (1, B, n * n) and got_s.shape == (1, B, n * n)
    np.testing.assert_array_equal(np.asarray(ref_m), np.asarray(got_m[0]))
    np.testing.assert_array_equal(np.asarray(ref_s), np.asarray(got_s[0]))
    jaxpr = str(jax.make_jaxpr(
        lambda m, s: fused_matrix_inverse(
            m, s, n, p.qfloat_len, p.qfloat_ints, p.qfloat_base,
            p.true_division, block=16, num_warps=1,
        )
    )(mags, signs))
    assert "pallas_call" in jaxpr and "grid=(3,)" in jaxpr


def test_fused_default_block():
    """The default block is a power of two (Triton) spread over whole warps,
    and it is what the kernels get when no block is passed."""
    assert fi.BLOCK & (fi.BLOCK - 1) == 0 and fi.NUM_WARPS & (fi.NUM_WARPS - 1) == 0
    assert fi.BLOCK >= 32 * fi.NUM_WARPS
    p = LOW.replace(n=2)
    arg = jax.ShapeDtypeStruct((fi.BLOCK + 1, 4), jnp.int64)
    jaxpr = str(jax.make_jaxpr(
        lambda m, s: fused_matrix_inverse(
            m, s, 2, p.qfloat_len, p.qfloat_ints, p.qfloat_base,
            p.true_division,
        )
    )(arg, arg))
    assert "grid=(2,)" in jaxpr and f"num_warps={fi.NUM_WARPS}" in jaxpr


@pytest.mark.parametrize(
    "preset,n,track", [(LOW, 2, False), (HIGH, 4, True), (HIGH, 5, False)]
)
def test_fused_kernel_lowers_for_cuda(preset, n, track):
    """The kernels lower to Triton custom calls for CUDA, no card needed."""
    from jax import export

    p = preset.replace(n=n)
    fn = jax.jit(
        lambda m, s: fused_matrix_inverse(
            m, s, n, p.qfloat_len, p.qfloat_ints, p.qfloat_base,
            p.true_division, interpret=False, track=track,
        )
    )
    arg = jax.ShapeDtypeStruct((4096, n * n), jnp.int64)
    exp = export.export(
        fn, platforms=["cuda"],
        disabled_checks=[
            export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
        ],
    )(arg, arg)
    text = exp.mlir_module()
    kernels = text.count("__gpu$xla.gpu.triton")
    assert kernels >= 1 and text.count("stablehlo.custom_call") == kernels
    assert f"fused_n{n}_" in text or f"fused_inverse_n{n}" in text


def test_fused_lowering_wiring():
    """lowering='fused' routes through the packed-io entry point."""
    p = LOW.replace(n=2)
    mags, signs = quantize(p, 2, 8, seed=2)
    ref_m, ref_s = unroll_reference(p, 2, mags, signs)
    got_m, got_s = qfloat_matrix_inverse_packed_io(
        mags, signs, 2, p.qfloat_len, p.qfloat_ints, p.qfloat_base,
        p.true_division, lowering="fused",
    )
    np.testing.assert_array_equal(np.asarray(ref_m), np.asarray(got_m))
    np.testing.assert_array_equal(np.asarray(ref_s), np.asarray(got_s))
