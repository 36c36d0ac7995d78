"""Sanity tests for the roofline op counter (utils/roofline.py)."""

import jax
import jax.numpy as jnp
import numpy as np

from matrix_inversion_tpu.utils.roofline import count_u32_ops, flagship_roofline


def test_counts_simple_ops():
    def f(x, y):
        return x + y * y  # one add + one mul, 8 elements each

    x = jnp.zeros((8,), jnp.int32)
    assert count_u32_ops(f, x, x) == 16.0


def test_s64_weighting():
    def f(x):
        return x + x

    x32 = jnp.zeros((4,), jnp.int32)
    x64 = jnp.zeros((4,), jnp.int64)
    assert count_u32_ops(f, x32) == 4.0
    assert count_u32_ops(f, x64) == 8.0        # floor: s64 = 2x
    assert count_u32_ops(f, x64, realistic=True) == 12.0  # add = 3 s32 ops


def test_scan_multiplies_by_length():
    def f(x):
        def body(c, _):
            return c + 1, c * c
        c, ys = jax.lax.scan(body, x, None, length=10)
        return c, ys

    x = jnp.zeros((4,), jnp.int32)
    # per step: add(4) + mul(4) = 8; 10 steps
    assert count_u32_ops(f, x) == 80.0


def test_flagship_roofline_reports():
    r = flagship_roofline(1e12, batch=8, measured_inversions_per_s=1e6)
    assert r["ops_per_inversion_u32eq_floor"] > 1000
    assert (
        r["ops_per_inversion_u32eq_realistic"]
        > r["ops_per_inversion_u32eq_floor"]
    )
    assert r["mfu_pct_vs_realistic"] > r["mfu_pct_vs_upper"] > 0


def test_kernel_op_histogram_counts_the_stages(monkeypatch):
    """The fused kernels' op count comes from the stage code they run:
    merging stages into more or fewer kernels moves no op."""
    from matrix_inversion_tpu.ops import fused_inverse as fi
    from matrix_inversion_tpu.utils.roofline import kernel_op_histogram

    merged = kernel_op_histogram(n=3, preset="low", elems=8)
    monkeypatch.setattr(fi, "STAGE_BUDGET", 1)
    split = kernel_op_histogram(n=3, preset="low", elems=8)
    assert merged == split
    assert merged["mul"] > 0 and sum(merged.values()) > 1000
