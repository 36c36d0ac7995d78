"""Op-count roofline for the batched inversion programs.

Counts the *logical elementwise work* of a circuit — u32-equivalent ALU ops
per inversion — by walking its jaxpr (recursing into scan/cond bodies with
their trip counts), and divides an issue rate the caller supplies by it.

Cost model:

* every elementwise arithmetic/logic/compare/select primitive costs
  ``#output elements x dtype_weight`` u32-equivalent ops;
* int64 ops weigh 2 (64-bit integer ops are emulated as 32-bit pairs —
  add/sub/logic are 2-3 s32 ops, shifts/compares similar, multiplies more;
  2 is deliberately optimistic so the reported share is an upper bound of
  how much headroom remains);
* data movement (reshape/broadcast/slice/concat/convert/gather) costs 0 —
  this is an ALU roofline, not a bandwidth roofline.

No rate is assumed for any device: every bound takes the device's
u32-equivalent issue rate (elem-ops/s) from the caller, measured on that
device.
"""

from __future__ import annotations

import json

import numpy as np

# elementwise primitives counted as ALU work (jax primitive names)
_ALU_PRIMS = {
    "add", "sub", "mul", "div", "rem", "neg", "sign", "abs", "max", "min",
    "and", "or", "xor", "not", "shift_left", "shift_right_logical",
    "shift_right_arithmetic", "eq", "ne", "lt", "le", "gt", "ge",
    "select_n", "clamp", "floor", "ceil", "round", "pow", "integer_pow",
}

# dtype -> u32-equivalent weight per element (optimistic floor: s64 = 2)
_DTYPE_WEIGHT = {
    "int64": 2.0, "uint64": 2.0,
    "int32": 1.0, "uint32": 1.0, "float32": 1.0,
    "int16": 1.0, "uint16": 1.0, "bfloat16": 1.0,
    "int8": 1.0, "uint8": 1.0, "bool": 1.0,
    "float64": 2.0,
}

# realistic per-primitive s64 emulation costs in s32 ops (XLA lowers s64 to
# s32 pairs: add/sub carry-chain 3, wide multiply ~6, funnel shifts ~4,
# lexicographic compares ~3, pure bitwise 2)
_S64_PRIM_WEIGHT = {
    "add": 3.0, "sub": 3.0, "neg": 3.0, "abs": 3.0, "sign": 3.0,
    "mul": 6.0, "div": 12.0, "rem": 12.0,
    "max": 4.0, "min": 4.0,
    "shift_left": 4.0, "shift_right_logical": 4.0,
    "shift_right_arithmetic": 4.0,
    "lt": 3.0, "le": 3.0, "gt": 3.0, "ge": 3.0,
    "eq": 2.5, "ne": 2.5,
    "and": 2.0, "or": 2.0, "xor": 2.0, "not": 2.0,
    "select_n": 2.0, "clamp": 4.0, "integer_pow": 6.0,
}


def _out_cost(eqn, realistic: bool) -> float:
    cost = 0.0
    for v in eqn.outvars:
        aval = v.aval
        dt = str(aval.dtype)
        if realistic and dt in ("int64", "uint64", "float64"):
            w = _S64_PRIM_WEIGHT.get(eqn.primitive.name, 2.0)
        else:
            w = _DTYPE_WEIGHT.get(dt, 1.0)
        cost += float(np.prod(aval.shape, dtype=np.float64)) * w
    return cost


def _count_jaxpr(jaxpr, realistic: bool = False) -> float:
    """u32-equivalent elementwise ops for one execution of ``jaxpr``."""
    total = 0.0
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim == "scan":
            body = eqn.params["jaxpr"].jaxpr
            length = eqn.params["length"]
            total += _count_jaxpr(body, realistic) * float(length)
        elif prim == "while":
            # no static trip count; count one iteration (lower bound) —
            # the shipped lowerings use scan, not while
            total += _count_jaxpr(eqn.params["body_jaxpr"].jaxpr, realistic)
        elif prim == "cond":
            total += max(
                _count_jaxpr(b.jaxpr, realistic)
                for b in eqn.params["branches"]
            )
        elif prim in ("pjit", "custom_jvp_call", "custom_vjp_call",
                      "closed_call", "core_call", "remat_call", "checkpoint"):
            inner = eqn.params.get("jaxpr") or eqn.params.get("call_jaxpr")
            if inner is not None:
                total += _count_jaxpr(
                    inner.jaxpr if hasattr(inner, "jaxpr") else inner,
                    realistic,
                )
        elif prim in _ALU_PRIMS:
            total += _out_cost(eqn, realistic)
        # everything else (reshape/broadcast/slice/concatenate/convert/
        # iota/gather/dynamic_slice/...) = data movement, 0 ALU cost
    return total


def count_u32_ops(fn, *example_args, realistic: bool = False) -> float:
    """Total u32-equivalent elementwise ops of one call of ``fn``.

    ``realistic=False`` uses the optimistic s64=2 floor (max-headroom
    reading); ``realistic=True`` uses the per-primitive emulation table.
    """
    import jax

    jaxpr = jax.make_jaxpr(fn)(*example_args)
    return _count_jaxpr(jaxpr.jaxpr, realistic)


def flagship_roofline(
    ops_per_s: float,
    batch: int = None,
    measured_inversions_per_s: float = None,
):
    """Ops/inversion + roofline for the flagship n=4 High packed circuit.

    ``ops_per_s`` is the device's u32-equivalent issue rate.  Returns a dict
    with ops_per_inversion, the issue-bound inversions/s, and (when a
    measured rate is given) the achieved share of that bound.
    """
    import functools

    import jax
    import jax.numpy as jnp

    from ..config import PRESETS
    from ..models.inverse import qfloat_matrix_inverse_packed_io

    p = PRESETS["high"].replace(n=4)
    B = batch or 1024
    fn = functools.partial(
        qfloat_matrix_inverse_packed_io,
        n=p.n,
        qfloat_len=p.qfloat_len,
        qfloat_ints=p.qfloat_ints,
        qfloat_base=p.qfloat_base,
        true_division=p.true_division,
        lowering="unroll",
    )
    mags = jnp.zeros((B, 16), jnp.int64)
    signs = jnp.ones((B, 16), jnp.int64)
    per_inv = count_u32_ops(fn, mags, signs) / B
    per_inv_real = count_u32_ops(fn, mags, signs, realistic=True) / B
    bound = ops_per_s / per_inv
    bound_real = ops_per_s / per_inv_real
    out = {
        "ops_per_inversion_u32eq_floor": round(per_inv, 1),
        "ops_per_inversion_u32eq_realistic": round(per_inv_real, 1),
        "ops_per_s": ops_per_s,
        "roofline_inversions_per_s_upper": round(bound, 1),
        "roofline_inversions_per_s_realistic": round(bound_real, 1),
    }
    if measured_inversions_per_s:
        out["measured_inversions_per_s"] = measured_inversions_per_s
        out["mfu_pct_vs_upper"] = round(
            100.0 * measured_inversions_per_s / bound, 2
        )
        out["mfu_pct_vs_realistic"] = round(
            100.0 * measured_inversions_per_s / bound_real, 2
        )
    return out


def kernel_op_histogram(n: int = 4, preset: str = "high", elems: int = 128):
    """Primitive histogram of the fused kernels, per inversion.

    The packed-circuit count above models the XLA int64 lowerings; the
    fused kernels execute a different program — the uint32 pair form
    (ops/pair_math.py).  This traces the kernels' stages on the whole
    batch (``fused_matrix_inverse(..., pallas=False)``, the same stage
    code with the same merging) and counts each ALU primitive's
    per-element ops per inversion, giving both the true instruction mix
    (what to optimize next) and the numerator for a measured-rate roofline
    (see ``kernel_roofline``).
    """
    import functools

    import jax
    import jax.numpy as jnp

    from ..config import PRESETS
    from ..ops.fused_inverse import fused_matrix_inverse

    p = PRESETS[preset].replace(n=n)
    fn = functools.partial(
        fused_matrix_inverse, n=n, qfloat_len=p.qfloat_len,
        qfloat_ints=p.qfloat_ints, base=p.qfloat_base,
        true_division=p.true_division, pallas=False,
    )
    z = jnp.zeros((elems, n * n), jnp.int64)
    jaxpr = jax.make_jaxpr(fn)(z, jnp.ones_like(z))

    hist = {}

    def walk(jx, mult=1.0):
        for eqn in jx.eqns:
            prim = eqn.primitive.name
            if prim == "scan":
                walk(eqn.params["jaxpr"].jaxpr, mult * eqn.params["length"])
            elif prim in ("pjit", "closed_call"):
                inner = eqn.params.get("jaxpr") or eqn.params.get("call_jaxpr")
                if inner is not None:
                    walk(inner.jaxpr if hasattr(inner, "jaxpr") else inner,
                         mult)
            elif prim in _ALU_PRIMS or prim == "convert_element_type":
                nel = sum(
                    float(np.prod(v.aval.shape, dtype=np.float64))
                    for v in eqn.outvars
                )
                hist[prim] = hist.get(prim, 0.0) + mult * nel / elems
    walk(jaxpr.jaxpr)
    return dict(sorted(hist.items(), key=lambda kv: -kv[1]))


def kernel_roofline(ops_per_s, measured_inversions_per_s=None, n=4,
                    preset="high"):
    """Roofline for the fused kernel from its real op histogram.

    ``ops_per_s``: the device's u32-equivalent issue rate, either one number
    or ``{primitive_name: elem-ops/s}`` with a ``"default"`` entry for
    primitives not listed.
    """
    hist = kernel_op_histogram(n, preset)
    rates = dict(ops_per_s) if isinstance(ops_per_s, dict) else {
        "default": ops_per_s
    }
    default = rates.pop("default")
    time_per_inv = sum(
        cnt / rates.get(prim, default) for prim, cnt in hist.items()
    )
    bound = 1.0 / time_per_inv
    out = {
        "ops_per_inversion_kernel": round(sum(hist.values()), 1),
        "kernel_op_histogram": {k: round(v, 1) for k, v in hist.items()},
        "ops_per_s": default,
        "roofline_inversions_per_s": round(bound, 1),
    }
    if measured_inversions_per_s:
        out["measured_inversions_per_s"] = measured_inversions_per_s
        out["pct_of_roofline"] = round(
            100.0 * measured_inversions_per_s / bound, 2
        )
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="op-count roofline")
    ap.add_argument("ops_per_s", type=float,
                    help="the device's u32-equivalent issue rate, elem-ops/s")
    ap.add_argument("--measured", type=float, default=None,
                    help="measured inversions/s to place against the bound")
    ap.add_argument("--kernel", action="store_true",
                    help="count the fused kernel body, not the XLA circuit")
    a = ap.parse_args()
    fn = kernel_roofline if a.kernel else flagship_roofline
    print(json.dumps(fn(a.ops_per_s, measured_inversions_per_s=a.measured)))
