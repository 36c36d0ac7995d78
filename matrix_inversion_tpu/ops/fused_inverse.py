"""Fused whole-inversion kernels (Pallas through Triton).

A few kernel launches run the ENTIRE batched QFloat matrix inversion —
pivoting, LU decomposition, forward/backward substitution (or the 2x2
closed form) — for a block of the batch, with every intermediate of a
stage in registers.

Why: the XLA lowerings of the packed circuit write every scan carry and
every fusion boundary to device memory, about 45 kB of traffic per
inversion at n=4 High.  These kernels read the n*n input cells (hi, lo,
sign) once, pass the LU state between stages (a few hundred bytes per
inversion each) and write the n*n output cells once.

Stages: Triton's compile time grows much faster than linearly with the
size of a kernel (on an H100 ~9 s for the ~3k ops per element of n=2
High, ~3 min for the ~8k of n=3 High, over 10 min for the ~21k of n=4
High), so the inversion is cut where the algorithm allows it into stages:
each pivot step, each row of P*M, each LU column
(``models.qfloat_lu.lu_column``), then each forward and backward
substitution step.  The substitution stages run on a (row, batch block)
grid — row ``i`` of the solution depends only on row ``i`` of P, so every
row runs the same code.  Consecutive stages are merged into one kernel up
to :data:`STAGE_BUDGET` jaxpr equations (8 kernels at n=4 High).  n=2
(the closed form) is a single stage.  ``fused_matrix_inverse(...,
pallas=False)`` runs the same stages on whole arrays without Pallas.

How: the kernel bodies are the *same trace-time circuit machinery* as
every other lowering — models/qfloat_lu.py run with
:class:`~matrix_inversion_tpu.ops.pair_qfloat.PairQFloat` cells (uint32
(hi, lo) pairs).  Bit-exactness with the unrolled packed lowering is
therefore structural (same op sequence, pair ops property-tested) and
verified end-to-end in tests/test_fused.py.

Layout: cell-major ``(words, B)``.  The grid runs one program per
``block`` batch columns; each program loads one contiguous ``(block,)``
row per word, so every load and store is coalesced.  The batch is padded
to a multiple of ``block`` only.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..core.qfloat import SignedBinary, Zero
from . import pair_math as pm
from .pair_qfloat import PairQFloat, _is_static

# Batch columns per program and warps per program.  Triton spreads a
# block's columns over num_warps * 32 threads, one column per thread here.
# Swept on an H100 at n=4 High (PERF.md): 64/2, 128/4 and 256/8 are within
# 5% of each other, so one setting serves every n.
BLOCK = 128
NUM_WARPS = 4

# Most jaxpr equations one stage kernel may hold: consecutive stages are
# merged up to this size (fewer launches, less state traffic), but Triton's
# compile time grows ~size^2.8, so one large kernel costs more to build than
# several small ones.  This is where set-up is traded for device rate: on
# an H100 at n=4 High, 2000 gives 8 kernels, 61 s of set-up and 497M
# inversions/s; 3500 gives 4 kernels, 115 s and 687M/s (PERF.md).  2000
# holds the headline's set-up, which every process pays, near a minute.
STAGE_BUDGET = 2000


# ---------------------------------------------------------------------------
# cell state <-> word stacks
# ---------------------------------------------------------------------------


def _flatten(state):
    """Cell state (dicts/lists of PairQFloat, SignedBinary, Zero) ->
    ``(u32 words, i32 words, layout)``; static parts stay in ``layout``."""
    cells, treedef = jax.tree_util.tree_flatten(
        state, is_leaf=lambda x: isinstance(x, (PairQFloat, SignedBinary, Zero))
    )
    u32, i32, desc = [], [], []
    for c in cells:
        if isinstance(c, PairQFloat):
            u32 += [c.hi, c.lo]
            static = _is_static(c.sign)
            if not static:
                i32.append(c.sign.astype(jnp.int32))
            desc.append(("q", len(c), c.ints, c.base,
                         int(c.sign) if static else None))
        elif isinstance(c, SignedBinary):
            v = c.value
            static = isinstance(v, (int, np.integer))
            if not static:
                i32.append(jnp.asarray(v).astype(jnp.int32))
            desc.append(("b", int(v) if static else None))
        elif isinstance(c, Zero):
            desc.append(("z",))
        else:
            raise TypeError(f"unexpected cell {type(c)}")
    return u32, i32, (treedef, tuple(desc))


def _unflatten(u32, i32, layout):
    treedef, desc = layout
    u, s = iter(u32), iter(i32)
    cells = []
    for d in desc:
        if d[0] == "q":
            hi, lo = next(u), next(u)
            sign = next(s) if d[4] is None else d[4]
            cells.append(PairQFloat(hi, lo, d[1], d[2], d[3], sign))
        elif d[0] == "b":
            cells.append(SignedBinary(next(s) if d[1] is None else d[1]))
        else:
            cells.append(Zero())
    return treedef.unflatten(cells)


@contextlib.contextmanager
def _overflow_scope(track, out):
    """Inside ``track``: record overflow flags and append their OR (one int32
    per batch element) to ``out``."""
    if not track:
        yield
        return
    from .packed import track_overflow

    with track_overflow() as tracker:
        yield
        ovf = jnp.zeros((), jnp.int32)
        for f in tracker.flags:
            ovf = ovf | f.astype(jnp.int32)
        out.append(ovf)


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


def _params(block, num_warps, interpret, name):
    return dict(
        compiler_params=pltriton.CompilerParams(
            num_warps=num_warps, num_stages=1
        ),
        backend="triton",
        interpret=interpret,
        name=name,
    )


def _word_counts(layout):
    """(uint32 words, int32 words) of a state with this layout."""
    u = i = 0
    for d in layout[1]:
        if d[0] == "q":
            u += 2
            i += d[4] is None
        elif d[0] == "b":
            i += d[1] is None
    return u, i


def _count_eqns(jaxpr):
    total = 0
    for eqn in jaxpr.eqns:
        total += 1
        for v in eqn.params.values():
            inner = getattr(v, "jaxpr", v)
            if hasattr(inner, "eqns"):
                total += _count_eqns(inner) - 1
    return total


def _apply(fn, words, layout, row_layout):
    """Run a stage on flat words: ``fn(state)``, or ``fn(row_state, state)``
    when ``row_layout`` is given (the row words follow the shared ones)."""
    it = iter(words)
    take = lambda k: [next(it) for _ in range(k)]
    ku, ki = _word_counts(layout)
    state = _unflatten(take(ku), take(ki), layout)
    if row_layout is None:
        return fn(state)
    ru, ri = _word_counts(row_layout)
    return fn(_unflatten(take(ru), take(ri), row_layout), state)


def _abstract_words(*layouts):
    words = []
    for lay in layouts:
        if lay is not None:
            ku, ki = _word_counts(lay)
            words += [jax.ShapeDtypeStruct((8,), jnp.uint32)] * ku
            words += [jax.ShapeDtypeStruct((8,), jnp.int32)] * ki
    return words


def _plan(stages, layout, row_layout, budget, track):
    """Trace each stage once for its op count and output layout, then
    group consecutive stages into kernels of at most ``budget`` jaxpr
    equations (a stage larger than the budget is a kernel of its own).
    With ``track`` the count includes the overflow flags the stage records.

    Returns ``[(name, fn, out_layout)]``, one entry per kernel.
    """
    traced = []
    cur = row_layout if row_layout is not None else layout
    for name, fn in stages:
        box = {}

        def body(words, fn=fn, cur=cur):
            with _overflow_scope(track, []):
                out = _apply(fn, words,
                             layout if row_layout is not None else cur,
                             cur if row_layout is not None else None)
            box["layout"] = _flatten(out)[2]
            return _flatten(out)[:2]

        count = _count_eqns(
            jax.make_jaxpr(body)(
                _abstract_words(layout, cur) if row_layout is not None
                else _abstract_words(cur)
            ).jaxpr
        )
        cur = box["layout"]
        traced.append((name, fn, count, cur))

    groups, total = [], budget + 1
    for name, fn, count, out in traced:
        if total + count > budget:
            groups.append([])
            total = 0
        groups[-1].append((name, fn, out))
        total += count
    kernels = []
    for g in groups:
        fns = [f for _, f, _ in g]
        if row_layout is not None:
            fn = lambda row, st, fns=fns: functools.reduce(
                lambda r, f: f(r, st), fns, row)
        else:
            fn = lambda st, fns=fns: functools.reduce(lambda s, f: f(s), fns, st)
        name = g[0][0] if len(g) == 1 else f"{g[0][0]}_to_{g[-1][0]}"
        kernels.append((name, fn, g[-1][2]))
    return kernels


def _stage(fn, shared, rows, out_layout, block, num_warps, interpret, track,
           name):
    """One kernel of the staged inversion.

    ``shared`` is ``(u, i, layout)``: uint32 ``(ku, B)`` and int32
    ``(ki, B)`` words of a cell state.  Without ``rows`` the kernel maps
    ``fn(shared_state) -> state`` over a grid of batch blocks.  With
    ``rows = (ru, ri, row_layout)``, words ``(n, k, B)`` of one state per
    output row, the grid is (row, batch block) and the kernel maps
    ``fn(row_state, shared_state) -> row_state``: every row runs the same
    code.  ``out_layout`` is the layout of the result (from :func:`_plan`).
    Returns ``(u, i, out_layout, ovf)`` of the new state (per row with
    ``rows``); ``ovf`` is the int32 overflow flag ((B,) or (n, B)) when
    ``track``, else None.
    """
    u, i, layout = shared
    padded = u.shape[-1]
    if rows:
        n_rows = rows[0].shape[0]
        grid = (n_rows, padded // block)
        g_spec = lambda k: pl.BlockSpec((k, block), lambda r, b: (0, b))
        r_spec = lambda k: pl.BlockSpec((None, k, block), lambda r, b: (r, 0, b))
        out_spec, out_dims = r_spec, (n_rows,)
        inputs = [(u, g_spec), (i, g_spec), (rows[0], r_spec), (rows[1], r_spec)]
    else:
        grid = (padded // block,)
        g_spec = lambda k: pl.BlockSpec((k, block), lambda b: (0, b))
        out_spec, out_dims = g_spec, ()
        inputs = [(u, g_spec), (i, g_spec)]
    used = [(x, spec) for x, spec in inputs if x.shape[-2]]
    outs = list(zip(_word_counts(out_layout), (jnp.uint32, jnp.int32)))

    def kernel(*refs):
        words = [r[k] for r in refs[: len(used)] for k in range(r.shape[0])]
        out_refs = list(refs[len(used):])
        ovf = []
        with _overflow_scope(track, ovf):
            out = _apply(fn, words, layout, rows[2] if rows else None)
        for vals, (k, _) in zip(_flatten(out)[:2], outs):
            assert len(vals) == k
            if k:
                ref = out_refs.pop(0)
                for j, x in enumerate(vals):
                    ref[j] = jnp.broadcast_to(x, (block,))
        if track:
            out_refs[0][...] = jnp.broadcast_to(ovf[0], (block,))

    out_shape = [jax.ShapeDtypeStruct(out_dims + (k, padded), dt)
                 for k, dt in outs if k]
    out_specs = [out_spec(k) for k, _ in outs if k]
    if track:
        out_shape.append(jax.ShapeDtypeStruct(out_dims + (padded,), jnp.int32))
        out_specs.append(
            pl.BlockSpec((None, block), lambda r, b: (r, b)) if rows
            else pl.BlockSpec((block,), lambda b: (b,))
        )
    res = list(pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=[spec(x.shape[-2]) for x, spec in used],
        out_specs=out_specs,
        out_shape=out_shape,
        **_params(block, num_warps, interpret, name),
    )(*[x for x, _ in used]))
    new = [res.pop(0) if k else jnp.zeros(out_dims + (0, padded), dt)
           for k, dt in outs]
    return new[0], new[1], out_layout, (res[0] if track else None)


def _stage_plain(fn, shared, rows, out_layout, track, name=None):
    """:func:`_stage` without Pallas: ``fn`` applied to the whole batch
    (once per output row with ``rows``); same arguments and results."""
    u, i, layout = shared
    padded = u.shape[-1]

    def run(row_words, row_layout):
        ovf = []
        with _overflow_scope(track, ovf):
            out = _apply(fn, [*u, *i, *row_words], layout, row_layout)
        nu, ni, got = _flatten(out)
        assert got == out_layout
        stack = lambda ws, dt: (
            jnp.stack([jnp.broadcast_to(w, (padded,)) for w in ws]) if ws
            else jnp.zeros((0, padded), dt))
        flag = jnp.broadcast_to(ovf[0], (padded,)) if track else None
        return stack(nu, jnp.uint32), stack(ni, jnp.int32), flag

    if not rows:
        nu, ni, flag = run([], None)
        return nu, ni, out_layout, flag
    per_row = [run([*rows[0][r], *rows[1][r]], rows[2])
               for r in range(rows[0].shape[0])]
    nu, ni, flags = (
        jnp.stack([p[k] for p in per_row]) if per_row[0][k] is not None
        else None
        for k in range(3)
    )
    return nu, ni, out_layout, flags


def _q_words(u, i, desc):
    """hi, lo and sign words ``(..., B)`` of the PairQFloat cells of a flat
    state ``u``/``i`` ``(..., k, B)``; its other cells are skipped."""
    his, los, sgs = [], [], []
    at_u = at_i = 0
    for d in desc:
        if d[0] == "q":
            his.append(u[..., at_u, :])
            los.append(u[..., at_u + 1, :])
            at_u += 2
            if d[4] is None:
                sgs.append(i[..., at_i, :])
                at_i += 1
            else:
                sgs.append(jnp.full(u.shape[:-2] + u.shape[-1:], d[4],
                                    jnp.int32))
        elif d[0] == "b" and d[1] is None:
            at_i += 1
    return his, los, sgs


def _inverse_stages(n, qfloat_len, qfloat_ints, base, true_division, hi, lo,
                    sg, launch, track):
    """The whole inversion as a sequence of stage kernels, each run by
    ``launch`` (:func:`_stage` or :func:`_stage_plain`).

    n=2: the closed form.  n >= 3: one stage per pivot step, per row of
    P*M and per LU column, then one (row, batch block) grid stage per
    substitution step; consecutive stages are merged up to
    :data:`STAGE_BUDGET`.  Returns the ``(n*n, B)`` hi, lo and sign words
    of the inverse and the int32 overflow flag ``(B,)`` (None unless
    ``track``).
    """
    from ..models.qfloat_lu import (
        lu_backward_step,
        lu_column,
        lu_forward_step,
        lu_inverse_diagonal,
        pivot_step,
        qfloat_inverse_2x2,
        qfloat_list_row_product,
        transpose_2D_list,
        zero_list_matrix,
    )

    def closed_form(M):
        return qfloat_inverse_2x2(M, qfloat_len, qfloat_ints)

    def pivot(j, state):
        M, P = state
        raw = [[c.value for c in row] for row in P]
        pivot_step(j, M, raw)
        P = [[SignedBinary(v) for v in row] for row in raw]
        if j == n - 2:
            return M, P, zero_list_matrix(n)
        return M, P

    def pm_row(i, state):
        M, P, PM = state
        PM = PM[:i] + [qfloat_list_row_product(P[i], M)] + PM[i + 1:]
        if i == n - 1:
            return P, PM, zero_list_matrix(n), zero_list_matrix(n)
        return M, P, PM

    def column(j, state):
        P, PM, L, U = state
        lu_column(j, PM, L, U, qfloat_len, qfloat_ints, true_division, False)
        if j == n - 1:
            Uinv = lu_inverse_diagonal(U, qfloat_len, true_division)
            return transpose_2D_list(P), L, U, Uinv
        # later columns read PM[:][> j] only
        PM = [[Zero() if c <= j else x for c, x in enumerate(row)]
              for row in PM]
        return P, PM, L, U

    def forward(j, row, shared):
        Prow, Yi = row
        L = shared[0]
        Yi = Yi[:j] + [lu_forward_step(j, Prow, L, Yi, False)] + Yi[j + 1:]
        if j == n - 1:
            return Yi, [Zero()] * n
        return Prow, Yi

    def backward(j, row, shared):
        Yi, Xi = row
        L, U, Uinv = shared
        Xi = Xi[:j] + [lu_backward_step(j, Yi, U, Uinv, Xi, qfloat_len,
                                        qfloat_ints, true_division, False)] + Xi[j + 1:]
        # later steps read Y[:j] only
        return Yi[:j] + [Zero()] * (n - j), Xi

    n2 = n * n
    zero = jnp.zeros((), jnp.uint32)
    M = [[PairQFloat(zero, zero, qfloat_len, qfloat_ints, base,
                     jnp.zeros((), jnp.int32)) for _ in range(n)]
         for _ in range(n)]
    P0 = [[SignedBinary(int(r == c)) for c in range(n)] for r in range(n)]
    _, _, layout = _flatten(M if n == 2 else (M, P0))
    shared = (jnp.stack([hi, lo], axis=1).reshape(2 * n2, -1), sg, layout)
    flags = []

    def run(stages, rows):
        nonlocal shared
        plan = _plan(stages, shared[2], rows[2] if rows else None,
                     STAGE_BUDGET, track)
        for name, fn, out_layout in plan:
            *new, ovf = launch(fn, shared, rows, out_layout,
                               name=f"fused_n{n}_{name}")
            if rows:
                rows = tuple(new)
            else:
                shared = tuple(new)
            if track:
                flags.append(ovf if ovf.ndim == 1 else ovf.max(axis=0))
        return rows

    if n == 2:
        run([("closed_form", closed_form)], None)
        words = _q_words(shared[0], shared[1], shared[2][1])
    else:
        run([(f"pivot{j}", functools.partial(pivot, j)) for j in range(n - 1)]
            + [(f"pm{i}", functools.partial(pm_row, i)) for i in range(n)]
            + [(f"lu{j}", functools.partial(column, j)) for j in range(n)],
            None)
        # the last column leads with P transposed, all dynamic: its cells
        # are the first n*n int32 words, and row i of the solution starts
        # from its row i
        u, i, (treedef, desc) = shared
        assert all(d == ("b", None) for d in desc[:n2])
        prows = i[:n2].reshape(n, n, -1)
        shared = (u, i[n2:], (
            jax.tree_util.treedef_tuple(treedef.children()[1:]), desc[n2:]
        ))
        row_layout = _flatten(
            ([SignedBinary(jnp.zeros((), jnp.int32))] * n, [Zero()] * n)
        )[2]
        rows = run(
            [(f"fwd{j}", functools.partial(forward, j)) for j in range(n)]
            + [(f"bwd{j}", functools.partial(backward, j))
               for j in range(n - 1, -1, -1)],
            (jnp.zeros((n, 0, prows.shape[-1]), jnp.uint32), prows,
             row_layout),
        )
        # X row i holds column i of the inverse: cell (j, i) = X[i][j]
        words = _q_words(rows[0], rows[1], rows[2][1])
        assert len(words[0]) == n
    words = [jnp.stack(w, axis=0).reshape(n2, -1) for w in words]
    ovf = functools.reduce(jnp.bitwise_or, flags) if track else None
    return words, ovf


def fused_matrix_inverse(mags, signs, n, qfloat_len, qfloat_ints, base,
                         true_division, block=None, num_warps=None,
                         interpret=None, track=False, pallas=True):
    """Whole-inversion fused kernels over arbitrarily large batches.

    Same contract as the packed-I/O circuit body
    (``models.inverse.qfloat_matrix_inverse_packed_io``): ``(..., n*n)``
    int64 magnitudes + signs in, the same (int64) out — bit-identical
    results, a few kernel launches for the whole batch instead of one XLA
    kernel per op.  ``track=True`` returns ``(mags, signs, overflowed)``
    with an int32 per-matrix overflow flag (the OR of every normalization
    and division overflow in the inversion), bit-identical to the tracked
    unroll lowering.

    ``block``/``num_warps`` default to :data:`BLOCK`/:data:`NUM_WARPS`.
    ``interpret=None`` runs the kernels in Pallas interpret mode on the CPU
    backend (tests) and compiled everywhere else.  ``pallas=False`` runs
    the same stages on the whole batch without ``pallas_call``: the plain
    version XLA compiles, and what the tests and the op count run eagerly.
    """
    block = block or BLOCK
    num_warps = num_warps or NUM_WARPS
    if interpret is None:
        interpret = jax.default_backend() == "cpu"
    mags = jnp.asarray(mags, jnp.int64)
    n2 = n * n
    assert mags.shape[-1] == n2
    bshape = mags.shape[:-1]
    b = int(np.prod(bshape)) if bshape else 1

    # (..., n2) -> (n2, B): cell-major so each block row of one cell is
    # contiguous for the kernel
    flat_m = jnp.moveaxis(mags.reshape(b, n2), -1, 0)
    flat_s = jnp.moveaxis(
        jnp.broadcast_to(jnp.asarray(signs), bshape + (n2,)).reshape(b, n2), -1, 0
    ).astype(jnp.int32)

    padded = -(-b // block) * block if pallas else b
    if padded != b:
        # all ops are branchless: padding columns (zero matrices) run
        # through the same circuit and are sliced off afterwards
        flat_m = jnp.pad(flat_m, ((0, 0), (0, padded - b)))
        flat_s = jnp.pad(flat_s, ((0, 0), (0, padded - b)), constant_values=1)

    hi, lo = pm.split64(flat_m)
    if pallas:
        launch = functools.partial(_stage, block=block, num_warps=num_warps,
                                   interpret=interpret, track=track)
    else:
        launch = functools.partial(_stage_plain, track=track)
    (ohi, olo, osg), ovf = _inverse_stages(
        n, qfloat_len, qfloat_ints, base, true_division, hi, lo, flat_s,
        launch, track,
    )

    out_m = pm.join64(ohi[:, :b], olo[:, :b]).astype(jnp.int64)
    out_m = jnp.moveaxis(out_m, 0, -1).reshape(bshape + (n2,))
    out_s = jnp.moveaxis(osg[:, :b].astype(jnp.int64), 0, -1).reshape(
        bshape + (n2,)
    )
    if track:
        return out_m, out_s, ovf[:b].reshape(bshape)
    return out_m, out_s
