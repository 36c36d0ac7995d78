"""Device-mesh parallelism for batched inversions.

The reference's only concurrency is single-host dataflow parallelism
(reference qfloat_matrix_inversion.py:1001) plus the "tensorize" batching
of scalar ops.  The scaling model here is:

* ``data`` axis — batches of independent inversions sharded across devices
  and hosts.  LU over one matrix is column-sequential, so batch
  data-parallelism is the efficient axis (SURVEY.md section 7).
* ``cell`` axis — the n*n matrix-cell axis, sharded during the
  embarrassingly-parallel marshalling stages (pack/unpack) and gathered
  with an ``all_gather`` before the cell-coupled LU stage; reduction
  statistics ride a ``psum``.  This exercises real collectives so the same
  program scales past one host.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import QFloatParams
from ..models.inverse import qfloat_matrix_inverse


def make_mesh(n_devices=None, axis_names=("data",), shape=None):
    """Build a Mesh over the first ``n_devices`` devices.

    ``shape`` (optional) reshapes devices into a multi-axis mesh, e.g.
    ``shape=(4, 2), axis_names=("data", "cell")``.
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.asarray(devices[:n_devices])
    if shape is None:
        shape = (n_devices,) + (1,) * (len(axis_names) - 1)
    return Mesh(devices.reshape(shape), axis_names)


def data_parallel_inverse(params: QFloatParams, mesh: Mesh, backend=None):
    """jit-compiled batched inverse with the batch axis sharded over ``data``.

    Input digits ``(B, n*n, len)`` and signs ``(B, n*n)`` are sharded on
    their leading axis; XLA keeps every op batch-sharded, so no cross-device
    communication happens inside the inversion itself — collectives only
    appear if the caller reduces over the batch.
    """
    backend = backend or params.resolve_backend()
    p = params
    fn = functools.partial(
        qfloat_matrix_inverse,
        n=p.n,
        qfloat_len=p.qfloat_len,
        qfloat_ints=p.qfloat_ints,
        qfloat_base=p.qfloat_base,
        true_division=p.true_division,
        tensorize=p.tensorize,
        backend=backend,
    )
    data_sharding3 = NamedSharding(mesh, P("data", None, None))
    data_sharding2 = NamedSharding(mesh, P("data", None))
    return jax.jit(
        fn,
        in_shardings=(data_sharding3, data_sharding2),
        out_shardings=data_sharding3,
    )


def data_parallel_inverse_fused(params: QFloatParams, mesh: Mesh,
                                track=False):
    """Batch-sharded FUSED inversion: shard_map around the whole-inversion
    Triton kernels (ops/fused_inverse.py), packed I/O.

    Why shard_map and not jit-with-shardings: under automatic partitioning
    XLA would have to shard the Pallas custom call itself; shard_map
    instead runs one independent kernel per device on its batch shard —
    the natural multi-device form of an embarrassingly-parallel batch (zero
    collectives).
    Bit-exact with every other lowering (tests/test_sharding.py).

    ``track=True`` adds the per-matrix overflow flag as a third output
    (sharded like the batch) — the multi-chip form of
    ``qfloat_matrix_inverse_with_overflow(lowering="fused")``.
    """
    from ..ops.fused_inverse import fused_matrix_inverse

    p = params
    if p.resolve_backend() != "packed":
        raise ValueError("fused lowering requires a packed configuration")

    def shard_fn(mags, signs):
        return fused_matrix_inverse(
            mags, signs, p.n, p.qfloat_len, p.qfloat_ints, p.qfloat_base,
            p.true_division, track=track,
        )

    out_specs = (P("data", None), P("data", None))
    if track:
        out_specs = out_specs + (P("data"),)
    mapped = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("data", None), P("data", None)),
        out_specs=out_specs,
        # the pallas_call out_shapes carry no varying-axis metadata; the
        # per-device program touches no collectives, so the check is moot
        check_vma=False,
    )
    return jax.jit(mapped)


def sharded_inverse_with_stats(params: QFloatParams, mesh: Mesh, backend=None):
    """shard_map program: dp-sharded inversion + psum'd global error moments.

    Demonstrates explicit collectives over the mesh: each device inverts its
    batch shard, locally reduces |x|, and a ``psum`` over the ``data`` axis
    produces the global statistics the precision benchmark reports
    (reference qfloat_matrix_inversion.py:874-879 computes them on host).
    """
    from jax import shard_map

    backend = backend or params.resolve_backend()
    p = params
    fn = functools.partial(
        qfloat_matrix_inverse,
        n=p.n,
        qfloat_len=p.qfloat_len,
        qfloat_ints=p.qfloat_ints,
        qfloat_base=p.qfloat_base,
        true_division=p.true_division,
        tensorize=p.tensorize,
        backend=backend,
    )

    def shard_fn(digits, signs):
        out = fn(digits, signs)
        # local moment of the output digit mass, reduced across the mesh
        local = jnp.sum(jnp.abs(out).astype(jnp.float32))
        total = jax.lax.psum(local, "data")
        count = jax.lax.psum(jnp.float32(out.shape[0]), "data")
        return out, total / count

    mapped = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("data", None, None), P("data", None)),
        out_specs=(P("data", None, None), P()),
    )
    return jax.jit(mapped)


def cell_sharded_pipeline(params: QFloatParams, mesh: Mesh, backend=None):
    """Two-stage program exercising a ``cell`` mesh axis + all_gather.

    Stage 1 (cell-parallel): per-cell digit preprocessing (packing-style
    reductions) sharded over (data, cell).
    Stage 2: ``all_gather`` the cells onto every data shard, then run the
    cell-coupled LU inversion data-parallel.

    This is the seed of within-inversion sharding (pivot/row-update
    broadcasts over collectives) called out in SURVEY.md section 5.
    """
    from jax import shard_map

    backend = backend or params.resolve_backend()
    p = params
    fn = functools.partial(
        qfloat_matrix_inverse,
        n=p.n,
        qfloat_len=p.qfloat_len,
        qfloat_ints=p.qfloat_ints,
        qfloat_base=p.qfloat_base,
        true_division=p.true_division,
        tensorize=p.tensorize,
        backend=backend,
    )

    def shard_fn(digits, signs):
        # stage 1: cell-sharded sanitation (digit range clamp) — cheap,
        # embarrassingly parallel over cells
        digits = jnp.clip(digits, 0, p.qfloat_base - 1)
        # stage 2: gather the cell shards so each device holds all n*n cells
        digits = jax.lax.all_gather(digits, "cell", axis=1, tiled=True)
        signs = jax.lax.all_gather(signs, "cell", axis=1, tiled=True)
        out = fn(digits, signs)
        return out

    mapped = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("data", "cell", None), P("data", "cell")),
        out_specs=P("data", None, None),
        # after the all_gather every cell shard computes identical values;
        # static replication inference can't see that, so disable the check
        check_vma=False,
    )
    return jax.jit(mapped)
