"""Streaming executor: overlap host marshalling with device execution.

Production serving path: a background thread quantizes batch k+1 (using the
native C++ marshaller) and transfers it while the device inverts batch k,
and a finish pool overlaps the fetch+dequantize tail, so sustained
throughput approaches max(host stage, transfer, device compute) instead of
their SUM.  The reference has no analog (it runs one inversion per process
invocation); this is the "data loader" component.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class _ProducerFailure:
    """Sentinel carrying a producer-thread exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class StreamingInverter:
    """Pipelined batched inversion over an iterator of matrix batches.

    Usage:
        inv = BatchedMatrixInversion(params, B, backend="packed", io="packed")
        stream = StreamingInverter(inv, depth=2)
        for result in stream.run(batches):   # batches: iterable of (B, n, n)
            ...
    """

    def __init__(self, batched_inverter, depth: int = 2,
                 finish_workers: int = 2):
        """``depth``: max batches in flight on the device side.
        ``finish_workers``: threads running the device-fetch + dequantize
        stage.  The native dequantizer releases the GIL (ctypes), so >1
        worker genuinely parallelizes the host-side tail — without it the
        consumer dequantizes synchronously and the device idles behind
        host work (measured: dequantize is the largest warm host cost per
        batch, benchmarks/results/e2e.json).  0 = dequantize inline."""
        self.inv = batched_inverter
        self.depth = max(1, depth)
        self.finish_workers = max(0, finish_workers)

    def _producer(self, batches, q):
        import jax
        import jax.numpy as jnp

        try:
            for M in batches:
                a, b = self.inv.quantize(np.asarray(M, dtype=np.float64))
                device_args = (
                    jax.device_put(jnp.asarray(a, jnp.int64)),
                    jax.device_put(jnp.asarray(b, jnp.int64)),
                )
                q.put(device_args)
            q.put(None)  # clean end-of-stream
        except BaseException as exc:  # propagate to the consumer, never truncate
            q.put(_ProducerFailure(exc))

    def run(self, batches):
        """Yield dequantized (B, n, n) inverse batches, pipelined.

        A failure while quantizing/transferring any batch re-raises in the
        consumer (after draining results already in flight) instead of
        silently truncating the stream.
        """
        q = queue.Queue(maxsize=self.depth)
        producer = threading.Thread(
            target=self._producer, args=(batches, q), daemon=True
        )
        producer.start()

        pool = (
            ThreadPoolExecutor(max_workers=self.finish_workers)
            if self.finish_workers
            else None
        )
        finish = (lambda out: pool.submit(self._finish, out)) if pool else None

        try:
            in_flight = []  # device outputs or finish-futures, in order
            failure = None
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, _ProducerFailure):
                    failure = item
                    break
                out = self.inv.run_raw(*item)  # async dispatch
                in_flight.append(finish(out) if pool else out)
                while len(in_flight) >= self.depth:
                    head = in_flight.pop(0)
                    yield head.result() if pool else self._finish(head)
            for out in in_flight:
                yield out.result() if pool else self._finish(out)
            producer.join()
            if failure is not None:
                raise RuntimeError(
                    "StreamingInverter producer failed while preparing a batch"
                ) from failure.exc
        finally:
            if pool:
                # Drop finish jobs that never started so an abandoned stream
                # doesn't keep fetching/dequantizing (or block interpreter
                # exit on) batches nobody will consume.
                pool.shutdown(wait=False, cancel_futures=True)

    def _finish(self, out):
        import jax

        jax.block_until_ready(out)
        if isinstance(out, tuple):
            host = tuple(np.asarray(o) for o in out)
        else:
            host = np.asarray(out)
        return self.inv.dequantize(host)
