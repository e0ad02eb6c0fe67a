"""Bounded-window batched dispatch pipeline over an item stream.

The port of ``gpy_dla_detection_tpu/utils/pipeline.py``, the shared
scaffolding of the batched per-spectrum heads
(``models/lls.lls_inference_many``, ``models/civ.civ_inference_many``):
chunk the incoming spectra into batches, keep up to ``max_in_flight``
dispatched batches ahead of the readback (bounding device memory while
the host queues the next batch), and queue every output tensor's copy to
the host behind its batch's work, so that draining a batch waits on that
batch's copies alone.

The reference pads the last short batch to one compiled shape; here the
short batch is dispatched at its own size.
"""

from __future__ import annotations

import collections
from typing import Any, NamedTuple

import torch


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host tensor being filled with ``t``: on a CUDA device a pinned
    buffer written by a non-blocking copy, queued behind the work already
    on the current stream; on the CPU a plain copy.  Hold the result until
    the copy is waited on: the buffer must outlive it."""
    cuda = t.is_cuda
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
    return host.copy_(t.detach(), non_blocking=cuda)


def _map_tensors(fn, tree):
    """``tree`` with ``fn`` applied to every tensor in it (tuples, named
    tuples and lists are walked; anything else is kept)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map_tensors(fn, x) for x in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(fn, x) for x in tree)
    return tree


class Readback(NamedTuple):
    """One dispatched output's host copies, being filled, and the event
    recorded after them (None where no tensor was on a CUDA device)."""

    host: Any
    done: torch.cuda.Event | None

    def result(self):
        """The output with every tensor a numpy array, after waiting on
        this readback's event alone."""
        if self.done is not None:
            self.done.synchronize()
        return _map_tensors(torch.Tensor.numpy, self.host)


def start_readback(out) -> Readback:
    """Queue the copies of every tensor in ``out`` to the host and return
    at once (the counterpart of the reference's ``copy_to_host_async``)."""
    cuda = []

    def copy(t):
        cuda.append(t.is_cuda)
        return host_copy(t)

    host = _map_tensors(copy, out)
    done = None
    if any(cuda):
        done = torch.cuda.Event()
        done.record()
    return Readback(host, done)


def pipelined_batches(
    items,
    batch_size: int,
    max_in_flight: int,
    dispatch_fn,
    finalize_fn,
    aux=None,
):
    """Run ``items`` through ``dispatch_fn`` in batches with a bounded
    in-flight window; collect ``finalize_fn``'s per-item results in stream
    order.

    :param items: any iterable (e.g. a prefetching generator).
    :param dispatch_fn: ``(chunk: list, chunk_aux: list | None) ->``
        tensors (a tensor, or tuples and lists of them): must
        return without waiting for the device.  The last chunk may be
        shorter than ``batch_size``.
    :param finalize_fn: ``(n: int, out) -> iterable`` of the chunk's ``n``
        per-item results, ``out`` being ``dispatch_fn``'s output with
        every tensor a numpy array.
    :param max_in_flight: batches dispatched ahead of the readback; once
        more are in flight, the oldest is drained (0: synchronous).
    :param aux: optional iterable yielding one auxiliary value per item
        (e.g. resampling indices), consumed lazily in stream order.
    :return: list of per-item results.
    """
    it_aux = iter(aux) if aux is not None else None
    in_flight: collections.deque = collections.deque()
    results: list = []

    def drain_one():
        n, pending = in_flight.popleft()
        results.extend(finalize_fn(n, pending.result()))

    def dispatch(chunk, chunk_aux):
        in_flight.append((len(chunk), start_readback(dispatch_fn(chunk, chunk_aux))))
        if len(in_flight) > max_in_flight:
            drain_one()

    chunk: list = []
    chunk_aux: list | None = [] if it_aux is not None else None
    for item in items:
        chunk.append(item)
        if it_aux is not None:
            chunk_aux.append(next(it_aux))
        if len(chunk) == batch_size:
            dispatch(chunk, chunk_aux)
            chunk = []
            chunk_aux = [] if it_aux is not None else None
    if chunk:
        dispatch(chunk, chunk_aux)
    while in_flight:
        drain_one()
    return results
