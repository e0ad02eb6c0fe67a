"""Host-side pipeline prefetch.

The survey CLI's per-batch work is host preprocessing (FITS read,
normalization, padding — numpy) followed by device compute (the jitted
selection).  JAX dispatch is asynchronous but the *next* batch's
preprocessing would still serialize behind the current batch's
``np.asarray`` materialization, so the CLI overlaps them explicitly:
a single worker thread keeps ``depth`` preprocessed batches in flight
while the main thread drives the device (the reference's serial
per-spectrum loop has no equivalent — reference: run_bayes_select.py:141).

One worker is deliberate: host preprocessing is numpy-bound and this
box's CPU is the scarce resource; the goal is overlap, not host
parallelism.

The port's own copy of ``gpy_dla_detection_tpu/utils/prefetch.py``, kept equal
to it name for name, so that the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import collections
import concurrent.futures
import itertools
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
R = TypeVar("R")


def prefetch_map(
    fn: Callable[[T], R], items: Iterable[T], depth: int = 2
) -> Iterator[R]:
    """``map(fn, items)`` with up to ``depth`` results computed ahead on
    a worker thread, yielded strictly in order.

    Exceptions raised by ``fn`` propagate at the corresponding yield
    point (so callers keep ordinary error handling).
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    it = iter(items)
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        queue: collections.deque = collections.deque()
        for item in itertools.islice(it, depth):
            queue.append(pool.submit(fn, item))
        while queue:
            result = queue.popleft().result()
            # refill before yielding so the worker stays busy while the
            # consumer processes this result
            try:
                queue.append(pool.submit(fn, next(it)))
            except StopIteration:
                pass
            yield result
