"""Identity-keyed memoization for per-model device tables.

The port's copy of ``gpy_dla_detection_tpu/utils/memo.py``.  The zQSO
correlation scan precomputes a large device-resident FFT table per learned
model (``models/zqso_corr.py``).  Keys include ``id(model)``, cheap and
hashable for any container of tensors, so a hit must re-check identity (an
id can be reused after the original object is garbage collected).  The
callers' keys also name the model's device, so a table built on one device
never serves another.  FIFO eviction bounds the resident tables.
"""

from __future__ import annotations


def memo_by_identity(cache: dict, key: tuple, owner, build, max_entries: int = 8):
    """Return ``cache[key]`` if present AND still owned by ``owner``
    (identity check guards against id() reuse), else ``build()`` and
    store, evicting the oldest entry past ``max_entries``.

    ``key`` must include ``id(owner)``; ``build`` takes no arguments.
    """
    hit = cache.get(key)
    if hit is not None and hit[0] is owner:
        return hit[1]
    entry = build()
    cache[key] = (owner, entry)
    if len(cache) > max_entries:
        cache.pop(next(iter(cache)))
    return entry
