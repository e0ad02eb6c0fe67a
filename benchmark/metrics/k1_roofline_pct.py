"""K1's share of its roofline: the least time of the work its launches in
the traced stretch do (``harness/counts.py``) over their device time, in
percent.  If the profiler holds fewer records than the launches assumed,
the least time is scaled to the records it holds."""

from harness.result import is_k1
from harness.trace import device_seconds


def read(r):
    least = r.values.get("least_s", {}).get("k1")
    launches = r.values.get("launches", {}).get("k1")
    if not least or not launches:
        return None
    found, seconds = device_seconds(r.trace, is_k1)
    if not found or seconds <= 0:
        return None
    return 100.0 * least * (found / launches) / seconds
