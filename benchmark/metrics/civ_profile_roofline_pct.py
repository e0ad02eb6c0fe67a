"""The CIV doublet stage's share of its roofline: the least time of its
work (``harness/counts_civ.py``: the (S, P - 6) float32 absorption written
once) over the device time of the records launched while a
``gpy.civ_profile`` span was open on the launching thread, in percent.
The work is counted once for each K5 record among them (one a profile),
so a profile whose records the profiler missed counts on neither side."""

from harness.spans import Threads

SPAN = "gpy.civ_profile"


def read(r):
    pt, least = r.values.get("program_trace"), r.values.get("civ_profile_least_s")
    if pt is None or not least:
        return None
    threads = Threads(pt.spans)
    profiles, seconds = 0, 0.0
    for rec in pt.trace.records:
        launch = pt.launches.get(rec)
        if launch is not None and threads.within(launch.thread, launch.at, SPAN):
            seconds += (rec.end - rec.start) / 1e6
            profiles += "tail_kernel" in rec.name  # K5
    if not profiles or seconds <= 0:
        return None
    return 100.0 * least * profiles / seconds
