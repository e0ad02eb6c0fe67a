"""Share of the traced stretch in which no device record ran, in percent."""

from harness.trace import busy_s


def read(r):
    w = r.trace.window_s
    return None if w <= 0 else 100.0 * (1.0 - busy_s(r.trace) / w)
