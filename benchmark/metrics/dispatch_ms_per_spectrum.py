"""Host milliseconds a spectrum in ``parallel/batch.dispatch_batch`` (the
launches of the per-spectrum QMC loop), over the measured window."""


def read(r):
    s = r.values.get("dispatch_s_per_spectrum")
    return None if s is None else 1e3 * s
