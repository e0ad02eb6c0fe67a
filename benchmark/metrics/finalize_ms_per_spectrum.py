"""Host milliseconds a spectrum in ``parallel/batch.finalize_batch`` (the
model selection), timed after the batch's readback event has been waited
on, over the measured window."""


def read(r):
    s = r.values.get("finalize_s_per_spectrum")
    return None if s is None else 1e3 * s
