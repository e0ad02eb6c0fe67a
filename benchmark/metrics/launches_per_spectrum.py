"""Device kernel records a spectrum in the traced stretch (copies left out)."""


def read(r):
    return len(r.trace.kernels()) / r.units if r.units else None
