"""The whole step's share of the card's peak: the least time the work of
one spectrum needs (by the rooflines' counts and peaks: the catalog's K1,
K2 and K3; a zQSO scan's ``harness/counts`` least) times the window's
spectra per second, in percent."""


def read(r):
    least, rate = r.values.get("step_least_s"), r.values.get("spectra_per_s")
    return None if not least or not rate else 100.0 * least * rate
