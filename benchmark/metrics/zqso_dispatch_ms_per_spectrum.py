"""Host milliseconds a spectrum in ``models/zqso.dispatch_scan``, over the
measured window."""


def read(r):
    s = r.values.get("scan_dispatch_s_per_spectrum")
    return None if s is None else 1e3 * s
