"""The 95th percentile, in ms, of the measured window's latencies (a
batch's, dispatch to its results on the host), as the driver took it:
for a cell whose tail spreads too widely between runs to carry a bound."""


def read(r):
    return r.values.get("p95_latency_ms")
