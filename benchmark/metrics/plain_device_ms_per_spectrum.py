"""Device milliseconds a spectrum of every kernel that is not one of the
port's own (``csrc/``): the plain PyTorch work below the entry points."""

from harness.result import is_port_kernel
from harness.trace import device_seconds


def read(r):
    if not r.units:
        return None
    _, s = device_seconds(r.trace, lambda n: not is_port_kernel(n))
    return 1e3 * s / r.units
