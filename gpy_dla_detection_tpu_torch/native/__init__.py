"""ctypes bindings for the native C++ kernels: the port's copy of
``gpy_dla_detection_tpu/native``.

``voigt_native.cc`` is that package's source byte for byte.  It is built
with ``g++ -O3 -std=c++17 -shared -fPIC`` on first use into ``build/``
beside it (one library a checkout, rebuilt when the source is newer), and
a failed build raises: there is no fallback to the Python routes.  This is
the host/runtime native path mirroring the reference's single native
component, the ``voigt.c`` MEX extension (reference: voigt.c:253-304) —
rebuilt in C++ with its own Faddeeva implementation (no libcerf) and a
threaded batch API.  It runs on the host CPU: the card's paths are the
kernels under ``csrc/``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

from .. import constants as C

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "voigt_native.cc")
_BUILD = os.path.join(_DIR, "build")
_LIB = os.path.join(_BUILD, "libvoigt_native.so")

_lib = None


def _build() -> None:
    """Compile the library into a temporary file and move it into place,
    so processes that build at once never load a half-written file."""
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC, "-lpthread"]
    try:
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"building {_SRC} failed ({' '.join(cmd)}):\n{done.stderr}")
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load():
    """Load (building if needed) the native library; returns the ctypes
    handle or raises if no toolchain is available."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
        _build()
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError:
        # a stale binary from another arch/toolchain: rebuild once and
        # retry before giving up
        _build()
        lib = ctypes.CDLL(_LIB)

    lib.faddeeva_real.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
    ]
    lib.voigt_absorption_batch.argtypes = [
        ctypes.POINTER(ctypes.c_double)
    ] * 6 + [
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
    ]
    lib.voigt_absorption_lls_batch.argtypes = lib.voigt_absorption_batch.argtypes
    lib.voigt_absorption_civ_batch.argtypes = [
        ctypes.POINTER(ctypes.c_double)
    ] * 7 + [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
    ]
    lib.preprocess_spectrum.restype = ctypes.c_int64
    _lib = lib
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _batch_1d(**arrays):
    """Validate per-absorber parameter arrays: 1-D and one shared
    length.  The C kernels flat-index them, so a length mismatch or a
    2-D input is an out-of-bounds read / silently wrong result, not an
    error the library can catch itself."""
    out = {
        k: np.atleast_1d(np.ascontiguousarray(v, np.float64))
        for k, v in arrays.items()
    }
    shapes = {k: v.shape for k, v in out.items()}
    if any(v.ndim != 1 for v in out.values()) or len(set(shapes.values())) != 1:
        raise ValueError(
            f"per-absorber parameters must be 1-D arrays of one length, got {shapes}"
        )
    return list(out.values())


def faddeeva_real(x, y):
    """Re[w(x + iy)] via the native library."""
    lib = load()
    x = np.ascontiguousarray(x, np.float64)
    y = np.ascontiguousarray(np.broadcast_to(y, x.shape), np.float64)
    out = np.empty_like(x)
    lib.faddeeva_real(_ptr(x.ravel()), _ptr(y.ravel()), _ptr(out.ravel()), x.size)
    return out


def voigt_absorption(
    wavelengths,
    nhi,
    z_absorber,
    num_lines: int = 3,
    broadening: bool = True,
    num_threads: int = 0,
):
    """Batched Lyman-series Voigt absorption on the host CPU.

    Same semantics as ops/voigt.py ``voigt_absorption``; threads over
    absorbers (0 = hardware concurrency).
    """
    lib = load()
    wavelengths = np.ascontiguousarray(wavelengths, np.float64)
    nhi, z_absorber = _batch_1d(nhi=nhi, z_absorber=z_absorber)
    S = nhi.shape[0]
    P = wavelengths.shape[0]
    width = C.INSTRUMENT_PROFILE_HALF_WIDTH if broadening else 0
    out = np.empty((S, P - 2 * width))
    lam = np.ascontiguousarray(C.LYMAN_WAVELENGTHS_A[:num_lines])
    lead = np.ascontiguousarray(C.LYMAN_LEADING_CONSTANTS[:num_lines])
    gam = np.ascontiguousarray(C.LYMAN_LORENTZIAN_WIDTHS[:num_lines])
    profile = np.ascontiguousarray(C.INSTRUMENT_PROFILE)
    if num_threads == 0:
        num_threads = os.cpu_count() or 1
    lib.voigt_absorption_batch(
        _ptr(wavelengths),
        _ptr(nhi),
        _ptr(z_absorber),
        _ptr(lam),
        _ptr(lead),
        _ptr(gam),
        ctypes.c_double(C.THERMAL_SIGMA_CGS),
        _ptr(profile) if broadening else None,
        ctypes.c_int(C.INSTRUMENT_PROFILE_HALF_WIDTH),
        ctypes.c_int(num_lines),
        ctypes.c_int64(P),
        ctypes.c_int64(S),
        _ptr(out),
        ctypes.c_int(num_threads),
    )
    return out


def voigt_absorption_lls(
    wavelengths,
    nhi,
    z_absorber,
    num_lines: int = 3,
    broadening: bool = True,
    num_threads: int = 0,
):
    """Batched LLS-break absorption on the host CPU (same semantics as
    ops/voigt.py ``voigt_absorption_lls``)."""
    lib = load()
    wavelengths = np.ascontiguousarray(wavelengths, np.float64)
    nhi, z_absorber = _batch_1d(nhi=nhi, z_absorber=z_absorber)
    S, P = nhi.shape[0], wavelengths.shape[0]
    width = C.INSTRUMENT_PROFILE_HALF_WIDTH if broadening else 0
    out = np.empty((S, P - 2 * width))
    lam = np.ascontiguousarray(C.LYMAN_WAVELENGTHS_A[:num_lines])
    lead = np.ascontiguousarray(C.LYMAN_LEADING_CONSTANTS[:num_lines])
    gam = np.ascontiguousarray(C.LYMAN_LORENTZIAN_WIDTHS[:num_lines])
    profile = np.ascontiguousarray(C.INSTRUMENT_PROFILE)
    if num_threads == 0:
        num_threads = os.cpu_count() or 1
    lib.voigt_absorption_lls_batch(
        _ptr(wavelengths), _ptr(nhi), _ptr(z_absorber),
        _ptr(lam), _ptr(lead), _ptr(gam),
        ctypes.c_double(C.THERMAL_SIGMA_CGS),
        _ptr(profile) if broadening else None,
        ctypes.c_int(C.INSTRUMENT_PROFILE_HALF_WIDTH),
        ctypes.c_int(num_lines),
        ctypes.c_int64(P), ctypes.c_int64(S),
        _ptr(out), ctypes.c_int(num_threads),
    )
    return out


def voigt_absorption_civ(
    wavelengths,
    nciv,
    z_civ,
    sigma,
    num_lines: int = 2,
    broadening: bool = True,
    num_threads: int = 0,
):
    """Batched CIV-doublet absorption (free per-sample sigma) on the
    host CPU (same semantics as ops/voigt.py ``voigt_absorption_civ``)."""
    lib = load()
    wavelengths = np.ascontiguousarray(wavelengths, np.float64)
    nciv = np.atleast_1d(np.ascontiguousarray(nciv, np.float64))
    nciv, z_civ, sigma = _batch_1d(
        nciv=nciv, z_civ=z_civ, sigma=np.broadcast_to(sigma, nciv.shape)
    )
    S, P = nciv.shape[0], wavelengths.shape[0]
    width = C.INSTRUMENT_PROFILE_HALF_WIDTH if broadening else 0
    out = np.empty((S, P - 2 * width))
    lam = np.ascontiguousarray(C.CIV_WAVELENGTHS_CM[:num_lines] * 1e8)
    lead = np.ascontiguousarray(C.CIV_LEADING_CONSTANTS[:num_lines])
    gam = np.ascontiguousarray(C.CIV_LORENTZIAN_WIDTHS[:num_lines])
    profile = np.ascontiguousarray(C.INSTRUMENT_PROFILE)
    if num_threads == 0:
        num_threads = os.cpu_count() or 1
    lib.voigt_absorption_civ_batch(
        _ptr(wavelengths), _ptr(nciv), _ptr(z_civ), _ptr(sigma),
        _ptr(lam), _ptr(lead), _ptr(gam),
        _ptr(profile) if broadening else None,
        ctypes.c_int(C.INSTRUMENT_PROFILE_HALF_WIDTH),
        ctypes.c_int(num_lines),
        ctypes.c_int64(P), ctypes.c_int64(S),
        _ptr(out), ctypes.c_int(num_threads),
    )
    return out


def preprocess_spectrum(wavelengths, flux, noise_variance, pixel_mask, z_qso, params):
    """Native twin of data/spectrum.py ``preprocess`` (returns the same
    Spectrum pytree)."""
    from ..data.spectrum import Spectrum

    lib = load()
    wavelengths = np.ascontiguousarray(wavelengths, np.float64)
    flux = np.ascontiguousarray(flux, np.float64)
    noise_variance = np.ascontiguousarray(noise_variance, np.float64)
    pixel_mask = np.ascontiguousarray(pixel_mask, np.uint8)
    N = params.num_pixels_padded
    pad = 3
    padded = np.empty(N + 2 * pad)
    flux_out = np.empty(N)
    var_out = np.empty(N)
    mask_out = np.empty(N, np.uint8)
    median = ctypes.c_double()
    n_w = lib.preprocess_spectrum(
        _ptr(wavelengths),
        _ptr(flux),
        _ptr(noise_variance),
        pixel_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(wavelengths.shape[0]),
        ctypes.c_double(z_qso),
        ctypes.c_double(params.normalization_min_lambda),
        ctypes.c_double(params.normalization_max_lambda),
        ctypes.c_double(params.min_lambda),
        ctypes.c_double(params.max_lambda),
        ctypes.c_int64(N),
        ctypes.c_double(params.pixel_spacing),
        ctypes.c_int(pad),
        _ptr(padded),
        _ptr(flux_out),
        _ptr(var_out),
        mask_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(median),
    )
    if n_w < 0:
        raise ValueError("preprocess_spectrum failed (window empty or too large)")
    rest = wavelengths / (1.0 + z_qso)
    in_window_valid = wavelengths[
        (rest >= params.min_lambda) & (rest <= params.max_lambda) & (pixel_mask == 0)
    ]
    return Spectrum(
        padded_wavelengths=padded,
        flux=flux_out,
        noise_variance=var_out,
        mask=mask_out.astype(bool),
        z_qso=np.float64(z_qso),
        min_z_dla=np.float64(params.min_z_dla(in_window_valid, z_qso)),
        max_z_dla=np.float64(params.max_z_dla(in_window_valid, z_qso)),
        normalization_median=np.float64(median.value),
    )
