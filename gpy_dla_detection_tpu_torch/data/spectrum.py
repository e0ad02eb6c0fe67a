"""Fixed-shape spectrum representation, host-side preprocessing, and the
move onto a device.

``Spectrum``, ``preprocess``, ``stack`` and ``astype`` are the port's own
copy of ``gpy_dla_detection_tpu/data/spectrum.py`` (numpy only), kept
equal to it name for name and number for number so that the port imports
nothing of the JAX package.  A ``Spectrum`` holds *padded, masked* arrays
with a static pixel count, so every spectrum of a catalog has one shape
and batches of spectra stack along a leading axis (reference:
gpy_dla_detection/null_gp.py:95-177, the stateful ``set_data``).
Preprocessing runs on the host in numpy once per spectrum;
:func:`to_torch` moves the result onto a device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..params import Parameters

# number of pixels the instrumental convolution consumes on each side
_PAD = 3


class Spectrum(NamedTuple):
    """One (or a batch of) preprocessed quasar spectra.

    Shapes below are for a single spectrum; batches add a leading axis.
    ``N = params.num_pixels_padded``.
    """

    # observed wavelengths of the model window, padded by 3 convolution
    # pixels on each side: (N + 6,)
    padded_wavelengths: np.ndarray
    # normalized flux / noise variance on the window pixels: (N,)
    flux: np.ndarray
    noise_variance: np.ndarray
    # True for in-window, unmasked pixels that enter the likelihood: (N,)
    mask: np.ndarray
    # scalars
    z_qso: np.ndarray
    min_z_dla: np.ndarray
    max_z_dla: np.ndarray
    normalization_median: np.ndarray

    @property
    def wavelengths(self):
        """Observed wavelengths of the window pixels: (N,)."""
        return self.padded_wavelengths[..., _PAD:-_PAD]


def preprocess(
    wavelengths: np.ndarray,
    flux: np.ndarray,
    noise_variance: np.ndarray,
    pixel_mask: np.ndarray,
    z_qso: float,
    params: Parameters,
    normalize: bool = True,
) -> Spectrum:
    """Normalize, window, and pad one observed spectrum.

    Mirrors the reference preprocessing (null_gp.py:95-177): median
    normalization over the 1310-1325 A rest window, restriction to the
    modelling window, and construction of the convolution-padded
    wavelength grid — but emits fixed-shape masked arrays.

    :param wavelengths: observed wavelengths [A].
    :param pixel_mask: True = bad pixel (same convention as the
        reference's read_spec).
    """
    wavelengths = np.asarray(wavelengths, dtype=np.float64)
    flux = np.asarray(flux, dtype=np.float64).copy()
    noise_variance = np.asarray(noise_variance, dtype=np.float64).copy()
    pixel_mask = np.asarray(pixel_mask, dtype=bool)

    rest = params.emitted_wavelengths(wavelengths, z_qso)

    if normalize:
        ind = (
            (rest >= params.normalization_min_lambda)
            & (rest <= params.normalization_max_lambda)
            & (~pixel_mask)
        )
        median = float(np.nanmedian(flux[ind])) if np.any(ind) else 1.0
        flux /= median
        noise_variance /= median**2
    else:
        median = 1.0

    # model window (keeps masked pixels so the convolution grid is gapless)
    in_window = (rest >= params.min_lambda) & (rest <= params.max_lambda)
    window_wavelengths = wavelengths[in_window]
    n_w = window_wavelengths.shape[0]
    N = params.num_pixels_padded
    if n_w > N:
        raise ValueError(
            f"spectrum has {n_w} window pixels > num_pixels_padded={N}"
        )

    valid = in_window & (~pixel_mask)

    # absorber search range uses only valid pixels (reference samples
    # z_dla from this_wavelengths, dla_samples.py:94-104)
    valid_wavelengths = wavelengths[valid]
    if valid_wavelengths.size == 0:
        raise ValueError("no valid pixels in the modelling window")
    min_z = params.min_z_dla(valid_wavelengths, z_qso)
    max_z = params.max_z_dla(valid_wavelengths, z_qso)

    # padded wavelength grid: 3 log-spaced pixels below, the window
    # pixels, then a log-spaced continuation filling the padding tail
    # (reference: null_gp.py:159-177; tail pixels are masked out)
    dex = params.pixel_spacing
    lo = np.log10(window_wavelengths[0])
    head = 10 ** (lo + dex * np.arange(-_PAD, 0))
    hi = np.log10(window_wavelengths[-1])
    n_tail = N - n_w + _PAD
    tail = 10 ** (hi + dex * np.arange(1, n_tail + 1))
    padded = np.concatenate([head, window_wavelengths, tail])

    flux_out = np.zeros(N)
    var_out = np.ones(N)
    mask_out = np.zeros(N, dtype=bool)
    flux_w = flux[in_window]
    var_w = noise_variance[in_window]
    valid_w = ~pixel_mask[in_window] & np.isfinite(flux_w) & np.isfinite(var_w)
    # masked pixels keep placeholder values; they never enter the math
    flux_out[:n_w] = np.where(valid_w, np.nan_to_num(flux_w), 0.0)
    var_out[:n_w] = np.where(valid_w, np.nan_to_num(var_w, nan=1.0), 1.0)
    mask_out[:n_w] = valid_w

    return Spectrum(
        padded_wavelengths=padded,
        flux=flux_out,
        noise_variance=var_out,
        mask=mask_out,
        z_qso=np.float64(z_qso),
        min_z_dla=np.float64(min_z),
        max_z_dla=np.float64(max_z),
        normalization_median=np.float64(median),
    )


def stack(spectra: list[Spectrum]) -> Spectrum:
    """Stack single spectra into a batch (leading axis)."""
    return Spectrum(*[np.stack([getattr(s, f) for s in spectra]) for f in Spectrum._fields])


def astype(spec: Spectrum, dtype) -> Spectrum:
    """Cast floating-point leaves (mask stays boolean)."""
    return Spectrum(
        padded_wavelengths=spec.padded_wavelengths.astype(dtype),
        flux=spec.flux.astype(dtype),
        noise_variance=spec.noise_variance.astype(dtype),
        mask=spec.mask,
        z_qso=spec.z_qso.astype(dtype),
        min_z_dla=spec.min_z_dla.astype(dtype),
        max_z_dla=spec.max_z_dla.astype(dtype),
        normalization_median=spec.normalization_median.astype(dtype),
    )


def to_torch(spec: Spectrum, device, dtype: torch.dtype) -> Spectrum:
    """A ``Spectrum`` (or stacked batch) with tensor fields on ``device``:
    floating fields in ``dtype``, the mask boolean."""
    return Spectrum(
        *[
            torch.as_tensor(np.asarray(f), device=device).to(
                torch.bool if name == "mask" else dtype
            )
            for name, f in zip(Spectrum._fields, spec)
        ]
    )
