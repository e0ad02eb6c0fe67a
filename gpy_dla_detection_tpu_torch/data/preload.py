"""Spectrum preloading: batch preprocessing + artifact caching.

Rebuild of the MATLAB preloader (reference: preload_qsos.m:1-83): read
each spectrum, median-normalize, window, and persist the fixed-shape
arrays so the batch driver streams preprocessed tensors straight to the
device.  Updates the catalog filter flags for unnormalizable spectra
(bit 2) and spectra with too few pixels (bit 3), like the reference
(preload_qsos.m:29-48).

The port's copy of ``gpy_dla_detection_tpu/data/preload.py``, on the
port's ``spectrum``, ``fits`` and ``build_catalog``; ``use_native=True``
preprocesses through the port's ``native`` library.  Host numpy: the
spectra reach the card through ``spectrum.to_torch`` in the batch driver.
h5py is imported inside the artifact functions (the card has none).
"""

from __future__ import annotations

import numpy as np

from ..params import Parameters
from .build_catalog import FILTER_MIN_PIXELS, FILTER_NORMALIZATION
from .spectrum import Spectrum, preprocess, stack


def preload_spectra(
    filenames: list[str],
    z_qsos,
    params: Parameters,
    read_spec=None,
    use_native: bool = False,
):
    """Preprocess a list of spectra.

    :return: (spectra list, filter_flags array) — entries that fail
        preprocessing get a None spectrum and a filter bit.
    """
    if read_spec is None:
        from .fits import read_spec as read_spec_default

        read_spec = read_spec_default

    if use_native:
        from .. import native

        prep = lambda *a: native.preprocess_spectrum(*a)
    else:
        prep = preprocess

    if len(filenames) != len(z_qsos):
        raise ValueError(
            f"{len(filenames)} filenames but {len(z_qsos)} z_qsos — a "
            "silent zip truncation would leave trailing flags at 0 "
            "('passed') for spectra that were never processed"
        )
    spectra: list[Spectrum | None] = []
    flags = np.zeros(len(filenames), dtype=np.uint8)
    for i, (fname, z) in enumerate(zip(filenames, z_qsos)):
        wavelengths, flux, noise_variance, pixel_mask = read_spec(fname)

        rest = wavelengths / (1.0 + z)
        norm_ind = (
            (rest >= params.normalization_min_lambda)
            & (rest <= params.normalization_max_lambda)
            & ~pixel_mask
        )
        if not np.any(norm_ind & np.isfinite(flux)):
            flags[i] |= FILTER_NORMALIZATION
            spectra.append(None)
            continue

        try:
            spec = prep(wavelengths, flux, noise_variance, pixel_mask, z, params)
        except ValueError:
            flags[i] |= FILTER_MIN_PIXELS
            spectra.append(None)
            continue

        if int(np.sum(spec.mask)) < params.min_num_pixels:
            flags[i] |= FILTER_MIN_PIXELS
            spectra.append(None)
            continue
        spectra.append(spec)
    return spectra, flags


def compute_snrs(spectra: list[Spectrum | None]) -> np.ndarray:
    """Per-spectrum signal-to-noise over the modelled window — the
    quantity the CDDF analysis cuts on
    (reference: CDDF_analysis/calc_cddf.py:1167-1237 compute_all_snrs).

    Failed spectra get SNR = -1.
    """
    snrs = np.full(len(spectra), -1.0)
    for i, s in enumerate(spectra):
        if s is None:
            continue
        mask = np.asarray(s.mask)
        if not mask.any():
            continue
        flux = np.asarray(s.flux)[mask]
        sigma = np.sqrt(np.asarray(s.noise_variance)[mask])
        snrs[i] = float(np.nanmedian(np.abs(flux) / sigma))
    return snrs


def save_preloaded(filename: str, spectra: list[Spectrum], ids=None) -> None:
    """Persist preprocessed spectra as one HDF5 artifact
    (the artifact-DAG stage analogous to preloaded_qsos.mat,
    reference: preload_qsos.m:73-79)."""
    import h5py

    survivors = [s for s in spectra if s is not None]
    if not survivors:
        raise ValueError(
            "no spectra survived preprocessing — nothing to save"
        )
    batch = stack(survivors)
    kept = np.array([i for i, s in enumerate(spectra) if s is not None])
    with h5py.File(filename, "w") as f:
        for name in Spectrum._fields:
            f.create_dataset(name, data=np.asarray(getattr(batch, name)))
        f.create_dataset("kept_indices", data=kept)
        if ids is not None:
            arr = np.asarray(ids)[kept]
            if arr.dtype.kind in "US":
                arr = arr.astype(h5py.string_dtype(encoding="utf-8"))
            f.create_dataset("ids", data=arr)


def load_preloaded(filename: str) -> tuple[Spectrum, np.ndarray]:
    import h5py

    with h5py.File(filename, "r") as f:
        spec = Spectrum(*[f[name][()] for name in Spectrum._fields])
        kept = f["kept_indices"][()]
    return spec, kept
