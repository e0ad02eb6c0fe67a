"""Pipeline configuration.

``Parameters`` is a frozen (hashable) dataclass so instances can be
passed as static arguments to jitted functions; every numeric knob is a
plain Python float/int, never a traced array.

Conformance: field defaults mirror the reference pipeline's settings
(reference: gpy_dla_detection/set_parameters.py:21-102 for the DLA
pipeline, zqso_set_parameters.py for redshift estimation,
civ_set_parameter.py for CIV).  Velocity cuts are stored in km/s and
converted via :meth:`kms_to_z` like the reference does at construction
time (set_parameters.py:93-100).

The port's own copy of ``gpy_dla_detection_tpu/params.py`` (numpy only),
kept equal to it name for name and number for number so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .constants import LYA_WAVELENGTH_A, LYB_WAVELENGTH_A, LYMAN_LIMIT_A, SPEED_OF_LIGHT_SI


@dataclasses.dataclass(frozen=True)
class Parameters:
    """Static configuration of the DLA-detection pipeline."""

    # physical constants (Angstrom)
    lya_wavelength: float = LYA_WAVELENGTH_A
    lyb_wavelength: float = LYB_WAVELENGTH_A
    lyman_limit: float = LYMAN_LIMIT_A
    speed_of_light: float = SPEED_OF_LIGHT_SI  # m/s

    # file loading (rest-frame Angstrom)
    loading_min_lambda: float = 910.0
    loading_max_lambda: float = 1217.0

    # preprocessing
    z_qso_cut: float = 2.15
    min_num_pixels: int = 200

    # flux normalization window (rest-frame Angstrom)
    normalization_min_lambda: float = 1310.0
    normalization_max_lambda: float = 1325.0

    # null model
    min_lambda: float = 911.75
    max_lambda: float = 1215.75
    dlambda: float = 0.25
    k: int = 20
    max_noise_variance: float = 9.0

    # optimization (training)
    initial_c_0: float = 0.1
    initial_tau_0: float = 0.0023
    initial_beta: float = 3.65
    max_train_iterations: int = 2000

    # DLA parameter samples
    num_dla_samples: int = 10000
    alpha: float = 0.97
    uniform_min_log_nhi: float = 20.0
    uniform_max_log_nhi: float = 23.0
    fit_min_log_nhi: float = 20.0
    fit_max_log_nhi: float = 22.0

    # model prior
    prior_z_qso_increase_kms: float = 30000.0

    # instrumental broadening
    width: int = 3
    pixel_spacing: float = 1e-4  # dex

    # absorber model
    num_lines: int = 3
    max_z_cut_kms: float = 3000.0
    min_z_cut_kms: float = 3000.0
    min_z_separation_kms: float = 3000.0

    # Lyman-series forest
    num_forest_lines: int = 31

    # mean-flux suppression (Kim et al. 2007)
    prev_tau_0: float = 0.0023
    prev_beta: float = 3.65
    # the 2020 pipeline multiplies the Kim mean-flux factor into mu/M
    # and omega2; the 2017 single-DLA pipeline scales only omega2 by
    # the learned single-line factor (reference: process_qsos.m:138-147
    # vs multi_dlas/process_qsos_multiple_dlas_meanflux.m:240-288)
    suppress_mean_flux: bool = True

    # --- fixed-shape padding for the TPU compute path -------------------
    # number of model-window pixels each spectrum is padded to; the
    # 911.75-1215.75 A window at 1e-4 dex spacing spans ~1251 pixels.
    num_pixels_padded: int = 1280

    # ------------------------------------------------------------------
    # presets
    # ------------------------------------------------------------------
    @classmethod
    def garnett2017(cls, **overrides) -> "Parameters":
        """The 2017 single-DLA settings (Garnett+ 2017): mixture weight
        alpha=0.9 and max_noise_variance=1^2 (reference:
        set_parameters.m:37,49), single-line (Lya-only) noise scaling
        with no mean-flux suppression of mu/M (reference:
        process_qsos.m:138-147)."""
        kw: dict = dict(
            alpha=0.9,
            max_noise_variance=1.0,
            num_forest_lines=1,
            suppress_mean_flux=False,
        )
        kw.update(overrides)
        return cls(**kw)

    # ------------------------------------------------------------------
    # unit conversions
    # ------------------------------------------------------------------
    def kms_to_z(self, kms: float) -> float:
        """Relative velocity in km/s to redshift difference."""
        return kms * 1000.0 / self.speed_of_light

    @property
    def prior_z_qso_increase(self) -> float:
        return self.kms_to_z(self.prior_z_qso_increase_kms)

    @property
    def max_z_cut(self) -> float:
        return self.kms_to_z(self.max_z_cut_kms)

    @property
    def min_z_cut(self) -> float:
        return self.kms_to_z(self.min_z_cut_kms)

    @property
    def min_z_separation(self) -> float:
        return self.kms_to_z(self.min_z_separation_kms)

    @staticmethod
    def emitted_wavelengths(observed_wavelengths, z):
        return observed_wavelengths / (1.0 + z)

    @staticmethod
    def observed_wavelengths(emitted_wavelengths, z):
        return emitted_wavelengths * (1.0 + z)

    # ------------------------------------------------------------------
    # absorber search range (host-side, numpy)
    # ------------------------------------------------------------------
    def _model_window_wavelengths(self, wavelengths: np.ndarray, z_qso: float) -> np.ndarray:
        rest = self.emitted_wavelengths(np.asarray(wavelengths), z_qso)
        ind = (rest >= self.min_lambda) & (rest <= self.max_lambda)
        return np.asarray(wavelengths)[ind]

    def max_z_dla(self, wavelengths: np.ndarray, z_qso: float) -> float:
        """Maximum absorber redshift searched: red end of the modelled
        window (minus a 3000 km/s cut), never beyond the quasar itself.
        (reference: set_parameters.py:125-140)"""
        in_window = self._model_window_wavelengths(wavelengths, z_qso)
        return min(
            float(np.max(in_window)) / self.lya_wavelength - 1.0 - self.max_z_cut,
            z_qso - self.max_z_cut,
        )

    def min_z_dla(self, wavelengths: np.ndarray, z_qso: float) -> float:
        """Minimum absorber redshift searched: blue end of the modelled
        window, or 3000 km/s above the Lyman limit in the QSO rest frame.
        (reference: set_parameters.py:142-159)"""
        in_window = self._model_window_wavelengths(wavelengths, z_qso)
        return max(
            float(np.min(in_window)) / self.lya_wavelength - 1.0,
            self.observed_wavelengths(self.lyman_limit, z_qso) / self.lya_wavelength
            - 1.0
            + self.min_z_cut,
        )


@dataclasses.dataclass(frozen=True)
class ZParameters(Parameters):
    """Configuration for quasar redshift estimation.

    Wider modelling window and a bluer normalization range.
    (reference: gpy_dla_detection/zqso_set_parameters.py:14-54)
    """

    loading_min_lambda: float = 800.0
    loading_max_lambda: float = 1550.0
    normalization_min_lambda: float = 1176.0
    normalization_max_lambda: float = 1256.0
    min_lambda: float = 910.0
    max_lambda: float = 3000.0
    dlambda: float = 0.25
    k: int = 20
    max_noise_variance: float = 16.0
    num_zqso_samples: int = 10000
    num_pixels_padded: int = 5632  # 910-3000 A window is up to ~5190 px


@dataclasses.dataclass(frozen=True)
class CIVParameters(Parameters):
    """Configuration for the CIV doublet search.

    (reference: gpy_dla_detection/civ_set_parameter.py:20-117)
    """

    civ_1548_wavelength: float = 1548.2040
    civ_1550_wavelength: float = 1550.7781

    loading_min_lambda: float = 1310.0
    loading_max_lambda: float = 1555.0
    normalization_min_lambda: float = 1420.0
    normalization_max_lambda: float = 1475.0
    min_lambda: float = 1311.0
    max_lambda: float = 1554.0
    dlambda: float = 0.5
    max_noise_variance: float = 16.0
    num_civ_samples: int = 10000
    z_qso_cut: float = 1.7
    min_num_pixels: int = 400
    uniform_min_log_nciv: float = 12.88
    uniform_max_log_nciv: float = 14.5
    fit_min_log_nciv: float = 12.88
    fit_max_log_nciv: float = 15.0
    num_lines: int = 2
    num_pixels_padded: int = 768

    def min_z_civ(self, wavelengths: np.ndarray, z_qso: float) -> float:
        """(reference: civ_set_parameter.py:102-117)"""
        in_window = self._model_window_wavelengths(wavelengths, z_qso)
        return max(
            float(np.min(in_window)) / self.civ_1548_wavelength - 1.0,
            self.observed_wavelengths(1310.0, z_qso) / self.civ_1548_wavelength - 1.0,
        )

    def max_z_civ(self, wavelengths: np.ndarray, z_qso: float) -> float:
        """(reference: civ_set_parameter.py:90-100)"""
        return z_qso - self.max_z_cut

    # the generic spectrum preprocessing asks the Parameters object for
    # the absorber search range; for the CIV pipeline that range is the
    # doublet's, not Lyman-alpha's (caught by an end-to-end CLI drive:
    # the inherited lya formulas put the injected doublet out of range)
    def min_z_dla(self, wavelengths: np.ndarray, z_qso: float) -> float:
        return self.min_z_civ(wavelengths, z_qso)

    def max_z_dla(self, wavelengths: np.ndarray, z_qso: float) -> float:
        return self.max_z_civ(wavelengths, z_qso)
