"""Move preprocessed spectra onto a device.

Preprocessing itself (normalization, windowing, padding) is the
reference's numpy code, reused: ``gpy_dla_detection_tpu.data.spectrum``.
"""

from __future__ import annotations

import numpy as np
import torch

from gpy_dla_detection_tpu.data.spectrum import Spectrum


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
