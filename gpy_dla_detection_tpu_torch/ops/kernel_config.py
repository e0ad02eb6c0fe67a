"""Storage of the absorption profiles.

The port's copy of the one constant of
``gpy_dla_detection_tpu/ops/kernel_config.py`` it needs; the rest of that
module reads environment flags, which the port replaces with arguments
(``abs_dtype`` of ``models.evidence.qmc_log_evidences`` and the entry
points above it).

Profiles lie in [0, 1] by construction.  Compact storage keeps them as
int16 fixed-point codes ``round(a * ABS_I16_SCALE)`` (round half to even,
in the profile's float type) and decodes them as ``code * (1 /
ABS_I16_SCALE)``, a product with the reciprocal: a uniform 1.5e-5
absolute error at half the bytes of float32.  The absorption kernels (K1,
K5, K6) encode where they store; the likelihood kernel (K2) decodes where
it assembles the noise model.
"""

from __future__ import annotations

import torch

ABS_I16_SCALE = 32767.0

# the reference's GPY_DLA_ABS_DTYPE values.  "i16p" packs two int16 codes
# in an int32 there, to halve the elements of the TPU's row gather; the
# codes are the same, and the port stores them as plain int16
_STORE_DTYPES = {"f32": torch.float32, "i16": torch.int16, "i16p": torch.int16}


def profile_store_dtype(name: str) -> torch.dtype:
    """The storage dtype of a reference flag value: ``"f32"`` ->
    ``torch.float32``, ``"i16"`` and ``"i16p"`` -> ``torch.int16``."""
    if name not in _STORE_DTYPES:
        raise ValueError(
            f"profile storage must be 'f32', 'i16' or 'i16p', got {name!r}"
        )
    return _STORE_DTYPES[name]
