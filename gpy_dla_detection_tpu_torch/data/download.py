"""SDSS spectrum retrieval.

Rebuild of the reference's downloader (reference:
gpy_dla_detection/read_spec.py:123-191, examples/download_spectra.py,
data/scripts/download_spectra.sh).  Network access is environment
dependent; every function degrades to a clear error when offline.

The port's copy of ``gpy_dla_detection_tpu/data/download.py``, on the
port's ``data.build_catalog.V_5_7_2_PLATES`` and ``data.fits.file_loader``.
"""

from __future__ import annotations

import os
from urllib import request

from .build_catalog import V_5_7_2_PLATES
from .fits import file_loader

SDSS_BASE = "https://data.sdss.org/sas/dr12/boss/spectro/redux"
# DR14Q spectra are served from the DR16 eBOSS reduction
# (reference: read_spec.py:180-183)
EBOSS_BASE = "https://data.sdss.org/sas/dr16/eboss/spectro/redux"


def spec_url(plate: int, mjd: int, fiber_id: int, release: str = "dr12q") -> str:
    """URL of an SDSS speclite file.

    dr12q: BOSS redux, with the 33 late plates under v5_7_2 instead of
    v5_7_0 (reference: read_spec.py:138-170).  dr14q: the v5_13_0 eBOSS
    redux under DR16 (reference: read_spec.py:180-183).
    """
    fname = file_loader(plate, mjd, fiber_id)
    if release == "dr12q":
        version = "v5_7_2" if int(plate) in set(V_5_7_2_PLATES.tolist()) else "v5_7_0"
        return f"{SDSS_BASE}/{version}/spectra/lite/{plate:d}/{fname}"
    if release == "dr14q":
        return f"{EBOSS_BASE}/v5_13_0/spectra/lite/{plate:d}/{fname}"
    raise ValueError(
        f"release must be dr12q or dr14q, got {release!r}"
    )  # reference: read_spec.py:184-185


def retrieve_raw_spec(
    plate: int,
    mjd: int,
    fiber_id: int,
    release: str = "dr12q",
    directory: str = ".",
    overwrite: bool = False,
) -> str:
    """Download one spectrum; returns the local path."""
    path = os.path.join(directory, file_loader(plate, mjd, fiber_id))
    if os.path.exists(path) and not overwrite:
        return path
    os.makedirs(directory, exist_ok=True)
    url = spec_url(plate, mjd, fiber_id, release)
    try:
        request.urlretrieve(url, path)
    except Exception as e:
        raise RuntimeError(
            f"could not download {url} (offline environment?): {e}"
        ) from e
    return path


def download_file_list(file_list: str, directory: str = ".") -> list[str]:
    """Fetch every spectrum in a build_catalog file list.

    v5_7_2 plates emit TWO lines per spectrum in the list (the v5_7_2
    location, then the v5_7_0 one — the reference's greedy list,
    build_catalogs.m:111-117); alternatives collapse to ONE returned
    path, trying each URL in order until one succeeds.

    :return: one local path per unique file, in first-seen order.
    """
    alternates: dict[str, list[str]] = {}
    order: list[str] = []
    with open(file_list) as f:
        for line in f:
            rel = line.strip()
            if not rel:
                continue
            base = os.path.basename(rel)
            if base not in alternates:
                alternates[base] = []
                order.append(base)
            alternates[base].append(f"{SDSS_BASE}/{rel.replace('/./', '/')}")

    os.makedirs(directory, exist_ok=True)
    paths = []
    for base in order:
        path = os.path.join(directory, base)
        if not os.path.exists(path):
            last_err: Exception | None = None
            for url in alternates[base]:
                try:
                    request.urlretrieve(url, path)
                    last_err = None
                    break
                except Exception as e:  # try the next redux location
                    last_err = e
            if last_err is not None:
                raise RuntimeError(
                    f"could not download {base} from any of "
                    f"{alternates[base]} (offline environment?): {last_err}"
                ) from last_err
        paths.append(path)
    return paths
