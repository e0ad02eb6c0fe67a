"""Minimal native FITS binary-table reader for SDSS spectra.

The reference loads spectra through astropy (reference:
gpy_dla_detection/read_spec.py:22-120); this framework ships its own
dependency-free reader for the subset of FITS used by SDSS/BOSS
"speclite" files: primary HDU + BINTABLE extensions with scalar
big-endian columns.  Falls back gracefully for any conforming file.

The port's own copy of ``gpy_dla_detection_tpu/data/fits.py``, kept equal
to it name for name, so that the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import numpy as np

BLOCK = 2880

_TFORM_DTYPES = {
    "L": ("u1", 1),
    "B": ("u1", 1),
    "I": (">i2", 2),
    "J": (">i4", 4),
    "K": (">i8", 8),
    "E": (">f4", 4),
    "D": (">f8", 8),
}


def _read_header(f):
    """Parse one FITS header (sequence of 2880-byte blocks of 80-char
    cards).  Returns (dict of cards, bytes consumed)."""
    cards = {}
    nbytes = 0
    done = False
    while not done:
        block = f.read(BLOCK)
        if len(block) < BLOCK:
            if nbytes == 0 and len(block) == 0:
                return None, 0
            raise ValueError("truncated FITS header")
        nbytes += BLOCK
        for i in range(0, BLOCK, 80):
            card = block[i : i + 80].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if not key or card[8] != "=":
                continue
            value = card[10:].split("/")[0].strip()
            if value.startswith("'"):
                value = value[1:].split("'")[0].strip()
            elif value == "T":
                value = True
            elif value == "F":
                value = False
            else:
                try:
                    value = int(value)
                except ValueError:
                    try:
                        value = float(value)
                    except ValueError:
                        pass
            cards[key] = value
    return cards, nbytes


# byte widths of the TFORM codes we parse structurally but do not
# decode (bit arrays, complex, variable-length descriptors): one exotic
# column in an HDU the caller never touches must not abort the read
_TFORM_OPAQUE_WIDTHS = {
    "X": lambda r: (r + 7) // 8,
    "C": lambda r: 8 * r,
    "M": lambda r: 16 * r,
    "P": lambda r: 8 * r,
    "Q": lambda r: 16 * r,
}


def _parse_tform(tform: str):
    """'E' / '1E' / '10D' -> (dtype, bytes, repeat, code).  Unsupported
    codes map to an opaque void dtype of the right width so the record
    layout stays aligned (the column is skipped on extraction)."""
    i = 0
    while i < len(tform) and tform[i].isdigit():
        i += 1
    repeat = int(tform[:i]) if i else 1
    code = tform[i]
    if code == "A":
        return (f"S{repeat}", repeat, 1, code)
    if code in _TFORM_DTYPES:
        dtype, size = _TFORM_DTYPES[code]
        return (dtype, size * repeat, repeat, code)
    if code in _TFORM_OPAQUE_WIDTHS:
        nbytes = _TFORM_OPAQUE_WIDTHS[code](repeat)
        return (f"V{max(nbytes, 1)}", nbytes, 1, code)
    raise ValueError(f"unsupported FITS TFORM code {code!r} in {tform!r}")


def read_fits_tables(filename: str):
    """All BINTABLE HDUs of a FITS file as
    [{'name': EXTNAME, 'columns': {name: ndarray}}, ...]."""
    tables = []
    with open(filename, "rb") as f:
        # primary HDU
        header, _ = _read_header(f)
        if header is None or not header.get("SIMPLE", False):
            raise ValueError(f"{filename}: not a FITS file")
        # primary data (usually empty for speclite)
        naxis = header.get("NAXIS", 0)
        if naxis:
            size = abs(header.get("BITPIX", 8)) // 8
            for i in range(1, naxis + 1):
                size *= header.get(f"NAXIS{i}", 0)
            f.seek((size + BLOCK - 1) // BLOCK * BLOCK, 1)

        while True:
            header, n = _read_header(f)
            if header is None:
                break
            xtension = header.get("XTENSION", "")
            naxis1 = header.get("NAXIS1", 0)
            naxis2 = header.get("NAXIS2", 0)
            # conforming-extension data size: |BITPIX|/8 x GCOUNT x
            # (PCOUNT + prod NAXISn) — for BINTABLEs BITPIX=8/GCOUNT=1
            # this is the fixed table plus the variable-length heap;
            # for IMAGE extensions it scales with the pixel type (the
            # old NAXIS1*NAXIS2 misaligned every subsequent HDU)
            naxis = header.get("NAXIS", 0)
            prod = 1 if naxis else 0
            for i in range(1, naxis + 1):
                prod *= header.get(f"NAXIS{i}", 0)
            bpp = abs(header.get("BITPIX", 8)) // 8
            total = bpp * header.get("GCOUNT", 1) * (
                header.get("PCOUNT", 0) + prod
            )
            padded = (total + BLOCK - 1) // BLOCK * BLOCK

            if xtension.strip() != "BINTABLE":
                f.seek(padded, 1)
                continue

            data_bytes = naxis1 * naxis2
            tfields = header.get("TFIELDS", 0)
            names, dtypes, codes = [], [], []
            for i in range(1, tfields + 1):
                names.append(str(header.get(f"TTYPE{i}", f"col{i}")).strip())
                dt, size, repeat, code = _parse_tform(
                    str(header[f"TFORM{i}"]).strip()
                )
                codes.append(code)
                dtypes.append((names[-1], dt, (repeat,) if repeat > 1 and not dt.startswith(("S", "V")) else ()))

            raw = f.read(data_bytes)
            f.seek(padded - data_bytes, 1)
            rec = np.frombuffer(raw, dtype=np.dtype(dtypes), count=naxis2)
            columns = {}
            for name, code in zip(names, codes):
                col = rec[name]
                if col.dtype.kind == "V":
                    continue  # opaque column (bit/complex/var-length)
                arr = np.ascontiguousarray(col).astype(
                    col.dtype.newbyteorder("=")
                )
                if code == "L":
                    # FITS logicals are ASCII 'T'/'F' bytes — both
                    # truthy as raw u1
                    arr = arr == ord("T")
                columns[name] = arr
            tables.append({"name": str(header.get("EXTNAME", "")), "columns": columns})
    return tables


def file_loader(plate: int, mjd: int, fiber_id: int) -> str:
    """SDSS spec file naming convention (reference: read_spec.py:17)."""
    return f"spec-{plate:d}-{mjd:d}-{fiber_id:04d}.fits"


def read_spec(filename: str):
    """Load an SDSS DR12Q coadded speclite file.

    :return: (wavelengths, flux, noise_variance, pixel_mask) with the
        reference's conventions (reference: read_spec.py:22-71):
        variance NaN where ivar == 0; mask = ivar==0 | BRIGHTSKY bit.
    """
    tables = read_fits_tables(filename)
    if not tables:
        raise ValueError(f"{filename}: no binary tables")
    data = None
    for t in tables:
        if t["name"].upper() == "COADD":
            data = t["columns"]
            break
    if data is None:
        data = tables[0]["columns"]
    return _spec_from_columns(data)


def read_spec_dr14q(filename: str):
    """Load a DR14Q speclite file: the coadd always lives in the first
    extension, with the same columns (reference: read_spec.py:74-120)."""
    tables = read_fits_tables(filename)
    if not tables:
        raise ValueError(f"{filename}: no binary tables")
    return _spec_from_columns(tables[0]["columns"])


def _spec_from_columns(data):
    flux = np.asarray(data["flux"], np.float64)
    wavelengths = 10.0 ** np.asarray(data["loglam"], np.float64)
    ivar = np.asarray(data["ivar"], np.float64)
    and_mask = np.asarray(data["and_mask"]).astype(np.int64)

    noise_variance = np.full(ivar.shape, np.nan)
    good = ivar != 0
    noise_variance[good] = 1.0 / ivar[good]

    BRIGHTSKY = 24
    pixel_mask = (~good) | (((and_mask >> BRIGHTSKY) & 1) == 1)

    return wavelengths, flux, noise_variance, pixel_mask


def spec_reader(release: str = "dr12q"):
    """Reader function for a data release (the reference parameterizes
    its CLI by reader — reference: run_bayes_select.py:32,146)."""
    if release == "dr12q":
        return read_spec
    if release == "dr14q":
        return read_spec_dr14q
    raise ValueError(f"release must be dr12q or dr14q, got {release!r}")
