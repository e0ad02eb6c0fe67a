"""The port's ``data/download`` against the JAX package's, offline.

``spec_url`` is pure: the same URL on every v5_7_2 plate, on plates
beside them and in both releases, and the same refusal of another
release.  The two fetchers run with ``urllib.request.urlretrieve``
replaced by a recorder that writes the file or fails as told, so no test
touches the network: the alternates of a v5_7_2 file are tried in order,
a present file is not fetched again (unless ``overwrite``), and the
error messages are the reference's.  Exact equality throughout (strings
and lists).
"""

from urllib import request

import numpy as np
import pytest

from gpy_dla_detection_tpu.data import build_catalog as JB
from gpy_dla_detection_tpu.data import download as JD
from gpy_dla_detection_tpu_torch.data import build_catalog as TB
from gpy_dla_detection_tpu_torch.data import download as TD


@pytest.fixture
def fetches(monkeypatch):
    """``urlretrieve`` replaced: each URL is recorded; a URL containing a
    string of ``fetches.fail`` raises, any other writes a small file."""

    class Recorder(list):
        fail: tuple = ()

    calls = Recorder()

    def fake(url, path):
        calls.append(url)
        if any(bad in url for bad in calls.fail):
            raise OSError(f"HTTP Error 404: {url}")
        with open(path, "w") as f:
            f.write(url)
        return path, None

    monkeypatch.setattr(request, "urlretrieve", fake)
    return calls


@pytest.mark.parametrize("release", ["dr12q", "dr14q"])
def test_spec_url_on_every_v5_7_2_plate_and_beside(release):
    plates = list(TB.V_5_7_2_PLATES) + [7338, 7341, 7566, 3586, 10000]
    for plate in plates:
        for mjd, fiber in ((56000, 1), (57520, 1000)):
            got = TD.spec_url(int(plate), mjd, fiber, release)
            assert got == JD.spec_url(int(plate), mjd, fiber, release)
    v572 = TD.spec_url(7339, 56000, 12, release)
    assert ("/v5_7_2/" in v572) == (release == "dr12q")
    assert "/v5_7_0/" in TD.spec_url(7338, 56000, 12, "dr12q")
    assert np.array_equal(TB.V_5_7_2_PLATES, JB.V_5_7_2_PLATES)
    assert (TD.SDSS_BASE, TD.EBOSS_BASE) == (JD.SDSS_BASE, JD.EBOSS_BASE)


def test_spec_url_refuses_another_release():
    with pytest.raises(ValueError, match="dr12q or dr14q") as got:
        TD.spec_url(7339, 56000, 12, "dr16q")
    with pytest.raises(ValueError) as want:
        JD.spec_url(7339, 56000, 12, "dr16q")
    assert str(got.value) == str(want.value)


def test_retrieve_raw_spec(fetches, tmp_path):
    for mod, name in ((JD, "j"), (TD, "t")):
        directory = str(tmp_path / name / "spectra")
        path = mod.retrieve_raw_spec(7339, 56000, 12, "dr12q", directory)
        assert path == f"{directory}/spec-7339-56000-0012.fits"
        assert mod.retrieve_raw_spec(7339, 56000, 12, "dr12q", directory) == path
        mod.retrieve_raw_spec(7339, 56000, 12, "dr14q", directory, overwrite=True)
    half = len(fetches) // 2
    assert fetches[:half] == fetches[half:] and half == 2
    assert "/v5_7_2/" in fetches[0] and "/dr16/eboss/" in fetches[1]
    fetches.fail = ("spec-4000",)
    messages = []
    for mod in (JD, TD):
        with pytest.raises(RuntimeError, match="offline environment") as e:
            mod.retrieve_raw_spec(4000, 55000, 3, "dr12q", str(tmp_path / "x"))
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_download_file_list_tries_the_alternates_in_order(fetches, tmp_path):
    """A build_catalog file list with a v5_7_2 file listed under both
    redux versions: one path for it, the v5_7_2 location tried first and
    the v5_7_0 one only when it fails; every other file once."""
    lines = ["v5_7_2/spectra/lite/./7339/spec-7339-56000-0012.fits",
             "v5_7_0/spectra/lite/./7339/spec-7339-56000-0012.fits",
             "", "v5_7_0/spectra/lite/./4000/spec-4000-55000-0003.fits"]
    listing = tmp_path / "file_list.txt"
    listing.write_text("\n".join(lines) + "\n")
    runs = {}
    for fail in ((), ("v5_7_2",)):
        fetches.fail = fail
        for mod, name in ((JD, "j"), (TD, "t")):
            del fetches[:]
            directory = tmp_path / f"{name}{len(fail)}"
            paths = mod.download_file_list(str(listing), str(directory))
            assert paths == [str(directory / "spec-7339-56000-0012.fits"),
                             str(directory / "spec-4000-55000-0003.fits")]
            assert (directory / "spec-7339-56000-0012.fits").read_text() == fetches[len(fail)]
            runs[name, fail] = list(fetches)
            assert mod.download_file_list(str(listing), str(directory)) == paths
            assert fetches == runs[name, fail]  # present files are not fetched again
    for fail in ((), ("v5_7_2",)):
        assert runs["t", fail] == runs["j", fail]
    assert [u.split("/redux/")[1] for u in runs["t", ("v5_7_2",)]] == [
        "v5_7_2/spectra/lite/7339/spec-7339-56000-0012.fits",
        "v5_7_0/spectra/lite/7339/spec-7339-56000-0012.fits",
        "v5_7_0/spectra/lite/4000/spec-4000-55000-0003.fits"]

    fetches.fail = ("spec-7339",)
    messages = []
    for mod, name in ((JD, "j"), (TD, "t")):
        with pytest.raises(RuntimeError, match="could not download spec-7339") as e:
            mod.download_file_list(str(listing), str(tmp_path / f"{name}_fail"))
        messages.append(str(e.value).replace(str(tmp_path / f"{name}_fail"), ""))
    assert messages[0] == messages[1] and "v5_7_0" in messages[1]
