"""The frozen generators give the same inputs at a seed (fixed checksums)."""

import json

import numpy as np
import pytest

from harness import gen, layout

SEED = 2**31 + 12345


@pytest.fixture(scope="module")
def cfgs():
    load = lambda n: json.loads((layout.BENCH_DIR / "configs" / f"{n}.json").read_text())
    return load("dla_catalog"), load("zqso")


def test_catalog_inputs(cfgs):
    cfg, _ = cfgs
    learned = gen.learned_model(cfg, gen.rng_for(SEED, 1))
    assert float(learned.M.sum()) == pytest.approx(-39.44135890865172, rel=1e-12)
    assert float(np.abs(learned.M).sum()) == pytest.approx(601.2255819380038, rel=1e-12)
    z, ind = gen.prior_catalog(gen.rng_for(SEED, 2))
    assert float(z.sum()) == pytest.approx(19071.891163642136, rel=1e-12) and int(ind.sum()) == 534
    dla = gen.dla_samples(cfg)
    assert float(dla.log_nhi_samples.sum()) == pytest.approx(205417.55358229848, rel=1e-12)
    assert float(dla.offset_samples.sum()) == pytest.approx(4998.324768066406, rel=1e-12)
    sub, z_lls, z_dla = gen.subdla_samples(cfg)
    assert float(sub.log_nhi_samples.sum()) == pytest.approx(197499.360256, rel=1e-12)
    assert (z_lls, z_dla) == pytest.approx((0.3719204790565327, 0.6280782108073304), rel=1e-12)
    obs = gen.observation(cfg, learned, 3.5, gen.rng_for(SEED, 3, 0), ((2.9, 20.5),))
    spec = gen.preprocess(cfg, *obs, 3.5)
    assert float(spec.flux.sum()) == pytest.approx(992.9791472713725, rel=1e-10)
    assert int(spec.mask.sum()) == 1236
    assert (float(spec.min_z_dla), float(spec.max_z_dla)) == pytest.approx(
        (2.385046623182538, 3.489726292154297), rel=1e-12)


def test_zqso_inputs(cfgs):
    _, zcfg = cfgs
    learned = gen.z_learned_model(zcfg, gen.rng_for(SEED, 1))
    assert float(learned.M.sum()) == pytest.approx(130.86737461678655, rel=1e-12)
    obs = gen.pad_z_observation(*gen.z_observation(learned, 3.1, gen.rng_for(SEED, 3, 0)), 5632)
    assert float(obs.flux.sum()) == pytest.approx(3012.8728606258915, rel=1e-12)
    assert int(obs.valid.sum()) == 4600 and obs.wavelengths.shape == (5632,)


def test_a_large_seed_is_taken():
    assert gen.seed_for(2**40 + 3, 7, 1) != gen.seed_for(2**40 + 3, 7, 2)
    assert 0 <= gen.seed_for(2**40 + 3, 7, 1) < 2**63
