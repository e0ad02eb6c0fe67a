"""The port's systematic importance resampler (``resampler="systematic"``,
the reference's ``GPY_DLA_RESAMPLER=systematic``) against
``tests/test_resampler.py``'s cases and the JAX comb.

* the comb is JAX's ``_draw_base_indices(key, probs, "systematic")`` bit
  for bit, given the cumulative weights, ``u0`` and roll that JAX draws
  from that key;
* per-category counts within 1 of S p_i (the defining property);
* flat weights chain no slot with itself (the roll);
* chained-level evidences agree with the multinomial ones within
  resampling noise: 10x the spread of two other multinomial seeds, or
  0.5 (the JAX test's bound), and level 0 is unchanged;
* (slow, full width) a clean spectrum's third chained level takes one of
  two values 2.8 apart under the JAX package's own resamplers, both of
  them, in float64, and the port given JAX's draws gives JAX's values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpy_dla_detection_tpu.models import evidence as J_evidence
from gpy_dla_detection_tpu_torch.data.fits import read_spec
from gpy_dla_detection_tpu_torch.data.samples import (
    generate_dla_samples,
    generate_subdla_samples,
)
from gpy_dla_detection_tpu_torch.data.spectrum import preprocess
from gpy_dla_detection_tpu_torch.data.spectrum import to_torch
from gpy_dla_detection_tpu_torch.data.synthetic import (
    synthetic_learned_model,
    synthetic_observation,
    synthetic_prior_catalog,
    synthetic_spectrum,
)
from gpy_dla_detection_tpu_torch.models.evidence import (
    _draw_base_indices,
    qmc_log_evidences,
    systematic_comb,
)
from gpy_dla_detection_tpu_torch.models.learned import LearnedModel, build_spectrum_model
from gpy_dla_detection_tpu_torch.models.pipeline import process_spectrum, sample_tensors
from gpy_dla_detection_tpu_torch.params import Parameters

from .test_fits import _write_speclite

torch.set_num_threads(2)


def _n_descents(a):
    """Positions where the sequence decreases: 0 for sorted, <= 1 for one
    rotation of a sorted sequence."""
    return int(np.sum(np.diff(np.asarray(a)) < 0))


def _probs(kind, S, seed):
    rng = np.random.default_rng(seed)
    if kind == "flat":
        p = np.full(S, 1.0 / S)
    elif kind == "gamma":
        p = rng.gamma(0.5, size=S)
    else:  # a few dominant parents among near-zero weights, some exactly 0
        p = np.exp(-rng.uniform(0, 60, S))
        p[rng.integers(0, S, S // 10)] = 0.0
    return p / p.sum()


@pytest.mark.parametrize("kind", ["flat", "gamma", "peaked"])
@pytest.mark.parametrize("S, seed", [(60, 0), (2048, 1), (10000, 2)])
def test_comb_equals_jax_given_its_draws(kind, S, seed):
    """Given the cumulative weights JAX sums and the ``u0`` and roll JAX
    draws from its key, the port's comb gives JAX's indices exactly."""
    probs = jnp.asarray(_probs(kind, S, seed))
    key = jax.random.PRNGKey(seed)
    want = np.asarray(J_evidence._draw_base_indices(key, probs, "systematic"))
    k_u, k_r = jax.random.split(key)
    u0 = float(jax.random.uniform(k_u, (), jnp.float64))
    shift = int(jax.random.randint(k_r, (), 0, S))
    cdf = torch.as_tensor(np.array(jnp.cumsum(probs)))
    got = systematic_comb(cdf, torch.tensor(u0, dtype=torch.float64), torch.tensor(shift))
    np.testing.assert_array_equal(got.numpy(), want)
    assert _n_descents(want) <= 1


def test_systematic_comb_counts_within_one():
    """The unrolled comb is sorted and its per-category counts are in
    {floor(S p_i), ceil(S p_i)}; the drawn (rolled) comb keeps the counts."""
    S = 4096
    probs = torch.as_tensor(_probs("gamma", S, 3))
    cdf = torch.cumsum(probs, 0)
    base = systematic_comb(cdf, torch.tensor(0.6180339887, dtype=torch.float64), 0).numpy()
    assert _n_descents(base) == 0, "the raw comb must be sorted"
    counts = np.bincount(base, minlength=S)
    # float rounding in the cumsum can shift a boundary by one slot
    np.testing.assert_array_less(np.abs(counts - S * probs.numpy()), 1.0 + 1e-6)
    drawn = _draw_base_indices(torch.Generator().manual_seed(0), probs, "systematic").numpy()
    np.testing.assert_array_less(
        np.abs(np.bincount(drawn, minlength=S) - S * probs.numpy()), 1.0 + 1e-6)
    assert _n_descents(drawn) <= 1


def test_systematic_draw_decouples_flat_weights():
    """Under flat weights the unrolled comb gives base[i] == i; the roll
    breaks that coupling and keeps one parent a slot and near-sortedness.
    The multinomial draw stays as it was (same generator, same draws)."""
    S = 2048
    probs = torch.full((S,), 1.0 / S, dtype=torch.float64)
    for seed in range(5):
        base = _draw_base_indices(torch.Generator().manual_seed(seed), probs, "systematic")
        base = base.numpy()
        assert np.mean(base == np.arange(S)) < 0.01, seed
        assert _n_descents(base) <= 1
        np.testing.assert_array_equal(np.bincount(base, minlength=S), np.ones(S))
    g1, g2 = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    multinomial = _draw_base_indices(g1, probs, "multinomial")
    np.testing.assert_array_equal(multinomial.numpy(), _draw_base_indices(g2, probs).numpy())
    assert multinomial.min() >= 0 and multinomial.max() < S


@pytest.fixture(scope="module")
def problem():
    params = Parameters(num_dla_samples=2000)
    learned = synthetic_learned_model(params)
    samples = generate_dla_samples(params)
    spec = synthetic_spectrum(params, learned, 3.05, seed=7, dlas=[(2.8, 20.8)])
    module = LearnedModel.from_numpy(learned, "cpu", torch.float64)
    model = build_spectrum_model(module, to_torch(spec, "cpu", torch.float64), params)
    return params, sample_tensors(samples, "cpu", torch.float64), model


def _evidences(problem, resampler, seed=0):
    params, samples, model = problem
    return qmc_log_evidences(model, *samples, torch.Generator().manual_seed(seed), 3, params,
                             resampler=resampler)


def test_systematic_evidences_match_multinomial(problem):
    """Chained-level evidences under the systematic resampler agree with
    the multinomial ones within resampling noise, and each drawn level is
    two ascending runs."""
    ref = _evidences(problem, "multinomial")
    got = _evidences(problem, "systematic")
    base = got.base_sample_inds.numpy()
    assert base.shape[0] == 2
    for row in base:
        assert _n_descents(row) <= 1
    # level 0 shares no resampling
    assert float(got.log_evidences[0]) == float(ref.log_evidences[0])
    spread = max(
        abs(float(_evidences(problem, "multinomial", s).log_evidences[k])
            - float(ref.log_evidences[k]))
        for s in (1, 2) for k in (1, 2)
    )
    for k in (1, 2):
        delta = abs(float(got.log_evidences[k]) - float(ref.log_evidences[k]))
        assert delta <= max(10 * spread, 0.5), (k, delta, spread)


def test_resampler_is_checked(problem):
    with pytest.raises(ValueError, match="resampler must be one of"):
        _evidences(problem, "stratified")


@pytest.mark.slow
def test_third_chained_level_modes(tmp_path, monkeypatch):
    """Spectrum 22 of ``chip_smoke.py`` phase 17 (clean, z_qso 3.168) at
    ``Parameters()``, in float64: its third chained level takes one of two
    values ~2.84 apart (the second chained level two ~0.46 apart), and
    which one a run takes is decided by the resampling draws, under the
    JAX package's multinomial and systematic resamplers alike, so a
    systematic run that differs from a multinomial one by 2.84 there is
    not a fault of the resampler.  The port, given JAX's systematic
    indices, gives JAX's evidences at every level.  JAX ~12 s a run and
    the port ~75 s on the CPU (minutes: marked slow)."""
    from gpy_dla_detection_tpu.data.fits import read_spec as j_read_spec
    from gpy_dla_detection_tpu.data.samples import (
        generate_dla_samples as j_dla_samples,
        generate_subdla_samples as j_subdla_samples,
    )
    from gpy_dla_detection_tpu.data.spectrum import preprocess as j_preprocess
    from gpy_dla_detection_tpu.data.synthetic import (
        synthetic_learned_model as j_learned_model,
        synthetic_prior_catalog as j_prior_catalog,
    )
    from gpy_dla_detection_tpu.models.pipeline import process_spectrum as j_process
    from gpy_dla_detection_tpu.params import Parameters as JParameters

    index = 22
    params = Parameters()
    arrays = synthetic_learned_model(params)
    z = float(np.linspace(2.6, 3.4, 32)[index])
    wl, fx, nv, pm = synthetic_observation(params, arrays, z, seed=1000 + index)
    path = tmp_path / "spec.fits"
    _write_speclite(path, fx.astype(np.float32), np.log10(wl).astype(np.float32),
                    (1.0 / nv).astype(np.float32), np.where(pm, 1 << 24, 0).astype(np.int32))

    j_params = JParameters()
    j_learned = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), j_learned_model(j_params))
    j_spec = j_preprocess(*j_read_spec(str(path)), z, j_params)
    j_dla, j_sub = j_dla_samples(j_params), j_subdla_samples(j_params)
    j_prior = j_prior_catalog(j_params)

    def jax_runs(resampler, seeds):
        monkeypatch.setattr(J_evidence, "_RESAMPLER", resampler)
        jax.clear_caches()  # the resampler is read when the pipeline is traced
        try:
            return [j_process(j_learned, j_spec, j_dla, j_sub, j_prior, j_params,
                              jax.random.PRNGKey(seed), 4) for seed in seeds]
        finally:
            jax.clear_caches()

    multinomial = jax_runs("multinomial", range(4))
    systematic = jax_runs("systematic", range(8))
    level = lambda runs, k: np.array([float(r.log_evidences_dla[k]) for r in runs])
    print("\nJAX float64, spectrum 22, log evidence of levels 2-3 less the null's:")
    for name, runs in (("multinomial", multinomial), ("systematic", systematic)):
        for seed, r in enumerate(runs):
            print(f"  {name} seed {seed}: " + ", ".join(
                f"{float(r.log_evidences_dla[k]) - float(r.log_evidence_null):.4f}"
                for k in (2, 3)))
    m3, s3 = level(multinomial, 3), level(systematic, 3)
    # the multinomial seeds take two values of the third level 2.8 apart
    assert 2.7 < m3.max() - m3.min() < 3.0, m3
    # every systematic run takes one of the values the multinomial seeds
    # take, and both of them occur
    nearest = np.abs(s3[:, None] - m3[None, :]).min(axis=1)
    assert nearest.max() < 0.1, (s3, m3)
    assert s3.max() - s3.min() > 2.7, s3

    # the port given JAX's indices of the systematic run in the lower value
    lower = systematic[int(np.argmin(s3))]
    learned = LearnedModel.from_numpy(arrays, "cpu", torch.float64)
    spec = preprocess(*read_spec(str(path)), z, params)
    got = process_spectrum(
        learned, spec, generate_dla_samples(params), generate_subdla_samples(params),
        synthetic_prior_catalog(params), params, torch.Generator(), 4,
        base_inds_override=np.asarray(lower.base_sample_inds))
    np.testing.assert_allclose(got.log_evidences_dla, np.asarray(lower.log_evidences_dla),
                               rtol=1e-10)
    np.testing.assert_array_equal(got.base_sample_inds, np.asarray(lower.base_sample_inds))
