"""Write the full-width golden fixtures that the PyTorch port is held to on
the card (``chip_smoke.py``).

``dla``: the JAX package runs the DLA catalog on the CPU in float64 at the
full ``Parameters()`` (S = 10,000 samples, N = 1,280 pixels, k = 20,
max_dlas = 4): exact Voigt profiles and float64 profile storage.  Two
synthetic spectra, one clean and one with an injected DLA, go through
``process_spectrum`` with resampling indices drawn by numpy, so the port
can replay the identical chain without JAX.

``lls``: the same for the LLS search at the width of ``run_find_lls.py``
(S = 10,000, an 850 A model window with N = 1,664 pixels, k = 20,
max_lya = 4, the BOSS mean flux): ``lls_log_evidences`` on one clean
spectrum and one with an injected LLS whose Lyman-limit break lies inside
the window.

``civ``: the CIV QMC head at ``CIVParameters()`` (S = 10,000 samples,
N = 768 pixels, k = 20): null and CIV log evidences of the 8 spectra of
``chip_smoke.py``'s CIV phase, every odd one with a CIV doublet multiplied
into its flux (the injection of tests/test_accuracy_gates.py).

``i16``: the DLA catalog of ``dla`` (the same two spectra, seeds and
resampling indices) with int16 profile storage, the reference's
``GPY_DLA_ABS_DTYPE=i16``: the JAX package's ``qmc_log_evidences`` in
float64 with ``abs_dtype=jnp.int16`` for the 4 DLA levels (with the
``dla`` fixture's indices) and the subDLA level (``process_spectrum`` has no
storage argument, so the script calls it directly), and the null
evidence.  It holds the evidences and the MAP chains; the indices are the
``dla`` fixture's, which ``chip_smoke.py`` reads from there.

``zqso``: the zQSO head at ``ZParameters()`` (10,000 candidate
redshifts on ``sample_z_qsos``' grid over 2.14-6.16, spectra padded to
P = 5,632) with ``synthetic_z_learned_model(ZQSO_MODEL_SEED, k=20)``:
``inference_z_qso`` on 4 ``synthetic_z_observation`` spectra of that model
(z_true drawn by numpy from ``ZQSO_Z_SEED`` in 2.4-4.6, observation seeds
``ZQSO_OBS_SEEDS``) with ``method="corr"``, and on the first with
``method="exact"``, in float64.  It holds the seeds, z_true, a probe of
each spectrum's flux (every 460th pixel), the log likelihoods and the MAP
redshifts.

``train``: the GP training objective at the full ``Parameters()`` width
(R = 1,217 rest pixels, k = 20, 31 forest lines): ``TRAIN_Q`` = 64
spectra from the port's ``synthetic_training_lists`` (its numpy copies of
the generators: ``synthetic_learned_model(params, TRAIN_MODEL_SEED)``,
z_qso drawn from ``TRAIN_Z_SEED`` in 2.5-3.6, observation seeds
``TRAIN_OBS_SEED + i``, each normalized by its median flux at 1,310-1,325
A rest), through the JAX package's ``prepare_training_set`` and
``initialize``; at those initial parameters, in float64, the per-spectrum
``batched_spectrum_losses``, the ``total_objective`` and its five gradient
blocks by ``jax.grad``.

``analysis``: the catalog's science stage on the port's
``synthetic_processed_catalog(ANALYSIS_Q, ANALYSIS_S, ANALYSIS_SEED)``
(the toy catalog of tests/test_cddf.py with two DLA levels and chained
``base_sample_inds``), the JAX package's ``ProcessedCatalog(max_k=2)``
and ``tables``: the port's ``catalog_statistics`` of it in float64, with
the catalog's size, seed and a checksum of its likelihoods.

Run from the repository root, naming the fixtures to write (all by
default; each run rewrites the file, so name only the one that changes):

    JAX_PLATFORMS=cpu python scripts/make_torch_golden.py [dla] [lls] [civ] [i16] [zqso] [train] [analysis]

Output: tests/data/torch_golden_fullscale.npz, tests/data/torch_golden_lls.npz,
tests/data/torch_golden_civ.npz, tests/data/torch_golden_i16.npz,
tests/data/torch_golden_zqso.npz, tests/data/torch_golden_train.npz,
tests/data/torch_golden_analysis.npz
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_device", jax.devices("cpu")[0])

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from gpy_dla_detection_tpu.data.samples import (  # noqa: E402
    generate_dla_samples,
    generate_subdla_samples,
)
from gpy_dla_detection_tpu.data.synthetic import (  # noqa: E402
    synthetic_learned_model,
    synthetic_prior_catalog,
    synthetic_spectrum,
)
from gpy_dla_detection_tpu.models.lls import (  # noqa: E402
    generate_lya_samples,
    lls_log_evidences,
    lls_model_posteriors,
    with_boss_meanflux,
)
from gpy_dla_detection_tpu.models.pipeline import process_spectrum  # noqa: E402
from gpy_dla_detection_tpu.params import CIVParameters, Parameters  # noqa: E402

OUT = ROOT / "tests" / "data" / "torch_golden_fullscale.npz"
MAX_DLAS = 4
INDEX_SEED = 2026
# (z_qso, observation seed, injected (z_dla, logNHI) or None); the first
# two spectra of chip_smoke.py's 16
SPECTRA = (
    (2.6, 0, None),
    (2.6 + 0.8 / 15, 1, (2.6 + 0.8 / 15 - 0.3, 21.2)),
)

OUT_LLS = ROOT / "tests" / "data" / "torch_golden_lls.npz"
MAX_LYA = 4
LLS_INDEX_SEED = 2027
# the LLS search's width (run_find_lls.py)
LLS_PARAMS = dict(num_dla_samples=10000, min_lambda=850.0, num_pixels_padded=1664)
# (z_qso, observation seed, injected (z_lls, logNHI) or None); the first two
# of chip_smoke.py's LLS spectra: the injected break, at 911.76 A (1 + 3.0),
# lies inside the 850 A window, which starts at 850 A (1 + 3.2) ~ 3,570 A
LLS_SPECTRA = (
    (3.0, 100, None),
    (3.2, 101, (3.0, 18.5)),
)


def write_dla() -> None:
    params = Parameters()
    learned = synthetic_learned_model(params)
    prior = synthetic_prior_catalog(params)
    dla_samples = generate_dla_samples(params)
    sub_samples = generate_subdla_samples(params)
    S = params.num_dla_samples
    base_inds = np.random.default_rng(INDEX_SEED).integers(
        0, S, size=(len(SPECTRA), MAX_DLAS - 1, S)
    )
    fields = {k: [] for k in (
        "log_evidence_null", "log_evidences_dla", "log_evidence_subdla",
        "map_z_dlas", "map_log_nhis", "model_posteriors", "p_dla",
    )}
    for (z_qso, seed, dla), inds in zip(SPECTRA, base_inds):
        spec = synthetic_spectrum(
            params, learned, z_qso, seed=seed, dlas=None if dla is None else [dla]
        )
        res = process_spectrum(
            learned, spec, dla_samples, sub_samples, prior, params,
            jax.random.PRNGKey(0), max_dlas=MAX_DLAS, base_inds_override=inds,
        )
        fields["log_evidence_null"].append(res.log_evidence_null)
        fields["log_evidences_dla"].append(res.log_evidences_dla)
        fields["log_evidence_subdla"].append(res.log_evidence_subdla)
        fields["map_z_dlas"].append(res.map_z_dlas)
        fields["map_log_nhis"].append(res.map_log_nhis)
        fields["model_posteriors"].append(res.selection.model_posteriors)
        fields["p_dla"].append(res.p_dla)
        print(f"z_qso={z_qso:.4f} injected={dla is not None} p_dla={res.p_dla:.6f} "
              f"dla evidences={np.asarray(res.log_evidences_dla)}")
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        OUT,
        z_qso=np.array([s[0] for s in SPECTRA], np.float64),
        obs_seed=np.array([s[1] for s in SPECTRA], np.int64),
        injected=np.array([s[2] is not None for s in SPECTRA]),
        dla_z=np.array([np.nan if s[2] is None else s[2][0] for s in SPECTRA]),
        dla_log_nhi=np.array([np.nan if s[2] is None else s[2][1] for s in SPECTRA]),
        base_inds=base_inds.astype(np.uint16),
        **{k: np.asarray(v, np.float64) for k, v in fields.items()},
    )
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


def write_lls() -> None:
    params = Parameters(**LLS_PARAMS)
    # spectra are drawn from the synthetic model, the search runs with the
    # BOSS mean flux (run_find_lls.py --boss-meanflux)
    drawn_from = synthetic_learned_model(params)
    learned = with_boss_meanflux(drawn_from)
    samples = generate_lya_samples(params.num_dla_samples)
    S = params.num_dla_samples
    base_inds = np.random.default_rng(LLS_INDEX_SEED).integers(
        0, S, size=(len(LLS_SPECTRA), MAX_LYA - 1, S)
    )
    fields = {k: [] for k in (
        "log_evidence_null", "log_evidences_lls", "map_z_lls", "map_log_nhis",
        "model_posteriors",
    )}
    for (z_qso, seed, lls), inds in zip(LLS_SPECTRA, base_inds):
        spec = synthetic_spectrum(
            params, drawn_from, z_qso, seed=seed,
            dlas=None if lls is None else [lls], with_lls_break=True,
        )
        null_ev, res = lls_log_evidences(
            learned, spec, samples, jax.random.PRNGKey(0), MAX_LYA, params,
            base_inds_override=inds,
        )
        evs = np.asarray(res.log_evidences)
        post = lls_model_posteriors(float(null_ev), evs)
        fields["log_evidence_null"].append(float(null_ev))
        fields["log_evidences_lls"].append(evs)
        fields["map_z_lls"].append(np.asarray(res.map_z_dlas))
        fields["map_log_nhis"].append(np.asarray(res.map_log_nhis))
        fields["model_posteriors"].append(post)
        print(f"z_qso={z_qso:.4f} injected={lls is not None} P(k>=1)={1.0 - post[0]:.6f} "
              f"evidences={evs} MAP z={float(res.map_z_dlas[0][0]):.5f}")
    OUT_LLS.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        OUT_LLS,
        z_qso=np.array([s[0] for s in LLS_SPECTRA], np.float64),
        obs_seed=np.array([s[1] for s in LLS_SPECTRA], np.int64),
        injected=np.array([s[2] is not None for s in LLS_SPECTRA]),
        lls_z=np.array([np.nan if s[2] is None else s[2][0] for s in LLS_SPECTRA]),
        lls_log_nhi=np.array([np.nan if s[2] is None else s[2][1] for s in LLS_SPECTRA]),
        base_inds=base_inds.astype(np.int16),
        **{k: np.asarray(v, np.float64) for k, v in fields.items()},
    )
    print(f"wrote {OUT_LLS} ({OUT_LLS.stat().st_size} bytes)")


OUT_CIV = ROOT / "tests" / "data" / "torch_golden_civ.npz"
# (z_qso, observation seed, injected (z_civ, logN_CIV, sigma [cm/s]) or
# None): chip_smoke.py's CIV spectra, in the strong regime of the CIV
# accuracy gate (logN 14.2-14.5, sigma 1.5e6-4e6, z_civ 0.05-0.2 below z_qso)
CIV_SPECTRA = tuple(
    (2.0 + 0.04 * i, 300 + i,
     (2.0 + 0.04 * i - 0.06 - 0.02 * i, 14.3 + 0.025 * i, 1.5e6 + 3.5e5 * i) if i % 2 else None)
    for i in range(8)
)


def civ_doublet_transmission(wl, z_civ, log_n, sigma):
    """exp(-tau) of one unbroadened CIV doublet: the injection of
    tests/test_accuracy_gates.py, on the JAX package's constants."""
    from scipy.special import wofz

    from gpy_dla_detection_tpu import constants as C

    tau = np.zeros_like(wl, dtype=np.float64)
    for l in range(2):
        lam_c = C.CIV_WAVELENGTHS_CM[l] * 1e8 * (1 + z_civ)
        vel = (wl - lam_c) * (C.SPEED_OF_LIGHT_CGS / lam_c)
        zz = (vel + 1j * C.CIV_LORENTZIAN_WIDTHS[l]) / (np.sqrt(2) * sigma)
        tau += (
            10.0**log_n
            * C.CIV_LEADING_CONSTANTS[l]
            * np.real(wofz(zz))
            / (np.sqrt(2 * np.pi) * sigma)
        )
    return np.exp(-tau)


def write_civ() -> None:
    from gpy_dla_detection_tpu.data.spectrum import preprocess
    from gpy_dla_detection_tpu.data.synthetic import synthetic_observation
    from gpy_dla_detection_tpu.models.civ import (
        _civ_step,
        civ_model_posterior,
        generate_civ_samples,
    )

    params = CIVParameters()
    learned = synthetic_learned_model(params)
    samples = generate_civ_samples(params)
    null_evs, civ_evs, p_civ = [], [], []
    for z_qso, seed, civ in CIV_SPECTRA:
        wl, flux, nv, mask = synthetic_observation(params, learned, z_qso, seed=seed)
        if civ is not None:
            flux = flux * civ_doublet_transmission(wl, *civ)
        spec = preprocess(wl, flux, nv, mask, z_qso, params)
        null_ev, civ_ev = (float(x) for x in _civ_step(learned, spec, samples, params))
        null_evs.append(null_ev)
        civ_evs.append(civ_ev)
        p_civ.append(civ_model_posterior(null_ev, civ_ev))
        print(f"z_qso={z_qso:.4f} injected={civ is not None} p_civ={p_civ[-1]:.6f} "
              f"null={null_ev:.6f} civ={civ_ev:.6f}")
    nan3 = (np.nan, np.nan, np.nan)
    injected = np.array([c if c is not None else nan3 for _, _, c in CIV_SPECTRA], np.float64)
    OUT_CIV.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        OUT_CIV,
        z_qso=np.array([s[0] for s in CIV_SPECTRA], np.float64),
        obs_seed=np.array([s[1] for s in CIV_SPECTRA], np.int64),
        injected=np.array([s[2] is not None for s in CIV_SPECTRA]),
        civ_z=injected[:, 0], civ_log_n=injected[:, 1], civ_sigma=injected[:, 2],
        log_evidence_null=np.asarray(null_evs, np.float64),
        log_evidence_civ=np.asarray(civ_evs, np.float64),
        p_civ=np.asarray(p_civ, np.float64),
    )
    print(f"wrote {OUT_CIV} ({OUT_CIV.stat().st_size} bytes)")


OUT_I16 = ROOT / "tests" / "data" / "torch_golden_i16.npz"


def write_i16() -> None:
    import jax.numpy as jnp

    from gpy_dla_detection_tpu.models.evidence import null_log_evidence, qmc_log_evidences
    from gpy_dla_detection_tpu.models.learned import build_spectrum_model

    params = Parameters()
    learned = synthetic_learned_model(params)
    dla_samples = generate_dla_samples(params)
    sub_samples = generate_subdla_samples(params)
    S = params.num_dla_samples
    # the dla fixture's indices: the same seed and draw
    base_inds = np.random.default_rng(INDEX_SEED).integers(
        0, S, size=(len(SPECTRA), MAX_DLAS - 1, S)
    )

    @jax.jit
    def evidences(spec, base):
        model = build_spectrum_model(learned, spec, params)
        sample_args = lambda s: (jnp.asarray(s.offset_samples), jnp.asarray(s.log_nhi_samples),
                                 jnp.asarray(s.nhi_samples))
        dla = qmc_log_evidences(model, *sample_args(dla_samples), jax.random.PRNGKey(0),
                                MAX_DLAS, params, base_inds_override=base, abs_dtype=jnp.int16)
        sub = qmc_log_evidences(model, *sample_args(sub_samples), jax.random.PRNGKey(1), 1,
                                params, abs_dtype=jnp.int16)
        return null_log_evidence(model), dla, sub

    fields = {k: [] for k in (
        "log_evidence_null", "log_evidences_dla", "log_evidence_subdla",
        "map_z_dlas", "map_log_nhis",
    )}
    for (z_qso, seed, dla), inds in zip(SPECTRA, base_inds):
        spec = synthetic_spectrum(
            params, learned, z_qso, seed=seed, dlas=None if dla is None else [dla]
        )
        null_ev, res, sub = evidences(spec, jnp.asarray(inds, jnp.int32))
        fields["log_evidence_null"].append(float(null_ev))
        fields["log_evidences_dla"].append(np.asarray(res.log_evidences))
        fields["log_evidence_subdla"].append(float(sub.log_evidences[0]))
        fields["map_z_dlas"].append(np.asarray(res.map_z_dlas))
        fields["map_log_nhis"].append(np.asarray(res.map_log_nhis))
        print(f"z_qso={z_qso:.4f} injected={dla is not None} null={float(null_ev):.6f} "
              f"dla evidences={np.asarray(res.log_evidences)} subdla={float(sub.log_evidences[0])}")
    OUT_I16.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        OUT_I16,
        z_qso=np.array([s[0] for s in SPECTRA], np.float64),
        obs_seed=np.array([s[1] for s in SPECTRA], np.int64),
        injected=np.array([s[2] is not None for s in SPECTRA]),
        **{k: np.asarray(v, np.float64) for k, v in fields.items()},
    )
    print(f"wrote {OUT_I16} ({OUT_I16.stat().st_size} bytes)")


OUT_ZQSO = ROOT / "tests" / "data" / "torch_golden_zqso.npz"
ZQSO_MODEL_SEED = 0
ZQSO_K = 20
ZQSO_Z_SEED = 2028
ZQSO_OBS_SEEDS = (1, 2, 3, 4)
ZQSO_FLUX_PROBE = 460  # every 460th pixel of each spectrum's flux


def write_zqso() -> None:
    from gpy_dla_detection_tpu.data.synthetic import synthetic_z_observation
    from gpy_dla_detection_tpu.models.zqso import inference_z_qso, prepare_z_spectrum
    from gpy_dla_detection_tpu.params import ZParameters

    params = ZParameters()
    z_true = np.random.default_rng(ZQSO_Z_SEED).uniform(2.4, 4.6, len(ZQSO_OBS_SEEDS))
    probes, lls_corr, z_map_corr = [], [], []
    lls_exact = z_map_exact = None
    for i, (z, obs_seed) in enumerate(zip(z_true, ZQSO_OBS_SEEDS)):
        learned, (wl, flux, nv, pm) = synthetic_z_observation(
            float(z), seed=ZQSO_MODEL_SEED, k=ZQSO_K, obs_seed=obs_seed)
        probes.append(flux[::ZQSO_FLUX_PROBE])
        spec = prepare_z_spectrum(wl, flux, nv, pm, params.num_pixels_padded)
        z_map, lls, grid = inference_z_qso(learned, spec, params, method="corr")
        lls_corr.append(lls)
        z_map_corr.append(z_map)
        print(f"z_true={z:.4f} corr z_map={z_map:.4f} max ll={np.nanmax(lls):.3f}")
        if i == 0:
            z_map_exact, lls_exact, _ = inference_z_qso(learned, spec, params, method="exact")
            print(f"z_true={z:.4f} exact z_map={z_map_exact:.4f}")
    np.savez_compressed(
        OUT_ZQSO,
        model_seed=np.int64(ZQSO_MODEL_SEED),
        k=np.int64(ZQSO_K),
        z_seed=np.int64(ZQSO_Z_SEED),
        obs_seed=np.array(ZQSO_OBS_SEEDS, np.int64),
        z_true=z_true,
        flux_probe=np.stack(probes),
        flux_probe_step=np.int64(ZQSO_FLUX_PROBE),
        z_grid=np.asarray(grid, np.float64),
        lls_corr=np.stack(lls_corr).astype(np.float64),
        z_map_corr=np.array(z_map_corr, np.float64),
        lls_exact=np.asarray(lls_exact, np.float64)[None],
        z_map_exact=np.array([z_map_exact], np.float64),
    )
    print(f"wrote {OUT_ZQSO} ({OUT_ZQSO.stat().st_size} bytes)")


OUT_TRAIN = ROOT / "tests" / "data" / "torch_golden_train.npz"
TRAIN_Q = 64
TRAIN_MODEL_SEED = 3
TRAIN_Z_SEED = 2029
TRAIN_OBS_SEED = 500
TRAIN_NOISE = 0.05


def write_train() -> None:
    import jax.numpy as jnp

    from gpy_dla_detection_tpu.models.training import (
        batched_spectrum_losses,
        initialize,
        prepare_training_set,
        total_objective,
    )
    from gpy_dla_detection_tpu_torch.data import synthetic as port_synthetic
    from gpy_dla_detection_tpu_torch.params import Parameters as PortParameters

    params = Parameters()
    # the spectra: numpy draws of the port's generator copies, which
    # tests/test_torch_standalone.py holds bit for bit to the reference's
    truth = port_synthetic.synthetic_learned_model(PortParameters(), seed=TRAIN_MODEL_SEED)
    z_qsos = np.random.default_rng(TRAIN_Z_SEED).uniform(2.5, 3.6, TRAIN_Q)
    train = prepare_training_set(params, *port_synthetic.synthetic_training_lists(
        PortParameters(), truth, z_qsos, TRAIN_OBS_SEED, TRAIN_NOISE), z_qsos)
    mu, p0 = initialize(params, train)
    args = (jnp.asarray(np.where(train.mask, train.flux - mu, 0.0)),
            jnp.asarray(train.lya_1pz), jnp.asarray(train.noise_variance),
            jnp.asarray(train.mask), jnp.asarray(train.zqso_1pz))
    losses = np.asarray(batched_spectrum_losses(p0, *args, params.num_forest_lines))
    objective, grads = jax.value_and_grad(total_objective)(p0, *args, params)
    print(f"train: Q={TRAIN_Q} R={train.flux.shape[1]} k={params.k} objective "
          f"{float(objective):.6f}, losses {losses.min():.3f}..{losses.max():.3f}")
    np.savez_compressed(
        OUT_TRAIN,
        model_seed=np.int64(TRAIN_MODEL_SEED),
        z_seed=np.int64(TRAIN_Z_SEED),
        obs_seed=np.int64(TRAIN_OBS_SEED),
        noise_level=np.float64(TRAIN_NOISE),
        k=np.int64(params.k),
        z_qso=z_qsos,
        mu=np.asarray(mu, np.float64),
        losses=losses.astype(np.float64),
        objective=np.float64(objective),
        **{f"grad_{name}": np.asarray(getattr(grads, name), np.float64)
           for name in grads._fields},
    )
    print(f"wrote {OUT_TRAIN} ({OUT_TRAIN.stat().st_size} bytes)")


OUT_ANALYSIS = ROOT / "tests" / "data" / "torch_golden_analysis.npz"
ANALYSIS_Q, ANALYSIS_S, ANALYSIS_SEED = 64, 2000, 17


def write_analysis() -> None:
    from gpy_dla_detection_tpu.analysis import tables
    from gpy_dla_detection_tpu.analysis.cddf import ProcessedCatalog
    from gpy_dla_detection_tpu_torch.data.synthetic import (
        catalog_statistics,
        synthetic_processed_catalog,
    )

    arrays = synthetic_processed_catalog(ANALYSIS_Q, ANALYSIS_S, ANALYSIS_SEED)
    stats = catalog_statistics(ProcessedCatalog(**arrays, max_k=2), tables)
    print(f"analysis: Q={ANALYSIS_Q} S={ANALYSIS_S} seed={ANALYSIS_SEED}, "
          f"{len(stats)} arrays, dN/dX {np.round(stats['line_density.dNdX'], 4)}")
    np.savez_compressed(
        OUT_ANALYSIS,
        num_spec=np.int64(ANALYSIS_Q),
        num_samples=np.int64(ANALYSIS_S),
        seed=np.int64(ANALYSIS_SEED),
        likelihood_checksum=np.nansum(arrays["sample_log_likelihoods"]),
        **stats,
    )
    print(f"wrote {OUT_ANALYSIS} ({OUT_ANALYSIS.stat().st_size} bytes)")


def main(argv: list[str]) -> None:
    writers = {"dla": write_dla, "lls": write_lls, "civ": write_civ, "i16": write_i16,
               "zqso": write_zqso, "train": write_train, "analysis": write_analysis}
    which = argv or list(writers)
    unknown = set(which) - set(writers)
    if unknown:
        raise SystemExit(f"unknown fixture(s) {sorted(unknown)}; choose from {', '.join(writers)}")
    for name in which:
        writers[name]()


if __name__ == "__main__":
    main(sys.argv[1:])
