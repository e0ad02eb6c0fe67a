"""The DLA catalog's model selection for one spectrum, in plain PyTorch.

The reference the catalog cell holds the program to.  It takes the raw
inputs the benchmark made (the learned GP's arrays, a preprocessed
spectrum, the two QMC sample sets, the prior catalog) and works out
everything again: the GP interpolated onto the spectrum with the Lyman
forest's mean-flux suppression, the null evidence, each sample's exact
Voigt profile (Faddeeva at every pixel, 7-tap instrumental convolution),
every QMC level's Woodbury likelihood (a Cholesky of the k x k
capacitance), the 3,000 km/s pair cut, the level evidences, the MAPs, the
model priors and posteriors.

The chained levels pair each sample with parents drawn by importance
resampling from the run's torch generator.  The reference judges the
program's levels on the program's own parents (``base_inds``, one of its
outputs), which it takes to recompute those samples, and checks the draw
apart: it replays the generator's uniforms and draws with its own weights
(:func:`draw_parents`).  Without ``base_inds`` it draws its parents itself,
so that it can stand in the program's place as the control.

``Precision`` says how it computes: float64 (the reference) or float32 with
its products in TF32 (the control: operands rounded to TF32's 10-bit
mantissa, float32 sums).  The redshift samples are always float32, as the
configuration states them, so the pair cut compares the values the
program compares.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import physics as C
from .faddeeva import wofz


class Precision(NamedTuple):
    dtype: torch.dtype
    tf32: bool


REFERENCE = Precision(torch.float64, False)
CONTROL = Precision(torch.float32, True)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits, ties away from 0)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    if prec.tf32:
        a, b = tf32_round(a), tf32_round(b)
    return a @ b


def _interp_uniform(x0, dx, values, xq):
    """Linear interpolation on the uniform grid ``x0 + dx * i``, clamped."""
    n = values.shape[0]
    t = (xq - x0) / dx
    i = torch.clamp(torch.floor(t).long(), 0, n - 2)
    f = torch.clamp(t - i, 0.0, 1.0)
    if values.ndim == 2:
        f = f[..., None]
    return values[i] * (1.0 - f) + values[i + 1] * f


def _forest_tau(wl, z_qso, tau_0, beta, num_lines):
    tau = torch.zeros_like(wl)
    for i in range(num_lines):
        one_plus_z = wl / float(C.LYMAN_WAVELENGTHS_A[i])
        scale = (tau_0 * float(C.LYMAN_OSC[i] / C.LYMAN_OSC[0])
                 * float(C.LYMAN_WAVELENGTHS_A[i] / C.LYMAN_WAVELENGTHS_A[0]))
        tau = tau + torch.where(one_plus_z - 1.0 <= z_qso, scale * one_plus_z**beta, 0.0)
    return tau


class Model(NamedTuple):
    padded: torch.Tensor  # (N + 6,)
    y: torch.Tensor
    v: torch.Tensor
    mask: torch.Tensor
    mu: torch.Tensor
    M: torch.Tensor
    omega2: torch.Tensor


def spectrum_model(learned, spec, cfg: dict, device, prec: Precision) -> Model:
    """The GP on the spectrum's pixels, mean-flux suppressed."""
    dt = prec.dtype
    put = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=device).to(dt)
    padded = put(spec.padded_wavelengths)
    wl = padded[3:-3]
    z_qso = float(spec.z_qso)
    rest = wl / (1.0 + z_qso)
    grid = np.asarray(learned.rest_wavelengths, np.float64)
    x0, dx = float(grid[0]), float(grid[1] - grid[0])
    mu = _interp_uniform(x0, dx, put(learned.mu), rest)
    M = _interp_uniform(x0, dx, put(learned.M), rest)
    omega2 = torch.exp(2.0 * _interp_uniform(x0, dx, put(learned.log_omega), rest))
    n_forest = cfg["num_forest_lines"]
    tau_learned = _forest_tau(wl, z_qso, math.exp(float(learned.log_tau_0)),
                              math.exp(float(learned.log_beta)), n_forest)
    scaling = 1.0 - torch.exp(-tau_learned) + math.exp(float(learned.log_c_0))
    a = torch.exp(-_forest_tau(wl, z_qso, float(learned.prev_tau_0),
                               float(learned.prev_beta), n_forest))
    return Model(padded, put(spec.flux), put(spec.noise_variance),
                 torch.as_tensor(np.asarray(spec.mask), device=device),
                 mu * a, M * a[:, None], omega2 * scaling**2 * a**2)


def low_rank_ll(y, mu_a, M, d, mask, a, prec: Precision, pairs=None):
    """log N(y; mu_a, diag(a) M M^T diag(a) + diag(d)) over ``mask``, one row
    per profile: ``mu_a``, ``d``, ``a`` (S, N); M (N, k)."""
    k = M.shape[1]
    d_safe = torch.where(mask, d, 1.0)
    d_inv = torch.where(mask, 1.0 / d_safe, 0.0)
    delta = torch.where(mask, y - mu_a, 0.0)
    if pairs is None:
        pairs = (M[:, :, None] * M[:, None, :]).reshape(M.shape[0], k * k)
    B = torch.eye(k, dtype=y.dtype, device=y.device) + matmul(a * a * d_inv, pairs, prec).reshape(-1, k, k)
    u = matmul(a * delta * d_inv, M, prec)
    L, info = torch.linalg.cholesky_ex(B)
    t = torch.linalg.solve_triangular(L, u[..., None], upper=False)[..., 0]
    quad = torch.sum(delta * delta * d_inv, -1) - torch.sum(t * t, -1)
    logdet = (torch.sum(torch.where(mask, torch.log(d_safe), 0.0), -1)
              + 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1))
    n = mask.sum().to(y.dtype)
    return torch.where(info == 0, -0.5 * (quad + logdet + n * C.LOG_2PI), math.nan)


def null_evidence(model: Model, prec: Precision) -> torch.Tensor:
    one = torch.ones_like(model.y)[None]
    return low_rank_ll(model.y, model.mu[None], model.M, (model.omega2 + model.v)[None],
                       model.mask, one, prec)[0]


def unit_tau(padded: torch.Tensor, z: torch.Tensor, num_lines: int) -> torch.Tensor:
    """(S, N + 6) Lyman-series optical depth per unit column density."""
    inv = 1.0 / (math.sqrt(2.0) * C.THERMAL_SIGMA_CGS)
    cdt = torch.complex128 if padded.dtype == torch.float64 else torch.complex64
    tau = torch.zeros((z.shape[0], padded.shape[0]), dtype=padded.dtype, device=padded.device)
    for l in range(num_lines):
        lam_c = float(C.LYMAN_WAVELENGTHS_A[l]) * (1.0 + z)[:, None]
        x = (padded - lam_c) * (C.SPEED_OF_LIGHT_CGS / lam_c) * inv
        arg = torch.complex(x, torch.full_like(x, float(C.LYMAN_GAMMA_V[l]) * inv)).to(cdt)
        tau = tau + float(C.LYMAN_LEADING[l]) * inv / math.sqrt(math.pi) * wofz(arg).real
    return tau


def broaden(raw: torch.Tensor) -> torch.Tensor:
    """Valid 7-tap convolution with the instrument profile: (.., P) -> (.., P - 6)."""
    n = raw.shape[-1] - 6
    return sum(float(C.INSTRUMENT_PROFILE[j]) * raw[..., j:j + n] for j in range(7))


def profiles(model: Model, z: torch.Tensor, nhis, num_lines: int, chunk: int = 2500):
    """(S, N) absorption of one absorber per sample for each column-density
    family in ``nhis`` (the families share the redshifts ``z``)."""
    outs = [[] for _ in nhis]
    for s in range(0, z.shape[0], chunk):
        unit = unit_tau(model.padded, z[s:s + chunk], num_lines)
        for out, nhi in zip(outs, nhis):
            out.append(broaden(torch.exp(-nhi[s:s + chunk, None] * unit)))
    return [torch.cat(o) for o in outs]


def level_ll(model: Model, A, rows, prec: Precision, log_S: float, pairs, chunk=2500):
    """(S,) log likelihood of each sample's absorbers: ``A`` times the
    parent profile rows ``rows``, minus log S."""
    out = []
    for s in range(0, A.shape[0], chunk):
        a = A[s:s + chunk]
        for r in rows:
            a = a * r[s:s + chunk]
        a = torch.where(model.mask, a, 1.0)
        out.append(low_rank_ll(model.y, model.mu * a, model.M, model.omega2 * a * a + model.v,
                               model.mask, a, prec, pairs))
    return torch.cat(out) - log_S


def pair_valid(z_rows: list[torch.Tensor], min_sep32: torch.Tensor) -> torch.Tensor:
    """The 3,000 km/s cut on float32 redshift rows."""
    if len(z_rows) == 1:
        return torch.ones_like(z_rows[0], dtype=torch.bool)
    zs = torch.sort(torch.stack(z_rows), dim=0).values
    return torch.all(torch.diff(zs, dim=0) >= min_sep32, dim=0)


def replay_uniforms(gen_seed: int, position: int, draws: int, S: int, device) -> list:
    """The float32 uniforms of the chained draws of the ``position``-th
    spectrum of a batch whose generator was seeded with ``gen_seed``: the
    spectra before it took ``draws`` draws each."""
    g = torch.Generator(device=device).manual_seed(int(gen_seed))
    for _ in range(position * draws):
        torch.rand(S, generator=g, dtype=torch.float32, device=device)
    return [torch.rand(S, generator=g, dtype=torch.float32, device=device) for _ in range(draws)]


def draw_parents(prev_ll, prev_valid, alive: bool, u32: torch.Tensor) -> torch.Tensor:
    """Multinomial parents by inverse CDF of exp(ll - max) over valid samples."""
    logits = torch.where(prev_valid, prev_ll, -math.inf)
    if not alive:
        logits = torch.zeros_like(logits)
    probs = torch.exp(logits - torch.max(logits))
    cdf = torch.cumsum(probs, 0)
    u = u32.to(cdf.dtype) * cdf[-1]
    return torch.clamp(torch.searchsorted(cdf, u, right=True), max=cdf.shape[0] - 1)


class Levels(NamedTuple):
    log_evidences: np.ndarray  # (max_k,)
    sample_lls: np.ndarray  # (S, max_k), NaN where invalid
    base_inds: np.ndarray  # (max_k - 1, S)
    own_draws: np.ndarray  # (max_k - 1, S): the reference's draws
    map_z: np.ndarray  # (max_k, max_k), NaN padded
    map_log_nhi: np.ndarray


def qmc_levels(model: Model, A, z32, log_nhi, max_k: int, cfg: dict, prec: Precision,
               base_inds=None, uniforms=None) -> Levels:
    """Every level's per-sample likelihoods, evidence and MAP.  Level k0
    chains the parents ``base_inds[k0 - 1]`` (the program's), or, without
    them, the reference's own draws from ``uniforms``."""
    S = A.shape[0]
    log_S = math.log(S)
    k = model.M.shape[1]
    pairs = (model.M[:, :, None] * model.M[:, None, :]).reshape(model.M.shape[0], k * k)
    min_sep32 = torch.tensor(cfg["min_z_separation_kms"] * 1000.0 / C.SPEED_OF_LIGHT_SI,
                             dtype=torch.float32, device=A.device)
    rows, z_rows, nhi_rows = [], [z32], [log_nhi]
    evid, slls, bases, owns, map_z, map_nhi = [], [], [], [], [], []
    alive, prev = True, None
    for k0 in range(max_k):
        if k0 > 0:
            own = None
            if uniforms is not None:
                own = draw_parents(*prev, alive, uniforms[k0 - 1])
                owns.append(own)
            base = own if base_inds is None else torch.as_tensor(
                np.asarray(base_inds[k0 - 1]), device=A.device).long()
            bases.append(base)
            rows.append(A[base])
            z_rows.append(z32[base])
            nhi_rows.append(log_nhi[base])
        ll = level_ll(model, A, rows, prec, log_S, pairs)
        valid = pair_valid(z_rows, min_sep32)
        masked = torch.where(valid, ll, -math.inf)
        top = torch.max(masked)
        mean = torch.sum(torch.where(valid, torch.exp(ll - top), 0.0)) / valid.sum()
        ev = float(top + torch.log(mean)) - k0 * log_S
        ev = ev if alive else math.nan
        alive = alive and math.isfinite(ev)
        evid.append(ev)
        slls.append(torch.where(valid & alive, ll, math.nan))
        prev = (ll - top, valid)
        i = int(torch.argmax(masked))
        pad = [math.nan] * (max_k - k0 - 1)
        map_z.append([float(r[i]) for r in z_rows] + pad)
        map_nhi.append([float(r[i]) for r in nhi_rows] + pad)
    host = lambda ts: (torch.stack(ts).cpu().numpy() if ts
                       else np.zeros((0, S), np.int64))
    return Levels(np.array(evid), torch.stack(slls, 1).cpu().numpy(), host(bases), host(owns),
                  np.array(map_z), np.array(map_nhi))


def log_priors(z_qso: float, prior_z, prior_dla, z_lls: float, z_dla: float, max_k: int,
               cfg: dict) -> np.ndarray:
    """log priors of [null, subDLA, DLA(1..max_k)] from the prior catalog."""
    cut = z_qso + cfg["prior_z_qso_increase_kms"] * 1000.0 / C.SPEED_OF_LIGHT_SI
    sel = np.asarray(prior_z) < cut
    ratio = float(np.sum(np.asarray(prior_dla)[sel])) / float(np.sum(sel))
    at_least = ratio ** np.arange(1, max_k + 1, dtype=np.float64)
    p_dla = at_least.copy()
    p_dla[:-1] -= at_least[1:]
    p_sub = (z_lls / z_dla) * ratio
    rest = np.log(np.concatenate([[p_sub], p_dla]))
    return np.concatenate([[np.log(1.0 - np.exp(rest).sum())], rest])


def normalized_log_posteriors(log_ev: np.ndarray, log_prior: np.ndarray) -> np.ndarray:
    lp = np.asarray(log_ev, np.float64) + log_prior
    top = np.nanmax(lp)
    return lp - (top + np.log(np.nansum(np.exp(lp - top))))


class Reference(NamedTuple):
    null: float
    dla: Levels  # the DLA levels on the parents judged (the program's, if given)
    sub: Levels
    log_post: np.ndarray  # normalized, [null, sub, DLA(1..k)]
    z32: np.ndarray  # (S,) the float32 redshift samples


def reference_spectrum(learned, spec, dla, sub, z_lls, z_dla, prior, cfg, device,
                       prec: Precision = REFERENCE, base_inds=None, uniforms=None) -> Reference:
    """The whole model selection of one spectrum (see the module's doc).

    :param dla, sub: (offset, log_nhi, nhi) sample arrays of each family.
    :param prior: (z_qsos, dla_ind) of the prior catalog.
    :param base_inds: (max_k - 1, S) the program's parents, or None to draw
        the reference's own from ``uniforms``.
    :param uniforms: the replayed float32 uniforms of the chained draws.
    """
    dt = prec.dtype
    max_k = cfg["max_dlas"]
    model = spectrum_model(learned, spec, cfg, device, prec)
    null = float(null_evidence(model, prec))
    lo = torch.tensor(float(spec.min_z_dla), dtype=torch.float32, device=device)
    hi = torch.tensor(float(spec.max_z_dla), dtype=torch.float32, device=device)
    f32 = lambda x: torch.as_tensor(np.asarray(x), device=device).to(torch.float32)
    z_dla32 = lo + (hi - lo) * f32(dla[0])
    z_sub32 = lo + (hi - lo) * f32(sub[0])
    shared = np.array_equal(np.asarray(dla[0]), np.asarray(sub[0]))
    put = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=device).to(dt)
    if shared:
        A_dla, A_sub = profiles(model, z_dla32.to(dt), (put(dla[2]), put(sub[2])),
                                cfg["num_lines"])
    else:
        (A_dla,) = profiles(model, z_dla32.to(dt), (put(dla[2]),), cfg["num_lines"])
        (A_sub,) = profiles(model, z_sub32.to(dt), (put(sub[2]),), cfg["num_lines"])
    lv_dla = qmc_levels(model, A_dla, z_dla32, f32(dla[1]), max_k, cfg, prec, base_inds, uniforms)
    lv_sub = qmc_levels(model, A_sub, z_sub32, f32(sub[1]), 1, cfg, prec)
    lp = log_priors(float(spec.z_qso), *prior, z_lls, z_dla, max_k, cfg)
    log_ev = np.concatenate([[null], lv_sub.log_evidences, lv_dla.log_evidences])
    return Reference(null, lv_dla, lv_sub, normalized_log_posteriors(log_ev, lp),
                     z_dla32.cpu().numpy())


class Outputs(NamedTuple):
    """What the program (or the control in its place) returned for one spectrum."""

    null: float
    dla_log_evidences: np.ndarray
    sub_log_evidence: float
    dla_sample_lls: np.ndarray  # (S, max_k)
    sub_sample_lls: np.ndarray  # (S,)
    base_inds: np.ndarray  # (max_k - 1, S)
    map_z: np.ndarray
    map_log_nhi: np.ndarray
    log_post: np.ndarray  # normalized


def control_outputs(ref: Reference) -> Outputs:
    """The control's run, in the shape of the program's outputs."""
    return Outputs(ref.null, ref.dla.log_evidences, float(ref.sub.log_evidences[0]),
                   ref.dla.sample_lls, ref.sub.sample_lls[:, 0], ref.dla.base_inds,
                   ref.dla.map_z, ref.dla.map_log_nhi, ref.log_post)


# samples more than this many nats below their level's best carry under
# exp(-50) of its weight: nothing the catalog reports moves with them, and
# their likelihoods hold float32's rounding of terms some 10^4 nats large
WEIGHT_NATS = 50.0


class Gaps:
    """Differences of one spectrum, kept both ways: the largest, and the
    sum of squares with its count (for a root mean square over spectra).
    Where one side is finite and the other not (an answer missing on one
    side), the largest is inf, and so is the root mean square: a missing
    answer fails every number it enters."""

    def __init__(self):
        self.top, self.sq, self.n = 0.0, 0.0, 0

    def add(self, prog, truth):
        a, b = np.asarray(prog, np.float64).ravel(), np.asarray(truth, np.float64).ravel()
        fa, fb = np.isfinite(a), np.isfinite(b)
        if np.any(fa != fb):
            self.top = math.inf
        d = np.abs(a[fa & fb] - b[fa & fb])
        if d.size:
            self.top = max(self.top, float(d.max()))
            self.sq += float(np.sum(d * d))
            self.n += d.size
        return self

    def merge(self, other: "Gaps") -> "Gaps":
        self.top, self.sq, self.n = max(self.top, other.top), self.sq + other.sq, self.n + other.n
        return self

    @property
    def rms(self) -> float:
        if math.isinf(self.top):
            return math.inf
        return math.sqrt(self.sq / self.n) if self.n else 0.0


def _weighty(ll: np.ndarray) -> np.ndarray:
    """The samples within ``WEIGHT_NATS`` of their level's best."""
    finite = np.isfinite(ll)
    return finite & (ll >= (np.nanmax(ll) if finite.any() else 0.0) - WEIGHT_NATS)


def compare(out: Outputs, ref: Reference) -> dict:
    """The gaps of one spectrum between the program's answers and the
    reference's (on the program's parents), by name: the null evidence; the
    level evidences (null, subDLA, DLA 1-4); the normalized model log
    posteriors; each level's MAP (how far the reference's likelihood of the
    program's MAP sample lies below its best, plus the two sides' gap at
    it; the MAP sample is the one whose float32 redshifts equal the
    program's MAP, none is an infinite gap); the per-sample likelihoods
    within ``WEIGHT_NATS`` of their level's best, with each level's MAP
    regret (the first term of the MAP's gap) among them."""
    ev_prog = np.concatenate([[out.null], [out.sub_log_evidence], out.dla_log_evidences])
    ev_ref = np.concatenate([[ref.null], ref.sub.log_evidences, ref.dla.log_evidences])
    gaps = {"null": Gaps().add(out.null, ref.null), "evidence": Gaps().add(ev_prog, ev_ref),
            "posterior": Gaps().add(out.log_post, ref.log_post), "map": Gaps(), "ll": Gaps()}
    S = ref.z32.shape[0]
    for k0 in range(out.map_z.shape[0]):
        ll = ref.dla.sample_lls[:, k0]
        near = _weighty(ll)
        gaps["ll"].add(out.dla_sample_lls[near, k0], ll[near])
        if np.any(np.isfinite(out.dla_sample_lls[:, k0]) != np.isfinite(ll)):
            gaps["ll"].top = math.inf
        if not np.isfinite(ll).any():
            continue
        rows = [np.arange(S)] + [out.base_inds[j] for j in range(k0)]
        hit = np.isfinite(ll)
        for r, idx in enumerate(rows):
            hit &= ref.z32[idx] == np.float32(out.map_z[k0, r])
        if not hit.any():
            gaps["map"].top = gaps["ll"].top = math.inf
            continue
        i = int(np.flatnonzero(hit)[np.argmax(ll[hit])])
        regret = float(np.nanmax(ll) - ll[i])
        gaps["map"].add(regret + abs(float(out.dla_sample_lls[i, k0]) - ll[i]), 0.0)
        gaps["ll"].add(regret, 0.0)
    sub = ref.sub.sample_lls[:, 0]
    near = _weighty(sub)
    gaps["ll"].add(out.sub_sample_lls[near], sub[near])
    if np.any(np.isfinite(out.sub_sample_lls) != np.isfinite(sub)):
        gaps["ll"].top = math.inf
    return gaps


def draw_mismatch(out: Outputs, ref: Reference) -> float:
    """Share of the program's parents that the reference, drawing from the
    same uniforms with its own weights (on the program's earlier parents),
    does not draw."""
    own = ref.dla.own_draws
    return float(np.mean(own != out.base_inds)) if own.size else 0.0
