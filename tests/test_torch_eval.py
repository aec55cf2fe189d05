"""The port's evaluation stack (esmdiff_tpu_torch.eval: geo, align, metrics,
tmscore) against the JAX package's on the same seeded float64 inputs, on
the CPU.

Tolerances: geometry within 1e-9 A (JAX's jnp functions run with x64
enabled, so both sides compute in float64); histogram counts equal, edge
values included; JS values equal after JAX's 4-decimal rounding, or at
most 1e-4 apart where a value sits on a rounding boundary; validity
fractions exact; ``idp_metrics`` within 1e-9 relative; TM-scores from the
same C++ source bit-equal, and the native TM within 1e-6 of the plain
numpy version.  TICA's projections are compared up to the sign of each
column (eigensolvers choose their own signs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.eval import align as jalign
from esmdiff_tpu.eval import geo as jgeo
from esmdiff_tpu.eval import metrics as jmetrics
from esmdiff_tpu.eval import tmscore as jtm
from esmdiff_tpu_torch.core import protein as tprotein
from esmdiff_tpu_torch.eval import align, geo, metrics, tmscore

torch.set_num_threads(2)

GEO_ATOL = 1e-9
CPU = "cpu"
BPTI = "data/targets/bpti/bpti.pdb"


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float64))


def _x64(fn, *args):
    """A JAX function on float64 jnp inputs, result as numpy."""
    with jax.enable_x64(True):
        out = fn(*[jnp.asarray(a) for a in args])
        return jax.tree_util.tree_map(np.asarray, out)


def _ensemble(n, L=24, scale=1.0, seed=0):
    rng = np.random.RandomState(seed)
    base = np.cumsum(rng.randn(L, 3) * 2.0, axis=0)
    return base[None] + rng.randn(n, L, 3) * scale


@pytest.fixture(scope="module")
def bpti_ca():
    return tprotein.load_ca_ensemble(BPTI)[0].astype(np.float64)


def _assert_js(port: dict, ref: dict):
    assert list(port) == list(ref)
    for k in ref:
        assert abs(float(port[k]) - float(ref[k])) <= 1e-4 + 1e-12, (k, port,
                                                                     ref)
    # equal after rounding except on a rounding boundary
    assert sum(float(port[k]) != float(ref[k]) for k in ref) <= 1


# -- geo ---------------------------------------------------------------------

@pytest.mark.parametrize("name", ["kabsch", "align", "rmsd", "rmsd_raw",
                                  "align_batched", "rmsd_batched",
                                  "rmsd_pairwise_batched",
                                  "pairwise_rmsd_matrix",
                                  "radius_of_gyration", "pairwise_distances",
                                  "rmsf"])
def test_geo_matches_jax(name):
    X = _ensemble(6, L=20, scale=1.5, seed=1)
    Y = _ensemble(6, L=20, scale=1.5, seed=2)
    P, Q = X[0], Y[0]
    cases = {
        "kabsch": ((P, Q), jgeo.kabsch, geo.kabsch),
        "align": ((P, Q), jgeo.align, geo.align),
        "rmsd": ((P, Q), jgeo.rmsd, geo.rmsd),
        "rmsd_raw": ((P, Q), lambda a, b: jgeo.rmsd(a, b, align_first=False),
                     lambda a, b: geo.rmsd(a, b, align_first=False)),
        "align_batched": ((X, Q), jgeo.align_batched, geo.align_batched),
        "rmsd_batched": ((X, Q), jgeo.rmsd_batched, geo.rmsd_batched),
        "rmsd_pairwise_batched": ((X, Y), jgeo.rmsd_pairwise_batched,
                                  geo.rmsd_pairwise_batched),
        "pairwise_rmsd_matrix": ((X,), jgeo.pairwise_rmsd_matrix,
                                 geo.pairwise_rmsd_matrix),
        "radius_of_gyration": ((X,), jgeo.radius_of_gyration,
                               geo.radius_of_gyration),
        "pairwise_distances": ((X,), jgeo.pairwise_distances,
                               geo.pairwise_distances),
        "rmsf": ((X,), jgeo.rmsf, geo.rmsf),
    }
    args, jfn, tfn = cases[name]
    ref = _x64(jfn, *args)
    out = tfn(*[_t(a) for a in args])
    refs = ref if isinstance(ref, tuple) else (ref,)
    outs = out if isinstance(out, tuple) else (out,)
    assert len(refs) == len(outs)
    for r, o in zip(refs, outs):
        assert _np(o).dtype == np.float64
        np.testing.assert_allclose(_np(o), r, rtol=0, atol=GEO_ATOL)


def test_pairwise_rmsd_matrix_blocks(monkeypatch):
    """Row blocks of the pairwise matrix give the one-block matrix."""
    X = _t(_ensemble(7, L=12, seed=3))
    whole = geo.pairwise_rmsd_matrix(X)
    monkeypatch.setattr(geo, "_PAIR_ELEMENTS", 7 * 12 * 3 * 2)
    np.testing.assert_array_equal(_np(geo.pairwise_rmsd_matrix(X)),
                                  _np(whole))


def test_masked_kabsch_fits_each_pair_on_its_mask():
    """masked_kabsch on a batch = kabsch on each pair's masked rows."""
    rng = np.random.RandomState(4)
    P, Q = rng.randn(5, 16, 3), rng.randn(5, 16, 3)
    mask = rng.rand(5, 16) > 0.3
    P[~mask] = np.nan
    R, t = geo.masked_kabsch(_t(P), _t(Q), torch.from_numpy(mask))
    for b in range(5):
        jR, jt = _x64(jgeo.kabsch, P[b][mask[b]], Q[b][mask[b]])
        np.testing.assert_allclose(_np(R[b]), jR, atol=GEO_ATOL)
        np.testing.assert_allclose(_np(t[b]), jt, atol=GEO_ATOL)


# -- align -------------------------------------------------------------------

def _gapped_ensemble(M=7, L=30, seed=5):
    ens = _ensemble(M, L=L, scale=0.8, seed=seed)
    rng = np.random.RandomState(seed)
    for i in range(M):
        start = rng.randint(0, L - 4)
        ens[i, start:start + rng.randint(0, 5)] = np.nan
    ens[-1, 2:] = np.nan          # two residues only: compared unfitted
    return ens


def test_nan_pair_deviation_matches_jax():
    s1, s2 = _gapped_ensemble()[:2]
    out = align.nan_pair_deviation(_t(s1), _t(s2))
    ref = jalign.nan_pair_deviation(s1, s2)
    np.testing.assert_array_equal(np.isnan(_np(out)), np.isnan(ref))
    np.testing.assert_allclose(_np(out), ref, atol=GEO_ATOL)
    np.testing.assert_allclose(_np(align.kabsch_rotation(_t(s1[:5]),
                                                         _t(s2[:5]))),
                               jalign.kabsch_rotation(s1[:5], s2[:5]),
                               atol=GEO_ATOL)


@pytest.mark.parametrize("block", [None, 4])
def test_pair_deviations_match_jax_loop(block, monkeypatch):
    """Every (j, k) pair at once, gaps on either side and a pair with fewer
    than 3 mutual residues, against JAX's loop over pairs."""
    if block:
        monkeypatch.setattr(align, "_PAIR_ELEMENTS", block * 30 * 3)
    ens = _gapped_ensemble()
    out = _np(align.pair_deviations(_t(ens)))
    ref = np.stack([jalign.nan_pair_deviation(ens[j], ens[k])
                    for j in range(len(ens)) for k in range(j + 1, len(ens))])
    assert out.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_allclose(out, ref, atol=GEO_ATOL)


def test_identical_sets_with_different_gaps_measure_zero():
    ens = _ensemble(1, L=25, seed=6)[0]
    R = np.linalg.qr(np.random.RandomState(0).randn(3, 3))[0]
    R *= np.sign(np.linalg.det(R))
    moved = ens @ R.T + 5.0
    a, b = ens.copy(), moved.copy()
    a[3:6] = np.nan
    b[15:20] = np.nan
    dev = _np(align.pair_deviations(_t(np.stack([a, b]))))[0]
    assert np.isnan(dev[3:6]).all() and np.isnan(dev[15:20]).all()
    assert np.nanmax(dev) < 1e-9


def test_alignment_copies_match_jax():
    ref = "ACDEFGHIKLMNPQRSTVWY" * 3
    obs = ref[:10] + ref[15:50] + "W" + ref[52:]
    assert align.nw_align(ref, obs) == jalign.nw_align(ref, obs)
    coords = np.random.RandomState(7).randn(len(obs), 3)
    np.testing.assert_array_equal(align.map_to_reference(ref, obs, coords),
                                  jalign.map_to_reference(ref, obs, coords))


# -- metrics: features and validity -----------------------------------------

@pytest.mark.parametrize("name", ["adjacent_ca_distance", "distance_matrix_ca",
                                  "pairwise_distance_ca", "pwd_offset_3",
                                  "radius_of_gyration", "rg_masses", "rmsf"])
def test_features_match_jax(name, monkeypatch):
    X = _ensemble(9, L=18, scale=1.0, seed=8)
    masses = np.random.RandomState(9).rand(18) + 0.5
    fns = {
        "adjacent_ca_distance": (jmetrics.adjacent_ca_distance,
                                 metrics.adjacent_ca_distance),
        "distance_matrix_ca": (jmetrics.distance_matrix_ca,
                               metrics.distance_matrix_ca),
        "pairwise_distance_ca": (jmetrics.pairwise_distance_ca,
                                 metrics.pairwise_distance_ca),
        "pwd_offset_3": (lambda x: jmetrics.pairwise_distance_ca(x, k=3),
                         lambda x, device: metrics.pairwise_distance_ca(
                             x, k=3, device=device)),
        "radius_of_gyration": (jmetrics.radius_of_gyration,
                               metrics.radius_of_gyration),
        "rg_masses": (lambda x: jmetrics.radius_of_gyration(x, masses),
                      lambda x, device: metrics.radius_of_gyration(
                          x, masses, device=device)),
        "rmsf": (jmetrics.rmsf, metrics.rmsf),
    }
    jfn, tfn = fns[name]
    ref = jfn(X)
    np.testing.assert_allclose(_np(tfn(X, device=CPU)), ref, rtol=0,
                               atol=GEO_ATOL)
    # frame blocks give the same values
    monkeypatch.setattr(metrics, "_BLOCK_ELEMENTS", 18 * 18 * 3 * 2)
    np.testing.assert_allclose(_np(tfn(X, device=CPU)), ref, rtol=0,
                               atol=GEO_ATOL)


def test_position_entropy_and_correlations_match_jax():
    tokens = np.random.RandomState(10).randint(0, 7, (40, 12))
    tokens[:, 3] = 2
    np.testing.assert_allclose(
        _np(metrics.position_specific_entropy(tokens, device=CPU)),
        jmetrics.position_specific_entropy(tokens), rtol=0, atol=1e-12)
    x, y = np.random.RandomState(11).randn(2, 30)
    assert metrics.correlations(_t(x), y) == jmetrics.correlations(x, y)


def test_validity_matches_jax(bpti_ca):
    rng = np.random.RandomState(12)
    d = {"target": bpti_ca[None] + rng.randn(20, *bpti_ca.shape) * 0.3,
         "close": bpti_ca[None] + rng.randn(15, *bpti_ca.shape) * 0.3,
         "clashing": bpti_ca[None] + rng.randn(15, *bpti_ca.shape) * 2.5}
    for kw in ({}, {"k_exclusion": 2}, {"ca_vdw_radius": 2.5}):
        ref = jmetrics.validity(d, **kw)
        out = metrics.validity(d, device=CPU, **kw)
        assert out == ref and list(out) == list(ref)
        np.testing.assert_array_equal(
            _np(metrics.steric_clash(d["clashing"], device=CPU, **kw)),
            jmetrics.steric_clash(d["clashing"], **kw))
    assert metrics.bonding_validity(d, device=CPU) == \
        jmetrics.bonding_validity(d)
    val = metrics.validity(d, device=CPU)
    assert val["close"] > val["clashing"]


# -- metrics: histograms and the JS suite ------------------------------------

def test_binned_counts_equal_numpy_edges_included():
    """Values on every edge, at lo and hi, outside the range and NaN; a
    feature whose range is narrower than 1e-6; weights."""
    rng = np.random.RandomState(13)
    lo = np.array([0.0, -3.3, 7.0, 1.0])
    hi = np.array([1.0, 2.9, 7.0, 1.0 + 1e-9])
    edges = [np.linspace(a, max(b, a + 1e-6), 51) for a, b in zip(lo, hi)]
    cols = []
    for d in range(4):
        span = edges[d][-1] - edges[d][0]
        col = np.concatenate([edges[d], edges[d] + span * 1e-17,
                              np.nextafter(edges[d], -np.inf),
                              np.nextafter(edges[d], np.inf),
                              edges[d][0] + rng.rand(200) * span,
                              [edges[d][0] - 1, edges[d][-1] + 1, np.nan]])
        cols.append(col)
    values = np.stack(cols, axis=1)
    ref = jmetrics._binned(values, lo, hi, 50)
    out = _np(metrics._binned(_t(values), _t(lo), _t(hi), 50))
    np.testing.assert_array_equal(out, ref)
    w = rng.rand(len(values))
    np.testing.assert_allclose(
        _np(metrics._binned(_t(values), _t(lo), _t(hi), 50, weights=w)),
        jmetrics._binned(values, lo, hi, 50, weights=w), rtol=1e-12)
    one = values[:, 1]
    np.testing.assert_array_equal(
        _np(metrics._binned(_t(one), _t(lo[1]), _t(hi[1]), 50)),
        jmetrics._binned(one, lo[1], hi[1], 50))


def test_binned_blocks_and_js_divergence(monkeypatch):
    rng = np.random.RandomState(14)
    values = rng.randn(300, 6)
    lo, hi = values.min(0), values.max(0)
    whole = _np(metrics._binned(_t(values), _t(lo), _t(hi), 20))
    monkeypatch.setattr(metrics, "_BLOCK_ELEMENTS", 6 * 7)
    np.testing.assert_array_equal(
        _np(metrics._binned(_t(values), _t(lo), _t(hi), 20)), whole)
    p = jmetrics._binned(values, lo, hi, 20)
    q = jmetrics._binned(values[:150] * 1.3, lo, hi, 20)
    np.testing.assert_allclose(
        metrics.js_divergence_binned(_t(p), _t(q)).item(),
        jmetrics.js_divergence_binned(p, q), rtol=1e-13)


@pytest.mark.parametrize("kl", [False, True])
def test_js_pwd_and_rg_match_jax(bpti_ca, kl):
    rng = np.random.RandomState(15)
    d = {"target": bpti_ca[None] + rng.randn(60, *bpti_ca.shape) * 0.3,
         "close": bpti_ca[None] + rng.randn(40, *bpti_ca.shape) * 0.3,
         "far": bpti_ca[None] + rng.randn(40, *bpti_ca.shape) * 2.0}
    _assert_js(metrics.js_pwd(d, kl=kl, device=CPU), jmetrics.js_pwd(d, kl=kl))
    out, rg = metrics.js_rg(d, kl=kl, return_rg=True, device=CPU)
    ref, jrg = jmetrics.js_rg(d, kl=kl, return_rg=True)
    _assert_js(out, ref)
    for k in d:
        np.testing.assert_allclose(_np(rg[k]), jrg[k], atol=GEO_ATOL)
    if not kl:
        assert out["close"] < out["far"]


def test_tica_and_js_tica_match_jax_up_to_sign():
    """A trajectory with a slow mode: TICA's components, projections and
    per-dimension JS against JAX's."""
    rng = np.random.RandomState(16)
    T, L = 400, 10
    slow = np.cumsum(rng.randn(T)) * 0.05
    base = _ensemble(1, L=L, seed=17)[0]
    traj = base[None] + rng.randn(T, L, 3) * 0.2
    traj[:, :5, 0] += slow[:, None]
    d = {"target": traj, "sample": traj[::7] + rng.randn(58, L, 3) * 0.1}
    out, dr = metrics.js_tica(d, lagtime=10, device=CPU)
    ref, jdr = jmetrics.js_tica(d, lagtime=10)
    _assert_js(out, ref)
    for k in d:
        a, b = _np(dr[k]), jdr[k]
        signs = np.sign((a * b).sum(0))
        np.testing.assert_allclose(a * signs, b, rtol=0, atol=1e-7)
    X = jmetrics.pairwise_distance_ca(traj)
    t = metrics.TICA(lagtime=10).fit(_t(X))
    j = jmetrics.TICA(lagtime=10).fit(X)
    np.testing.assert_allclose(_np(t.mean_), j.mean_, atol=GEO_ATOL)
    comp = _np(t.components_)
    np.testing.assert_allclose(comp * np.sign((comp * j.components_).sum(0)),
                               j.components_, rtol=1e-6, atol=1e-9)
    # a degenerate reference: the identity projection
    deg = metrics.TICA().fit(_t(X[:2]))
    np.testing.assert_array_equal(_np(deg.components_),
                                  jmetrics.TICA().fit(X[:2]).components_)


def test_idp_metrics_match_jax(bpti_ca):
    rng = np.random.RandomState(18)
    d = {"target": bpti_ca[None] + rng.randn(50, *bpti_ca.shape) * 1.5,
         "a": bpti_ca[None] + rng.randn(30, *bpti_ca.shape) * 1.0,
         "b": bpti_ca[None] * 1.1 + rng.randn(30, *bpti_ca.shape) * 2.0}
    for pwd_offset in (3, 1):
        out = metrics.idp_metrics(d, pwd_offset=pwd_offset, device=CPU)
        ref = jmetrics.idp_metrics(d, pwd_offset=pwd_offset)
        for o, r in zip(out, ref):
            assert list(o) == list(r)
            for k in r:
                np.testing.assert_allclose(o[k], r[k], rtol=1e-9,
                                           atol=1e-15)


def test_metrics_refuse_cuda_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        metrics.js_pwd({"target": _ensemble(4)})


# -- tmscore -----------------------------------------------------------------

@pytest.fixture(scope="module")
def tm_inputs(bpti_ca):
    rng = np.random.RandomState(19)
    R = np.linalg.qr(rng.randn(3, 3))[0]
    ens = np.stack([bpti_ca @ R.T + rng.randn(*bpti_ca.shape) * s + 3.0
                    for s in (0.0, 0.5, 1.0, 2.0, 4.0, 8.0)])
    return ens, bpti_ca


def test_native_tm_matches_plain_version(tm_inputs):
    ens, target = tm_inputs
    tms, rmsds = tmscore.tm_score_many(ens, target)
    for i in range(len(ens)):
        tm, rmsd = tmscore._tm_score_np(ens[i], target)
        assert abs(tms[i] - tm) <= 1e-6 and abs(rmsds[i] - rmsd) <= 1e-6
        assert tmscore.tm_score(ens[i], target) == (tms[i], rmsds[i])
    assert tms[0] > 0.999 and (np.diff(tms) < 0).all()


def _far_blobs(bpti_ca):
    """Compact random blobs against BPTI, as far-from-native samples are."""
    rng = np.random.RandomState(21)
    return rng.randn(12, *bpti_ca.shape) * 8.0 + bpti_ca.mean(0)


def test_native_tm_matches_plain_version_far_from_native(bpti_ca):
    """On far-from-native pairs the shared library's quaternion iteration
    stops short of the optimal rotation; the port's copy of the library
    finishes those fits by Jacobi sweeps, and its plain version does the
    same: the two agree at 1e-6, and the RMSD is the optimal fit's
    (geo.rmsd, an SVD) at 1e-9, where the shared library's lies above it."""
    blobs = _far_blobs(bpti_ca)
    tms, rmsds = tmscore.tm_score_many(blobs, bpti_ca)
    plain = np.array([tmscore._tm_score_np(b, bpti_ca) for b in blobs])
    np.testing.assert_allclose(plain[:, 0], tms, rtol=0, atol=1e-6)
    np.testing.assert_allclose(plain[:, 1], rmsds, rtol=0, atol=1e-6)
    optimum = _np(geo.rmsd_batched(_t(blobs), _t(bpti_ca)))
    np.testing.assert_allclose(rmsds, optimum, rtol=0, atol=1e-9)
    _, shared_rmsds = jtm.tm_score_many(blobs, bpti_ca)
    assert (shared_rmsds - optimum > 1e-6).any()


def test_native_tm_equals_svd_fit_far_from_native(bpti_ca, monkeypatch):
    """The repaired library's TM-scores and RMSDs equal the JAX package's
    SVD version (``_tm_score_np``) at 1e-6 on the far-from-native pairs
    where the shared library parts from it; so do the ensemble measures."""
    blobs = _far_blobs(bpti_ca)
    tms, rmsds = tmscore.tm_score_many(blobs, bpti_ca)
    svd = np.array([jtm._tm_score_np(b, bpti_ca) for b in blobs])
    np.testing.assert_allclose(tms, svd[:, 0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(rmsds, svd[:, 1], rtol=0, atol=1e-6)
    shared, _ = jtm.tm_score_many(blobs, bpti_ca)
    assert np.abs(shared - svd[:, 0]).max() > 1e-6   # the fault repaired
    got = [*tmscore.tm_ensemble(blobs, bpti_ca), tmscore.tm_diversity(blobs)]
    monkeypatch.setattr(jtm, "_load_library", lambda: None)
    want = [*jtm.tm_ensemble(blobs, bpti_ca), jtm.tm_diversity(blobs)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_native_tm_bit_equal_to_jax(tm_inputs):
    """Near native, where the shared library's iteration converges, the
    port's copy gives its scores bit for bit.  The diversity's pairs of
    noisy members include far ones, where the repaired fit parts from the
    shared library's (by rounding here): held to 1e-12, and the draw of
    pairs exactly (``max_pairs``, ``seed``)."""
    ens, target = tm_inputs
    assert jtm._load_library() is not None   # JAX's own native build
    tms, rmsds = tmscore.tm_score_many(_t(ens), target)
    jtms, jrmsds = jtm.tm_score_many(ens, target)
    np.testing.assert_array_equal(tms, jtms)
    np.testing.assert_array_equal(rmsds, jrmsds)
    assert tmscore.tm_ensemble(ens, target) == jtm.tm_ensemble(ens, target)
    big = np.concatenate([ens] * 8)      # 48 models: 1128 pairs, 1000 drawn
    for kw in ({}, {"max_pairs": 10, "seed": 3}):
        assert tmscore.tm_diversity(big, **kw) == pytest.approx(
            jtm.tm_diversity(big, **kw), rel=0, abs=1e-12)
    assert tmscore.tm_diversity(ens[:1]) == 0.0
    with pytest.raises(ValueError, match="one shape"):
        tmscore.tm_score(ens[0], target[:-1])
    with pytest.raises(ValueError, match="one shape"):
        tmscore.tm_score_many(ens[..., :2], target[..., :2])
