"""Contrast labels, sheets and folds in the port (``data/labeling.py``, no
pandas or sklearn) against the JAX package's, which fit sklearn mixtures
and read pandas sheets, on the CPU.

Tolerances: the port's k-means labels equal sklearn's, and each mixture's
iteration count equals sklearn's; means and BIC within 1e-6 (both fit in
float64; their sums run in different orders). The grid search: the same
number of components, the picked (mu, std) within 0.1 HU, the same label.
``label_ccta_scans``, ``cross_val_splits``, ``ostia_dataframe`` and
``minmax_norm``: exact (row for row, fold for fold, in order)."""

import warnings

import numpy as np
import pandas as pd
import pytest
from sklearn.cluster import KMeans
from sklearn.mixture import GaussianMixture

from contrast_gan_3d_tpu.data import labeling as jax_lab
from contrast_gan_3d_tpu_torch.data import labeling as lab

HU_TOL = 0.1
FIT_TOL = 1e-6
PATCH = (19, 19, 19)
# (modes as (mean HU, std HU, share)): 1 to 4 modes, the lumen the
# brightest, as an aortic-root patch holds it
MODES = {
    "one": [(420.0, 30.0, 1.0)],
    "two": [(60.0, 40.0, 0.6), (380.0, 25.0, 0.4)],
    "two_low": [(40.0, 30.0, 0.5), (240.0, 35.0, 0.5)],
    "three": [(-60.0, 50.0, 0.3), (150.0, 40.0, 0.3), (560.0, 30.0, 0.4)],
    "four": [(-200.0, 60.0, 0.2), (50.0, 30.0, 0.3), (250.0, 40.0, 0.2), (460.0, 30.0, 0.3)],
}
SEEDS = (0, 42)


def _patch(modes, seed):
    rng = np.random.default_rng(seed)
    n = int(np.prod(PATCH))
    counts = [int(round(s * n)) for _, _, s in modes]
    counts[-1] = n - sum(counts[:-1])
    vals = np.concatenate([rng.normal(m, sd, c) for (m, sd, _), c in zip(modes, counts)])
    return rng.permutation(vals).reshape(PATCH).astype(np.float32)


@pytest.fixture(scope="module")
def fitted():
    """JAX's and the port's grid searches on every (modes, seed) patch,
    the port's in one batched call."""
    keys = [(name, seed) for name in MODES for seed in SEEDS]
    patches = np.stack([_patch(MODES[name], seed) for name, seed in keys])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_gmms = [jax_lab.gmm_grid_search(p.ravel(), seed=7) for p in patches]
    port_gmms = lab.gmm_grid_search_batch(patches, seed=7, device="cpu")
    return dict(zip(keys, zip(jax_gmms, port_gmms)))


@pytest.mark.parametrize("name", list(MODES))
@pytest.mark.parametrize("seed", SEEDS)
def test_gmm_grid_search_matches_jax(fitted, name, seed):
    jax_gmm, port_gmm = fitted[name, seed]
    assert port_gmm.n_components == jax_gmm.n_components
    mu_j, std_j = jax_lab.pick_gmm_component(jax_gmm)
    mu_p, std_p = lab.pick_gmm_component(port_gmm)
    assert abs(mu_p - mu_j) <= HU_TOL and abs(std_p - std_j) <= HU_TOL, (mu_p, mu_j, std_p, std_j)
    assert lab.label_from_HU(mu_p) == jax_lab.label_from_HU(mu_j)


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_kmeans_and_mixture_match_sklearn(k):
    """One fit at a time: the k-means labels equal sklearn's (same draws),
    and the mixture's iterations, means and BIC are sklearn's."""
    x = _patch(MODES["three"], 3).ravel().astype(np.float64)
    want = KMeans(n_clusters=k, n_init=1, random_state=np.random.RandomState(11)).fit(x[:, None]).labels_
    np.testing.assert_array_equal(lab.kmeans_labels(x, k, np.random.RandomState(11)), want)
    gmm = GaussianMixture(n_components=k, random_state=11).fit(x[:, None])
    got = lab.fit_gaussian_mixtures(x[None], [k], seed=11, device="cpu")[0]
    assert got.n_iter == gmm.n_iter_ and got.converged == gmm.converged_
    np.testing.assert_allclose(got.means, gmm.means_.ravel(), rtol=0, atol=FIT_TOL)
    np.testing.assert_allclose(got.covariances, gmm.covariances_.ravel(), rtol=FIT_TOL, atol=FIT_TOL)
    assert abs(got.bic - gmm.bic(x[:, None])) <= FIT_TOL * abs(gmm.bic(x[:, None]))


def test_compute_ostia_hu_stats_matches_jax():
    """Two ostia of one patient, as ``create_dataset`` fits them."""
    patches = np.stack([_patch(MODES["two"], 5), _patch(MODES["three"], 6)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_lab.compute_ostia_HU_stats(patches, seed=42)
    got = lab.compute_ostia_HU_stats(patches, seed=42, device="cpu")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=HU_TOL)
    # the one-patch form
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want_k = jax_lab.gmm_grid_search(patches[1].ravel(), seed=42).n_components
    assert lab.gmm_grid_search(patches[1].ravel(), seed=42, device="cpu").n_components == want_k


def _ostia_rows(seed):
    """Per-ostium rows with std ties within a scan, duplicate (mu, std)
    across scans, std >= 500 rows and unsorted IDs."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in rng.permutation(12):
        pid = f"case{i:02d}" if i % 3 else f"c{i}"
        for _ in range(2):
            mu = float(rng.choice([250.0, 400.0, 600.0, round(rng.uniform(0, 800), 3)]))
            std = float(rng.choice([10.0, 20.0, 500.0, 650.0, round(rng.uniform(0, 700), 3)]))
            rows.append({"ID": pid, "path": f"/data/{pid}.npy", "mu": mu, "std": std})
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_label_ccta_scans_matches_jax(seed):
    rows = _ostia_rows(seed)
    want = jax_lab.label_ccta_scans(pd.DataFrame(rows)).to_dict("records")
    got = lab.label_ccta_scans(rows)
    assert [(r["ID"], r["path"], r["mu"], r["std"], int(r["label"])) for r in want] == \
        [(r["ID"], r["path"], r["mu"], r["std"], r["label"]) for r in got]


BALANCES = {"balanced": (6, 6, 6), "skewed": (11, 4, 3), "two_class": (8, 5, 0)}


def _sheet(tmp_path, balance, seed):
    counts = BALANCES[balance]
    labels = np.concatenate([np.full(n, lbl) for n, lbl in zip(counts, (0, -1, 1))])
    labels = np.random.default_rng(seed).permutation(labels)
    rows = [{"ID": f"p{i}", "path": f"/data/p{i}.npy", "mu": 100.0 + i, "std": 20.0, "label": int(lbl)}
            for i, lbl in enumerate(labels)]
    path = tmp_path / "dataset.csv"
    pd.DataFrame(rows).to_csv(path, index=False)
    return path


@pytest.mark.parametrize("n_folds", [1, 3])
@pytest.mark.parametrize("seed", [0, 42, 1234])
@pytest.mark.parametrize("balance", list(BALANCES))
def test_cross_val_splits_matches_jax(tmp_path, n_folds, seed, balance):
    sheet = _sheet(tmp_path, balance, seed)
    want_train, want_val = jax_lab.cross_val_splits(n_folds, sheet, seed=seed)
    got_train, got_val = lab.cross_val_splits(n_folds, sheet, seed=seed)
    norm = lambda folds: [[(str(p), int(lbl)) for p, lbl in fold] for fold in folds]
    assert got_train == norm(want_train) and got_val == norm(want_val)
    assert all(type(p) is str and type(lbl) is int for fold in got_train + got_val for p, lbl in fold)


def test_cross_val_splits_over_two_sheets(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    sheets = [_sheet(a, "balanced", 1), _sheet(b, "skewed", 2)]
    want = jax_lab.cross_val_splits(3, *sheets, seed=9)
    got = lab.cross_val_splits(3, *sheets, seed=9)
    assert got == tuple([[(str(p), int(lbl)) for p, lbl in f] for f in part] for part in want)


def test_sheets_round_trip_and_refuse_xlsx(tmp_path):
    rows = [{"ID": "007", "path": "/d/007.npy", "mu": 401.25, "std": 1 / 3, "label": 0},
            {"ID": "p1", "path": "/d/p1.npy", "mu": -12.0, "std": 600.0, "label": -1}]
    path = lab.write_sheet(rows, tmp_path / "s.csv")
    assert lab.read_sheet(path) == rows
    # the labels as pandas reads them back
    assert pd.read_csv(path)["label"].tolist() == [0, -1]
    with pytest.raises(ValueError, match="openpyxl"):
        lab.read_sheet(tmp_path / "s.xlsx")
    with pytest.raises(ValueError, match="openpyxl"):
        lab.write_sheet(rows, tmp_path / "s.xlsx")


def test_ostia_dataframe_matches_jax(tmp_path):
    files = []
    for name, pts in (("pa", ((1.5, 2.0, -3.25), (4.0, 5.5, 6.0))), ("pb", ((0.1, 0.2, 0.3), (7.0, 8.0, 9.0)))):
        pdir = tmp_path / name
        pdir.mkdir()
        (pdir / "ostia.xml").write_text("<ListSize>2</ListSize>\n" + "".join(
            f"<pos>{x} {y} {z}</pos>\n" for x, y, z in pts))
        files.append(pdir / "ostia.xml")
    want = jax_lab.ostia_dataframe(files, save_path=tmp_path / "jax.xlsx")
    got = lab.ostia_dataframe(files, save_path=tmp_path / "port.xlsx")
    assert got == want.to_dict("records")
    # neither machine has openpyxl: both write csv in its place
    assert lab.read_sheet(tmp_path / "port.csv") == pd.read_csv(tmp_path / "jax.csv").to_dict("records")


@pytest.mark.parametrize("value_range", [None, (-1024.0, 1500.0), (3.0, 3.0)])
def test_minmax_norm_matches_jax(value_range):
    x = np.random.default_rng(0).normal(100, 300, (5, 7)).astype(np.float32)
    np.testing.assert_array_equal(lab.minmax_norm(x, value_range), jax_lab.minmax_norm(x, value_range))
