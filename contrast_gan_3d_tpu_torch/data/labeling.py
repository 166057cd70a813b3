"""Scan contrast labels, dataset sheets and cross-validation folds (the
port's counterpart of ``contrast_gan_3d_tpu/data/labeling.py``), without
pandas or sklearn, which the card's machine lacks.

Each scan is labelled by the mean HU of the contrast-filled lumen in a
Gaussian-mixture fit of its aortic-root (ostium) patches: 300 < mu < 500
-> OPT (0), mu <= 300 -> LOW (-1), mu >= 500 -> HIGH (+1); scans whose
fitted std is 500 or more are dropped. The mixtures are sklearn's
``GaussianMixture`` defaults, reproduced: 1-D full covariance, the
first M-step from the hard labels of a k-means whose k-means++ seeding
draws what sklearn's draws from ``RandomState(seed)``, then EM in float64
(``reg_covar`` 1e-6, ``tol`` 1e-3 on the mean log-likelihood, 100
iterations), batched over patches and component counts on the caller's
device; the count with the least BIC wins. The k-means runs on the host,
as sklearn's does. Folds reproduce ``StratifiedKFold(shuffle=True)`` and,
for one fold, ``train_test_split(stratify=...)`` draw for draw, so a sheet
gives the JAX tool's folds.

Sheets are lists of row dicts, read and written as csv with the standard
library (``read_sheet`` / ``write_sheet``). ``.xlsx`` needs openpyxl,
which the card's machine lacks: reading one raises, and ``ostia_dataframe``
writes ``.csv`` in its place, as the JAX package does without openpyxl.
A fold entry that names an HDF5 corpus file expands to its members under
the entry's label (``divide_scans_in_fold``)."""

import csv
import logging
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from contrast_gan_3d_tpu_torch.data import hdf5
from contrast_gan_3d_tpu_torch.utils import io_utils
from contrast_gan_3d_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

# sklearn.mixture.GaussianMixture's defaults
MAX_COMPONENTS = 5
REG_COVAR = 1e-6
EM_TOL = 1e-3
EM_MAX_ITER = 100
# sklearn.cluster.KMeans's defaults
KMEANS_TOL = 1e-4
KMEANS_MAX_ITER = 300
# patches per batched EM call (5 component counts each): bounds the
# (fits, samples, components) f64 working set at a few hundred MB
EM_CHUNK = 64


def label_from_HU(mu: float) -> int:
    """A scan's label from its aortic-root mean HU: 300 < mu < 500 -> 0
    (OPT), mu <= 300 -> -1 (LOW), mu >= 500 -> +1 (HIGH)."""
    if mu <= 300:
        return -1
    if mu >= 500:
        return 1
    return 0


# ---------------------------------------------------------------------------
# sheets
# ---------------------------------------------------------------------------

_INT_COLUMNS = ("label",)
_FLOAT_COLUMNS = ("mu", "std", "x", "y", "z")


def _no_xlsx(path: Path):
    if path.suffix.lower() == ".xlsx":
        raise ValueError(f"{path}: .xlsx sheets need openpyxl, which this port does not use; save the sheet as "
                         ".csv (the JAX package writes .csv itself where openpyxl is missing)")


def read_sheet(path) -> List[Dict]:
    """A csv sheet as a list of row dicts in file order: ``label`` as an
    int, ``mu`` / ``std`` / ``x`` / ``y`` / ``z`` as floats, every other
    column (``ID``, ``path``) as a str. ``.xlsx`` raises (openpyxl)."""
    path = Path(path)
    _no_xlsx(path)
    rows = []
    with open(path, newline="") as fd:
        for row in csv.DictReader(fd):
            for k in row:
                if k in _INT_COLUMNS:
                    row[k] = int(float(row[k]))
                elif k in _FLOAT_COLUMNS:
                    row[k] = float(row[k])
            rows.append(row)
    return rows


def write_sheet(rows: Sequence[Dict], path, columns: Optional[Sequence[str]] = None) -> Path:
    """Write row dicts as a csv sheet (columns: ``columns``, else the first
    row's keys in order); floats as the shortest string that reads back
    to the same value in their own precision (a float32 as float32), as
    pandas writes them. ``.xlsx`` raises (openpyxl)."""
    path = Path(path)
    _no_xlsx(path)
    columns = list(columns if columns is not None else (rows[0] if rows else ()))
    with open(path, "w", newline="") as fd:
        w = csv.writer(fd)
        w.writerow(columns)
        for row in rows:
            w.writerow([str(row[c]) if isinstance(row[c], (float, np.floating)) else row[c] for c in columns])
    return path


def ostia_dataframe(ostia_files: Iterable, save_path=None) -> List[Dict]:
    """World L/R ostia coordinates of each patient as rows ``ID, x, y, z``:
    two rows per MeVisLab marker file, the ID taken from the file's parent
    directory. ``save_path`` optionally writes the sheet as csv (an
    ``.xlsx`` name is written as ``.csv`` with a warning, as the JAX
    package does without openpyxl)."""
    rows = []
    for ostia_file in ostia_files:
        ostia_file = Path(ostia_file)
        points, _ = io_utils.load_mevis_coords(ostia_file)
        name = io_utils.stem(ostia_file.parent)
        for point in np.asarray(points, dtype=np.float32)[:2]:
            rows.append({"ID": name, **{k: float(v) for k, v in zip("xyz", point)}})
    logger.info("Total L/R ostia coordinates: %s", (len(rows), 3))
    if save_path is not None:
        save_path = Path(save_path)
        if save_path.suffix.lower() == ".xlsx":
            save_path = save_path.with_suffix(".csv")
            logger.warning("openpyxl unavailable, writing '%s'", save_path)
        # the coordinates are float32, and written as float32
        write_sheet([{**r, **{k: np.float32(r[k]) for k in "xyz"}} for r in rows], save_path,
                    columns=("ID", "x", "y", "z"))
        logger.info("Saved ostia world coordinates to '%s'", save_path)
    return rows


# ---------------------------------------------------------------------------
# the Gaussian mixtures
# ---------------------------------------------------------------------------


@dataclass
class GaussianMixture1D:
    """One fitted 1-D mixture: sklearn's ``weights_``, ``means_`` and
    ``covariances_`` (variances here), flattened to (k,) float64 arrays."""

    weights: np.ndarray
    means: np.ndarray
    covariances: np.ndarray
    bic: float
    n_iter: int
    converged: bool

    @property
    def n_components(self) -> int:
        return len(self.means)

    # sklearn's attribute names, which the figures read
    @property
    def weights_(self) -> np.ndarray:
        return self.weights

    @property
    def means_(self) -> np.ndarray:
        return self.means

    @property
    def covariances_(self) -> np.ndarray:
        return self.covariances


def _random_state(seed):
    return np.random.mtrand._rand if seed is None else np.random.RandomState(seed)


def _sq_distances(c: np.ndarray, x: np.ndarray, x_sq: np.ndarray) -> np.ndarray:
    """sklearn's ``_euclidean_distances(c, x, Y_norm_squared=x_sq,
    squared=True)`` in 1-D, in its order of operations."""
    d = -2 * (c[:, None] * x[None, :])
    d += (c * c)[:, None]
    d += x_sq[None, :]
    return np.maximum(d, 0, out=d)


def _kmeans_plusplus(x: np.ndarray, k: int, rs) -> np.ndarray:
    """sklearn's ``_kmeans_plusplus`` on centred 1-D data, unit weights:
    the same draws from ``rs`` and the same arithmetic."""
    n = len(x)
    w = np.ones(n, dtype=x.dtype)
    x_sq = x * x
    trials = 2 + int(np.log(k))
    centers = np.empty(k, dtype=x.dtype)
    centers[0] = x[rs.choice(n, p=w / w.sum())]
    closest = _sq_distances(centers[:1], x, x_sq)[0]
    pot = closest @ w
    for c in range(1, k):
        rand_vals = rs.uniform(size=trials) * pot
        ids = np.searchsorted(np.cumsum(w * closest), rand_vals)
        np.clip(ids, None, n - 1, out=ids)
        dist = _sq_distances(x[ids], x, x_sq)
        np.minimum(closest, dist, out=dist)
        pots = dist @ w.reshape(-1, 1)
        best = int(np.argmin(pots))
        pot, closest = pots[best], dist[best]
        centers[c] = x[ids[best]]
    return centers


def _lloyd_step(x, centers, update=True):
    """One ``lloyd_iter_chunked_dense``: labels by ||c||^2 - 2 x c, then
    (``update``) the new centres with sklearn's empty-cluster relocation
    and reciprocal averaging, and each centre's shift."""
    labels = np.argmin((centers * centers)[None, :] + (-2.0 * (x[:, None] * centers[None, :])), axis=1)
    if not update:
        return labels, centers, None
    k = len(centers)
    weight = np.bincount(labels, minlength=k).astype(x.dtype)
    sums = np.bincount(labels, weights=x, minlength=k)
    empty = np.where(weight == 0)[0]
    if len(empty):
        dist = (x - centers[labels]) ** 2
        far = np.argpartition(dist, -len(empty))[:-len(empty) - 1:-1]
        if dist.max() != 0:
            for new_id, idx in zip(empty, far):
                old_id = labels[idx]
                sums[old_id] -= x[idx]
                sums[new_id] = x[idx]
                weight[new_id] = 1.0
                weight[old_id] -= 1.0
    new = sums.copy()
    full = weight > 0
    new[full] *= 1.0 / weight[full]
    new[~full] = new[np.argmax(weight)]
    return labels, new, np.abs(new - centers)


def kmeans_labels(values: np.ndarray, k: int, rs) -> np.ndarray:
    """sklearn's ``KMeans(n_clusters=k, n_init=1, random_state=rs).fit(
    values).labels_`` for 1-D values: centred, k-means++ seeded, Lloyd
    to strict convergence or a centre shift within 1e-4 of the variance."""
    x = np.asarray(values, dtype=np.float64).ravel()
    tol = np.mean(np.var(x[:, None], axis=0)) * KMEANS_TOL
    x = x - x.mean(axis=0)
    centers = _kmeans_plusplus(x, k, rs)
    labels_old = np.full(len(x), -1)
    strict = False
    for _ in range(KMEANS_MAX_ITER):
        labels, centers, shift = _lloyd_step(x, centers)
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old = labels
    if not strict:
        labels, _, _ = _lloyd_step(x, centers, update=False)
    return labels


def _m_step(x, resp, valid, init: bool):
    """sklearn's ``_estimate_gaussian_parameters`` (full covariance, 1-D)
    for (F, N) values and (F, N, K) responsibilities; components outside
    ``valid`` (F, K) get weight 0."""
    n = x.shape[1]
    nk = resp.sum(1) + 10 * torch.finfo(torch.float64).eps
    means = torch.einsum("fnk,fn->fk", resp, x) / nk
    diff = x[:, :, None] - means[:, None, :]
    cov = torch.einsum("fnk,fnk->fk", resp * diff, diff) / nk + REG_COVAR
    nk = torch.where(valid, nk, torch.zeros_like(nk))
    weights = nk / n if init else nk / nk.sum(1, keepdim=True)
    return weights, means, cov


def _weighted_log_prob(x, weights, means, cov):
    """sklearn's ``_estimate_weighted_log_prob`` (full covariance, 1-D):
    (F, N, K)."""
    prec_chol = 1.0 / torch.sqrt(cov)
    y = x[:, :, None] * prec_chol[:, None, :] - (means * prec_chol)[:, None, :]
    return (-0.5 * (math.log(2 * math.pi) + y * y) + torch.log(prec_chol)[:, None, :]
            + torch.log(weights)[:, None, :])


def fit_gaussian_mixtures(values, components: Sequence[int], seed: Optional[int] = None,
                          device="cuda") -> List[GaussianMixture1D]:
    """One ``GaussianMixture(n_components=k, random_state=seed)`` fit per
    (values[i], components[i]), as sklearn fits it: k-means labels on the
    host (each fit draws from a fresh ``RandomState(seed)``, as each of
    sklearn's does), then EM batched over the fits in float64 on
    ``device``. ``values`` is (F, N)."""
    dev = resolve_device(device)
    vals = np.asarray(values, dtype=np.float64).reshape(len(components), -1)
    n = vals.shape[1]
    kmax = max(components)
    resp = np.zeros((len(components), n, kmax))
    for i, k in enumerate(components):
        resp[i, np.arange(n), kmeans_labels(vals[i], k, _random_state(seed))] = 1.0
    x =torch.as_tensor(vals, device=dev)
    resp = torch.as_tensor(resp, device=dev)
    valid = torch.arange(kmax, device=dev)[None, :] < torch.as_tensor(list(components), device=dev)[:, None]
    weights, means, cov = _m_step(x, resp, valid, init=True)
    lower = torch.full((len(components),), -math.inf, dtype=torch.float64, device=dev)
    active = torch.ones(len(components), dtype=torch.bool, device=dev)
    n_iter = torch.zeros(len(components), dtype=torch.int64, device=dev)
    for it in range(1, EM_MAX_ITER + 1):
        wlp = _weighted_log_prob(x, weights, means, cov)
        norm = torch.logsumexp(wlp, dim=2)
        new = _m_step(x, torch.exp(wlp - norm[:, :, None]), valid, init=False)
        keep = active[:, None]
        weights, means, cov = (torch.where(keep, b, a) for a, b in zip((weights, means, cov), new))
        bound = norm.mean(1)
        change = bound - lower
        lower = torch.where(active, bound, lower)
        n_iter = torch.where(active, torch.full_like(n_iter, it), n_iter)
        active = active & ~(change.abs() < EM_TOL)
        if not bool(active.any()):
            break
    score = torch.logsumexp(_weighted_log_prob(x, weights, means, cov), dim=2).mean(1)
    out = []
    for i, k in enumerate(components):
        bic = -2 * float(score[i]) * n + (3 * k - 1) * np.log(n)
        out.append(GaussianMixture1D(weights=weights[i, :k].cpu().numpy(), means=means[i, :k].cpu().numpy(),
                                     covariances=cov[i, :k].cpu().numpy(), bic=float(bic),
                                     n_iter=int(n_iter[i]), converged=not bool(active[i])))
    return out


def gmm_grid_search_batch(patches, max_components: int = MAX_COMPONENTS, seed: Optional[int] = None,
                          device="cuda") -> List[GaussianMixture1D]:
    """For each of the (P, ...) ``patches``: mixtures with 1..max_components
    components, the one with the lowest BIC (the first on a tie), as the
    JAX package's ``gmm_grid_search`` keeps it. All P x max_components fits
    run as batched EM, ``EM_CHUNK`` patches per call."""
    flat = np.asarray(patches, dtype=np.float64).reshape(len(patches), -1)
    ks = list(range(1, max_components + 1))
    best = []
    for s in range(0, len(flat), EM_CHUNK):
        chunk = flat[s:s + EM_CHUNK]
        fits = fit_gaussian_mixtures(np.repeat(chunk, len(ks), axis=0), ks * len(chunk), seed=seed, device=device)
        for p in range(len(chunk)):
            pick, pick_bic = None, np.inf
            for gmm in fits[p * len(ks):(p + 1) * len(ks)]:
                if gmm.bic < pick_bic:
                    pick, pick_bic = gmm, gmm.bic
            best.append(pick)
    return best


def gmm_grid_search(values, max_components: int = MAX_COMPONENTS, seed: Optional[int] = None,
                    device="cuda") -> GaussianMixture1D:
    """Mixtures with 1..max_components components on ``values``; the one
    with the lowest BIC (the JAX package's ``gmm_grid_search``)."""
    return gmm_grid_search_batch(np.asarray(values)[None], max_components, seed, device)[0]


def pick_gmm_component(gmm: GaussianMixture1D) -> Tuple[float, float]:
    """(mu, std) of the highest-mean component: the contrast-filled lumen."""
    idx = int(np.argmax(gmm.means))
    return float(gmm.means[idx]), float(np.sqrt(gmm.covariances[idx]))


def compute_ostia_HU_stats(ostia_patches, seed: Optional[int] = None, device="cuda") -> List[Tuple[float, float]]:
    """Per-ostium (mu, std) of the aortic-root HU: the picked component of
    each patch's best mixture (all patches in one batched fit)."""
    return [pick_gmm_component(g) for g in gmm_grid_search_batch(ostia_patches, seed=seed, device=device)]


def label_ccta_scans(ostia_rows: Sequence[Dict], id_column: str = "ID", std_threshold: float = 500.0) -> List[Dict]:
    """Label per-ostium (mu, std) rows as the JAX package's pandas code
    does: per scan the row with the least std (the first on a tie), scans
    in sorted ID order (``groupby``); then the first of rows with equal
    (mu, std) kept (``drop_duplicates``); rows with std >= ``std_threshold``
    dropped; ``label`` from mu. Returns new row dicts with ``label``."""
    best: Dict = {}
    for row in ostia_rows:
        key = row[id_column]
        if key not in best or row["std"] < best[key]["std"]:
            best[key] = row
    out, seen = [], set()
    for key in sorted(best):
        row = best[key]
        if (row["mu"], row["std"]) in seen:
            continue
        seen.add((row["mu"], row["std"]))
        if row["std"] < std_threshold:
            out.append({**row, "label": label_from_HU(row["mu"])})
    return out


# ---------------------------------------------------------------------------
# folds
# ---------------------------------------------------------------------------


def stratified_kfold_test_folds(y: np.ndarray, n_splits: int, rs) -> np.ndarray:
    """sklearn's ``StratifiedKFold(n_splits, shuffle=True)._make_test_folds``:
    classes coded by first appearance, the per-fold allocation round-robin
    over the sorted codes, one ``rs.shuffle`` per class in code order."""
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    counts = np.bincount(y_encoded)
    if np.all(n_splits > counts):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number of members in each class.")
    if n_splits > counts.min():
        logger.warning("The least populated class in y has only %d members, which is less than n_splits=%d.",
                       counts.min(), n_splits)
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::n_splits], minlength=n_classes) for i in range(n_splits)])
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rs.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    return test_folds


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rs) -> np.ndarray:
    """sklearn's ``_approximate_mode``: floored shares, then the largest
    remainders, ties broken by ``rs.choice``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need = int(n_draws - floored.sum())
    if need > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need)
            inds = rs.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need -= add_now
            if need == 0:
                break
    return floored.astype(int)


def stratified_shuffle_split(y: np.ndarray, test_size: float, rs) -> Tuple[np.ndarray, np.ndarray]:
    """sklearn's ``train_test_split(shuffle=True, stratify=y)`` indices:
    ``StratifiedShuffleSplit``'s first split with ceil(test_size * n) test
    samples."""
    n = len(y)
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    if class_counts.min() < 2:
        raise ValueError("The least populated classes in y have only 1 member, which is too few. The minimum number "
                         f"of groups for any class cannot be less than 2: {classes[class_counts < 2].tolist()}")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(f"train ({n_train}) and test ({n_test}) sizes must be at least the number of classes "
                         f"({len(classes)})")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    n_i = _approximate_mode(class_counts, n_train, rs)
    t_i = _approximate_mode(class_counts - n_i, n_test, rs)
    train, test = [], []
    for i in range(len(classes)):
        perm = class_indices[i].take(rs.permutation(class_counts[i]), mode="clip")
        train.extend(perm[:n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    return rs.permutation(train), rs.permutation(test)


def cross_val_splits(n_folds: int, *dataset_paths, test_size: float = 0.2,
                     seed: Optional[int] = None) -> Tuple[List[List[Tuple[str, int]]], List[List[Tuple[str, int]]]]:
    """Stratified k-fold (one stratified split when ``n_folds == 1``) over
    the (path, label) rows of csv sheets, in sheet order: the JAX
    package's folds from the same sheets and seed. Returns (train folds,
    validation folds), each fold a list of (path, label)."""
    X, Y = [], []
    for sheet in dataset_paths:
        for row in read_sheet(sheet):
            X.append(str(row["path"]))
            Y.append(int(row["label"]))
    X, Y = np.array(X), np.array(Y)
    rs = _random_state(seed)

    def fold(idx):
        return [(str(X[i]), int(Y[i])) for i in idx]

    if n_folds == 1:
        tr, va = stratified_shuffle_split(Y, test_size, rs)
        return [fold(tr)], [fold(va)]
    test_folds = stratified_kfold_test_folds(Y, n_folds, rs)
    idx = np.arange(len(Y))
    return ([fold(idx[test_folds != i]) for i in range(n_folds)],
            [fold(idx[test_folds == i]) for i in range(n_folds)])


def divide_scans_in_fold(fold) -> Dict[int, List]:
    """Group a fold's (path, label) pairs by label, in fold order. An entry
    naming a whole HDF5 file expands to its patients, all under the entry's
    label (``data/hdf5.corpus_members``; a standalone patient file is
    itself): per-label corpus files (``opt.h5`` / ``low.h5`` /
    ``high.h5``) are the layout a multi-host run shards."""
    out: Dict[int, List] = {}
    for path, label in fold:
        if hdf5.is_hdf5_path(path) and hdf5.split_member(path)[1] is None:
            out.setdefault(int(label), []).extend(hdf5.corpus_members(path))
        else:
            out.setdefault(int(label), []).append(path)
    return out


def minmax_norm(x, value_range: Optional[Tuple[float, float]] = None):
    """(x - low) / (high - low), the denominator at least 1e-5; the range
    defaults to x's own."""
    if value_range is None:
        value_range = (x.min(), x.max())
    low, high = value_range
    return (x - low) / max(high - low, 1e-5)
