"""Figures (the port's counterpart of ``contrast_gan_3d_tpu/utils/
visualization.py``): axial-slice grids with a HU colorbar and centerline
overlays, the three medical views of LPS volumes, ostium-patch and GMM-fit
diagnostics, intensity histograms and the HU-distribution-shift KDE
figure. Every function returns its figure (``plot_mid_slice``: its axes),
so callers (the threaded loggers, notebooks) render and close it.

Host numpy and matplotlib only, imported at the first call: the card's
machine has no matplotlib, and importing this module never needs it. The
first call selects the Agg backend unless pyplot is already imported or
``MPLBACKEND`` is set, as importing the JAX module does.

Without seaborn (it needs pandas): ``plot_hu_distributions`` and
``hu_distribution_shift_plot`` draw what seaborn 0.13's ``histplot(stat=
"density", kde=True)`` and ``kdeplot`` draw there, with numpy and
``scipy.stats.gaussian_kde``: its histogram bins (``np.histogram_bin_edges``
"auto"), its KDE (Scott's bandwidth, ``bw_adjust`` 1, a 200-point grid
``cut`` bandwidths past the data, 0 for the histogram's curve), its colours
from the axes' cycle, and no curve for a series of fewer than 2 values or
zero variance (``warn_singular=False``). Non-finite values are dropped.
"""

import math
import os
import sys
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from contrast_gan_3d_tpu_torch.constants import VMAX, VMIN


def _pyplot():
    """``matplotlib.pyplot``, imported here at the first call (Agg unless
    pyplot is already imported or ``MPLBACKEND`` chooses). Raises the
    ``ImportError`` naming matplotlib where it is not installed."""
    import matplotlib

    if "matplotlib.pyplot" not in sys.modules and not os.environ.get("MPLBACKEND"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def close(fig):
    _pyplot().close(fig)


def _slice_indices(depth: int, max_slices: int, rng=None) -> np.ndarray:
    if depth <= max_slices:
        return np.arange(depth)
    if rng is not None:
        return np.sort(rng.choice(depth, size=max_slices, replace=False))
    return np.linspace(0, depth - 1, max_slices).astype(int)


def plot_axial_slices(
    volume: np.ndarray,
    mask: Optional[np.ndarray] = None,
    cmap: str = "gray",
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    max_slices: int = 64,
    title: Optional[str] = None,
    rng=None,
):
    """Grid of axial (z) slices of a (W, H, D) volume with one shared
    colorbar and an optional centerline-mask scatter. An unset limit
    defaults on its own: the display window for "gray", else +-max|volume|.
    ``rng`` draws the slices where there are more than ``max_slices``."""
    plt = _pyplot()
    volume = np.asarray(volume)
    if volume.ndim == 2:
        volume = volume[..., None]
    ids = _slice_indices(volume.shape[-1], max_slices, rng)
    n = len(ids)
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    if vmin is None or vmax is None:
        if cmap == "gray":
            d_vmin, d_vmax = VMIN, VMAX
        else:
            amax = float(np.abs(volume).max() or 1.0)
            d_vmin, d_vmax = -amax, amax
        vmin = d_vmin if vmin is None else vmin
        vmax = d_vmax if vmax is None else vmax

    fig, axes = plt.subplots(rows, cols, figsize=(2 * cols, 2 * rows), squeeze=False)
    im = None
    for ax, z in zip(axes.ravel(), ids):
        im = ax.imshow(volume[..., z].T, cmap=cmap, vmin=vmin, vmax=vmax, origin="lower")
        if mask is not None:
            ys, xs = np.nonzero(np.asarray(mask)[..., z].T)
            if len(xs):
                ax.scatter(xs, ys, s=2, c="red", alpha=0.8)
        ax.set_title(f"z={z}", fontsize=6)
    for ax in axes.ravel():
        ax.axis("off")
    if im is not None:
        fig.colorbar(im, ax=axes, shrink=0.8, label="HU")
    if title:
        fig.suptitle(title)
    return fig


def get_medical_views(scan: np.ndarray, xyz: np.ndarray):
    """Axial / sagittal / coronal 2-D views of an LPS (W, H, D) volume through
    voxel ``xyz``, sagittal and coronal flipped vertically for display."""
    scan = np.asarray(scan)
    x, y, z = np.asarray(xyz).astype(int)
    return [
        scan[..., z].T,
        np.flip(scan[x, ...].T, 0),
        np.flip(scan[:, y, :].T, 0),
    ]


def _render_ostium_views(axes, ostium_patch: np.ndarray, coords, vmin, vmax):
    """The ostium figures' three views on the first three ``axes``;
    ``coords`` is a voxel triple or "middle". Returns the voxel triple."""
    ostium_patch = np.asarray(ostium_patch)
    if isinstance(coords, str):
        if coords != "middle":
            raise ValueError(f"coords must be a voxel triple or 'middle', got {coords!r}")
        coords = np.asarray(ostium_patch.shape) // 2
    for ax, view in zip(axes, get_medical_views(ostium_patch, coords)):
        ax.imshow(view, cmap="gray", vmin=vmin, vmax=vmax)
        ax.axis("off")
    return coords


def plot_ostium_patch(
    ostium_patch: np.ndarray,
    coords="middle",
    vmin: float = VMIN,
    vmax: float = VMAX,
    title: Optional[str] = None,
):
    """Three medical views through an extracted ostium patch; ``coords`` is
    a voxel triple or "middle"."""
    fig, axes = _pyplot().subplots(1, 3, figsize=(7, 5))
    _render_ostium_views(axes, ostium_patch, coords, vmin, vmax)
    if title is not None:
        fig.suptitle(title)
    return fig


def plot_mid_slice(
    image: np.ndarray,
    axes=None,
    title: Optional[str] = None,
    vmin: float = VMIN,
    vmax: float = VMAX,
):
    """Axial / sagittal / coronal views through the volume's centre, with
    the shape and the centre in the title. Returns the axes."""
    if axes is None:
        _, axes = _pyplot().subplots(1, 3, figsize=(10, 5))
    image = np.asarray(image)
    if image.ndim != 3:
        raise ValueError(
            f"plot_mid_slice takes a (W, H, D) volume, got {image.shape} — "
            "for packed patients pass data[..., 0]"
        )
    middle = np.asarray(image.shape) // 2
    views = get_medical_views(image, middle)
    for ax, ax_title, view in zip(np.ravel(axes), ["Axial", "Sagittal", "Coronal"], views):
        ax.imshow(view, cmap="gray", vmin=vmin, vmax=vmax)
        ax.set_title(ax_title)
    full_title = f"{tuple(image.shape)}, middle: {middle}"
    if title is not None:
        full_title = f"{title} {full_title}"
    np.ravel(axes)[0].get_figure().suptitle(full_title)
    return axes


def subsample_voxels(values: np.ndarray, max_size: int = 100_000, rng=None) -> np.ndarray:
    """At most ``max_size`` of a 1-D voxel sample, drawn without replacement
    from ``rng`` (a fresh unseeded generator by default); smaller samples
    are returned whole."""
    values = np.asarray(values).ravel()
    if values.size <= max_size:
        return values
    return (rng or np.random.default_rng()).choice(values, size=max_size, replace=False)


def plot_three_views(
    volume: np.ndarray,
    coords: Optional[np.ndarray] = None,
    cmap: str = "gray",
    vmin: float = VMIN,
    vmax: float = VMAX,
):
    """Axial / sagittal / coronal views of an LPS (W, H, D) volume through
    ``coords`` (the centre by default)."""
    volume = np.asarray(volume)
    x, y, z = (
        np.asarray(coords).astype(int)
        if coords is not None
        else np.asarray(volume.shape) // 2
    )
    views = [
        (volume[..., z].T, f"axial z={z}"),
        (volume[x, ...].T, f"sagittal x={x}"),
        (volume[:, y, :].T, f"coronal y={y}"),
    ]
    fig, axes = _pyplot().subplots(1, 3, figsize=(12, 4))
    for ax, (img, name) in zip(axes, views):
        ax.imshow(img, cmap=cmap, vmin=vmin, vmax=vmax, origin="lower")
        ax.set_title(name)
        ax.axis("off")
    return fig


def plot_centerlines_3d(
    centerlines: np.ndarray,
    downsample_factor: int = 1,
    title: Optional[str] = None,
    figsize: Tuple[int, int] = (10, 10),
    **scatter_kwargs,
):
    """3D scatter of an (N, 3+) centerline point cloud (a trailing radius
    column is ignored)."""
    pts = np.asarray(centerlines)[::downsample_factor, :3]
    fig = _pyplot().figure(figsize=figsize)
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], **scatter_kwargs)
    if title is not None:
        ax.set_title(title)
    ax.set_xlabel("X")
    ax.set_ylabel("Y")
    ax.set_zlabel("Z")
    return fig


def plot_histogram(
    values: np.ndarray, bins: int = 100, title: Optional[str] = None, ax=None
):
    if ax is None:
        fig, ax = _pyplot().subplots(figsize=(6, 4))
    else:
        fig = ax.figure
    ax.hist(np.asarray(values).ravel(), bins=bins)
    ax.set_xlabel("HU")
    if title:
        ax.set_title(title)
    return fig


def plot_image_histogram(
    *images,
    bins: int = 80,
    figsize: Tuple[int, int] = (10, 5),
    **hist_kwargs,
):
    """Grid of per-image intensity histograms; each argument is an array or
    an ``(array, title)`` pair."""
    n = len(images)
    if n == 0:
        raise ValueError("plot_image_histogram needs at least one image")
    rows = int(round(np.sqrt(n))) or 1
    cols = int(np.ceil(n / rows))
    fig, axes = _pyplot().subplots(rows, cols, figsize=figsize, squeeze=False)
    for i, ax in enumerate(axes.ravel()):
        if i >= n:
            ax.set_visible(False)
            continue
        img = images[i]
        if isinstance(img, tuple) and len(img) == 2:
            img, title = img
            ax.set_title(title)
        ax.hist(np.asarray(img).ravel(), color="black", bins=bins, **hist_kwargs)
    return fig


def _gmm_components(gmm) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(weights, means, variances) of a mixture fitted on 1-D values, from
    sklearn's attribute names (``data/labeling.GaussianMixture1D`` has them
    too), for any covariance type: full (n,1,1), diag (n,1), spherical (n,)
    or tied (1,1)."""
    means = np.asarray(gmm.means_).ravel()
    cov = np.asarray(gmm.covariances_)
    if cov.size == 1:
        var = np.full(len(means), cov.ravel()[0])
    elif cov.size == len(means):
        var = cov.ravel()
    else:
        raise ValueError("expected a GMM fitted on 1-D (HU) values")
    return np.asarray(gmm.weights_).ravel(), means, var


def plot_gmm_fitted_ostium_patch(
    ostium_patch: np.ndarray,
    gmm,
    coords="middle",
    title: Optional[str] = None,
    hu_range: Tuple[float, float] = (-300, 900),
):
    """Three medical views of an ostium patch and its HU histogram with the
    fitted mixture: one curve per component and the dashed sum. ``gmm``: a
    mixture over 1-D HU values (``data/labeling.GaussianMixture1D``, or
    sklearn's ``GaussianMixture``)."""
    from scipy.stats import norm as _norm

    ostium_patch = np.asarray(ostium_patch)
    weights, means, var = _gmm_components(gmm)
    stds = np.sqrt(var)

    fig, axes = _pyplot().subplots(1, 4, figsize=(10, 5))
    _render_ostium_views(axes[:3], ostium_patch, coords, VMIN, VMAX)
    ax = axes[3]
    ax.hist(ostium_patch.ravel(), density=True, color="black", bins=80)
    x = np.arange(hu_range[0], hu_range[1], 10)
    y = _norm.pdf(x[None], means[:, None], stds[:, None]) * weights[:, None]
    # the property cycle defines C0..C9 only
    ax.plot(x, y.sum(0), lw=3, c="black", ls="dashed")
    for i, yy in enumerate(y):
        ax.plot(x, yy, lw=3, c=f"C{i % 10}")
    if title is not None:
        fig.suptitle(title)
    return fig


def _finite_f64(values) -> np.ndarray:
    values = np.asarray(values, dtype=np.float64).ravel()
    return values[np.isfinite(values)]


def _kde_curve(values: np.ndarray, cut: float, gridsize: int = 200):
    """seaborn 0.13's univariate KDE: (support, density), or None where it
    draws no curve (fewer than 2 values, zero variance, a singular fit)."""
    from scipy.stats import gaussian_kde

    if len(values) < 2 or math.isclose(float(np.nan_to_num(values.var(ddof=1))), 0):
        return None
    try:
        kde = gaussian_kde(values)
    except np.linalg.LinAlgError:
        return None
    kde.set_bandwidth(kde.factor * 1)  # bw_adjust 1
    bw = np.sqrt(kde.covariance.squeeze())
    support = np.linspace(values.min() - bw * cut, values.max() + bw * cut, gridsize)
    return support, kde(support)


def _scout_line_color(ax):
    """The next colour of the axes' line cycle, consumed as ``ax.plot``
    would consume it."""
    scout, = ax.plot([], [], scalex=False, scaley=False)
    color = scout.get_color()
    scout.remove()
    return color


def _density_axis_labels(ax):
    """seaborn's axis labels for a density along x: an empty x label and
    "Density" on y, where the axes have none yet."""
    if not ax.get_xlabel():
        ax.set_xlabel("", visible=any(t.get_visible() for t in ax.get_xticklabels()))
    if not ax.get_ylabel():
        ax.set_ylabel("Density", visible=any(t.get_visible() for t in ax.get_yticklabels()))


def _density_histogram(ax, values: np.ndarray, label: str, alpha: float):
    """What ``sns.histplot(values, label=label, ax=ax, stat="density",
    kde=True, edgecolor="none", alpha=alpha)`` draws: density bars on
    numpy's "auto" bins in the cycle's next patch colour, and the KDE
    (cut 0) scaled to the bars' area in that colour, opaque."""
    from matplotlib.colors import to_rgb, to_rgba

    scout, = ax.bar([np.nan], [np.nan], edgecolor="none", alpha=alpha)
    color = to_rgb(scout.get_facecolor())
    scout.remove()
    ax.containers.pop(-1)

    edges = np.histogram_bin_edges(values, "auto")
    heights, edges = np.histogram(values, bins=len(edges) - 1, range=(edges.min(), edges.max()), density=True)
    widths = np.diff(edges)
    centers = edges[:-1] + widths / 2
    lefts = centers - widths / 2
    widths = (lefts + widths) - lefts
    curve = _kde_curve(values, cut=0)

    bars = ax.bar(lefts, heights, widths, np.zeros_like(heights), align="edge", label=label, edgecolor="none",
                  facecolor=to_rgba(color, alpha), color="none")
    for bar in bars:
        bar.sticky_edges.x[:] = []
        bar.sticky_edges.y[:] = (0, np.inf)
    if curve is not None:
        support, density = curve
        line, = ax.plot(support, density * (heights * widths).sum(), color=to_rgba(color, 1))
        line.sticky_edges.y[:] = (0, np.inf)

    # seaborn's bar edge width: a tenth of the thinnest bar in points, at
    # most the patch default
    i = int(np.argmin(widths))
    ax.autoscale_view()
    pts = 72 / ax.figure.dpi * abs(ax.transData.transform([lefts[i] + widths[i]] * 2)
                                   - ax.transData.transform([lefts[i]] * 2))
    for bar in bars:
        bar.set_linewidth(min(0.1 * pts[0], bar.get_linewidth()))
    _density_axis_labels(ax)


def plot_hu_distributions(
    subopt: np.ndarray,
    corrected_subopt: np.ndarray,
    opt: np.ndarray,
    ax=None,
    title: Optional[str] = None,
    alpha: float = 0.6,
    max_voxels: int = 100_000,
    rng=None,
):
    """One axis of density histograms with their KDE curves: sub-optimal,
    corrected sub-optimal and optimal HU samples, each subsampled to
    ``max_voxels`` first (``rng``, seed 0 by default)."""
    if ax is None:
        fig, ax = _pyplot().subplots()
    else:
        fig = ax.figure
    rng = np.random.default_rng(0) if rng is None else rng
    series = [
        (subopt, "Suboptimal"),
        (corrected_subopt, "Corrected suboptimal"),
        (opt, "Optimal"),
    ]
    for vals, label in series:
        vals = subsample_voxels(np.asarray(vals), max_voxels, rng)
        _density_histogram(ax, _finite_f64(vals), label, alpha)
    ax.legend()
    if title is not None:
        ax.set_title(title)
    return fig


def _score_samples(gmm, xs: np.ndarray) -> np.ndarray:
    """sklearn's ``GaussianMixture.score_samples`` of 1-D values, in its
    order of operations, from the fitted weights, means and variances."""
    from scipy.special import logsumexp

    weights, means, var = _gmm_components(gmm)
    prec = 1.0 / np.sqrt(var)
    y = xs * prec[None, :] - (means * prec)[None, :]
    log_prob = -0.5 * (np.log(2 * np.pi) + np.square(y)) + np.log(prec)[None, :]
    return logsumexp(log_prob + np.log(weights)[None, :], axis=1)


def plot_GMM_fit(values: np.ndarray, gmm, bins: int = 80):
    """Histogram of ostium-patch HU values with the fitted mixture's
    density and a dashed line at each component's mean."""
    values = np.asarray(values, dtype=np.float64).ravel()
    fig, ax = _pyplot().subplots(figsize=(6, 4))
    ax.hist(values, bins=bins, density=True, alpha=0.6)
    xs = np.linspace(values.min(), values.max(), 512).reshape(-1, 1)
    dens = np.exp(_score_samples(gmm, xs))
    ax.plot(xs.ravel(), dens, "r-", lw=2)
    for mu in np.asarray(gmm.means_).ravel():
        ax.axvline(mu, color="k", ls="--", lw=1)
    ax.set_xlabel("HU")
    ax.set_ylabel("density")
    return fig


def hu_distribution_shift_plot(
    voxels_by_scan_type: Dict[str, Dict[str, np.ndarray]],
    regions: Sequence[str] = ("centerlines", "ostia", "myocardium"),
    hu_range: Tuple[float, float] = (-200, 1000),
):
    """KDE curves of the HU values per region, one per series: {series:
    {region: 1-D HU values}}, e.g. "low", "low-corrected", "opt". A series
    above 100,000 values is subsampled first (seed 0): myocardium masks
    reach 10^7 voxels. A series that draws no curve (zero variance, as a
    two-voxel ostium mask) still takes its colour."""
    from matplotlib.colors import to_rgba

    rng = np.random.default_rng(0)
    max_voxels = 100_000
    fig, axes = _pyplot().subplots(1, len(regions), figsize=(5 * len(regions), 4), squeeze=False)
    for ax, region in zip(axes.ravel(), regions):
        for series, by_region in voxels_by_scan_type.items():
            vals = np.asarray(by_region.get(region, []))
            if vals.size:
                vals = subsample_voxels(vals[np.isfinite(vals)], max_voxels, rng)
                color = to_rgba(_scout_line_color(ax), 1)
                curve = _kde_curve(_finite_f64(vals), cut=3)
                if curve is not None:
                    line, = ax.plot(*curve, label=series, color=color)
                    line.sticky_edges.y[:] = (0, np.inf)
                _density_axis_labels(ax)
        ax.set_title(region)
        ax.set_xlim(*hu_range)
        ax.set_xlabel("HU")
        if ax.get_legend_handles_labels()[1]:  # degenerate series draw nothing
            ax.legend()
    return fig
