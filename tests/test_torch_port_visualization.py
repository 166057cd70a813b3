"""The port's figures and batch viewer against the JAX package's, on the
CPU, with tiny inputs made from a seed.

Both modules render with the same matplotlib, the Agg backend and the same
rcParams in this process, so a figure the port draws as JAX draws it has
the same pixels: every function is held to ``fig.canvas.buffer_rgba()``
equality. The two seaborn figures (``plot_hu_distributions``, JAX's
``histplot(kde=True)``, and ``hu_distribution_shift_plot``, ``kdeplot``)
are drawn without seaborn in the port; their artists are held to JAX's:
the same counts of lines, bars and legend entries, each line's x and y
and each bar's left edge, width and height within 1e-9 relative, the same
colours. Their pixels are compared too, and are equal: the port draws the
same artists in the same order (each test asserts the largest pixel
difference, 0). ``plot_GMM_fit`` takes sklearn's fitted mixture on the
JAX side and a ``GaussianMixture1D`` with its parameters on the port's.
"""

import matplotlib
import numpy as np
import pytest

from contrast_gan_3d_tpu.utils import batch_viewer as jax_bv
from contrast_gan_3d_tpu.utils import visualization as jax_viz
from contrast_gan_3d_tpu_torch.data.labeling import GaussianMixture1D
from contrast_gan_3d_tpu_torch.utils import batch_viewer as bv
from contrast_gan_3d_tpu_torch.utils import visualization as viz

RTOL = 1e-9


def _pixels(fig):
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba()).copy()


def _assert_same_figure(got, want):
    try:
        a, b = _pixels(got), _pixels(want)
        assert a.shape == b.shape
        diff = np.abs(a.astype(int) - b.astype(int)).max()
        assert diff == 0, f"largest pixel difference {diff}"
    finally:
        viz.close(got)
        jax_viz.close(want)


@pytest.fixture
def vol(rng):
    return rng.normal(200, 300, (12, 10, 9)).astype(np.float32)


def test_first_call_selects_agg_as_the_jax_module():
    assert matplotlib.get_backend().lower() == "agg"
    assert viz._pyplot() is jax_viz.plt


@pytest.mark.parametrize("kw", [
    dict(max_slices=4, title="t"),
    dict(max_slices=64),
    dict(cmap="RdBu", max_slices=4),
    dict(cmap="RdBu", vmax=2.0),
    dict(vmin=-100.0),
    dict(max_slices=4, rng=7),
])
def test_plot_axial_slices(vol, rng, kw):
    mask = (rng.random(vol.shape) < 0.05).astype(np.uint8)
    seed = kw.pop("rng", None)
    rngs = [np.random.default_rng(seed) if seed is not None else None for _ in range(2)]
    _assert_same_figure(viz.plot_axial_slices(vol, mask=mask, rng=rngs[0], **kw),
                        jax_viz.plot_axial_slices(vol, mask=mask, rng=rngs[1], **kw))
    _assert_same_figure(viz.plot_axial_slices(vol[..., 0]), jax_viz.plot_axial_slices(vol[..., 0]))


def test_slice_indices_draw_as_jax():
    for depth, n in ((9, 4), (9, 64), (100, 16)):
        np.testing.assert_array_equal(viz._slice_indices(depth, n), jax_viz._slice_indices(depth, n))
        a, b = np.random.default_rng(3), np.random.default_rng(3)
        np.testing.assert_array_equal(viz._slice_indices(depth, n, a), jax_viz._slice_indices(depth, n, b))
        assert a.bit_generator.state == b.bit_generator.state


def test_medical_views_and_subsample(vol):
    for got, want in zip(viz.get_medical_views(vol, (2, 3, 1)), jax_viz.get_medical_views(vol, (2, 3, 1))):
        np.testing.assert_array_equal(got, want)
    big = np.arange(5000, dtype=np.float32)
    np.testing.assert_array_equal(viz.subsample_voxels(big, 500, np.random.default_rng(1)),
                                  jax_viz.subsample_voxels(big, 500, np.random.default_rng(1)))
    assert viz.subsample_voxels(big[:100], 200) is not None and len(viz.subsample_voxels(big[:100], 200)) == 100


def test_ostium_figures(rng):
    patch = rng.normal(300, 100, (19, 19, 19)).astype(np.float32)
    _assert_same_figure(viz.plot_ostium_patch(patch, title="o"), jax_viz.plot_ostium_patch(patch, title="o"))
    _assert_same_figure(viz.plot_ostium_patch(patch, coords=(3, 4, 5)),
                        jax_viz.plot_ostium_patch(patch, coords=(3, 4, 5)))
    with pytest.raises(ValueError, match="middle"):
        viz.plot_ostium_patch(patch, coords="center")
    # the shared renderer on caller axes, and the mid slice (returns axes)
    fig_a, axes_a = viz._pyplot().subplots(1, 3)
    fig_b, axes_b = jax_viz.plt.subplots(1, 3)
    np.testing.assert_array_equal(viz._render_ostium_views(axes_a, patch, "middle", -100, 500),
                                  jax_viz._render_ostium_views(axes_b, patch, "middle", -100, 500))
    _assert_same_figure(fig_a, fig_b)
    got, want = viz.plot_mid_slice(patch, title="m"), jax_viz.plot_mid_slice(patch, title="m")
    _assert_same_figure(got[0].get_figure(), want[0].get_figure())
    with pytest.raises(ValueError, match="data"):
        viz.plot_mid_slice(patch[..., None])


def test_three_views_centerlines_and_histograms(vol, rng):
    _assert_same_figure(viz.plot_three_views(vol), jax_viz.plot_three_views(vol))
    _assert_same_figure(viz.plot_three_views(vol, coords=(1, 2, 3), cmap="RdBu", vmin=-1, vmax=1),
                        jax_viz.plot_three_views(vol, coords=(1, 2, 3), cmap="RdBu", vmin=-1, vmax=1))
    pts = rng.normal(0, 10, (50, 4))
    _assert_same_figure(viz.plot_centerlines_3d(pts, downsample_factor=2, title="c", s=3, figsize=(4, 4)),
                        jax_viz.plot_centerlines_3d(pts, downsample_factor=2, title="c", s=3, figsize=(4, 4)))
    _assert_same_figure(viz.plot_histogram(vol, bins=20, title="h"), jax_viz.plot_histogram(vol, bins=20, title="h"))
    fig_a, ax_a = viz._pyplot().subplots()
    fig_b, ax_b = jax_viz.plt.subplots()
    assert viz.plot_histogram(vol, ax=ax_a) is fig_a and jax_viz.plot_histogram(vol, ax=ax_b) is fig_b
    _assert_same_figure(fig_a, fig_b)
    imgs = [rng.normal(size=(8, 8)) for _ in range(3)]
    _assert_same_figure(viz.plot_image_histogram(imgs[0], (imgs[1], "titled"), imgs[2], bins=10),
                        jax_viz.plot_image_histogram(imgs[0], (imgs[1], "titled"), imgs[2], bins=10))
    with pytest.raises(ValueError):
        viz.plot_image_histogram()


@pytest.fixture
def gmms(rng):
    """sklearn's fitted mixture (JAX's side) and the port's mixture with
    its parameters."""
    from sklearn.mixture import GaussianMixture

    vals = np.concatenate([rng.normal(100, 20, 200), rng.normal(420, 30, 200)])
    sk = GaussianMixture(2, random_state=0).fit(vals.reshape(-1, 1))
    port = GaussianMixture1D(sk.weights_.ravel(), sk.means_.ravel(), sk.covariances_.ravel(), 0.0, 1, True)
    return vals, sk, port


def test_gmm_figures(gmms, rng):
    vals, sk, port = gmms
    xs = np.linspace(vals.min(), vals.max(), 512).reshape(-1, 1)
    np.testing.assert_allclose(viz._score_samples(port, xs), sk.score_samples(xs), rtol=1e-12)
    _assert_same_figure(viz.plot_GMM_fit(vals, port), jax_viz.plot_GMM_fit(vals, sk))
    patch = rng.normal(300, 100, (19, 19, 19)).astype(np.float32)
    _assert_same_figure(viz.plot_gmm_fitted_ostium_patch(patch, port, title="g"),
                        jax_viz.plot_gmm_fitted_ostium_patch(patch, sk, title="g"))


def test_close_closes():
    plt = viz._pyplot()
    fig = plt.figure()
    viz.close(fig)
    assert not plt.fignum_exists(fig.number)


def _assert_same_artists(got, want):
    """Line and bar data within RTOL, counts, colours, labels and limits."""
    try:
        assert len(got.axes) == len(want.axes)
        for ga, wa in zip(got.axes, want.axes):
            assert len(ga.lines) == len(wa.lines) and len(ga.patches) == len(wa.patches)
            assert len(ga.containers) == len(wa.containers)
            for gl, wl in zip(ga.lines, wa.lines):
                np.testing.assert_allclose(gl.get_xdata(), wl.get_xdata(), rtol=RTOL)
                np.testing.assert_allclose(gl.get_ydata(), wl.get_ydata(), rtol=RTOL)
                assert matplotlib.colors.to_rgba(gl.get_color()) == matplotlib.colors.to_rgba(wl.get_color())
                assert gl.get_label().startswith("_") == wl.get_label().startswith("_")
                if not gl.get_label().startswith("_"):
                    assert gl.get_label() == wl.get_label()
            for gp, wp in zip(ga.patches, wa.patches):
                np.testing.assert_allclose([gp.get_x(), gp.get_width(), gp.get_height()],
                                           [wp.get_x(), wp.get_width(), wp.get_height()], rtol=RTOL)
                assert gp.get_facecolor() == wp.get_facecolor() and gp.get_edgecolor() == wp.get_edgecolor()
                assert gp.get_linewidth() == pytest.approx(wp.get_linewidth(), rel=RTOL)
            assert [c.get_label() for c in ga.containers] == [c.get_label() for c in wa.containers]
            legends = [a.get_legend() for a in (ga, wa)]
            assert (legends[0] is None) == (legends[1] is None)
            if legends[0] is not None:
                assert [t.get_text() for t in legends[0].get_texts()] == [t.get_text() for t in legends[1].get_texts()]
            assert (ga.get_xlabel(), ga.get_ylabel(), ga.get_title()) == (wa.get_xlabel(), wa.get_ylabel(),
                                                                          wa.get_title())
            np.testing.assert_allclose(ga.get_xlim() + ga.get_ylim(), wa.get_xlim() + wa.get_ylim(), rtol=RTOL)
    except BaseException:
        viz.close(got)
        jax_viz.close(want)
        raise
    _assert_same_figure(got, want)


def test_hu_distributions_draw_seaborns_histogram_and_kde(rng):
    sub, cor, opt = (rng.normal(mu, 40, 600).round() for mu in (250, 390, 410))
    _assert_same_artists(viz.plot_hu_distributions(sub, cor, opt, title="hu", max_voxels=400),
                         jax_viz.plot_hu_distributions(sub, cor, opt, title="hu", max_voxels=400))
    # a constant series: its bars, no curve; float32 input
    const = np.full(50, 300.0, np.float32)
    sub = sub[:100]
    fig_a, ax_a = viz._pyplot().subplots()
    fig_b, ax_b = jax_viz.plt.subplots()
    viz.plot_hu_distributions(sub.astype(np.float32), const, opt, ax=ax_a, rng=np.random.default_rng(5))
    jax_viz.plot_hu_distributions(sub.astype(np.float32), const, opt, ax=ax_b, rng=np.random.default_rng(5))
    assert len(ax_a.lines) == 2
    _assert_same_artists(fig_a, fig_b)


def test_hu_shift_plot_draws_seaborns_kde(rng):
    data = {
        "low": {"centerlines": rng.normal(250, 40, 500).round(), "ostia": np.array([260.0, 260.0])},
        "low-corrected": {"centerlines": rng.normal(400, 40, 500), "ostia": rng.normal(395, 30, 100)},
        "opt": {"centerlines": rng.integers(300, 500, 120_000).astype(np.int16), "ostia": np.array([410.0])},
        "empty": {"centerlines": np.array([np.nan, 5.0, np.inf, 7.0])},
    }
    _assert_same_artists(viz.hu_distribution_shift_plot(data), jax_viz.hu_distribution_shift_plot(data))
    _assert_same_artists(viz.hu_distribution_shift_plot(data, regions=("ostia",), hu_range=(0, 800)),
                         jax_viz.hu_distribution_shift_plot(data, regions=("ostia",), hu_range=(0, 800)))


# --- the batch viewer ------------------------------------------------------------


def _press(viewer, key):
    from matplotlib.backend_bases import KeyEvent

    KeyEvent("key_press_event", viewer.fig.canvas, key)._process()


def _scroll(viewer, button):
    from matplotlib.backend_bases import MouseEvent

    MouseEvent("scroll_event", viewer.fig.canvas, 10, 10, button=button)._process()


@pytest.fixture
def batch(rng):
    data = rng.normal(0, 1, (3, 8, 6, 10)).astype(np.float32)
    seg = (rng.random((3, 8, 6, 10)) < 0.1).astype(np.float32)
    return data, seg


def test_viewer_reaches_jax_states(batch):
    """The key and scroll events of ``tests/test_batch_viewer.py``, and
    more, reach the JAX viewer's states and pixels."""
    data, seg = batch
    ours, theirs = bv.BatchViewer([data, seg], titles=["data", "seg"]), jax_bv.BatchViewer([data, seg],
                                                                                            titles=["data", "seg"])
    events = ["up", "pagedown", "end", "up", "right", "left", "left", "home", "pageup", "down", "scroll-up",
              "scroll-down", "scroll-down", "x"]
    for ev in events:
        for v in (ours, theirs):
            _scroll(v, ev[7:]) if ev.startswith("scroll") else _press(v, ev)
        assert (ours.sample, ours.slice) == (theirs.sample, theirs.slice), ev
        np.testing.assert_array_equal(ours._images[0].get_array(), theirs._images[0].get_array())
        assert ours.fig._suptitle.get_text() == theirs.fig._suptitle.get_text()
    assert (ours.sample, ours.slice) == (2, 7)
    np.testing.assert_array_equal(_pixels(ours.fig), _pixels(theirs.fig))
    _press(ours, "q")
    theirs.close()
    plt = viz._pyplot()
    assert not plt.fignum_exists(ours.fig.number)


def test_viewer_refusals_as_jax(batch):
    data, seg = batch
    single = bv.BatchViewer([data[0]])
    assert (single.n_samples, single.n_slices) == (1, 10)
    single.close()
    for mod in (bv, jax_bv):
        with pytest.raises(ValueError, match="disagree"):
            mod.BatchViewer([data, data[:, :, :, :5]])
        with pytest.raises(ValueError, match="expected"):
            mod.BatchViewer([data[0, 0]])
        with pytest.raises(RuntimeError, match="non-interactive"):
            mod.view_batch(data, seg)
