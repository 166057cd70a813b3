"""Scrollable view of one batch (the port's counterpart of
``contrast_gan_3d_tpu/utils/batch_viewer.py``): each volume of the batch
side by side at a common axial slice, in one matplotlib window; the keyboard
scrolls through slices and samples. Works on any interactive backend
(pyplot's own choice: unlike ``utils/visualization``, nothing here selects
Agg); the figure's key handling fires on Agg too, through synthetic events,
which is how the tests drive it. matplotlib is imported at the first call.

Keys: ``up``/``down`` (or the mouse wheel): next/previous axial slice;
``pageup``/``pagedown``: +-10 slices; ``left``/``right``: previous/next
sample; ``home``/``end``: first/last slice; ``q``: close.
"""

from typing import List, Optional, Sequence

import numpy as np


class BatchViewer:
    """Scrollable axial-slice view of one batch.

    ``volumes``: arrays shaped ``(B, W, H, D)`` (a batch) or ``(W, H, D)``
    (a batch of one), e.g. ``[data, seg]``, all with the same B and D.
    Slices are shown transposed (H up), as
    :func:`utils.visualization.plot_axial_slices` shows them.
    """

    def __init__(
        self,
        volumes: Sequence[np.ndarray],
        titles: Optional[List[str]] = None,
        cmap: str = "gray",
        fig=None,
    ):
        import matplotlib.pyplot as plt

        vols = []
        for v in volumes:
            v = np.asarray(v)
            v = v[None] if v.ndim == 3 else v
            if v.ndim != 4:
                raise ValueError(f"expected (B,W,H,D) or (W,H,D), got {v.shape}")
            vols.append(v)
        if len({(v.shape[0], v.shape[-1]) for v in vols}) != 1:
            raise ValueError(
                "volumes disagree on batch size / depth: "
                + str([v.shape for v in vols])
            )
        self.volumes = vols
        self.titles = titles or [f"vol{i}" for i in range(len(vols))]
        self.n_samples = vols[0].shape[0]
        self.n_slices = vols[0].shape[-1]
        self.sample = 0
        self.slice = self.n_slices // 2
        self.cmap = cmap

        self.fig = fig or plt.figure(figsize=(4 * len(vols), 4.4))
        self.axes = self.fig.subplots(1, len(vols), squeeze=False)[0]
        self._images = []
        for ax, v, t in zip(self.axes, self.volumes, self.titles):
            sl = v[self.sample, :, :, self.slice].T
            im = ax.imshow(
                sl, cmap=self.cmap, origin="lower",
                vmin=float(v.min()), vmax=float(v.max()),
            )
            ax.set_title(t)
            ax.axis("off")
            self._images.append(im)
        self._cids = [
            self.fig.canvas.mpl_connect("key_press_event", self._on_key),
            self.fig.canvas.mpl_connect("scroll_event", self._on_scroll),
        ]
        self._update()

    def _update(self):
        for im, v in zip(self._images, self.volumes):
            im.set_data(v[self.sample, :, :, self.slice].T)
        self.fig.suptitle(
            f"sample {self.sample + 1}/{self.n_samples}   "
            f"slice {self.slice + 1}/{self.n_slices}   "
            "(arrows scroll, q closes)"
        )
        self.fig.canvas.draw_idle()

    def _step_slice(self, d: int):
        self.slice = int(np.clip(self.slice + d, 0, self.n_slices - 1))
        self._update()

    def _step_sample(self, d: int):
        self.sample = (self.sample + d) % self.n_samples
        self._update()

    def _on_key(self, event):
        key = event.key
        if key == "up":
            self._step_slice(1)
        elif key == "down":
            self._step_slice(-1)
        elif key == "pageup":
            self._step_slice(10)
        elif key == "pagedown":
            self._step_slice(-10)
        elif key == "home":
            self.slice = 0
            self._update()
        elif key == "end":
            self.slice = self.n_slices - 1
            self._update()
        elif key == "right":
            self._step_sample(1)
        elif key == "left":
            self._step_sample(-1)
        elif key == "q":
            self.close()

    def _on_scroll(self, event):
        self._step_slice(1 if event.button == "up" else -1)

    def close(self):
        import matplotlib.pyplot as plt

        for cid in self._cids:
            self.fig.canvas.mpl_disconnect(cid)
        plt.close(self.fig)


def view_batch(*volumes, titles=None, block: bool = True) -> BatchViewer:
    """Open a :class:`BatchViewer` window. Raises on a non-interactive
    backend (a headless host) rather than show nothing: write the PNG grids
    there (``view_batches`` without ``--interactive``)."""
    import matplotlib
    import matplotlib.pyplot as plt

    backend = matplotlib.get_backend().lower()
    if "agg" in backend and "webagg" not in backend:
        raise RuntimeError(
            f"matplotlib backend {backend!r} is non-interactive (headless "
            "host?) — interactive viewing needs a display; use the PNG "
            "grids instead (view_batches without --interactive)"
        )
    viewer = BatchViewer(list(volumes), titles=titles)
    plt.show(block=block)
    return viewer
