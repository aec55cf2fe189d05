"""Analysis plots: the TICA scatter, a heatmap, the apo scatter (port of
``esmdiff_tpu/eval/plots.py``; densities by scipy's KDE).

matplotlib is imported when a plot is drawn, and nowhere else in the
port: without it, drawing raises ImportError (``--plot`` of
``esmdiff-torch-analyze``), and every other path runs.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _pyplot():
    try:
        import matplotlib
    except ImportError:
        raise ImportError("drawing a plot (--plot) needs matplotlib, which "
                          "is not installed") from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=float)


def _kde_contour(ax, pts: np.ndarray, levels: int = 8, grid: int = 80):
    """KDE landscape contour of the reference ensemble."""
    from scipy.stats import gaussian_kde

    kde = gaussian_kde(pts.T)
    pad = 0.05 * (pts.max(0) - pts.min(0) + 1e-9)
    xs = np.linspace(pts[:, 0].min() - pad[0], pts[:, 0].max() + pad[0], grid)
    ys = np.linspace(pts[:, 1].min() - pad[1], pts[:, 1].max() + pad[1], grid)
    xx, yy = np.meshgrid(xs, ys)
    zz = kde(np.stack([xx.ravel(), yy.ravel()])).reshape(xx.shape)
    ax.contour(xx, yy, zz, levels=levels, colors="steelblue",
               linewidths=0.8, alpha=0.7)


def scatterplot_2d(d_proj: dict, save_to: str | Path, ref_key: str = "target",
                   n_max_point: int = 1000, pop_ref: bool = False,
                   plot_kde: bool = False):
    """2-D TICA scatter of each method against the reference; with
    ``plot_kde`` sample points are coloured by their own KDE density and
    the reference is drawn as a KDE contour."""
    plt = _pyplot()
    d = dict(d_proj)
    ref = d.get(ref_key)
    if pop_ref:
        d.pop(ref_key, None)
    names = [k for k in d if k != ref_key]
    n = max(len(names), 1)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4), squeeze=False)
    for ax, name in zip(axes[0], names or [ref_key]):
        if ref is not None:
            r = _host(ref[:n_max_point])
            if plot_kde and len(r) > 2:
                _kde_contour(ax, r)
            else:
                ax.scatter(r[:, 0], r[:, 1], s=4, c="lightgray",
                           label=ref_key)
        v = _host(d[name][:n_max_point])
        if plot_kde and len(v) > 2:
            from scipy.stats import gaussian_kde

            dens = gaussian_kde(v.T)(v.T)
            ax.scatter(v[:, 0], v[:, 1], s=4, c=dens, cmap="viridis",
                       alpha=0.8, label=name)
        else:
            ax.scatter(v[:, 0], v[:, 1], s=4, alpha=0.6, label=name)
        ax.set_xlabel("TIC 1")
        ax.set_ylabel("TIC 2")
        ax.legend(frameon=False, fontsize=8)
    fig.tight_layout()
    Path(save_to).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_to, dpi=150)
    plt.close(fig)


def heatmap(matrix, save_to: str | Path, xlabel: str = "", ylabel: str = "",
            cmap: str = "viridis"):
    """Matrix heatmap (contact maps, pairwise RMSD or TM)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(_host(matrix), cmap=cmap, aspect="auto")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    fig.tight_layout()
    Path(save_to).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_to, dpi=150)
    plt.close(fig)


def scatterplot_apo(x, y, save_to: str | Path, xlabel: str = "TM pair",
                    ylabel: str = "TM ensemble", regplot: bool = False):
    plt = _pyplot()
    x, y = _host(x), _host(y)
    fig, ax = plt.subplots(figsize=(4.5, 4.5))
    ax.scatter(x, y, s=14, alpha=0.7)
    if regplot and len(x) > 1:
        coef = np.polyfit(x, y, 1)
        xs = np.linspace(x.min(), x.max(), 50)
        ax.plot(xs, np.polyval(coef, xs), "r--", lw=1)
    else:
        lim = [min(x.min(), y.min()), max(x.max(), y.max())]
        ax.plot(lim, lim, "k--", lw=1)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    fig.tight_layout()
    Path(save_to).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_to, dpi=150)
    plt.close(fig)
