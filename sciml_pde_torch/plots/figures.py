"""Figure generators (rollout curves, motivation bars, field renders); port
of ``sciml_pde_tpu/plots/figures.py``.

  - ``rollout_figure``: nRMSE vs rollout step, baseline vs aux
    (Plot Generator/rollout.py);
  - ``motivation_figure``: foundation models on full vs decomposed NS
    (motivation.py);
  - ``field_panels``: side-by-side prediction/target field renders for 2D DR
    / 2D NS (2D_DR_plot.py, 2D_NS_plot.py) and mid-slice renders for 3D
    (3D_NS_Vis.py);
  - ``data_efficiency_figure``: nRMSE vs simulation cost across basic_dsN
    presets with seed error bars (random_seed_ns.py);
  - ``field_animation``: a trajectory as an animated gif.

Every function takes numpy arrays (``.cpu().numpy()`` at the call site).
They draw with PIL, which the card's machine has (matplotlib it has not):
the JAX package's panels, curves, colour scales, titles and legends, with
the axes as a frame and no tick labels.  Fields are coloured by viridis
(interpolated between eight of its colours).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from sciml_pde_torch.plots.paper_tables import (
    MOTIVATION_NRMSE,
    ROLLOUT_NRMSE,
    SIM_COST_SECONDS,
)

# viridis at 0, 1/7, ..., 1
_VIRIDIS = np.array([
    (68, 1, 84), (70, 50, 127), (54, 92, 141), (39, 127, 142),
    (31, 161, 135), (74, 194, 109), (159, 218, 58), (253, 231, 37),
], dtype=np.float64)
_LINE_COLOURS = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40))
_SIZE = (500, 400)
_MARGIN = 40


def _colour(img: np.ndarray, vmin: float | None, vmax: float | None):
    """A 2D field as an RGB PIL image, viridis over [vmin, vmax] (the
    field's own range where None), row 0 at the bottom as
    imshow(origin="lower") draws it."""
    from PIL import Image

    a = np.asarray(img, np.float64)
    lo = float(a.min()) if vmin is None else vmin
    hi = float(a.max()) if vmax is None else vmax
    u = np.clip((a - lo) / (hi - lo if hi > lo else 1.0), 0.0, 1.0) * (len(_VIRIDIS) - 1)
    i = np.minimum(np.floor(u).astype(int), len(_VIRIDIS) - 2)
    w = (u - i)[..., None]
    rgb = (_VIRIDIS[i] * (1 - w) + _VIRIDIS[i + 1] * w).astype(np.uint8)
    return Image.fromarray(np.ascontiguousarray(rgb[::-1]), "RGB")


def image_row(out_path: str | Path, panels, names=(), title: str = ""):
    """Fields side by side, each (img, vmin, vmax), scaled up to about 256
    pixels a side, each under its name and all under ``title``."""
    from PIL import Image, ImageDraw

    tiles = [_colour(img, lo, hi) for img, lo, hi in panels]
    scale = max(1, 256 // max(max(t.size) for t in tiles))
    tiles = [t.resize((t.width * scale, t.height * scale), Image.NEAREST) for t in tiles]
    gap, top = 8, 40
    canvas = Image.new("RGB", (sum(t.width for t in tiles) + gap * (len(tiles) + 1),
                               max(t.height for t in tiles) + gap + top), "white")
    draw = ImageDraw.Draw(canvas)
    draw.text((gap, 4), title, fill="black")
    x = gap
    for n, t in enumerate(tiles):
        canvas.paste(t, (x, top))
        draw.text((x, top - 14), names[n] if n < len(names) else "", fill="black")
        x += t.width + gap
    canvas.save(out_path)
    return Path(out_path)


def _plot_area(x0, x1, y0, y1, title: str, names, slots=None):
    """A white canvas with the plot area's frame, ``title`` above it and a
    legend of ``names`` in the line colours (of ``slots``, default their
    positions); returns the image, its drawing context and a map from data
    to pixel coordinates."""
    from PIL import Image, ImageDraw

    w, h = _SIZE
    img = Image.new("RGB", _SIZE, "white")
    draw = ImageDraw.Draw(img)
    draw.rectangle([_MARGIN, _MARGIN, w - _MARGIN, h - _MARGIN], outline="black")
    draw.text((_MARGIN, 12), title, fill="black")
    for n, name in enumerate(names):
        slot = n if slots is None else slots[n]
        draw.text((_MARGIN + 8, _MARGIN + 6 + 14 * n), name,
                  fill=_LINE_COLOURS[slot % len(_LINE_COLOURS)])
    sx = (w - 2 * _MARGIN) / (x1 - x0 if x1 > x0 else 1.0)
    sy = (h - 2 * _MARGIN) / (y1 - y0 if y1 > y0 else 1.0)
    return img, draw, lambda x, y: (_MARGIN + (x - x0) * sx, h - _MARGIN - (y - y0) * sy)


def line_figure(out_path: str | Path, curves: dict, title: str = "",
                spread: dict | None = None, colour_of: dict | None = None,
                thin: tuple = ()):
    """Curves {name: (x, y)} with a marker at each point, and error bars
    of +-``spread[name]`` where given, in one frame; a point whose value is
    not finite is left out (a gap).  ``colour_of`` maps a curve's name to
    its slot in the line colours (default: its position); the curves named
    in ``thin`` are drawn thin with hollow markers."""
    spread, colour_of = spread or {}, colour_of or {}
    xs = np.concatenate([np.asarray(x, float) for x, _ in curves.values()])
    ys = np.concatenate([np.asarray(y, float) + spread.get(k, 0.0)
                         for k, (_, y) in curves.items()])
    img, draw, to_px = _plot_area(xs.min(), xs.max(), min(np.nanmin(ys), 0.0),
                                  np.nanmax(ys) * 1.05, title, list(curves),
                                  [colour_of.get(k, n) for n, k in enumerate(curves)])
    for n, (name, (x, y)) in enumerate(curves.items()):
        x, y = np.asarray(x, float), np.asarray(y, float)
        pts = [to_px(a, b) for a, b in zip(x, y) if np.isfinite(b)]
        col = _LINE_COLOURS[colour_of.get(name, n) % len(_LINE_COLOURS)]
        if len(pts) > 1:
            draw.line(pts, fill=col, width=1 if name in thin else 2)
        for px, py in pts:
            draw.ellipse([px - 3, py - 3, px + 3, py + 3], outline=col,
                         fill="white" if name in thin else col)
        if name in spread:
            for a, b, s in zip(x, y, spread[name]):
                if np.isfinite(b):
                    draw.line([to_px(a, b - s), to_px(a, b + s)], fill=col, width=1)
    img.save(out_path)
    return Path(out_path)


def rollout_figure(out_path: str | Path, task: str = "2D_NS", model: str = "FNO",
                   ours: list[float] | None = None):
    """nRMSE vs rollout step; ``ours`` (optional) overlays fresh results."""
    tab = ROLLOUT_NRMSE[task][model]
    steps = np.arange(1, len(tab["baseline"]) + 1)
    curves = {f"{model} baseline": (steps, tab["baseline"]),
              f"{model} + aux (paper)": (steps, tab["aux"])}
    if ours is not None:
        curves["ours (this run)"] = (steps[: len(ours)], ours)
    return line_figure(out_path, curves, f"{task} {model} rollout: nRMSE vs rollout step")


def motivation_figure(out_path: str | Path):
    m = MOTIVATION_NRMSE
    vals = np.asarray([m["full"], m["decomposed_convection"]], float)
    n_s, n_g = vals.shape
    img, draw, to_px = _plot_area(0.0, float(n_g), 0.0, float(vals.max()) * 1.05,
                                  "nRMSE of " + ", ".join(m["models"]),
                                  ["full 2D NS", "decomposed convection"])
    width = 0.8 / n_s
    for s in range(n_s):
        for g in range(n_g):
            x0, y0 = to_px(g + 0.1 + s * width, vals[s, g])
            x1, y1 = to_px(g + 0.1 + (s + 1) * width, 0.0)
            draw.rectangle([x0, y0, x1, y1], fill=_LINE_COLOURS[s])
    img.save(out_path)
    return Path(out_path)


def field_panels(out_path: str | Path, pred: np.ndarray, target: np.ndarray,
                 channel: int = 0, title: str = ""):
    """2D field render: prediction vs target vs error, clim locked to the
    target (reference metrics.py:461-508 style)."""
    if pred.ndim == 4:  # 3D volume: take the mid z-slice (3D_NS_Vis.py)
        zmid = pred.shape[2] // 2
        pred, target = pred[:, :, zmid], target[:, :, zmid]
    p, t = pred[..., channel], target[..., channel]
    vmin, vmax = float(t.min()), float(t.max())
    return image_row(out_path, [(p.T, vmin, vmax), (t.T, vmin, vmax), ((p - t).T, None, None)],
                     ("Prediction", "Data", "Error"), title)


def data_efficiency_figure(out_path: str | Path, results: dict[str, list[float]],
                           labels: list[str] | None = None,
                           x: list[float] | None = None,
                           xlabel: str = "simulation cost (s)"):
    """nRMSE vs simulation cost (log axis); ``results`` maps curve name ->
    nRMSE per basic_dsN preset (mean over seeds); error bars from seed
    spread when a list of lists is given (random_seed_ns.py:30-39).  ``x``
    overrides the default NS sim-cost axis (use when presets are a
    non-contiguous subset, where positional mapping would mislabel points);
    per-seed rows of uneven length are handled independently."""
    cost = x if x is not None else SIM_COST_SECONDS
    curves, spread = {}, {}
    for name, vals in results.items():
        vals = np.asarray(vals, dtype=object)
        if vals.ndim == 2 or isinstance(vals[0], (list, np.ndarray)):
            spread[name] = [np.std(np.asarray(v, float)) for v in vals]
            vals = [np.mean(np.asarray(v, float)) for v in vals]
        curves[name] = (np.log10(np.asarray(cost[: len(vals)], float)), np.asarray(vals, float))
    return line_figure(out_path, curves, f"nRMSE vs log10 {xlabel}", spread)


def field_animation(out_path: str | Path, frames: np.ndarray, channel: int = 0,
                    fps: int = 10, cmap: str = "viridis", title: str = ""):
    """Animated gif of a trajectory (reference data_gen/src/plots.py
    ``phi_plots``/gif writing): ``frames`` is (T, X, Y[, C]); one image per
    frame on a shared colour scale (viridis, the one ``cmap`` drawn)."""
    from PIL import Image, ImageDraw

    if cmap != "viridis":
        raise ValueError(f"cmap {cmap!r}: viridis is the one colour map drawn")
    frames = np.asarray(frames)
    if frames.ndim == 4:
        frames = frames[..., channel]
    vmin, vmax = float(frames.min()), float(frames.max())
    scale = max(1, 256 // max(frames.shape[1:]))
    imgs = []
    for f in frames:
        im = _colour(f.T, vmin, vmax)
        im = im.resize((im.width * scale, im.height * scale), Image.NEAREST)
        ImageDraw.Draw(im).text((4, 4), title, fill="white")
        imgs.append(im)
    imgs[0].save(out_path, save_all=True, append_images=imgs[1:],
                 duration=max(1, int(1000 / fps)), loop=0)
    return Path(out_path)
