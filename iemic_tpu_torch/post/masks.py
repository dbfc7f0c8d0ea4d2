# Copied from iemic_tpu/post/masks.py (numpy-only; importing iemic_tpu would import jax).
"""Land-mask creation and editing tools (reference matlab/create_mask.m,
edit_mask.m, and the flood/smooth/merge helpers in matlab/ and
data/mkmask/).

Masks use the reference's convention: an (l+2, m+2, n+2) integer array
with 0 = OCEAN and 1 = LAND including a one-cell border of ghost
cells; the raw interior (l, m, n) view is what these tools produce and
edit (see iemic_tpu.models.ocean.landmask.finalize_mask)."""

from __future__ import annotations

import numpy as np


def create_mask(n: int, m: int, l: int, land=None) -> np.ndarray:
    """Blank (all-ocean) raw mask, optionally with land columns set
    from a 2D (m, n) boolean array."""
    raw = np.zeros((l, m, n), dtype=np.int64)
    if land is not None:
        raw[:, np.asarray(land, dtype=bool)] = 1
    return raw


def flood_fill(mask2d: np.ndarray, seed: tuple[int, int],
               periodic: bool = False) -> np.ndarray:
    """Connected-component fill of ocean points starting from seed;
    everything not reachable becomes land (the reference's
    topo.F90:41-450 flood-fill removes isolated seas and bays)."""
    m, n = mask2d.shape
    ocean = (np.asarray(mask2d) == 0)
    reach = np.zeros_like(ocean, dtype=bool)
    stack = [seed]
    while stack:
        j, i = stack.pop()
        if not (0 <= j < m):
            continue
        ii = i % n if periodic else i
        if not (0 <= ii < n):
            continue
        if reach[j, ii] or not ocean[j, ii]:
            continue
        reach[j, ii] = True
        stack.extend([(j + 1, ii), (j - 1, ii), (j, ii + 1), (j, ii - 1)])
    out = np.where(reach, 0, 1).astype(np.int64)
    return out


def smooth_mask(mask2d: np.ndarray, min_neighbors: int = 2,
                iterations: int = 1) -> np.ndarray:
    """Remove single-cell ocean inlets/peninsulas: an ocean cell with
    fewer than min_neighbors ocean neighbors becomes land and vice
    versa (matlab mask smoothing)."""
    mk = np.asarray(mask2d).copy()
    for _ in range(iterations):
        ocean = (mk == 0).astype(int)
        nb = (np.roll(ocean, 1, 0) + np.roll(ocean, -1, 0)
              + np.roll(ocean, 1, 1) + np.roll(ocean, -1, 1))
        mk = np.where((ocean == 1) & (nb < min_neighbors), 1, mk)
        land = (mk != 0).astype(int)
        nbl = (np.roll(land, 1, 0) + np.roll(land, -1, 0)
               + np.roll(land, 1, 1) + np.roll(land, -1, 1))
        mk = np.where((land == 1) & (nbl < min_neighbors), 0, mk)
    return mk


def mask_from_etopo(depth2d: np.ndarray, grid, nlev: int | None = None
                    ) -> np.ndarray:
    """Raw 3D mask from a bathymetry field (m, n) in meters (negative
    below sea level) — the reference's mkmask path from ETOPO data:
    a cell (k, j, i) is land when the sea floor is shallower than the
    cell's bottom face."""
    l = grid.l if nlev is None else nlev
    zw = np.asarray(grid.zw[:-1]) * grid.hdim        # bottom faces (<0)
    raw = np.zeros((l, depth2d.shape[0], depth2d.shape[1]),
                   dtype=np.int64)
    for k in range(l):
        raw[k] = (np.asarray(depth2d) > zw[k]).astype(np.int64)
    return raw


def write_mask_file(path: str, raw: np.ndarray) -> None:
    """Write a mask in the reference's ascii mkmask format read by
    landmask.read_mask_file (topo.F90:41-66): per level k = 0..l+1 a
    header line, then m+2 digit rows from j = m+1 down to 0, each of
    n+2 digits (including the all-land ghost border)."""
    l, m, n = raw.shape
    full = np.ones((l + 2, m + 2, n + 2), dtype=np.int64)
    full[1:l + 1, 1:m + 1, 1:n + 1] = raw
    lines = []
    for k in range(l + 2):
        lines.append(f"%% level {k}")
        for j in range(m + 1, -1, -1):
            lines.append("".join(str(int(v)) for v in full[k, j]))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def merge_masks(a: np.ndarray, b: np.ndarray,
                mode: str = "union") -> np.ndarray:
    """Merge two raw (l, m, n) masks (the matlab mask-merge helper):
    mode 'union' keeps land where EITHER has land, 'intersect' where
    BOTH have land, 'overwrite' takes b wherever b differs from
    all-ocean."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape != b.shape:
        raise ValueError(f"mask shapes differ: {a.shape} vs {b.shape}")
    if mode == "union":
        return np.where((a != 0) | (b != 0), 1, 0).astype(np.int64)
    if mode == "intersect":
        return np.where((a != 0) & (b != 0), 1, 0).astype(np.int64)
    if mode == "overwrite":
        return np.where(b != 0, 1, a).astype(np.int64)
    raise ValueError(f"merge_masks: unknown mode '{mode}'")


class MaskEditor:
    """Mask editing session — the matlab/edit_mask.m analog.

    The reference's editor is an interactive MATLAB figure for
    clicking land cells on/off level by level; here the same edits are
    scriptable (for reproducible mask pipelines) and an optional
    matplotlib click-editor is provided where a display exists.

    Operates on a raw (l, m, n) mask (0 = ocean, 1 = land); every edit
    is recorded for undo and for dumping an edit script.
    """

    def __init__(self, raw):
        self.mask = np.asarray(raw).copy()
        self._undo = []
        self.log = []

    def _push(self):
        self._undo.append(self.mask.copy())

    def undo(self):
        if self._undo:
            self.mask = self._undo.pop()
            self.log.append(("undo",))
        return self

    def toggle(self, j: int, i: int, k: int | None = None):
        """Flip one cell (all levels when k is None) — the editor's
        click action."""
        self._push()
        sl = slice(None) if k is None else k
        self.mask[sl, j, i] = 1 - self.mask[sl, j, i]
        self.log.append(("toggle", j, i, k))
        return self

    def set_box(self, j0: int, j1: int, i0: int, i1: int,
                value: int = 1, k: int | None = None):
        """Set a lat/lon box to land (1) or ocean (0)."""
        self._push()
        sl = slice(None) if k is None else k
        self.mask[sl, j0:j1, i0:i1] = value
        self.log.append(("set_box", j0, j1, i0, i1, value, k))
        return self

    def set_depth(self, j: int, i: int, nlev: int):
        """Make column (j, i) ocean down to level nlev (0 = all land)
        — the editor's per-column depth action."""
        self._push()
        self.mask[:, j, i] = 1
        self.mask[:nlev, j, i] = 0
        self.log.append(("set_depth", j, i, nlev))
        return self

    def flood(self, seed: tuple[int, int], periodic: bool = False):
        """Apply the flood fill on the surface level and propagate the
        resulting land columns down (removes lakes/bays, the editor's
        cleanup action)."""
        self._push()
        surf = flood_fill(self.mask[0], seed, periodic=periodic)
        self.mask[:, surf != 0] = 1
        self.mask[0] = surf
        self.log.append(("flood", seed, periodic))
        return self

    def smooth(self, min_neighbors: int = 2, iterations: int = 1):
        self._push()
        for k in range(self.mask.shape[0]):
            self.mask[k] = smooth_mask(self.mask[k], min_neighbors,
                                       iterations)
        self.log.append(("smooth", min_neighbors, iterations))
        return self

    def save(self, path: str):
        write_mask_file(path, self.mask)
        return self

    def interactive(self, level: int = 0):  # pragma: no cover
        """Matplotlib click editor (left-click toggles a cell on the
        shown level, 'u' undoes, up/down keys change level) — the
        direct edit_mask.m experience where a display exists."""
        import matplotlib.pyplot as plt
        state = {"k": level}
        fig, ax = plt.subplots()

        def draw():
            ax.clear()
            ax.imshow(self.mask[state["k"]], origin="lower",
                      cmap="Greys", vmin=0, vmax=1)
            ax.set_title(f"level {state['k']} "
                         "(click: toggle, u: undo, up/down: level)")
            fig.canvas.draw_idle()

        def on_click(ev):
            if ev.inaxes is ax and ev.xdata is not None:
                self.toggle(int(round(ev.ydata)), int(round(ev.xdata)),
                            state["k"])
                draw()

        def on_key(ev):
            if ev.key == "u":
                self.undo()
            elif ev.key == "up":
                state["k"] = min(state["k"] + 1,
                                 self.mask.shape[0] - 1)
            elif ev.key == "down":
                state["k"] = max(state["k"] - 1, 0)
            draw()

        fig.canvas.mpl_connect("button_press_event", on_click)
        fig.canvas.mpl_connect("key_press_event", on_key)
        draw()
        plt.show()
        return self


def edit_mask(raw) -> MaskEditor:
    """Open an editing session on a raw (l, m, n) mask (edit_mask.m)."""
    return MaskEditor(raw)
