"""Photo-textured benchmark world (counterpart of cerebro_tpu/photoworld.py).

The procedural ``synthworld`` texture is the same smooth noise everywhere,
so descriptor contrast between places is thin there. This world's ground is
a polar mosaic of real photographs, so every angular sector of the survey
circuit carries distinct imagery:

  * the circuit is divided into K sectors, one source photo per sector;
  * each sector is subdivided into ~``cell_m``-metre polar cells, each
    painted with a different native-resolution crop of the sector's photo
    (deterministic per cell);
  * terrain height (the plateau mask) has the procedural world's
    statistics, so stereo depth still has structure.

``synthworld.Renderer`` drives it (the world only needs ``_sample``).

The nine photos come from ``artifacts/photoworld_photos.npz``, written once
by ``scripts/export_photoworld_photos.py`` from the JAX package's
``load_photos()`` (which decodes sample images of scikit-learn and
matplotlib with OpenCV); the port needs none of those packages.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

PHOTOS_NPZ = os.path.join(
    os.path.dirname(__file__), "..", "artifacts", "photoworld_photos.npz"
)


def load_photos() -> list:
    """The nine contrast-normalized [0, 1] float32 photos, in order."""
    with np.load(PHOTOS_NPZ) as z:
        return [z[f"photo_{k}"] for k in range(len(z.files))]


def _smooth_mask(rng, n: int) -> np.ndarray:
    """Plateau mask with the same statistics as synthworld's terrain."""
    out = np.zeros((n, n), np.float32)
    for scale, amp in [(128, 1.0), (256, 1.0)]:
        small = rng.normal(size=(n // scale, n // scale)).astype(np.float32)
        big = np.kron(small, np.ones((scale, scale), np.float32))
        for _ in range(3):
            big = 0.25 * (
                np.roll(big, 1, 0) + np.roll(big, -1, 0)
                + np.roll(big, 1, 1) + np.roll(big, -1, 1)
            )
        out += amp * big
    out = (out - out.min()) / (out.max() - out.min())
    return out > 0.62


@dataclasses.dataclass
class PhotoWorld:
    """Drop-in world for ``synthworld.Renderer``: polar photo-mosaic
    texture + plateau mask, with its own texture scale (``tex_m`` px/m —
    the atlas must cover the wider photo circuit without wrapping)."""

    tex: np.ndarray  # (N, N) float32 mosaic
    mask: np.ndarray  # (N, N) bool plateau mask
    tex_m: float  # texture pixels per metre

    @classmethod
    def create(
        cls,
        seed: int = 0,
        n: int = 4096,
        tex_m: float = 100.0,
        n_sectors: int = 9,
        cell_m: float = 2.0,
        r_max_m: float = 20.0,
    ) -> "PhotoWorld":
        rng = np.random.default_rng(seed)
        photos = load_photos()
        if len(photos) < n_sectors:
            raise ValueError(f"{n_sectors} sectors need as many photos, have {len(photos)}")
        cell_px = int(cell_m * tex_m)

        # polar coordinates of every atlas pixel (world metres)
        ax = (np.arange(n, dtype=np.float32) - n / 2) / tex_m
        wx, wy = np.meshgrid(ax, ax)  # wy rows, wx cols (atlas[ty, tx])
        r = np.hypot(wx, wy)
        phi = np.mod(np.arctan2(wy, wx), 2 * np.pi)

        sector_phi = 2 * np.pi / n_sectors
        sector = np.minimum((phi / sector_phi).astype(np.int32), n_sectors - 1)
        # angular cell width: ~cell_m of arc at the survey radius (r_max/1.4)
        r_ref = r_max_m / 1.4
        cell_phi = cell_m / r_ref
        cells_per_sector = max(int(round(sector_phi / cell_phi)), 1)
        cell_phi = sector_phi / cells_per_sector  # exact tiling per sector
        ci = (phi / cell_phi).astype(np.int64)  # global angular cell id
        rj = (r / cell_m).astype(np.int64)  # radial cell id
        u = (phi / cell_phi - ci).astype(np.float32)  # [0,1) within cell
        v = (r / cell_m - rj).astype(np.float32)

        tex = np.zeros((n, n), np.float32)
        # a seeded hash per (angular, radial) cell picks the crop offset, so
        # every cell shows a different native-res region of its photo
        for k in range(n_sectors):
            m = sector == k
            if not m.any():
                continue
            ph = photos[k]
            ph_h, ph_w = ph.shape
            # crop source size: native if the photo is big enough, else the
            # whole photo scaled into the cell
            sh = min(cell_px, ph_h - 1)
            sw = min(cell_px, ph_w - 1)
            cid = ci[m] * 100003 + rj[m] * 193  # unique per polar cell
            h1 = (cid * 2654435761 + seed) & 0xFFFFFFFF
            h2 = (cid * 40503 + 9176 + seed) & 0xFFFFFFFF
            oy = (h1 % max(ph_h - sh, 1)).astype(np.int64)
            ox = (h2 % max(ph_w - sw, 1)).astype(np.int64)
            py = oy + np.minimum((v[m] * sh).astype(np.int64), sh - 1)
            px = ox + np.minimum((u[m] * sw).astype(np.int64), sw - 1)
            tex[m] = ph[py, px]
        # mild high-frequency dither so even flat photo regions carry
        # stereo-matchable texture (5% amplitude; does not move descriptors)
        tex = np.clip(tex + 0.05 * rng.standard_normal((n, n)).astype(np.float32), 0, 1)
        return cls(tex=tex, mask=_smooth_mask(rng, n), tex_m=tex_m)

    def _sample(self, wx: np.ndarray, wy: np.ndarray, arr: np.ndarray):
        n = arr.shape[0]
        tx = (wx * self.tex_m + n / 2).astype(np.int64) % n
        ty = (wy * self.tex_m + n / 2).astype(np.int64) % n
        return arr[ty, tx]


# survey radius for the photo circuit: sectors must be wider than the
# camera footprint (6.4 m at flight height) for cross-sector contrast
PHOTO_RADIUS_M = 14.0


def make_photo_sequence(n_frames: int = 1000, laps: float = 3.5, **kw):
    """synthworld.make_sequence on the photo circuit's wider radius."""
    from cerebro_tpu_torch import synthworld as sw

    return sw.make_sequence(n_frames=n_frames, laps=laps, radius=PHOTO_RADIUS_M, **kw)
