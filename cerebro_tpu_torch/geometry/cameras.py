"""Camera models as batched lift/project functions on tensors (counterpart of
cerebro_tpu/geometry/cameras.py).

The reference vendors camodocal (src/utils/camodocal/: PinholeCamera.cc,
CataCamera.cc (Mei), EquidistantCamera.cc (Kannala-Brandt),
ScaramuzzaCamera.cc). Each model provides

  project(params, P_cam)  : (...,3) camera-frame points -> (...,2) pixels
  lift(params, uv)        : (...,2) pixels -> (...,3) unit-norm rays

The inverse-distortion solves run the JAX package's fixed iteration counts
(radtan 8, Kannala-Brandt 10, Scaramuzza 12), in float32 as it computes
them, so both packages give the same pixels and rays. ``from_yaml_dict``
accepts camodocal-format dicts (the reference's config/**/*.yaml camera
blocks).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

PINHOLE = "PINHOLE"
MEI = "MEI"
KANNALA_BRANDT = "KANNALA_BRANDT"
SCARAMUZZA = "SCARAMUZZA"


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """Unified parameter container: float32 CPU tensors (0-d, dist (4,)),
    moved to the input's device by ``project`` / ``lift``. Unused slots are
    zero.

    dist            : PINHOLE / MEI (k1, k2, p1, p2) radtan;
                      KANNALA_BRANDT (k2, k3, k4, k5) theta polynomial;
                      SCARAMUZZA (a0, a2, a3, a4): cam2world polynomial
                      z(rho) = a0 + a2 rho^2 + a3 rho^3 + a4 rho^4, affine
                      stretch [[fx, xi], [0, fy]], (cx, cy) the centre
    xi              : MEI mirror parameter / Scaramuzza 'd' affine term
    """

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor
    xi: torch.Tensor
    model: str = PINHOLE
    width: int = 752
    height: int = 480


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _make(fx, fy, cx, cy, dist, xi, model, width, height) -> CameraParams:
    return CameraParams(
        fx=_f32(fx), fy=_f32(fy), cx=_f32(cx), cy=_f32(cy), dist=_f32(dist),
        xi=_f32(xi), model=model, width=width, height=height,
    )


def make_pinhole(fx, fy, cx, cy, dist=(0.0, 0.0, 0.0, 0.0), width=752, height=480):
    return _make(fx, fy, cx, cy, dist, 0.0, PINHOLE, width, height)


def make_kannala_brandt(mu, mv, u0, v0, k=(0.0, 0.0, 0.0, 0.0), width=752, height=480):
    return _make(mu, mv, u0, v0, k, 0.0, KANNALA_BRANDT, width, height)


def make_mei(gamma1, gamma2, u0, v0, xi, dist=(0.0, 0.0, 0.0, 0.0), width=752, height=480):
    return _make(gamma1, gamma2, u0, v0, dist, xi, MEI, width, height)


def make_scaramuzza(
    c, u0, v0, poly=(1.0, 0.0, 0.0, 0.0), d_affine=0.0, width=752, height=480
):
    """OCamCalib-style omnidirectional camera: cam2world poly z(rho) = a0 +
    a2 rho^2 + a3 rho^3 + a4 rho^4, affine [[c, d], [0, 1]] (e fixed at 0),
    centre (u0, v0)."""
    return _make(c, 1.0, u0, v0, poly, d_affine, SCARAMUZZA, width, height)


def from_yaml_dict(d: Dict) -> CameraParams:
    """Build from a camodocal-format dict (ref src/utils/camodocal/src/
    camera_models/CameraFactory.cc)."""
    model = d.get("model_type", "PINHOLE").upper()
    w = int(d.get("image_width", 752))
    h = int(d.get("image_height", 480))
    if model == "PINHOLE":
        pp = d["projection_parameters"]
        dp = d.get("distortion_parameters", {})
        return make_pinhole(
            pp["fx"], pp["fy"], pp["cx"], pp["cy"],
            (dp.get("k1", 0.0), dp.get("k2", 0.0), dp.get("p1", 0.0), dp.get("p2", 0.0)),
            w, h,
        )
    if model == "KANNALA_BRANDT":
        pp = d["projection_parameters"]
        return make_kannala_brandt(
            pp["mu"], pp["mv"], pp["u0"], pp["v0"],
            (pp.get("k2", 0.0), pp.get("k3", 0.0), pp.get("k4", 0.0), pp.get("k5", 0.0)),
            w, h,
        )
    if model == "MEI":
        pp = d["projection_parameters"]
        dp = d.get("mirror_parameters", {})
        di = d.get("distortion_parameters", {})
        return make_mei(
            pp["gamma1"], pp["gamma2"], pp["u0"], pp["v0"], dp.get("xi", 1.0),
            (di.get("k1", 0.0), di.get("k2", 0.0), di.get("p1", 0.0), di.get("p2", 0.0)),
            w, h,
        )
    if model == "SCARAMUZZA":
        # OCamCalib format (ref ScaramuzzaCamera.cc:64-104): p1 == 0 by
        # construction; the affine e term (ae) is not representable
        pp = d["poly_parameters"]
        ap = d["affine_parameters"]
        return make_scaramuzza(
            ap.get("ac", 1.0), ap["cx"], ap["cy"],
            (pp.get("p0", 0.0), pp.get("p2", 0.0), pp.get("p3", 0.0), pp.get("p4", 0.0)),
            d_affine=ap.get("ad", 0.0),
            width=w, height=h,
        )
    raise ValueError(f"unknown camera model {model!r}")


def _params(c: CameraParams, x: torch.Tensor):
    """(fx, fy, cx, cy, dist, xi) as float32 tensors on ``x``'s device."""
    return tuple(
        t.to(device=x.device, dtype=torch.float32)
        for t in (c.fx, c.fy, c.cx, c.cy, c.dist, c.xi)
    )


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _safe(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """x with |x| < eps replaced by eps (the JAX package's division guard)."""
    return torch.where(x.abs() < eps, torch.full_like(x, eps), x)


# ---------------------------------------------------------------------------
# Distortion primitives
# ---------------------------------------------------------------------------


def _radtan_distort(dist: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Radial-tangential distortion of normalized coords (...,2)."""
    k1, k2, p1, p2 = dist[..., 0], dist[..., 1], dist[..., 2], dist[..., 3]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([x * radial + dx, y * radial + dy], dim=-1)


def _radtan_undistort(dist: torch.Tensor, xy_d: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Fixed-point inverse of radtan distortion, a fixed iteration count
    (ref src/utils/camodocal/src/camera_models/PinholeCamera.cc)."""
    xy = xy_d
    for _ in range(iters):
        xy = xy_d - (_radtan_distort(dist, xy) - xy)
    return xy


# ---------------------------------------------------------------------------
# Projection / lifting per model
# ---------------------------------------------------------------------------


def _project_pinhole(c: CameraParams, P: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy, dist, _ = _params(c, P)
    xy = P[..., :2] / _safe(P[..., 2])[..., None]
    xyd = _radtan_distort(dist, xy)
    return torch.stack([fx * xyd[..., 0] + cx, fy * xyd[..., 1] + cy], dim=-1)


def _lift_pinhole(c: CameraParams, uv: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy, dist, _ = _params(c, uv)
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy
    xy = _radtan_undistort(dist, torch.stack([xd, yd], dim=-1))
    ray = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    return ray / _norm(ray)


def _kb_poly(dist: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """r(theta) = theta + k2 th^3 + k3 th^5 + k4 th^7 + k5 th^9."""
    k2, k3, k4, k5 = dist[..., 0], dist[..., 1], dist[..., 2], dist[..., 3]
    th2 = theta * theta
    return theta * (1.0 + th2 * (k2 + th2 * (k3 + th2 * (k4 + th2 * k5))))


def _project_kb(c: CameraParams, P: torch.Tensor) -> torch.Tensor:
    # ref src/utils/camodocal/src/camera_models/EquidistantCamera.cc
    fx, fy, cx, cy, dist, _ = _params(c, P)
    rho = torch.sqrt(P[..., 0] ** 2 + P[..., 1] ** 2)
    theta = torch.atan2(rho, P[..., 2])
    r = _kb_poly(dist, theta)
    small = rho < 1e-9
    scale = torch.where(small, torch.zeros_like(r), r / torch.where(small, torch.ones_like(rho), rho))
    return torch.stack([fx * P[..., 0] * scale + cx, fy * P[..., 1] * scale + cy], dim=-1)


def _lift_kb(c: CameraParams, uv: torch.Tensor, iters: int = 10) -> torch.Tensor:
    # r(theta) inverted by a fixed count of Newton steps
    fx, fy, cx, cy, dist, _ = _params(c, uv)
    k2, k3, k4, k5 = dist[..., 0], dist[..., 1], dist[..., 2], dist[..., 3]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    r = torch.sqrt(mx * mx + my * my)
    theta = r
    for _ in range(iters):
        th2 = theta * theta
        fp = 1.0 + th2 * (3 * k2 + th2 * (5 * k3 + th2 * (7 * k4 + th2 * 9 * k5)))
        theta = theta - (_kb_poly(dist, theta) - r) / torch.clamp(fp, min=1e-6)
    sin_t = torch.sin(theta)
    small = r < 1e-9
    safe_r = torch.where(small, torch.ones_like(r), r)
    x = torch.where(small, torch.zeros_like(r), sin_t * mx / safe_r)
    y = torch.where(small, torch.zeros_like(r), sin_t * my / safe_r)
    return torch.stack([x, y, torch.cos(theta)], dim=-1)


def _project_mei(c: CameraParams, P: torch.Tensor) -> torch.Tensor:
    # unified (Mei) model: onto the unit sphere, shift by xi, pinhole
    # (ref src/utils/camodocal/src/camera_models/CataCamera.cc)
    fx, fy, cx, cy, dist, xi = _params(c, P)
    z = _safe(P[..., 2] + xi * torch.linalg.vector_norm(P, dim=-1))
    xyd = _radtan_distort(dist, P[..., :2] / z[..., None])
    return torch.stack([fx * xyd[..., 0] + cx, fy * xyd[..., 1] + cy], dim=-1)


def _lift_mei(c: CameraParams, uv: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy, dist, xi = _params(c, uv)
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    xy = _radtan_undistort(dist, torch.stack([mx, my], dim=-1))
    mx, my = xy[..., 0], xy[..., 1]
    r2 = mx * mx + my * my
    disc = 1.0 + (1.0 - xi * xi) * r2
    zs = (xi + torch.sqrt(torch.clamp(disc, min=0.0))) / (1.0 + r2)
    ray = torch.stack([zs * mx, zs * my, zs - xi], dim=-1)
    return ray / _norm(ray)


def _scara_poly(dist: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    a0, a2, a3, a4 = dist[..., 0], dist[..., 1], dist[..., 2], dist[..., 3]
    return a0 + rho * rho * (a2 + rho * (a3 + rho * a4))


def _scara_poly_deriv(dist: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    a2, a3, a4 = dist[..., 1], dist[..., 2], dist[..., 3]
    return rho * (2.0 * a2 + rho * (3.0 * a3 + rho * 4.0 * a4))


def _lift_scara(c: CameraParams, uv: torch.Tensor) -> torch.Tensor:
    # invert the affine [[c, d], [0, 1]] about the centre
    fx, _, cx, cy, dist, xi = _params(c, uv)
    my = uv[..., 1] - cy  # second affine row is (0, 1)
    mx = (uv[..., 0] - cx - xi * my) / fx
    rho = torch.sqrt(mx * mx + my * my)
    ray = torch.stack([mx, my, _scara_poly(dist, rho)], dim=-1)
    return ray / _norm(ray)


def _project_scara(c: CameraParams, P: torch.Tensor, iters: int = 12) -> torch.Tensor:
    # f(rho) * r - z * rho = 0 solved for rho by a fixed count of Newton
    # steps from the paraxial rho ~ a0 * r / z
    fx, _, cx, cy, dist, xi = _params(c, P)
    r = torch.sqrt(P[..., 0] ** 2 + P[..., 1] ** 2)
    z = P[..., 2]
    safe_r = torch.where(r < 1e-9, torch.ones_like(r), r)
    rho = dist[..., 0].abs() * r / torch.clamp(z.abs(), min=1e-6)
    for _ in range(iters):
        g = _scara_poly(dist, rho) * r - z * rho
        gp = _safe(_scara_poly_deriv(dist, rho) * r - z)
        rho = torch.clamp(rho - g / gp, 0.0, 1e4)
    mx = P[..., 0] / safe_r * rho
    my = P[..., 1] / safe_r * rho
    return torch.stack([fx * mx + xi * my + cx, my + cy], dim=-1)


_PROJECT = {
    PINHOLE: _project_pinhole,
    KANNALA_BRANDT: _project_kb,
    MEI: _project_mei,
    SCARAMUZZA: _project_scara,
}
_LIFT = {
    PINHOLE: _lift_pinhole,
    KANNALA_BRANDT: _lift_kb,
    MEI: _lift_mei,
    SCARAMUZZA: _lift_scara,
}


def project(c: CameraParams, P_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3D points (...,3) -> pixel coords (...,2)."""
    return _PROJECT[c.model](c, P_cam.float())


def lift(c: CameraParams, uv: torch.Tensor) -> torch.Tensor:
    """Pixel coords (...,2) -> unit-norm rays (...,3)."""
    return _LIFT[c.model](c, uv.float())


def K_matrix(c: CameraParams) -> torch.Tensor:
    """3x3 intrinsics (the reference's GeometryUtils::make_K,
    src/utils/CameraGeometry.h:276-305)."""
    z, o = torch.zeros_like(c.fx), torch.ones_like(c.fx)
    return torch.stack(
        [
            torch.stack([c.fx, z, c.cx], dim=-1),
            torch.stack([z, c.fy, c.cy], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )


def normalized_coords(c: CameraParams, uv: torch.Tensor) -> torch.Tensor:
    """Pixels -> undistorted ideal (normalized) image coords (...,2), the
    reference's K^-1 normalization before PnP
    (src/utils/PointFeatureMatching.cpp:95-153)."""
    ray = lift(c, uv)
    return ray[..., :2] / _safe(ray[..., 2])[..., None]
