"""The one route generator: a traffic file's segments and a seed -> a stream.

A traffic file (``portbench/traffic/<mix>.json``) names tracks over the
photo world and a list of segments flown on them:

    "tracks": {"main": {"radius_m": 14.0, "lap_s": 15.0}, ...}
    "segments": [{"track": "main", "s": 15.0, "part": "prefill"},
                 {"repeat": 8, "segments": [...]}, ...]

A circular track may keep to an arc of its circle (``"start"`` and
``"arc"``, as fractions of a lap): flying on past the arc's end starts it
over. A spiral track, ``{"spiral": {"r0_m": R0, "pitch_m": P},
"speed_m_s": V}``, is the outward Archimedean spiral r = R0 + P theta / 2 pi
flown at the constant ground speed V from its inner end (its phase is the
seconds flown along it): each ring lies one pitch outside the last, so a
pitch wider than the footprint's diagonal never flies over seen ground.

Time is stream time (``dt_s`` per frame). A segment flies its track for
``s`` seconds, each track keeping its own phase, so a track flown again
later revisits the ground it covered; on a circle, a ``"kidnap": {"frames": F,
"jump_laps": J}`` entry jumps the track's phase by J laps, and its F frames
carry no pose, 4 tracked features and no keyframe flag; the odometry then
restarts in a new world frame, as a VIO front end does after a reset.
``part`` names the stream's parts (``prefill``, ``window``, ``tail``): what
the harness feeds before, inside and after the measured window.

The seed turns the whole route about the centre and draws the odometry's
noise; sizes, rates and the order of the parts are the file's, so every
seed gives the same work on other ground.

Odometry: ground-truth increments integrated with a slow yaw drift and a
yaw random walk plus 1% scale noise (the VINS-like model of the system's
synthetic world).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from portbench import world as W


@dataclasses.dataclass
class Stream:
    xy: np.ndarray  # (N, 2) ground-truth camera positions
    gt_poses: np.ndarray  # (N, 4, 4) ground-truth w_T_cam
    odom_poses: np.ndarray  # (N, 4, 4) drifting odometry w_T_cam (per world)
    has_pose: np.ndarray  # (N,) bool: odometry is published
    n_tracked: np.ndarray  # (N,) int
    is_keyframe: np.ndarray  # (N,) bool
    world: np.ndarray  # (N,) int: the odometry frame a frame's pose is in
    stamps: np.ndarray  # (N,) stream seconds
    part: np.ndarray  # (N,) object: the part each frame belongs to
    track: np.ndarray  # (N,) object: the track a frame was flown on

    def index(self, part: str) -> np.ndarray:
        return np.nonzero(self.part == part)[0]


def _flatten(segments: list) -> List[dict]:
    out = []
    for seg in segments:
        if "repeat" in seg:
            for _ in range(int(seg["repeat"])):
                out.extend(_flatten(seg["segments"]))
        else:
            out.append(seg)
    return out


def generate(traffic: dict, seed: int) -> Stream:
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0x5EED])
    dt = float(traffic["dt_s"])
    kf_every = int(traffic.get("keyframe_every", 1))
    tracks = traffic["tracks"]
    turn = float(rng.uniform(0.0, 1.0))  # the seed turns every track alike
    phase = {name: 0.0 for name in tracks}
    xs, ys, pose, tracked, kf, part, trk = [], [], [], [], [], [], []
    frame = 0
    for seg in _flatten(traffic["segments"]):
        name = seg["track"]
        t = tracks[name]
        spiral = "spiral" in t
        step = dt if spiral else dt / float(t["lap_s"])
        if "kidnap" in seg:
            if spiral:
                raise ValueError(f"track {name!r} is a spiral: a kidnap jumps laps of a circle")
            phase[name] += float(seg["kidnap"]["jump_laps"])
            n = int(seg["kidnap"]["frames"])
            lost = True
        else:
            n = int(round(float(seg["s"]) / dt))
            lost = False
        arc = float(t.get("arc", 1.0))
        for _ in range(n):
            if spiral:
                x, y = _spiral_xy(t, turn, phase[name])
                xs.append(x)
                ys.append(y)
            else:
                th = 2 * np.pi * (turn + float(t.get("start", 0.0)) + np.mod(phase[name], arc))
                xs.append(float(t["radius_m"]) * np.cos(th))
                ys.append(float(t["radius_m"]) * np.sin(th))
            pose.append(not lost)
            tracked.append(4 if lost else 120)
            kf.append((not lost) and frame % kf_every == 0)
            part.append(seg.get("part", "window"))
            trk.append(name)
            phase[name] += step
            frame += 1
    N = len(xs)
    xy = np.stack([np.asarray(xs), np.asarray(ys)], -1)
    gt = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    gt[:, :3, :3] = W.R_NADIR
    gt[:, 0, 3], gt[:, 1, 3], gt[:, 2, 3] = xy[:, 0], xy[:, 1], W.FLIGHT_H
    has_pose = np.asarray(pose, bool)
    odom, world = _odometry(gt, has_pose, rng, float(traffic.get("yaw_drift", 0.0012)))
    return Stream(
        xy=xy.astype(np.float32), gt_poses=gt, odom_poses=odom, has_pose=has_pose,
        n_tracked=np.asarray(tracked, np.int32), is_keyframe=np.asarray(kf, bool),
        world=world, stamps=1.0 + dt * np.arange(N), part=np.asarray(part, object),
        track=np.asarray(trk, object),
    )


def _spiral_xy(track: dict, turn: float, flown_s: float) -> Tuple[float, float]:
    """The point of a spiral track ``flown_s`` seconds from its inner end.
    With b = pitch / 2 pi and r = b phi, the arc length from the centre is
    (b / 2)(phi sqrt(1 + phi^2) + asinh phi); Newton's method finds the phi
    whose length past the inner end's is the distance flown."""
    b = float(track["spiral"]["pitch_m"]) / (2 * np.pi)
    phi0 = float(track["spiral"]["r0_m"]) / b

    def length(phi):
        return 0.5 * b * (phi * np.sqrt(1.0 + phi * phi) + np.arcsinh(phi))

    s = float(track["speed_m_s"]) * flown_s + length(phi0)
    phi = np.sqrt(2.0 * s / b)  # from the length's leading term, b phi^2 / 2
    for _ in range(50):
        d = (length(phi) - s) / (b * np.sqrt(1.0 + phi * phi))
        phi -= d
        if abs(d) < 1e-12 * phi:
            break
    th = 2 * np.pi * turn + (phi - phi0)
    return b * phi * np.cos(th), b * phi * np.sin(th)


def _odometry(gt: np.ndarray, has_pose: np.ndarray, rng, yaw_drift: float) -> Tuple[np.ndarray, np.ndarray]:
    N = len(gt)
    odom = np.zeros_like(gt)
    world = np.zeros(N, np.int64)
    R0 = W.R_NADIR.astype(np.float64)
    cur = np.eye(4)
    cur[:3, :3] = R0
    cur[:3, 3] = gt[0, :3, 3]
    kappa, w, lost_before = 0.0, 0, False
    for i in range(N):
        if has_pose[i] and lost_before:  # recovery: a new world frame
            w += 1
            cur = np.eye(4)
            cur[:3, :3] = R0
            kappa = 0.0
        elif i > 0 and has_pose[i]:
            d = gt[i, :3, 3].astype(np.float64) - gt[i - 1, :3, 3]
            kappa += yaw_drift + rng.normal(0.0, 0.0004)
            c, s = np.cos(kappa), np.sin(kappa)
            Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
            cur = cur.copy()
            cur[:3, 3] += Rz @ d * (1.0 + rng.normal(0.0, 0.01))
            cur[:3, :3] = Rz @ R0
        lost_before = not has_pose[i]
        odom[i] = cur.astype(np.float32)
        world[i] = w
    return odom, world


def revisit_truth(stream: Stream, exclusion: int = 50, min_dt: float = 10.0,
                  radius_m: float = 0.8) -> np.ndarray:
    """(N,) bool: a keyframe with an earlier keyframe at the same place,
    more than ``exclusion`` keyframes and ``min_dt`` seconds before it (the
    recall base of the sanity line)."""
    kf = np.nonzero(stream.is_keyframe)[0]
    out = np.zeros(len(stream.xy), bool)
    for n, i in enumerate(kf):
        js = kf[: max(n - exclusion, 0)]
        js = js[stream.stamps[i] - stream.stamps[js] > min_dt]
        if len(js):
            out[i] = bool((np.linalg.norm(stream.xy[js] - stream.xy[i], axis=1) < radius_m).any())
    return out


def check_first_visit(stream: Stream, frames, exclusion: int, footprint: tuple):
    """Refuse a first-visit mix where a keyframe among ``frames`` sees
    ground that a keyframe more than ``exclusion`` keyframes before it saw.
    ``footprint`` is the ground both cameras see, (x_min, x_max, y_min,
    y_max) from the camera; the rig never turns, so two footprints overlap
    where the positions lie closer than its width along x and its depth
    along y."""
    span = np.array([footprint[1] - footprint[0], footprint[3] - footprint[2]])
    kf = np.nonzero(stream.is_keyframe)[0]
    order = {int(f): n for n, f in enumerate(kf)}
    xy = stream.xy[kf].astype(np.float64)
    for f in (int(f) for f in frames if stream.is_keyframe[f]):
        n = order[f]
        if n <= exclusion:
            continue
        d = np.abs(xy[: n - exclusion] - xy[n])
        seen = np.nonzero((d < span).all(axis=1))[0]
        if len(seen):
            j = int(seen[-1])
            raise ValueError(f"a first-visit mix sees ground twice: keyframe {f} lies {d[j, 0]:.2f} m along x "
                             f"and {d[j, 1]:.2f} m along y from keyframe {int(kf[j])}, {n - j} keyframes "
                             f"before it, so their {span[0]:.2f} x {span[1]:.2f} m footprints overlap "
                             f"(beyond {exclusion} keyframes)")
