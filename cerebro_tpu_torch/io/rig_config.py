"""OpenCV-yaml rig config front-end (counterpart of
cerebro_tpu/io/rig_config.py; pure Python and numpy).

The reference node boots entirely from VINS-Fusion-style opencv-yaml config
files: the main rig yaml names the camera calib yamls (resolved relative to
the config file, ref src/cerebro_node.cpp:128-135,241-246) and the stereo
extrinsic, either as a separate ``extrinsic_1_T_0`` yaml whose translation
is in **millimetres** (divided by 1000 at src/cerebro_node.cpp:355) or
derived as ``inv(body_T_cam1) @ body_T_cam0`` from the two body-to-camera
matrices (src/cerebro_node.cpp:277-307). This module parses that exact
format (a tiny, dependency-free subset parser — the files use only scalars,
2-level maps, ``!!opencv-matrix`` nodes and flow sequences) and builds the
framework's typed rig: two ``CameraParams`` + ``c1_T_c0``.

Camera yamls are camodocal format (ref
src/utils/camodocal/src/camera_models/CameraFactory.cc:96-160): PINHOLE /
MEI / KANNALA_BRANDT / SCARAMUZZA, dispatched by ``model_type``.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np

from cerebro_tpu_torch.geometry import cameras


# ---------------------------------------------------------------------------
# Minimal opencv-yaml parser
# ---------------------------------------------------------------------------


def _scalar(tok: str):
    tok = tok.strip()
    if tok.startswith('"') and tok.endswith('"') and len(tok) >= 2:
        return tok[1:-1]
    if tok.startswith("'") and tok.endswith("'") and len(tok) >= 2:
        return tok[1:-1]
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok


def _strip_comment(line: str) -> str:
    """Remove a trailing comment (files never put '#' inside quoted values
    except in full-line comments, which are dropped earlier)."""
    q = None
    for i, ch in enumerate(line):
        if q:
            if ch == q:
                q = None
        elif ch in "\"'":
            q = ch
        elif ch == "#":
            return line[:i]
    return line


def parse_opencv_yaml(text: str) -> Dict:
    """Parse the opencv-yaml subset used by the reference's config files.

    Supports: ``%YAML`` header, ``---`` document marker, comments, nested
    maps by indentation, ``!!opencv-matrix`` nodes (rows/cols/dt/data ->
    numpy array), and flow sequences ``[..]`` spanning multiple lines."""
    # 1. normalize to (indent, key, value) entries
    lines = []
    raw = text.splitlines()
    i = 0
    while i < len(raw):
        line = raw[i]
        i += 1
        if line.strip().startswith("%YAML") or line.strip() == "---":
            continue
        line = _strip_comment(line)
        if not line.strip():
            continue
        m = re.match(r"^(\s*)([A-Za-z0-9_\-]+)\s*:\s*(.*)$", line)
        if not m:
            continue  # stray content (opencv writes nothing else)
        indent, key, val = len(m.group(1)), m.group(2), m.group(3).strip()
        # flow sequence possibly spanning lines
        if val.startswith("[") and val.count("[") > val.count("]"):
            while i < len(raw) and val.count("[") > val.count("]"):
                val += " " + _strip_comment(raw[i]).strip()
                i += 1
        lines.append((indent, key, val))

    # 2. recursive descent over the indentation structure
    def build(start: int, indent: int) -> Tuple[Dict, int]:
        out: Dict = {}
        k = start
        while k < len(lines):
            ind, key, val = lines[k]
            if ind != indent:
                break
            if val == "" or val.startswith("!!"):
                # mapping node (possibly tagged !!opencv-matrix)
                if k + 1 < len(lines) and lines[k + 1][0] > ind:
                    sub, k = build(k + 1, lines[k + 1][0])
                else:
                    sub, k = {}, k + 1
                if val.startswith("!!opencv-matrix"):
                    sub = _to_matrix(sub)
                out[key] = sub
            elif val.startswith("["):
                items = [t for t in re.split(r"[,\[\]]", val) if t.strip()]
                out[key] = [_scalar(t) for t in items]
                k += 1
            else:
                out[key] = _scalar(val)
                k += 1
        return out, k

    def _to_matrix(sub: Dict) -> np.ndarray:
        rows, cols = int(sub["rows"]), int(sub["cols"])
        data = np.asarray(sub["data"], np.float64)
        return data.reshape(rows, cols)

    tree, _ = build(0, min((ind for ind, _, _ in lines), default=0))
    return tree


# ---------------------------------------------------------------------------
# Rig construction (cerebro_node main() [B.1-B.3] equivalent)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RigSpec:
    """Everything the node wiring extracted from the config tree."""

    cam0: cameras.CameraParams
    cam1: Optional[cameras.CameraParams]
    c1_T_c0: Optional[np.ndarray]  # (4,4) float64, metres
    image_hw: Tuple[int, int]
    raw: Dict  # full parsed tree (topics, rates, solver knobs...)


def load_camera_yaml(path: str) -> cameras.CameraParams:
    """camodocal CameraFactory::generateCameraFromYamlFile equivalent."""
    with open(path) as f:
        tree = parse_opencv_yaml(f.read())
    return cameras.from_yaml_dict(tree)


def _quat_xyzw_t_to_mat(qx, qy, qz, qw, t: np.ndarray) -> np.ndarray:
    """Host-side float64 quaternion -> SE(3) (same formula as
    geometry.se3.quat_to_rot, kept in numpy for full precision)."""
    q = np.asarray([qw, qx, qy, qz], np.float64)
    w, x, y, z = q / np.linalg.norm(q)
    R = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float64,
    )
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def load_rig_config(config_path: str) -> RigSpec:
    """Build the rig exactly like the reference node's main():

    - ``cam0_calib``/``cam1_calib`` resolved relative to the config file
      (ref src/cerebro_node.cpp:128-135,241-246);
    - ``extrinsic_1_T_0`` yaml: quaternion + translation **in mm**, divided
      by 1000 (ref :331-373, mm rule :355);
    - else derived from ``body_T_cam0``/``body_T_cam1`` as
      ``inv(body_T_cam1) @ body_T_cam0`` (ref :277-307).
    """
    with open(config_path) as f:
        tree = parse_opencv_yaml(f.read())
    base = os.path.dirname(os.path.abspath(config_path))

    cam0 = cam1 = None
    if isinstance(tree.get("cam0_calib"), str):
        cam0 = load_camera_yaml(os.path.join(base, tree["cam0_calib"]))
    if isinstance(tree.get("cam1_calib"), str) and int(tree.get("num_of_cam", 2)) >= 2:
        cam1 = load_camera_yaml(os.path.join(base, tree["cam1_calib"]))
    if cam0 is None:
        raise ValueError(f"config {config_path!r} names no cam0_calib")

    c1_T_c0 = None
    ext = tree.get("extrinsic_1_T_0")
    if isinstance(ext, str):
        with open(os.path.join(base, ext)) as f:
            etree = parse_opencv_yaml(f.read())
        n = etree["transform"]
        t_mm = np.asarray([n["t_x"], n["t_y"], n["t_z"]], np.float64)
        # the reference assumes translations in this file are millimetres
        # (src/cerebro_node.cpp:355 `tr_xyz/1000.`)
        c1_T_c0 = _quat_xyzw_t_to_mat(
            n["q_x"], n["q_y"], n["q_z"], n["q_w"], t_mm / 1000.0
        )
    elif "body_T_cam0" in tree and "body_T_cam1" in tree:
        b_T_c0 = np.asarray(tree["body_T_cam0"], np.float64)
        b_T_c1 = np.asarray(tree["body_T_cam1"], np.float64)
        c1_T_c0 = np.linalg.inv(b_T_c1) @ b_T_c0

    h = int(tree.get("image_height", cam0.height))
    w = int(tree.get("image_width", cam0.width))
    return RigSpec(cam0=cam0, cam1=cam1, c1_T_c0=c1_T_c0, image_hw=(h, w), raw=tree)
