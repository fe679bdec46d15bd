"""Settings / configuration.

Drop-in compatible with the reference's OpenCV-YAML settings files
(``Examples/**/*.yaml``, parsed by cv::FileStorage in the Tracking ctor —
src/Tracking.cc:≈55-170).  We parse the same ``%YAML:1.0`` files with the
same keys (``Camera.fx`` … ``ORBextractor.nFeatures`` … ``ThDepth`` …) plus
extensions under ``Tpu.*`` (feature capacity, map capacity, mesh shape;
the key names predate the GPU port).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional

import numpy as np


# ---------------------------------------------------------------------------
# OpenCV-YAML parsing (cv::FileStorage subset: scalars + opencv-matrix nodes)
# ---------------------------------------------------------------------------


def load_opencv_yaml(path_or_text: str) -> Dict[str, object]:
    """Parse the cv::FileStorage YAML subset the reference configs use.

    Handles ``%YAML:1.0`` headers, ``Key.Sub: value`` scalar lines, and
    ``!!opencv-matrix`` nodes with rows/cols/dt/data (used by the EuRoC stereo
    yaml's LEFT.*/RIGHT.* rectification blocks, Examples/Stereo/EuRoC.yaml).
    """
    if "\n" in path_or_text:
        text = path_or_text
    else:
        with open(path_or_text, "r") as f:
            text = f.read()

    out: Dict[str, object] = {}
    lines = text.split("\n")
    i = 0
    while i < len(lines):
        line = lines[i]
        i += 1
        s = line.split("#", 1)[0].rstrip()
        if not s or s.startswith("%YAML") or s.startswith("---"):
            continue
        m = re.match(r"^([A-Za-z0-9_.]+):\s*(.*)$", s.strip())
        if not m:
            continue
        key, val = m.group(1), m.group(2).strip()
        if val.startswith("!!opencv-matrix") or val == "":
            # Multi-line matrix node: collect rows/cols/dt/data.
            node: Dict[str, object] = {}
            data_items: List[float] = []
            in_data = False
            while i < len(lines):
                sub = lines[i].split("#", 1)[0].rstrip()
                if not sub.strip():
                    i += 1
                    continue
                if not (lines[i].startswith(" ") or lines[i].startswith("\t")):
                    break
                i += 1
                subs = sub.strip()
                dm = re.match(r"^(rows|cols):\s*(\d+)$", subs)
                if dm:
                    node[dm.group(1)] = int(dm.group(2))
                    continue
                if subs.startswith("dt:"):
                    continue
                if subs.startswith("data:"):
                    in_data = True
                    subs = subs[len("data:"):].strip()
                if in_data:
                    nums = re.findall(r"[-+0-9.eE]+", subs)
                    data_items.extend(float(x) for x in nums)
                    if "]" in subs:
                        in_data = False
            rows = int(node.get("rows", 0))
            cols = int(node.get("cols", 0))
            if rows and cols and len(data_items) >= rows * cols:
                out[key] = np.array(data_items[: rows * cols], np.float64).reshape(rows, cols)
            continue
        # Scalar
        try:
            out[key] = int(val)
        except ValueError:
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val.strip('"')
    return out


# ---------------------------------------------------------------------------
# Typed settings
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OrbSettings:
    """ORBextractor.* keys (defaults = reference TUM1.yaml values)."""

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    # NOTE: the reference's iniThFAST(=20)/minThFAST(=7) two-pass cell
    # retry (ORBextractor.cc:≈790: FAST at iniThFAST, retry the cell at
    # minThFAST when empty) is subsumed here by threshold-free score
    # ranking: every cell keeps its top-scoring corners above minThFAST,
    # which is exactly the retry's fixed point.  Only min_th_fast remains
    # a knob; ORBextractor.iniThFAST in reference YAMLs parses and is
    # ignored.
    min_th_fast: int = 7


@dataclasses.dataclass(frozen=True)
class CameraSettings:
    fx: float = 517.306408
    fy: float = 516.469215
    cx: float = 318.643040
    cy: float = 255.313989
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 640
    height: int = 480
    fps: float = 30.0
    bf: float = 0.0
    rgb: int = 1
    th_depth: float = 40.0
    depth_map_factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class TpuSettings:
    """Capacities + mesh config (no analog in the reference; ours are the
    fixed static shapes that replace its dynamic allocation)."""

    max_keypoints: int = 1024          # per-frame feature capacity (padded)
    max_keyframes: int = 512           # map keyframe pool
    max_points: int = 32768            # map landmark pool
    max_obs_per_point: int = 16        # padded observation slots per landmark
    local_window: int = 80             # TrackLocalMap KF cap (Tracking.cc:≈1190)
    # Back-end association windows (reference scale by default; each is an
    # UPPER CAP — the compiled window is bucketed to the map's current size
    # so small maps never pay the padded worst case):
    ba_local_window: int = 32          # local BA free cams (Optimizer.cc:≈460
                                       # frees ALL covisibles; capped here)
    ba_fixed_window: int = 16          # local BA fixed observer ring
    tri_neighbors_mono: int = 20       # triangulation neighbors, mono
    tri_neighbors_stereo: int = 10     # (LocalMapping.cc:≈190: 20 / 10)
    fuse_first_neighbors: int = 10     # SearchInNeighbors 1st-order KFs
    fuse_second_neighbors: int = 5     # + 2nd-order (LocalMapping.cc:≈370)
    ransac_iters: int = 256            # batched hypothesis count
    min_init_matches: int = 100        # mono-init match gate (Tracking.cc:≈600)
    # Keyframe-cadence policy (NeedNewKeyFrame, Tracking.cc:≈980 — the
    # reference's (c1a||c1b||c1c)&&c2 structure):
    kf_max_gap: int = 10               # c1a: mMaxFrames analog (frames)
    kf_busy_frames: int = 2            # c1b: deterministic mapper-occupancy
                                       # model — a mapping job occupies the
                                       # mapper ~this many frames (the
                                       # reference's 60-300 ms LocalMapping
                                       # budget at frame rate); "idle" once
                                       # the gap since the last KF exceeds it
    kf_queue_depth: int = 3            # mlNewKeyFrames queue<3 gate
                                       # (Tracking.cc:≈1050)
    kf_urgent_gap: int = 10            # InterruptBA-class urgent adopt when
                                       # the KF gap reaches this (frames)
    kf_urgent_wait_s: float = 0.15     # grace for the urgent adopt (covers a
                                       # normally-finishing mapping job tail;
                                       # a longer stall only defers the
                                       # keyframe further)
    mesh_shape: tuple = (1,)           # device mesh ("map" axis)
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class Settings:
    camera: CameraSettings = dataclasses.field(default_factory=CameraSettings)
    orb: OrbSettings = dataclasses.field(default_factory=OrbSettings)
    tpu: TpuSettings = dataclasses.field(default_factory=TpuSettings)
    sensor: str = "mono"  # mono | stereo | rgbd
    rectification: Optional[dict] = None  # LEFT./RIGHT. K,D,R,P for EuRoC

    @staticmethod
    def from_yaml(path_or_text: str, sensor: str = "mono") -> "Settings":
        d = load_opencv_yaml(path_or_text)

        def g(key, default):
            return d.get(key, default)

        cam = CameraSettings(
            fx=float(g("Camera.fx", 517.3)), fy=float(g("Camera.fy", 516.5)),
            cx=float(g("Camera.cx", 318.6)), cy=float(g("Camera.cy", 255.3)),
            k1=float(g("Camera.k1", 0.0)), k2=float(g("Camera.k2", 0.0)),
            p1=float(g("Camera.p1", 0.0)), p2=float(g("Camera.p2", 0.0)),
            k3=float(g("Camera.k3", 0.0)),
            width=int(g("Camera.width", 640)), height=int(g("Camera.height", 480)),
            fps=float(g("Camera.fps", 30.0)), bf=float(g("Camera.bf", 0.0)),
            rgb=int(g("Camera.RGB", 1)),
            th_depth=float(g("ThDepth", 40.0)),
            depth_map_factor=float(g("DepthMapFactor", 1.0)),
        )
        orb = OrbSettings(
            n_features=int(g("ORBextractor.nFeatures", 1000)),
            scale_factor=float(g("ORBextractor.scaleFactor", 1.2)),
            n_levels=int(g("ORBextractor.nLevels", 8)),
            min_th_fast=int(g("ORBextractor.minThFAST", 7)),
        )
        # Feature capacity: next pow2 >= nFeatures (padded static shape).
        cap = 1
        while cap < orb.n_features:
            cap *= 2
        tpu = TpuSettings(
            max_keypoints=int(g("Tpu.maxKeypoints", cap)),
            max_keyframes=int(g("Tpu.maxKeyFrames", 512)),
            max_points=int(g("Tpu.maxPoints", 32768)),
        )
        rect = None
        if "LEFT.K" in d:
            rect = {k: v for k, v in d.items() if k.startswith(("LEFT.", "RIGHT."))}
        return Settings(camera=cam, orb=orb, tpu=tpu, sensor=sensor, rectification=rect)

    def camera_model(self):
        from .utils.camera import make_camera

        c = self.camera
        return make_camera(
            c.fx, c.fy, c.cx, c.cy,
            dist=np.array([c.k1, c.k2, c.p1, c.p2, c.k3], np.float32),
            bf=c.bf, width=c.width, height=c.height,
        )
