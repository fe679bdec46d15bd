"""Live-stream drivers — the ROS-node layer's JAX equivalent.

The reference ships ROS nodes (Examples/ROS/ORB_SLAM2/src/ros_mono.cc,
ros_stereo.cc, ros_rgbd.cc — SURVEY.md §2.4) that subscribe to image
topics and feed System::Track* from callbacks; rgbd/stereo pairs are
aligned with message_filters::ApproximateTime, and the stereo node
optionally rectifies online.

This module provides the same capability without ROS:

* ``ApproxTimeSync`` — pairs two asynchronous timestamped streams within a
  slop window (the ApproximateTime policy's core behavior: emit the
  closest-in-time pair, drop stale unmatched messages).
* ``LiveDriver`` — callback-style entry points (``feed_mono``,
  ``feed_stereo_left/right``, ``feed_rgb``/``feed_depth``) that drive a
  ``SlamSystem``; optional online rectification maps (EuRoC-style) are
  applied before tracking, mirroring ros_stereo.cc's do_rectify path.

The driver runs tracking in the caller's thread exactly as the reference
runs it in the ROS spinner thread; swap in any transport (socket, shared
memory, camera SDK) by calling the feed methods from its callback.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Optional

import numpy as np


class ApproxTimeSync:
    """Pair two timestamped streams (message_filters::ApproximateTime).

    Buffers per-stream messages and emits (a, b) pairs whose timestamps
    differ by at most ``slop`` seconds, always matching each message with
    the closest candidate; older unmatched messages are dropped once a
    newer pair forms (queue_size bounds memory like the ROS policy).
    """

    def __init__(self, slop: float = 0.02, queue_size: int = 10,
                 callback: Optional[Callable] = None):
        self.slop = float(slop)
        self.queue_size = int(queue_size)
        self.callback = callback
        self._qa: deque = deque()
        self._qb: deque = deque()
        self.dropped = 0

    def put_a(self, t: float, payload):
        self._qa.append((float(t), payload))
        return self._drain()

    def put_b(self, t: float, payload):
        self._qb.append((float(t), payload))
        return self._drain()

    def _drain(self):
        emitted = []
        while self._qa and self._qb:
            ta, _ = self._qa[0]
            tb, _ = self._qb[0]
            if abs(ta - tb) <= self.slop:
                # Candidate pair; see if the next message on either side is
                # closer (ApproximateTime optimality within the queue).
                if len(self._qa) > 1 and abs(self._qa[1][0] - tb) < abs(ta - tb):
                    self._qa.popleft()
                    self.dropped += 1
                    continue
                if len(self._qb) > 1 and abs(self._qb[1][0] - ta) < abs(ta - tb):
                    self._qb.popleft()
                    self.dropped += 1
                    continue
                a = self._qa.popleft()
                b = self._qb.popleft()
                pair = (max(a[0], b[0]), a[1], b[1])
                emitted.append(pair)
                if self.callback is not None:
                    self.callback(*pair)
            elif ta < tb:
                self._qa.popleft()
                self.dropped += 1
            else:
                self._qb.popleft()
                self.dropped += 1
        while len(self._qa) > self.queue_size:
            self._qa.popleft()
            self.dropped += 1
        while len(self._qb) > self.queue_size:
            self._qb.popleft()
            self.dropped += 1
        return emitted


class LiveDriver:
    """Callback-style live front door over a ``SlamSystem``.

    sensor: "mono" | "stereo" | "rgbd".
    rectify: optional (map_left, map_right) pyfuncs applied to stereo pairs
      before tracking (utils/camera rectification maps — the ros_stereo.cc
      do_rectify path).  For rgbd, ``depth_scale`` mirrors DepthMapFactor.
    """

    def __init__(self, system, sensor: str, slop: float = 0.02,
                 rectify=None):
        if sensor not in ("mono", "stereo", "rgbd"):
            raise ValueError(f"unknown sensor {sensor!r}")
        self.system = system
        self.sensor = sensor
        self.rectify = rectify
        self.frames = 0
        if sensor == "stereo":
            self._sync = ApproxTimeSync(slop, callback=self._on_stereo)
        elif sensor == "rgbd":
            self._sync = ApproxTimeSync(slop, callback=self._on_rgbd)
        else:
            self._sync = None

    # -- feed entry points (the "topic callbacks") --------------------------

    def feed_mono(self, image, t: float):
        assert self.sensor == "mono"
        self.system.track_monocular(np.asarray(image), t)
        self.frames += 1

    def feed_stereo_left(self, image, t: float):
        assert self.sensor == "stereo"
        self._sync.put_a(t, np.asarray(image))

    def feed_stereo_right(self, image, t: float):
        assert self.sensor == "stereo"
        self._sync.put_b(t, np.asarray(image))

    def feed_rgb(self, image, t: float):
        assert self.sensor == "rgbd"
        self._sync.put_a(t, np.asarray(image))

    def feed_depth(self, depth, t: float):
        assert self.sensor == "rgbd"
        self._sync.put_b(t, np.asarray(depth))

    # -- synced pair handlers ------------------------------------------------

    def _on_stereo(self, t, left, right):
        if self.rectify is not None:
            ml, mr = self.rectify
            left, right = ml(left), mr(right)
        self.system.track_stereo(left, right, t)
        self.frames += 1

    def _on_rgbd(self, t, rgb, depth):
        self.system.track_rgbd(rgb, depth, t)
        self.frames += 1

    # -- lifecycle -----------------------------------------------------------

    @property
    def dropped(self) -> int:
        return self._sync.dropped if self._sync else 0

    def shutdown(self, trajectory_path: Optional[str] = None):
        """Flush in-flight frames; optionally save the TUM trajectory
        (the ROS nodes save KeyFrameTrajectory on shutdown)."""
        self.system.tracker.flush()
        if trajectory_path:
            self.system.save_keyframe_trajectory_tum(trajectory_path)
