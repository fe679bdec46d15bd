"""End-to-end on-disk dataset driver run.

Renders a synthetic sequence to a REAL TUM-layout fixture on disk
(rgb/*.png, 16-bit depth/*.png at DepthMapFactor 5000, rgb.txt,
associations.txt, groundtruth.txt, reference-format settings YAML), then
executes the actual ``examples/run_dataset.py`` entry point as a
subprocess — PNG decode -> association parsing -> track -> trajectory
save (rgbd_tum.cc:≈170 flow; System::SaveTrajectoryTUM ≈270) — and
finally evaluates the WRITTEN trajectory file against the WRITTEN
ground-truth file through ``examples/evaluate.py`` (the external
evaluate_ate.py role, SURVEY.md §4), asserting ATE.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SETTINGS_YAML = """\
%YAML:1.0
Camera.fx: 320.0
Camera.fy: 320.0
Camera.cx: 160.0
Camera.cy: 120.0
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 320
Camera.height: 240
Camera.fps: 30.0
Camera.bf: 32.0
Camera.RGB: 1
ThDepth: 40.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 800
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def _quat_from_rot(R):
    from orbslam2_tpu.models.system import _rot_to_quat

    return _rot_to_quat(R)


@pytest.fixture(scope="module")
def tum_fixture(tmp_path_factory):
    """Write a ~48-frame TUM-format RGB-D sequence to disk."""
    from PIL import Image

    from orbslam2_tpu.config import (
        CameraSettings, OrbSettings, Settings, TpuSettings,
    )
    from orbslam2_tpu.utils import synthetic

    root = tmp_path_factory.mktemp("tum_seq")
    (root / "rgb").mkdir()
    (root / "depth").mkdir()

    s = Settings(
        camera=CameraSettings(
            fx=320.0, fy=320.0, cx=160.0, cy=120.0,
            k1=0, k2=0, p1=0, p2=0, k3=0,
            width=320, height=240, bf=32.0, th_depth=40.0,
            depth_map_factor=5000.0,
        ),
        orb=OrbSettings(n_features=800, n_levels=4),
        tpu=TpuSettings(max_keypoints=1024),
    )
    cam = s.camera_model()
    n = 48
    seq = synthetic.make_sequence(
        cam, n_frames=n, n_points=500, with_depth=True, seed=21,
        radius=0.5, forward=1.2,
    )

    rgb_lines = ["# color images", "# timestamp filename"]
    depth_lines = ["# depth images", "# timestamp filename"]
    assoc_lines = []
    gt_lines = ["# ground truth trajectory",
                "# timestamp tx ty tz qx qy qz qw"]
    for i in range(n):
        ts = 1305031100.0 + i / 30.0
        rgb_name = f"rgb/{ts:.6f}.png"
        depth_name = f"depth/{ts:.6f}.png"
        Image.fromarray(
            np.clip(seq.images[i], 0, 255).astype(np.uint8)
        ).save(root / rgb_name)
        d16 = np.clip(seq.depths[i] * 5000.0, 0, 65535).astype(np.uint16)
        # 16-bit grayscale PNG, the TUM depth encoding.
        Image.fromarray(d16).save(root / depth_name)
        rgb_lines.append(f"{ts:.6f} {rgb_name}")
        depth_lines.append(f"{ts:.6f} {depth_name}")
        assoc_lines.append(f"{ts:.6f} {rgb_name} {ts:.6f} {depth_name}")
        T = seq.poses_wc[i]
        q = _quat_from_rot(T[:3, :3])
        t = T[:3, 3]
        gt_lines.append(
            f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
            f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}"
        )
    (root / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (root / "depth.txt").write_text("\n".join(depth_lines) + "\n")
    (root / "associations.txt").write_text("\n".join(assoc_lines) + "\n")
    (root / "groundtruth.txt").write_text("\n".join(gt_lines) + "\n")
    (root / "settings.yaml").write_text(SETTINGS_YAML)
    return root, seq


@pytest.mark.slow
class TestDatasetDriverE2E:
    def test_rgbd_tum_driver_end_to_end(self, tum_fixture, tmp_path):
        """rgbd_tum flow: decode PNGs -> track -> save -> evaluate."""
        root, seq = tum_fixture
        out = tmp_path / "out"
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"  # tests never take the accelerator
        proc = subprocess.run(
            [sys.executable, os.path.join(REPO, "examples/run_dataset.py"),
             "--dataset", "tum", "--sensor", "rgbd",
             "--path", str(root),
             "--assoc", str(root / "associations.txt"),
             "--settings", str(root / "settings.yaml"),
             "--out", str(out), "--cpu",
             "--gt", str(root / "groundtruth.txt")],
            capture_output=True, text=True, timeout=1800, env=env,
            cwd=REPO,
        )
        assert proc.returncode == 0, (
            f"driver failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}"
        )
        traj = out / "CameraTrajectory.txt"
        kf_traj = out / "KeyFrameTrajectory.txt"
        assert traj.exists() and kf_traj.exists(), proc.stdout[-2000:]
        lines = traj.read_text().strip().split("\n")
        assert len(lines) == 48  # one TUM line per frame
        assert len(lines[0].split()) == 8
        assert len(kf_traj.read_text().strip().split("\n")) >= 2

        # Evaluate the WRITTEN files through examples/evaluate.py (the
        # evaluate_ate.py role) — not via in-memory poses.
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "evaluate", os.path.join(REPO, "examples/evaluate.py")
        )
        ev = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ev)
        res = ev.evaluate_files(
            str(traj), str(root / "groundtruth.txt"), fmt="tum",
            with_scale=False,
        )
        assert res["pairs"] >= 40
        assert res["ate_rmse_m"] < 0.05, res
        # The driver's own --gt evaluation printed the same class of
        # number (sanity that the one-command path ran).
        assert "ATE RMSE" in proc.stdout
