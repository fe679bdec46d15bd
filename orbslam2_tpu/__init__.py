"""orbslam2_tpu — a JAX visual SLAM framework.

Brand-new JAX/XLA/Pallas re-design of the capabilities of ORB-SLAM2
(reference: yg838457845/ORB_SLAM2-Chinese-annotation, an annotation fork of
raulmur/ORB_SLAM2).  See SURVEY.md for the capability map this implements.

Layers (bottom-up, mirroring SURVEY.md §1's layer map):
  ops/       batched perception kernels (pyramid, FAST, rBRIEF, matching,
             stereo, RANSAC, triangulation, BoW)          [ref L3, L1/DBoW2]
  solvers/   Gauss-Newton/LM estimation engine + Lie ops  [ref L4, L1/g2o]
  models/    map state, frame/keyframe logic, tracking /
             local-mapping / loop-closing pipeline, System facade [ref L2,L5,L6]
  parallel/  device-mesh sharding + distributed BA        [new; ref has none]
  utils/     camera, datasets, trajectory IO, vocabulary  [ref L8, L9]
"""

__version__ = "0.1.0"

import jax as _jax

# Full float32 matmuls for the whole process.  Without this the GPU runs
# float32 matmuls in TF32, which keeps about three decimal digits: fatal
# for pose accuracy in the geometry code (Lie ops, GN/LM normal equations,
# triangulation), and rBRIEF sampling (ops/orb.py) is an exact one-hot
# contraction only in full float32.
_jax.config.update("jax_default_matmul_precision", "highest")

from .config import Settings, OrbSettings, CameraSettings, TpuSettings  # noqa: F401
