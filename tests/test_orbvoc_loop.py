"""ORBvoc-scale vocabulary driving an ACTUAL in-pipeline loop closure.

test_orbvoc_scale.py proves the 10^6-word asset path standalone (parse,
descent, sparse scoring); every loop e2e so far used small trained
vocabularies.  This test runs the RGB-D circular-revisit e2e with a
generated ORBvoc-format vocabulary at true scale (k=10, L=6 — 1,111,110
nodes / 10^6 leaf words), so KeyframeDatabase takes its SPARSE path
(per-keyframe word lists + l1_scores_sparse at 10^6 words,
KeyFrameDatabase.cc:≈90 over TemplatedVocabulary.h:≈1300 scale) for
every detection, and a loop edge must still fire and correct the map.

The tree's internal-node descriptors are synthesized around the SCENE's
real descriptor distribution (leaves = perturbed real descriptors,
parents = means of children) — a structure-preserving stand-in for the
real ORBvoc training corpus, unlike the uniform-random fixture that
suffices for the parser/scoring tests.
"""

import dataclasses

import numpy as np
import pytest

from orbslam2_tpu.config import CameraSettings, OrbSettings, Settings, TpuSettings
from orbslam2_tpu.models.system import Sensor, SlamSystem
from orbslam2_tpu.utils import synthetic


def _scene_scale_vocabulary(train_desc: np.ndarray, seed: int = 0):
    """Build a k=10, L=6 vocabulary (10^6 words) whose leaf descriptors
    cover the scene's descriptor distribution: sample real descriptors
    with replacement and flip a few random bits per leaf; internal nodes
    are majority-votes of their children (the structure hierarchical
    k-means converges to)."""
    from orbslam2_tpu.ops.bow import Vocabulary

    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    k, levels = 10, 6
    counts = [k ** (l + 1) for l in range(levels)]
    n = sum(counts)
    off = np.cumsum([0] + counts[:-1])

    # Unpack training descriptors to bits: (M, 256)
    tr = train_desc.astype(np.uint32)
    bits = ((tr[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(
        np.uint8
    ).reshape(tr.shape[0], 256)

    n_leaves = counts[-1]
    pick = rng.integers(0, bits.shape[0], n_leaves)
    leaf_bits = bits[pick]
    flips = rng.random((n_leaves, 256)) < (6.0 / 256.0)
    leaf_bits = leaf_bits ^ flips.astype(np.uint8)

    node_bits = np.zeros((n + 1, 256), np.uint8)  # slot 0 = root
    node_bits[1 + off[-1]:] = leaf_bits
    # Parents = majority of children, bottom-up.
    for l in range(levels - 2, -1, -1):
        c = counts[l]
        child0 = 1 + off[l + 1]
        ch = node_bits[child0:child0 + counts[l + 1]].reshape(c, k, 256)
        node_bits[1 + off[l]:1 + off[l] + c] = (
            ch.sum(axis=1) >= (k + 1) // 2
        ).astype(np.uint8)

    packed = np.zeros((n + 1, 8), np.uint32)
    for w in range(8):
        chunk = node_bits[:, w * 32:(w + 1) * 32].astype(np.uint32)
        packed[:, w] = (chunk << np.arange(32, dtype=np.uint32)).sum(axis=1)

    # children table: node id -> k child ids (-1 pad); same BFS layout as
    # utils/vocab's converter (root = 0, file nodes 1-based).
    children = np.full((n + 1, k), -1, np.int64)
    children[0] = 1 + np.arange(k)
    for l in range(1, levels):
        parents = 1 + off[l - 1] + np.arange(counts[l - 1])
        ch = (1 + off[l] + np.arange(counts[l])).reshape(counts[l - 1], k)
        children[parents] = ch
    word_id = np.full(n + 1, -1, np.int64)
    word_id[1 + off[-1]:] = np.arange(n_leaves)

    return Vocabulary(
        node_desc=jnp.asarray(packed),
        children=jnp.asarray(children.astype(np.int32)),
        word_id=jnp.asarray(word_id.astype(np.int32)),
        idf=jnp.ones(n_leaves, np.float32),
        levels=levels,
    )


@pytest.mark.slow
def test_rgbd_loop_closure_with_orbvoc_scale_vocab():
    from orbslam2_tpu.models.tracking import TrackState
    from orbslam2_tpu.ops.extractor import OrbExtractor

    s = Settings(
        camera=CameraSettings(
            fx=320.0, fy=320.0, cx=160.0, cy=120.0,
            k1=0, k2=0, p1=0, p2=0, k3=0,
            width=320, height=240, bf=160.0, th_depth=40.0,
            depth_map_factor=1.0,
        ),
        orb=OrbSettings(n_features=800, n_levels=4),
        tpu=TpuSettings(max_keypoints=1024, max_keyframes=96,
                        max_points=8192, min_init_matches=50),
    )
    cam = s.camera_model()
    seq = synthetic.make_loop_sequence(
        cam, n_frames=84, circle_radius=1.5, with_depth=True, seed=5
    )
    ex = OrbExtractor(s.orb, s.tpu)
    descs = np.concatenate([
        (lambda f: np.asarray(f.desc)[np.asarray(f.valid)])(
            ex(seq.images[i])
        )
        for i in range(0, 84, 6)
    ])
    vocab = _scene_scale_vocabulary(descs, seed=0)
    assert int(vocab.n_words) == 10**6

    sys = SlamSystem(s, Sensor.RGBD, vocabulary=vocab,
                     enable_loop_closing=True)
    assert sys.database.sparse, "10^6-word vocab must take the sparse path"
    # Same drift amplification as the small-vocab RGB-D loop e2e: with
    # production accuracy the revisit reconnects through covisibility and
    # no loop is needed (correct but untestable).
    sys.local_mapper.enable_ba = False
    sys.local_mapper.enable_fuse = False
    lost = 0
    for i in range(84):
        sys.track_rgbd(seq.images[i], seq.depths[i], seq.timestamps[i])
        lost += int(sys.tracking_state() == TrackState.LOST)
    sys.shutdown()

    loops = [(a, b) for a, b, _ in sys.loop_closer.loop_edges]
    assert loops, (
        "no loop edge fired through the sparse 10^6-word database; "
        f"metrics: {sys.loop_closer.metrics}"
    )
    n_kf_total = int(np.asarray(sys.map.n_kf))
    a, b = loops[0]
    assert b - a > 0.5 * n_kf_total, (loops, n_kf_total)
    ate = synthetic.ate_rmse(sys.poses_wc(), seq.poses_wc, with_scale=False)
    assert ate < 0.5, f"loop-closed ATE {ate:.3f}"
