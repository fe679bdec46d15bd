"""Native C++ host-runtime library: correctness vs Python fallbacks."""

import os
import time

import numpy as np
import pytest

from orbslam2_tpu.utils import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable (no toolchain)"
)


def make_voc_text(tmp_path, n_nodes=500, k=5, seed=0):
    rng = np.random.default_rng(seed)
    lines = [f"{k} 3 0 0"]
    descs, parents, leaves, weights = [], [], [], []
    for i in range(n_nodes):
        parent = int(rng.integers(0, max(i, 1)))
        leaf = int(rng.uniform() > 0.5)
        d = rng.integers(0, 256, 32)
        w = float(rng.uniform(0, 1))
        parents.append(parent)
        leaves.append(leaf)
        descs.append(d)
        weights.append(w)
        lines.append(
            f"{parent} {leaf} " + " ".join(str(int(x)) for x in d)
            + f" {w:.6f}"
        )
    p = tmp_path / "voc.txt"
    p.write_text("\n".join(lines) + "\n")
    return str(p), parents, leaves, np.stack(descs), weights


class TestOrbvocScale:
    @pytest.mark.slow
    def test_orbvoc_scale_parse_and_sparse_db(self, tmp_path):
        """ORBvoc-class vocabulary end-to-end: generate a
        complete k=8/L=6 tree (262144 words — past the dense-database
        threshold), parse it through the native streaming parser, and run
        the sparse (inverted-file-as-gather) KeyframeDatabase path on it."""
        import jax.numpy as jnp

        from orbslam2_tpu.models import map_state as ms
        from orbslam2_tpu.models.kf_database import KeyframeDatabase
        from orbslam2_tpu.utils.vocab import load_orbvoc_text

        k, L = 8, 6
        rng = np.random.default_rng(0)
        parents, is_leaf = [], []
        level_start = {0: 0}  # level -> id of first node at that level
        next_id = 1
        for lvl in range(1, L + 1):
            n_lvl = k ** lvl
            level_start[lvl] = next_id
            prev_start = level_start[lvl - 1]
            j = np.arange(n_lvl)
            parents.append(prev_start + j // k)
            is_leaf.append(np.full(n_lvl, lvl == L, bool))
            next_id += n_lvl
        parents = np.concatenate(parents)
        is_leaf = np.concatenate(is_leaf)
        n_lines = len(parents)
        descs = rng.integers(0, 256, (n_lines, 32))
        weights = np.where(is_leaf, rng.uniform(0.1, 1.0, n_lines), 0.0)

        cols = np.column_stack(
            [parents, is_leaf.astype(np.int64), descs,
             (weights * 1e6).astype(np.int64)]
        )
        body = "\n".join(
            " ".join(map(str, row[:-1])) + f" {row[-1] / 1e6:.6f}"
            for row in cols.tolist()
        )
        p = tmp_path / "bigvoc.txt"
        p.write_text(f"{k} {L} 0 0\n" + body + "\n")
        assert p.stat().st_size > 20_000_000  # genuinely ORBvoc-class

        t0 = time.time()
        vocab = load_orbvoc_text(str(p))
        parse_s = time.time() - t0
        assert vocab.n_words == k ** L
        assert parse_s < 60, f"parse took {parse_s:.1f}s"

        db = KeyframeDatabase(vocab, 8, feat_capacity=512)
        assert db.sparse, "262144 words must select the sparse path"
        m = ms.make_empty_map(8, 64, 300)
        m = m._replace(kf_valid=jnp.ones(8, bool), n_kf=jnp.int32(4))
        kf_desc = {}
        for kf in range(4):
            d = rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint32)
            kf_desc[kf] = d
            db.add_keyframe(kf, jnp.asarray(d), jnp.ones(300, bool))
        # Self-query must rank itself first through the sparse scorer.
        ids = db.detect_relocalization_candidates(
            m, jnp.asarray(kf_desc[2]), jnp.ones(300, bool), n_candidates=2
        )
        assert len(ids) >= 1 and ids[0] == 2, ids


class TestNativeParsers:
    def test_orbvoc_matches_reference_data(self, tmp_path):
        path, parents, leaves, descs, weights = make_voc_text(tmp_path)
        out = native.parse_orbvoc_fast(path)
        assert out is not None
        header, p_a, l_a, d_a, w_a = out
        assert header[0] == 5 and header[1] == 3
        assert len(p_a) == len(parents)
        np.testing.assert_array_equal(p_a, parents)
        np.testing.assert_array_equal(l_a, np.asarray(leaves, bool))
        np.testing.assert_array_equal(d_a, descs)
        # weights were written with 6 decimals; compare at text precision
        np.testing.assert_allclose(w_a, weights, atol=5e-7)

    def test_float_table(self, tmp_path):
        p = tmp_path / "times.txt"
        p.write_text("# comment line\n0.0 1.5\n2.5\n3.75 nonnumeric 4.0\n")
        out = native.parse_float_table_fast(str(p))
        np.testing.assert_allclose(out, [0.0, 1.5, 2.5, 3.75, 4.0])

    def test_pgm_decode(self, tmp_path):
        rng = np.random.default_rng(0)
        img = rng.integers(0, 256, (48, 64), dtype=np.uint8)
        p = tmp_path / "img.pgm"
        with open(p, "wb") as f:
            f.write(b"P5\n# comment\n64 48\n255\n")
            f.write(img.tobytes())
        out = native.decode_pgm_fast(str(p))
        assert out is not None and out.shape == (48, 64)
        np.testing.assert_array_equal(out.astype(np.uint8), img)

    def test_vocab_loader_uses_native(self, tmp_path):
        from orbslam2_tpu.utils.vocab import load_orbvoc_text

        path, *_ = make_voc_text(tmp_path, n_nodes=300, k=4)
        v = load_orbvoc_text(path)
        assert v.n_words > 0
        assert v.node_desc.shape[0] == 301

    def test_native_parse_speed(self, tmp_path):
        # Not a strict perf gate — just assert the native path isn't slower
        # than the Python fallback on a mid-size file.
        path, *_ = make_voc_text(tmp_path, n_nodes=4000, k=8)
        t0 = time.perf_counter()
        native.parse_orbvoc_fast(path)
        t_native = time.perf_counter() - t0

        t0 = time.perf_counter()
        with open(path) as f:
            f.readline()
            for line in f:
                parts = line.split()
                _ = [int(x) for x in parts[2:34]]
        t_python = time.perf_counter() - t0
        assert t_native < t_python, (t_native, t_python)
