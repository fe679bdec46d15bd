"""Full-ORBvoc-scale vocabulary fixture.

The reference ships a 44 MB ``ORBvoc.txt`` (k=10, L=6, ~1.11M nodes /
1M leaf words; DBoW2 TemplatedVocabulary::loadFromTextFile,
TemplatedVocabulary.h:≈1300) that this sandbox cannot download.  This
test GENERATES an ORBvoc-format file at the true scale and proves the
whole asset path on it:

  * text parser (native C++ streaming parser + Python fallback parity)
  * packed-npz cache round trip
  * batched tree descent (BowTransformer) over a full frame
  * sparse BoW + sparse L1 scoring at 10^6 words
  * memory shape sanity (the packed vocabulary must stay ~100 MB class)
"""
import os
import time

import numpy as np
import pytest

import jax.numpy as jnp


def write_orbvoc_fixture(path: str, k: int = 10, levels: int = 6,
                         seed: int = 0) -> int:
    """Write a k^levels-word ORBvoc.txt-format file (BFS node order;
    parent ids always precede children, as the parser requires).
    Returns the node count (excluding the implicit root)."""
    rng = np.random.default_rng(seed)
    counts = [k ** (l + 1) for l in range(levels)]
    n = sum(counts)  # nodes excluding root
    parent = np.empty(n, np.int64)
    is_leaf = np.zeros(n, np.int64)
    # BFS layout: level l occupies [off[l], off[l] + k^(l+1)).  Node ids in
    # the FILE are 1-based line numbers; the root is implicit id 0.
    off = np.cumsum([0] + counts[:-1])
    for l, c in enumerate(counts):
        ids = np.arange(c)
        if l == 0:
            parent[off[l]:off[l] + c] = 0
        else:
            parent[off[l]:off[l] + c] = off[l - 1] + ids // k + 1
    is_leaf[off[-1]:] = 1
    desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    weight = np.where(is_leaf == 1,
                      rng.uniform(0.5, 2.0, n), 0.0).astype(np.float32)

    # Vectorized text assembly (a Python f-string loop over 1.11M rows
    # takes minutes; np.char column concatenation takes seconds).
    cols = [parent.astype("U7"), is_leaf.astype("U1")]
    cols += [desc[:, j].astype("U3") for j in range(32)]
    cols += [np.char.mod("%.4g", weight)]
    row = cols[0]
    for c in cols[1:]:
        row = np.char.add(np.char.add(row, " "), c)
    with open(path, "w") as f:
        f.write(f"{k} {levels} 0 0\n")
        f.write("\n".join(row.tolist()))
        f.write("\n")
    return n


@pytest.mark.slow
def test_orbvoc_full_scale(tmp_path):
    from orbslam2_tpu.ops.bow import (
        BowTransformer, l1_scores_sparse, sparse_bow,
    )
    from orbslam2_tpu.utils import vocab as vio

    path = str(tmp_path / "ORBvoc_synth.txt")
    t0 = time.time()
    n_nodes = write_orbvoc_fixture(path)
    t_write = time.time() - t0
    size_mb = os.path.getsize(path) / 1e6
    assert n_nodes == 1_111_110
    assert size_mb > 30, f"fixture too small to be ORBvoc-class: {size_mb}"

    t0 = time.time()
    v = vio.load_orbvoc_text(path)
    t_parse = time.time() - t0
    assert v.n_words == 1_000_000
    assert v.levels == 6
    assert v.node_desc.shape == (1_111_111, 8)
    assert v.children.shape[1] == 10
    # Memory class: packed descs 8*4 B/node + children 40 B/node ~ 80 MB.
    n_bytes = (v.node_desc.nbytes + v.children.nbytes + v.word_id.nbytes
               + v.idf.nbytes)
    assert n_bytes < 200e6, n_bytes
    # The reference's text load takes ~10-20 s (System.cc:≈55); ours must
    # be in that class or better even on this sandbox CPU.
    assert t_parse < 120, f"parse took {t_parse:.0f}s"

    # npz cache round trip.
    npz = str(tmp_path / "voc.npz")
    vio.save_vocabulary(v, npz)
    v2 = vio.load_vocabulary(npz)
    assert np.array_equal(np.asarray(v2.node_desc), np.asarray(v.node_desc))
    assert np.array_equal(np.asarray(v2.children), np.asarray(v.children))

    # Batched descent of one frame (1024 features) to leaf words.
    rng = np.random.default_rng(7)
    desc_b = rng.integers(0, 2**32, (1024, 8), dtype=np.uint32)
    tr = BowTransformer(v)
    bow_is_dense_banned = v.n_words >= 10**6  # dense rows are 4 MB each
    words, nodes = None, None
    t0 = time.time()
    _, words, nodes = tr(jnp.asarray(desc_b), jnp.ones(1024, bool))
    words = np.asarray(words)
    t_desc = time.time() - t0
    assert words.shape == (1024,)
    assert (words >= 0).all() and (words < 10**6).all()
    assert bow_is_dense_banned

    # Sparse scoring at 10^6 words: a frame scored against a 64-frame
    # database, plus self-similarity sanity (score(x, x) == 1).
    qw, qwt = sparse_bow(jnp.asarray(words), v.idf, v.n_words)
    db_words = np.tile(np.asarray(qw), (64, 1))
    db_weights = np.tile(np.asarray(qwt), (64, 1))
    scores = np.asarray(l1_scores_sparse(
        qw, qwt, jnp.asarray(db_words), jnp.asarray(db_weights),
        v.n_words,
    ))
    np.testing.assert_allclose(scores, 1.0, atol=1e-4)
    # Different random frame scores well below self-similarity.
    desc_c = rng.integers(0, 2**32, (1024, 8), dtype=np.uint32)
    _, words_c, _ = tr(jnp.asarray(desc_c), jnp.ones(1024, bool))
    cw, cwt = sparse_bow(words_c, v.idf, v.n_words)
    cross = float(np.asarray(l1_scores_sparse(
        cw, cwt, jnp.asarray(db_words[:1]), jnp.asarray(db_weights[:1]),
        v.n_words,
    ))[0])
    assert cross < 0.5, cross

    print(f"fixture {size_mb:.0f} MB write={t_write:.1f}s "
          f"parse={t_parse:.1f}s descend={t_desc:.2f}s cross={cross:.3f}")
