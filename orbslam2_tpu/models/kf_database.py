"""Keyframe place-recognition database.

JAX equivalent of ``KeyFrameDatabase`` (src/KeyFrameDatabase.cc,
SURVEY.md §2.1): the inverted file over vocabulary words becomes either

  * a dense (K, W) BoW matrix with one-reduction L1 scoring (small/medium
    vocabularies, W <= _DENSE_MAX_WORDS), or
  * a sparse per-keyframe word list scored with ops/bow.l1_scores_sparse
    (one dense query row + gathers) — the inverted-file access pattern as
    a gather kernel, feasible at the 10^6-word ORBvoc scale.

DetectLoopCandidates / DetectRelocalizationCandidates implement the
reference's FULL candidate logic (KeyFrameDatabase.cc:≈90-200):

  1. common-word prefilter: count shared vocabulary words per keyframe,
     keep those with > 0.8 * maxCommonWords;
  2. L1-score gate (loop: >= minScore among the query's covisibles);
  3. covisibility-group ACCUMULATED score: each candidate's score plus the
     scores of its top-10 covisible keyframes that are also shortlisted —
     the anti-perceptual-aliasing mechanism (a true revisit is corroborated
     by its neighborhood, a lone aliased match is not);
  4. keep each group's best keyframe, cut at 0.75 * bestAccScore.

The database also stores each keyframe's FEATURE NODE ids (the DBoW2
FeatureVector): matchers use them to gate candidate pairs (node-gated
SearchByBoW, src/ORBmatcher.cc:≈250).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import bow as bow_mod
from . import map_state as ms

_DENSE_MAX_WORDS = 1 << 17  # beyond this, dense (K, W) rows are wasteful
_MAX_SHORTLIST = 16         # candidates entering group accumulation


@functools.partial(jax.jit, static_argnames=("n_top",))
def _grouped_acc_scores(
    m: ms.MapState,
    short_ids: jnp.ndarray,    # (S,) candidate keyframe ids
    short_ok: jnp.ndarray,     # (S,)
    scores: jnp.ndarray,       # (K,) L1 scores (0 where not shortlisted)
    shortlist: jnp.ndarray,    # (K,) bool
    n_top: int = 10,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-candidate accumulated score over its top-10 covisibles that are
    also shortlisted, the best-scoring keyframe of each group, and each
    candidate's full covisibility row (consumers batch-read the rows with
    the scores in ONE device_get — per-candidate row fetches would pay a
    host sync each)."""

    def one(c, ok):
        row = ms.covisible_row(m, c)
        w, ids = jax.lax.top_k(row, min(n_top, int(row.shape[0])))
        in_grp = (w > 0) & shortlist[ids]
        grp_scores = jnp.where(in_grp, scores[ids], 0.0)
        acc = scores[c] + jnp.sum(grp_scores)
        # Best member of the group (candidate itself included).
        best_i = jnp.argmax(jnp.where(in_grp, scores[ids], -1.0))
        best_kf = jnp.where(
            jnp.max(jnp.where(in_grp, scores[ids], -1.0)) > scores[c],
            ids[best_i], c,
        )
        return jnp.where(ok, acc, -1.0), best_kf, row

    return jax.vmap(one)(short_ids, short_ok)


class KeyframeDatabase:
    """Holds per-keyframe BoW state; updated at keyframe insertion."""

    def __init__(self, vocab: bow_mod.Vocabulary, kf_capacity: int,
                 feat_capacity: int = 2048):
        self.vocab = vocab
        self.transformer = bow_mod.BowTransformer(vocab)
        self.sparse = vocab.n_words > _DENSE_MAX_WORDS
        if self.sparse:
            self.db_words = jnp.full(
                (kf_capacity, feat_capacity), -1, jnp.int32
            )
            self.db_weights = jnp.zeros(
                (kf_capacity, feat_capacity), jnp.float32
            )
        else:
            self.bow = jnp.zeros((kf_capacity, vocab.n_words), jnp.float32)
        self.has_entry = jnp.zeros((kf_capacity,), bool)
        self._feat_capacity = feat_capacity
        # Per-keyframe feature node ids (DBoW2 FeatureVector) for node-
        # gated SearchByBoW; allocated on first add (per-slot feature dim).
        self.db_nodes: Optional[jnp.ndarray] = None

    # -- updates -----------------------------------------------------------

    def add_keyframe(self, kf_id: int, desc: jnp.ndarray, valid: jnp.ndarray):
        row, words, nodes = self.transformer(desc, valid)
        if self.sparse:
            sw, swt = bow_mod.sparse_bow(
                words, self.vocab.idf, self.vocab.n_words
            )
            n = sw.shape[0]
            cap = self._feat_capacity
            if n < cap:
                sw = jnp.concatenate([sw, jnp.full(cap - n, -1, jnp.int32)])
                swt = jnp.concatenate([swt, jnp.zeros(cap - n, jnp.float32)])
            self.db_words = self.db_words.at[kf_id].set(sw[:cap])
            self.db_weights = self.db_weights.at[kf_id].set(swt[:cap])
        else:
            self.bow = self.bow.at[kf_id].set(row)
        if self.db_nodes is None:
            self.db_nodes = jnp.full(
                (self.has_entry.shape[0], nodes.shape[0]), -1, jnp.int32
            )
        self.db_nodes = self.db_nodes.at[kf_id].set(
            jnp.where(valid, nodes, -1)
        )
        self.has_entry = self.has_entry.at[kf_id].set(True)
        return words, nodes

    def nodes_for(self, kf_id: int) -> Optional[jnp.ndarray]:
        """(N,) feature node ids of a stored keyframe (-1 invalid), or None
        before any insertion."""
        if self.db_nodes is None:
            return None
        return self.db_nodes[kf_id]

    def frame_nodes(self, desc: jnp.ndarray, valid: jnp.ndarray):
        _, words, nodes = self.transformer(desc, valid)
        return jnp.where(valid, nodes, -1)

    # -- scoring -----------------------------------------------------------

    def _query_row(self, desc: jnp.ndarray, valid: jnp.ndarray):
        row, words, _ = self.transformer(desc, valid)
        return row, words

    def _scores_and_common(self, row, words) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """L1 scores (K,) + common-word counts (K,) for a query row."""
        W = self.vocab.n_words
        qmask = jnp.zeros((W,), jnp.float32).at[
            jnp.where(words >= 0, words, 0)
        ].max(jnp.where(words >= 0, 1.0, 0.0))
        if self.sparse:
            sw, swt = bow_mod.sparse_bow(words, self.vocab.idf, W)
            scores = bow_mod.l1_scores_sparse(
                sw, swt, self.db_words, self.db_weights, W
            )
            hits = qmask[jnp.maximum(self.db_words, 0)] * (
                self.db_words >= 0
            )
            common = jnp.sum(hits, axis=1)
        else:
            scores = bow_mod.l1_scores(row, self.bow)
            common = (self.bow > 0).astype(jnp.float32) @ qmask
        return scores, common

    def _scores(self, desc: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
        row, words = self._query_row(desc, valid)
        scores, _ = self._scores_and_common(row, words)
        return scores

    def _scores_for_kf(self, m: ms.MapState, kf_id: int):
        row, words = self._query_row(
            m.kf_desc[kf_id], m.kf_kp_valid[kf_id]
        )
        return self._scores_and_common(row, words)

    # -- queries (reference candidate logic) -------------------------------

    def _grouped_candidates(
        self,
        m: ms.MapState,
        scores: jnp.ndarray,
        common: jnp.ndarray,
        eligible: jnp.ndarray,
        n_candidates: int,
        extras=None,
    ) -> Tuple[np.ndarray, np.ndarray, dict, object]:
        """Steps 1+3+4 of the reference logic, shared by loop + reloc.

        Returns (ids, acc_scores, covis_groups, extras_host) where
        covis_groups maps a candidate id to the set of keyframe ids
        covisible with it — read
        back in the SAME device_get as the scores so consistency tracking
        costs no extra sync.  ``extras``: optional pytree of device arrays
        piggybacked on that device_get; the host copies are returned as
        the 4th tuple element ``extras_host`` (callers use this to fetch
        pool state without paying another sync)."""
        eligible = eligible & (common > 0)
        max_common = jnp.max(jnp.where(eligible, common, 0.0))
        shortlist = eligible & (common > 0.8 * max_common)
        sl_scores = jnp.where(shortlist, scores, 0.0)
        top_s, short_ids = jax.lax.top_k(
            jnp.where(shortlist, scores, -1.0),
            min(_MAX_SHORTLIST, int(shortlist.shape[0])),
        )
        short_ok = top_s > 0.0
        acc_d, best_kf_d, rows_d = _grouped_acc_scores(
            m, short_ids.astype(jnp.int32), short_ok, sl_scores, shortlist
        )
        # ONE host sync for the whole candidate decision.
        acc, best_kf, rows, sl, extras_host = jax.device_get(
            (acc_d, best_kf_d, rows_d, short_ids, extras)
        )
        if not (acc > 0).any():
            return np.zeros(0, np.int64), np.zeros(0), {}, extras_host
        cut = 0.75 * acc.max()
        keep = acc >= cut
        groups = {
            int(sl[i]): set(np.nonzero(rows[i] > 0)[0].tolist())
            for i in range(len(sl))
        }
        # Dedupe group winners, strongest accumulated score first.
        order = np.argsort(-acc)
        seen, out_ids, out_acc = set(), [], []
        for i in order:
            if not keep[i]:
                continue
            k = int(best_kf[i])
            if k in seen:
                continue
            seen.add(k)
            out_ids.append(k)
            out_acc.append(float(acc[i]))
            if len(out_ids) >= n_candidates:
                break
        # Group winners can collapse to one keyframe on small / heavily
        # covisible maps (every group shares the same best member).  The
        # reference naturally returns several because its groups partition
        # a large graph; here, backfill the remaining slots with the entry
        # keyframes of groups that PASSED the 0.75 accumulated cut (still
        # ranked by accumulated score) so the geometric verifier sees real
        # alternatives — aliased groups below the cut stay excluded.
        if len(out_ids) < n_candidates:
            for i in order:
                if not keep[i]:
                    continue
                k = int(sl[i])
                if k in seen:
                    continue
                seen.add(k)
                out_ids.append(k)
                out_acc.append(float(acc[i]))
                if len(out_ids) >= n_candidates:
                    break
        # Group sets for the winners that came from best_kf rather than the
        # shortlist entry: approximate with the entry keyframe's row (the
        # winner is inside that group by construction).
        for i in order:
            k = int(best_kf[i])
            if k in seen and k not in groups:
                groups[k] = groups.get(int(sl[i]), set())
        return (np.asarray(out_ids, np.int64), np.asarray(out_acc), groups,
                extras_host)

    def detect_loop_candidates(
        self,
        m: ms.MapState,
        kf_id: int,
        n_candidates: int = 3,
        extras=None,
    ) -> Tuple[np.ndarray, np.ndarray, dict, object]:
        """KeyFrameDatabase::DetectLoopCandidates (≈90): common-word
        prefilter, covisible exclusion, min-score gate, covisibility-group
        accumulated scoring with the 0.75 cut.

        Returns (ids, acc_scores, covis_groups, extras_host) — one host
        sync total."""
        scores, common = self._scores_for_kf(m, kf_id)
        covis_row = ms.covisible_row(m, jnp.int32(kf_id)) > 0
        covis_scores = jnp.where(covis_row & self.has_entry, scores, jnp.inf)
        min_score = jnp.min(covis_scores)
        min_score = jnp.where(jnp.isinf(min_score), 0.0, min_score)

        K = self.has_entry.shape[0]
        eligible = (
            self.has_entry
            & m.kf_valid
            & ~covis_row
            & (jnp.arange(K) != kf_id)
            & (scores >= jnp.maximum(min_score, 1e-9))
        )
        return self._grouped_candidates(
            m, scores, common, eligible, n_candidates, extras=extras
        )

    def detect_relocalization_candidates(
        self,
        m: ms.MapState,
        frame_desc: jnp.ndarray,
        frame_valid: jnp.ndarray,
        n_candidates: int = 8,
    ) -> np.ndarray:
        """KeyFrameDatabase::DetectRelocalizationCandidates (≈200): same
        grouped logic without the covisibility exclusion / min-score gate.

        n_candidates is wider than loop detection's: the reference returns
        EVERY group above the 0.75 cut and lets P4P+pose-opt reject the
        wrong ones (Tracking.cc:≈1310 iterates all candidates); when BoW
        scores are weakly discriminative the geometric verifier is the
        real filter, so give it alternatives."""
        row, words = self._query_row(frame_desc, frame_valid)
        scores, common = self._scores_and_common(row, words)
        eligible = self.has_entry & m.kf_valid & (scores > 0)
        ids, _, _, _ = self._grouped_candidates(
            m, scores, common, eligible, n_candidates
        )
        return ids

    # -- maintenance ---------------------------------------------------------

    def remap(self, kf_new_from_old: np.ndarray):
        """Apply a keyframe-pool compaction (map_state.compact_map): row j of
        the database becomes the row of the old id that moved to slot j;
        rows of dropped keyframes are cleared."""
        K = self.has_entry.shape[0]
        kf_map = np.asarray(kf_new_from_old)
        old_of_new = np.full(K, -1, np.int64)
        kept = np.nonzero(kf_map >= 0)[0]
        old_of_new[kf_map[kept]] = kept
        src = np.maximum(old_of_new, 0)
        live = jnp.asarray(old_of_new >= 0)
        if self.sparse:
            self.db_words = jnp.where(
                live[:, None], self.db_words[src], -1
            )
            self.db_weights = jnp.where(
                live[:, None], self.db_weights[src], 0.0
            )
        else:
            self.bow = jnp.where(live[:, None], self.bow[src], 0.0)
        if self.db_nodes is not None:
            self.db_nodes = jnp.where(live[:, None], self.db_nodes[src], -1)
        self.has_entry = live & self.has_entry[src]

    # -- compat ------------------------------------------------------------

    def frame_bow(self, desc: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
        row, _, _ = self.transformer(desc, valid)
        return row
