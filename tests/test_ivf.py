"""IVF approximate retrieval (serve/ivf.py).

The exactness contract: with nprobe == n_clusters every candidate is
scored by the same exact kernel, so the top-k must carry the same
SCORES as brute-force `QueryEngine.query` (candidate order inside score
ties may differ through the gather).  Smaller nprobe is approximate and
gauged by `ivf_recall`.  The reference has no approximate path at all —
its retrieval is whole-split brute force (do_trec_qa_clean.py:617-652).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mms_answer_selection_tpu.models.mms_qa import (ConvBlock, MMSQAConfig,
                                                    mms_qa_init)
from mms_answer_selection_tpu.serve import IVFIndex, QueryEngine, ivf_recall
from mms_answer_selection_tpu.serve.ivf import _kmeans

CFG = MMSQAConfig(
    vocab_size=50, embed_dim=16, question_len=6, answer_len=6,
    sim_measures=2,
    blocks=(ConvBlock(3, 3, 4, "ave", 2, 2), ConvBlock(2, 2, 4, "ave", 1, 1)),
    fc1_dim=4)

rng = np.random.default_rng(11)


def _engine(pool=96, **kw):
    params, _ = mms_qa_init(jax.random.PRNGKey(0), CFG)
    params["sim"]["w"] = jnp.asarray(
        rng.normal(size=np.shape(params["sim"]["w"])).astype(np.float32)
        * 0.3)
    eng = QueryEngine(params, CFG, pool_dtype=jnp.float32, interpret=True,
                      **kw)
    eng.build_index(rng.integers(0, CFG.vocab_size,
                                 (pool, CFG.answer_len)))
    return eng


QUERIES = rng.integers(0, CFG.vocab_size, (5, CFG.question_len))


class TestKMeans:
    def test_separated_blobs_recovered(self):
        centers = np.array([[0.0, 10.0], [10.0, 0.0], [-10.0, -10.0]])
        pts = np.concatenate([c + rng.normal(size=(40, 2)) * 0.1
                              for c in centers])
        cent, assign = _kmeans(pts, 3, iters=8, seed=1)
        assign = np.asarray(assign)
        # each blob lands in exactly one cluster
        for b in range(3):
            blob = assign[b * 40: (b + 1) * 40]
            assert len(set(blob.tolist())) == 1
        # and the clusters are distinct
        assert len({assign[0], assign[40], assign[80]}) == 3
        got = sorted(np.asarray(cent).round(0).tolist())
        assert got == sorted(centers.tolist())

    def test_k_clamped_to_n(self):
        cent, assign = _kmeans(np.eye(3, dtype=np.float32), 8, iters=2)
        assert cent.shape[0] == 3


class TestExactnessContract:
    def test_probe_all_matches_brute_force_scores(self):
        eng = _engine()
        eng.build_ivf(n_clusters=6, seed=3)
        bv, bi = eng.query(QUERIES, k=7)
        iv, ii = eng.query_ivf(QUERIES, k=7, nprobe=6)
        np.testing.assert_allclose(np.asarray(iv), np.asarray(bv),
                                   rtol=1e-5)
        # identical candidates wherever scores are untied
        bv = np.asarray(bv)
        for r, (bi_r, ii_r) in enumerate(zip(np.asarray(bi),
                                             np.asarray(ii))):
            if len(set(bv[r].tolist())) == len(bv[r]):
                assert bi_r.tolist() == ii_r.tolist()

    def test_scan_chunk_storage_gathers_correctly(self):
        # chunk_size < pool forces the stacked (n_chunks, chunk, ...)
        # storage; the IVF flat-gather must reassemble global indices
        # (chunk_size 128 is a BLOCK_C multiple, so 256 gives 2 chunks)
        eng = _engine(pool=256, chunk_size=128)
        assert eng.chunks is not None
        eng.build_ivf(n_clusters=4, seed=0)
        bv, _ = eng.query(QUERIES, k=5)
        iv, _ = eng.query_ivf(QUERIES, k=5, nprobe=4)
        np.testing.assert_allclose(np.asarray(iv), np.asarray(bv),
                                   rtol=1e-5)

    def test_partial_probe_scores_are_true_kernel_scores(self):
        eng = _engine()
        eng.build_ivf(n_clusters=8, seed=5)
        iv, ii = eng.query_ivf(QUERIES, k=3, nprobe=2)
        # every returned (query, candidate) score must equal the
        # brute-force score of that same candidate
        bv_all, bi_all = eng.query(QUERIES, k=eng.pool_size)
        full = {}
        for q, (vs, isx) in enumerate(zip(np.asarray(bv_all),
                                          np.asarray(bi_all))):
            full.update({(q, int(i)): v for i, v in zip(isx, vs)})
        for q, (vs, isx) in enumerate(zip(np.asarray(iv),
                                          np.asarray(ii))):
            for i, v in zip(isx, vs):
                if i >= 0:
                    np.testing.assert_allclose(
                        v, full[(q, int(i))], rtol=1e-5)


class TestRecallAndShapes:
    def test_recall_improves_with_nprobe_and_hits_1_at_full(self):
        eng = _engine(pool=200)
        eng.build_ivf(n_clusters=10, seed=2)
        r_small = ivf_recall(eng, QUERIES, k=10, nprobe=1)
        r_full = ivf_recall(eng, QUERIES, k=10, nprobe=10)
        assert r_full == 1.0
        assert 0.0 <= r_small <= 1.0
        r_mid = ivf_recall(eng, QUERIES, k=10, nprobe=5)
        assert r_mid >= r_small

    def test_k_clamps_to_probed_set(self):
        eng = _engine(pool=24)
        eng.build_ivf(n_clusters=8, bucket=4, seed=1)
        iv, ii = eng.query_ivf(QUERIES, k=50, nprobe=2)
        assert iv.shape == (len(QUERIES), 8)  # nprobe * bucket

    def test_invalid_slots_marked_minus_one(self):
        # force tiny uneven clusters so probed sets carry padding
        eng = _engine(pool=40)
        eng.build_ivf(n_clusters=12, seed=4)
        iv, ii = eng.query_ivf(QUERIES, k=12, nprobe=1)
        iv, ii = np.asarray(iv), np.asarray(ii)
        assert ((ii == -1) == np.isneginf(iv)).all()
        assert (ii >= -1).all() and (ii < eng.pool_size).all()

    def test_spill_keeps_every_candidate_indexed(self):
        eng = _engine(pool=64)
        ivf = eng.build_ivf(n_clusters=4, bucket=20, seed=0)
        bm = np.asarray(ivf.bucket_map)
        got = sorted(bm[bm >= 0].tolist())
        assert got == list(range(64))  # all candidates, exactly once


class TestCoarseShortlist:
    """query_coarse: flat dense coarse matmul -> exact kernel on the
    top-shortlist.  Same exactness contract at shortlist == pool."""

    def test_full_shortlist_matches_brute_force(self):
        eng = _engine(pool=96)
        ivf = eng.build_ivf(n_clusters=6, seed=1)
        bv, bi = eng.query(QUERIES, k=7)
        cv, ci = ivf.query_coarse(QUERIES, k=7, shortlist=96)
        np.testing.assert_allclose(np.asarray(cv), np.asarray(bv),
                                   rtol=1e-5)

    def test_shortlist_scores_are_true_kernel_scores(self):
        eng = _engine(pool=96)
        ivf = eng.build_ivf(n_clusters=6, seed=1)
        cv, ci = ivf.query_coarse(QUERIES, k=5, shortlist=16)
        bv_all, bi_all = eng.query(QUERIES, k=96)
        full = {}
        for q, (vs, isx) in enumerate(zip(np.asarray(bv_all),
                                          np.asarray(bi_all))):
            full.update({(q, int(i)): v for i, v in zip(isx, vs)})
        for q, (vs, isx) in enumerate(zip(np.asarray(cv),
                                          np.asarray(ci))):
            for i, v in zip(isx, vs):
                np.testing.assert_allclose(v, full[(q, int(i))],
                                           rtol=1e-5)

    def test_coarse_beats_or_ties_ivf_at_equal_budget(self):
        eng = _engine(pool=200)
        ivf = eng.build_ivf(n_clusters=10, seed=2)
        budget = 2 * ivf.bucket  # what nprobe=2 probes
        r_ivf = ivf_recall(eng, QUERIES, k=10, nprobe=2)
        r_coarse = ivf_recall(eng, QUERIES, k=10, method="coarse",
                              shortlist=budget)
        assert r_coarse >= r_ivf

    def test_recall_1_at_full_shortlist(self):
        eng = _engine(pool=128)
        eng.build_ivf(n_clusters=8)
        assert ivf_recall(eng, QUERIES, k=10, method="coarse",
                          shortlist=128) == 1.0


class TestApproxShortlist:
    """Large-pool coarse shortlists select via ``lax.approx_max_k``
    instead of exact ``lax.top_k`` (which can be a full sort at pool
    length).  Gate: shortlist >= 256 AND pool >= 8x shortlist AND
    approx_recall is not None.  The exact kernel rescores the
    shortlist, so per-element recall misses at the shortlist BOUNDARY
    cannot move the final top-k at the defaults.  XLA's CPU and GPU
    lowerings of ApproxTopK are exact, so the parity test here pins the
    plumbing."""

    def _lower_text(self, eng, shortlist, approx_recall):
        fn = eng.ivf._build_coarse_fn(4, shortlist, approx_recall)
        coarse_ref = (eng.ivf.coarse_pool
                      if eng.ivf.coarse_pool is not None
                      else eng.ivf.coarse)
        args = (jnp.asarray(QUERIES[:1]), eng.ivf._pool_flat(),
                eng.ivf._aux_flat(), coarse_ref, eng.ivf.live_neg)
        return fn.lower(*args).as_text()

    def test_gate_engages_on_large_pool(self):
        eng = _engine(pool=2048)
        eng.build_ivf(n_clusters=8, seed=0)
        assert "ApproxTopK" in self._lower_text(eng, 256, 0.95)

    def test_gate_off_below_min_shortlist(self):
        eng = _engine(pool=2048)
        eng.build_ivf(n_clusters=8, seed=0)
        assert "ApproxTopK" not in self._lower_text(eng, 128, 0.95)

    def test_gate_off_small_pool(self):
        eng = _engine(pool=512)  # < 8 * 256
        eng.build_ivf(n_clusters=8, seed=0)
        assert "ApproxTopK" not in self._lower_text(eng, 256, 0.95)

    def test_none_forces_exact_selection(self):
        eng = _engine(pool=2048)
        eng.build_ivf(n_clusters=8, seed=0)
        assert "ApproxTopK" not in self._lower_text(eng, 256, None)

    def test_results_match_exact_path(self):
        eng = _engine(pool=2048)
        ivf = eng.build_ivf(n_clusters=8, seed=0)
        av, ai = ivf.query_coarse(QUERIES, k=10, shortlist=256)
        ev, ei = ivf.query_coarse(QUERIES, k=10, shortlist=256,
                                  approx_recall=None)
        np.testing.assert_allclose(np.asarray(av), np.asarray(ev),
                                   rtol=1e-5)

    def test_cache_key_includes_recall_target(self):
        eng = _engine(pool=2048)
        ivf = eng.build_ivf(n_clusters=8, seed=0)
        ivf.query_coarse(QUERIES, k=4, shortlist=256)
        key0 = ivf._coarse_jit[0]
        ivf.query_coarse(QUERIES, k=4, shortlist=256, approx_recall=None)
        assert ivf._coarse_jit[0] != key0


class TestMultiVectorCoarse:
    """coarse_tokens > 1: per-candidate token k-means -> a mini pool the
    exact kernel scores as the coarse stage (max structure preserved)."""

    def test_exact_when_tokens_fit_in_centroids(self):
        # candidates drawn from <= 4 distinct token ids: 4 centroids
        # reproduce the token set, so coarse MaxSim == exact MaxSim and
        # the shortlist ranking is already the true ranking
        params, _ = mms_qa_init(jax.random.PRNGKey(0), CFG)
        params["sim"]["w"] = jnp.asarray(
            rng.normal(size=np.shape(params["sim"]["w"])).astype(
                np.float32) * 0.3)
        eng = QueryEngine(params, CFG, pool_dtype=jnp.float32,
                          interpret=True)
        base = rng.integers(0, CFG.vocab_size, (96, 4))
        cand = np.take_along_axis(
            base, rng.integers(0, 4, (96, CFG.answer_len)), axis=1)
        eng.build_index(cand)
        ivf = eng.build_ivf(n_clusters=6, coarse_tokens=4, seed=0)
        assert ivf.coarse_pool is not None
        r = ivf_recall(eng, QUERIES, k=5, method="coarse", shortlist=20)
        assert r == 1.0

    def test_multivector_recall_beats_mean(self):
        eng = _engine(pool=256)
        r1 = []
        rT = []
        for seed in range(3):
            eng.build_ivf(n_clusters=8, seed=seed, coarse_tokens=1)
            r1.append(ivf_recall(eng, QUERIES, k=10, method="coarse",
                                 shortlist=32))
            eng.build_ivf(n_clusters=8, seed=seed, coarse_tokens=4)
            rT.append(ivf_recall(eng, QUERIES, k=10, method="coarse",
                                 shortlist=32))
        assert np.mean(rT) >= np.mean(r1)

    def test_exactness_contract_still_holds(self):
        eng = _engine(pool=96)
        ivf = eng.build_ivf(n_clusters=6, coarse_tokens=3, seed=1)
        bv, _ = eng.query(QUERIES, k=7)
        cv, _ = ivf.query_coarse(QUERIES, k=7, shortlist=96)
        np.testing.assert_allclose(np.asarray(cv), np.asarray(bv),
                                   rtol=1e-5)

    def test_coarse_tokens_validation(self):
        eng = _engine(pool=32)
        with pytest.raises(ValueError, match="coarse_tokens"):
            eng.build_ivf(n_clusters=4, coarse_tokens=0)


class TestInt8Pool:
    """IVF over the PRODUCTION int8 pool: the gather takes candidate rows
    (and their aux rows) from the candidate-major pool and scores them
    with the same int8 kernel, so probed scores equal int8 brute force
    exactly."""

    def _int8_engine(self, pool=96, **kw):
        params, _ = mms_qa_init(jax.random.PRNGKey(0), CFG)
        params["sim"]["w"] = jnp.asarray(
            rng.normal(size=np.shape(params["sim"]["w"])).astype(
                np.float32) * 0.3)
        eng = QueryEngine(params, CFG, pool_dtype="int8", interpret=True,
                          **kw)
        eng.build_index(rng.integers(0, CFG.vocab_size,
                                     (pool, CFG.answer_len)))
        return eng

    def test_probe_all_matches_int8_brute_force(self):
        eng = self._int8_engine()
        ivf = eng.build_ivf(n_clusters=6, seed=3)
        bv, bi = eng.query(QUERIES, k=7)
        iv, ii = eng.query_ivf(QUERIES, k=7, nprobe=6)
        np.testing.assert_allclose(np.asarray(iv), np.asarray(bv),
                                   rtol=1e-4)
        cv, ci = ivf.query_coarse(QUERIES, k=7, shortlist=96)
        np.testing.assert_allclose(np.asarray(cv), np.asarray(bv),
                                   rtol=1e-4)

    def test_chunked_int8_gather(self):
        eng = self._int8_engine(pool=2048, chunk_size=1024)
        assert eng.chunks is not None
        ivf = eng.build_ivf(n_clusters=8, seed=0, coarse_tokens=3)
        bv, _ = eng.query(QUERIES, k=5)
        cv, _ = ivf.query_coarse(QUERIES, k=5, shortlist=2048)
        np.testing.assert_allclose(np.asarray(cv), np.asarray(bv),
                                   rtol=1e-4)

    def test_multivector_mini_pool_is_bf16(self):
        eng = self._int8_engine()
        ivf = eng.build_ivf(n_clusters=4, coarse_tokens=3)
        assert ivf.coarse_pool.dtype == jnp.bfloat16


class TestIndexPersistence:
    """save_index/load_index: warm server restarts skip re-embedding
    and re-clustering (rebuild-only — the reference recomputes its
    serve state every run)."""

    def test_bf16_roundtrip_with_ivf(self, tmp_path):
        eng = _engine(pool=96)
        eng.build_ivf(n_clusters=6, coarse_tokens=3, seed=1)
        bv, bi = eng.query(QUERIES, k=5)
        cv, ci = eng.ivf.query_coarse(QUERIES, k=5, shortlist=32)
        path = str(tmp_path / "index.npz")
        eng.save_index(path)

        eng2 = QueryEngine(eng.params, CFG, pool_dtype=jnp.float32,
                           interpret=True)
        eng2.load_index(path)
        assert eng2.pool_size == eng.pool_size
        v2, i2 = eng2.query(QUERIES, k=5)
        np.testing.assert_array_equal(np.asarray(i2), np.asarray(bi))
        np.testing.assert_allclose(np.asarray(v2), np.asarray(bv),
                                   rtol=0)
        assert eng2.ivf is not None
        assert eng2.ivf.coarse_tokens == 3
        v3, i3 = eng2.ivf.query_coarse(QUERIES, k=5, shortlist=32)
        np.testing.assert_array_equal(np.asarray(i3), np.asarray(ci))
        np.testing.assert_allclose(np.asarray(v3), np.asarray(cv),
                                   rtol=0)
        # bucket-probe path (query_ivf) exercises bucket_map/valid/
        # centroids — the other restored attribute set
        pv, pi = eng.query_ivf(QUERIES, k=5, nprobe=6)
        pv2, pi2 = eng2.query_ivf(QUERIES, k=5, nprobe=6)
        np.testing.assert_array_equal(np.asarray(pi2), np.asarray(pi))
        np.testing.assert_allclose(np.asarray(pv2), np.asarray(pv),
                                   rtol=0)

    def test_int8_chunked_roundtrip(self, tmp_path):
        params, _ = mms_qa_init(jax.random.PRNGKey(0), CFG)
        params["sim"]["w"] = jnp.asarray(
            rng.normal(size=np.shape(params["sim"]["w"])).astype(
                np.float32) * 0.3)
        eng = QueryEngine(params, CFG, pool_dtype="int8",
                          interpret=True, chunk_size=1024)
        eng.build_index(rng.integers(0, CFG.vocab_size,
                                     (2048, CFG.answer_len)))
        bv, bi = eng.query(QUERIES, k=5)
        path = str(tmp_path / "i8.npz")
        eng.save_index(path)
        eng2 = QueryEngine(params, CFG, pool_dtype="int8",
                           interpret=True)
        eng2.load_index(path)
        assert eng2.chunks is not None
        v2, i2 = eng2.query(QUERIES, k=5)
        np.testing.assert_array_equal(np.asarray(i2), np.asarray(bi))
        np.testing.assert_allclose(np.asarray(v2), np.asarray(bv),
                                   rtol=0)

    def test_int8_ivf_roundtrip(self, tmp_path):
        # the restored int8 IVF must rebuild its token-major gather
        # closures over the loaded pool (the other _exact_parts branch)
        params, _ = mms_qa_init(jax.random.PRNGKey(0), CFG)
        params["sim"]["w"] = jnp.asarray(
            rng.normal(size=np.shape(params["sim"]["w"])).astype(
                np.float32) * 0.3)
        eng = QueryEngine(params, CFG, pool_dtype="int8", interpret=True)
        eng.build_index(rng.integers(0, CFG.vocab_size,
                                     (256, CFG.answer_len)))
        eng.build_ivf(n_clusters=5, coarse_tokens=2, seed=2)
        pv, pi = eng.query_ivf(QUERIES, k=4, nprobe=5)
        cv, ci = eng.ivf.query_coarse(QUERIES, k=4, shortlist=64)
        path = str(tmp_path / "i8ivf.npz")
        eng.save_index(path)
        eng2 = QueryEngine(params, CFG, pool_dtype="int8", interpret=True)
        eng2.load_index(path)
        pv2, pi2 = eng2.query_ivf(QUERIES, k=4, nprobe=5)
        np.testing.assert_array_equal(np.asarray(pi2), np.asarray(pi))
        np.testing.assert_allclose(np.asarray(pv2), np.asarray(pv),
                                   rtol=0)
        cv2, ci2 = eng2.ivf.query_coarse(QUERIES, k=4, shortlist=64)
        np.testing.assert_array_equal(np.asarray(ci2), np.asarray(ci))
        np.testing.assert_allclose(np.asarray(cv2), np.asarray(cv),
                                   rtol=0)

    def test_fingerprint_mismatch_rejected(self, tmp_path):
        eng = _engine(pool=32)
        path = str(tmp_path / "x.npz")
        eng.save_index(path)
        params2 = jax.tree.map(lambda a: a, eng.params)
        params2["sim"]["w"] = eng.params["sim"]["w"] + 1.0
        eng2 = QueryEngine(params2, CFG, pool_dtype=jnp.float32,
                           interpret=True)
        with pytest.raises(ValueError, match="fingerprint"):
            eng2.load_index(path)

    def test_dtype_mismatch_rejected(self, tmp_path):
        eng = _engine(pool=32)
        path = str(tmp_path / "x.npz")
        eng.save_index(path)
        eng2 = QueryEngine(eng.params, CFG, pool_dtype="int8",
                           interpret=True)
        with pytest.raises(ValueError, match="dtype"):
            eng2.load_index(path)

    def test_unbuilt_save_rejected(self):
        eng = QueryEngine(_engine(pool=32).params, CFG,
                          pool_dtype=jnp.float32, interpret=True)
        with pytest.raises(ValueError, match="build_index"):
            eng.save_index("/tmp/never.npz")

    def test_meshed_roundtrip_same_topology(self, tmp_path):
        from jax.sharding import Mesh
        mesh = Mesh(np.asarray(jax.devices()), ("c",))
        eng = _engine(pool=64, mesh=mesh)
        bv, bi = eng.query(QUERIES, k=5)
        path = str(tmp_path / "mesh.npz")
        eng.save_index(path)

        eng2 = QueryEngine(eng.params, CFG, pool_dtype=jnp.float32,
                           interpret=True, mesh=mesh)
        eng2.load_index(path)
        assert eng2.pool.sharding.mesh.shape == mesh.shape
        v2, i2 = eng2.query(QUERIES, k=5)
        np.testing.assert_array_equal(np.asarray(i2), np.asarray(bi))
        np.testing.assert_allclose(np.asarray(v2), np.asarray(bv), rtol=0)

    def test_shard_count_mismatch_rejected(self, tmp_path):
        from jax.sharding import Mesh
        eng = _engine(pool=64)  # single-device layout
        path = str(tmp_path / "flat.npz")
        eng.save_index(path)
        mesh = Mesh(np.asarray(jax.devices()), ("c",))
        eng2 = QueryEngine(eng.params, CFG, pool_dtype=jnp.float32,
                           interpret=True, mesh=mesh)
        with pytest.raises(ValueError, match="shard"):
            eng2.load_index(path)


class TestValidation:
    def test_unbuilt_engine_rejected(self):
        params, _ = mms_qa_init(jax.random.PRNGKey(0), CFG)
        eng = QueryEngine(params, CFG, pool_dtype=jnp.float32,
                          interpret=True)
        with pytest.raises(ValueError, match="build_index"):
            IVFIndex(eng)
        with pytest.raises(RuntimeError, match="build_ivf"):
            _engine().query_ivf(QUERIES)

    def test_rebuild_invalidates_ivf(self):
        eng = _engine()
        eng.build_ivf(n_clusters=4)
        eng.build_index(rng.integers(0, CFG.vocab_size,
                                     (32, CFG.answer_len)))
        assert eng.ivf is None

    def test_bucket_too_small_raises(self):
        eng = _engine(pool=64)
        with pytest.raises(ValueError, match="cannot hold"):
            eng.build_ivf(n_clusters=4, bucket=2)


class TestTombstones:
    """Interaction of live deletes (QueryEngine.remove_candidates) with
    the IVF index — both orders."""

    def test_remove_after_cached_query_refreshes_closures(self):
        # the probed exact stage captures the pool arrays in its jitted
        # closure; a remove AFTER a query must invalidate that cache or
        # the tombstone is invisible to the IVF path (regression)
        eng = _engine(pool=96)
        eng.build_ivf(n_clusters=6, coarse_tokens=3, seed=1)
        _, i0 = eng.query_ivf(QUERIES, k=4, nprobe=6)      # caches _jit
        _, c0 = eng.ivf.query_coarse(QUERIES, k=4, shortlist=48)
        dead = sorted({int(np.asarray(i0)[q, 0])
                       for q in range(QUERIES.shape[0])})
        eng.remove_candidates(dead)
        _, i1 = eng.query_ivf(QUERIES, k=4, nprobe=6)
        assert not (set(np.asarray(i1).ravel().tolist()) & set(dead))
        _, c1 = eng.ivf.query_coarse(QUERIES, k=4, shortlist=48)
        assert not (set(np.asarray(c1).ravel().tolist()) & set(dead))

    def test_build_after_remove_excludes_tombstones(self):
        eng = _engine(pool=96)
        _, i0 = eng.query(QUERIES, k=4)
        dead = sorted({int(np.asarray(i0)[q, 0])
                       for q in range(QUERIES.shape[0])})
        eng.remove_candidates(dead)
        ivf = eng.build_ivf(n_clusters=6, seed=1)
        # tombstones never enter a bucket
        in_buckets = set(np.asarray(ivf.bucket_map).ravel().tolist())
        assert not (in_buckets & set(dead))
        # and the flat coarse routing masks them out entirely
        assert ivf.live_neg is not None
        _, ci = ivf.query_coarse(QUERIES, k=4, shortlist=16)
        assert not (set(np.asarray(ci).ravel().tolist()) & set(dead))

    def test_build_after_remove_matches_live_brute_force(self):
        eng = _engine(pool=96)
        eng.remove_candidates([3, 40, 77])
        eng.build_ivf(n_clusters=6, seed=2)
        bv, bi = eng.query(QUERIES, k=5)           # brute force, masked
        pv, pi = eng.query_ivf(QUERIES, k=5, nprobe=6)  # probe all
        np.testing.assert_array_equal(np.asarray(pi), np.asarray(bi))
        np.testing.assert_allclose(np.asarray(pv), np.asarray(bv),
                                   rtol=0)

    def test_persisted_tombstones_mask_coarse_routing(self, tmp_path):
        eng = _engine(pool=96)
        eng.remove_candidates([5, 6])
        eng.build_ivf(n_clusters=6, seed=3)
        path = str(tmp_path / "ts.npz")
        eng.save_index(path)
        eng2 = QueryEngine(eng.params, CFG, pool_dtype=jnp.float32,
                           interpret=True)
        eng2.load_index(path)
        assert eng2.ivf.live_neg is not None
        _, ci = eng2.ivf.query_coarse(QUERIES, k=4, shortlist=16)
        assert not (set(np.asarray(ci).ravel().tolist()) & {5, 6})


class TestNoCapturedPoolConstants:
    """The IVF query programs must take every large array (pool, aux,
    coarse tables, bucket map) as a jit ARGUMENT: a closed-over device
    array lowers as an HLO constant, and a multi-GB constant makes a
    multi-GB program to compile.  Lowered-text size is the guard: a
    captured pool inlines dense<"0x..."> blobs and blows the program up
    by the pool's byte size."""

    def _lowered_len(self, eng, method):
        q = jnp.asarray(QUERIES[:1])
        if method == "ivf":
            fn = eng.ivf._build_query_fn(4, 2)
            if eng.ivf._cent_dev is None:
                eng.ivf._cent_dev = jnp.asarray(eng.ivf._cent_f32)
            args = (q, eng.ivf._pool_flat(), eng.ivf._aux_flat(),
                    eng.ivf.bucket_map, eng.ivf.valid, eng.ivf._cent_dev)
        else:
            fn = eng.ivf._build_coarse_fn(4, 16)
            coarse_ref = (eng.ivf.coarse_pool
                          if eng.ivf.coarse_pool is not None
                          else eng.ivf.coarse)
            args = (q, eng.ivf._pool_flat(), eng.ivf._aux_flat(),
                    coarse_ref, eng.ivf.live_neg)
        return len(fn.lower(*args).as_text())

    def test_query_programs_stay_small(self):
        # 4096 f32 candidates ~ 4096*8*128*4 = 16 MB of pool bytes; a
        # capture regression inflates the lowering >10x past the bound
        eng = _engine(pool=4096)
        eng.build_ivf(n_clusters=16, seed=0)
        assert self._lowered_len(eng, "ivf") < 2_000_000
        assert self._lowered_len(eng, "coarse") < 2_000_000
        eng.build_ivf(n_clusters=16, seed=0, coarse_tokens=2)
        assert self._lowered_len(eng, "coarse") < 2_000_000

    def test_kmeans_update_takes_vecs_as_arg(self):
        # the Lloyd update must not close over the (N, D) matrix either
        import inspect
        from mms_answer_selection_tpu.serve import ivf as ivf_mod
        src = inspect.getsource(ivf_mod._kmeans)
        assert "def update(assign, cent, vecs)" in src


class TestNoDuplicatePoolCopy:
    """The index's cached storage view must BE the engine's buffers, not
    a host-level reshape of them: reshaping a scan-chunk stack outside
    jit materializes a second full copy of the packed pool (5.4 GB at
    1M int8 — the round-5 bench's coarse-stage OOM).  The 4-D stack is
    flattened INSIDE the traced query programs, where the reshape is an
    XLA bitcast."""

    def test_flat_view_is_engine_storage(self):
        eng = _engine(pool=256, chunk_size=128)
        eng.build_ivf(n_clusters=4, seed=0)
        assert eng.ivf._pool_flat() is eng.chunks[0]
        assert eng.ivf._pool_flat().ndim == 4

    def test_chunked_queries_match_flat_engine(self):
        # same pool stored flat vs scan-chunked must retrieve the same
        # candidates through both ivf routing and the coarse shortlist
        ids = rng.integers(0, CFG.vocab_size, (256, CFG.answer_len))
        params, _ = mms_qa_init(jax.random.PRNGKey(0), CFG)
        params["sim"]["w"] = jnp.asarray(
            rng.normal(size=np.shape(params["sim"]["w"]))
            .astype(np.float32) * 0.3)

        def build(**kw):
            e = QueryEngine(params, CFG, pool_dtype=jnp.float32,
                            interpret=True, **kw)
            e.build_index(ids)
            e.build_ivf(n_clusters=4, seed=0)
            return e

        flat, chunked = build(chunk_size=512), build(chunk_size=128)
        assert flat.chunks is None and chunked.chunks is not None
        for meth in ("ivf", "coarse"):
            if meth == "ivf":
                fv, fi = flat.query_ivf(QUERIES, k=4, nprobe=4)
                cv, ci = chunked.query_ivf(QUERIES, k=4, nprobe=4)
            else:
                fv, fi = flat.ivf.query_coarse(QUERIES, k=4, shortlist=32)
                cv, ci = chunked.ivf.query_coarse(QUERIES, k=4,
                                                  shortlist=32)
            np.testing.assert_allclose(np.asarray(fv), np.asarray(cv),
                                       rtol=1e-5, atol=1e-5)
            assert np.array_equal(np.sort(np.asarray(fi), axis=1),
                                  np.sort(np.asarray(ci), axis=1))
