"""int8 retrieval kernel tests: quantization, score accuracy, top-k recall."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from mms_answer_selection_tpu.ops.sim_cross_pallas import (
    BLOCK_C,
    bilinear_maxsim_scores,
    bilinear_maxsim_scores_int8,
    bilinear_maxsim_scores_reference,
    mask_out_candidates_int8,
    pack_candidate_pool,
    pack_candidate_pool_int8,
    project_queries,
    project_queries_int8,
    _quantize_rows,
)

rng = np.random.default_rng(41)


class TestQuantize:
    def test_roundtrip_error_bounded(self):
        x = jnp.asarray(rng.normal(size=(32, 50)).astype(np.float32))
        q, s = _quantize_rows(x)
        deq = q.astype(jnp.float32) * s[:, None]
        rel = float(jnp.max(jnp.abs(deq - x)) / jnp.max(jnp.abs(x)))
        assert rel < 0.01  # 1/127 per-row symmetric quant

    def test_zero_row_safe(self):
        x = jnp.zeros((2, 8))
        q, s = _quantize_rows(x)
        assert np.all(np.asarray(q) == 0)
        assert np.all(np.isfinite(np.asarray(s)))


class TestInt8Scores:
    def _setup(self, nq=3, c=2 * BLOCK_C, w1=5, w2=7, d=50, m=2):
        q = jnp.asarray(rng.normal(size=(nq, w1, d)).astype(np.float32))
        cand = jnp.asarray(rng.normal(size=(c, w2, d)).astype(np.float32))
        w = jnp.asarray(rng.normal(size=(m, d, d)).astype(np.float32) * 0.1)
        return q, cand, w

    def test_close_to_f32_reference(self):
        q, cand, w = self._setup()
        ref = np.asarray(bilinear_maxsim_scores_reference(q, cand, w))
        qw, qs = project_queries_int8(q, w)
        pool, aux = pack_candidate_pool_int8(cand)
        out = np.asarray(bilinear_maxsim_scores_int8(qw, qs, pool, aux,
                                                     interpret=True))
        scale = np.abs(ref).max()
        np.testing.assert_allclose(out, ref, atol=0.05 * scale)

    def test_topk_recall_vs_f32(self):
        q, cand, w = self._setup(nq=4, c=4 * BLOCK_C)
        ref = np.asarray(bilinear_maxsim_scores_reference(q, cand, w))
        qw, qs = project_queries_int8(q, w)
        pool, aux = pack_candidate_pool_int8(cand)
        out = np.asarray(bilinear_maxsim_scores_int8(qw, qs, pool, aux,
                                                     interpret=True))
        k = 10
        for qi in range(4):
            top_ref = set(np.argsort(-ref[qi])[:k])
            top_int8 = set(np.argsort(-out[qi])[:k])
            assert len(top_ref & top_int8) >= k - 2  # >= 80% overlap

    def test_padding_mask(self):
        # all-negative sims: padded zero rows must not win the max
        q = jnp.ones((1, 2, 50), jnp.float32)
        cand = -jnp.ones((BLOCK_C, 3, 50), jnp.float32)
        w = jnp.eye(50)[None]
        ref = np.asarray(bilinear_maxsim_scores_reference(q, cand, w))
        assert ref[0, 0] < 0
        qw, qs = project_queries_int8(q, w)
        pool, aux = pack_candidate_pool_int8(cand)
        out = np.asarray(bilinear_maxsim_scores_int8(qw, qs, pool, aux,
                                                     interpret=True))
        np.testing.assert_allclose(out, ref, atol=0.05 * abs(ref).max())

    def test_mask_out_candidates(self):
        q, cand, w = self._setup(nq=1, c=BLOCK_C)
        qw, qs = project_queries_int8(q, w)
        pool, aux = pack_candidate_pool_int8(cand)
        aux = mask_out_candidates_int8(aux, BLOCK_C - 8)
        out = np.asarray(bilinear_maxsim_scores_int8(qw, qs, pool, aux,
                                                     interpret=True))
        # fully masked candidates sink far below any real score
        assert out[0, -8:].max() < out[0, : BLOCK_C - 8].min()


class TestTileValidation:
    """Tile parameters the kernel cannot launch with must raise, not
    silently skip candidates or queries."""

    def test_width_off_the_k_step_rejected(self):
        """A hand-built pool whose padded width is not a multiple of the
        tensor-core K step cannot launch; the packers never build one."""
        q = jnp.ones((1, 2, 50), jnp.float32)
        w = jnp.eye(50)[None]
        qw = project_queries(q, w)[:, :, :56]
        pool = pack_candidate_pool(jnp.ones((BLOCK_C, 3, 50)))[:, :, :56]
        with pytest.raises(ValueError, match="K step"):
            bilinear_maxsim_scores(qw, pool, interpret=True)

    def test_pool_not_multiple_of_16_rejected(self):
        q = jnp.ones((1, 2, 50), jnp.float32)
        cand = jnp.ones((40, 3, 50), jnp.float32)
        w = jnp.eye(50)[None]
        qw, qs = project_queries_int8(q, w)
        pool, aux = pack_candidate_pool_int8(cand)
        with pytest.raises(ValueError, match="multiple of 16"):
            bilinear_maxsim_scores_int8(qw, qs, pool, aux, interpret=True)

    def test_width_mismatch_rejected(self):
        q = jnp.ones((1, 2, 50), jnp.float32)
        w = jnp.eye(50)[None]
        qw, qs = project_queries_int8(q, w)
        pool, aux = pack_candidate_pool_int8(
            jnp.ones((BLOCK_C, 3, 70), jnp.float32))
        with pytest.raises(ValueError, match="width"):
            bilinear_maxsim_scores_int8(qw, qs, pool, aux, interpret=True)

    def test_off_block_pool_shrinks_tile(self):
        """A 400-candidate pool is not a BLOCK_C multiple; direct callers
        get the largest power-of-two tile that divides the pool (here
        16; QueryEngine pads to BLOCK_C multiples)."""
        q = jnp.asarray(rng.normal(size=(2, 3, 50)).astype(np.float32))
        cand = jnp.asarray(rng.normal(size=(400, 4, 50)).astype(np.float32))
        w = jnp.asarray(rng.normal(size=(1, 50, 50)).astype(np.float32) * 0.1)
        ref = np.asarray(bilinear_maxsim_scores_reference(q, cand, w))
        qw, qs = project_queries_int8(q, w)
        pool, aux = pack_candidate_pool_int8(cand)
        out = np.asarray(bilinear_maxsim_scores_int8(
            qw, qs, pool, aux, interpret=True))
        assert out.shape == (2, 400)
        np.testing.assert_allclose(out, ref, atol=0.05 * np.abs(ref).max())


class TestBf16GcdFallback:
    def test_off_block_pool_scores(self):
        """A 96-candidate bf16 pool against the default tile runs on
        32-wide tiles and agrees with the reference scorer."""
        from mms_answer_selection_tpu.ops.sim_cross_pallas import (
            bilinear_maxsim_scores_reference)

        rng = np.random.default_rng(1)
        cand = jnp.asarray(rng.normal(size=(96, 8, 16)).astype(np.float32))
        q = jnp.asarray(rng.normal(size=(3, 8, 16)).astype(np.float32))
        w = jnp.asarray(rng.normal(size=(2, 16, 16)).astype(np.float32))
        qw = project_queries(q, w)
        pool = pack_candidate_pool(cand)
        got = bilinear_maxsim_scores(qw, pool, interpret=True)
        want = bilinear_maxsim_scores_reference(q, cand, w)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-2, atol=2e-2)
