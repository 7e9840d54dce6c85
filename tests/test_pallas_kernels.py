"""MaxSim kernel tests.  On the CPU the kernels run under the Pallas
interpreter, with the same padding and tiling as the compiled GPU path;
the launch-shape tests also lower them for the GPU (Triton IR is produced
without a card), and chip_smoke.py runs them compiled on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mms_answer_selection_tpu.ops import sim_cross_pallas as K
from mms_answer_selection_tpu.ops.sim_cross_pallas import (
    BLOCK_C,
    bilinear_maxsim_scores,
    bilinear_maxsim_scores_chunked,
    bilinear_maxsim_scores_int8,
    bilinear_maxsim_scores_reference,
    mask_candidate_rows,
    mask_candidate_rows_int8,
    maxsim_scores_plain,
    pack_candidate_pool,
    pack_candidate_pool_int8,
    project_queries,
    project_queries_int8,
)

rng = np.random.default_rng(11)


def _inputs(nq, c, w1=5, w2=7, d=50, m=2, seed=0):
    r = np.random.default_rng(seed)
    q = jnp.asarray(r.normal(size=(nq, w1, d)).astype(np.float32))
    cand = jnp.asarray(r.normal(size=(c, w2, d)).astype(np.float32))
    w = jnp.asarray(r.normal(size=(m, d, d)).astype(np.float32) * 0.1)
    return q, cand, w


def _packed(mode, q, cand, w):
    """(qw, qs, pool, aux) for a mode; qs/aux are None for float pools."""
    if mode == "int8":
        qw, qs = project_queries_int8(q, w)
        pool, aux = pack_candidate_pool_int8(cand)
        return qw, qs, pool, aux
    dtype = jnp.float32 if mode == "f32" else jnp.bfloat16
    return (project_queries(q, w, dtype=dtype), None,
            pack_candidate_pool(cand, dtype=dtype), None)


def _score(mode, qw, qs, pool, aux, **kw):
    if mode == "int8":
        return bilinear_maxsim_scores_int8(qw, qs, pool, aux,
                                           interpret=True, **kw)
    return bilinear_maxsim_scores(qw, pool, interpret=True, **kw)


# relative to max |ref|: f32 is exact up to summation order; bf16 operands
# carry 8 mantissa bits; int8 quantizes per candidate
_TOL = {"f32": 1e-5, "bf16": 0.02, "int8": 0.06}


class TestKernelGrid:
    """Kernels against the f32 reference over pool sizes that fill one
    tile, several tiles, or fall off the default tile, and query counts
    that leave the query tile full or ragged."""

    @pytest.mark.parametrize("nq", [1, 8, 33])
    @pytest.mark.parametrize("c", [BLOCK_C, 3 * BLOCK_C, 80],
                             ids=["one_tile", "three_tiles", "off_tile"])
    @pytest.mark.parametrize("mode", ["bf16", "f32", "int8"])
    def test_matches_reference(self, mode, c, nq):
        q, cand, w = _inputs(nq, c, seed=nq * 1000 + c)
        ref = np.asarray(bilinear_maxsim_scores_reference(q, cand, w))
        qw, qs, pool, aux = _packed(mode, q, cand, w)
        out = np.asarray(_score(mode, qw, qs, pool, aux))
        assert out.shape == (nq, c)
        scale = np.abs(ref).max()
        assert np.abs(out - ref).max() <= _TOL[mode] * scale
        # the plain XLA version on the same packed operands agrees to
        # summation order
        plain = np.asarray(maxsim_scores_plain(qw, qs, pool, aux, tile=16))
        np.testing.assert_allclose(out, plain, rtol=1e-5,
                                   atol=1e-5 * scale)


class TestMaxSimScores:
    def test_matches_reference(self):
        nq, c, w1, w2, d, m = 2, 2 * BLOCK_C, 5, 7, 50, 2
        q, cand, w = _inputs(nq, c, w1, w2, d, m, seed=3)
        ref = bilinear_maxsim_scores_reference(q, cand, w)
        # f32 through the kernel for an apples-to-apples numeric check
        qw = project_queries(q, w, dtype=jnp.float32)
        pool = pack_candidate_pool(cand, dtype=jnp.float32)
        out = bilinear_maxsim_scores(qw, pool, interpret=True)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=1e-3, atol=1e-3)

    def test_padding_never_wins_max(self):
        # candidates whose real similarities are ALL negative: a padded
        # zero token row would win the max (score 0) without the mask
        nq, c, w2, d = 1, BLOCK_C, 3, 50
        q = jnp.ones((nq, 2, d), jnp.float32)
        cand = -jnp.ones((c, w2, d), jnp.float32)
        w = jnp.eye(d)[None]
        ref = bilinear_maxsim_scores_reference(q, cand, w)
        assert float(ref[0, 0]) < 0
        qw = project_queries(q, w, dtype=jnp.float32)
        pool = pack_candidate_pool(cand, dtype=jnp.float32, w2p=8)
        out = bilinear_maxsim_scores(qw, pool, interpret=True)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4)

    def test_bf16_pool_close_to_f32(self):
        q, cand, w = _inputs(2, BLOCK_C, 4, 6, 50, 2, seed=4)
        ref = bilinear_maxsim_scores_reference(q, cand, w)
        qw = project_queries(q, w)  # bf16
        pool = pack_candidate_pool(cand)  # bf16
        out = bilinear_maxsim_scores(qw, pool, interpret=True)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=0.05, atol=0.5)

    def test_pool_size_must_tile(self):
        q = jnp.zeros((1, 2, 50))
        w = jnp.eye(50)[None]
        qw = project_queries(q, w, dtype=jnp.float32)
        pool = pack_candidate_pool(jnp.zeros((BLOCK_C + 1, 3, 50)),
                                   dtype=jnp.float32)
        with pytest.raises(ValueError, match="multiple"):
            bilinear_maxsim_scores(qw, pool, interpret=True)

    def test_chunked_reference_matches_reference(self):
        q, cand, w = _inputs(3, 96, seed=5)
        ref = np.asarray(bilinear_maxsim_scores_reference(q, cand, w))
        out = np.asarray(bilinear_maxsim_scores_chunked(q, cand, w,
                                                        chunk=32))
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-5)


class TestPaddingAndTombstones:
    @pytest.mark.parametrize("mode", ["f32", "int8"])
    def test_token_padding_never_wins(self, mode):
        """Packed token rows beyond W2 (mask lane for float pools, a copy
        of token 0 for int8) never change a candidate's max."""
        q = jnp.ones((2, 3, 50), jnp.float32)
        cand = -jnp.abs(jnp.asarray(
            rng.normal(size=(BLOCK_C, 5, 50)).astype(np.float32)))
        w = jnp.eye(50)[None]
        ref = np.asarray(bilinear_maxsim_scores_reference(q, cand, w))
        assert ref.max() < 0
        if mode == "int8":
            qw, qs = project_queries_int8(q, w)
            pool, aux = pack_candidate_pool_int8(cand, w2p=12)
        else:
            qw, qs, aux = project_queries(q, w, dtype=jnp.float32), None, None
            pool = pack_candidate_pool(cand, dtype=jnp.float32, w2p=12)
        assert pool.shape[1] == 12
        out = np.asarray(_score(mode, qw, qs, pool, aux))
        assert np.abs(out - ref).max() <= _TOL[mode] * np.abs(ref).max()

    @pytest.mark.parametrize("mode", ["bf16", "int8"])
    def test_tombstones_sink_only_their_rows(self, mode):
        q, cand, w = _inputs(2, 2 * BLOCK_C, seed=6)
        qw, qs, pool, aux = _packed(mode, q, cand, w)
        before = np.asarray(_score(mode, qw, qs, pool, aux))
        rows = jnp.asarray([0, 5, BLOCK_C + 3])
        if mode == "int8":
            aux = mask_candidate_rows_int8(aux, rows)
        else:
            pool = mask_candidate_rows(pool, rows)
        after = np.asarray(_score(mode, qw, qs, pool, aux))
        dead = np.zeros(2 * BLOCK_C, bool)
        dead[np.asarray(rows)] = True
        assert np.all(after[:, dead] < -1e29)
        np.testing.assert_array_equal(after[:, ~dead], before[:, ~dead])


class TestBackendRule:
    @pytest.mark.parametrize("backend,expected",
                             [("gpu", False), ("cpu", True)])
    def test_none_resolves_from_backend(self, monkeypatch, backend,
                                        expected):
        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        assert K.resolve_interpret(None) is expected

    def test_other_backend_raises(self, monkeypatch):
        monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
        with pytest.raises(ValueError, match="no MaxSim kernel"):
            K.resolve_interpret(None)

    def test_explicit_choice_wins(self, monkeypatch):
        monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
        assert K.resolve_interpret(True) is True
        assert K.resolve_interpret(False) is False


def _pallas_eqn(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    eqns = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "pallas_call"]
    assert len(eqns) == 1
    return eqns[0]


class TestLaunchShapes:
    @pytest.mark.parametrize("mode", ["bf16", "int8"])
    def test_padded_shapes_equal_in_both_modes(self, mode):
        """The interpreter (CPU tests) and the compiled kernel (GPU) launch
        the same grid over the same padded operands."""
        q, cand, w = _inputs(3, 80, w1=6, seed=7)
        args = _packed(mode, q, cand, w)
        launches = []
        for interpret in (True, False):
            def fn(qw, qs, pool, aux, interpret=interpret):
                if mode == "int8":
                    return bilinear_maxsim_scores_int8(
                        qw, qs, pool, aux, interpret=interpret)
                return bilinear_maxsim_scores(qw, pool, interpret=interpret)
            e = _pallas_eqn(fn, *args)
            gm = e.params["grid_mapping"]
            launches.append((gm.grid,
                             [b.block_shape for b in gm.block_mappings],
                             [v.aval for v in e.invars],
                             e.params["interpret"]))
        (g1, b1, a1, i1), (g2, b2, a2, i2) = launches
        assert (i1, i2) == (True, False)
        assert g1 == g2 and b1 == b2 and a1 == a2
        # 6*2 = 12 query rows pad to 16; 80 candidates take 16-wide tiles
        assert g1 == (3, 5)

    @pytest.mark.parametrize("mode", ["bf16", "int8"])
    def test_lowers_to_triton_at_recipe_widths(self, mode):
        """D=50, W1=W2=40, M=4: the kernel lowers to a Triton call for the
        GPU (power-of-two tiles, dot operands >= 16) without a card."""
        q = jnp.zeros((2, 40, 50))
        cand = jnp.zeros((2 * BLOCK_C, 40, 50))
        w = jnp.zeros((4, 50, 50))
        args = _packed(mode, q, cand, w)

        def fn(qw, qs, pool, aux):
            if mode == "int8":
                return bilinear_maxsim_scores_int8(qw, qs, pool, aux,
                                                   interpret=False)
            return bilinear_maxsim_scores(qw, pool, interpret=False)

        text = jax.jit(fn).trace(*args).lower(
            lowering_platforms=("cuda",)).as_text()
        assert "__gpu$xla.gpu.triton" in text
        assert "grid_x = 2" in text and "grid_y = 2" in text


class TestPaddingRules:
    @pytest.mark.parametrize("n,parts", [
        (160, ((0, 128), (128, 32))), (64, ((0, 64),)),
        (48, ((0, 32), (32, 16)))])
    def test_pow2_parts(self, n, parts):
        assert K._pow2_parts(n) == parts

    @pytest.mark.parametrize("d,dtype,dp", [
        (50, jnp.bfloat16, 64), (50, jnp.int8, 64), (300, jnp.int8, 320),
        (300, jnp.bfloat16, 304), (16, jnp.float32, 32)])
    def test_padded_dim_follows_k_step(self, d, dtype, dp):
        assert K.padded_dim(d, dtype) == dp


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bf16", "f32", "int8"])
def test_compiled_kernel_matches_reference(gpu_device, mode):
    """The compiled (Triton) kernel on the card; skips on the CPU.
    chip_smoke.py's kernel phase runs the same check at recipe widths."""
    q, cand, w = _inputs(8, 4 * BLOCK_C, w1=40, w2=40, m=4, seed=9)
    ref = np.asarray(bilinear_maxsim_scores_reference(q, cand, w))
    qw, qs, pool, aux = _packed(mode, q, cand, w)
    if mode == "int8":
        out = bilinear_maxsim_scores_int8(qw, qs, pool, aux)
    else:
        out = bilinear_maxsim_scores(qw, pool)
    err = np.abs(np.asarray(out) - ref).max()
    assert err <= _TOL[mode] * np.abs(ref).max()
