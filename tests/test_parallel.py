"""Mesh-parallel tests on the 8-virtual-device CPU mesh.

The key assertion follows the reference's multi-GPU test pattern
(test_gradient_based_solver.cpp:459-488): the sharded N-device training step
must produce the same parameters as the single-device step on the same
global batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from mms_answer_selection_tpu.models.mms_qa import (
    ConvBlock,
    MMSQAConfig,
    mms_qa_init,
    param_spec,
)
from mms_answer_selection_tpu.parallel import (
    build_sharded_eval_step,
    build_sharded_train_step,
    make_mesh,
    params_pspec,
)
from mms_answer_selection_tpu.training import SolverConfig, make_solver

TINY = MMSQAConfig(
    vocab_size=64, embed_dim=16, question_len=12, answer_len=12,
    sim_measures=2,
    blocks=(ConvBlock(3, 3, 8, "ave", 2, 2), ConvBlock(3, 3, 8, "ave", 3, 1)),
    fc1_dim=8)


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "question": jnp.asarray(rng.integers(0, 64, (n, 12)), jnp.int32),
        "answer": jnp.asarray(rng.integers(0, 64, (n, 12)), jnp.int32),
        "overlap_feat": jnp.asarray(rng.random((n, 2)).astype(np.float32)),
        "label": jnp.asarray(rng.integers(0, 2, (n,)), jnp.int32),
    }


def _setup():
    params, state = mms_qa_init(jax.random.PRNGKey(0), TINY)
    solver = make_solver(
        SolverConfig(solver_type="adadelta", weight_decay=5e-4),
        param_spec(params, TINY))
    return params, state, solver, solver.init(params)


class TestMesh:
    def test_make_mesh_shapes(self):
        m = make_mesh(tp=2)
        assert m.shape == {"dp": 4, "tp": 2}
        m1 = make_mesh(tp=1)
        assert m1.shape["dp"] == 8

    def test_make_mesh_rejects_bad_split(self):
        with pytest.raises(ValueError):
            make_mesh(dp=3, tp=2)

    def test_params_pspec_rules(self):
        params, _ = mms_qa_init(jax.random.PRNGKey(0), TINY)
        mesh = make_mesh(tp=2)
        spec = params_pspec(params, mesh)
        assert spec["embed"]["w"] == P("tp")      # 64 rows % 2 == 0
        assert spec["sim"]["w"] == P("tp")        # 2 measures % 2 == 0
        assert spec["conv0"]["w"] == P()
        assert spec["fc1"]["w"] == P()

    def test_params_pspec_indivisible_stays_replicated(self):
        cfg = MMSQAConfig(**{**TINY.__dict__, "vocab_size": 63,
                             "sim_measures": 3})
        params, _ = mms_qa_init(jax.random.PRNGKey(0), cfg)
        spec = params_pspec(params, make_mesh(tp=2))
        assert spec["embed"]["w"] == P()
        assert spec["sim"]["w"] == P()


class TestShardedTrainStep:
    def test_multi_device_matches_single_device(self):
        # same global batch, same seed: dp=4 x tp=2 must equal single-device.
        # Uses a non-degenerate init (xavier metric): at the recipe's
        # zero-init the sim map is all zero, BN variance is exactly 0, and
        # rsqrt(var + 1e-9) amplifies mere reduction-order noise by ~3e4x,
        # which is not a sharding bug (single-device reduction-order changes
        # do the same).
        # SGD (linear in the gradient) isolates the collective's numerics;
        # AdaDelta's g/sqrt(EMA(g^2)) normalization turns near-zero-gradient
        # reduction-order noise into sign flips of the whole update and is
        # deliberately not under test here (its recurrence is covered by
        # test_optim.py).
        cfg = MMSQAConfig(**{**TINY.__dict__, "sim_weight_init": "xavier"})
        params, state = mms_qa_init(jax.random.PRNGKey(0), cfg)
        solver = make_solver(
            SolverConfig(solver_type="sgd", base_lr=0.1, momentum=0.9,
                         weight_decay=5e-4),
            param_spec(params, cfg))
        opt_state = solver.init(params)
        batch = _batch(16)
        rng = jax.random.PRNGKey(7)

        def plain_step(params, state, opt_state, batch, it, rng):
            from mms_answer_selection_tpu.models.mms_qa import mms_qa_apply

            def loss_fn(p):
                out, new_state = mms_qa_apply(p, state, batch, cfg,
                                              train=True, rng=rng)
                return out["loss"], new_state

            (loss, new_state), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            p2, o2 = solver.apply(params, grads, opt_state, it)
            return p2, new_state, o2, loss

        single = jax.jit(plain_step)
        p1, s1, o1, l1 = single(params, state, opt_state, batch,
                                jnp.asarray(0), rng)

        mesh = make_mesh(tp=2)
        step = build_sharded_train_step(cfg, solver, mesh,
                                        donate=False)(params, state,
                                                      opt_state)
        p2, s2, o2, l2 = step(params, state, opt_state, batch,
                              jnp.asarray(0), rng)

        assert float(l1) == pytest.approx(float(l2), rel=1e-5)
        # atol 1e-4: reduction-order noise on near-zero gradient sums (e.g.
        # conv bias grads summed over N*H*W) measures ~3e-5 absolute between
        # layouts; anything structural would be orders larger
        for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=2e-3, atol=1e-4)
        for a, b in zip(jax.tree.leaves(s1), jax.tree.leaves(s2)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=2e-3, atol=1e-4)

    @pytest.mark.parametrize("solver_type,tp", [
        ("adadelta", 1), ("adadelta", 2), ("adam", 2)])
    def test_production_solvers_match_single_device(self, solver_type, tp):
        """The reference verifies EVERY solver multi-device
        (test_gradient_based_solver.cpp:459-488); this covers the
        production recipe's AdaDelta (and Adam) over dp and dp x tp
        layouts for 3 consecutive steps, exercising the h/h2 history
        recurrences through the collective.

        Xavier metric init keeps gradients out of the rsqrt(1e-9) noise
        regime (see test_multi_device_matches_single_device); tolerances
        are looser than SGD's because AdaDelta/Adam divide by sqrt(EMA(g^2))
        -- reduction-order noise on a gradient of magnitude ~1e-6 becomes a
        relative update error of the same order, compounded over steps."""
        cfg = MMSQAConfig(**{**TINY.__dict__, "sim_weight_init": "xavier"})
        params, state = mms_qa_init(jax.random.PRNGKey(0), cfg)
        base_lr = 1.0 if solver_type == "adadelta" else 0.01
        solver = make_solver(
            SolverConfig(solver_type=solver_type, base_lr=base_lr,
                         momentum=0.95 if solver_type == "adadelta" else 0.9,
                         delta=5e-7 if solver_type == "adadelta" else 1e-8,
                         weight_decay=5e-4),
            param_spec(params, cfg))
        opt_state = solver.init(params)

        from mms_answer_selection_tpu.models.mms_qa import mms_qa_apply

        def plain_step(params, state, opt_state, batch, it, rng):
            def loss_fn(p):
                out, new_state = mms_qa_apply(p, state, batch, cfg,
                                              train=True, rng=rng)
                return out["loss"], new_state

            (loss, new_state), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            p2, o2 = solver.apply(params, grads, opt_state, it)
            return p2, new_state, o2, loss

        single = jax.jit(plain_step)
        mesh = make_mesh(tp=tp)
        sharded = build_sharded_train_step(cfg, solver, mesh,
                                           donate=False)(params, state,
                                                         opt_state)
        p1, s1, o1 = params, state, opt_state
        p2, s2, o2 = params, state, opt_state
        for i in range(3):
            batch = _batch(16, seed=i)
            rng = jax.random.PRNGKey(100 + i)
            p1, s1, o1, l1 = single(p1, s1, o1, batch, jnp.asarray(i), rng)
            p2, s2, o2, l2 = sharded(p2, s2, o2, batch, jnp.asarray(i), rng)
            assert float(l1) == pytest.approx(float(l2), rel=1e-4)
        # conv biases sit immediately before BN, whose mean-subtraction
        # cancels any shift: their TRUE gradient is identically zero, so
        # the measured gradient is pure reduction-order noise.  Adam
        # normalizes that noise to a full +-lr*lr_mult step whose sign
        # differs between layouts -- bound those leaves by the sign-flip
        # envelope 2 * lr_mult(=2) * base_lr * steps instead (AdaDelta's
        # update stays O(g) for tiny g, so it never trips this).
        bias_envelope = 2 * 2 * base_lr * 3 * 1.05
        flat1 = jax.tree_util.tree_flatten_with_path(p1)[0]
        flat2 = jax.tree.leaves(p2)
        for (path, a), b in zip(flat1, flat2):
            name = jax.tree_util.keystr(path)
            a, b = np.asarray(a), np.asarray(b)
            if "conv" in name and "'b'" in name:
                assert np.abs(a - b).max() <= bias_envelope, name
            else:
                np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-4,
                                           err_msg=name)
        # optimizer history must track too (h, and h2 for these solvers);
        # conv-bias history is the square of noise -- compare absolutely
        flat1 = jax.tree_util.tree_flatten_with_path(o1)[0]
        flat2 = jax.tree.leaves(o2)
        for (path, a), b in zip(flat1, flat2):
            name = jax.tree_util.keystr(path)
            a, b = np.asarray(a), np.asarray(b)
            if "conv" in name and "'b'" in name:
                assert np.abs(a - b).max() <= max(1e-6, bias_envelope ** 2)
            else:
                np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-4,
                                           err_msg=name)

    def test_three_steps_stay_consistent(self):
        params, state, solver, opt_state = _setup()
        mesh = make_mesh(tp=1)
        step = build_sharded_train_step(TINY, solver, mesh,
                                        donate=False)(params, state,
                                                      opt_state)
        losses = []
        for i in range(3):
            params, state, opt_state, loss = step(
                params, state, opt_state, _batch(16, seed=i),
                jnp.asarray(i), jax.random.PRNGKey(i))
            losses.append(float(loss))
        assert all(np.isfinite(losses))

    def test_sharded_eval_step(self):
        params, state, *_ = _setup()
        mesh = make_mesh(tp=2)
        ev = build_sharded_eval_step(TINY, mesh)
        prob = ev(params, state, _batch(16))
        assert prob.shape == (16, 2)
        np.testing.assert_allclose(np.asarray(prob).sum(1), 1.0, rtol=1e-5)

    @pytest.mark.parametrize("rows", [16, 13], ids=["divisible", "ragged"])
    def test_trainer_eval_any_split_size(self, rows):
        """A data-parallel Trainer evaluates splits of any size: rows
        shard over dp when they divide evenly, else replicate; either
        way the result equals one device's."""
        from mms_answer_selection_tpu.training import Trainer, TrainerConfig
        batch = _batch(rows, seed=5)
        batch["group"] = jnp.asarray(np.arange(rows) // 4, jnp.int32)
        out = {}
        for name, mesh in (("one", None), ("dp4", make_mesh(
                tp=1, devices=jax.devices()[:4]))):
            tr = Trainer(TINY, TrainerConfig(batch_size=16), mesh=mesh)
            params, state, _ = tr.init()
            out[name] = tr._eval_step(params, state, batch)
        np.testing.assert_allclose(np.asarray(out["dp4"]["prob"]),
                                   np.asarray(out["one"]["prob"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(out["dp4"]["map"]),
                                   float(out["one"]["map"]), rtol=1e-6)


class TestGraftEntry:
    def test_entry_compiles(self):
        import sys
        sys.path.insert(0, "/root/repo")
        import __graft_entry__ as ge
        fn, args = ge.entry()
        logits, loss = jax.jit(fn)(*args)
        assert logits.shape[1] == 2 and np.isfinite(float(loss))

    def test_dryrun_multichip(self):
        import __graft_entry__ as ge
        ge.dryrun_multichip(8)
