"""End-to-end training-loop tests on a hermetic synthetic corpus: the
minimum E2E slice of SURVEY.md §7 (data -> model -> AdaDelta -> metrics ->
early stop -> checkpoint)."""

import dataclasses

import jax
import numpy as np
import pytest

from mms_answer_selection_tpu.data import prepare_trec_qa, synthetic_corpus
from mms_answer_selection_tpu.models.mms_qa import ConvBlock, MMSQAConfig
from mms_answer_selection_tpu.training import (
    SolverConfig,
    Trainer,
    TrainerConfig,
    load_checkpoint,
    latest_checkpoint,
    save_checkpoint,
)


def _tiny_setup(seed=1):
    xml, w2v = synthetic_corpus(n_questions=10, answers_per_q=6, seed=seed)
    splits, info = prepare_trec_qa(xml, xml, xml, w2v)
    model_cfg = MMSQAConfig(
        vocab_size=info["vocab_size"],
        embed_dim=50,
        question_len=12, answer_len=12,
        sim_measures=2,
        blocks=(ConvBlock(3, 3, 8, "ave", 2, 2), ConvBlock(3, 3, 8, "ave", 3, 1)),
        fc1_dim=8,
    )
    # re-encode at length 12
    splits, info = prepare_trec_qa(xml, xml, xml, w2v)
    for s in splits.values():
        s["question"] = s["question"][:, 14:26]
        s["answer"] = s["answer"][:, 14:26]
    return splits, info, model_cfg


@pytest.fixture(scope="module")
def trained():
    splits, info, model_cfg = _tiny_setup()
    tcfg = TrainerConfig(
        solver=SolverConfig(solver_type="adadelta", base_lr=1.0,
                            momentum=0.95, delta=5e-7, weight_decay=5e-4),
        max_iter=120, batch_size=15, test_interval=20,
        snapshot_interval=0, early_stop_patience=50, seed=22)
    trainer = Trainer(model_cfg, tcfg)
    hist = trainer.fit(splits["train"], splits["dev"],
                       pretrained=info["pretrained"])
    return trainer, hist, splits, info, model_cfg


class TestFit:
    def test_loss_decreases(self, trained):
        _, hist, *_ = trained
        losses = hist["train_loss"]
        assert len(losses) >= 3
        assert losses[-1] < losses[0]

    def test_dev_map_beats_random(self, trained):
        # synthetic positives share words with the question (overlap feature
        # alone is predictive) -- trained MAP must beat the ~0.5-0.6 of a
        # random ranking over 2-pos/4-neg groups
        _, hist, *_ = trained
        assert hist["best_dev_map"] > 0.65

    def test_history_structure(self, trained):
        _, hist, *_ = trained
        assert len(hist["dev_map"]) == len(hist["steps"])
        assert hist["best_step"] in hist["steps"]
        assert hist["params"] is not None

    def test_evaluate_full_split(self, trained):
        trainer, hist, splits, *_ = trained
        res = trainer.evaluate(hist["params"], hist["state"], splits["test"])
        assert 0.0 <= res["map"] <= 1.0 + 1e-5  # f32 accumulation epsilon
        assert res["prob"].shape[0] == len(splits["test"]["label"])


class TestEarlyStop:
    def test_patience_stops_training(self):
        splits, info, model_cfg = _tiny_setup(seed=3)
        tcfg = TrainerConfig(
            solver=SolverConfig(solver_type="adadelta"),
            max_iter=5000, batch_size=15, test_interval=10,
            snapshot_interval=0, early_stop_patience=1, seed=22)
        trainer = Trainer(model_cfg, tcfg)
        hist = trainer.fit(splits["train"], splits["dev"],
                           pretrained=info["pretrained"])
        # 60 rows / bs 15 -> 4 steps per epoch; patience 1 must stop long
        # before max_iter
        assert hist["steps"][-1] < 1000


class TestCheckpoint:
    def test_roundtrip(self, tmp_path, trained):
        trainer, hist, splits, info, model_cfg = trained
        bundle = {"params": hist["params"], "state": hist["state"]}
        save_checkpoint(str(tmp_path), 7, bundle, meta={"dev_map": 0.5})
        path = latest_checkpoint(str(tmp_path))
        assert path.endswith("qa_iter_7")
        restored, meta = load_checkpoint(path, template=bundle)
        assert meta["step"] == 7 and meta["dev_map"] == 0.5
        a = jax.tree.leaves(bundle)
        b = jax.tree.leaves(restored)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        # restored params give identical eval scores
        r1 = trainer.evaluate(bundle["params"], bundle["state"], splits["dev"])
        r2 = trainer.evaluate(restored["params"], restored["state"],
                              splits["dev"])
        np.testing.assert_allclose(r1["prob"], r2["prob"], rtol=1e-6)

    def test_latest_picks_highest(self, tmp_path):
        for step in (3, 10, 7):
            save_checkpoint(str(tmp_path), step, {"x": np.zeros(2)})
        assert latest_checkpoint(str(tmp_path)).endswith("qa_iter_10")

    def test_snapshot_during_fit(self, tmp_path):
        splits, info, model_cfg = _tiny_setup(seed=5)
        tcfg = TrainerConfig(
            solver=SolverConfig(solver_type="adadelta"),
            max_iter=25, batch_size=15, test_interval=10,
            snapshot_interval=10, early_stop_patience=50, seed=22,
            snapshot_dir=str(tmp_path))
        Trainer(model_cfg, tcfg).fit(splits["train"], splits["dev"],
                                     pretrained=info["pretrained"])
        assert latest_checkpoint(str(tmp_path)) is not None


class TestDeterminism:
    def test_same_seed_same_result(self):
        splits, info, model_cfg = _tiny_setup(seed=7)
        tcfg = TrainerConfig(
            solver=SolverConfig(solver_type="adadelta"),
            max_iter=15, batch_size=15, test_interval=10,
            snapshot_interval=0, early_stop_patience=50, seed=22)
        h1 = Trainer(model_cfg, tcfg).fit(splits["train"], splits["dev"],
                                          pretrained=info["pretrained"])
        h2 = Trainer(model_cfg, tcfg).fit(splits["train"], splits["dev"],
                                          pretrained=info["pretrained"])
        np.testing.assert_allclose(h1["train_loss"], h2["train_loss"],
                                   rtol=1e-5)


class TestWideConfig:
    def test_v4_wide_300d_trains(self):
        # BASELINE configs[1]: 300d embeddings + wider encoder; also covers
        # the wide-D padding path of the retrieval kernels downstream
        import dataclasses
        from mms_answer_selection_tpu.models.mms_qa import V4_WIDE
        splits, info, _ = _tiny_setup(seed=13)
        cfg = dataclasses.replace(
            V4_WIDE, vocab_size=info["vocab_size"], embed_dim=50,
            question_len=12, answer_len=12,
            blocks=(ConvBlock(3, 3, 16, "ave", 2, 2),
                    ConvBlock(3, 3, 32, "ave", 3, 1)), fc1_dim=16)
        tcfg = TrainerConfig(
            solver=SolverConfig(solver_type="adadelta"),
            max_iter=25, batch_size=15, test_interval=10,
            snapshot_interval=0, early_stop_patience=99, seed=22)
        hist = Trainer(cfg, tcfg).fit(splits["train"], splits["dev"],
                                      pretrained=info["pretrained"])
        assert np.isfinite(hist["train_loss"]).all()

    def test_kernel_with_300d_vectors(self):
        # retrieval kernels at D=300 (int8 Dp pads to 320 = 256 + 64)
        import jax.numpy as jnp
        from mms_answer_selection_tpu.ops.sim_cross_pallas import (
            BLOCK_C, bilinear_maxsim_scores_int8,
            bilinear_maxsim_scores_reference, pack_candidate_pool_int8,
            project_queries_int8)
        r = np.random.default_rng(3)
        q = jnp.asarray(r.normal(size=(2, 5, 300)).astype(np.float32))
        cand = jnp.asarray(r.normal(size=(BLOCK_C, 7, 300)).astype(np.float32))
        w = jnp.asarray(r.normal(size=(2, 300, 300)).astype(np.float32) * 0.05)
        ref = np.asarray(bilinear_maxsim_scores_reference(q, cand, w))
        qw, qs = project_queries_int8(q, w)
        pool, aux = pack_candidate_pool_int8(cand)
        out = np.asarray(bilinear_maxsim_scores_int8(qw, qs, pool, aux,
                                                     interpret=True))
        np.testing.assert_allclose(out, ref, atol=0.05 * np.abs(ref).max())


class TestScanTrainSteps:
    """Fused K-step dispatch (scan_train_steps) runs the exact rng/data
    chain of K sequential _train_step calls; values agree to float
    tolerance (XLA reassociates ~1 ULP when fusing the scan body)."""

    def _equiv(self, mesh=None):
        import jax.numpy as jnp
        splits, info, model_cfg = _tiny_setup(seed=9)
        tcfg = TrainerConfig(
            solver=SolverConfig(solver_type="adadelta", base_lr=1.0,
                                momentum=0.95, delta=5e-7,
                                weight_decay=5e-4),
            max_iter=10, batch_size=8, snapshot_interval=0, seed=22)
        # donate=False: the sequential path reuses its inputs
        trainer = Trainer(model_cfg, tcfg, mesh=mesh, donate=False)
        params, state, opt_state = trainer.init(
            pretrained=info["pretrained"])
        root_key = jax.random.PRNGKey(tcfg.seed)
        k = 4
        rng = np.random.default_rng(0)
        idx = [rng.integers(0, len(splits["train"]["label"]), 8)
               for _ in range(k)]
        seq_batches = [{kk: jnp.asarray(v[i]) for kk, v in
                        splits["train"].items() if kk != "group"}
                       for i in idx]

        p_s, s_s, o_s = params, state, opt_state
        losses_seq = []
        for i, b in enumerate(seq_batches):
            p_s, s_s, o_s, loss = trainer._train_step(
                p_s, s_s, o_s, b, jnp.asarray(3 + i),
                jax.random.fold_in(root_key, 3 + i))
            losses_seq.append(float(loss))

        stacked = {kk: jnp.stack([b[kk] for b in seq_batches])
                   for kk in seq_batches[0]}
        p_f, s_f, o_f, losses = trainer.scan_train_steps(
            params, state, opt_state, stacked, 3, root_key)

        np.testing.assert_allclose(np.asarray(losses), losses_seq,
                                   rtol=1e-5)
        for a, b in zip(jax.tree.leaves(p_s), jax.tree.leaves(p_f)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-4, atol=1e-6)
        for a, b in zip(jax.tree.leaves(o_s), jax.tree.leaves(o_f)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-4, atol=1e-6)

    def test_bit_equivalent_single_device(self):
        self._equiv()

    def test_bit_equivalent_dp_mesh(self):
        from mms_answer_selection_tpu.parallel import make_mesh
        self._equiv(mesh=make_mesh())


class TestFitFusedDispatch:
    """fit(steps_per_dispatch=K) records a step-identical history to K=1
    (same steps, same evals/snapshots; values to float tolerance)."""

    def test_history_matches_k1(self, tmp_path):
        splits, info, model_cfg = _tiny_setup(seed=11)
        def run(k, snapdir):
            tcfg = TrainerConfig(
                solver=SolverConfig(solver_type="adadelta", base_lr=1.0,
                                    momentum=0.95, delta=5e-7,
                                    weight_decay=5e-4),
                max_iter=60, batch_size=10, test_interval=20,
                snapshot_interval=20, early_stop_patience=50, seed=22,
                snapshot_dir=str(snapdir))
            trainer = Trainer(model_cfg, tcfg)
            return trainer.fit(splits["train"], splits["dev"],
                               pretrained=info["pretrained"],
                               steps_per_dispatch=k)
        h1 = run(1, tmp_path / "k1")
        hk = run(20, tmp_path / "k20")
        assert h1["steps"] == hk["steps"]
        np.testing.assert_allclose(hk["train_loss"], h1["train_loss"],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(hk["dev_map"], h1["dev_map"],
                                   rtol=1e-4, atol=1e-5)
        assert hk["best_step"] == h1["best_step"]
        # same snapshots on disk (boundary planner hit every multiple)
        s1 = sorted(p.name for p in (tmp_path / "k1").iterdir())
        sk = sorted(p.name for p in (tmp_path / "k20").iterdir())
        assert s1 == sk

    def test_odd_k_still_lands_boundaries(self, tmp_path):
        splits, info, model_cfg = _tiny_setup(seed=11)
        tcfg = TrainerConfig(
            solver=SolverConfig(solver_type="adadelta", base_lr=1.0,
                                momentum=0.95, delta=5e-7,
                                weight_decay=5e-4),
            max_iter=45, batch_size=10, test_interval=20,
            snapshot_interval=0, early_stop_patience=50, seed=22)
        trainer = Trainer(model_cfg, tcfg)
        h = trainer.fit(splits["train"], splits["dev"],
                        pretrained=info["pretrained"], steps_per_dispatch=7)
        assert h["steps"] == [0, 20, 40]
