"""Snapshot / resume / finetune tests.

The reference pattern is test_gradient_based_solver.cpp:490-540
(TestSnapshot): run N iterations continuously, then run k, snapshot,
restore into a fresh solver, run N-k more -- the two parameter sets (and
the full optimizer history) must match bit-for-bit for every solver type.
Finetuning (`caffe train -weights`) loads params by name+shape with
mismatches skipped (net.cpp:741-777, tools/caffe.cpp:211-213).
"""

import json
import os

import jax
import numpy as np
import pytest

from mms_answer_selection_tpu.data import prepare_trec_qa, synthetic_corpus
from mms_answer_selection_tpu.models.mms_qa import (
    ConvBlock,
    MMSQAConfig,
    mms_qa_init,
)
from mms_answer_selection_tpu.training import (
    SolverConfig,
    Trainer,
    TrainerConfig,
    load_checkpoint,
    save_checkpoint,
)
from mms_answer_selection_tpu.training.checkpoint import (
    copy_matching,
    load_weights_into,
)

SOLVERS = ["sgd", "nesterov", "adagrad", "rmsprop", "adadelta", "adam"]


@pytest.fixture(scope="module")
def corpus():
    xml, w2v = synthetic_corpus(n_questions=10, answers_per_q=6, seed=3)
    splits, info = prepare_trec_qa(xml, xml, xml, w2v)
    for s in splits.values():
        s["question"] = s["question"][:, 14:26]
        s["answer"] = s["answer"][:, 14:26]
    model_cfg = MMSQAConfig(
        vocab_size=info["vocab_size"], embed_dim=50,
        question_len=12, answer_len=12, sim_measures=2,
        blocks=(ConvBlock(3, 3, 8, "ave", 2, 2),
                ConvBlock(3, 3, 8, "ave", 3, 1)),
        fc1_dim=8)
    return splits, info, model_cfg


def _tcfg(solver_type, snapshot_dir, max_iter=12):
    return TrainerConfig(
        solver=SolverConfig(solver_type=solver_type,
                            base_lr=0.1 if solver_type in
                            ("sgd", "nesterov") else 1.0,
                            weight_decay=5e-4),
        max_iter=max_iter, batch_size=15, test_interval=6,
        snapshot_interval=1, early_stop_patience=99, seed=22,
        snapshot_dir=snapshot_dir)


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


class TestSnapshotRestoreEquivalence:
    """train 12 == train 5 + snapshot + restore + train 7, for every
    solver, comparing params AND optimizer history bit-for-bit."""

    @pytest.mark.parametrize("solver_type", SOLVERS)
    def test_solver(self, corpus, tmp_path, solver_type):
        splits, info, model_cfg = corpus
        dir_a = str(tmp_path / "a")
        dir_b = str(tmp_path / "b")

        # continuous run: 12 steps, snapshot every step
        tr_a = Trainer(model_cfg, _tcfg(solver_type, dir_a))
        tr_a.fit(splits["train"], splits["dev"],
                 pretrained=info["pretrained"])

        # interrupted run: fresh Trainer resumes from the step-4 snapshot
        # (mid-permutation-pass: steps_per_pass = ceil(60/15) = 4, so step
        # 5 starts one batch into pass 2's permutation)
        tr_b = Trainer(model_cfg, _tcfg(solver_type, dir_b))
        tr_b.fit(splits["train"], splits["dev"],
                 pretrained=info["pretrained"],
                 resume_from=os.path.join(dir_a, "qa_iter_4"))

        ba, _ = load_checkpoint(os.path.join(dir_a, "qa_iter_11"))
        bb, _ = load_checkpoint(os.path.join(dir_b, "qa_iter_11"))
        _leaves_equal(ba["params"], bb["params"])
        _leaves_equal(ba["state"], bb["state"])
        _leaves_equal(ba["opt_state"], bb["opt_state"])

    def test_resume_from_snapshot_root_uses_latest(self, corpus, tmp_path):
        splits, info, model_cfg = corpus
        dir_a = str(tmp_path / "a")
        tr = Trainer(model_cfg, _tcfg("adadelta", dir_a, max_iter=5))
        tr.fit(splits["train"], splits["dev"], pretrained=info["pretrained"])
        # resuming the DIRECTORY picks qa_iter_4 and trains 5..11
        tr2 = Trainer(model_cfg, _tcfg("adadelta", dir_a, max_iter=12))
        hist = tr2.fit(splits["train"], splits["dev"],
                       pretrained=info["pretrained"], resume_from=dir_a)
        assert os.path.exists(os.path.join(dir_a, "qa_iter_11"))
        assert hist["best_step"] >= 0

    def test_resume_restores_history_and_counters(self, corpus, tmp_path):
        splits, info, model_cfg = corpus
        dir_a = str(tmp_path / "a")
        tr = Trainer(model_cfg, _tcfg("adadelta", dir_a, max_iter=8))
        h1 = tr.fit(splits["train"], splits["dev"],
                    pretrained=info["pretrained"])
        with open(os.path.join(dir_a, "qa_iter_7", "meta.json")) as f:
            meta = json.load(f)
        assert meta["step"] == 7
        assert "epoch" in meta and "wait_epoch" in meta
        assert meta["history"]["dev_map"] == h1["dev_map"]

        tr2 = Trainer(model_cfg, _tcfg("adadelta", dir_a, max_iter=12))
        h2 = tr2.fit(splits["train"], splits["dev"],
                     pretrained=info["pretrained"], resume_from=dir_a)
        # curves continue, not restart: evals at 0 and 6 are inherited
        assert h2["steps"][: len(h1["steps"])] == h1["steps"]
        assert h2["dev_map"][: len(h1["dev_map"])] == h1["dev_map"]
        # the pre-resume best is preserved (reloaded from its snapshot)
        assert h2["best_dev_map"] >= h1["best_dev_map"]
        assert h2["params"] is not None

    def test_resume_and_weights_exclusive(self, corpus, tmp_path):
        splits, info, model_cfg = corpus
        tr = Trainer(model_cfg, _tcfg("sgd", str(tmp_path)))
        with pytest.raises(ValueError):
            tr.fit(splits["train"], splits["dev"],
                   resume_from="x", weights="y")


class TestFinetune:
    def test_copy_matching_reports(self):
        tpl = {"a": np.zeros((2, 3)), "b": {"w": np.zeros(4)},
               "c": np.zeros(5)}
        src = {"a": np.ones((2, 3)), "b": {"w": np.ones(9)}}
        merged, report = copy_matching(tpl, src)
        assert report == {"a": "loaded", "b/w": "shape_mismatch",
                          "c": "missing"}
        np.testing.assert_array_equal(merged["a"], 1.0)
        np.testing.assert_array_equal(merged["b"]["w"], 0.0)
        np.testing.assert_array_equal(merged["c"], 0.0)

    def test_copy_matching_sequence_nodes(self):
        """Tuple/list pytree nodes merge element-wise, including the
        checkpoint convention of sequences loaded as {str(i): v} dicts."""
        tpl = {"stack": (np.zeros(2), np.zeros(3)),
               "hist": [np.zeros(1), np.zeros(1)]}
        src = {"stack": {"0": np.ones(2), "1": np.ones(9)},  # loaded dict
               "hist": [np.full(1, 5.0)]}                    # short list
        merged, report = copy_matching(tpl, src)
        assert isinstance(merged["stack"], tuple)
        assert report["stack/0"] == "loaded"
        assert report["stack/1"] == "shape_mismatch"
        assert report["hist/0"] == "loaded"
        assert report["hist/1"] == "missing"
        np.testing.assert_array_equal(merged["stack"][0], 1.0)
        np.testing.assert_array_equal(merged["stack"][1], 0.0)
        np.testing.assert_array_equal(merged["hist"][0], 5.0)
        np.testing.assert_array_equal(merged["hist"][1], 0.0)

    def test_latest_checkpoint_missing_dir(self, tmp_path):
        from mms_answer_selection_tpu.training.checkpoint import \
            latest_checkpoint

        assert latest_checkpoint(str(tmp_path / "nope")) is None

    def test_load_weights_into_cross_config(self, corpus, tmp_path):
        """Finetune a wider-fc model from a trained narrow one: shared
        layers (embed/sim/conv) load, the mismatched fc is kept at init."""
        splits, info, model_cfg = corpus
        dir_a = str(tmp_path / "src")
        tr = Trainer(model_cfg, _tcfg("adadelta", dir_a, max_iter=4))
        tr.fit(splits["train"], splits["dev"], pretrained=info["pretrained"])

        import dataclasses
        wide_cfg = dataclasses.replace(model_cfg, fc1_dim=16)
        params, state = mms_qa_init(jax.random.PRNGKey(0), wide_cfg)
        fc_before = np.asarray(params["fc1"]["w"]).copy()
        params2, state2, report = load_weights_into(
            params, state, os.path.join(dir_a, "qa_iter_3"))
        src, _ = load_checkpoint(os.path.join(dir_a, "qa_iter_3"))
        np.testing.assert_array_equal(np.asarray(params2["embed"]["w"]),
                                      src["params"]["embed"]["w"])
        np.testing.assert_array_equal(np.asarray(params2["fc1"]["w"]),
                                      fc_before)
        assert report["embed/w"] == "loaded"
        assert any(v == "shape_mismatch" for v in report.values())

    def test_fit_with_weights_trains(self, corpus, tmp_path):
        splits, info, model_cfg = corpus
        dir_a = str(tmp_path / "src")
        tr = Trainer(model_cfg, _tcfg("adadelta", dir_a, max_iter=4))
        tr.fit(splits["train"], splits["dev"], pretrained=info["pretrained"])
        tr2 = Trainer(model_cfg, _tcfg("adadelta", None, max_iter=3))
        hist = tr2.fit(splits["train"], splits["dev"],
                       weights=os.path.join(dir_a, "qa_iter_3"))
        assert np.isfinite(hist["train_loss"]).all()


class TestCLIResume:
    def test_train_resume_continues(self, tmp_path, capsys):
        from mms_answer_selection_tpu.cli import main
        from mms_answer_selection_tpu.models.mms_qa import MMSQAConfig
        from mms_answer_selection_tpu.utils.config import experiment_to_json

        xml, w2v = synthetic_corpus(n_questions=8, answers_per_q=5, seed=4)
        xml_path = tmp_path / "data.xml"
        xml_path.write_text(xml)
        glove = tmp_path / "glove.txt"
        with open(glove, "w") as f:
            for w, v in w2v.items():
                f.write(w + " " + " ".join(f"{x:.5f}" for x in v) + "\n")
        out = tmp_path / "prep"
        main(["prep", "--train-xml", str(xml_path), "--dev-xml",
              str(xml_path), "--test-xml", str(xml_path), "--glove",
              str(glove), "--out", str(out), "--q-len", "12",
              "--a-len", "12"])
        meta = json.loads((out / "meta.json").read_text())
        exp = tmp_path / "exp"
        model = MMSQAConfig(
            vocab_size=meta["vocab_size"], embed_dim=50,
            question_len=12, answer_len=12, sim_measures=2,
            blocks=(ConvBlock(3, 3, 4, "ave", 2, 2),
                    ConvBlock(3, 3, 4, "ave", 3, 1)),
            fc1_dim=4)
        tcfg = TrainerConfig(solver=SolverConfig(), max_iter=6,
                             batch_size=10, test_interval=5,
                             snapshot_interval=1, early_stop_patience=99,
                             snapshot_dir=str(exp / "models"))
        cfg_path = tmp_path / "config.json"
        cfg_path.write_text(experiment_to_json(model, tcfg))
        main(["train", "--data", str(out), "--exp", str(exp), "--config",
              str(cfg_path)])
        capsys.readouterr()
        assert (exp / "models" / "qa_iter_5").exists()

        # resume with a longer budget; the saved <exp>/config.json carries
        # the architecture, but max_iter comes from the new --config
        tcfg2 = TrainerConfig(solver=SolverConfig(), max_iter=10,
                              batch_size=10, test_interval=5,
                              snapshot_interval=1, early_stop_patience=99,
                              snapshot_dir=str(exp / "models"))
        cfg2 = tmp_path / "config2.json"
        cfg2.write_text(experiment_to_json(model, tcfg2))
        main(["train", "--data", str(out), "--exp", str(exp), "--config",
              str(cfg2), "--resume"])
        out2 = capsys.readouterr().out
        assert "best dev MAP" in out2
        assert (exp / "models" / "qa_iter_9").exists()
        hist = json.loads((exp / "history.json").read_text())
        assert hist["steps"] == [0, 5]  # eval curve spans both runs
