"""Config roundtrip + CLI end-to-end on a hermetic synthetic corpus."""

import json
import os

import numpy as np
import pytest

from mms_answer_selection_tpu.models.mms_qa import ConvBlock, MMSQAConfig, V4
from mms_answer_selection_tpu.training import SolverConfig, TrainerConfig
from mms_answer_selection_tpu.utils.config import (
    experiment_from_json,
    experiment_to_json,
)


class TestConfig:
    def test_roundtrip(self):
        model = MMSQAConfig(vocab_size=123, sim_measures=3,
                            blocks=(ConvBlock(3, 3, 8, "max", 2, 2),))
        trainer = TrainerConfig(
            solver=SolverConfig(solver_type="adam", stepvalues=(5, 10)),
            max_iter=77)
        text = experiment_to_json(model, trainer)
        m2, t2 = experiment_from_json(text)
        assert m2 == model
        assert t2 == trainer

    def test_v0_migration(self):
        raw = json.loads(experiment_to_json(V4, TrainerConfig()))
        del raw["config_version"]
        m2, t2 = experiment_from_json(json.dumps(raw))
        assert m2 == V4

    def test_unknown_version_rejected(self):
        raw = json.loads(experiment_to_json(V4, TrainerConfig()))
        raw["config_version"] = -5
        with pytest.raises(ValueError):
            experiment_from_json(json.dumps(raw))


class TestCLI:
    @pytest.fixture(scope="class")
    def prepped(self, tmp_path_factory):
        from mms_answer_selection_tpu.cli import main
        from mms_answer_selection_tpu.data.trec_qa import synthetic_corpus

        root = tmp_path_factory.mktemp("cli")
        xml, w2v = synthetic_corpus(n_questions=8, answers_per_q=5, seed=4)
        xml_path = root / "data.xml"
        xml_path.write_text(xml)
        glove = root / "glove.txt"
        with open(glove, "w") as f:
            for w, v in w2v.items():
                f.write(w + " " + " ".join(f"{x:.5f}" for x in v) + "\n")
        out = root / "prep"
        main(["prep", "--train-xml", str(xml_path), "--dev-xml",
              str(xml_path), "--test-xml", str(xml_path), "--glove",
              str(glove), "--out", str(out), "--q-len", "12",
              "--a-len", "12"])
        return root, out

    def test_prep_artifacts(self, prepped):
        root, out = prepped
        for name in ("train.npz", "dev.npz", "test.npz", "vocab.npz",
                     "meta.json"):
            assert (out / name).exists()
        meta = json.loads((out / "meta.json").read_text())
        assert meta["q_len"] == 12
        with np.load(out / "train.npz") as z:
            assert z["question"].shape[1] == 12

    def test_train_eval_serve(self, prepped, capsys):
        from mms_answer_selection_tpu.cli import main
        from mms_answer_selection_tpu.utils.config import experiment_to_json
        from mms_answer_selection_tpu.training import (SolverConfig,
                                                       TrainerConfig)
        from mms_answer_selection_tpu.models.mms_qa import (ConvBlock,
                                                            MMSQAConfig)

        root, out = prepped
        meta = json.loads((out / "meta.json").read_text())
        exp = root / "exp"
        exp.mkdir(exist_ok=True)
        model = MMSQAConfig(
            vocab_size=meta["vocab_size"], embed_dim=50,
            question_len=12, answer_len=12, sim_measures=2,
            blocks=(ConvBlock(3, 3, 4, "ave", 2, 2),
                    ConvBlock(3, 3, 4, "ave", 3, 1)),
            fc1_dim=4)
        trainer = TrainerConfig(solver=SolverConfig(), max_iter=30,
                                batch_size=10, test_interval=10,
                                snapshot_interval=0, early_stop_patience=99)
        cfg_path = root / "config.json"
        cfg_path.write_text(experiment_to_json(model, trainer))

        main(["train", "--data", str(out), "--exp", str(exp), "--config",
              str(cfg_path)])
        out1 = capsys.readouterr().out
        assert "best dev MAP" in out1
        assert (exp / "history.json").exists()

        main(["eval", "--data", str(out), "--exp", str(exp), "--config",
              str(cfg_path)])
        ev = json.loads(capsys.readouterr().out.strip().split("\n")[-1])
        assert 0.0 <= ev["in_graph_map"] <= 1.0

        main(["serve", "--data", str(out), "--exp", str(exp), "--config",
              str(cfg_path), "--k", "3", "--n-queries", "2"])
        lines = capsys.readouterr().out.strip().split("\n")
        rec = json.loads(lines[-1])
        assert len(rec["topk"]) == 3

        # quantized pool flags: --int8 compat switch and --pool-dtype int8
        main(["serve", "--data", str(out), "--exp", str(exp), "--config",
              str(cfg_path), "--k", "3", "--n-queries", "1", "--int8"])
        rec8 = json.loads(capsys.readouterr().out.strip().split("\n")[-1])
        assert len(rec8["topk"]) == 3
        main(["serve", "--data", str(out), "--exp", str(exp), "--config",
              str(cfg_path), "--k", "3", "--n-queries", "1",
              "--pool-dtype", "int8"])
        rec_pd = json.loads(
            capsys.readouterr().out.strip().split("\n")[-1])
        assert rec_pd["topk"] == rec8["topk"]
        # quantized top-k stays close to exact for this tiny pool
        exact = {i for i, _ in rec["topk"]}
        assert len(exact & {i for i, _ in rec8["topk"]}) >= 1

        # two-phase serve: int8 shortlist -> exact-model rerank, values
        # become probabilities
        main(["serve", "--data", str(out), "--exp", str(exp), "--config",
              str(cfg_path), "--k", "3", "--n-queries", "1", "--int8",
              "--rerank", "8"])
        rr = json.loads(capsys.readouterr().out.strip().split("\n")[-1])
        assert len(rr["topk"]) == 3
        assert all(0.0 <= v <= 1.0 for _, v in rr["topk"])

        # persistent service: qa serve --listen 0 binds an ephemeral
        # port, answers text + token queries over HTTP, and stops via
        # the module shutdown hook (serve/server.py)
        import threading
        import time as _time
        import urllib.request

        import mms_answer_selection_tpu.cli as cli_mod

        cli_mod._LAST_SERVER = None
        th = threading.Thread(
            target=main,
            args=(["serve", "--data", str(out), "--exp", str(exp),
                   "--config", str(cfg_path), "--k", "3",
                   "--listen", "0"],),
            daemon=True)
        th.start()
        for _ in range(600):
            if getattr(cli_mod, "_LAST_SERVER", None) is not None:
                break
            _time.sleep(0.1)
        srv = cli_mod._LAST_SERVER
        assert srv is not None, "serve --listen never came up"
        base = f"http://{srv.host}:{srv.port}"
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            h = json.loads(r.read())
        assert h["ok"] and h["pool"] > 0 and h["text_queries"]
        req = urllib.request.Request(
            base + "/query",
            data=json.dumps({"text": "what is a cat"}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            q = json.loads(r.read())
        assert len(q["results"]) == 1 and len(q["results"][0]["topk"]) == 3
        srv.httpd.shutdown()
        th.join(timeout=30)
        assert not th.is_alive()
        vs = [v for _, v in rr["topk"]]
        assert vs == sorted(vs, reverse=True)

        # --index PATH: first run builds + saves, second run warm-loads
        # (QueryEngine.save_index/load_index) and answers identically
        capsys.readouterr()  # drop the --listen thread's banner
        idx_path = str(root / "serve_index.npz")
        main(["serve", "--data", str(out), "--exp", str(exp), "--config",
              str(cfg_path), "--k", "3", "--n-queries", "2",
              "--index", idx_path])
        lines = capsys.readouterr().out.strip().split("\n")
        assert json.loads(lines[0]).get("index_saved") == idx_path
        cold = [json.loads(ln) for ln in lines[1:]]
        main(["serve", "--data", str(out), "--exp", str(exp), "--config",
              str(cfg_path), "--k", "3", "--n-queries", "2",
              "--index", idx_path])
        lines = capsys.readouterr().out.strip().split("\n")
        hdr = json.loads(lines[0])
        assert hdr.get("index_loaded") == idx_path and hdr["pool"] > 0
        warm = [json.loads(ln) for ln in lines[1:]]
        assert warm == cold

        # qa export: freeze the deployable StableHLO artifact and
        # replay it without the model code (deploy.py)
        art = str(root / "model.mmsx")
        main(["export", "--data", str(out), "--exp", str(exp),
              "--config", str(cfg_path), "--out", art,
              "--platforms", "cpu"])
        hx = json.loads(capsys.readouterr().out.strip().split("\n")[-1])
        assert hx["out"] == art and hx["question_len"] == 12
        from mms_answer_selection_tpu.deploy import load_scorer
        sc = load_scorer(art)
        probs = sc.score(
            np.zeros((2, hx["question_len"]), np.int32),
            np.zeros((2, hx["answer_len"]), np.int32),
            np.zeros((2, hx["overlap_features"]), np.float32))
        assert probs.shape == (2,) and np.isfinite(probs).all()

    def test_device_query(self, capsys):
        from mms_answer_selection_tpu.cli import main
        main(["device_query"])
        lines = capsys.readouterr().out.strip().split("\n")
        assert len(lines) == 8  # virtual cpu mesh


class TestSummarize:
    def test_variant_table(self, capsys):
        from mms_answer_selection_tpu.cli import main
        main(["summarize", "--variant", "v4"])
        out = capsys.readouterr().out
        assert "sim_cross(bilinear,M=4)" in out
        assert "TOTAL" in out

    def test_history_csv(self, tmp_path, capsys):
        import json as _json
        from mms_answer_selection_tpu.cli import main
        hist = tmp_path / "history.json"
        hist.write_text(_json.dumps({
            "train_loss": [0.7, 0.6], "steps": [0],
            "dev_map": [0.5], "dev_mrr": [0.6], "dev_auc": [0.7]}))
        main(["summarize", "--variant", "v3", "--history", str(hist)])
        assert (tmp_path / "history.train.csv").exists()
        assert (tmp_path / "history.eval.csv").exists()


class TestExtract:
    def test_extract_features(self, tmp_path, capsys):
        # reuse a tiny train run to produce a checkpoint, then extract
        import json as _json
        from mms_answer_selection_tpu.cli import main
        from mms_answer_selection_tpu.data.trec_qa import synthetic_corpus
        from mms_answer_selection_tpu.utils.config import experiment_to_json
        from mms_answer_selection_tpu.training import (SolverConfig,
                                                       TrainerConfig)
        from mms_answer_selection_tpu.models.mms_qa import (ConvBlock,
                                                            MMSQAConfig)

        xml, w2v = synthetic_corpus(n_questions=6, answers_per_q=4, seed=8)
        (tmp_path / "d.xml").write_text(xml)
        with open(tmp_path / "g.txt", "w") as f:
            for w, v in w2v.items():
                f.write(w + " " + " ".join(f"{x:.4f}" for x in v) + "\n")
        main(["prep", "--train-xml", str(tmp_path / "d.xml"), "--dev-xml",
              str(tmp_path / "d.xml"), "--test-xml", str(tmp_path / "d.xml"),
              "--glove", str(tmp_path / "g.txt"), "--out",
              str(tmp_path / "prep"), "--q-len", "12", "--a-len", "12"])
        meta = _json.loads((tmp_path / "prep/meta.json").read_text())
        model = MMSQAConfig(
            vocab_size=meta["vocab_size"], embed_dim=50, question_len=12,
            answer_len=12, sim_measures=2,
            blocks=(ConvBlock(3, 3, 4, "ave", 2, 2),
                    ConvBlock(3, 3, 4, "ave", 3, 1)), fc1_dim=4)
        trainer = TrainerConfig(solver=SolverConfig(), max_iter=12,
                                batch_size=8, test_interval=6,
                                snapshot_interval=0, early_stop_patience=99)
        (tmp_path / "cfg.json").write_text(experiment_to_json(model, trainer))
        main(["train", "--data", str(tmp_path / "prep"), "--exp",
              str(tmp_path / "exp"), "--config", str(tmp_path / "cfg.json")])
        capsys.readouterr()
        main(["extract", "--data", str(tmp_path / "prep"), "--exp",
              str(tmp_path / "exp"), "--config", str(tmp_path / "cfg.json")])
        out = capsys.readouterr().out
        assert "features_test.npz" in out
        path = out.strip().split()[-1]
        with np.load(path) as z:
            assert z["prob"].shape[1] == 2
            assert z["question_embeddings"].shape[2] == 50


class TestSaliencyCLI:
    def test_saliency_outputs(self, tmp_path, capsys):
        import json as _json
        from mms_answer_selection_tpu.cli import main
        from mms_answer_selection_tpu.data.trec_qa import synthetic_corpus
        from mms_answer_selection_tpu.utils.config import experiment_to_json
        from mms_answer_selection_tpu.training import (SolverConfig,
                                                       TrainerConfig)
        from mms_answer_selection_tpu.models.mms_qa import (ConvBlock,
                                                            MMSQAConfig)

        xml, w2v = synthetic_corpus(n_questions=6, answers_per_q=4, seed=9)
        (tmp_path / "d.xml").write_text(xml)
        with open(tmp_path / "g.txt", "w") as f:
            for w, v in w2v.items():
                f.write(w + " " + " ".join(f"{x:.4f}" for x in v) + "\n")
        main(["prep", "--train-xml", str(tmp_path / "d.xml"), "--dev-xml",
              str(tmp_path / "d.xml"), "--test-xml", str(tmp_path / "d.xml"),
              "--glove", str(tmp_path / "g.txt"), "--out",
              str(tmp_path / "prep"), "--q-len", "12", "--a-len", "12"])
        meta = _json.loads((tmp_path / "prep/meta.json").read_text())
        model = MMSQAConfig(
            vocab_size=meta["vocab_size"], embed_dim=50, question_len=12,
            answer_len=12, sim_measures=2,
            blocks=(ConvBlock(3, 3, 4, "ave", 2, 2),
                    ConvBlock(3, 3, 4, "ave", 3, 1)), fc1_dim=4)
        trainer = TrainerConfig(solver=SolverConfig(), max_iter=12,
                                batch_size=8, test_interval=6,
                                snapshot_interval=0, early_stop_patience=99)
        (tmp_path / "cfg.json").write_text(experiment_to_json(model, trainer))
        main(["train", "--data", str(tmp_path / "prep"), "--exp",
              str(tmp_path / "exp"), "--config", str(tmp_path / "cfg.json")])
        capsys.readouterr()
        main(["saliency", "--data", str(tmp_path / "prep"), "--exp",
              str(tmp_path / "exp"), "--config", str(tmp_path / "cfg.json"),
              "-n", "4"])
        out = capsys.readouterr().out
        assert ".npz" in out
        with np.load(tmp_path / "exp" / "saliency.npz") as z:
            assert z["question_saliency"].shape == (4, 12)


class TestTimeServe:
    def test_serve_lifecycle_timing(self, capsys):
        from mms_answer_selection_tpu.cli import main
        main(["time", "--serve-pool", "256", "--pool-dtype", "bf16",
              "--iters", "2"])
        out = json.loads(capsys.readouterr().out.strip().split("\n")[-1])
        for key in ("build_index_ms", "save_index_ms", "load_index_ms",
                    "query_1q_p50_ms", "query_32q_p50_ms", "add_256_ms",
                    "remove_100_ms", "compact_ms"):
            assert key in out and out[key] >= 0
        assert out["pool"] == 256 and out["pool_dtype"] == "bf16"
