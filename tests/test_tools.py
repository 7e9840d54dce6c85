"""The small reference tools: compute_image_mean + draw_net equivalents.

References: tools/compute_image_mean.cpp (legacy-dim BlobProto mean
file), python/caffe/draw.py + python/draw_net.py (DOT structure graph),
src/caffe/data_transformer.cpp:25-48 (mean_file consumption).
"""

import numpy as np
import pytest

from mms_answer_selection_tpu.data.pair_image import (
    compute_image_mean, load_mean_hwc, synthetic_image_corpus,
    synthetic_pair_corpus)
from mms_answer_selection_tpu.utils.caffemodel import (
    load_blob_binaryproto, save_blob_binaryproto)
from mms_answer_selection_tpu.utils.draw import net_to_dot


class TestBlobBinaryproto:
    def test_legacy_dims_roundtrip(self, tmp_path):
        arr = np.random.default_rng(0).normal(size=(3, 5, 4)).astype(
            np.float32)
        path = str(tmp_path / "mean.binaryproto")
        save_blob_binaryproto(path, arr[None])  # (1, C, H, W)
        back = load_blob_binaryproto(path)
        assert back.shape == (1, 3, 5, 4)
        np.testing.assert_array_equal(back[0], arr)

    def test_modern_shape_roundtrip(self, tmp_path):
        arr = np.arange(12, dtype=np.float32).reshape(2, 6)
        path = str(tmp_path / "b.binaryproto")
        save_blob_binaryproto(path, arr, legacy_dims=False)
        back = load_blob_binaryproto(path)
        assert back.shape == (2, 6)
        np.testing.assert_array_equal(back, arr)

    def test_rank_cap(self, tmp_path):
        with pytest.raises(ValueError, match="4-D max"):
            save_blob_binaryproto(str(tmp_path / "x"),
                                  np.zeros((1, 1, 1, 1, 1), np.float32))


class TestImageMean:
    def test_pair_list_mean(self, tmp_path):
        list_file = synthetic_pair_corpus(str(tmp_path), n_pairs=6, hw=8)
        mean = compute_image_mean(list_file, root=str(tmp_path))
        assert mean.shape == (8, 8, 1)
        from mms_answer_selection_tpu.data.pair_image import (
            load_image, parse_pair_list)

        rows = parse_pair_list(list_file)
        manual = np.mean(
            [load_image(str(tmp_path / p))
             for r in rows for p in (r[0], r[1])], axis=0)
        np.testing.assert_allclose(mean, manual, rtol=1e-6)

    def test_image_list_mean_matches_manual(self, tmp_path):
        list_file = synthetic_image_corpus(str(tmp_path), n_images=5, hw=6)
        from mms_answer_selection_tpu.data.pair_image import load_image

        with open(list_file) as f:
            paths = [ln.rsplit(None, 1)[0] for ln in f if ln.strip()]
        manual = np.mean(
            [load_image(str(tmp_path / p)) for p in paths], axis=0)
        mean = compute_image_mean(list_file, root=str(tmp_path))
        np.testing.assert_allclose(mean, manual, rtol=1e-6)

    def test_mean_file_hwc_loader(self, tmp_path):
        mean_hwc = np.random.default_rng(1).uniform(
            0, 255, (6, 7, 3)).astype(np.float32)
        path = str(tmp_path / "mean.binaryproto")
        save_blob_binaryproto(path, mean_hwc.transpose(2, 0, 1)[None])
        back = load_mean_hwc(path)
        np.testing.assert_allclose(back, mean_hwc, rtol=1e-6)

    def test_cli_writes_mean_file(self, tmp_path, capsys):
        from mms_answer_selection_tpu.cli import main

        list_file = synthetic_image_corpus(str(tmp_path), n_images=4, hw=5)
        out = str(tmp_path / "mean.binaryproto")
        main(["image_mean", list_file, "--root", str(tmp_path),
              "--out", out])
        text = capsys.readouterr().out
        assert "mean_value channel [0]:" in text
        blob = load_blob_binaryproto(out)
        assert blob.shape == (1, 1, 5, 5)

    def test_graph_solver_consumes_mean_file(self, tmp_path):
        """transform_param { mean_file } subtracts the stored mean
        (data_transformer.cpp:119-139 path)."""
        from mms_answer_selection_tpu.training.graph_solver import GraphSolver

        list_file = synthetic_image_corpus(str(tmp_path), n_images=4, hw=5)
        mean_hwc = np.full((5, 5, 1), 10.0, np.float32)
        save_blob_binaryproto(str(tmp_path / "m.binaryproto"),
                              mean_hwc.transpose(2, 0, 1)[None])
        solver = f"""
        base_lr: 0.1 max_iter: 1 display: 0
        net_param {{
          layer {{ name: "data" type: "ImageData" top: "data" top: "label"
            image_data_param {{ source: "{list_file}" batch_size: 4
              root_folder: "{tmp_path}" }}
            transform_param {{ mean_file: "m.binaryproto" }} }}
          layer {{ name: "sink" type: "Silence" bottom: "data"
            bottom: "label" }}
        }}
        """
        gs = GraphSolver(solver, base_dir=str(tmp_path))
        batch = gs._pull_train_batch()
        raw = GraphSolver(solver.replace(
            'transform_param { mean_file: "m.binaryproto" }', ""),
            base_dir=str(tmp_path))._pull_train_batch()
        np.testing.assert_allclose(np.asarray(batch["data"]),
                                   np.asarray(raw["data"]) - 10.0,
                                   rtol=1e-6)

    def test_mean_file_and_value_exclusive(self, tmp_path):
        from mms_answer_selection_tpu.training.graph_solver import GraphSolver

        list_file = synthetic_image_corpus(str(tmp_path), n_images=2, hw=5)
        solver = f"""
        base_lr: 0.1 max_iter: 1
        net_param {{
          layer {{ name: "data" type: "ImageData" top: "data" top: "label"
            image_data_param {{ source: "{list_file}" batch_size: 2 }}
            transform_param {{ mean_file: "m" mean_value: 3 }} }}
        }}
        """
        with pytest.raises(ValueError, match="both mean_file and"):
            GraphSolver(solver, base_dir=str(tmp_path))


class TestDraw:
    NET = """
    name: "toy"
    layer { name: "data" type: "Input" top: "x" }
    layer { name: "conv" type: "Convolution" bottom: "x" top: "c"
      convolution_param { num_output: 4 kernel_size: 3 stride: 1 pad: 1 } }
    layer { name: "relu" type: "ReLU" bottom: "c" top: "c" }
    layer { name: "pool" type: "Pooling" bottom: "c" top: "p"
      pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
    layer { name: "loss" type: "SoftmaxWithLoss" bottom: "p" top: "loss"
      include { phase: TRAIN } }
    """

    def test_dot_structure(self):
        dot = net_to_dot(self.NET)
        assert dot.startswith('digraph "toy"')
        for frag in ("layer_conv", "blob_x", "blob_c", "kernel 3",
                     "MAX kernel 2", "in-place"):
            assert frag in dot, frag
        # edges: data -> x -> conv -> c -> pool -> p
        assert '"blob_x" -> "layer_conv";' in dot
        assert '"layer_pool" -> "blob_p";' in dot

    def test_phase_filter(self):
        train = net_to_dot(self.NET, phase="train")
        test = net_to_dot(self.NET, phase="test")
        assert "layer_loss" in train and "layer_loss" not in test

    def test_legacy_net_upgrades(self):
        legacy = """
        layers { name: "ip" type: INNER_PRODUCT bottom: "x" top: "y"
          inner_product_param { num_output: 3 } }
        """
        dot = net_to_dot(legacy)
        assert "InnerProduct" in dot and "out 3" in dot

    def test_cli_draw(self, tmp_path, capsys):
        from mms_answer_selection_tpu.cli import main

        net = tmp_path / "net.prototxt"
        net.write_text(self.NET)
        out = tmp_path / "net.dot"
        main(["draw", "--net", str(net), "--out", str(out)])
        assert "wrote" in capsys.readouterr().out
        assert out.read_text().startswith('digraph "toy"')


class TestParseLog:
    """tools/extra/parse_log.py equivalence (utils/parse_log.py)."""

    GLOG = """\
I0817 14:00:00.000000  71 solver.cpp:228] Iteration 0, loss = 2.30
I0817 14:00:00.100000  71 solver.cpp:244]     Train net output #0: loss = 2.30 (* 1 = 2.30 loss)
I0817 14:00:00.200000  71 sgd_solver.cpp:105] Iteration 0, lr = 0.01
I0817 14:00:05.000000  71 solver.cpp:330] Iteration 100, Testing net (#0)
I0817 14:00:05.100000  71 solver.cpp:397]     Test net output #0: accuracy = 0.5
I0817 14:00:05.200000  71 solver.cpp:397]     Test net output #1: loss = 1.9
I0817 14:00:06.000000  71 solver.cpp:228] Iteration 100, loss = 1.80
I0817 14:00:06.100000  71 solver.cpp:244]     Train net output #0: loss = 1.80 (* 1 = 1.80 loss)
I0817 14:00:06.200000  71 sgd_solver.cpp:105] Iteration 100, lr = 0.009
"""

    def test_glog_rows(self):
        from mms_answer_selection_tpu.utils.parse_log import parse_log

        train, test = parse_log(self.GLOG, year=2026)
        assert [r["NumIters"] for r in train] == [0, 100]
        # caffe logs lr AFTER the display block (ApplyUpdate), so a
        # row carries the lr in force when its output #0 printed —
        # lagging one block, with the first row backfilled from the
        # first real lr (the reference parser's exact semantics)
        assert train[0]["LearningRate"] == 0.01
        assert train[1]["LearningRate"] == 0.01
        assert train[1]["loss"] == 1.80
        assert abs(train[1]["Seconds"] - 6.1) < 1e-6
        assert test[0]["NumIters"] == 100
        assert test[0]["accuracy"] == 0.5 and test[0]["loss"] == 1.9

    def test_csv_and_cli(self, tmp_path, capsys):
        from mms_answer_selection_tpu.cli import main
        from mms_answer_selection_tpu.utils.parse_log import rows_to_csv

        log = tmp_path / "train.log"
        log.write_text(self.GLOG)
        main(["parse_log", str(log)])
        out = capsys.readouterr().out
        assert "train.log.train" in out
        text = (tmp_path / "train.log.train").read_text()
        lines = text.strip().splitlines()
        assert lines[0].startswith("NumIters,Seconds,LearningRate")
        assert len(lines) == 3
        assert rows_to_csv([]) == ""

    def test_parses_graph_solver_log(self, tmp_path, caplog):
        """A real `qa solve` run's log lines parse the same way
        (GraphSolver emits caffe's line shapes)."""
        import logging

        from mms_answer_selection_tpu.training.graph_solver import GraphSolver
        from mms_answer_selection_tpu.utils.parse_log import parse_log

        solver = """
        base_lr: 0.05 max_iter: 4 display: 2 random_seed: 3
        test_interval: 2 test_iter: 1 test_initialization: false
        lr_policy: "fixed"
        net_param {
          layer { name: "data" type: "DummyData" top: "x" top: "label"
            dummy_data_param {
              shape { dim: 4 dim: 3 } shape { dim: 4 }
              data_filler { type: "gaussian" std: 1.0 } } }
          layer { name: "ip" type: "InnerProduct" bottom: "x" top: "ip"
            inner_product_param { num_output: 2
              weight_filler { type: "xavier" } } }
          layer { name: "lab" type: "Power" bottom: "label" top: "labi" }
          layer { name: "loss" type: "EuclideanLoss" bottom: "ip"
            bottom: "ip" top: "loss" }
        }
        """
        with caplog.at_level(logging.INFO, logger="mms.graph_solver"):
            gs = GraphSolver(solver, base_dir=str(tmp_path))
            gs.step(4)
        train, test = parse_log(caplog.text)
        assert [r["NumIters"] for r in train] == [0, 2]
        assert train[0]["LearningRate"] == 0.05
        assert len(test) == 1 and test[0]["NumIters"] == 2


class TestConvertImageset:
    """`qa convert_imageset` ≙ tools/convert_imageset.cpp (LMDB of uint8
    Datums there; chunked HDF5 + list file here — what HDF5Data layers
    consume)."""

    def _corpus(self, tmp_path, n=10):
        rng = np.random.default_rng(0)
        lines = []
        for i in range(n):
            im = rng.integers(0, 256, (6, 6, 3)).astype(np.float32)
            np.save(tmp_path / f"im{i}.npy", im)
            lines.append(f"im{i}.npy {i % 3}")
        (tmp_path / "list.txt").write_text("\n".join(lines) + "\n")
        return lines

    def test_basic(self, tmp_path, capsys):
        from mms_answer_selection_tpu.cli import main
        from mms_answer_selection_tpu.data.hdf5_compat import \
            load_hdf5_list

        self._corpus(tmp_path)
        main(["convert_imageset", str(tmp_path), str(tmp_path / "list.txt"),
              str(tmp_path / "db")])
        out = capsys.readouterr().out
        assert "Processed 10 files." in out
        arrays = load_hdf5_list(str(tmp_path / "db" / "data.txt"))
        assert arrays["data"].shape == (10, 6, 6, 3)
        np.testing.assert_array_equal(arrays["label"],
                                      np.arange(10) % 3)
        # row 0 is im0 (no shuffle): content preserved
        np.testing.assert_array_equal(
            arrays["data"][0], np.load(tmp_path / "im0.npy"))

    def test_shuffle_deterministic(self, tmp_path):
        from mms_answer_selection_tpu.cli import main
        from mms_answer_selection_tpu.data.hdf5_compat import \
            load_hdf5_list

        self._corpus(tmp_path)
        main(["convert_imageset", str(tmp_path), str(tmp_path / "list.txt"),
              str(tmp_path / "a"), "--shuffle", "--seed", "1"])
        main(["convert_imageset", str(tmp_path), str(tmp_path / "list.txt"),
              str(tmp_path / "b"), "--shuffle", "--seed", "1"])
        la = load_hdf5_list(str(tmp_path / "a" / "data.txt"))["label"]
        lb = load_hdf5_list(str(tmp_path / "b" / "data.txt"))["label"]
        np.testing.assert_array_equal(la, lb)
        assert not np.array_equal(la, np.arange(10) % 3)  # order moved

    def test_size_mismatch_exits(self, tmp_path):
        from mms_answer_selection_tpu.cli import main

        self._corpus(tmp_path)
        np.save(tmp_path / "odd.npy",
                np.zeros((4, 4, 3), np.float32))
        with open(tmp_path / "list.txt", "a") as f:
            f.write("odd.npy 0\n")
        with pytest.raises(SystemExit, match="shape"):
            main(["convert_imageset", str(tmp_path),
                  str(tmp_path / "list.txt"), str(tmp_path / "db")])

    def test_feeds_hdf5data_training(self, tmp_path):
        """The produced dataset drives an HDF5Data net end-to-end."""
        from mms_answer_selection_tpu.cli import main
        from mms_answer_selection_tpu.training.graph_solver import \
            GraphSolver

        self._corpus(tmp_path, n=12)
        main(["convert_imageset", str(tmp_path), str(tmp_path / "list.txt"),
              str(tmp_path / "db")])
        net = f"""
        layer {{ name: "d" type: "HDF5Data" top: "data" top: "label"
          hdf5_data_param {{ source: "{tmp_path / 'db' / 'data.txt'}"
            batch_size: 4 }} }}
        layer {{ name: "flat" type: "Flatten" bottom: "data" top: "flat" }}
        layer {{ name: "fc" type: "InnerProduct" bottom: "flat" top: "fc"
          inner_product_param {{ num_output: 3
            weight_filler {{ type: "xavier" }} }} }}
        layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "fc"
          bottom: "label" top: "loss" }}
        """
        (tmp_path / "net.prototxt").write_text(net)
        (tmp_path / "solver.prototxt").write_text(
            'net: "net.prototxt"\nbase_lr: 0.01\nlr_policy: "fixed"\n'
            'max_iter: 6\ntest_interval: 0\nsnapshot_prefix: "s"\n')
        gs = GraphSolver(str(tmp_path / "solver.prototxt"))
        smoothed = gs.step(6)
        assert np.isfinite(smoothed)


class TestPlot:
    """`qa plot` ≙ tools/extra/plot_training_log.py.example."""

    LOG = """\
I0817 14:00:01.000000 1 solver.cpp:100] Iteration 0, loss = 2.0
I0817 14:00:01.100000 1 solver.cpp:101]     Train net output #0: loss = 2.0 (* 1 = 2.0 loss)
I0817 14:00:01.200000 1 sgd_solver.cpp:105] Iteration 0, lr = 0.1
I0817 14:00:02.000000 1 solver.cpp:330] Iteration 10, Testing net (#0)
I0817 14:00:02.100000 1 solver.cpp:397]     Test net output #0: accuracy = 0.5
I0817 14:00:02.200000 1 solver.cpp:397]     Test net output #1: loss = 1.5 (* 1 = 1.5 loss)
I0817 14:00:03.000000 1 solver.cpp:100] Iteration 10, loss = 1.0
I0817 14:00:03.100000 1 solver.cpp:101]     Train net output #0: loss = 1.0 (* 1 = 1.0 loss)
I0817 14:00:03.200000 1 sgd_solver.cpp:105] Iteration 10, lr = 0.1
I0817 14:00:04.000000 1 solver.cpp:330] Iteration 20, Testing net (#0)
I0817 14:00:04.100000 1 solver.cpp:397]     Test net output #0: accuracy = 0.8
I0817 14:00:04.200000 1 solver.cpp:397]     Test net output #1: loss = 0.7 (* 1 = 0.7 loss)
"""

    def test_lists_chart_types(self, capsys):
        from mms_answer_selection_tpu.cli import main

        main(["plot"])
        out = capsys.readouterr().out
        assert "0: Test accuracy  vs. Iters" in out
        assert "7: Train loss  vs. Seconds" in out

    def test_plots_test_accuracy_and_train_loss(self, tmp_path, capsys):
        from mms_answer_selection_tpu.cli import main

        (tmp_path / "run.log").write_text(self.LOG)
        main(["plot", "0", str(tmp_path / "acc.png"),
              str(tmp_path / "run.log")])
        main(["plot", "6", str(tmp_path / "loss.png"),
              str(tmp_path / "run.log")])
        main(["plot", "5", str(tmp_path / "lr_s.png"),
              str(tmp_path / "run.log")])  # Seconds axis from glog ts
        assert (tmp_path / "acc.png").stat().st_size > 0
        assert (tmp_path / "loss.png").stat().st_size > 0
        assert (tmp_path / "lr_s.png").stat().st_size > 0

    def test_no_points_is_explicit(self, tmp_path):
        from mms_answer_selection_tpu.cli import main

        (tmp_path / "empty.log").write_text("nothing to see\n")
        with pytest.raises(SystemExit, match="no .*points"):
            main(["plot", "0", str(tmp_path / "x.png"),
                  str(tmp_path / "empty.log")])


class TestDrawLabels:
    """Per-type headline-hyperparameter labels (python/caffe/draw.py
    get_layer_label, generalized to the fork's layer types)."""

    NET = """
name: "labels"
layer { name: "in" type: "Input" top: "d"
  input_param { shape { dim: 2 dim: 6 } } }
layer { name: "emb" type: "Embed" bottom: "d" top: "e"
  embed_param { input_dim: 50 num_output: 8 } }
layer { name: "sim" type: "SimCross" bottom: "e" bottom: "e" top: "s"
  sim_cross_param { dist_mode: 3 mesure_count: 2 } }
layer { name: "drop" type: "Dropout" bottom: "s" top: "s"
  dropout_param { dropout_ratio: 0.25 } }
layer { name: "lrn" type: "LRN" bottom: "s" top: "l"
  lrn_param { local_size: 3 } }
layer { name: "gp" type: "Pooling" bottom: "l" top: "g"
  pooling_param { pool: AVE global_pooling: true } }
"""

    def test_headline_params_in_dot(self):
        dot = net_to_dot(self.NET)
        assert r"50 -\> 8" in dot               # Embed in->out (DOT-escaped)
        assert "mode 3 M 2" in dot              # SimCross
        assert "ratio 0.25" in dot              # Dropout
        assert "local 3" in dot                 # LRN
        assert "AVE global" in dot              # global pooling
        # blob nodes and edges present
        assert "octagon" in dot and "->" in dot
