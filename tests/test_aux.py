"""Aux subsystem tests: HDF5 compat, signal handling, history tooling."""

import json
import os
import signal

import numpy as np
import pytest

from mms_answer_selection_tpu.models.mms_qa import V4, MMSQAConfig
from mms_answer_selection_tpu.training.signals import Action, SignalHandler
from mms_answer_selection_tpu.utils.history import (
    history_to_csv,
    summarize_model,
)

rng = np.random.default_rng(17)


class TestHDF5Compat:
    @pytest.fixture()
    def split(self):
        return {
            "question": rng.integers(0, 50, (30, 12)).astype(np.int32),
            "answer": rng.integers(0, 50, (30, 12)).astype(np.int32),
            "label": rng.integers(0, 2, 30).astype(np.int32),
            "group": rng.integers(0, 5, 30).astype(np.int32),
            "overlap_feat": rng.random((30, 2)).astype(np.float32),
        }

    def test_roundtrip_chunked(self, tmp_path, split):
        h5py = pytest.importorskip("h5py")  # noqa: F841
        from mms_answer_selection_tpu.data.hdf5_compat import (
            load_hdf5_list, save_hdf5_chunks)

        list_file = save_hdf5_chunks(str(tmp_path / "h5"), "train", split,
                                     chunk_rows=12)  # forces 3 chunks
        loaded = load_hdf5_list(list_file)
        assert set(loaded) == set(split)
        for key in split:
            np.testing.assert_allclose(loaded[key], split[key], rtol=1e-6)
        assert loaded["question"].dtype == np.int32
        assert loaded["overlap_feat"].dtype == np.float32


class TestSignals:
    def test_stop_latches_and_snapshot_clears(self):
        with SignalHandler() as h:
            assert h.get_requested_action() == Action.NONE
            os.kill(os.getpid(), signal.SIGHUP)
            assert h.get_requested_action() == Action.SNAPSHOT
            assert h.get_requested_action() == Action.NONE  # cleared
            os.kill(os.getpid(), signal.SIGINT)
            assert h.get_requested_action() == Action.STOP
            assert h.get_requested_action() == Action.STOP  # latched

    def test_handlers_restored_on_exit(self):
        before = signal.getsignal(signal.SIGINT)
        with SignalHandler():
            assert signal.getsignal(signal.SIGINT) != before
        assert signal.getsignal(signal.SIGINT) == before


class TestHistoryTooling:
    def test_csv_export(self):
        hist = {"train_loss": [0.7, 0.6, 0.5], "steps": [0, 100],
                "dev_map": [0.5, 0.6], "dev_mrr": [0.55, 0.65],
                "dev_auc": [0.7, 0.8]}
        train_csv, eval_csv = history_to_csv(hist)
        lines = train_csv.strip().split("\n")
        assert lines[0] == "NumIters,TrainingLoss"
        assert lines[1].startswith("0,0.7")
        ev = eval_csv.strip().split("\n")
        assert ev[1].startswith("0,0.5,0.55,0.7")

    def test_summarize_v4_structure(self):
        cfg = MMSQAConfig(**{**V4.__dict__, "vocab_size": 1000})
        table = summarize_model(cfg)
        assert "sim_cross(bilinear,M=4)" in table
        assert "conv0(5x5)" in table
        # v4 head: flatten 1x1x64 + 2 overlap -> fc1 32
        assert "66" in table
        assert "TOTAL" in table
        # embed(1000*50+50) + sim(4*2500 + 4*1600) + convs + fcs
        total = int(table.strip().split()[-1])
        expected_embed = 1000 * 50 + 50
        assert total > expected_embed


class TestTiming:
    def test_stage_times_fwd_bwd(self):
        """Per-stage fwd+bwd table (`caffe time` parity,
        tools/caffe.cpp:301-387) on a tiny config."""
        import jax
        import jax.numpy as jnp

        from mms_answer_selection_tpu.models.mms_qa import (ConvBlock,
                                                            MMSQAConfig,
                                                            mms_qa_init)
        from mms_answer_selection_tpu.utils.timer import stage_times_fwd_bwd

        cfg = MMSQAConfig(
            vocab_size=64, embed_dim=16, question_len=12, answer_len=12,
            sim_measures=2,
            blocks=(ConvBlock(3, 3, 8, "ave", 2, 2),
                    ConvBlock(3, 3, 8, "ave", 3, 1)),
            fc1_dim=8)
        params, state = mms_qa_init(jax.random.PRNGKey(0), cfg)
        rng = np.random.default_rng(0)
        batch = {
            "question": jnp.asarray(rng.integers(0, 64, (8, 12)), jnp.int32),
            "answer": jnp.asarray(rng.integers(0, 64, (8, 12)), jnp.int32),
            "overlap_feat": jnp.asarray(
                rng.random((8, 2)).astype(np.float32)),
        }
        table = stage_times_fwd_bwd(params, state, batch, cfg, iters=2)
        assert set(table) == {"embed", "sim_cross", "conv_block0",
                              "conv_block1", "head"}
        for name, row in table.items():
            assert row["forward_ms"] > 0, name
            assert row["backward_ms"] >= 0, name

    def test_stage_times_forward_only(self):
        """Inference-mode per-stage table (`caffe time` over a deploy net —
        forward only, BN in eval mode)."""
        import jax
        import jax.numpy as jnp

        from mms_answer_selection_tpu.models.mms_qa import (ConvBlock,
                                                            MMSQAConfig,
                                                            mms_qa_init)
        from mms_answer_selection_tpu.utils.timer import stage_times

        cfg = MMSQAConfig(
            vocab_size=64, embed_dim=16, question_len=12, answer_len=12,
            sim_measures=2,
            blocks=(ConvBlock(3, 3, 8, "ave", 2, 2),
                    ConvBlock(3, 3, 8, "max", 3, 1)),
            fc1_dim=8)
        params, state = mms_qa_init(jax.random.PRNGKey(0), cfg)
        rng = np.random.default_rng(0)
        batch = {
            "question": jnp.asarray(rng.integers(0, 64, (8, 12)), jnp.int32),
            "answer": jnp.asarray(rng.integers(0, 64, (8, 12)), jnp.int32),
            "overlap_feat": jnp.asarray(
                rng.random((8, 2)).astype(np.float32)),
        }
        table = stage_times(params, state, batch, cfg, iters=2)
        assert set(table) == {"embed", "sim_cross", "conv_block0",
                              "conv_block1", "head"}
        for name, row in table.items():
            assert row["p50_s"] > 0 and row["iters"] == 2, name

    def test_cmd_time_cli(self, tmp_path, capsys, monkeypatch):
        import json as _json

        from mms_answer_selection_tpu.cli import main

        xprof = str(tmp_path / "xprof")
        main(["time", "--batch", "4", "--iters", "1", "--xprof", xprof,
              "--fused-steps", "3"])
        out = _json.loads(capsys.readouterr().out.strip().split("\n")[-1])
        assert "full_train_step_ms" in out and out["full_train_step_ms"] > 0
        assert "backward_ms" in out["p50_ms_per_stage"]["sim_cross"]
        assert out["fused_train_step_ms"] > 0 and out["fused_steps"] == 3
        assert out["xprof"] == xprof
        import os as _os
        assert _os.path.isdir(xprof)  # trace artifact written


class TestCompileCache:
    def test_enable_sets_config(self, tmp_path, monkeypatch):
        import jax
        from mms_answer_selection_tpu.utils import compile_cache
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        monkeypatch.setattr(compile_cache, "DEFAULT_DIR",
                            str(tmp_path / "xla"))
        before = jax.config.jax_compilation_cache_dir
        try:
            d = compile_cache.enable_compilation_cache()
            assert d == str(tmp_path / "xla")
            assert jax.config.jax_compilation_cache_dir == d
            # idempotent
            assert compile_cache.enable_compilation_cache() == d
        finally:
            jax.config.update("jax_compilation_cache_dir", before)

    def test_default_dir_is_inside_the_checkout(self):
        import os
        from mms_answer_selection_tpu.utils import compile_cache
        repo = os.path.dirname(os.path.dirname(os.path.abspath(
            compile_cache.__file__)))
        assert compile_cache.DEFAULT_DIR == os.path.join(
            os.path.dirname(repo), ".jax_cache")

    def test_env_var_wins_and_sets_no_dir(self, tmp_path, monkeypatch):
        import jax
        from mms_answer_selection_tpu.utils import compile_cache
        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "env"))
        assert compile_cache.enable_compilation_cache() == str(
            tmp_path / "env")
        assert jax.config.jax_compilation_cache_dir == before
        assert not (tmp_path / "env").exists()
