"""Shared logic for the 2-process localhost DCN test (and its in-process
baseline): a deterministic ~20-step fit_stream over the global dp mesh.

Run as a worker process:
    python multihost_helper.py <coordinator_port> <process_id> <out.json>
with JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 --
the two workers wire a 2-process jax.distributed cluster over localhost,
span a global dp=8 mesh (4 local CPU devices each), and every process feeds
the IDENTICAL deterministic batch stream: jit's in_shardings slices each
host's quarter out, XLA's all-reduce does the gradient sum over "DCN"
(the reference's cross-device story is P2PSync, parallel.cpp:271-284;
per-solver input sharding is data_reader.cpp:79-98 -- here the input rows
shard by the mesh layout instead).
"""

from __future__ import annotations

import json
import sys

import numpy as np


def run_stream(steps: int = 20, eval_interval: int = 5):
    """Deterministic tiny training run; returns the comparable history
    subset.  Requires jax to be configured (cpu, 8 global devices) first."""
    import jax
    from mms_answer_selection_tpu.models.mms_qa import ConvBlock, MMSQAConfig
    from mms_answer_selection_tpu.parallel.multihost import global_mesh
    from mms_answer_selection_tpu.training import (
        SolverConfig, Trainer, TrainerConfig)

    assert len(jax.devices()) == 8, jax.devices()
    mesh = global_mesh(tp=1)  # dp=8 spanning every process's devices

    model_cfg = MMSQAConfig(
        vocab_size=64, embed_dim=16, question_len=12, answer_len=12,
        sim_measures=2,
        blocks=(ConvBlock(3, 3, 8, "ave", 2, 2),
                ConvBlock(3, 3, 8, "ave", 3, 1)),
        fc1_dim=8,
        # xavier, not the recipe's zero metric init: near the zero-init
        # point every score is ~chance and single-ULP reassociation
        # differences between the 1-process and 2-process XLA collectives
        # flip ranks (CLAUDE.md "step-0 chance reading is ULP-sensitive");
        # with differentiated scores the rank metrics are topology-exact
        sim_weight_init="xavier")
    cfg = TrainerConfig(
        solver=SolverConfig(solver_type="adadelta", base_lr=1.0,
                            momentum=0.95, delta=5e-7, weight_decay=5e-4),
        batch_size=16, test_interval=eval_interval, snapshot_interval=0,
        seed=22)
    trainer = Trainer(model_cfg, cfg, mesh=mesh)

    rng = np.random.default_rng(5)

    def batch(n):
        return {
            "question": rng.integers(0, 64, (n, 12)).astype(np.int32),
            "answer": rng.integers(0, 64, (n, 12)).astype(np.int32),
            "overlap_feat": rng.random((n, 2)).astype(np.float32),
            "label": rng.integers(0, 2, (n,)).astype(np.int32),
        }

    batches = [batch(16) for _ in range(steps)]
    dev = batch(48)
    dev["group"] = np.repeat(np.arange(8), 6).astype(np.int32)
    # every group needs a positive and a negative to be "effective"
    dev["label"] = np.tile(
        np.asarray([1, 0, 0, 1, 0, 1], np.int32), 8)

    hist = trainer.fit_stream(iter(batches), dev, steps=steps,
                              eval_interval=eval_interval)
    return {k: hist[k] for k in ("train_loss", "dev_map", "dev_mrr",
                                 "dev_auc", "steps", "best_step",
                                 "best_dev_map")}


def run_serve(k: int = 8):
    """Deterministic QueryEngine build/query over the global ("c",) mesh:
    the candidate pool shards across EVERY process's devices, per-shard
    top-k merges over the collective fabric, and the merged result
    replicates back to every controller.  Returns the top-k tables for
    the plain sharded path and the chunked scan-inside-shard_map path.
    Requires jax configured (cpu, 8 global devices) first."""
    import jax
    from jax.sharding import Mesh
    from mms_answer_selection_tpu.models.mms_qa import (
        ConvBlock, MMSQAConfig, mms_qa_init)
    from mms_answer_selection_tpu.serve import QueryEngine

    assert len(jax.devices()) == 8, jax.devices()
    cfg = MMSQAConfig(
        vocab_size=64, embed_dim=16, question_len=12, answer_len=12,
        sim_measures=2,
        blocks=(ConvBlock(3, 3, 8, "ave", 2, 2),
                ConvBlock(3, 3, 8, "ave", 3, 1)),
        fc1_dim=8, sim_weight_init="xavier")
    params, _ = mms_qa_init(jax.random.PRNGKey(0), cfg)
    # host-side copies: every process holds identical global values, so
    # device_put with a cross-process NamedSharding is well-defined
    params = jax.device_get(params)
    mesh = Mesh(np.asarray(jax.devices()), ("c",))
    rng = np.random.default_rng(7)
    queries = rng.integers(0, 64, (4, 12)).astype(np.int32)
    out = {}
    cand = rng.integers(0, 64, (1024, 12)).astype(np.int32)
    eng = QueryEngine(params, cfg, mesh=mesh,
                      interpret=True).build_index(cand)
    vals, idx = eng.query(queries, k=k)
    out["vals"] = np.asarray(vals).tolist()
    out["idx"] = np.asarray(idx).tolist()
    big = rng.integers(0, 64, (2088, 12)).astype(np.int32)
    eng_c = QueryEngine(params, cfg, mesh=mesh, interpret=True,
                        chunk_size=128).build_index(big)
    assert eng_c.chunks is not None, "expected the chunked sharded path"
    v2, i2 = eng_c.query(queries, k=k)
    out["vals_chunked"] = np.asarray(v2).tolist()
    out["idx_chunked"] = np.asarray(i2).tolist()
    return out


def main(argv):
    port, pid, out = int(argv[1]), int(argv[2]), argv[3]
    mode = argv[4] if len(argv) > 4 else "train"
    import jax
    # both processes run on the CPU; select it BEFORE any backend init
    jax.config.update("jax_platforms", "cpu")
    from mms_answer_selection_tpu.parallel.multihost import initialize
    initialize(f"localhost:{port}", 2, pid)
    assert jax.process_count() == 2, jax.process_count()
    hist = run_stream() if mode == "train" else run_serve()
    with open(out, "w") as f:
        json.dump({"process_index": jax.process_index(), **hist}, f)
    print("WORKER OK", pid, flush=True)


if __name__ == "__main__":
    main(sys.argv)
