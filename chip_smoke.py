#!/usr/bin/env python3
"""Smoke test of the main path on one NVIDIA GPU: the V4 model (D=50,
40x40 tokens, M=4 measures, AdaDelta) is trained through the CLI, then
served, all in this one process.

Phases, in order; any failure raises and the script exits non-zero:

1. device   -- JAX must find a GPU (``jax_platforms`` is pinned to cuda,
               so JAX raises instead of falling back to the CPU); prints
               the device kind and count and nvidia-smi's name and power
               limit.
2. kernels  -- compiles every MaxSim kernel (bf16, f32, int8) at the
               recipe widths, checks that it lowered to a Triton kernel,
               prints ``memory_analysis()`` and compares the scores with
               the f32 reference.
3. train    -- writes a recipe-scale synthetic TREC-QA corpus from a seed,
               runs ``qa prep``, ``qa train --fused-steps`` and
               ``qa eval``; checks the loss is finite and the checkpoint
               reads back.
4. serve    -- from that checkpoint: int8 and bf16 QueryEngines over a
               262,144-candidate pool, top-10 checked against a chunked f32
               reference, query_rerank, query_ivf, query_coarse, the HTTP
               QAServer on localhost, and the exported scorer.

The last line of standard output is
``{"ok": true, "device": {"platform", "kind", "count"}}``.

    python chip_smoke.py              # one GPU, full sizes
    python chip_smoke.py --rehearse   # the CPU, tiny sizes, interpreted
    python chip_smoke.py --four       # only the four-GPU phase: data-parallel
                                      # training and pool-sharded serving,
                                      # each against one device
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))

# kernel score error, as a fraction of the largest |reference score|:
# bf16 operands keep 8 mantissa bits (f32 accumulation); int8 quantizes
# each candidate with one symmetric scale; f32 differs by summation order
KERNEL_TOL = {"bf16": 0.02, "f32": 1e-4, "int8": 0.06}
# data-parallel vs one-device training loss, relative: the cross-device
# gradient and batch-norm sums reduce in another order, and float32 sums
# are not associative, so the losses differ by rounding alone.  The
# comparison trains with momentum SGD: AdaDelta's first steps have the
# same size whatever the gradient's magnitude, so the biases in front of
# batch norm -- whose true gradient is zero and whose computed gradient
# is rounding noise -- take full steps of random sign, and two runs that
# differ only in reduction order drift apart by percents within tens of
# steps
FOUR_LOSS_RTOL = 1e-3
FOUR_SOLVER = {"solver_type": "sgd", "base_lr": 0.01, "momentum": 0.9}


@dataclasses.dataclass(frozen=True)
class Size:
    d: int                 # embedding width
    w: int                 # question and answer tokens
    m: int                 # metric measures
    kernel_queries: int
    kernel_pool: int
    vocab_words: int
    topics: int
    train_q: int           # questions per split (~40 answers each)
    dev_q: int
    test_q: int
    train_steps: int
    fused_steps: int
    batch: int
    test_interval: int
    pool: int
    chunk_size: int        # QueryEngine chunk: pools above it use the scan
    ivf_clusters: int
    four_steps: int
    four_batch: int        # divisible by 4 (data-parallel shards)
    full_model: bool       # V4 itself, or a narrow stand-in


FULL = Size(d=50, w=40, m=4, kernel_queries=8, kernel_pool=4096,
            vocab_words=22500, topics=250, train_q=1250, dev_q=65,
            test_q=68, train_steps=300, fused_steps=50, batch=50,
            test_interval=100, pool=262144, chunk_size=131072,
            ivf_clusters=256, four_steps=40, four_batch=64,
            full_model=True)
TINY = Size(d=16, w=12, m=2, kernel_queries=3, kernel_pool=128,
            vocab_words=600, topics=12, train_q=24, dev_q=8, test_q=8,
            train_steps=20, fused_steps=5, batch=10, test_interval=10,
            pool=1024, chunk_size=512, ivf_clusters=8, four_steps=8,
            four_batch=16, full_model=False)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi(required: bool) -> str:
    """``name, power.limit`` of the card, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        if required:
            raise
        return "not available"
    return out.splitlines()[0] if out else out


class _Tee(io.TextIOBase):
    """Write-through to stdout that also keeps what was written."""

    def __init__(self):
        self.parts = []

    def write(self, s):
        self.parts.append(s)
        sys.__stdout__.write(s)
        return len(s)

    def text(self):
        return "".join(self.parts)


def run_cli(argv) -> str:
    """``qa <argv>`` in this process; returns what it printed."""
    from mms_answer_selection_tpu.cli import main as qa
    tee = _Tee()
    with contextlib.redirect_stdout(tee):
        qa(list(argv))
    return tee.text()


# ---------------------------------------------------------------- device
def phase_device(expect_gpu: bool) -> dict:
    import jax
    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    if expect_gpu and dev.platform != "gpu":
        raise RuntimeError(f"expected a GPU, JAX found {jax.devices()}")
    say("device", f"{info['kind']} x{info['count']} ({info['platform']})")
    say("device", f"nvidia-smi: {nvidia_smi(required=expect_gpu)}")
    return info


# --------------------------------------------------------------- kernels
def phase_kernels(size: Size, compiled: bool) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from mms_answer_selection_tpu.ops import sim_cross_pallas as K

    r = np.random.default_rng(0)
    q = jnp.asarray(r.normal(size=(size.kernel_queries, size.w, size.d))
                    .astype(np.float32) * 0.5)
    cand = jnp.asarray(r.normal(size=(size.kernel_pool, size.w, size.d))
                       .astype(np.float32) * 0.5)
    w = jnp.asarray(r.normal(size=(size.m, size.d, size.d))
                    .astype(np.float32) * 0.1)
    ref = np.asarray(K.bilinear_maxsim_scores_reference(q, cand, w))
    scale = float(np.abs(ref).max())
    for mode in ("bf16", "f32", "int8"):
        if mode == "int8":
            qw, qs = K.project_queries_int8(q, w)
            pool, aux = K.pack_candidate_pool_int8(cand)
            args = (qw, qs, pool, aux)

            def fn(qw, qs, pool, aux):
                return K.bilinear_maxsim_scores_int8(qw, qs, pool, aux)
        else:
            dtype = jnp.bfloat16 if mode == "bf16" else jnp.float32
            args = (K.project_queries(q, w, dtype=dtype),
                    K.pack_candidate_pool(cand, dtype=dtype))

            def fn(qw, pool):
                return K.bilinear_maxsim_scores(qw, pool)
        lowered = jax.jit(fn).lower(*args)
        if compiled and "__gpu$xla.gpu.triton" not in lowered.as_text():
            raise RuntimeError(f"{mode} kernel did not lower to Triton")
        exe = lowered.compile()
        say("kernels", f"{mode} memory_analysis: {exe.memory_analysis()}")
        t0 = time.perf_counter()
        out = np.asarray(exe(*args))
        dt = time.perf_counter() - t0
        err = float(np.abs(out - ref).max()) / scale
        say("kernels", f"{mode} {size.kernel_queries}q x {size.kernel_pool} "
            f"max|err|/max|ref| = {err:.3e} (limit {KERNEL_TOL[mode]}), "
            f"first call {dt * 1e3:.1f} ms")
        if not err <= KERNEL_TOL[mode]:
            raise AssertionError(f"{mode} kernel error {err} exceeds "
                                 f"{KERNEL_TOL[mode]}")


# ----------------------------------------------------------------- train
def model_config(size: Size, vocab_size: int):
    from mms_answer_selection_tpu.models.mms_qa import (V4, ConvBlock,
                                                        MMSQAConfig)
    if size.full_model:
        return dataclasses.replace(V4, vocab_size=vocab_size)
    return MMSQAConfig(
        vocab_size=vocab_size, embed_dim=size.d, question_len=size.w,
        answer_len=size.w, sim_measures=size.m,
        blocks=(ConvBlock(3, 3, 4, "ave", 2, 2),
                ConvBlock(3, 3, 4, "ave", 3, 1)), fc1_dim=4)


def write_corpus(size: Size, root: str, seed: int = 22) -> str:
    """Synthetic TREC-QA splits (XML) and GloVe-format vectors, from a
    seed; runs ``qa prep`` and returns the prepped directory."""
    from mms_answer_selection_tpu.data import synthetic_split, synthetic_world

    world = synthetic_world(vocab_words=size.vocab_words,
                            n_topics=size.topics, dim=size.d, seed=seed)
    paths = {}
    for name, n_q, lo, hi, s in (("train", size.train_q, 30, 50, 101),
                                 ("dev", size.dev_q, 12, 24, 202),
                                 ("test", size.test_q, 15, 29, 303)):
        paths[name] = os.path.join(root, f"{name}.xml")
        with open(paths[name], "w") as f:
            f.write(synthetic_split(world, n_q, lo, hi, seed=s))
    glove = os.path.join(root, "vectors.txt")
    with open(glove, "w") as f:
        for word, vec in world["w2v"].items():
            f.write(word + " " + " ".join(f"{x:.6f}" for x in vec) + "\n")
    prep = os.path.join(root, "prep")
    run_cli(["prep", "--train-xml", paths["train"], "--dev-xml",
             paths["dev"], "--test-xml", paths["test"], "--glove", glove,
             "--dim", str(size.d), "--q-len", str(size.w), "--a-len",
             str(size.w), "--out", prep])
    return prep


def write_config(size: Size, prep: str, exp: str, *, steps: int,
                 batch: int, record_every: int = 20,
                 solver: dict | None = None) -> str:
    from mms_answer_selection_tpu.training import SolverConfig, TrainerConfig
    from mms_answer_selection_tpu.utils.config import experiment_to_json

    with open(os.path.join(prep, "meta.json")) as f:
        vocab_size = json.load(f)["vocab_size"]
    trainer = TrainerConfig(
        solver=SolverConfig(**(solver or {})), max_iter=steps,
        batch_size=batch, test_interval=size.test_interval,
        snapshot_interval=0, early_stop_patience=99, train_loss_record_interval=record_every,
        snapshot_dir=os.path.join(exp, "models"))
    os.makedirs(exp, exist_ok=True)
    path = os.path.join(exp, "experiment.json")
    with open(path, "w") as f:
        f.write(experiment_to_json(model_config(size, vocab_size), trainer))
    return path


def phase_train(size: Size, work: str) -> dict:
    import numpy as np
    from mms_answer_selection_tpu.models.mms_qa import mms_qa_init
    from mms_answer_selection_tpu.training.checkpoint import (
        latest_checkpoint, load_checkpoint)

    t0 = time.perf_counter()
    prep = write_corpus(size, work)
    with np.load(os.path.join(prep, "train.npz")) as z:
        n_pairs = len(z["label"])
    say("train", f"qa prep: {n_pairs} training pairs "
        f"({time.perf_counter() - t0:.1f} s)")
    exp = os.path.join(work, "exp")
    cfg_path = write_config(size, prep, exp, steps=size.train_steps,
                            batch=size.batch)
    t0 = time.perf_counter()
    out = run_cli(["train", "--data", prep, "--exp", exp, "--config",
                   cfg_path, "--fused-steps", str(size.fused_steps)])
    if "best dev MAP" not in out:
        raise RuntimeError("qa train printed no best dev MAP")
    with open(os.path.join(exp, "history.json")) as f:
        hist = json.load(f)
    losses = np.asarray(hist["train_loss"], np.float64)
    if losses.size == 0 or not np.isfinite(losses).all():
        raise AssertionError(f"training loss not finite: {losses}")
    say("train", f"qa train: {size.train_steps} steps, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, best dev MAP "
        f"{hist['best_dev_map']:.4f} ({time.perf_counter() - t0:.1f} s)")

    ckpt = latest_checkpoint(exp, prefix="best")
    if ckpt is None:
        raise RuntimeError("qa train wrote no checkpoint")
    import jax
    from mms_answer_selection_tpu.utils.config import experiment_from_json
    with open(cfg_path) as f:
        model_cfg, _ = experiment_from_json(f.read())
    params0, state0 = mms_qa_init(jax.random.PRNGKey(0), model_cfg)
    bundle, _ = load_checkpoint(ckpt, template={"params": params0,
                                                "state": state0})
    leaves = jax.tree.leaves(bundle)
    if not all(np.isfinite(np.asarray(x)).all() for x in leaves):
        raise AssertionError("checkpoint holds non-finite values")
    say("train", f"checkpoint {os.path.basename(ckpt)} read back: "
        f"{len(leaves)} arrays")

    out = run_cli(["eval", "--data", prep, "--exp", exp, "--config",
                   cfg_path, "--ckpt", ckpt])
    ev = json.loads(out.strip().splitlines()[-1])
    if not np.isfinite(ev["in_graph_map"]):
        raise AssertionError(f"qa eval MAP not finite: {ev}")
    say("train", f"qa eval: test MAP {ev['in_graph_map']:.4f}, "
        f"MRR {ev['in_graph_mrr']:.4f}")
    return {"prep": prep, "exp": exp, "config": cfg_path, "ckpt": ckpt,
            "model_cfg": model_cfg, "params": bundle["params"],
            "state": bundle["state"]}


# ----------------------------------------------------------------- serve
def candidate_pool(size: Size, prep: str, seed: int = 7):
    """(pool, W) candidate token ids: every prepped answer, then random
    rows over the vocabulary up to the pool size."""
    import numpy as np
    with open(os.path.join(prep, "meta.json")) as f:
        vocab_size = json.load(f)["vocab_size"]
    answers = []
    for name in ("train", "dev", "test"):
        with np.load(os.path.join(prep, f"{name}.npz")) as z:
            answers.append(z["answer"])
    answers = np.unique(np.concatenate(answers), axis=0)[: size.pool]
    r = np.random.default_rng(seed)
    extra = r.integers(0, vocab_size - 2,
                       (size.pool - len(answers), size.w)).astype(np.int32)
    return np.concatenate([answers.astype(np.int32), extra])


def reference_scores(params, query_ids, cand_ids, chunk: int):
    """(Nq, C) f32 scores of the learned metric, chunked over candidates."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from mms_answer_selection_tpu.ops.embed import embed_lookup
    from mms_answer_selection_tpu.ops.sim_cross_pallas import (
        bilinear_maxsim_scores_reference)

    @jax.jit
    def run(embed, w, q_ids, c_ids):
        q_tok = embed_lookup(embed, q_ids)

        def body(_, ids):
            return None, bilinear_maxsim_scores_reference(
                q_tok, embed_lookup(embed, ids), w)

        _, out = jax.lax.scan(
            body, None, c_ids.reshape(-1, chunk, c_ids.shape[1]))
        return jnp.moveaxis(out, 0, 1).reshape(q_ids.shape[0], -1)

    return np.asarray(run(params["embed"], params["sim"]["w"],
                          jnp.asarray(query_ids), jnp.asarray(cand_ids)))


def check_topk(name, vals, idx, ref, tol_frac, *, k, allow_missing=False):
    """Every returned candidate's reference score must reach the
    reference's k-th best less the tolerance (this holds under near-ties),
    and every returned score must match the reference at its index."""
    import numpy as np
    vals, idx = np.asarray(vals, np.float64), np.asarray(idx)
    nq, pool = ref.shape
    kth = -np.sort(-ref, axis=1)[:, k - 1]
    worst = 0.0
    for i in range(nq):
        ok = idx[i] >= 0
        if not allow_missing and not ok.all():
            raise AssertionError(f"{name}: query {i} returned padding")
        if not ok.any():
            raise AssertionError(f"{name}: query {i} returned nothing")
        got = idx[i][ok]
        if len(set(got.tolist())) != len(got) or got.max() >= pool:
            raise AssertionError(f"{name}: bad indices {got}")
        tol = tol_frac * float(np.abs(ref[i]).max())
        below = kth[i] - ref[i, got]
        diff = np.abs(vals[i][ok] - ref[i, got])
        worst = max(worst, float(max(below.max(), diff.max()) /
                                 max(np.abs(ref[i]).max(), 1e-30)))
        if below.max() > tol or diff.max() > tol:
            raise AssertionError(
                f"{name}: query {i} off the reference (rank gap "
                f"{below.max():.4g}, score gap {diff.max():.4g}, "
                f"tolerance {tol:.4g})")
    return worst


def http(method: str, url: str, body=None) -> dict:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        if resp.status != 200:
            raise RuntimeError(f"{method} {url} -> {resp.status}")
        return json.loads(resp.read())


def phase_serve(size: Size, trained: dict, work: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from mms_answer_selection_tpu import deploy
    from mms_answer_selection_tpu.models.mms_qa import mms_qa_apply
    from mms_answer_selection_tpu.serve import QAServer, QueryEngine

    params = jax.tree.map(jnp.asarray, trained["params"])
    state = jax.tree.map(jnp.asarray, trained["state"])
    cfg = trained["model_cfg"]
    prep = trained["prep"]
    cand = candidate_pool(size, prep)
    with np.load(os.path.join(prep, "test.npz")) as z:
        test = {k: z[k] for k in z.files}
    _, first = np.unique(test["group"], return_index=True)
    questions = test["question"][np.sort(first)]
    q32 = np.resize(questions, (32, size.w)).astype(np.int32)
    ref = reference_scores(params, q32, cand, chunk=min(1024, size.pool))
    say("serve", f"reference scores for 32 questions x {size.pool} "
        "candidates (f32, chunked)")

    engines = {}
    for mode in ("int8", "bf16"):
        t0 = time.perf_counter()
        eng = QueryEngine(params, cfg, chunk_size=size.chunk_size,
                          pool_dtype=mode if mode == "int8"
                          else jnp.bfloat16).build_index(cand)
        build = time.perf_counter() - t0
        for nq in (1, 32):
            vals, idx = eng.query(q32[:nq], k=10)
            worst = check_topk(f"{mode} query", vals, idx, ref[:nq],
                               KERNEL_TOL[mode], k=10)
            t0 = time.perf_counter()
            np.asarray(eng.query(q32[:nq], k=10)[0])
            say("serve", f"{mode} engine ({size.pool} candidates, "
                f"built in {build:.1f} s): {nq}q top-10 within "
                f"{worst:.3e} of the reference (limit {KERNEL_TOL[mode]}),"
                f" warm query {(time.perf_counter() - t0) * 1e3:.2f} ms")
        engines[mode] = eng

    eng = engines["int8"]
    probs, idx = eng.query_rerank(state, q32, k=10, shortlist=50)
    probs, idx = np.asarray(probs), np.asarray(idx)
    _, short = eng.query(q32, k=50)
    short = np.asarray(short)
    if not (np.isfinite(probs).all() and (probs >= 0).all()
            and (probs <= 1).all()):
        raise AssertionError("query_rerank probabilities out of [0, 1]")
    if not all(set(idx[i]) <= set(short[i]) for i in range(len(idx))):
        raise AssertionError("query_rerank left the int8 shortlist")
    say("serve", "query_rerank (shortlist 50): 32 queries reranked inside "
        "the shortlist")

    eng.build_ivf(n_clusters=size.ivf_clusters)
    vals, idx = eng.query_ivf(q32, k=10, nprobe=8)
    worst = check_topk("query_ivf", vals, idx, ref, KERNEL_TOL["int8"],
                       k=size.pool, allow_missing=True)
    say("serve", f"query_ivf (nprobe 8 of {eng.ivf.n_clusters}): scores "
        f"within {worst:.3e} of the reference")
    vals, idx = eng.ivf.query_coarse(q32, k=10)
    worst = check_topk("query_coarse", vals, idx, ref, KERNEL_TOL["int8"],
                       k=size.pool)
    say("serve", f"query_coarse (shortlist 1024): scores within "
        f"{worst:.3e} of the reference")
    eng.ivf = None

    with np.load(os.path.join(prep, "vocab.npz")) as z:
        words = z["words"]
    server = QAServer(eng, state=state, vocab_words=words).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        texts = [" ".join(str(words[t]) for t in row if t < len(words))
                 for row in questions[:2]]
        res = http("POST", base + "/query", {"text": texts, "k": 10})
        if [len(r["topk"]) for r in res["results"]] != [10, 10]:
            raise AssertionError(f"text query answered {res}")
        res = http("POST", base + "/query",
                   {"tokens": q32[:3].tolist(), "k": 5})
        got = [[i for i, _ in r["topk"]] for r in res["results"]]
        want = np.asarray(eng.query(q32[:3], k=5)[1]).tolist()
        if got != want:
            raise AssertionError(f"server {got} != engine {want}")
        res = http("POST", base + "/query",
                   {"text": texts[0], "k": 5, "rerank": 50})
        if len(res["results"][0]["topk"]) != 5:
            raise AssertionError(f"rerank query answered {res}")
        health = http("GET", base + "/healthz")
        if not health["ok"] or health["pool"] != size.pool:
            raise AssertionError(f"healthz: {health}")
        say("serve", f"QAServer on 127.0.0.1:{server.port}: text, token "
            f"and rerank queries and /healthz answered "
            f"({health['queries_served']} requests)")
    finally:
        server.close()

    path = os.path.join(work, "scorer.mmsx")
    header = deploy.save_scorer(path, params, state, cfg,
                                platforms=("cpu", "cuda"))
    scorer = deploy.load_scorer(path)
    n = min(64, len(test["label"]))
    got = scorer.score(test["question"][:n], test["answer"][:n],
                       test["overlap_feat"][:n])
    out, _ = jax.jit(lambda p, s, b: mms_qa_apply(p, s, b, cfg,
                                                  train=False))(
        params, state, {"question": jnp.asarray(test["question"][:n]),
                        "answer": jnp.asarray(test["answer"][:n]),
                        "overlap_feat": jnp.asarray(
                            test["overlap_feat"][:n])})
    want = np.asarray(out["prob"][:, 1])
    err = float(np.abs(got - want).max())
    if not (np.isfinite(got).all() and err <= 1e-3):
        raise AssertionError(f"exported scorer differs by {err}")
    say("serve", f"exported scorer ({header['platforms']}, "
        f"{header['bytes']} bytes) ran on {jax.devices()[0].platform}: "
        f"{n} pairs within {err:.2e} of the in-process model")


# ------------------------------------------------------------------ four
def phase_four(size: Size, work: str) -> None:
    """Data-parallel training (``qa train --mesh-dp 4``) and pool-sharded
    serving (``QueryEngine(mesh=...)``), each against one device."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from mms_answer_selection_tpu.serve import QueryEngine
    from mms_answer_selection_tpu.training.checkpoint import (
        latest_checkpoint, load_checkpoint)

    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--four needs 4 devices, found {devs}")
    prep = write_corpus(dataclasses.replace(
        size, train_q=max(size.train_q // 5, 8)), work)
    losses = {}
    for dp in (1, 4):
        exp = os.path.join(work, f"exp_dp{dp}")
        cfg_path = write_config(size, prep, exp, steps=size.four_steps,
                                batch=size.four_batch, record_every=1,
                                solver=FOUR_SOLVER)
        argv = ["train", "--data", prep, "--exp", exp, "--config",
                cfg_path]
        if dp > 1:
            argv += ["--mesh-dp", str(dp)]
        run_cli(argv)
        with open(os.path.join(exp, "history.json")) as f:
            losses[dp] = np.asarray(json.load(f)["train_loss"], np.float64)
    one, four = losses[1], losses[4]
    rel = float(np.max(np.abs(four - one) / np.abs(one)))
    if one.shape != four.shape or not rel <= FOUR_LOSS_RTOL:
        raise AssertionError(f"dp=4 loss differs from one device by {rel}")
    say("four", f"training: {size.four_steps} steps at batch "
        f"{size.four_batch}, dp=4 loss within {rel:.3e} of one device "
        f"(limit {FOUR_LOSS_RTOL}; reduction order; momentum SGD)")

    ckpt = latest_checkpoint(os.path.join(work, "exp_dp1"), prefix="best")
    bundle, _ = load_checkpoint(ckpt)
    params = jax.tree.map(jnp.asarray, bundle["params"])
    with open(os.path.join(work, "exp_dp1", "experiment.json")) as f:
        from mms_answer_selection_tpu.utils.config import (
            experiment_from_json)
        cfg, _ = experiment_from_json(f.read())
    cand = candidate_pool(size, prep)
    with np.load(os.path.join(prep, "test.npz")) as z:
        q32 = np.resize(z["question"], (32, size.w)).astype(np.int32)
    mesh = Mesh(np.asarray(devs[:4]), ("c",))
    for mode in ("int8", "bf16"):
        pd = mode if mode == "int8" else jnp.bfloat16
        single = QueryEngine(params, cfg, pool_dtype=pd,
                             chunk_size=size.chunk_size).build_index(cand)
        v1, i1 = (np.asarray(a) for a in single.query(q32, k=10))
        del single
        # flat shards, and per-shard chunk stacks scanned inside shard_map
        for chunk in (size.chunk_size, size.pool // 8):
            eng = QueryEngine(params, cfg, pool_dtype=pd, mesh=mesh,
                              chunk_size=chunk).build_index(cand)
            v4, i4 = (np.asarray(a) for a in eng.query(q32, k=10))
            del eng
            rel = float(np.max(np.abs(v4 - v1) / np.abs(v1)))
            if not (np.array_equal(i4, i1) and rel <= 1e-5):
                raise AssertionError(
                    f"{mode} sharded (chunk {chunk}) differs: indices "
                    f"equal {np.array_equal(i4, i1)}, values {rel}")
            say("four", f"serving {mode}, pool sharded over 4 devices "
                f"(chunk {chunk}): same top-10 as one device, values "
                f"within {rel:.1e}")


# ------------------------------------------------------------------ main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU at tiny sizes, kernels "
                         "interpreted")
    ap.add_argument("--four", action="store_true",
                    help="run only the four-device phase")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    try:
        import mms_answer_selection_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke.py must run from a checkout of the repository: "
              f"{e}", file=sys.stderr)
        return 2
    if args.rehearse and args.four:
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=4").strip()
    import jax
    # pinned before first use: without a GPU, JAX raises instead of
    # falling back to the CPU
    jax.config.update("jax_platforms", "cpu" if args.rehearse else "cuda")
    size = TINY if args.rehearse else FULL

    t_start = time.perf_counter()
    device = phase_device(expect_gpu=not args.rehearse)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if args.four:
            phase_four(size, work)
        else:
            t0 = time.perf_counter()
            phase_kernels(size, compiled=not args.rehearse)
            say("kernels", f"done in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            trained = phase_train(size, work)
            say("train", f"done in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            phase_serve(size, trained, work)
            say("serve", f"done in {time.perf_counter() - t0:.1f} s")
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(f"nvidia-smi: {nvidia_smi(required=not args.rehearse)}",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
