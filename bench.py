"""Headline benchmark: learned-metric candidate pairs scored per second on
one GPU.

Scores NQ queries against a C-candidate pool under the v4 recipe's learned
bilinear metric (M=4 measures, D=50, 40 query tokens x 40 candidate tokens)
using the fused Pallas MaxSim kernels (ops/sim_cross_pallas.py): the
(NQ*M*W1) x (C*W2) similarity tensor never reaches device memory.

Runs only on a GPU (it exits non-zero anywhere else) and prints ONE JSON
line: {"metric", "value", "unit", "device": {...}, ...}, where "device"
names the platform, device kind, count, and the card's name and power
limit as nvidia-smi reports them.

``--compare-xla`` instead times QueryEngine.query end to end with the
kernels and with the plain XLA scorer (sim_cross_pallas.maxsim_scores_plain)
in alternating turns, at 256 and 1 queries over the pool.

Usage: python bench.py [--pool C] [--queries NQ] [--iters N] [--secondary]
       python bench.py --compare-xla [--pool C]
"""

import argparse
import contextlib
import json
import subprocess
import sys
import time

import numpy as np


def device_info() -> dict:
    """The device JAX runs on, plus the card's name and power limit."""
    import jax
    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "nvidia_smi": smi}


def run_maxsim_bench(pool_size: int, n_queries: int, iters: int,
                     warmup: int = 2, mode: str = "int8"):
    import jax
    import jax.numpy as jnp
    from mms_answer_selection_tpu.ops.sim_cross_pallas import (
        BLOCK_C, bilinear_maxsim_scores, bilinear_maxsim_scores_int8,
        pack_candidate_pool, pack_candidate_pool_int8, project_queries,
        project_queries_int8)

    d, w1, w2, m = 50, 40, 40, 4
    if pool_size % BLOCK_C:  # the kernel scores BLOCK_C-candidate tiles
        pool_size = -(-pool_size // BLOCK_C) * BLOCK_C
        print(f"pool rounded up to {pool_size} (tile {BLOCK_C})",
              file=sys.stderr)
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.normal(size=(n_queries, w1, d)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(m, d, d)).astype(np.float32) * 0.05)
    cand = jnp.asarray(rng.normal(size=(pool_size, w2, d)).astype(np.float32))

    # the jitted fn reduces the scores to ONE scalar on-device; pulling that
    # scalar to the host each iteration is the completion fence
    if mode == "int8":
        # the quantized serving path (QueryEngine pool_dtype="int8"):
        # ~0.4% score error, exact padding, rerank for exactness
        qw, qs = project_queries_int8(q, w)
        pool, aux = pack_candidate_pool_int8(cand)
        del cand
        fn = jax.jit(lambda a, b, c_, d_: jnp.sum(
            bilinear_maxsim_scores_int8(a, b, c_, d_)))
        args = (qw, qs, pool, aux)
    else:
        qw = project_queries(q, w)                   # bf16 (NQ, M*W1, 64)
        pool = pack_candidate_pool(cand)             # bf16 (C, 40, 64)
        del cand
        fn = jax.jit(
            lambda qw_, p_: jnp.sum(bilinear_maxsim_scores(qw_, p_)))
        args = (qw, pool)

    float(fn(*args))                                 # compile + warm
    for _ in range(warmup):
        float(fn(*args))

    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        float(fn(*args))
        times.append(time.perf_counter() - t0)
    t = float(np.median(times))
    pairs = n_queries * pool_size
    return pairs / t, {"seconds_per_launch": t, "pairs_per_launch": pairs,
                       "times": times, "mode": mode}


def run_latency_bench(pool_size: int, n_queries: int, iters: int = 20,
                      mode: str = "int8", k: int = 10):
    """p50 end-to-end query latency (BASELINE.json's latency north star):
    per dispatch, project the query tokens through the learned metric,
    score the full pool with the fused kernel, take top-k on-chip, and
    fetch the (Nq, k) winners to the host (the fetch IS the fence)."""
    import jax
    import jax.numpy as jnp
    from mms_answer_selection_tpu.ops.sim_cross_pallas import (
        bilinear_maxsim_scores, bilinear_maxsim_scores_int8,
        pack_candidate_pool, pack_candidate_pool_int8, project_queries,
        project_queries_int8)

    d, w1, w2, m = 50, 40, 40, 4
    rng = np.random.default_rng(1)
    q = jnp.asarray(rng.normal(size=(n_queries, w1, d)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(m, d, d)).astype(np.float32) * 0.05)
    cand = jnp.asarray(rng.normal(size=(pool_size, w2, d)).astype(np.float32))

    if mode == "int8":
        pool, aux = pack_candidate_pool_int8(cand)

        def fn(q_, w_, pool_, aux_):
            qw, qs = project_queries_int8(q_, w_)
            s = bilinear_maxsim_scores_int8(qw, qs, pool_, aux_)
            return jax.lax.top_k(s, k)
        fn = jax.jit(fn)
        args = (q, w, pool, aux)
    else:
        pool = pack_candidate_pool(cand)

        def fn(q_, w_, pool_):
            qw = project_queries(q_, w_)
            s = bilinear_maxsim_scores(qw, pool_)
            return jax.lax.top_k(s, k)
        fn = jax.jit(fn)
        args = (q, w, pool)
    del cand

    np.asarray(fn(*args)[0])  # compile + warm
    np.asarray(fn(*args)[0])
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        np.asarray(fn(*args)[0])  # small (Nq, k) host fetch = fence
        times.append(time.perf_counter() - t0)
    return float(np.median(times) * 1e3)


def _make_engine(pool_dtype, cand_ids, embed_table, w, cfg, *,
                 scan_chunks=True):
    """QueryEngine over a synthetic vocabulary -- the serve path exactly as
    deployed (chunked scan for 1M pools, per-chunk on-device embedding)."""
    from mms_answer_selection_tpu.serve import QueryEngine
    params = {"embed": {"w": embed_table}, "sim": {"w": w}}
    eng = QueryEngine(params, cfg, pool_dtype=pool_dtype,
                      scan_chunks=scan_chunks)
    eng.build_index(cand_ids)
    return eng


def run_pool_suite(pool_size: int, *, n_fid_queries: int = 16, k: int = 10,
                   shortlist: int = 50, nq_throughput: int = 128,
                   iters: int = 5, measure_throughput: bool = True):
    """Per-pool-size serve-path suite: top-k fidelity of the quantized
    modes vs bf16-exact -- both EXACT top-k agreement and recall of the
    bf16 top-k inside a ``shortlist``-sized quantized candidate list (the
    retrieve-then-rerank serving pattern the quantized modes exist for) --
    plus int8 engine throughput + 1-query p50 at this pool size.

    Engines are built SEQUENTIALLY and freed between modes so the bf16 1M
    pool (10.2 GB packed) never coexists with the quantized ones."""
    import gc

    import jax
    import jax.numpy as jnp
    from mms_answer_selection_tpu.models.mms_qa import MMSQAConfig

    d, w1, w2, m, vocab = 50, 40, 40, 4, 50000
    cfg = MMSQAConfig(vocab_size=vocab, embed_dim=d, question_len=w1,
                      answer_len=w2, sim_measures=m)
    rng = np.random.default_rng(7)
    embed_table = jnp.asarray(
        rng.normal(size=(vocab, d)).astype(np.float32) * 0.3)
    w = jnp.asarray(rng.normal(size=(m, d, d)).astype(np.float32) * 0.05)
    cand_ids = rng.integers(0, vocab, (pool_size, w2)).astype(np.int32)
    fid_q = rng.integers(0, vocab, (n_fid_queries, w1)).astype(np.int32)
    thr_q = rng.integers(0, vocab, (nq_throughput, w1)).astype(np.int32)
    one_q = fid_q[:1]

    out = {"pool": pool_size, "k": k, "shortlist": shortlist}
    topk = {}
    for mode in ("bf16", "int8"):
        t_build = time.perf_counter()
        # the bf16-exact reference engine at 1M is a 10.7 GB pool: use the
        # host chunk loop (chunk-sized executables) -- a single scan
        # program holding the whole pool is near the chip's memory edge,
        # and this engine only provides the fidelity ground truth
        big_exact = mode == "bf16" and pool_size > 300_000
        eng = _make_engine(jnp.bfloat16 if mode == "bf16" else mode,
                           cand_ids, embed_table, w, cfg,
                           scan_chunks=not big_exact)
        build_s = time.perf_counter() - t_build
        # one k=shortlist query per mode: its first k rows ARE the top-k
        # (lax.top_k is sorted), the full row is the rerank shortlist
        _, idx = eng.query(fid_q, k=shortlist)
        topk[mode] = np.asarray(idx)           # host fetch = fence
        if mode == "int8" and measure_throughput:
            vals, _ = eng.query(thr_q, k=k)    # warm the Nq=128 program
            np.asarray(vals)
            times = []
            for _ in range(iters):
                t0 = time.perf_counter()
                np.asarray(eng.query(thr_q, k=k)[0])
                times.append(time.perf_counter() - t0)
            t = float(np.median(times))
            out["int8_pairs_per_sec"] = nq_throughput * pool_size / t
            np.asarray(eng.query(one_q, k=k)[0])   # warm the 1q program
            times = []
            for _ in range(iters * 2):
                t0 = time.perf_counter()
                np.asarray(eng.query(one_q, k=k)[0])
                times.append(time.perf_counter() - t0)
            out["int8_p50_1q_ms"] = float(np.median(times) * 1e3)
            out["build_seconds"] = build_s
        del eng
        gc.collect()
    for mode in ("int8",):
        agree = np.mean([
            len(set(topk["bf16"][i][:k]) & set(topk[mode][i][:k])) / k
            for i in range(n_fid_queries)])
        recall = np.mean([
            len(set(topk["bf16"][i][:k]) & set(topk[mode][i])) / k
            for i in range(n_fid_queries)])
        out[f"top{k}_agreement_{mode}_vs_bf16"] = float(agree)
        out[f"top{k}_in_top{shortlist}_recall_{mode}"] = float(recall)
    return out


def run_rerank_bench(pool_size: int, *, shortlist: int = 50, k: int = 10,
                     iters: int = 10):
    """End-to-end TWO-PHASE serving p50: int8 shortlist ->
    exact interaction-model rescoring (QueryEngine.query_rerank — the
    serving recipe the fidelity tables assume).  Params are a full
    random-init V4-geometry model with the synthetic embed/metric
    swapped in; BN runs its init stats (timing is shape-, not
    value-dependent)."""
    import jax
    import jax.numpy as jnp
    from mms_answer_selection_tpu.models.mms_qa import (MMSQAConfig,
                                                        mms_qa_init)
    from mms_answer_selection_tpu.serve import QueryEngine

    d, w1, w2, m, vocab = 50, 40, 40, 4, 50000
    cfg = MMSQAConfig(vocab_size=vocab, embed_dim=d, question_len=w1,
                      answer_len=w2, sim_measures=m)
    params, state = mms_qa_init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(7)
    params["embed"]["w"] = jnp.asarray(
        rng.normal(size=(vocab, d)).astype(np.float32) * 0.3)
    params["sim"]["w"] = jnp.asarray(
        rng.normal(size=(m, d, d)).astype(np.float32) * 0.05)
    eng = QueryEngine(params, cfg, pool_dtype="int8")
    eng.build_index(rng.integers(0, vocab, (pool_size, w2))
                    .astype(np.int32))
    out = {"pool": eng.pool_size, "shortlist": shortlist, "k": k}
    for nq in (1, 32):
        q = rng.integers(0, vocab, (nq, w1)).astype(np.int32)
        # warm both phases' executables; the host fetch is the fence
        np.asarray(eng.query_rerank(state, q, k=k,
                                    shortlist=shortlist)[0])
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            np.asarray(eng.query_rerank(state, q, k=k,
                                        shortlist=shortlist)[0])
            times.append(time.perf_counter() - t0)
        out[f"rerank_p50_ms_{nq}q"] = float(np.median(times) * 1e3)
    return out


def run_ivf_bench(pool_size: int, *, k: int = 10, n_fid_queries: int = 16,
                  iters: int = 10):
    """Approximate-retrieval headline (VERDICT round-4 item 4): recall@10
    and single-query p50 for (a) IVF cluster routing over an nprobe sweep
    and (b) the flat coarse stage with T=8 token centroids, both against
    the SAME int8 engine's brute-force top-10 (isolating approximation
    loss from quantization loss, which the fidelity suite measures).  The
    reference has no counterpart — its serve path is brute force only
    (tools/caffe.cpp:229-296) — so these are the rebuild's own numbers.

    The pool is a TRAINED-MODEL PROXY.  IVF's contract presumes the
    metric induces cluster structure; the other suites' pure-noise
    (embeddings, W) pair deliberately has NONE — under a random bilinear
    form, candidates sharing a query's topic score no higher than
    strangers, the exact top-k is driven by per-candidate maxima of
    i.i.d. noise, and recall ≈ probed fraction for ANY router (measured:
    0.09 at 5% probed).  A trained model is the opposite regime: its
    embeddings carry semantic cluster structure (GloVe neighborhoods)
    and its learned W aligns the query/answer spaces (W starts at ZERO —
    the caffe constant filler — and training grows exactly the aligned
    component).  So this suite generates that regime explicitly: 512
    latent topics, each vocabulary slice's embeddings = topic center +
    token noise, W = identity-dominant + noise, candidates draw tokens
    from one topic each.

    Queries MIX TWO topics (half the tokens from each).  Single-topic
    queries route trivially once clusters align with topics — the first
    full run measured recall@10 = 1.0 at EVERY sweep point, a flat
    curve that says nothing about the recall/latency trade.  A
    two-topic query's exact top-10 splits across two cluster
    neighborhoods, so small nprobe genuinely misses — the sweep (which
    starts at nprobe=1) then shows the knee a deployment would tune
    against.  (Real questions mention several things; candidates —
    answers — are the single-subject side.)"""
    import gc

    import jax.numpy as jnp
    from mms_answer_selection_tpu.models.mms_qa import MMSQAConfig
    from mms_answer_selection_tpu.serve.ivf import ivf_recall

    d, w1, w2, m, vocab = 50, 40, 40, 4, 50000
    n_topics = 512
    cfg = MMSQAConfig(vocab_size=vocab, embed_dim=d, question_len=w1,
                      answer_len=w2, sim_measures=m)
    rng = np.random.default_rng(11)
    slice_w = vocab // n_topics
    # trained-embedding proxy: e_v = 0.3*(0.6*center[topic(v)] + 0.8*g_v)
    # (mix normalized so per-token scale matches the other suites' 0.3)
    v_topic = np.minimum(np.arange(vocab) // slice_w, n_topics - 1)
    centers = rng.normal(size=(n_topics, d)).astype(np.float32)
    embed_table = jnp.asarray(0.3 * (
        0.6 * centers[v_topic]
        + 0.8 * rng.normal(size=(vocab, d)).astype(np.float32)))
    # trained-metric proxy: identity-dominant per measure + noise
    w = jnp.asarray(0.2 * np.eye(d, dtype=np.float32)[None]
                    + rng.normal(size=(m, d, d)).astype(np.float32) * 0.05)
    c_topic = rng.integers(0, n_topics, pool_size)
    cand_ids = (c_topic[:, None] * slice_w
                + rng.integers(0, slice_w, (pool_size, w2))).astype(np.int32)
    # two topics per query, interleaved half/half (see docstring)
    q_topic = rng.integers(0, n_topics, (n_fid_queries, 2))
    q_mix = q_topic[:, np.arange(w1) % 2]              # (Nq, W1) topic ids
    fid_q = (q_mix * slice_w
             + rng.integers(0, slice_w, (n_fid_queries, w1))).astype(np.int32)
    one_q = fid_q[:1]
    eng = _make_engine("int8", cand_ids, embed_table, w, cfg)

    def p50(fn):
        np.asarray(fn()[0])           # compile + warm
        np.asarray(fn()[0])
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            np.asarray(fn()[0])       # small host fetch = fence
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts) * 1e3)

    def fence(name, fn):
        """Sub-stage fence: a late failure (e.g. a 1M coarse OOM)
        records itself in `out` instead of erasing the earlier
        sub-stages' numbers."""
        try:
            out[name] = fn()
            return True
        except Exception as e:  # noqa: BLE001
            import traceback
            print(f"ivf sub-stage {name} failed: {e}", file=sys.stderr)
            traceback.print_exc()
            out[name] = {"error": f"{type(e).__name__}: {e}"[:200]}
            return False

    out = {"pool": eng.pool_size, "k": k,
           "brute_p50_ms_1q": p50(lambda: eng.query(one_q, k=k))}
    # the exact top-k ONCE for every recall measurement below (each
    # brute pass scores the whole pool; at 1M that is the most
    # expensive single dispatch in this suite)
    brute_idx = np.asarray(eng.query(fid_q, k=k)[1])
    # ~2 clusters per latent topic: cluster granularity should track the
    # data's blob granularity, not the pool size (finer splits scatter a
    # topic's top-10 across sub-clusters; coarser merges topics and
    # bloats buckets)
    n_clusters = 1024

    def ivf_sweep():
        ivf = eng.build_ivf(n_clusters, coarse_tokens=1)
        out["n_clusters"] = ivf.n_clusters
        out["bucket"] = ivf.bucket
        sweep = {}
        # recall across the full sweep (one 16-query dispatch each);
        # p50 only at the serving-relevant points — every (nprobe, Nq)
        # pair is its own compiled program, so the 1-query timing
        # programs are rationed
        for nprobe in (1, 2, 4, 8, 16, 32):
            pt = {
                "recall10": ivf_recall(eng, fid_q, k=k, nprobe=nprobe,
                                       brute_idx=brute_idx),
                "probed_frac": min(1.0,
                                   nprobe * ivf.bucket / eng.pool_size),
            }
            if nprobe >= 8:
                pt["p50_ms_1q"] = p50(lambda: eng.query_ivf(
                    one_q, k=k, nprobe=nprobe))
            sweep[f"nprobe_{nprobe}"] = pt
        return sweep

    def coarse_t8():
        # flat coarse with T=8 token centroids per candidate
        # (multi-vector coarse stage: preserves the MaxSim structure,
        # ~W2/T of the work).  Drop the T=1 index FIRST: its
        # probed-gather executables and bucket tables must not coexist
        # with the T=8 mini pool on a 1M-row chip
        eng.ivf = None
        gc.collect()
        eng.build_ivf(n_clusters, coarse_tokens=8)
        res = {}
        # shortlist sweep: the fixed 1024 shortlist is 0.1% of a 1M
        # pool, so 4096 shows whether recall recovers once the probed
        # fraction is held at the 262k level (~0.4%)
        for shortlist in (1024, 4096):
            res[f"s{shortlist}"] = {
                "recall10": ivf_recall(eng, fid_q, k=k, method="coarse",
                                       shortlist=shortlist,
                                       brute_idx=brute_idx),
                "p50_ms_1q": p50(lambda: eng.ivf.query_coarse(
                    one_q, k=k, shortlist=shortlist)),
                "probed_frac": min(1.0, shortlist / eng.pool_size),
            }
        # flat alias for the default shortlist
        res.update(shortlist=1024, **res["s1024"])
        return res

    fence("ivf", ivf_sweep)
    fence("coarse_t8", coarse_t8)
    del eng
    gc.collect()
    return out


def run_train_bench(batch: int, iters: int, fused_k: int = 0):
    """Secondary: full v4 training steps/sec (fwd+bwd+AdaDelta).

    fused_k > 0 additionally measures ``Trainer.scan_train_steps`` --
    K steps per dispatch, which removes the per-step host round-trip
    and shows the device's own training rate."""
    import jax
    import jax.numpy as jnp
    from mms_answer_selection_tpu.models.mms_qa import V4
    from mms_answer_selection_tpu.training import Trainer, TrainerConfig

    cfg = V4.__class__(**{**V4.__dict__, "vocab_size": 20000})
    tr = Trainer(cfg, TrainerConfig(batch_size=batch))
    params, state, opt_state = tr.init()
    rng = np.random.default_rng(0)
    b = {
        "question": jnp.asarray(rng.integers(0, 20000, (batch, 40)), jnp.int32),
        "answer": jnp.asarray(rng.integers(0, 20000, (batch, 40)), jnp.int32),
        "overlap_feat": jnp.asarray(rng.random((batch, 2)).astype(np.float32)),
        "label": jnp.asarray(rng.integers(0, 2, (batch,)), jnp.int32),
    }
    # host-read fences throughout (they also keep warmup compiles out of
    # the timed region)
    out = tr._train_step(params, state, opt_state, b, jnp.asarray(0),
                         jax.random.PRNGKey(0))
    float(out[3])
    params, state, opt_state = out[:3]
    t0 = time.perf_counter()
    for i in range(iters):
        params, state, opt_state, loss = tr._train_step(
            params, state, opt_state, b, jnp.asarray(i + 1),
            jax.random.PRNGKey(i))
        float(loss)  # per-step fence: the per-dispatch training rate
    dt = (time.perf_counter() - t0) / iters
    detail = {"sec_per_step": dt, "batch": batch}
    if fused_k:
        stacked = {k_: jnp.stack([v] * fused_k) for k_, v in b.items()}
        key = jax.random.PRNGKey(1)
        out = tr.scan_train_steps(params, state, opt_state, stacked,
                                  iters + 1, key)
        float(out[3][-1])  # fence the compile + warmup run
        params, state, opt_state = out[:3]
        reps = 3
        times = []
        for r in range(reps):
            t0 = time.perf_counter()
            params, state, opt_state, losses = tr.scan_train_steps(
                params, state, opt_state, stacked,
                iters + 1 + (r + 1) * fused_k, key)
            float(losses[-1])  # host fence per call
            times.append(time.perf_counter() - t0)
        dt_f = float(np.median(times)) / fused_k
        detail["fused_sec_per_step"] = dt_f
        detail["fused_steps_per_sec"] = 1.0 / dt_f
        detail["fused_k"] = fused_k
    return 1.0 / dt, detail


@contextlib.contextmanager
def plain_xla_scoring():
    """Swap the MaxSim kernels for the plain XLA version inside every
    QueryEngine program traced in this context (the engine looks the
    scorers up on the kernel module at trace time)."""
    from unittest import mock

    from mms_answer_selection_tpu.ops import sim_cross_pallas as kernels

    def bf16(qw, pool, interpret=None):
        return kernels.maxsim_scores_plain(qw, None, pool, None)

    def int8(qw, qs, pool, aux, interpret=None):
        return kernels.maxsim_scores_plain(qw, qs, pool, aux)

    with mock.patch.object(kernels, "bilinear_maxsim_scores", bf16), \
            mock.patch.object(kernels, "bilinear_maxsim_scores_int8", int8):
        yield


def run_engine_compare(pool_size: int, *, iters: int = 5,
                       query_counts=(256, 1)) -> dict:
    """QueryEngine.query end to end (embed, project, score, top-10) with
    the Pallas kernels and with the plain XLA scorer, for the bf16 and
    int8 pools, in alternating turns (kernel, xla, xla, kernel) so drift
    on the card hits both sides alike.  Medians in milliseconds."""
    import gc

    import jax.numpy as jnp
    from mms_answer_selection_tpu.models.mms_qa import MMSQAConfig

    d, w1, w2, m, vocab = 50, 40, 40, 4, 50000
    cfg = MMSQAConfig(vocab_size=vocab, embed_dim=d, question_len=w1,
                      answer_len=w2, sim_measures=m)
    rng = np.random.default_rng(5)
    embed_table = jnp.asarray(
        rng.normal(size=(vocab, d)).astype(np.float32) * 0.3)
    w = jnp.asarray(rng.normal(size=(m, d, d)).astype(np.float32) * 0.05)
    cand_ids = rng.integers(0, vocab, (pool_size, w2)).astype(np.int32)
    out = {"pool": pool_size}
    for mode in ("int8", "bf16"):
        eng = _make_engine(jnp.bfloat16 if mode == "bf16" else mode,
                           cand_ids, embed_table, w, cfg)
        for nq in query_counts:
            q = rng.integers(0, vocab, (nq, w1)).astype(np.int32)
            times = {"kernel": [], "xla": []}
            for side in ("kernel", "xla", "xla", "kernel"):
                eng._query_jit = None   # retrace with this side's scorer
                ctx = (plain_xla_scoring() if side == "xla"
                       else contextlib.nullcontext())
                with ctx:
                    np.asarray(eng.query(q, k=10)[0])   # compile + warm
                    for _ in range(iters):
                        t0 = time.perf_counter()
                        np.asarray(eng.query(q, k=10)[0])
                        times[side].append(time.perf_counter() - t0)
            for side, ts in times.items():
                out[f"{mode}_{nq}q_{side}_ms"] = float(np.median(ts) * 1e3)
            out[f"{mode}_{nq}q_xla_over_kernel"] = (
                out[f"{mode}_{nq}q_xla_ms"] / out[f"{mode}_{nq}q_kernel_ms"])
        eng._query_jit = None
        del eng
        gc.collect()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pool", type=int, default=262144)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--mode", default="int8", choices=["int8", "bf16"])
    ap.add_argument("--secondary", action="store_true",
                    help="also run the training-step benchmark (stderr)")
    ap.add_argument("--no-latency", action="store_true",
                    help="skip the p50 query-latency measurements")
    ap.add_argument("--quick", action="store_true",
                    help="headline kernel numbers only: skip the serve-"
                         "path pool suite (1M engine + quantization "
                         "fidelity)")
    ap.add_argument("--compare-xla", action="store_true",
                    help="only time QueryEngine.query with the kernels "
                         "against the plain XLA scorer")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cuda")  # raise, never fall back
    from mms_answer_selection_tpu.utils.compile_cache import (
        enable_compilation_cache)
    enable_compilation_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {jax.devices()}")
    device = device_info()

    if args.compare_xla:
        print(json.dumps({"compare_xla": run_engine_compare(args.pool),
                          "device": device}))
        return
    pairs_per_sec, detail = run_maxsim_bench(args.pool, args.queries,
                                             args.iters, mode=args.mode)
    lat = {}
    if not args.no_latency:
        lat["p50_query_latency_ms_1q"] = run_latency_bench(
            args.pool, 1, mode=args.mode)
        lat["p50_query_latency_ms_32q"] = run_latency_bench(
            args.pool, 32, mode=args.mode)
    if args.secondary:
        sps, d2 = run_train_bench(50, 20, fused_k=100)
        print(f"secondary: {sps:.1f} train steps/s {d2}", file=sys.stderr)
    extra = {}
    if not args.quick:
        # serve-path evidence at both pool sizes: int8 top-k fidelity vs
        # bf16-exact, and the 1M engine's throughput + 1-query p50
        pool_1m = 1_000_000 // 262144 * 262144 + 262144
        s262 = run_pool_suite(262144, measure_throughput=False)
        s1m = run_pool_suite(pool_1m)
        extra["topk10_agreement_vs_bf16"] = {
            "int8_262k": s262["top10_agreement_int8_vs_bf16"],
            "int8_1m": s1m["top10_agreement_int8_vs_bf16"],
        }
        extra["top10_in_top50_recall"] = {
            "int8_262k": s262["top10_in_top50_recall_int8"],
            "int8_1m": s1m["top10_in_top50_recall_int8"],
        }
        extra["pool_1m"] = {
            "pool": s1m["pool"],
            "int8_pairs_per_sec": s1m["int8_pairs_per_sec"],
            "int8_p50_1q_ms": s1m["int8_p50_1q_ms"],
            "build_seconds": s1m["build_seconds"],
        }
        extra["rerank_262k"] = run_rerank_bench(262144)
        extra["ivf_262k"] = run_ivf_bench(262144)
        extra["ivf_1m"] = run_ivf_bench(pool_1m)
    print(json.dumps({
        "metric": "learned_metric_pairs_scored_per_sec",
        "value": pairs_per_sec,
        "unit": "pairs/s",
        "mode": args.mode,
        "pool": args.pool,
        "seconds_per_launch": detail["seconds_per_launch"],
        **lat,
        **extra,
        "device": device,
    }))


if __name__ == "__main__":
    main()
