"""BASELINE configs[3]: brute-force learned-metric retrieval over a 1M
synthetic candidate pool.

Single device: the int8-quantized pool + engine-level chunked scoring run
the whole config on one GPU.  On a mesh, pass a Mesh whose last axis
shards the pool (per-shard top-k + global merge over the interconnect).

    python examples/retrieval_1m.py [--pool 1048576] [--queries 128]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pool", type=int, default=1_048_576)
    ap.add_argument("--queries", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=30000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--mesh", action="store_true",
                    help="shard the pool over all local devices")
    ap.add_argument("--ivf-clusters", type=int, default=0,
                    help="also time the IVF approximate path with this "
                         "many clusters (switches the pool to bf16)")
    ap.add_argument("--nprobe", type=int, default=16)
    ap.add_argument("--coarse-shortlist", type=int, default=0,
                    help="also time the flat coarse-shortlist path "
                         "with this shortlist size")
    ap.add_argument("--coarse-tokens", type=int, default=8,
                    help="token centroids per candidate for the coarse "
                         "stage (1 = cheap mean-vector matmul; 8 = "
                         "mini-pool kernel, near-exact recall)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from mms_answer_selection_tpu.models.mms_qa import V4, mms_qa_init
    from mms_answer_selection_tpu.serve import QueryEngine
    from mms_answer_selection_tpu.utils.compile_cache import (
        enable_compilation_cache)
    enable_compilation_cache()

    cfg = V4.__class__(**{**V4.__dict__, "vocab_size": args.vocab})
    params, _ = mms_qa_init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    # a trained metric would come from a checkpoint; synthetic here
    params["sim"]["w"] = jnp.asarray(
        rng.normal(size=(cfg.sim_measures, cfg.embed_dim,
                         cfg.embed_dim)).astype(np.float32) * 0.05)

    mesh = None
    if args.mesh:
        from jax.sharding import Mesh
        mesh = Mesh(np.asarray(jax.devices()), ("c",))

    cand_ids = rng.integers(0, args.vocab, (args.pool, cfg.answer_len),
                            dtype=np.int32)
    pool_dtype = "int8"
    if args.ivf_clusters or args.coarse_shortlist:
        import jax.numpy as _jnp
        pool_dtype = _jnp.bfloat16  # IVF v1 gathers float pools
    engine = QueryEngine(params, cfg, mesh=mesh, pool_dtype=pool_dtype)
    t0 = time.perf_counter()
    engine.build_index(cand_ids)
    print(f"indexed {args.pool:,} candidates in "
          f"{time.perf_counter() - t0:.1f}s")

    q_ids = jnp.asarray(rng.integers(0, args.vocab,
                                     (args.queries, cfg.question_len)),
                        jnp.int32)
    vals, idx = engine.query(q_ids, k=args.k)   # compile
    _ = float(vals[0, 0])
    t0 = time.perf_counter()
    vals, idx = engine.query(q_ids, k=args.k)
    _ = float(vals[0, 0])
    dt = time.perf_counter() - t0
    pairs = args.queries * args.pool
    print(f"{args.queries} queries x {args.pool:,} candidates: "
          f"{pairs / dt / 1e6:.1f}M pairs/s ({dt * 1e3:.1f} ms)")
    print("top-k of query 0:", list(zip(np.asarray(idx[0]).tolist(),
                                        np.round(np.asarray(vals[0]), 3))))

    if args.ivf_clusters or args.coarse_shortlist:
        # approximate single-query latency path (serve/ivf.py): coarse
        # stage routes, the exact kernel scores only the probed set
        from mms_answer_selection_tpu.serve import ivf_recall
        t0 = time.perf_counter()
        ivf = engine.build_ivf(n_clusters=args.ivf_clusters or 1024,
                               coarse_tokens=args.coarse_tokens)
        print(f"ivf built in {time.perf_counter() - t0:.1f}s "
              f"(bucket={ivf.bucket}, spilled={ivf.spilled}, "
              f"T={args.coarse_tokens})")
        one_q = q_ids[:1]
        modes = []
        if args.ivf_clusters:
            modes.append(("ivf", {"nprobe": args.nprobe}))
        if args.coarse_shortlist:
            modes.append(("coarse", {"shortlist": args.coarse_shortlist}))
        for name, kw in modes:
            qfn = (engine.query_ivf if name == "ivf"
                   else ivf.query_coarse)
            v, _ = qfn(one_q, k=args.k, **kw)      # compile
            _ = float(v[0, 0])
            t0 = time.perf_counter()
            v, _ = qfn(one_q, k=args.k, **kw)
            _ = float(v[0, 0])
            ms = (time.perf_counter() - t0) * 1e3
            r = ivf_recall(engine, q_ids[:16], k=args.k, method=name,
                           **kw)
            print(f"{name} 1-query p50 ~{ms:.1f} ms, recall@{args.k} "
                  f"(16q) = {r:.3f}  [{kw}]")


if __name__ == "__main__":
    main()
