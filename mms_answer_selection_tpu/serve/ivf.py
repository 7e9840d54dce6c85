"""IVF (inverted-file) approximate retrieval over a QueryEngine pool.

The reference's retrieval story — and this rebuild's headline path — is
brute force: every query scores every candidate
(do_trec_qa_clean.py:617-652 scores whole splits; QueryEngine fuses it
into one kernel).  Brute force amortizes beautifully over large query
BATCHES, but a single latency-sensitive query still pays the whole pool.
This module adds the classic two-level index in front of the exact
kernel:

1. **Coarse representation.**  The kernel's score is
   ``sum_{m,i} max_j (q_i W_m a_j)`` (sim_cross_pallas.py).  Replacing
   ``max_j`` with ``mean_j`` makes the candidate enter only through its
   token mean ``v_a = mean_j a_j``, and the whole coarse score collapses
   to ONE dot product::

       coarse(q, a) = (sum_{m,i} q_i W_m) . v_a

   The query side is exactly ``project_queries(...).sum(axis=1)`` — the
   same projection the exact kernel needs anyway, so the coarse stage
   adds one (Nq, D) x (D, K) matmul.

2. **k-means over the coarse vectors** (Lloyd, on-device, chunked
   assignment) groups candidates into K buckets, padded to a fixed
   width B so every shape stays static under jit.

3. **Query**: score K centroids, take the top ``nprobe`` clusters,
   gather their ``nprobe * B`` candidates from the packed pool, and run
   the EXACT fused kernel on just those.  Probing ``nprobe*B << C``
   bounds per-query work by the probed set, not the pool.

Exactness contract: with ``nprobe == n_clusters`` results are
bit-identical to ``QueryEngine.query`` (every candidate is exact-kernel
scored; only the candidate ORDER through the gather differs, and the
same top-k tie rule applies to identical score sets).  Smaller nprobe
trades recall for latency; ``ivf_recall`` measures the trade.

Scope: single-device engines, flat or scan-chunk storage, float
(bf16/f32) and int8 pools.  Pools are candidate-major, so the probed
gather is one row index (plus the int8 aux rows) and probed scores equal
brute force.  Meshed pools use the sharded brute-force path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.embed import embed_lookup
from ..ops.sim_cross_pallas import (
    BLOCK_C,
    NEG_INF,
    bilinear_maxsim_scores,
    bilinear_maxsim_scores_int8,
    padded_dim,
    project_queries,
    project_queries_int8,
)


def _kmeanspp_init(vecs, k, key):
    """k-means++ seeding as ONE jitted program: a ``fori_loop`` that per
    step scores every point against the latest centroid, folds the
    running min-distance, and categorical-samples the next seed with
    probability proportional to it.  Uniform init is known-bad on tight
    blobs (several seeds land in one blob, none in others — observed as
    a 5x max/mean bucket skew on the bench's topic pool); ++ seeding is
    the standard fix and costs O(kND) trivial FLOPs in one dispatch.

    vecs enters as an ARGUMENT (the jit-closure-constant rule)."""
    n, d = vecs.shape

    @jax.jit
    def init(vecs, key):
        k0, key = jax.random.split(key)
        first = jax.random.randint(k0, (), 0, n)
        cent0 = jnp.zeros((k, d), jnp.float32).at[0].set(vecs[first])
        mind0 = jnp.sum((vecs - vecs[first]) ** 2, axis=1)

        def body(i, carry):
            cent, mind, key = carry
            kc, key = jax.random.split(key)
            # sample proportional to squared distance; chosen points
            # have mind 0 -> log -inf -> zero probability
            nxt = jax.random.categorical(kc, jnp.log(mind + 1e-30))
            c = vecs[nxt]
            cent = jax.lax.dynamic_update_slice(cent, c[None], (i, 0))
            mind = jnp.minimum(mind, jnp.sum((vecs - c) ** 2, axis=1))
            return cent, mind, key

        cent, _, _ = jax.lax.fori_loop(1, k, body, (cent0, mind0, key))
        return cent

    return init(vecs, key)


def _kmeans(vecs, k, *, iters: int = 10, seed: int = 0,
            chunk: int = 65536, init_sample: int = 131072):
    """Lloyd's k-means on device with k-means++ seeding.  vecs (N, D)
    f32 -> (centroids (K, D), assignment (N,) int32).  Distances are
    computed in N-chunks so the (N, K) matrix never materializes for
    1M-row pools; ++ seeding runs on a <=``init_sample`` subsample (the
    faiss convention — seeding needs blob coverage, not every point).
    Empty clusters keep their previous centroid (they can re-acquire
    points later)."""
    vecs = jnp.asarray(vecs, jnp.float32)
    n, d = vecs.shape
    k = min(k, n)
    key = jax.random.PRNGKey(seed)
    k_sub, k_init = jax.random.split(key)
    if n > init_sample:
        sub = vecs[jax.random.choice(k_sub, n, (init_sample,),
                                     replace=False)]
    else:
        sub = vecs
    cent = _kmeanspp_init(sub, k, k_init)

    n_pad = -(-n // chunk) * chunk
    vp = jnp.pad(vecs, ((0, n_pad - n), (0, 0)))

    @jax.jit
    def assign_chunk(xc, cent):
        # argmin_k |x - c|^2 == argmin_k (c.c - 2 x.c); x.x is constant
        d2 = jnp.sum(cent * cent, axis=1)[None, :] - 2.0 * (xc @ cent.T)
        return jnp.argmin(d2, axis=1).astype(jnp.int32)

    # vecs enters as an ARGUMENT, never a closure: a closed-over device
    # array lowers as an HLO constant, and a 1M x D constant makes a
    # multi-GB program to compile
    @jax.jit
    def update(assign, cent, vecs):
        ones = jnp.ones((n,), jnp.float32)
        sums = jax.ops.segment_sum(vecs, assign, num_segments=k)
        cnts = jax.ops.segment_sum(ones, assign, num_segments=k)
        newc = sums / jnp.maximum(cnts, 1.0)[:, None]
        return jnp.where((cnts > 0)[:, None], newc, cent)

    assign = None
    for _ in range(max(1, iters)):
        parts = [assign_chunk(vp[i: i + chunk], cent)
                 for i in range(0, n_pad, chunk)]
        assign = jnp.concatenate(parts)[:n]
        cent = update(assign, cent, vecs)
    return cent, assign


class IVFIndex:
    """Two-level index over a built, single-device, unquantized
    QueryEngine pool.  Construct via ``QueryEngine.build_ivf``."""

    def __init__(self, engine, *, n_clusters: int = 256,
                 bucket: int | None = None, kmeans_iters: int = 10,
                 seed: int = 0, coarse_tokens: int = 1):
        if engine.pool_size == 0:
            raise ValueError("engine has no index; call build_index first")
        if engine.mesh is not None:
            raise ValueError("IVF v1 is single-device; meshed pools use "
                             "the sharded brute-force path")
        if engine.chunks is not None and isinstance(engine.chunks, list):
            raise ValueError("IVF needs scan_chunks=True storage (one "
                             "stacked device buffer), not the host "
                             "chunk-loop list")
        if engine.cand_token_ids is None:
            raise ValueError("IVF needs build_index(candidate_ids); "
                             "from-tokens pools keep no ids")
        self.engine = engine
        self.n_clusters = min(n_clusters, engine.pool_size)
        self.coarse_tokens = int(coarse_tokens)
        if self.coarse_tokens < 1:
            raise ValueError("coarse_tokens must be >= 1")
        self._flat_cache = None   # (pool_flat, aux_flat) device views
        self._cent_dev = None     # centroids on device (passed as jit arg)
        self._build(bucket, kmeans_iters, seed)
        self._jit = None

    # --------------------------------------------------------------- build
    def _coarse_candidates(self) -> np.ndarray:
        """(C, D) f32 token-mean embedding per candidate, host array,
        built in chunks so 1M-row pools never materialize (C, W2, D)."""
        eng = self.engine
        ids = eng.cand_token_ids
        c = ids.shape[0]
        d = eng.cfg.embed_dim
        out = np.empty((c, d), np.float32)
        mean_fn = jax.jit(lambda i: jnp.mean(
            embed_lookup(eng.params["embed"], i).astype(jnp.float32),
            axis=1))
        step = 65536
        for a in range(0, c, step):
            out[a: a + step] = np.asarray(mean_fn(
                jnp.asarray(ids[a: a + step])))
        return out

    def _token_centroids(self, t: int, iters: int = 5) -> np.ndarray:
        """(C, T, D) f32: each candidate's W2 token embeddings compressed
        to T centroids by a BATCHED per-candidate Lloyd (vectorized over
        the whole chunk — one einsum per iteration, no per-candidate
        loops).  With T >= the candidate's distinct-token count the
        centroids ARE its token set and the coarse MaxSim is exact."""
        eng = self.engine
        ids = eng.cand_token_ids
        c, w2 = ids.shape
        d = eng.cfg.embed_dim

        @jax.jit
        def chunk_fn(i):
            tok = embed_lookup(eng.params["embed"], i).astype(jnp.float32)
            b = tok.shape[0]
            # farthest-point init: covers every distinct token when the
            # candidate has <= T of them (duplicate picks then repeat an
            # existing token, which never changes a MaxSim) — so the
            # T-fits-all exactness guarantee survives Lloyd's refinement
            cents = [tok[:, 0]]
            mind = jnp.sum((tok - tok[:, :1]) ** 2, -1)      # (B, W2)
            for _ in range(t - 1):
                nxt = jnp.argmax(mind, -1)
                cn = jnp.take_along_axis(
                    tok, jnp.broadcast_to(nxt[:, None, None], (b, 1, d)),
                    axis=1)[:, 0]
                cents.append(cn)
                mind = jnp.minimum(
                    mind, jnp.sum((tok - cn[:, None]) ** 2, -1))
            cent = jnp.stack(cents, axis=1)                  # (B, T, D)
            for _ in range(iters):
                d2 = jnp.sum((tok[:, :, None] - cent[:, None]) ** 2, -1)
                hot = jax.nn.one_hot(jnp.argmin(d2, -1), t)  # (B, W2, T)
                sums = jnp.einsum("bwt,bwd->btd", hot, tok)
                cnt = jnp.sum(hot, axis=1)                   # (B, T)
                cent = jnp.where((cnt > 0)[..., None],
                                 sums / jnp.maximum(cnt, 1.0)[..., None],
                                 cent)
            return cent

        out = np.empty((c, t, d), np.float32)
        step = 16384
        for a in range(0, c, step):
            out[a: a + step] = np.asarray(chunk_fn(
                jnp.asarray(ids[a: a + step])))
        return out

    def _build(self, bucket, kmeans_iters, seed):
        eng = self.engine
        vecs = self._coarse_candidates()
        cent, assign = _kmeans(vecs, self.n_clusters, iters=kmeans_iters,
                               seed=seed)
        self.n_clusters = int(cent.shape[0])
        assign = np.asarray(assign)
        # tombstoned rows never enter a bucket and get a -inf additive
        # coarse mask: they'd only waste probe/shortlist slots (the
        # exact stage already scores them -inf)
        deleted = np.asarray(eng.deleted, np.int64)
        live = np.ones(eng.pool_size, bool)
        if deleted.size:
            live[deleted] = False
        counts = np.bincount(assign[live], minlength=self.n_clusters)
        b = int(max(counts.max(), 1)) if bucket is None else int(bucket)
        b = max(b, 1)
        order = np.argsort(assign, kind="stable")
        if deleted.size:
            order = order[live[order]]
        bucket_map = np.full((self.n_clusters, b), -1, np.int32)
        loads = np.zeros(self.n_clusters, np.int64)
        spilled = []
        for cand in order:
            cl = assign[cand]
            if loads[cl] < b:
                bucket_map[cl, loads[cl]] = cand
                loads[cl] += 1
            else:
                spilled.append(cand)
        # capacity spill: overflow rides the least-loaded clusters.  They
        # are exact-kernel scored whenever their host cluster is probed,
        # so correctness holds; only the coarse routing (and so recall)
        # degrades for spilled candidates.
        if spilled:
            for cand in spilled:
                cl = int(np.argmin(loads))
                if loads[cl] >= b:
                    raise ValueError(
                        f"bucket={b} cannot hold {eng.pool_size} "
                        f"candidates in {self.n_clusters} clusters")
                bucket_map[cl, loads[cl]] = cand
                loads[cl] += 1
        self.spilled = len(spilled)
        self._cent_f32 = np.asarray(cent)
        self.bucket = b
        self.bucket_map = jnp.asarray(bucket_map)
        self.valid = jnp.asarray(bucket_map >= 0)
        # flat coarse table for query_coarse (bf16 halves HBM: a 1M x 50d
        # table is 100 MB); convert on the HOST so the upload is a pure
        # transfer, not a device-side convert program
        self.coarse = jnp.asarray(np.asarray(vecs, np.dtype(jnp.bfloat16)))
        self.live_neg = None
        if deleted.size:
            ln = np.zeros(eng.pool_size, np.float32)
            ln[deleted] = -np.inf
            self.live_neg = jnp.asarray(ln)
        self._coarse_jit = None
        # multi-vector coarse: a kernel-scoreable MINI POOL of T token
        # centroids per candidate preserves the score's max structure
        # (T=1 stays on the cheap dense-matmul path).  Rows pad to the
        # kernel's candidate tile, padding masked.
        self.coarse_pool = None
        if self.coarse_tokens > 1:
            # the pack is pure padding + mask-lane writes, so build it in
            # HOST numpy and upload once: a single jitted pack over a 1M
            # mini pool would be a multi-GB-buffer program
            cents = self._token_centroids(self.coarse_tokens)
            c, t, d = cents.shape
            c_pad = -(-c // BLOCK_C) * BLOCK_C
            pool_dtype = eng.pool_dtype or jnp.bfloat16
            dp = padded_dim(d, pool_dtype)
            np_dtype = np.dtype(pool_dtype)
            mini = np.zeros((c_pad, t, dp), np_dtype)
            mini[:c, :, :d] = cents.astype(np_dtype)
            mini[c:, :, dp - 1] = NEG_INF    # candidate padding
            if deleted.size:
                mini[deleted, :, dp - 1] = NEG_INF
            self.coarse_pool = jnp.asarray(mini)

    # --------------------------------------------------------------- query
    def _flat(self):
        """Cached (pool, aux) device views of the engine's RAW storage
        — 3-D (Cp, W2P, Dp) for flat pools, 4-D (n_chunks, unit, W2P,
        Dp) for scan-chunk stacks — handed to the query programs as
        ARGUMENTS each call and flattened INSIDE the trace
        (``_flatten_storage``).  A host-level ``reshape`` here would
        materialize a second full copy of the pool; the traced reshape
        is an XLA bitcast.  The
        engine invalidates this cache when it mutates the pool
        (remove_candidates), so a stale pre-mask view can never
        serve."""
        if self._flat_cache is None:
            eng = self.engine
            if eng.pool is not None:
                self._flat_cache = (eng.pool, eng.aux)
            else:
                self._flat_cache = eng.chunks
        return self._flat_cache

    def _pool_flat(self):
        return self._flat()[0]

    def _aux_flat(self):
        return self._flat()[1]

    @staticmethod
    def _flatten_storage(pool, aux):
        """Traced candidate-major flatten of the raw storage: 4-D
        scan-chunk stacks collapse to (Cp, W2P, Dp) / (Cp, A).  Inside
        jit this is a bitcast (contiguous row-major), so the flat view
        costs no HBM; 3-D flat pools pass through untouched."""
        if pool.ndim == 4:
            pool = pool.reshape((-1,) + pool.shape[2:])
            if aux is not None:
                aux = aux.reshape((-1,) + aux.shape[2:])
        return pool, aux

    def _exact_parts(self):
        """(project, gather, score) closures for the probed exact stage,
        specialized by pool dtype.  ``gather`` takes the flat pool (and
        int8 aux) as ARGUMENTS: every large array must enter the jitted
        query programs as a parameter, not a closure, or it lowers as an
        HLO constant.  Pools are candidate-major, so gather is one row
        index (plus the int8 aux rows) and probed scores match
        brute-force `query` exactly (same per-candidate quantization)."""
        eng = self.engine
        w = eng.params["sim"]["w"]
        interpret = eng.interpret
        if eng.quant is None:
            def project(q_tokens):
                return project_queries(q_tokens, w, dtype=eng.pool_dtype)

            def gather(idx, pool_flat, aux_flat):
                return pool_flat[idx]

            def score(proj_i, sub):
                return bilinear_maxsim_scores(proj_i[None], sub,
                                              interpret=interpret)[0]

            return project, gather, score

        def project(q_tokens):
            return project_queries_int8(q_tokens, w)   # (qw_i8, scales)

        def gather(idx, pool_flat, aux_flat):
            return pool_flat[idx], aux_flat[idx]

        def score(proj_i, sub):
            qw_i, qs_i = proj_i
            sub_pool, sub_aux = sub
            return bilinear_maxsim_scores_int8(
                qw_i[None], qs_i[None], sub_pool, sub_aux,
                interpret=interpret)[0]

        return project, gather, score

    def _route_qw(self, q_tokens, proj):
        """bf16 projected queries for the coarse/routing stage: the
        float exact stage's own projection doubles as it; int8 engines
        keep a separate bf16 projection (their exact stage projects to
        int8)."""
        eng = self.engine
        if eng.quant is None:
            return proj
        w = eng.params["sim"]["w"]
        return project_queries(q_tokens, w, dtype=jnp.bfloat16)

    def _build_query_fn(self, k: int, nprobe: int):
        eng = self.engine
        embed_params = eng.params["embed"]
        bucket_width = int(self.bucket_map.shape[1])
        project, gather, score = self._exact_parts()

        def fn(query_ids, pool_flat, aux_flat, bucket_map, valid, cent):
            pool_flat, aux_flat = self._flatten_storage(pool_flat,
                                                        aux_flat)
            if query_ids.ndim == 3:
                q_tokens = query_ids
            else:
                q_tokens = embed_lookup(embed_params, query_ids)
            proj = project(q_tokens)
            qw = self._route_qw(q_tokens, proj)
            # coarse: (sum_{m,i} q_i W_m) . mean_j a_j; qw's mask lane is
            # constant 1 per row but the centroid lanes beyond D are zero
            u = jnp.sum(qw.astype(jnp.float32), axis=1)  # (Nq, Dp)
            cs = u[:, : cent.shape[1]] @ cent.T          # (Nq, K)
            _, cl = jax.lax.top_k(cs, nprobe)            # (Nq, P)

            pb = nprobe * bucket_width
            # the kernel tiles the candidate axis in BLOCK_C-row blocks:
            # pad the probed set with masked slots up to the next multiple
            pb_pad = -(-pb // BLOCK_C) * BLOCK_C

            def per_query(args):
                proj_i, cl_i = args
                idx = bucket_map[cl_i].reshape(-1)       # (P*B,)
                ok = valid[cl_i].reshape(-1)
                if pb_pad != pb:
                    idx = jnp.pad(idx, (0, pb_pad - pb),
                                  constant_values=-1)
                    ok = jnp.pad(ok, (0, pb_pad - pb))
                sub = gather(jnp.clip(idx, 0), pool_flat, aux_flat)
                s = jnp.where(ok, score(proj_i, sub), -jnp.inf)
                v, j = jax.lax.top_k(s, k)
                # unprobed/padding slots come back as index -1, score -inf
                return v, jnp.where(jnp.take(ok, j), jnp.take(idx, j), -1)

            return jax.lax.map(per_query, (proj, cl))

        return jax.jit(fn)

    def query(self, query_ids, k: int = 10, *, nprobe: int = 8):
        """(scores (Nq, k'), candidate indices (Nq, k')) over the probed
        set; k' = min(k, nprobe * bucket).  Slots beyond the probed set's
        valid candidates return index -1 with score -inf."""
        nprobe = min(nprobe, self.n_clusters)
        k = min(k, nprobe * self.bucket, self.engine.pool_size)
        key = (k, nprobe)
        if self._jit is None or self._jit[0] != key:
            self._jit = (key, self._build_query_fn(k, nprobe))
        if self._cent_dev is None:
            self._cent_dev = jnp.asarray(self._cent_f32)
        return self._jit[1](jnp.asarray(query_ids), self._pool_flat(),
                            self._aux_flat(), self.bucket_map, self.valid,
                            self._cent_dev)

    # ------------------------------------------------- flat coarse variant
    def _build_coarse_fn(self, k: int, shortlist: int,
                         approx_recall: float | None = None):
        eng = self.engine
        embed_params = eng.params["embed"]
        interpret = eng.interpret
        # structural flags are STATIC (trace one branch); the arrays
        # themselves enter as arguments — see _exact_parts' capture note
        multi_vector = self.coarse_pool is not None
        has_live_neg = self.live_neg is not None
        s_pad = -(-shortlist // BLOCK_C) * BLOCK_C  # kernel tile align
        # shortlist selection: exact lax.top_k at k=1024 over a 262k/1M-row
        # score vector can be a full sort.  The coarse scores are already
        # approximate — the exact kernel rescores the shortlist — so
        # approx_max_k (recall_target per element, misses concentrate at
        # the shortlist BOUNDARY where the true top-k never lives) is the
        # right primitive where a backend implements it approximately; XLA
        # lowers it to exact top-k on the GPU and CPU.  Small shortlists
        # and small pools keep exact top_k: approx needs room to tile.
        use_approx = (approx_recall is not None and shortlist >= 256
                      and eng.pool_size >= 8 * shortlist)
        project, gather, score = self._exact_parts()

        def fn(query_ids, pool_flat, aux_flat, coarse_ref, live_neg):
            pool_flat, aux_flat = self._flatten_storage(pool_flat,
                                                        aux_flat)
            if query_ids.ndim == 3:
                q_tokens = query_ids
            else:
                q_tokens = embed_lookup(embed_params, query_ids)
            proj = project(q_tokens)
            qw = self._route_qw(q_tokens, proj)
            if multi_vector:
                # multi-vector coarse: the exact kernel over the T-token
                # mini pool (same max structure, W2/T less work)
                cs = bilinear_maxsim_scores(qw, coarse_ref,
                                            interpret=interpret)
            else:
                u = jnp.sum(qw.astype(jnp.float32), axis=1)
                cs = u[:, : coarse_ref.shape[1]] @ coarse_ref.T.astype(
                    jnp.float32)
                if has_live_neg:
                    cs = cs + live_neg  # tombstones never shortlist
            if use_approx:
                _, sl = jax.lax.approx_max_k(
                    cs, shortlist, recall_target=float(approx_recall))
            else:
                _, sl = jax.lax.top_k(cs, shortlist)     # (Nq, S)

            def per_query(args):
                proj_i, sl_i = args
                idx = sl_i
                ok = jnp.ones_like(idx, dtype=bool)
                if s_pad != shortlist:
                    idx = jnp.pad(idx, (0, s_pad - shortlist))
                    ok = jnp.pad(ok, (0, s_pad - shortlist))
                sub = gather(idx, pool_flat, aux_flat)
                s = jnp.where(ok, score(proj_i, sub), -jnp.inf)
                v, j = jax.lax.top_k(s, k)
                return v, jnp.take(idx, j)

            return jax.lax.map(per_query, (proj, sl))

        return jax.jit(fn)

    def query_coarse(self, query_ids, k: int = 10, *,
                     shortlist: int = 1024,
                     approx_recall: float | None = 0.95):
        """Flat two-stage retrieval: ONE dense coarse matmul over ALL
        candidates (cheap even at 1M: one (Nq, D) x (D, C) matmul),
        exact kernel only on the top-``shortlist``.  No cluster routing
        loss — strictly better recall than `query` at the same probed
        budget; use `query`'s IVF when even the coarse matmul is too
        much (100M+ pools).

        approx_recall: per-element recall target for the shortlist
        selection via lax.approx_max_k (engaged when
        ``shortlist >= 256`` and the pool is >= 8x the shortlist; exact
        ``lax.top_k`` otherwise).  None forces exact selection
        everywhere.  Boundary misses are rescored away by the exact
        stage; end recall@k is unaffected at the defaults."""
        shortlist = min(shortlist, self.engine.pool_size)
        k = min(k, shortlist)
        key = (k, shortlist, approx_recall)
        if self._coarse_jit is None or self._coarse_jit[0] != key:
            self._coarse_jit = (key, self._build_coarse_fn(
                k, shortlist, approx_recall))
        pool_flat, aux_flat = self._flat()
        coarse_ref = (self.coarse_pool if self.coarse_pool is not None
                      else self.coarse)
        return self._coarse_jit[1](jnp.asarray(query_ids), pool_flat,
                                   aux_flat, coarse_ref, self.live_neg)


def ivf_recall(engine, query_ids, *, k: int = 10, nprobe: int = 8,
               method: str = "ivf", shortlist: int = 1024,
               brute_idx=None):
    """Fraction of brute-force top-k candidates the approximate probe
    recovers (macro-averaged over queries) — the standard recall@k gauge
    for the latency/recall trade.  method: "ivf" (cluster-routed,
    ``nprobe``) or "coarse" (flat shortlist, ``shortlist``).

    ``brute_idx`` (Nq, k) lets callers sweeping nprobe/shortlist compute
    the exact top-k ONCE instead of re-scoring the whole pool per sweep
    point (a 1M-pool brute pass per call is the dominant cost)."""
    if brute_idx is None:
        _, brute_idx = engine.query(query_ids, k=k)
    if method == "coarse":
        iv, ii = engine.ivf.query_coarse(query_ids, k=k,
                                         shortlist=shortlist)
    else:
        iv, ii = engine.query_ivf(query_ids, k=k, nprobe=nprobe)
    bi, ii = np.asarray(brute_idx), np.asarray(ii)
    hits = [len(set(b.tolist()) & set(i[i >= 0].tolist())) / len(b)
            for b, i in zip(bi, ii)]
    return float(np.mean(hits))
