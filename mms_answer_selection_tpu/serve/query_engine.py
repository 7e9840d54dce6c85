"""Query engine: index a candidate pool, batch-score queries, top-k on-chip.

This replaces the reference's serve path -- `caffe test` / pycaffe
net.forward over a whole split at once (tools/caffe.cpp:229-296,
do_trec_qa_clean.py:617-652) -- with an actual retrieval engine
(BASELINE.json configs[3]: brute-force learned-metric retrieval over a 1M
candidate pool, sharded top-k across a mesh):

* ``build_index`` embeds and packs the candidate pool once, sharded over the
  mesh's devices along the candidate axis (the serve-time long axis).
* ``query`` projects the query tokens through the learned metric (Q·W_m
  amortized over the pool), scores every candidate with the fused Pallas
  MaxSim kernel -- the (Nq·M·W1)×(Nc·W2) similarity tensor never touches
  HBM -- and selects top-k per shard with ``lax.top_k`` before a global
  merge, so only (shards × k) candidates ever cross the interconnect.
* ``score_pairs`` runs the full interaction model (conv encoder over the
  Q×A map) for exact reference-model scores on explicit pairs -- the
  rescoring stage of a two-phase retrieve-then-rerank serve.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.mms_qa import MMSQAConfig, mms_qa_apply
from ..ops.embed import embed_lookup
from ..ops import sim_cross_pallas as kernels
from ..ops.sim_cross_pallas import (
    BLOCK_C,
    NEG_INF,
    mask_candidate_rows,
    mask_candidate_rows_int8,
    mask_out_candidates,
    mask_out_candidates_int8,
    pack_candidate_pool,
    pack_candidate_pool_int8,
    project_queries,
    project_queries_int8,
)

# pool_dtype strings that select a quantized pool
_QUANT = ("int8",)


def _score(qw, qs, pool, aux, interpret):
    """Kernel scores (Nq, C) for a float (qs/aux None) or int8 pool.  The
    scorers are looked up on the kernel module at trace time, so a
    measurement can swap in the plain XLA version."""
    if qs is None:
        return kernels.bilinear_maxsim_scores(qw, pool, interpret=interpret)
    return kernels.bilinear_maxsim_scores_int8(qw, qs, pool, aux,
                                               interpret=interpret)


def topk_merge(vals, idxs, k):
    """Merge per-shard top-k: (S, Nq, k) -> global (Nq, k)."""
    s, nq, kk = vals.shape
    flat_v = jnp.transpose(vals, (1, 0, 2)).reshape(nq, s * kk)
    flat_i = jnp.transpose(idxs, (1, 0, 2)).reshape(nq, s * kk)
    top_v, pos = jax.lax.top_k(flat_v, k)
    return top_v, jnp.take_along_axis(flat_i, pos, axis=1)


class QueryEngine:
    """Learned-metric retrieval over a fixed candidate pool.

    params: trained model params (uses 'embed' and 'sim' -- the learned
    metric); cfg: the model config; mesh: optional 1-axis ('c',) or 2-axis
    mesh whose LAST axis shards the candidate pool.
    """

    def __init__(self, params, cfg: MMSQAConfig, *, mesh: Mesh | None = None,
                 pool_dtype=jnp.bfloat16, interpret: bool | None = None,
                 chunk_size: int = 131072, scan_chunks: bool = True):
        """pool_dtype: jnp dtype for the packed pool, or "int8" (half the
        device memory of bf16 at ~1% score error; the serving default).
        Rerank with query_rerank/score_pairs when exactness matters.

        chunk_size: pools whose PER-SHARD size exceeds this are scored in
        chunks with incremental top-k merging (on a mesh: a lax.scan
        inside shard_map, one chunk stack per device), so the (Nq, C)
        score tensor never materializes for huge pools at any mesh size.

        scan_chunks: when True (default), chunked pools are scored by ONE
        jitted lax.scan over the stacked chunk axis -- a single dispatch
        for the whole pool.  False falls back to the host loop over one
        reused per-chunk executable, which keeps every compiled program's
        buffers chunk-sized."""
        if cfg.sim_mode != 2:
            raise ValueError("query engine requires the learned bilinear "
                             "metric (sim_mode=2)")
        self.params = params
        self.cfg = cfg
        self.mesh = mesh
        self.quant = pool_dtype if isinstance(pool_dtype, str) else None
        if self.quant is not None and self.quant not in _QUANT:
            raise ValueError(f"unknown quantized pool_dtype {pool_dtype!r}; "
                             f"use one of {sorted(_QUANT)} or a jnp dtype")
        self.pool_dtype = None if self.quant else pool_dtype
        self.interpret = interpret
        self.pool = None
        self.aux = None
        self.chunk_size = chunk_size
        self.scan_chunks = scan_chunks
        self.chunks = None  # list of (pool, aux) when chunked host-loop;
        #                     (stacked_pool, stacked_aux) when scan_chunks
        self.pool_size = 0
        self._padded_size = 0
        self._query_jit = None
        self._rerank_jit = None
        self._cand_tok_dev = None  # device copy of cand_token_ids (fused
        #                            rerank gathers shortlists on-chip)
        self.cand_token_ids = None  # set by build_index (rerank path)
        self.ivf = None  # set by build_ivf (approximate serve path)
        self.deleted = np.zeros(0, np.int64)  # tombstoned global rows

    # ------------------------------------------------------------------ build
    def build_index(self, candidate_ids, *, reserve: int = 0):
        """candidate_ids: int (C, W2) token ids.  Embeds with the trained
        table and packs/shards the pool.  The ids are retained on the
        HOST (small: C x W2 int32) so `query_rerank` can hand
        shortlisted candidates to the exact scorer.

        reserve: pre-pad this many extra (masked) candidate slots so
        later `add_candidates` calls fill capacity in place instead of
        growing the chunk stack (each distinct chunk count compiles its
        own scan program)."""
        candidate_ids = np.asarray(candidate_ids)
        self.cand_token_ids = candidate_ids
        return self._build(candidate_ids, self._embed_tokens,
                           reserve=reserve)

    def build_index_from_tokens(self, candidate_tokens):
        """candidate_tokens: (C, T, D) PRECOMPUTED token embeddings -- e.g.
        image patch tokens from models.caption_image.encode_image, or any
        modality living in the metric's D-dim space.  Same sharding/
        chunking behavior as build_index."""
        candidate_tokens = np.asarray(candidate_tokens)
        self.cand_token_ids = None  # no ids -> no query_rerank
        return self._build(candidate_tokens,
                           lambda chunk: jnp.asarray(chunk))

    def _embed_tokens(self, chunk):
        return embed_lookup(self.params["embed"], jnp.asarray(chunk))

    def _build(self, candidates, to_tokens, reserve: int = 0):
        # candidates stay a HOST array: per-chunk packing device_puts one
        # chunk-sized slice at a time, so a 1M-candidate f32 token pool
        # (16 GB) never materializes wholesale on the chip — the memory
        # bound the chunking exists for
        candidates = np.asarray(candidates)
        c = candidates.shape[0]
        shards = 1 if self.mesh is None else int(
            np.prod([self.mesh.shape[a] for a in self.mesh.axis_names]))
        # pad pool to a multiple of (shards * the kernel's tile); pools
        # whose PER-SHARD size exceeds chunk_size additionally pad to a
        # (shards * chunk) multiple and are scored by the chunk scan --
        # on a mesh the scan runs inside shard_map, so arbitrary pool
        # sizes shard over the devices AND never materialize more than
        # (Nq, chunk) scores per device
        if self.chunk_size % BLOCK_C:
            # chunks are scored as standalone pools, so each must be a
            # whole number of kernel tiles -- round chunk_size up
            self.chunk_size = -(-self.chunk_size // BLOCK_C) * BLOCK_C
        mult = shards * BLOCK_C
        chunked = c + reserve > self.chunk_size * shards
        if chunked:
            mult = max(mult, shards * self.chunk_size)
        c_pad = (c + reserve + mult - 1) // mult * mult
        if c_pad != c:
            pad_rows = np.zeros((c_pad - c,) + candidates.shape[1:],
                                candidates.dtype)
            candidates = np.concatenate([candidates, pad_rows], 0)

        pack = self._pack_closure(to_tokens)

        if chunked:
            # per-chunk embed+pack: a 1M-candidate pool never materializes
            # multi-GB f32 intermediates (and each chunk's executables stay
            # within the compiler's buffer budget).  Candidate order: shard
            # s owns the contiguous global range [s*per_shard, (s+1)*
            # per_shard); its chunk i covers s*per_shard + i*chunk.
            per_shard = c_pad // shards
            n_chunks = per_shard // self.chunk_size

            def pack_at(g0):
                """pack the chunk whose global range starts at g0; padding
                rows [max(0, c - g0):] masked (possibly the whole chunk)."""
                hi = g0 + self.chunk_size
                mask_from = max(0, c - g0) if c < hi else None
                return pack(candidates[g0:hi], mask_from)

            if self.mesh is not None:
                # stacked (n_chunks, shards*chunk, ...): sharding axis 1
                # over the mesh hands device s exactly its chunk stack
                rows = []
                for i in range(n_chunks):
                    row = [pack_at(s * per_shard + i * self.chunk_size)
                           for s in range(shards)]
                    rows.append((jnp.concatenate([p for p, _ in row]),
                                 jnp.concatenate([a for _, a in row])
                                 if row[0][1] is not None else None))
                pools = jnp.stack([p for p, _ in rows])
                auxs = jnp.stack([a for _, a in rows]) \
                    if rows[0][1] is not None else None
                self.chunks = self._put_chunked(pools, auxs)
            else:
                if self.scan_chunks:
                    # one (n_chunks, chunk, ...) buffer; query() scans it.
                    # Filled by DONATED in-place updates -- jnp.stack over
                    # a parts list would transiently hold the pool TWICE
                    setter = jax.jit(
                        lambda buf, part, i: buf.at[i].set(part),
                        donate_argnums=(0,))
                    pools = auxs = None
                    for i in range(n_chunks):
                        p_i, a_i = pack_at(i * self.chunk_size)
                        if pools is None:
                            pools = jnp.zeros((n_chunks,) + p_i.shape,
                                              p_i.dtype)
                            if a_i is not None:
                                auxs = jnp.zeros((n_chunks,) + a_i.shape,
                                                 a_i.dtype)
                        pools = setter(pools, p_i, i)
                        if a_i is not None:
                            auxs = setter(auxs, a_i, i)
                    self.chunks = (pools, auxs)
                else:
                    self.chunks = [pack_at(i * self.chunk_size)
                                   for i in range(n_chunks)]
            self.pool, self.aux = None, None
        else:
            pool, aux = pack(candidates, c if c_pad != c else None)
            if self.mesh is not None:
                pool, aux = self._put_flat(pool, aux)
            self.chunks = None
            self.pool = pool
            self.aux = aux
        self.pool_size, self._padded_size = c, c_pad
        self._query_jit = None
        self._rerank_jit = None
        self._cand_tok_dev = None
        self.ivf = None  # a rebuilt pool invalidates any IVF over it
        self.deleted = np.zeros(0, np.int64)
        return self

    def _pack_closure(self, to_tokens):
        def pack(chunk, mask_from: int | None):
            """tokenize + pack one chunk; mask_from masks candidates [i:]
            of THIS chunk (pool-padding rows)."""
            tokens = to_tokens(chunk)
            if self.quant:
                pool_c, aux_c = pack_candidate_pool_int8(tokens)
                if mask_from is not None:
                    aux_c = mask_out_candidates_int8(aux_c, mask_from)
                return pool_c, aux_c
            pool_c = pack_candidate_pool(tokens, dtype=self.pool_dtype)
            if mask_from is not None:
                pool_c = mask_out_candidates(pool_c, mask_from)
            return pool_c, None
        return pack

    # ------------------------------------------------------- incremental
    def add_candidates(self, candidate_ids):
        """Append candidates to a BUILT ids-index without re-embedding
        the existing pool: only the chunks that gain rows are repacked
        (from the host-retained token ids), and the chunk stack grows
        only when capacity — including ``build_index(reserve=...)``
        headroom — runs out (each distinct chunk count compiles its own
        scan program, so bulk adds beat row-at-a-time).  Single-device,
        ids-built engines; meshed pools rebuild (growth shifts every
        shard's contiguous global range).  Any IVF index is dropped (it
        does not cover the new rows) — call build_ivf again after bulk
        adds.  Returns the new rows' global indices.

        The reference has no incremental story at all: its serve path
        re-embeds the whole split every run (do_trec_qa_clean.py:
        617-652)."""
        if self.pool_size == 0:
            raise ValueError("build_index first")
        if self.mesh is not None:
            raise ValueError("add_candidates is single-device; meshed "
                             "pools rebuild with build_index")
        if self.cand_token_ids is None:
            raise ValueError("add_candidates needs an ids-built index "
                             "(build_index, not build_index_from_tokens)")
        if isinstance(self.chunks, list):
            raise ValueError("add_candidates needs scan_chunks=True "
                             "storage")
        new_ids = np.asarray(candidate_ids)
        if new_ids.ndim != 2 or \
                new_ids.shape[1:] != self.cand_token_ids.shape[1:]:
            raise ValueError(
                f"candidate_ids must be (N, {self.cand_token_ids.shape[1]})"
                f" token ids, got {new_ids.shape}")
        old_c = self.pool_size
        deleted = self.deleted  # _build (transition path) resets it
        ids = np.concatenate([self.cand_token_ids, new_ids], 0)
        c = ids.shape[0]
        pack = self._pack_closure(self._embed_tokens)

        def padded_to(n):
            if n == c:
                return ids
            return np.concatenate(
                [ids, np.zeros((n - c,) + ids.shape[1:], ids.dtype)], 0)

        if self.chunks is None:
            if c > self.chunk_size:
                # crosses into chunked storage: one-time full rebuild
                self._build(ids, self._embed_tokens)
            else:
                c_pad = max(self._padded_size, -(-c // BLOCK_C) * BLOCK_C)
                self.pool, self.aux = pack(
                    padded_to(c_pad), c if c_pad != c else None)
                self._padded_size = c_pad
        else:
            pools, auxs = self.chunks
            k = self.chunk_size
            n_chunks = pools.shape[0]
            c_pad = max(n_chunks * k, -(-c // k) * k)
            padded = padded_to(c_pad)
            setter = jax.jit(lambda buf, part, i: buf.at[i].set(part),
                             donate_argnums=(0,))
            extra = []
            for i in range(old_c // k, c_pad // k):
                g0 = i * k
                mask_from = max(0, c - g0) if c < g0 + k else None
                p_i, a_i = pack(padded[g0:g0 + k], mask_from)
                if i < n_chunks:
                    pools = setter(pools, p_i, i)
                    if a_i is not None:
                        auxs = setter(auxs, a_i, i)
                else:
                    extra.append((p_i, a_i))
            if extra:
                # growth step: transiently ~2x the grown chunks' HBM
                pools = jnp.concatenate(
                    [pools, jnp.stack([p for p, _ in extra])])
                if extra[0][1] is not None:
                    auxs = jnp.concatenate(
                        [auxs, jnp.stack([a for _, a in extra])])
                self._padded_size = c_pad
            self.chunks = (pools, auxs)
        self.cand_token_ids = ids
        self._cand_tok_dev = None  # grew: the fused rerank re-uploads
        self.pool_size = c
        self.ivf = None
        self.deleted = deleted
        # repacking from ids resurrects tombstoned rows — re-mask them
        if len(deleted):
            self._mask_rows(deleted)
        return np.arange(old_c, c)

    def remove_candidates(self, rows):
        """Tombstone candidates: their scores become -inf on every path
        (exact, chunked, meshed, IVF probe/coarse, rerank — deleted rows
        can never shortlist), without touching any other row.  A pure
        scatter into the float pool's mask lane / the quantized pool's
        aux rows, so it needs no re-embedding and works on every built
        storage.  Slots are NOT reclaimed: `add_candidates` appends at
        the end; rebuild to compact.  n_live tracks the survivors."""
        rows = np.unique(np.asarray(rows, np.int64).ravel())
        if rows.size == 0:
            return self
        if self.pool_size == 0:
            raise ValueError("build_index first")
        if rows[0] < 0 or rows[-1] >= self.pool_size:
            raise ValueError(f"row out of range [0, {self.pool_size})")
        self._mask_rows(rows)
        self.deleted = np.union1d(self.deleted, rows)
        if self.ivf is not None:
            # the IVF hands pool views to its query programs as ARGUMENTS
            # (never closures), but its cached flat view still points at
            # the PRE-mask arrays — drop it, plus the jits whose traced
            # live_neg structure may change (the bucket/coarse routing may
            # still shortlist the dead rows — wasted slots, never wrong
            # results)
            self.ivf._flat_cache = None
            self.ivf._jit = None
            self.ivf._coarse_jit = None
        return self

    @property
    def n_live(self) -> int:
        """Candidates that can still surface in top-k (pool_size minus
        tombstones)."""
        return self.pool_size - len(self.deleted)

    def compact(self):
        """Rebuild the pool from the live rows only, reclaiming
        tombstoned slots (global indices SHIFT).  Returns an
        (old_pool_size,) int64 map old->new index, -1 for deleted rows.
        Ids-built engines only; meshed engines re-shard through the
        same rebuild.  Any IVF index is dropped (the rebuild
        invalidates it)."""
        if self.pool_size == 0:
            raise ValueError("build_index first")
        if self.cand_token_ids is None:
            raise ValueError("compact needs an ids-built index")
        if self.n_live == 0:
            raise ValueError("no live rows to compact to")
        keep = np.setdiff1d(np.arange(self.pool_size), self.deleted)
        mapping = np.full(self.pool_size, -1, np.int64)
        mapping[keep] = np.arange(len(keep))
        ids = np.asarray(self.cand_token_ids)[keep]
        self._build(ids, self._embed_tokens)  # resets deleted + ivf
        self.cand_token_ids = ids
        return mapping

    def _mask_rows(self, rows):
        """Scatter padding masks into the given GLOBAL candidate rows,
        storage-aware (flat / stacked chunks / host-loop chunk list,
        single-device or meshed)."""
        rows = np.asarray(rows, np.int64)

        def mask_flat(pool, aux, r):
            if self.quant:
                return pool, mask_candidate_rows_int8(aux, jnp.asarray(r))
            return mask_candidate_rows(pool, jnp.asarray(r)), aux

        if self.chunks is None:
            self.pool, self.aux = mask_flat(self.pool, self.aux, rows)
            if self.mesh is not None:  # scatter can drop the sharding
                self.pool, self.aux = self._put_flat(self.pool, self.aux)
            return
        k = self.chunk_size
        # global row -> (chunk, column) in the stacked layout: shard s
        # owns [s*per_shard, (s+1)*per_shard); its chunk i covers
        # s*per_shard + i*k; the stacked column is s*k + within-chunk
        per_shard = self._padded_size // self._shards()
        s, within = rows // per_shard, rows % per_shard
        ci, ri = within // k, s * k + within % k
        if isinstance(self.chunks, list):
            out = []
            for i, (pool_i, aux_i) in enumerate(self.chunks):
                r = ri[ci == i]
                if r.size:
                    pool_i, aux_i = mask_flat(pool_i, aux_i, r)
                out.append((pool_i, aux_i))
            self.chunks = out
            return
        pools, auxs = self.chunks
        ci, ri = jnp.asarray(ci), jnp.asarray(ri)
        if self.quant:
            auxs = auxs.at[ci, ri, 0].set(0.0)
            auxs = auxs.at[ci, ri, 1].set(NEG_INF)
        else:
            pools = pools.at[ci, ri, :, -1].set(NEG_INF)
        if self.mesh is not None:  # scatter can drop the sharding
            pools, auxs = self._put_chunked(pools, auxs)
        self.chunks = (pools, auxs)

    # ------------------------------------------------------------ persistence
    def _shards(self) -> int:
        return 1 if self.mesh is None else int(
            np.prod([self.mesh.shape[a] for a in self.mesh.axis_names]))

    def _put_chunked(self, pools, auxs):
        """Shard a stacked (n_chunks, shards*chunk, ...) pool over the
        mesh (axis 1 -> devices), mirroring _build's chunked layout."""
        axes = self.mesh.axis_names if len(self.mesh.axis_names) > 1 \
            else self.mesh.axis_names[0]
        spec = NamedSharding(self.mesh, P(None, axes))
        pools = jax.device_put(pools, spec)
        if auxs is not None:
            auxs = jax.device_put(auxs, spec)
        return pools, auxs

    def _put_flat(self, pool, aux):
        """Shard an unchunked pool over the mesh (axis 0 -> devices)."""
        axis = self.mesh.axis_names[-1] \
            if len(self.mesh.axis_names) == 1 else self.mesh.axis_names
        spec = NamedSharding(self.mesh, P(axis))
        pool = jax.device_put(pool, spec)
        if aux is not None:
            aux = jax.device_put(aux, spec)
        return pool, aux

    def _params_fingerprint(self) -> str:
        """Digest of the arrays the index bakes in (embed table + metric
        W): a pool packed under one set of weights silently mis-scores
        under another, so load_index refuses a mismatch."""
        import hashlib
        h = hashlib.blake2b(digest_size=16)
        h.update(np.ascontiguousarray(
            np.asarray(self.params["embed"]["w"], np.float32)).tobytes())
        h.update(np.ascontiguousarray(
            np.asarray(self.params["sim"]["w"], np.float32)).tobytes())
        return h.hexdigest()

    def save_index(self, path: str):
        """Persist the built (packed/quantized) pool — and the IVF index
        if one exists — so a serving process restarts warm instead of
        re-embedding and re-clustering the whole pool.  The reference
        has no index to save (its serve path recomputes everything per
        run, do_trec_qa_clean.py:617-652); model weights there persist
        via .caffemodel, and this is the analogous artifact for the
        rebuild's serving state."""
        if self.pool_size == 0:
            raise ValueError("nothing to save; build_index first")
        if isinstance(self.chunks, list):
            raise ValueError("save_index needs scan_chunks=True storage")
        data = {
            "version": np.int64(1),
            # pool padding/layout is a function of the shard count, so a
            # meshed index only reloads onto an equal-size mesh
            "shards": np.int64(self._shards()),
            "fingerprint": np.frombuffer(
                self._params_fingerprint().encode(), np.uint8),
            "pool_size": np.int64(self.pool_size),
            "padded_size": np.int64(self._padded_size),
            "chunk_size": np.int64(self.chunk_size),
            "quant": np.frombuffer((self.quant or "").encode(), np.uint8),
            "pool_dtype": np.frombuffer(
                ("" if self.pool_dtype is None
                 else np.dtype(self.pool_dtype).name).encode(), np.uint8),
        }
        if len(self.deleted):
            data["deleted"] = self.deleted
        if self.cand_token_ids is not None:
            data["cand_token_ids"] = self.cand_token_ids
        if self.chunks is not None:
            pools, auxs = self.chunks
            data["chunk_pools"] = np.asarray(pools)
            if auxs is not None:
                data["chunk_auxs"] = np.asarray(auxs)
        else:
            data["pool"] = np.asarray(self.pool)
            if self.aux is not None:
                data["aux"] = np.asarray(self.aux)
        if self.ivf is not None:
            iv = self.ivf
            data.update(
                ivf_bucket_map=np.asarray(iv.bucket_map),
                ivf_centroids=iv._cent_f32,
                ivf_coarse=np.asarray(iv.coarse, np.float32),
                ivf_meta=np.asarray([iv.n_clusters, iv.bucket,
                                     iv.spilled, iv.coarse_tokens],
                                    np.int64))
            if iv.coarse_pool is not None:
                data["ivf_coarse_pool"] = np.asarray(iv.coarse_pool,
                                                     np.float32)
        # np.load restores ml_dtypes.bfloat16 as a void dtype ("V2");
        # store such arrays as uint16 bit patterns + the key list.
        arrays = {k: np.asarray(v) for k, v in data.items()}
        bf16_keys = [k for k, a in arrays.items() if a.dtype == jnp.bfloat16]
        for k in bf16_keys:
            arrays[k] = arrays[k].view(np.uint16)
        arrays["bf16_keys"] = np.frombuffer(
            ",".join(bf16_keys).encode(), np.uint8)
        # atomic: a crash mid-write must not leave a truncated index a
        # warm restart would then try to load
        import os
        tmp = path + ".tmp"
        np.savez(tmp, **arrays)
        # np.savez appends .npz to paths without it
        os.replace(tmp if os.path.exists(tmp) else tmp + ".npz", path)

    def load_index(self, path: str):
        """Restore a save_index artifact into this engine (same config
        and SAME params — verified by fingerprint)."""
        z_raw = np.load(path, allow_pickle=False)
        bf16_names = set(bytes(z_raw["bf16_keys"]).decode().split(",")) \
            if "bf16_keys" in z_raw else set()

        class _Z:  # view bf16 bit patterns back on access
            def __contains__(self, k):
                return k in z_raw
            def __getitem__(self, k):
                a = z_raw[k]
                return a.view(jnp.bfloat16) if k in bf16_names else a
        z = _Z()
        fp = bytes(z["fingerprint"]).decode()
        if fp != self._params_fingerprint():
            raise ValueError(
                "index was packed under different weights (embed/sim "
                "fingerprint mismatch); rebuild with build_index")
        quant = bytes(z["quant"]).decode() or None
        pd = bytes(z["pool_dtype"]).decode()
        if quant != self.quant or (
                (self.pool_dtype is None) != (pd == "")) or (
                pd and np.dtype(self.pool_dtype) != np.dtype(pd)):
            raise ValueError(
                f"index pool dtype ({quant or pd}) does not match this "
                f"engine ({self.quant or self.pool_dtype})")
        saved_shards = int(z["shards"]) if "shards" in z else 1
        if saved_shards != self._shards():
            raise ValueError(
                f"index was packed for {saved_shards} shard(s); this "
                f"engine's mesh has {self._shards()} — the pool padding "
                "layout differs, rebuild with build_index")
        self.pool_size = int(z["pool_size"])
        self._padded_size = int(z["padded_size"])
        self.chunk_size = int(z["chunk_size"])
        self.cand_token_ids = (z["cand_token_ids"]
                               if "cand_token_ids" in z else None)
        self.deleted = (np.asarray(z["deleted"], np.int64)
                        if "deleted" in z else np.zeros(0, np.int64))
        if "chunk_pools" in z:
            pools = jnp.asarray(z["chunk_pools"])
            auxs = (jnp.asarray(z["chunk_auxs"])
                    if "chunk_auxs" in z else None)
            if self.mesh is not None:
                pools, auxs = self._put_chunked(pools, auxs)
            self.chunks = (pools, auxs)
            self.pool = self.aux = None
        else:
            pool = jnp.asarray(z["pool"])
            aux = jnp.asarray(z["aux"]) if "aux" in z else None
            if self.mesh is not None:
                pool, aux = self._put_flat(pool, aux)
            self.pool, self.aux = pool, aux
            self.chunks = None
        self._query_jit = None
        self._rerank_jit = None
        self._cand_tok_dev = None
        self.ivf = None
        if "ivf_meta" in z:
            from .ivf import IVFIndex
            iv = IVFIndex.__new__(IVFIndex)
            iv.engine = self
            n_clusters, bucket, spilled, coarse_tokens = (
                int(v) for v in z["ivf_meta"])
            iv.n_clusters, iv.bucket = n_clusters, bucket
            iv.spilled, iv.coarse_tokens = spilled, coarse_tokens
            iv.bucket_map = jnp.asarray(z["ivf_bucket_map"])
            iv.valid = iv.bucket_map >= 0
            iv._cent_f32 = z["ivf_centroids"]
            iv.coarse = jnp.asarray(z["ivf_coarse"], jnp.bfloat16)
            iv.coarse_pool = (
                jnp.asarray(z["ivf_coarse_pool"],
                            self.pool_dtype or jnp.bfloat16)
                if "ivf_coarse_pool" in z else None)
            iv.live_neg = None
            if len(self.deleted):
                ln = np.zeros(self.pool_size, np.float32)
                ln[self.deleted] = -np.inf
                iv.live_neg = jnp.asarray(ln)
            iv._jit = None
            iv._coarse_jit = None
            iv._flat_cache = None
            iv._cent_dev = None
            self.ivf = iv
        return self

    # ------------------------------------------------------------------ query
    def _build_query_fn(self, k: int):
        cfg, mesh = self.cfg, self.mesh
        interpret = self.interpret
        w = self.params["sim"]["w"]
        embed_params = self.params["embed"]
        pool_dtype = self.pool_dtype

        quant = self.quant

        def score_local(query_ids, pool, aux):
            if query_ids.ndim == 3:  # precomputed token embeddings
                q_tokens = query_ids
            else:
                q_tokens = embed_lookup(embed_params, query_ids)
            if quant:
                qw, qs = project_queries_int8(q_tokens, w)
            else:
                qw = project_queries(q_tokens, w, dtype=pool_dtype)
                qs = None
            return _score(qw, qs, pool, aux, interpret)

        if mesh is None:
            def query_fn(query_ids, pool, aux):
                scores = score_local(query_ids, pool, aux)
                vals, idx = jax.lax.top_k(scores, k)
                return vals, idx
            return jax.jit(query_fn)

        axes = mesh.axis_names if len(mesh.axis_names) > 1 \
            else mesh.axis_names[0]

        def shard_fn(query_ids, pool, aux):
            # per-shard scoring; pool (and int8 aux) carry the local shard
            scores = score_local(query_ids, pool, aux)
            vals, idx = jax.lax.top_k(scores, k)
            shard_sz = pool.shape[0]
            if isinstance(axes, tuple):
                shard_i = jax.lax.axis_index(axes[0]) * mesh.shape[axes[1]] \
                    + jax.lax.axis_index(axes[1])
            else:
                shard_i = jax.lax.axis_index(axes)
            idx = idx + shard_i * shard_sz
            # gather the (small) per-shard winners everywhere and merge;
            # all_gather over a TUPLE of axis names still adds ONE
            # leading axis of size prod(sizes) (verified on an 8-device
            # 2-axis mesh), so no reshape is needed either way
            vals_all = jax.lax.all_gather(vals, axes)     # (S, Nq, k)
            idx_all = jax.lax.all_gather(idx, axes)
            return topk_merge(vals_all, idx_all, k)

        pool_spec = P(axes)
        # check_vma=False: pallas_call inside shard_map would otherwise
        # require vma annotations on its out_shape (jax 0.9 vma checking)
        mapped = jax.shard_map(
            shard_fn, mesh=mesh,
            # the aux slot is an empty pytree (None) on the bf16 path, so
            # its spec is inert there
            in_specs=(P(), pool_spec, pool_spec),
            out_specs=(P(), P()),
            check_vma=False)
        return jax.jit(mapped)

    def _build_scan_query_fn(self, k: int):
        """One jitted executable scoring EVERY chunk via lax.scan with an
        incremental top-k merge in the carry: a single dispatch for the
        whole pool, and the (Nq, C) score tensor never exceeds
        (Nq, chunk_size).  On a mesh the scan runs INSIDE shard_map --
        each device scans its own chunk stack, then the per-shard winners
        (only (shards x k) rows) cross the interconnect for the global
        merge -- so chunking and sharding compose for pools of any size."""
        cfg = self.cfg  # noqa: F841  (kept for parity with _build_query_fn)
        interpret = self.interpret
        w = self.params["sim"]["w"]
        embed_params = self.params["embed"]
        pool_dtype = self.pool_dtype
        quant = self.quant
        chunk_size = self.chunk_size
        mesh = self.mesh

        def local_scan(query_ids, pools, auxs):
            if query_ids.ndim == 3:
                q_tokens = query_ids
            else:
                q_tokens = embed_lookup(embed_params, query_ids)
            if quant:
                qw, qs = project_queries_int8(q_tokens, w)
            else:
                qw = project_queries(q_tokens, w, dtype=pool_dtype)
                qs = None
            nq = q_tokens.shape[0]

            def body(carry, xs):
                vals, idxs = carry
                if quant:
                    pool_i, aux_i, i = xs
                else:
                    (pool_i, i), aux_i = xs, None
                s = _score(qw, qs, pool_i, aux_i, interpret)
                v, ix = jax.lax.top_k(s, k)
                ix = ix + i * chunk_size
                merged_v = jnp.concatenate([vals, v.astype(vals.dtype)], 1)
                merged_i = jnp.concatenate([idxs, ix], 1)
                v2, pos = jax.lax.top_k(merged_v, k)
                return (v2, jnp.take_along_axis(merged_i, pos, 1)), None

            n_chunks = pools.shape[0]
            init = (jnp.full((nq, k), -jnp.inf, jnp.float32),
                    jnp.zeros((nq, k), jnp.int32))
            xs = (pools, auxs, jnp.arange(n_chunks)) if quant \
                else (pools, jnp.arange(n_chunks))
            (vals, idxs), _ = jax.lax.scan(body, init, xs)
            return vals, idxs

        if mesh is None:
            return jax.jit(local_scan)

        axes = mesh.axis_names if len(mesh.axis_names) > 1 \
            else mesh.axis_names[0]

        def shard_fn(query_ids, pools, auxs):
            # pools: this shard's (n_chunks, chunk, ...) stack; indices
            # from local_scan are per-shard [0, n_chunks*chunk)
            vals, idx = local_scan(query_ids, pools, auxs)
            per_shard = pools.shape[0] * chunk_size
            if isinstance(axes, tuple):
                shard_i = jax.lax.axis_index(axes[0]) * mesh.shape[axes[1]] \
                    + jax.lax.axis_index(axes[1])
            else:
                shard_i = jax.lax.axis_index(axes)
            idx = idx + shard_i * per_shard
            # single gathered axis even for tuple axes (see
            # _build_query_fn's shard_fn note)
            vals_all = jax.lax.all_gather(vals, axes)     # (S, Nq, k)
            idx_all = jax.lax.all_gather(idx, axes)
            return topk_merge(vals_all, idx_all, k)

        chunk_spec = P(None, axes)
        mapped = jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(), chunk_spec, chunk_spec),
            out_specs=(P(), P()),
            check_vma=False)
        return jax.jit(mapped)

    def query(self, query_ids, k: int = 10):
        """query_ids: int (Nq, W1).  Returns (scores (Nq, k'), indices
        (Nq, k')) of the top-k candidates under the learned metric, with
        k' = min(k, n_live): a (live) pool smaller than k returns fewer
        results rather than padding or tombstone entries."""
        if self.pool is None and self.chunks is None:
            raise RuntimeError("build_index first")
        k = min(k, self.n_live)  # tombstones never pad out the top-k
        if self.chunks is not None:
            k_eff = min(k, self.chunk_size)
            if self.scan_chunks or self.mesh is not None:
                # a meshed chunked pool is always scored by the in-
                # shard_map scan (the host chunk loop cannot shard)
                key = ("scan", k_eff)
                if self._query_jit is None or self._query_jit[0] != key:
                    self._query_jit = (key, self._build_scan_query_fn(k_eff))
                pools, auxs = self.chunks
                return self._query_jit[1](jnp.asarray(query_ids), pools,
                                          auxs)
            if self._query_jit is None or self._query_jit[0] != k_eff:
                self._query_jit = (k_eff, self._build_query_fn(k_eff))
            fn = self._query_jit[1]
            query_ids = jnp.asarray(query_ids)
            all_vals, all_idx = [], []
            for i, (pool_i, aux_i) in enumerate(self.chunks):
                v, ix = fn(query_ids, pool_i, aux_i)
                all_vals.append(v)
                all_idx.append(ix + i * self.chunk_size)
            return topk_merge(jnp.stack(all_vals), jnp.stack(all_idx), k_eff)
        k = min(k, self.pool_size)
        if self._query_jit is None or self._query_jit[0] != k:
            self._query_jit = (k, self._build_query_fn(k))
        vals, idx = self._query_jit[1](jnp.asarray(query_ids), self.pool,
                                       self.aux)
        return vals, idx

    # ------------------------------------------------- approximate retrieval
    def build_ivf(self, n_clusters: int = 256, *, bucket: int | None = None,
                  kmeans_iters: int = 10, seed: int = 0,
                  coarse_tokens: int = 1):
        """Build a two-level IVF index over the packed pool (serve/ivf.py):
        k-means buckets over the candidates' coarse token-mean vectors;
        `query_ivf` probes only the top clusters with the exact kernel.
        coarse_tokens > 1 compresses each candidate to that many token
        centroids and scores the flat coarse stage with the exact kernel
        over the mini pool (better recall, ~W2/T of brute-force work).
        For latency-sensitive single queries on large pools — brute-force
        `query` stays the throughput path for query batches."""
        from .ivf import IVFIndex
        self.ivf = IVFIndex(self, n_clusters=n_clusters, bucket=bucket,
                            kmeans_iters=kmeans_iters, seed=seed,
                            coarse_tokens=coarse_tokens)
        return self.ivf

    def query_ivf(self, query_ids, k: int = 10, *, nprobe: int = 8):
        """Approximate top-k via the IVF index (build_ivf first): exact
        kernel scores over the ``nprobe`` best clusters only.  With
        nprobe == n_clusters this equals `query` exactly."""
        if self.ivf is None:
            raise RuntimeError("build_ivf first")
        return self.ivf.query(query_ids, k=k, nprobe=nprobe)

    # ------------------------------------------------------- exact rescoring
    def _build_rerank_fn(self, k: int, shortlist: int):
        """ONE jitted retrieve-then-rerank program: quantized shortlist
        top-S -> on-device gather of the shortlist's candidate token rows
        -> exact interaction-model rescore (mms_qa_apply) -> final top-k.
        The shortlist indices never visit the host, so a serve pays a
        single dispatch instead of 2+ (shortlist, host id gather, rescore,
        re-sort)."""
        chunked_scan = self.chunks is not None and (
            self.scan_chunks or self.mesh is not None)
        phase1 = (self._build_scan_query_fn(shortlist) if chunked_scan
                  else self._build_query_fn(shortlist))
        params, cfg = self.params, self.cfg

        def fused(state, query_ids, pool_a, pool_b, cand_tok,
                  overlap_feat):
            _, idx = phase1(query_ids, pool_a, pool_b)   # (Nq, S)
            nq, s = idx.shape
            cand = jnp.take(cand_tok, idx.reshape(-1), axis=0)
            q_rep = jnp.repeat(query_ids, s, axis=0)     # (Nq*S, W1)
            of = (jnp.zeros((nq * s, cfg.overlap_features), jnp.float32)
                  if overlap_feat is None
                  else jnp.repeat(overlap_feat, s, axis=0))
            batch = {"question": q_rep, "answer": cand,
                     "overlap_feat": of}
            out, _ = mms_qa_apply(params, state, batch, cfg, train=False)
            probs = out["prob"][:, 1].reshape(nq, s)
            vals, order = jax.lax.top_k(probs, k)
            return vals, jnp.take_along_axis(idx, order, axis=1)

        return jax.jit(fused)

    def query_rerank(self, state, query_ids, k: int = 10, *,
                     shortlist: int = 50, overlap_feat=None):
        """Two-phase retrieve-then-rerank in one call: the (quantized)
        kernel shortlists ``shortlist`` candidates per query, the FULL
        interaction model rescores exactly those pairs (the `caffe test`
        path), and the top-k by exact P(correct) comes back as
        (probs (Nq, k), candidate indices (Nq, k)).  Both phases and the
        candidate-id gather run inside ONE jitted dispatch (see
        `_build_rerank_fn`); only host-loop chunked pools
        (scan_chunks=False, no mesh) keep the per-phase dispatches.

        This is the int8 serving recipe: the quantized kernel owns the
        shortlist, the exact model owns the final order.  Needs
        ``build_index`` (token ids retained); `build_index_from_tokens`
        pools have no ids to rescore."""
        if self.cand_token_ids is None:
            raise ValueError(
                "query_rerank needs build_index(candidate_ids); a "
                "from-tokens pool keeps no candidate ids to rescore")
        if self.n_live == 0:
            raise ValueError("no live candidates to rerank")
        # clamp to LIVE rows: beyond n_live the phase-1 shortlist ties
        # into the -inf region (tombstones + pool padding) — rescoring
        # those with the exact model would resurrect deleted candidates
        shortlist = min(shortlist, self.n_live)
        if self.chunks is not None:
            shortlist = min(shortlist, self.chunk_size)
        k = min(k, shortlist)
        if self.chunks is not None and not (self.scan_chunks
                                            or self.mesh is not None):
            return self._rerank_two_phase(state, query_ids, k,
                                          shortlist, overlap_feat)
        key = (k, shortlist)
        if self._rerank_jit is None or self._rerank_jit[0] != key:
            self._rerank_jit = (key, self._build_rerank_fn(k, shortlist))
        if self._cand_tok_dev is None:
            self._cand_tok_dev = jnp.asarray(self.cand_token_ids)
        pool_a, pool_b = (self.chunks if self.chunks is not None
                          else (self.pool, self.aux))
        of = None if overlap_feat is None else jnp.asarray(overlap_feat)
        return self._rerank_jit[1](state, jnp.asarray(query_ids),
                                   pool_a, pool_b, self._cand_tok_dev, of)

    def _rerank_two_phase(self, state, query_ids, k, shortlist,
                          overlap_feat):
        """Host-loop fallback (scan_chunks=False, unmeshed): the chunk
        loop already pays a dispatch per chunk, so the host id gather
        costs nothing extra here."""
        _, idx = self.query(query_ids, k=shortlist)
        idx = np.asarray(idx)                       # (Nq, S) host gather
        nq, s = idx.shape
        q_host = np.asarray(query_ids)
        cand = self.cand_token_ids[idx.reshape(-1)]  # (Nq*S, W2)
        q_rep = np.repeat(q_host, s, axis=0)         # (Nq*S, W1)
        of = (None if overlap_feat is None
              else np.repeat(np.asarray(overlap_feat), s, axis=0))
        probs = self.score_pairs(state, q_rep, cand,
                                 overlap_feat=of).reshape(nq, s)
        vals, order = jax.lax.top_k(probs, k)
        re_idx = jnp.take_along_axis(jnp.asarray(idx), order, axis=1)
        return vals, re_idx

    def score_pairs(self, state, query_ids, candidate_ids, overlap_feat=None):
        """Full interaction-model scores for explicit (query, candidate)
        pairs -- the exact `caffe test` scoring path, used to rerank the
        retrieval shortlist.  Returns P(correct) per pair."""
        n = query_ids.shape[0]
        if overlap_feat is None:
            overlap_feat = jnp.zeros((n, self.cfg.overlap_features),
                                     jnp.float32)
        batch = {"question": jnp.asarray(query_ids),
                 "answer": jnp.asarray(candidate_ids),
                 "overlap_feat": overlap_feat}
        out, _ = mms_qa_apply(self.params, state, batch, self.cfg,
                              train=False)
        return out["prob"][:, 1]
