"""Fused Pallas kernels (Triton route) for learned-metric MaxSim retrieval.

The reference's mode-2 SimCross issues 2 GEMMs per (sample, measure) from a
host loop, and its GPU build runs the layer on the CPU entirely
(sim_cross_layer.cu:187-189, 240-242).  The retrieval path here scores every
query against every candidate under the learned metric with MaxSim
aggregation

    score(q, c) = sum_m sum_i max_j q_i^T W_m c_j

computed flash-style: the (Nq*M*W1) x (C*W2) similarity map never reaches
device memory.  Written plainly it is 6,400 f32 values per (query,
candidate) pair at the recipe shapes -- about 51 KB written and read back
for 0.8 MFLOP, far below the tensor cores' ridge point -- so a fused kernel
that reads only the packed pool is the whole game.

Kernel design (``_maxsim_kernel``):

* The grid runs over (query, candidate tile).  Every output block is
  independent, so blocks run in any order on any SM; nothing is reduced
  across blocks.
* The pool is stored candidate-major (C, W2, Dp).  A block loops over the
  W2 token positions; at each one it loads the (block_c, Dp) token slice
  of its candidates, multiplies it with the block's projected query rows on
  the tensor cores, and folds the product into a running elementwise max.
  After the loop, the per-row maxima are summed per query.
* Block shapes follow Triton's rules: every loaded tile is a power of two,
  so the query rows (M*W1) and the contraction width Dp are split into
  power-of-two parts (160 rows -> 128 + 32), and ``pl.dot``'s right
  operand is at least 16 wide in every dimension.
* Dp is D padded to the tensor cores' K step (16 for bf16/f32, 32 for
  int8); the bf16/f32 pools keep one extra lane for an additive mask.
* Copies overlap compute through the pipeline depth (``NUM_STAGES``).

On the CPU the same kernels run under the Pallas interpreter (the test
path); padding and tiling are computed identically in both modes.

Two precisions:

* bf16 (or f32) pools: lane Dp-1 of every candidate token holds an additive
  mask (0 real / -1e30 masked) and the projected queries hold 1.0 there, so
  padding and tombstones ride the contraction.
* int8 pools ("int8 v2"): one symmetric scale per CANDIDATE, applied after
  the max (a positive scalar commutes with it); per-query-row scales,
  applied after the max too; padded token rows replicate the candidate's
  first token (a duplicate never changes a max); pool padding and
  tombstones live in a small (C, 2) f32 aux (scale, additive mask).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

NEG_INF = -1e30

# Candidates per grid block.  QueryEngine pads every pool to a multiple of
# BLOCK_C; direct callers with other pool sizes get the largest
# power-of-two tile that divides the pool (at least MIN_BLOCK_C).  Each
# grid block scores one query.  BLOCK_C, NUM_WARPS and NUM_STAGES were
# the fastest of a sweep on an H100 (candidate tiles 32/64/128, 1-2
# queries per block, 4/8 warps, 2/3 stages) at 256 queries x 262,144
# candidates, for both the bf16 and the int8 kernel.
BLOCK_C = 64
MIN_BLOCK_C = 16   # pl.dot needs every dimension of its right operand >= 16
NUM_WARPS = 4
NUM_STAGES = 3
ROW_ALIGN = 16     # query rows pad to this (smallest tensor-core M tile)
AUX_LANES = 2      # int8 aux: lane 0 = per-candidate scale, 1 = additive mask


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _k_step(dtype) -> int:
    """Tensor-core contraction step: 32 for int8 operands, else 16."""
    return 32 if jnp.dtype(dtype) == jnp.int8 else 16


def padded_dim(d: int, dtype) -> int:
    """Padded embedding width of packed pools and projected queries: D plus
    the mask lane for float pools, rounded up to the K step of ``dtype``."""
    extra = 0 if jnp.dtype(dtype) == jnp.int8 else 1
    return _round_up(d + extra, _k_step(dtype))


def _pow2_parts(n: int) -> tuple[tuple[int, int], ...]:
    """(offset, size) power-of-two pieces of [0, n), largest first:
    160 -> ((0, 128), (128, 32))."""
    parts, off = [], 0
    for bit in reversed(range(n.bit_length())):
        size = 1 << bit
        if n & size:
            parts.append((off, size))
            off += size
    return tuple(parts)


def resolve_interpret(interpret: bool | None) -> bool:
    """``interpret=None`` resolves from the backend: compiled kernels on
    the GPU, the Pallas interpreter on the CPU.  Any other backend has no
    kernel here and raises."""
    if interpret is not None:
        return bool(interpret)
    backend = jax.default_backend()
    if backend == "gpu":
        return False
    if backend == "cpu":
        return True
    raise ValueError(
        f"no MaxSim kernel for backend {backend!r}; the kernels compile for "
        f"the GPU (Pallas/Triton) and run interpreted on the CPU")


def _fit_block_c(c: int, block_c: int) -> int:
    """Largest power-of-two candidate tile <= block_c that divides c."""
    b = block_c
    while b >= MIN_BLOCK_C and c % b:
        b //= 2
    if b < MIN_BLOCK_C:
        raise ValueError(
            f"pool size {c} is not a multiple of {MIN_BLOCK_C}; pad the "
            f"pool to a multiple of BLOCK_C ({BLOCK_C}) the way QueryEngine "
            f"does")
    return b


def _maxsim_kernel(qw_ref, qs_ref, pool_ref, aux_ref, o_ref, *, n_tok,
                   row_parts, k_parts, rows_real, quant, precision):
    """One (query, candidate tile) block.

    qw_ref:   (Rp, Dp)          one query's projected rows, Rp padded
    qs_ref:   (Rp,)             int8 per-row scales (None for float)
    pool_ref: (block_c, W2, Dp) candidate tokens
    aux_ref:  (block_c, 2)      int8 per-candidate scale and mask (None
                                for float)
    o_ref:    (1, block_c)      scores
    """
    block_c = pool_ref.shape[0]
    acc_dtype = jnp.int32 if quant else jnp.float32
    lowest = jnp.iinfo(jnp.int32).min if quant else -jnp.inf
    q = [[qw_ref[pl.ds(r0, rn), pl.ds(k0, kn)] for k0, kn in k_parts]
         for r0, rn in row_parts]

    def body(t, accs):
        p = [pool_ref[:, t, pl.ds(k0, kn)] for k0, kn in k_parts]
        out = []
        for acc, q_row in zip(accs, q):
            s = None
            for qk, pk in zip(q_row, p):
                d = pl.dot(qk, pk, trans_b=True, precision=precision)
                s = d if s is None else s + d
            out.append(jnp.maximum(acc, s))
        return tuple(out)

    init = tuple(jnp.full((rn, block_c), lowest, acc_dtype)
                 for _, rn in row_parts)
    accs = jax.lax.fori_loop(0, n_tok, body, init)

    total = jnp.zeros((block_c,), jnp.float32)
    for (r0, rn), acc in zip(row_parts, accs):
        a = acc.astype(jnp.float32)
        if quant:
            a = a * qs_ref[pl.ds(r0, rn)][:, None]
        if r0 + rn > rows_real:        # drop the padded query rows
            row = r0 + jax.lax.broadcasted_iota(jnp.int32, (rn, 1), 0)
            a = jnp.where(row < rows_real, a, 0.0)
        total = total + jnp.sum(a, axis=0)
    if quant:
        total = total * aux_ref[:, 0] + aux_ref[:, 1]
    o_ref[0, :] = total


def _maxsim_call(qw, qs, pool, aux, *, interpret):
    """Shared wrapper: pads query rows, tiles the pool, launches."""
    interpret = resolve_interpret(interpret)
    quant = qs is not None
    nq, rows, dp = qw.shape
    c, n_tok, dp2 = pool.shape
    if dp != dp2:
        raise ValueError(f"query width {dp} != pool width {dp2}")
    if dp % _k_step(pool.dtype):
        raise ValueError(f"padded width {dp} is not a multiple of the K "
                         f"step {_k_step(pool.dtype)}; pack with this "
                         f"module's packers")
    block_c = _fit_block_c(c, BLOCK_C)
    rows_per_q = _round_up(rows, ROW_ALIGN)
    if rows_per_q != rows:
        qw = jnp.pad(qw, ((0, 0), (0, rows_per_q - rows), (0, 0)))
        if quant:
            qs = jnp.pad(qs, ((0, 0), (0, rows_per_q - rows)))
    precision = (jax.lax.Precision.HIGHEST
                 if jnp.dtype(pool.dtype) == jnp.float32 else None)
    kernel = functools.partial(
        _maxsim_kernel, n_tok=n_tok, row_parts=_pow2_parts(rows_per_q),
        k_parts=_pow2_parts(dp), rows_real=rows, quant=quant,
        precision=precision)
    in_specs = [pl.BlockSpec((rows_per_q, dp), lambda i, j: (i, 0))]
    args = [qw.reshape(nq * rows_per_q, dp)]
    if quant:
        in_specs.append(pl.BlockSpec((rows_per_q,), lambda i, j: (i,)))
        args.append(qs.reshape(-1).astype(jnp.float32))
    in_specs.append(pl.BlockSpec((block_c, n_tok, dp),
                                 lambda i, j: (j, 0, 0)))
    args.append(pool)
    if quant:
        in_specs.append(pl.BlockSpec((block_c, AUX_LANES),
                                     lambda i, j: (j, 0)))
        args.append(aux.astype(jnp.float32))
    else:
        float_kernel = kernel

        def kernel(qw_ref, pool_ref, o_ref):
            float_kernel(qw_ref, None, pool_ref, None, o_ref)
    return pl.pallas_call(
        kernel,
        grid=(nq, c // block_c),
        in_specs=in_specs,
        out_specs=pl.BlockSpec((1, block_c), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((nq, c), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="maxsim_int8" if quant else "maxsim",
    )(*args)


# ===========================================================================
# bf16 / f32 pools
# ===========================================================================

def pack_candidate_pool(tokens, *, w2p: int | None = None,
                        dtype=jnp.bfloat16):
    """(C, W2, D) candidate token embeddings -> (C, W2P, Dp) pool in
    ``dtype`` with the additive token mask (0 real / -1e30 padding) in the
    last lane (activated by project_queries' constant-1 lane).  W2P
    defaults to W2: the kernel loops over token positions, so no token
    padding is needed."""
    c, w2, d = tokens.shape
    w2p = w2 if w2p is None else w2p
    if w2 > w2p:
        raise ValueError(f"candidate length {w2} exceeds W2P={w2p}")
    dp = padded_dim(d, dtype)
    pool = jnp.zeros((c, w2p, dp), dtype)
    pool = pool.at[:, :w2, :d].set(tokens.astype(dtype))
    return pool.at[:, w2:, dp - 1].set(NEG_INF)


def mask_out_candidates(pool, start: int):
    """Mark candidates [start:] as padding (engine pool-size alignment)."""
    return pool.at[start:, :, -1].set(NEG_INF)


def mask_candidate_rows(pool, rows):
    """Mark the given candidate rows as padding (tombstone deletes)."""
    return pool.at[rows, :, -1].set(NEG_INF)


def project_queries(q_tokens, w, *, dtype=jnp.bfloat16):
    """(Nq, W1, D) x (M, D, D) -> (Nq, M*W1, Dp): each query's tokens
    pre-multiplied by every metric matrix (amortized over the whole pool);
    the last lane is 1.0 so the pool's mask lane contributes additively."""
    nq, w1, d = q_tokens.shape
    m = w.shape[0]
    dp = padded_dim(d, dtype)
    qw = jnp.einsum("nid,mde->nmie", q_tokens, w,
                    precision=jax.lax.Precision.HIGHEST)
    qw = qw.reshape(nq, m * w1, d)
    qw = jnp.pad(qw, ((0, 0), (0, 0), (0, dp - d)))
    return qw.at[:, :, dp - 1].set(1.0).astype(dtype)


def bilinear_maxsim_scores(qw, pool, *, interpret: bool | None = None):
    """Score every query against every candidate.

    qw:   (Nq, R, Dp)   from project_queries (R = M*W1)
    pool: (C, W2P, Dp)  from pack_candidate_pool; C a multiple of 16
    Returns (Nq, C) f32 scores: sum_m sum_i max_j q_i W_m c_j.
    """
    return _maxsim_call(qw, None, pool, None, interpret=interpret)


def bilinear_maxsim_scores_reference(q_tokens, cand_tokens, w):
    """Unfused f32 reference for testing: materializes the full map."""
    s = jnp.einsum("qid,mde,cje->qmicj", q_tokens, w, cand_tokens,
                   precision=jax.lax.Precision.HIGHEST)
    return jnp.sum(jnp.max(s, axis=-1), axis=(1, 2))


def bilinear_maxsim_scores_chunked(q_tokens, cand_tokens, w, *,
                                   chunk: int = 1024):
    """The f32 reference scanned over candidate chunks, so pools of any
    size fit: (Nq, C) scores.  C must be a multiple of ``chunk``."""
    c = cand_tokens.shape[0]
    chunk = min(chunk, c)
    if c % chunk:
        raise ValueError(f"pool size {c} is not a multiple of {chunk}")
    cands = cand_tokens.reshape((c // chunk, chunk) + cand_tokens.shape[1:])

    def body(_, cand):
        return None, bilinear_maxsim_scores_reference(q_tokens, cand, w)

    _, out = jax.lax.scan(body, None, cands)
    return jnp.moveaxis(out, 0, 1).reshape(q_tokens.shape[0], c)


def maxsim_scores_plain(qw, qs, pool, aux, *, tile: int = 512):
    """What XLA makes of the scoring without a kernel: on the same packed
    operands as the kernels (qs/aux None for float pools), one einsum per
    candidate tile writes the (Nq, R, tile, W2) map, then max and sum,
    under a lax.scan over tiles.  The kernels are measured against this."""
    quant = qs is not None
    c = pool.shape[0]
    tile = min(tile, c)
    if c % tile:
        raise ValueError(f"pool size {c} is not a multiple of {tile}")
    acc = jnp.int32 if quant else jnp.float32
    pools = pool.reshape((c // tile, tile) + pool.shape[1:])
    auxs = (aux.astype(jnp.float32).reshape(c // tile, tile, AUX_LANES)
            if quant else jnp.zeros((c // tile,)))

    def body(_, xs):
        p, a = xs
        s = jnp.einsum("qrd,cjd->qrcj", qw, p, preferred_element_type=acc)
        m = jnp.max(s, axis=-1).astype(jnp.float32)
        if quant:
            m = m * qs[:, :, None]
        out = jnp.sum(m, axis=1)
        if quant:
            out = out * a[:, 0] + a[:, 1]
        return None, out

    _, out = jax.lax.scan(body, None, (pools, auxs))
    return jnp.moveaxis(out, 0, 1).reshape(qw.shape[0], c)


# ===========================================================================
# int8 pools
# ===========================================================================

def _quantize_rows(x):
    """(rows, d) f32 -> (int8 rows, f32 per-row scales), symmetric."""
    absmax = jnp.max(jnp.abs(x), axis=-1, keepdims=True)
    scale = jnp.maximum(absmax, 1e-12) / 127.0
    q = jnp.clip(jnp.round(x / scale), -127, 127).astype(jnp.int8)
    return q, scale[:, 0]


def pack_candidate_pool_int8(tokens, *, w2p: int | None = None):
    """(C, W2, D) -> (pool_i8 (C, W2P, Dp) int8, aux (C, 2) f32 with
    lane 0 = per-candidate dequant scale, lane 1 = additive mask).  Token
    rows beyond W2 (only when ``w2p`` asks for them) replicate token 0."""
    c, w2, d = tokens.shape
    w2p = w2 if w2p is None else w2p
    if w2 > w2p:
        raise ValueError(f"candidate length {w2} exceeds W2P={w2p}")
    dp = padded_dim(d, jnp.int8)
    absmax = jnp.max(jnp.abs(tokens), axis=(1, 2))
    scale = jnp.maximum(absmax, 1e-12) / 127.0
    q = jnp.clip(jnp.round(tokens / scale[:, None, None]), -127,
                 127).astype(jnp.int8)
    pool = jnp.zeros((c, w2p, dp), jnp.int8)
    pool = pool.at[:, :w2, :d].set(q)
    if w2p > w2:
        pool = pool.at[:, w2:, :d].set(q[:, 0:1, :])
    aux = jnp.zeros((c, AUX_LANES), jnp.float32).at[:, 0].set(scale)
    return pool, aux


def mask_out_candidates_int8(aux, start: int):
    """Mark candidates [start:] as pool padding: scale 0 + -1e30 additive."""
    aux = aux.at[start:, 0].set(0.0)
    return aux.at[start:, 1].set(NEG_INF)


def mask_candidate_rows_int8(aux, rows):
    """Arbitrary-row variant of mask_out_candidates_int8 (tombstones)."""
    aux = aux.at[rows, 0].set(0.0)
    return aux.at[rows, 1].set(NEG_INF)


def project_queries_int8(q_tokens, w):
    """(Nq, W1, D) x (M, D, D) -> (qw_i8 (Nq, R, Dp) int8,
    q_scales (Nq, R) f32 per-row)."""
    nq, w1, d = q_tokens.shape
    m = w.shape[0]
    dp = padded_dim(d, jnp.int8)
    qw = jnp.einsum("nid,mde->nmie", q_tokens, w,
                    precision=jax.lax.Precision.HIGHEST)
    qi, scale = _quantize_rows(qw.reshape(nq * m * w1, d))
    out = jnp.pad(qi, ((0, 0), (0, dp - d)))
    return (out.reshape(nq, m * w1, dp),
            scale.reshape(nq, m * w1).astype(jnp.float32))


def bilinear_maxsim_scores_int8(qw_i8, q_scales, pool_i8, aux, *,
                                interpret: bool | None = None):
    """int8 scoring: (Nq, C) f32 approximate scores (per-candidate
    symmetric quantization, ~1-3% score error; padding is exact).  The
    int8 x int8 products accumulate in int32; the max runs on the int32
    accumulators and both scales apply after it.  Rerank the shortlist
    with score_pairs when exactness matters."""
    return _maxsim_call(qw_i8, q_scales, pool_i8, aux,
                        interpret=interpret)
