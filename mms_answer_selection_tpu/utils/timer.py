"""Profiling / timing harness.

The reference's only profiler is `caffe time`: per-layer forward/backward
wall-clock over N iterations using CUDA-event timers
(tools/caffe.cpp:301-387, include/caffe/util/benchmark.hpp).  The JAX
equivalents here:

* ``benchmark(fn, *args)`` -- wall-clock a jitted function with
  block_until_ready fencing (the device-event analogue), reporting
  mean/median/p50/p95 over iterations after warmup.
* ``stage_times(...)`` -- per-stage timing of the MMS forward pass by
  jitting each stage separately (embed / sim / each conv block / head), the
  `caffe time` per-layer table.  NOTE: stage sums exceed the fused
  end-to-end time -- XLA fuses across stages in the real model; this is for
  relative hot-spot attribution only, and the docstring says so because the
  reference's per-layer numbers have the same caveat in reverse.
* ``trace(path)`` -- context manager around jax.profiler for xprof traces.
"""

from __future__ import annotations

import contextlib
import time

import jax
import numpy as np


def _fence(out):
    """Completion fence: a HOST READ of the output, which waits for every
    computation that produced it.  Small leaves are fetched whole; large
    ones get a 1-element jitted slice fetched instead, so the fence never
    copies a large array to the host."""
    leaves = jax.tree.leaves(out)
    small = [x for x in leaves
             if getattr(x, "size", None) is not None and x.size <= 256]
    if small:
        np.asarray(small[0])
    elif leaves:
        jax.block_until_ready(leaves)
        import jax.numpy as jnp
        np.asarray(jnp.ravel(leaves[0])[:1])


def benchmark(fn, *args, iters: int = 20, warmup: int = 3) -> dict:
    """Time fn(*args) with device-completion fencing (host-read; see
    _fence).  Prefer fns returning a small/scalar output so the fence is
    the plain result fetch."""
    _fence(fn(*args))
    for _ in range(warmup):
        _fence(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _fence(fn(*args))
        times.append(time.perf_counter() - t0)
    arr = np.asarray(times)
    return {
        "mean_s": float(arr.mean()),
        "p50_s": float(np.percentile(arr, 50)),
        "p95_s": float(np.percentile(arr, 95)),
        "min_s": float(arr.min()),
        "iters": iters,
    }


@contextlib.contextmanager
def trace(path: str):
    """xprof trace of the enclosed block (view with tensorboard/xprof)."""
    jax.profiler.start_trace(path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def stage_times_fwd_bwd(params, state, batch, cfg, *,
                        iters: int = 10) -> dict:
    """Per-stage forward AND backward timing -- the full `caffe time`
    report (tools/caffe.cpp:301-387 prints per-layer forward ms and
    backward ms over the train net).

    Each stage's backward is measured as (time of jit(grad-of-stage) -
    time of jit(stage)): under XLA the VJP re-runs the forward inside the
    same executable (no cached activations across dispatches), so the
    subtraction isolates the backward work.  Returns
    {stage: {"forward_ms", "backward_ms"}} p50s.
    """
    import jax.numpy as jnp

    from ..models.mms_qa import sim_map
    from ..ops import avg_pool2d, bn_apply, conv2d, embed_lookup, max_pool2d

    results = {}

    def tim(name, fwd_fn, bwd_fn, *args):
        f = benchmark(jax.jit(fwd_fn), *args, iters=iters)
        fb = benchmark(jax.jit(bwd_fn), *args, iters=iters)
        results[name] = {
            "forward_ms": f["p50_s"] * 1e3,
            "backward_ms": max(0.0, (fb["p50_s"] - f["p50_s"]) * 1e3),
        }

    def e_fwd(ep, ids):
        return embed_lookup(ep, ids)

    def e_bwd(ep, ids):
        return jax.grad(lambda e: jnp.sum(embed_lookup(e, ids)))(ep)

    tim("embed", e_fwd, e_bwd, params["embed"], batch["question"])
    q_emb = embed_lookup(params["embed"], batch["question"])
    a_emb = embed_lookup(params["embed"], batch["answer"])

    def s_fwd(sp, q, a):
        return sim_map({**params, "sim": sp}, q, a, cfg)

    def s_bwd(sp, q, a):
        return jax.grad(
            lambda args: jnp.sum(s_fwd(*args)))((sp, q, a))

    tim("sim_cross", s_fwd, s_bwd, params["sim"], q_emb, a_emb)
    x = sim_map(params, q_emb, a_emb, cfg)

    for i, b in enumerate(cfg.blocks):
        def block(cp, bp, x_, i=i, b=b):
            y = conv2d(cp, x_)
            y, _ = bn_apply(bp, state[f"bn{i}"], y, train=True)
            pool = max_pool2d if b.pool == "max" else avg_pool2d
            y = pool(y, b.pool_k, b.pool_k, stride_h=b.pool_stride,
                     stride_w=b.pool_stride)
            return jnp.tanh(y)

        def block_bwd(cp, bp, x_, i=i, b=b):
            return jax.grad(
                lambda args: jnp.sum(block(*args)))((cp, bp, x_))

        tim(f"conv_block{i}", block, block_bwd,
            params[f"conv{i}"], params[f"bn{i}"], x)
        x = block(params[f"conv{i}"], params[f"bn{i}"], x)

    def head(f1, f2, x_, feat):
        flat = x_.reshape(x_.shape[0], -1)
        f = jnp.concatenate([flat, feat.astype(flat.dtype)], axis=1)
        h = jnp.tanh(f @ f1["w"] + f1["b"])
        return h @ f2["w"] + f2["b"]

    def head_bwd(f1, f2, x_, feat):
        return jax.grad(
            lambda args: jnp.sum(head(*args, feat)))((f1, f2, x_))

    tim("head", head, head_bwd, params["fc1"], params["fc2"], x,
        batch["overlap_feat"])
    return results


def stage_times(params, state, batch, cfg, *, iters: int = 10) -> dict:
    """Per-stage forward timing of the MMS model (hot-spot attribution)."""
    import jax.numpy as jnp

    from ..models.mms_qa import sim_map
    from ..ops import avg_pool2d, bn_apply, conv2d, embed_lookup, max_pool2d

    results = {}

    embed = jax.jit(lambda ids: embed_lookup(params["embed"], ids))
    results["embed"] = benchmark(embed, batch["question"], iters=iters)
    q_emb = embed(batch["question"])
    a_emb = embed(batch["answer"])

    sim = jax.jit(lambda q, a: sim_map(params, q, a, cfg))
    results["sim_cross"] = benchmark(sim, q_emb, a_emb, iters=iters)
    x = sim(q_emb, a_emb)

    for i, b in enumerate(cfg.blocks):
        def block(x_, i=i, b=b):
            y = conv2d(params[f"conv{i}"], x_)
            y, _ = bn_apply(params[f"bn{i}"], state[f"bn{i}"], y, train=False)
            pool = max_pool2d if b.pool == "max" else avg_pool2d
            y = pool(y, b.pool_k, b.pool_k, stride_h=b.pool_stride,
                     stride_w=b.pool_stride)
            return jnp.tanh(y)

        jb = jax.jit(block)
        results[f"conv_block{i}"] = benchmark(jb, x, iters=iters)
        x = jb(x)

    def head(x_, feat):
        flat = x_.reshape(x_.shape[0], -1)
        f = jnp.concatenate([flat, feat.astype(flat.dtype)], axis=1)
        h = jnp.tanh(f @ params["fc1"]["w"] + params["fc1"]["b"])
        return h @ params["fc2"]["w"] + params["fc2"]["b"]

    results["head"] = benchmark(jax.jit(head), x, batch["overlap_feat"],
                                iters=iters)
    return results
