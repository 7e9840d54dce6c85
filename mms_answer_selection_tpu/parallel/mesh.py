"""Device-mesh construction and sharding rules.

The reference's entire distributed backend is single-node tree
data-parallelism over CUDA P2P (src/caffe/parallel.cpp:201-437: GPUParams
flat buffers, DevicePair board-aware pairing, BlockingQueue handshakes,
broadcast-down / reduce-up).  The JAX-native replacement is declarative:

* a ``jax.sharding.Mesh`` over the devices (interconnect handled by XLA),
* a PartitionSpec per array, and
* jit, which inserts the bandwidth-optimal all-reduce for gradients --
  no hand-rolled tree, no queues, no device pairing.

Axes used by this framework:
  dp -- data parallel (batch dim; grads psum across it)
  tp -- tensor/model parallel: shards the embedding table rows and, in the
        query engine, the candidate pool (the long axis at serve time --
        SURVEY.md §5.7's "real long-axis problem")

The per-device RNG offsets of the reference (parallel.cpp:276-282) map to
jax.random.fold_in(key, axis_index) inside shard_map'ped code; for the
jit-based path the key is replicated and per-step folded, which is
bit-identical across layouts.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(dp: int | None = None, tp: int = 1, *, devices=None) -> Mesh:
    """Build a (dp, tp) mesh.  dp defaults to n_devices // tp."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if dp is None:
        if n % tp:
            raise ValueError(f"{n} devices not divisible by tp={tp}")
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp * tp} != device count {n}")
    arr = np.asarray(devices).reshape(dp, tp)
    return Mesh(arr, ("dp", "tp"))


def params_pspec(params, mesh: Mesh | None = None, *, tp_axis: str = "tp"):
    """PartitionSpec tree for the MMS model family.

    Sharding choices (everything else is small and replicated):
    * embedding table (V, D): rows sharded over tp -- the one large tensor;
      the gather becomes a sharded take + all-reduce handled by XLA
    * sim bilinear W (M, D, D): sharded over measures when divisible
    * conv / BN / fc: replicated (KBs each; replication is free bandwidth)

    A dim that does not divide the tp axis stays replicated (mirrors how the
    reference simply has no answer for uneven splits).
    """
    tp = mesh.shape[tp_axis] if mesh is not None else 1

    def rule(path, leaf):
        keys = [getattr(p, "key", getattr(p, "name", None)) for p in path]
        if "embed" in keys and keys[-1] == "w" and leaf.shape[0] % max(tp, 1) == 0:
            return P(tp_axis)
        if ("sim" in keys and keys[-1] == "w" and leaf.ndim == 3
                and leaf.shape[0] % max(tp, 1) == 0):
            return P(tp_axis)
        return P()

    return jax.tree_util.tree_map_with_path(rule, params)


def shard_pytree(tree, mesh: Mesh, pspec_tree):
    """device_put every leaf with its NamedSharding."""
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        tree, pspec_tree,
        is_leaf=lambda x: not isinstance(x, (dict, list, tuple)))
