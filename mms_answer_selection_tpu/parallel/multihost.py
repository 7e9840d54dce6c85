"""Multi-host (DCN) data parallelism wiring.

The reference has no multi-node story at all (SURVEY.md §2.3: single-node
CUDA-P2P only).  This module adds the JAX-native one: every host runs the
same program, ``jax.distributed.initialize`` wires the DCN control plane,
the global mesh spans all devices, and each host feeds only its local shard
of every batch (``host_shard`` = the DataReader round-robin of
data_reader.cpp:79-98 done across processes).

Can only be exercised for real on a multi-host slice; the shard arithmetic
and global-batch assembly helpers are unit-tested on the virtual mesh.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None):
    """jax.distributed.initialize passthrough (no-op when single-process).
    Without a cluster environment that JAX recognizes, pass all three
    arguments, e.g. ``coordinator_address="localhost:<port>"``.

    MUST run before any backend-initializing jax call: checking
    ``jax.process_count()`` here would itself initialize the local backend
    and make the subsequent ``jax.distributed.initialize`` raise, silently
    leaving the job single-host.  So the already-initialized probe uses the
    bridge's state flag instead, and explicit-wiring failures propagate
    (a cluster that NEEDS wiring must not limp on single-host)."""
    import jax._src.xla_bridge as xla_bridge
    if xla_bridge.backends_are_initialized():
        if jax.process_count() > 1:
            return  # distributed runtime already wired
        if coordinator_address is not None or num_processes is not None:
            raise RuntimeError(
                "multihost.initialize(coordinator_address=...) must be "
                "called before the first jax backend use "
                "(jax.devices()/jnp ops initialize the backend)")
        return  # single-process, nothing requested: no-op
    if coordinator_address is None and num_processes is None:
        try:
            jax.distributed.initialize()
        except Exception:  # single-process / no cluster env: fine
            return
    else:
        # explicit wiring was requested: failures must surface
        jax.distributed.initialize(coordinator_address, num_processes,
                                   process_id)


def host_shard() -> tuple[int, int]:
    """(process_index, process_count) -- feed BatchIterator(shard=...) or
    NativePrefetcher(shard=...) with this to stripe rows across hosts."""
    return jax.process_index(), jax.process_count()


def global_mesh(tp: int = 1) -> Mesh:
    """dp x tp mesh over ALL processes' devices (dp spans hosts; tp must
    stay within a host's device interconnect for bandwidth, so tp <= local
    devices)."""
    devices = np.asarray(jax.devices())
    n = devices.size
    if n % tp:
        raise ValueError(f"{n} global devices not divisible by tp={tp}")
    return Mesh(devices.reshape(n // tp, tp), ("dp", "tp"))


def global_batch_from_local(mesh: Mesh, local_batch: dict):
    """Assemble a logically-global batch from this host's local rows.

    Each host holds (global_batch / process_count) rows; this builds global
    jax.Arrays whose addressable shards are the local data -- the
    multi-host replacement for plain device_put.  Row order follows process
    index, so pair it with host_shard() striding for determinism."""
    n_proc = jax.process_count()

    def make(x):
        x = np.asarray(x)
        global_shape = (x.shape[0] * n_proc,) + x.shape[1:]
        sharding = NamedSharding(mesh, P("dp"))
        return jax.make_array_from_process_local_data(sharding, x,
                                                      global_shape)

    return {k: make(v) for k, v in local_batch.items()}
