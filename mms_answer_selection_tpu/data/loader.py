"""Batch iteration: the BasePrefetchingDataLayer/DataReader replacement.

The reference hides IO latency with a background thread + BlockingQueue per
data layer (base_data_layer.cpp:39-124) and shards rows round-robin across
solver threads (data_reader.cpp:79-98).  In JAX the equivalents are:

* host arrays are sliced per step and shipped with a *double-buffered*
  ``jax.device_put`` (the next batch transfers while the current step runs
  -- dispatch is async, so one-batch lookahead is the whole prefetch story);
* per-host sharding for multi-host data parallelism = deterministic
  striding by process index (``shard`` argument), the DataReader
  round-robin done with arithmetic instead of queues;
* deterministic per-epoch reshuffle (HDF5DataLayer shuffle,
  hdf5_data_layer.cpp:55-68) from a seeded key chain.

A native C++ packed-record reader for out-of-core candidate pools lives in
``native/``; this module is the in-memory path.
"""

from __future__ import annotations

import numpy as np
import jax


class ArrayDataset:
    """A dict of equal-length numpy arrays with slicing."""

    def __init__(self, arrays: dict):
        lens = {k: len(v) for k, v in arrays.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"ragged dataset: {lens}")
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        self.size = next(iter(lens.values()))

    def __len__(self):
        return self.size

    def select(self, idx):
        return {k: v[idx] for k, v in self.arrays.items()}


class BatchIterator:
    """Infinite deterministic batch stream with epoch-wise reshuffle.

    shard=(index, count) stripes rows across hosts like the reference's
    DataReader assigns rows to solvers (data_reader.cpp:79-98).
    """

    def __init__(self, dataset: ArrayDataset, batch_size: int, *, seed: int = 0,
                 shuffle: bool = True, shard: tuple[int, int] = (0, 1),
                 drop_keys: tuple = (), device_put: bool = False):
        self.ds = dataset
        self.bs = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.shard_index, self.shard_count = shard
        self.drop_keys = set(drop_keys)
        self.device_put = device_put
        self.epoch = 0
        self._cursor = 0
        self._perm = self._make_perm()
        if len(self._perm) == 0:
            # an empty stripe would spin __next__ forever (reshuffling
            # never makes it non-empty)
            raise ValueError(
                f"shard {self.shard_index}/{self.shard_count} of a "
                f"{self.ds.size}-row dataset is empty")

    def _make_perm(self):
        idx = np.arange(self.ds.size)
        if self.shuffle:
            # same threefry chain, forced onto the CPU backend: shuffling
            # host indices must not pay an accelerator dispatch (and the
            # first permutation of each dataset size a device compile)
            with jax.default_device(jax.local_devices(backend="cpu")[0]):
                key = jax.random.fold_in(jax.random.PRNGKey(self.seed),
                                         self.epoch)
                idx = np.asarray(jax.random.permutation(key, self.ds.size))
        return idx[self.shard_index:: self.shard_count]

    def __iter__(self):
        return self

    def __next__(self):
        take = []
        need = self.bs
        while need > 0:
            chunk = self._perm[self._cursor: self._cursor + need]
            take.append(chunk)
            self._cursor += len(chunk)
            need -= len(chunk)
            if self._cursor >= len(self._perm):
                self.epoch += 1
                self._perm = self._make_perm()
                self._cursor = 0
        idx = np.concatenate(take) if len(take) > 1 else take[0]
        batch = {k: v for k, v in self.ds.select(idx).items()
                 if k not in self.drop_keys}
        if self.device_put:
            batch = jax.device_put(batch)
        return batch
