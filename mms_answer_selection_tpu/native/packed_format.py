"""Python side of the native packed-record store (see packed_store.cc).

``write_mmsp`` writes the columnar MMSP file; ``PackedStore`` /
``NativePrefetcher`` wrap the C++ mmap + threaded gather + background
prefetch ring through ctypes.  The shared library is built on demand with
g++ (no pip); if no toolchain is available every entry point raises a clear
error and callers fall back to the in-memory ``data.loader`` path.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import threading

import numpy as np

_DTYPES = {np.dtype(np.int32): 0, np.dtype(np.float32): 1,
           np.dtype(np.int64): 2, np.dtype(np.float64): 3}
_DTYPES_REV = {v: k for k, v in _DTYPES.items()}
_MAGIC = 0x50534D4D  # 'MMSP'
_ALIGN = 64

_lib = None
_lib_lock = threading.Lock()


def _so_path() -> str:
    return os.path.join(os.path.dirname(__file__), "libpacked_store.so")


def _build_library() -> str:
    so = _so_path()
    src = os.path.join(os.path.dirname(__file__), "packed_store.cc")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           src, "-o", so]
    subprocess.run(cmd, check=True, capture_output=True)
    return so


def _get_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build_library())
        lib.mmsp_open.restype = ctypes.c_void_p
        lib.mmsp_open.argtypes = [ctypes.c_char_p]
        lib.mmsp_close.argtypes = [ctypes.c_void_p]
        lib.mmsp_rows.restype = ctypes.c_uint64
        lib.mmsp_rows.argtypes = [ctypes.c_void_p]
        lib.mmsp_num_fields.restype = ctypes.c_uint32
        lib.mmsp_num_fields.argtypes = [ctypes.c_void_p]
        lib.mmsp_field_info.restype = ctypes.c_int
        lib.mmsp_field_info.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint64)]
        lib.mmsp_gather.restype = ctypes.c_int
        lib.mmsp_gather.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
            ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int]
        lib.mmsp_shuffle.argtypes = [ctypes.c_uint64, ctypes.c_uint64,
                                     ctypes.c_void_p]
        lib.mmsp_prefetcher_create.restype = ctypes.c_void_p
        lib.mmsp_prefetcher_create.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64]
        lib.mmsp_prefetcher_next.restype = ctypes.c_int64
        lib.mmsp_prefetcher_next.argtypes = [ctypes.c_void_p,
                                             ctypes.c_void_p]
        lib.mmsp_prefetcher_acquire.restype = ctypes.c_int64
        lib.mmsp_prefetcher_acquire.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.mmsp_prefetcher_release.argtypes = [ctypes.c_void_p]
        lib.mmsp_prefetcher_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def write_mmsp(path: str, arrays: dict[str, np.ndarray]):
    """Write a dict of equal-length arrays as one MMSP file."""
    items = []
    n_rows = None
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        if arr.dtype not in _DTYPES:
            if np.issubdtype(arr.dtype, np.integer):
                arr = arr.astype(np.int32)
            else:
                arr = arr.astype(np.float32)
        if arr.ndim == 1:
            arr = arr[:, None]
        if arr.ndim != 2:
            arr = arr.reshape(arr.shape[0], -1)
        if n_rows is None:
            n_rows = arr.shape[0]
        elif arr.shape[0] != n_rows:
            raise ValueError("ragged fields")
        items.append((name, arr))

    # C struct Field is 56 bytes (32 name + 4 dtype + 4 pad + 8 cols + 8 off)
    header_size = 20 + len(items) * 56
    offset = (header_size + _ALIGN - 1) // _ALIGN * _ALIGN
    metas = []
    seen_names = set()
    for name, arr in items:
        nb31 = name.encode()[:31]
        if len(name.encode()) > 31 or nb31 in seen_names:
            # the C header stores 31 name bytes + NUL: silent truncation
            # can collapse two fields into one reader key
            raise ValueError(f"field name {name!r} exceeds the 31-byte "
                             f"header limit (or collides after "
                             f"truncation)")
        seen_names.add(nb31)
        metas.append((name, _DTYPES[arr.dtype], arr.shape[1], offset))
        offset += arr.nbytes
        offset = (offset + _ALIGN - 1) // _ALIGN * _ALIGN

    with open(path, "wb") as f:
        f.write(struct.pack("<IIIQ", _MAGIC, 1, len(items), n_rows))
        for name, dtype, cols, off in metas:
            nb = name.encode()[:31]
            f.write(nb + b"\0" * (32 - len(nb)))
            # match the C struct layout: u32 dtype, 4 pad, u64 cols, u64 off
            f.write(struct.pack("<IIQQ", dtype, 0, cols, off))
        for (name, arr), (_, _, _, off) in zip(items, metas):
            f.seek(off)
            f.write(arr.tobytes())


class PackedStore:
    """mmap'd random-access reader with native multithreaded gather."""

    def __init__(self, path: str):
        self.lib = _get_lib()
        self.handle = self.lib.mmsp_open(path.encode())
        if not self.handle:
            raise IOError(f"cannot open MMSP file {path}")
        self.n_rows = self.lib.mmsp_rows(self.handle)
        self.fields = {}
        for i in range(self.lib.mmsp_num_fields(self.handle)):
            name = ctypes.create_string_buffer(32)
            dtype = ctypes.c_uint32()
            cols = ctypes.c_uint64()
            self.lib.mmsp_field_info(self.handle, i, name,
                                     ctypes.byref(dtype), ctypes.byref(cols))
            self.fields[name.value.decode()] = (i, _DTYPES_REV[dtype.value],
                                                int(cols.value))

    def gather(self, field: str, idx, *, threads: int = 4) -> np.ndarray:
        fid, dtype, cols = self.fields[field]
        idx = np.ascontiguousarray(idx, np.int64)
        out = np.empty((len(idx), cols), dtype)
        rc = self.lib.mmsp_gather(
            self.handle, fid, idx.ctypes.data_as(ctypes.c_void_p), len(idx),
            out.ctypes.data_as(ctypes.c_void_p), threads)
        if rc != 0:
            raise IndexError(f"gather failed rc={rc}")
        return out

    def close(self):
        if self.handle:
            self.lib.mmsp_close(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


def native_shuffle(n: int, seed: int) -> np.ndarray:
    if n <= 0:
        # the C Fisher-Yates computes splitmix64 % (i+1) with i
        # wrapping to (uint64)-1 for n == 0: SIGFPE from the worker
        raise ValueError(f"native_shuffle needs n > 0, got {n}")
    lib = _get_lib()
    out = np.empty(n, np.int64)
    lib.mmsp_shuffle(n, seed, out.ctypes.data_as(ctypes.c_void_p))
    return out


class NativePrefetcher:
    """Background-thread batch stream over a PackedStore: the reference's
    prefetch thread + free/full BlockingQueue pair, as a native ring."""

    def __init__(self, store: PackedStore, fields, batch_size: int, *,
                 seed: int = 0, shuffle: bool = True, depth: int = 3,
                 gather_threads: int = 4, shard: tuple[int, int] = (0, 1)):
        self.store = store
        self.lib = store.lib
        self.field_names = list(fields)
        fids = np.asarray([store.fields[f][0] for f in self.field_names],
                          np.uint32)
        self.shapes = [(batch_size, store.fields[f][2], store.fields[f][1])
                       for f in self.field_names]
        per_shard = len(range(shard[0], store.n_rows, shard[1]))
        if store.n_rows <= 0 or per_shard <= 0:
            # an empty store (or empty host stripe) would SIGFPE in the
            # native reshuffle / read an empty perm out of bounds
            raise ValueError(
                f"shard {shard[0]}/{shard[1]} of a {store.n_rows}-row "
                f"store is empty")
        self.handle = self.lib.mmsp_prefetcher_create(
            store.handle, fids.ctypes.data_as(ctypes.c_void_p), len(fids),
            batch_size, seed, int(shuffle), depth, gather_threads,
            shard[0], shard[1])

    def next(self) -> dict[str, np.ndarray]:
        outs = [np.empty((bs, cols), dtype)
                for (bs, cols, dtype) in self.shapes]
        ptrs = (ctypes.c_void_p * len(outs))(
            *[o.ctypes.data_as(ctypes.c_void_p).value for o in outs])
        step = self.lib.mmsp_prefetcher_next(self.handle, ptrs)
        if step < 0:
            raise StopIteration
        return {name: arr for name, arr in zip(self.field_names, outs)}

    def acquire_view(self):
        """Zero-copy batch: (step, dict of numpy VIEWS into the ring slot).
        The views alias native memory owned by the prefetcher; the caller
        must be done with them (or have copied/transferred) before calling
        :meth:`release`, which recycles the slot.  Skips the memcpy that
        :meth:`next` does into fresh numpy buffers."""
        n = len(self.field_names)
        ptrs = (ctypes.c_void_p * n)()
        sizes = (ctypes.c_uint64 * n)()
        step = self.lib.mmsp_prefetcher_acquire(self.handle, ptrs, sizes)
        if step == -2:
            raise RuntimeError("acquire called twice without release")
        if step < 0:
            raise StopIteration
        out = {}
        for name, (bs, cols, dtype), ptr in zip(self.field_names,
                                                self.shapes, ptrs):
            buf = (ctypes.c_char * (bs * cols * dtype.itemsize)) \
                .from_address(ptr)
            out[name] = np.frombuffer(buf, dtype).reshape(bs, cols)
        return step, out

    def release(self):
        self.lib.mmsp_prefetcher_release(self.handle)

    def next_device(self, device=None):
        """Direct ring-slot -> device batch: acquire the slot zero-copy,
        jax.device_put straight from native memory (the ONLY host-side
        touch of the data after the gather), block until the transfer
        lands, release the slot.  Replaces next() + jnp.asarray, which
        costs one extra full host copy per field (TODO round-1 #7).

        On accelerator backends device_put DMAs out of the slot and the
        blocked transfer makes release safe: block_until_ready on a
        TRANSFER waits for the device buffer.  On the CPU backend XLA may
        ALIAS an aligned host buffer instead of copying -- the returned array
        would then mutate when the worker refills the slot -- so there
        the fields are copied out first (same cost as next())."""
        import jax
        step, views = self.acquire_view()
        try:
            devs = getattr(device, "device_set", None)  # Sharding
            plat = (next(iter(devs)).platform if devs
                    else getattr(device, "platform", None)
                    or jax.devices()[0].platform)
            if plat == "cpu":
                views = {k: np.array(v) for k, v in views.items()}
            batch = jax.device_put(views, device)
            batch = jax.block_until_ready(batch)
        finally:
            self.release()
        return batch

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def close(self):
        if self.handle:
            self.lib.mmsp_prefetcher_destroy(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
