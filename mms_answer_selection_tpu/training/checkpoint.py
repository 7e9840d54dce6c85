"""Checkpoint / resume: the .caffemodel + .solverstate replacement.

The reference snapshots two artifacts -- model weights (Net::ToProto,
net.cpp:847-856) and solver state (iter + optimizer history,
SGDSolver::SnapshotSolverState*, sgd_solver.cpp:246-347) -- and restores by
file extension (Solver::Restore, solver.cpp:470-481).  Here one checkpoint
directory per step carries the full pytree bundle:

    <dir>/qa_iter_<N>/ckpt.npz       params + bn state + opt state
    <dir>/qa_iter_<N>/meta.json      step, dev metrics, config digest

``ckpt.npz`` holds one array per pytree leaf, keyed by the leaf's path
("params/embed/w", "opt_state/0/accum_grad/..."; sequence entries and
named-tuple fields by index or name) -- self-describing, no pickle, numpy
only.  ``load_checkpoint`` restores by template (the name+shape-checked
loading that CopyTrainedLayersFrom does by layer name, net.cpp:741-777,
becomes structural pytree matching).
"""

from __future__ import annotations

import json
import os
import re

import jax
import numpy as np

CKPT_FILE = "ckpt.npz"


def _key_name(entry) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    raise TypeError(f"unsupported pytree path entry {entry!r}")


def _leaf_path(path) -> str:
    names = [_key_name(e) for e in path]
    for n in names:
        if "/" in n:
            raise ValueError(f"pytree key {n!r} contains '/'")
    return "/".join(names)


def _nest(flat: dict) -> dict:
    """{"a/0/b": x} -> {"a": {"0": {"b": x}}} (sequences come back as
    dicts keyed by their string index; copy_matching accepts both)."""
    out: dict = {}
    for key, value in flat.items():
        node = out
        *parents, last = key.split("/")
        for name in parents:
            node = node.setdefault(name, {})
        node[last] = value
    return out


def save_checkpoint(directory: str, step: int, bundle, *, prefix: str = "qa",
                    meta: dict | None = None) -> str:
    """bundle: arbitrary pytree (params/state/opt_state/...).  Returns path."""
    path = os.path.join(directory, f"{prefix}_iter_{step}")
    os.makedirs(path, exist_ok=True)
    leaves, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(bundle))
    host = {_leaf_path(p): np.asarray(v) for p, v in leaves}
    # temp-then-rename: a crash mid-write must not leave a truncated
    # checkpoint that latest_checkpoint would pick for resume
    tmp = os.path.join(path, ".ckpt.tmp.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **host)
    os.replace(tmp, os.path.join(path, CKPT_FILE))
    tmp_meta = os.path.join(path, ".meta.json.tmp")
    with open(tmp_meta, "w") as f:
        json.dump({"step": step, **(meta or {})}, f)
    os.replace(tmp_meta, os.path.join(path, "meta.json"))
    return path


def load_checkpoint(path: str, template=None):
    """Returns (bundle, meta).  With ``template`` the bundle is restored into
    the template's pytree structure (shape-checked); without, raw nested
    dicts of numpy arrays are returned."""
    with np.load(os.path.join(path, CKPT_FILE), allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    if template is None:
        raw = _nest(flat)
    else:
        paths, treedef = jax.tree_util.tree_flatten_with_path(template)
        leaves = []
        for p, tpl in paths:
            key = _leaf_path(p)
            if key not in flat:
                raise KeyError(f"checkpoint {path} has no leaf {key!r}")
            arr = flat[key]
            if tuple(arr.shape) != tuple(np.shape(tpl)):
                raise ValueError(
                    f"checkpoint leaf {key!r} has shape {arr.shape}, "
                    f"template {np.shape(tpl)}")
            leaves.append(arr)
        raw = jax.tree_util.tree_unflatten(treedef, leaves)
    meta_path = os.path.join(path, "meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return raw, meta


def copy_matching(template, loaded, *, path=""):
    """Name+shape-checked partial restore -- the finetuning semantics of
    Net::CopyTrainedLayersFrom (net.cpp:741-777): parameters are matched by
    *name* (pytree path here); a name present in both with the same shape is
    copied, a shape mismatch or a missing name keeps the template's value
    (the reference logs "Ignoring source layer" and moves on; a shape
    mismatch is fatal there, but for cross-config finetuning we skip it and
    report).  Returns (merged_pytree, report) where report maps each leaf
    path to "loaded" | "shape_mismatch" | "missing"."""
    report = {}

    def merge(tpl, src, p):
        if isinstance(tpl, dict):
            out = {}
            for k, v in tpl.items():
                sub = src.get(k) if isinstance(src, dict) else None
                out[k] = merge(v, sub, f"{p}/{k}" if p else str(k))
            return out
        if isinstance(tpl, (list, tuple)):
            src_seq = src if isinstance(src, (list, tuple, dict)) else ()
            out = []
            for i, v in enumerate(tpl):
                if isinstance(src_seq, dict):  # sequences load as dicts
                    sub = src_seq.get(str(i), src_seq.get(i))
                else:
                    sub = src_seq[i] if i < len(src_seq) else None
                out.append(merge(v, sub, f"{p}/{i}"))
            return type(tpl)(out) if isinstance(tpl, tuple) else out
        # leaf
        if src is None:
            report[p] = "missing"
            return tpl
        src_arr = np.asarray(src)
        tpl_shape = getattr(tpl, "shape", None)
        if tpl_shape is not None and tuple(src_arr.shape) != tuple(tpl_shape):
            report[p] = "shape_mismatch"
            return tpl
        report[p] = "loaded"
        return src_arr.astype(tpl.dtype) if hasattr(tpl, "dtype") else src_arr

    return merge(template, loaded, path), report


def load_weights_into(params, state, ckpt_path: str):
    """`caffe train -weights` equivalent (tools/caffe.cpp:125-135, 211-213):
    load a checkpoint's params (+ BN state when present) into an
    already-initialized model by name/shape matching.  Returns
    (params, state, report)."""
    bundle, _meta = load_checkpoint(ckpt_path)
    src_params = bundle.get("params", bundle)
    params, report = copy_matching(params, src_params)
    if state is not None and isinstance(bundle, dict) and "state" in bundle:
        state, state_report = copy_matching(state, bundle["state"])
        report.update({f"state/{k}": v for k, v in state_report.items()})
    return params, state, report


def latest_checkpoint(directory: str, *, prefix: str = "qa") -> str | None:
    """Highest-step checkpoint dir under ``directory`` (resume-from-snapshot,
    the `caffe train -snapshot` equivalent, tools/caffe.cpp:208-210)."""
    if not os.path.isdir(directory):
        return None
    best_step, best = -1, None
    pat = re.compile(rf"^{re.escape(prefix)}_iter_(\d+)$")
    for name in os.listdir(directory):
        m = pat.match(name)
        if m and int(m.group(1)) > best_step:
            best_step, best = int(m.group(1)), os.path.join(directory, name)
    return best
