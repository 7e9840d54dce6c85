"""Deployment export: ONE self-contained artifact carrying the
inference program AND the weights, serialized as StableHLO via
``jax.export``.

This is the rebuild's analog of the reference's frozen deployment pair
-- a .caffemodel plus a deploy prototxt that C++ caffe loads without the
training scripts (/root/reference/tools/caffe.cpp:229-296 test path,
src/caffe/net.cpp construction from NetParameter).  Here the program
and weights travel together: the artifact replays on any machine with
jax installed (``load_scorer``), with NO dependency on this package's
model code, and is lowered for BOTH cpu and cuda by default so the same
file serves on either backend.

The exported function is the inference forward of the flagship MMS
model: (question ids, answer ids, overlap features) -> (logits,
P(class) softmax), batch-size symbolic by default so one artifact
serves any request size.

File layout: ``MAGIC | uint64 header_len | header json | stablehlo
bytes``.  The header carries the shape/config facts a server needs
without deserializing the program, plus the calling-convention facts
``load_scorer`` needs to call it.  The program is the StableHLO module
bytecode itself, not ``Exported.serialize()``'s flatbuffer: that would
make every loading machine need the ``flatbuffers`` package.
"""

from __future__ import annotations

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np

MAGIC = b"MMSXPRT1"
FORMAT = 2


def _aval_spec(aval) -> list:
    """[shape string, dtype name]: symbolic dims print as their names."""
    return [str(tuple(aval.shape)), str(aval.dtype)]


def _avals_from_spec(specs):
    """Rebuild ShapeDtypeStructs (symbolic dims included, all in one
    scope) from ``_aval_spec`` lists."""
    from jax import export as jex
    shapes = [s.strip("()").rstrip(",") for s, _ in specs]
    dims = jex.symbolic_shape(", ".join(x for x in shapes if x))
    out, i = [], 0
    for (shape, dtype), text in zip(specs, shapes):
        n = len([d for d in text.split(",") if d.strip()])
        out.append(jax.ShapeDtypeStruct(tuple(dims[i:i + n]), dtype))
        i += n
    return out


def export_scorer(params, state, cfg, *, batch: int | None = None,
                  platforms=("cpu", "cuda")) -> tuple[bytes, dict]:
    """Lower the inference forward with the weights baked in.  Returns
    (StableHLO module bytecode, calling-convention facts for the header).

    batch: None exports a symbolic batch dimension (one program, any
    request size -- scoped dynamism jax.export supports without
    sacrificing static shapes inside the program); an int pins it.
    """
    from .models.mms_qa import mms_qa_apply
    from jax import export as jex

    def scorer(question, answer, overlap_feat):
        out, _ = mms_qa_apply(
            params, state,
            {"question": question, "answer": answer,
             "overlap_feat": overlap_feat},
            cfg, train=False)
        return out["logits"], out["prob"]

    b = jex.symbolic_shape("b")[0] if batch is None else int(batch)
    args = (jax.ShapeDtypeStruct((b, cfg.question_len), jnp.int32),
            jax.ShapeDtypeStruct((b, cfg.answer_len), jnp.int32),
            jax.ShapeDtypeStruct((b, cfg.overlap_features), jnp.float32))
    exp = jex.export(jax.jit(scorer), platforms=tuple(platforms))(*args)
    if exp.ordered_effects or exp.unordered_effects or exp.nr_devices != 1:
        raise ValueError("the scorer must be effect-free and single-device")
    call = {
        "in_avals": [_aval_spec(a) for a in exp.in_avals],
        "out_avals": [_aval_spec(a) for a in exp.out_avals],
        "calling_convention_version": exp.calling_convention_version,
        "module_kept_var_idx": list(exp.module_kept_var_idx),
        "uses_global_constants": exp.uses_global_constants,
    }
    return bytes(exp.mlir_module_serialized), call


def save_scorer(path: str, params, state, cfg, *,
                batch: int | None = None,
                platforms=("cpu", "cuda")) -> dict:
    """Export + write the artifact; returns the header dict."""
    blob, call = export_scorer(params, state, cfg, batch=batch,
                               platforms=platforms)
    header = {
        "format": FORMAT,
        "question_len": int(cfg.question_len),
        "answer_len": int(cfg.answer_len),
        "overlap_features": int(cfg.overlap_features),
        "vocab_size": int(cfg.vocab_size),
        "batch": batch,
        "platforms": list(platforms),
        "outputs": ["logits", "prob"],
        "call": call,
        "bytes": len(blob),
    }
    hb = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        f.write(blob)
    return header


def _exported_from(header: dict, module: bytes):
    """A callable ``jax.export.Exported`` for the stored module: a
    stand-in function with the same signature is exported for the same
    platforms (that fills the calling-convention fields JAX owns), then
    its module and module facts are swapped for the stored ones."""
    import dataclasses

    from jax import export as jex

    call = header["call"]
    ins = _avals_from_spec(call["in_avals"])
    outs = _avals_from_spec(call["out_avals"])
    in_dims = {str(d): d for a in ins for d in a.shape}

    def stand_in(*args):
        # output dims in terms of the inputs' (same-named) symbols
        return tuple(jnp.zeros(tuple(in_dims.get(str(d), d)
                                     for d in o.shape), o.dtype)
                     for o in outs)

    template = jex.export(jax.jit(stand_in),
                          platforms=tuple(header["platforms"]))(*ins)
    return dataclasses.replace(
        template,
        mlir_module_serialized=module,
        calling_convention_version=call["calling_convention_version"],
        module_kept_var_idx=tuple(call["module_kept_var_idx"]),
        uses_global_constants=call["uses_global_constants"])


class LoadedScorer:
    """A deserialized deployment artifact.  ``call`` accepts host or
    device arrays and returns host (logits, prob)."""

    def __init__(self, header: dict, exported):
        self.header = header
        self._exported = exported

    def __call__(self, question, answer, overlap_feat):
        logits, prob = self._exported.call(
            jnp.asarray(question, jnp.int32),
            jnp.asarray(answer, jnp.int32),
            jnp.asarray(overlap_feat, jnp.float32))
        return np.asarray(logits), np.asarray(prob)

    def score(self, question, answer, overlap_feat) -> np.ndarray:
        """P(correct) -- the positive-class probability column."""
        return self(question, answer, overlap_feat)[1][:, 1]


def load_scorer(path: str) -> LoadedScorer:
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"{path} is not an exported scorer "
                             f"(bad magic {magic!r})")
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        blob = f.read()
    if header.get("format") != FORMAT:
        raise ValueError(f"unsupported artifact format {header.get('format')}")
    if len(blob) != header["bytes"]:
        raise ValueError(f"truncated artifact: header promises "
                         f"{header['bytes']} program bytes, found "
                         f"{len(blob)}")
    return LoadedScorer(header, _exported_from(header, blob))
