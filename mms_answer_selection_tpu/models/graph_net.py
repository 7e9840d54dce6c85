"""GraphNet: run ANY NetParameter prototxt as a jittable JAX function.

The reference's ``Net`` (src/caffe/net.cpp:39-595) turns an arbitrary
layer DAG — any of the ~70 stock layer types plus the fork's additions —
into an executable forward/backward graph: phase filtering (FilterNet,
net.cpp:282-360), named-ParamSpec weight sharing (net.cpp:472-550),
loss_weight accumulation (net.cpp:156-166) and autogenerated backward.
The typed-config model families (``models/mms_qa.py`` etc.) cover the
recipes; this module covers the *generality*: a prototxt outside any
known family still runs.

JAX-first design, not a Net translation:

* A GraphNet is a pure function factory.  ``init`` walks the layer list
  once with example inputs, creating parameters layer-by-layer (shape
  inference IS the forward walk — no separate Reshape machinery like
  net.cpp's Blob reshaping pass).  ``apply`` replays the walk with real
  inputs and is fully jittable: static Python control flow over the
  layer list unrolls into one XLA graph, so the whole net fuses exactly
  like a hand-written model function.
* Backward is ``jax.grad`` of the weighted loss sum — InsertSplits
  (net.cpp:InsertSplits) is autodiff gradient accumulation; there is no
  split bookkeeping to do.
* Layout is NHWC end-to-end.  Caffe axis arguments are
  written against NCHW; for 4-D blobs GraphNet maps axis 1 -> -1 (and
  2,3 -> 1,2) so ``Concat { axis: 1 }`` concatenates channels here too.
  Non-4-D blobs use axes verbatim.  ``InnerProduct``/``Flatten``
  flatten in NHWC element order (the .caffemodel interop layer owns the
  NCHW<->NHWC permutation, utils/caffemodel.py).
* Data-family layers (Data/HDF5Data/ImageData/...) declare *inputs*:
  their tops are provided by the caller per step (the data pipeline is
  ``data/loader.py``'s job, decoupled from the graph — the reference
  couples them via prefetch threads inside the layer, base_data_layer
  .cpp).  DummyData generates its filler output in-graph.

Weight sharing follows caffe's rule (net.cpp:472-550): a ``param {
name: "..." }`` spec shares that blob slot with every other layer
declaring the same name; the first declaring layer owns the storage.

Supported types (registry below): the full zoo of ``ops/`` — if a type
is missing, ``GraphNet`` raises at construction with the layer name, the
same contract as LayerRegistry::CreateLayer (layer_factory.hpp:68-80).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import jax
import jax.numpy as jnp

from ..metrics import ir_metrics
from ..ops import losses as losses_ops
from ..ops import zoo
from ..ops.batch_norm import bn_apply, bn_init
from ..ops.dropout import dropout
from ..ops.embed import embed_lookup, load_pretrained_vectors
from ..ops.pooling import (pool2d_padded, spatial_pyramid_pool,
                           stochastic_pool2d)
from ..ops.recurrent import lstm_apply, lstm_init, rnn_apply, rnn_init
from ..ops.similarity import (fm_pool, sim_cross_bilinear, sim_cross_cosine,
                              sim_cross_inv_euclidean, sim_matrix)
from ..utils import fillers
from ..utils.prototxt import parse_prototxt, upgrade_net_prototxt

# layer types whose tops are external inputs (the caller's data pipeline)
DATA_TYPES = frozenset({
    "Data", "HDF5Data", "ImageData", "MemoryData", "WindowData",
    "PairImageData", "Input",
})

# types that are losses by default (loss_weight 1 on top 0, net.cpp:156-166
# applies it to types ending in "Loss")
def _is_loss_type(t: str) -> bool:
    return t.endswith("Loss")


def _as_list(v):
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _one(v, default=None):
    """Collapse a possibly-repeated scalar field to its last value."""
    if isinstance(v, list):
        return v[-1] if v else default
    return default if v is None else v


def _spatial2(p, field, default, h_key, w_key):
    """(h, w) from a ConvolutionParameter REPEATED spatial field: one
    entry applies to both axes, two entries are per-axis (h, w) —
    base_conv_layer.cpp reads kernel_size/stride/pad/dilation this way.
    Explicit *_h/*_w fields override (and in caffe exclude the repeated
    form, so override order is moot)."""
    vals = _as_list(p.get(field))
    if len(vals) >= 2:
        vh, vw = int(vals[0]), int(vals[1])
    else:
        vh = vw = int(vals[0]) if vals else default
    return (int(_one(p.get(h_key), vh)) if h_key else vh,
            int(_one(p.get(w_key), vw)) if w_key else vw)


def _axis(caffe_axis: int, ndim: int) -> int:
    """Caffe (NCHW) axis -> this framework's (NHWC) axis for 4-D blobs;
    identity otherwise.  Negative axes resolve first."""
    a = caffe_axis % ndim if ndim else caffe_axis
    if ndim == 4:
        return {0: 0, 1: 3, 2: 1, 3: 2}[a]
    return a


def _pool_mode(v) -> str:
    v = _one(v, "MAX")
    if isinstance(v, int):
        return {0: "max", 1: "ave", 2: "stochastic"}[v]
    return str(v).lower()


def _filler(spec, key, shape, *, fan_in=None, dtype=jnp.float32):
    """FillerParameter message -> array (filler.hpp's registry)."""
    spec = spec or {}
    t = str(_one(spec.get("type"), "constant")).lower()
    if t == "constant":
        return fillers.constant(shape, float(_one(spec.get("value"), 0.0)),
                                dtype)
    if t == "xavier":
        return fillers.xavier(key, shape, fan_in=fan_in, dtype=dtype)
    if t == "uniform":
        return fillers.uniform(key, shape, float(_one(spec.get("min"), 0.0)),
                               float(_one(spec.get("max"), 1.0)), dtype)
    if t == "gaussian":
        return fillers.gaussian(key, shape, float(_one(spec.get("mean"), 0.0)),
                                float(_one(spec.get("std"), 1.0)), dtype)
    if t == "msra":
        return fillers.msra(key, shape, fan_in=fan_in, dtype=dtype)
    if t == "positive_unitball":
        return fillers.positive_unitball(key, shape, dtype)
    if t == "bilinear":
        return fillers.bilinear(shape, dtype)
    raise ValueError(f"unknown filler type {t!r}")


@dataclasses.dataclass(frozen=True)
class LayerNode:
    name: str
    type: str
    bottoms: tuple[str, ...]
    tops: tuple[str, ...]
    cfg: dict                      # the raw (upgraded) layer message
    param_specs: tuple[dict, ...]  # param {} entries, in blob order
    loss_weights: tuple[float, ...]


def _phase_keeps(layer: dict, phase: str) -> bool:
    """NetStateMeetsRule on the phase field (net.cpp:282-360; include
    rules OR together, exclude rules veto)."""
    want = phase.upper()

    def rule_matches(rule):
        unsupported = [f for f in ("min_level", "max_level", "stage",
                                   "not_stage", "level")
                       if rule.get(f) is not None]
        if unsupported:
            # silently including (or vetoing) a stage/level-gated layer
            # is worse than refusing: this framework carries no NetState
            # beyond the phase (net.cpp:282-360)
            raise ValueError(
                f"NetStateRule fields {unsupported} are not supported "
                f"(only phase); remove the rule or split the prototxt")
        p = _one(rule.get("phase"))
        return p is None or str(p).upper() == want

    includes = _as_list(layer.get("include"))
    excludes = _as_list(layer.get("exclude"))
    if includes:
        return any(rule_matches(r) for r in includes)
    return not any(rule_matches(r) for r in excludes)


class _Ctx:
    """Per-walk context handed to layer handlers."""

    def __init__(self, net, params, state, *, train, rng, initializing,
                 init_key=None, dtype=jnp.float32):
        self.net = net
        self.params = params
        self.state = state
        self.new_state = {}
        self.train = train
        self.rng = rng
        self.initializing = initializing
        self._init_key = init_key
        self._fold = 0
        self.dtype = dtype
        self.layer_index = 0

    # -- rng ---------------------------------------------------------------
    def init_key(self):
        self._fold += 1
        return jax.random.fold_in(self._init_key, self._fold)

    def step_key(self):
        if self.rng is None:
            raise ValueError(
                "this net contains stochastic layers (Dropout / STOCHASTIC "
                "pooling / DummyData noise); pass rng= to apply()")
        self._fold += 1
        return jax.random.fold_in(self.rng, self._fold)

    # -- parameters --------------------------------------------------------
    def param(self, layer: LayerNode, key: str, make: Callable):
        """Fetch (or, when initializing, create) blob ``key`` of ``layer``,
        honoring ParamSpec name sharing.  ``make(rng_key) -> array``."""
        owner, okey = self.net._resolve_slot(layer, key)
        bucket = self.params.setdefault(owner, {}) \
            if self.initializing else self.params.get(owner, {})
        if okey not in bucket:
            if not self.initializing:
                raise KeyError(
                    f"missing parameter {owner}/{okey} (layer {layer.name})")
            bucket[okey] = make(self.init_key())
        return bucket[okey]

    def layer_state(self, layer: LayerNode, make: Callable):
        """Per-layer mutable state (BN running stats etc.)."""
        if self.initializing and layer.name not in self.state:
            self.state[layer.name] = make()
        return self.state.get(layer.name)


class GraphNet:
    """Executable NetParameter graph.  See module docstring.

    >>> net = GraphNet(prototxt_text, phase="train")
    >>> params, state = net.init(key, {"data": x, "label": y})
    >>> blobs, new_state = net.apply(params, state, batch, train=True,
    ...                              rng=step_key)
    >>> loss, (blobs, new_state) = net.loss(params, state, batch, rng=k)
    """

    def __init__(self, net, *, phase: str = "train"):
        if isinstance(net, str):
            net = parse_prototxt(net)
        net = upgrade_net_prototxt(net)
        self.name = str(net.get("name", ""))
        self.phase = phase.lower()
        layers = _as_list(net.get("layer"))
        self.layers: list[LayerNode] = []
        self.input_names: list[str] = [str(s) for s in
                                       _as_list(net.get("input"))]
        # deploy-prototxt input shape declarations (net.cpp:47-69 input
        # handling): modern repeated `input_shape {}` or legacy flat
        # `input_dim:` (4 ints per input), one entry per `input:` name
        self._input_shape_decls: dict[str, tuple[int, ...]] = {}
        shapes = [tuple(int(x) for x in _as_list(sh.get("dim")))
                  for sh in _as_list(net.get("input_shape"))]
        if not shapes:
            flat = [int(x) for x in _as_list(net.get("input_dim"))]
            shapes = [tuple(flat[i:i + 4])
                      for i in range(0, len(flat), 4)]
        for nm, sh in zip(self.input_names, shapes):
            self._input_shape_decls[nm] = sh
        seen_names = set()
        for raw in layers:
            if not _phase_keeps(raw, self.phase):
                continue
            t = str(raw.get("type", ""))
            name = str(raw.get("name", f"layer{len(self.layers)}"))
            if name in seen_names:
                raise ValueError(f"duplicate layer name {name!r}")
            seen_names.add(name)
            if t not in _REGISTRY:
                raise ValueError(
                    f"unknown layer type {t!r} (layer {name!r}); "
                    f"known: {sorted(_REGISTRY)}")
            tops = tuple(str(s) for s in _as_list(raw.get("top")))
            bottoms = tuple(str(s) for s in _as_list(raw.get("bottom")))
            specs = tuple(_as_list(raw.get("param")))
            lw = tuple(float(w) for w in _as_list(raw.get("loss_weight")))
            if not lw and _is_loss_type(t):
                lw = (1.0,)
            self.layers.append(LayerNode(name, t, bottoms, tops, raw,
                                         specs, lw))
            if t in DATA_TYPES:
                self.input_names.extend(tops)
        # -- ParamSpec sharing plan (net.cpp:472-550): (layer, blob_key) ->
        # (owner_layer, owner_blob_key); owner = first declarer of the name
        self._slots: dict[tuple[str, str], tuple[str, str]] = {}
        owners: dict[str, tuple[str, str]] = {}
        for node in self.layers:
            keys = _REGISTRY[node.type].param_keys
            for i, spec in enumerate(node.param_specs):
                if i >= len(keys):
                    continue  # specs for state blobs (e.g. BN stats)
                share = spec.get("name")
                if not share:
                    continue
                share = str(share)
                if share in owners:
                    self._slots[(node.name, keys[i])] = owners[share]
                else:
                    owners[share] = (node.name, keys[i])

    # ------------------------------------------------------------------
    def _resolve_slot(self, layer: LayerNode, key: str) -> tuple[str, str]:
        return self._slots.get((layer.name, key), (layer.name, key))

    def layer_index(self, name: str) -> int:
        for i, node in enumerate(self.layers):
            if node.name == name:
                return i
        raise KeyError(f"no layer named {name!r}")

    def _walk(self, ctx: _Ctx, inputs: dict, *, lo: int = 0,
              hi: int | None = None) -> dict:
        blobs = dict(inputs)
        provided = frozenset(inputs)
        for i, node in enumerate(self.layers):
            if i < lo or (hi is not None and i > hi):
                continue
            ctx.layer_index = i
            if node.type in DATA_TYPES:
                missing = [t for t in node.tops if t not in blobs]
                if missing:
                    raise KeyError(
                        f"data layer {node.name!r} tops {missing} not in "
                        f"inputs (GraphNet data layers read from the "
                        f"caller's pipeline)")
                continue
            try:
                bottoms = [blobs[b] for b in node.bottoms]
            except KeyError as e:
                raise KeyError(f"layer {node.name!r} bottom {e} not yet "
                               f"produced") from None
            outs = _REGISTRY[node.type].fn(ctx, node, bottoms)
            if outs is None:
                outs = []
            elif not isinstance(outs, (tuple, list)):
                outs = [outs]
            for top, val in zip(node.tops, outs):
                if node.type == "DummyData" and top in provided:
                    # explicit inputs win over in-graph generation (the
                    # pycaffe idiom; matcaffe stages DummyData tops with
                    # blob_set_data, matching caffe's fill-once constant
                    # filler semantics, dummy_data_layer.cpp:19-60)
                    continue
                blobs[top] = val
        return blobs

    # ------------------------------------------------------------------
    def init(self, key, example_inputs: dict, *, dtype=jnp.float32):
        """Create (params, state) by walking the graph over
        ``example_inputs`` (shapes matter, values don't)."""
        params: dict = {}
        state: dict = {}
        ctx = _Ctx(self, params, state, train=True,
                   rng=jax.random.fold_in(key, 0xD0), initializing=True,
                   init_key=key, dtype=dtype)
        self._walk(ctx, example_inputs)
        return params, state

    def apply(self, params, state, inputs: dict, *, train: bool = False,
              rng=None, start: str | None = None, end: str | None = None):
        """Run the net.  Returns (blobs, new_state): every named top plus
        the inputs; new_state carries updated BN statistics.

        ``start``/``end`` name layers for a PARTIAL forward (pycaffe's
        ``net.forward(start=, end=)``, pycaffe.py:78-105): only layers
        in [start, end] execute; ``inputs`` must then carry the range's
        bottom blobs (the caller's previous-forward blobs, in the
        pycaffe usage)."""
        ctx = _Ctx(self, params, dict(state), train=train, rng=rng,
                   initializing=False)
        lo = 0 if start is None else self.layer_index(start)
        hi = None if end is None else self.layer_index(end)
        blobs = self._walk(ctx, inputs, lo=lo, hi=hi)
        merged = dict(state)
        merged.update(ctx.new_state)
        return blobs, merged

    def loss(self, params, state, inputs: dict, *, rng=None,
             train: bool = True):
        """Weighted loss sum (net.cpp:156-166).  Returns
        (total_loss, (blobs, new_state)) — grad-ready with has_aux."""
        blobs, new_state = self.apply(params, state, inputs, train=train,
                                      rng=rng)
        total = jnp.zeros((), jnp.float32)
        for node in self.layers:
            for w, top in zip(node.loss_weights, node.tops):
                if w:
                    total = total + w * jnp.sum(
                        blobs[top].astype(jnp.float32))
        return total, (blobs, new_state)

    def output_blob_names(self) -> list[str]:
        """Net output blobs (net.cpp:270-279): walk layers erasing
        bottoms from the available set and adding tops; whatever remains
        is an output.  In-place layers (top == bottom) re-add the name,
        exactly like AppendTop, so a net ending in in-place ReLU still
        reports the blob."""
        avail: dict[str, None] = dict.fromkeys(self.input_names)
        for node in self.layers:
            if node.type in DATA_TYPES:
                continue
            for b in node.bottoms:
                avail.pop(b, None)
            for t in node.tops:
                avail[t] = None
        return list(avail)

    def declared_input_shapes(self, *, nhwc: bool = True) -> dict:
        """Input blob -> declared shape, from deploy-style net-level
        `input_shape`/`input_dim` declarations plus Input layers'
        `input_param { shape {} }` (input_layer.cpp:9-25: one shape, or
        one per top).  4-D declarations are caffe NCHW; ``nhwc=True``
        (default) permutes them to this framework's NHWC data layout.
        Blobs fed externally without any declaration are absent."""
        out = dict(self._input_shape_decls)
        for node in self.layers:
            if node.type != "Input":
                continue
            p = _p(node, "input_param")
            shapes = [tuple(int(x) for x in _as_list(sh.get("dim")))
                      for sh in _as_list(p.get("shape"))]
            if not shapes:
                continue
            for i, t in enumerate(node.tops):
                out[t] = shapes[i] if i < len(shapes) else shapes[0]
        if nhwc:
            out = {k: (v[0], v[2], v[3], v[1]) if len(v) == 4 else v
                   for k, v in out.items()}
        return out

    def blob_loss_weights(self) -> dict:
        """top name -> loss weight (net.cpp:156-166; 0 if not a loss)."""
        out: dict[str, float] = {}
        for node in self.layers:
            for i, t in enumerate(node.tops):
                w = (node.loss_weights[i]
                     if i < len(node.loss_weights) else 0.0)
                if w:
                    out[t] = float(w)
        return out

    def caffemodel_specs(self, params, state):
        """Generic Net::ToProto/ToHDF5 (net.cpp:847-913): a
        utils/caffemodel spec list covering EVERY layer of this net, in
        net order, with caffe's blob layouts — pass as ``specs=`` to
        save/load_caffemodel_* and the solverstate writers so any
        GraphNet round-trips the reference formats, not just the typed
        model families.  Layers without blobs appear with empty rows
        (ToHDF5 writes empty groups; the tests pin that convention).

        Layout notes: Convolution HWIO<->OIHW; Deconvolution is stored in
        caffe's own (Cin, Cout/g, kh, kw) already; InnerProduct
        (in,out)<->(out,in); BN blobs 2/3 are the running stats from
        ``state`` as (1, C, 1, 1) (bn_layer.cpp:91-117); BatchNorm blobs
        are mean/var/scale-factor (batch_norm_layer.cpp:30-45); LSTM/RNN
        blobs follow the unrolled net's param order — x-transform weight,
        its bias, hidden-transform weight (lstm_layer.cpp:199-244)."""
        import numpy as np

        def tr(*ax):
            return lambda a: np.transpose(a, ax)

        def ident(a):
            return a

        specs = []
        for node in self.layers:
            t = node.type
            rows = []

            def have(key, node=node):
                o, k = self._resolve_slot(node, key)
                return o in params and k in params[o]

            def add(idx, key, to_c=ident, from_c=ident, node=node,
                    rows=rows):
                o, k = self._resolve_slot(node, key)
                rows.append((idx, "params", (o, k), to_c, from_c))

            if t == "Convolution":
                add(0, "w", tr(3, 2, 0, 1), tr(2, 3, 1, 0))
                if have("b"):
                    add(1, "b")
            elif t == "Deconvolution":
                add(0, "w")
                if have("b"):
                    add(1, "b")
            elif t == "InnerProduct":
                add(0, "w", tr(1, 0), tr(1, 0))
                if have("b"):
                    add(1, "b")
            elif t == "Embed":
                add(0, "w")
                if have("b"):
                    add(1, "b")
            elif t == "PReLU":
                add(0, "slopes")
            elif t == "Scale":
                if have("scale"):
                    add(0, "scale")
                    if have("bias"):
                        add(1, "bias")
                elif have("bias"):
                    # two-bottom Scale with bias_term: the scale factor
                    # is the second bottom, so the ONLY learned blob is
                    # the bias, stored at index 0 (scale_layer.cpp:36-44)
                    add(0, "bias")
            elif t == "Bias":
                if have("bias"):
                    add(0, "bias")
            elif t == "Parameter":
                add(0, "w")
            elif t == "SimCross":
                if have("w"):
                    add(0, "w")
                    if have("b"):
                        add(1, "b")
            elif t == "SimMatrix":
                add(0, "w")
            elif t == "FM":
                if have("b"):
                    add(0, "b", lambda a: np.reshape(a, (1,)),
                        lambda a: np.reshape(a, ()))
            elif t == "LSTM":
                add(0, "wx", tr(1, 0), tr(1, 0))
                add(1, "b")
                add(2, "wh", tr(1, 0), tr(1, 0))
            elif t == "RNN":
                # rnn_layer.cpp blob order: W_xh, b_h, W_hh, W_ho, b_o
                add(0, "wx", tr(1, 0), tr(1, 0))
                add(1, "b")
                add(2, "wh", tr(1, 0), tr(1, 0))
                add(3, "wo", tr(1, 0), tr(1, 0))
                add(4, "bo")
            elif t == "BN":
                owner, _ = self._resolve_slot(node, "scale")
                c = np.shape(params[owner]["scale"])[0]

                def wide(a, c=c):
                    return np.reshape(a, (1, c, 1, 1))

                def flat(a, c=c):
                    return np.reshape(a, (c,))

                add(0, "scale", wide, flat)
                add(1, "shift", wide, flat)
                rows.append((2, "state", (node.name, "mean"), wide, flat))
                rows.append((3, "state", (node.name, "var"), wide, flat))
            elif t == "BatchNorm":
                c = np.shape(state[node.name]["mean"])[0]
                rows.append((0, "state", (node.name, "mean"), ident, ident))
                rows.append((1, "state", (node.name, "var"), ident, ident))
                rows.append((2, "state", (node.name, "factor"),
                             lambda a: np.reshape(a, (1,)),
                             lambda a: np.reshape(a, ())))
            param_rows = [r for r in rows if r[1] == "params"]
            shared = bool(param_rows) and all(
                r[2][0] != node.name for r in param_rows)
            specs.append((node.name, rows, shared))
        return specs

    def param_spec(self, params) -> dict:
        """(lr_mult, decay_mult) tree shaped like ``params`` from the
        prototxt's ParamSpecs; blobs without a spec default to (1, 1)
        (ParamSpec proto defaults)."""
        spec_by_slot: dict[tuple[str, str], tuple[float, float]] = {}
        for node in self.layers:
            keys = _REGISTRY[node.type].param_keys
            for i, ps in enumerate(node.param_specs):
                if i >= len(keys):
                    continue
                slot = self._resolve_slot(node, keys[i])
                # a sharing layer's spec only overrides fields it states
                # explicitly (net.cpp AppendParam CHECK_EQs a re-stated
                # lr_mult against the owner's; omitted fields inherit)
                prev = spec_by_slot.get(slot, (1.0, 1.0))
                spec_by_slot[slot] = (
                    float(_one(ps.get("lr_mult"), prev[0])),
                    float(_one(ps.get("decay_mult"), prev[1])))
        return {ln: {k: spec_by_slot.get((ln, k), (1.0, 1.0)) for k in sub}
                for ln, sub in params.items()}


# ===========================================================================
# layer registry
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class _Entry:
    fn: Callable
    param_keys: tuple[str, ...] = ()


_REGISTRY: dict[str, _Entry] = {}


def _register(type_name: str, *, param_keys: tuple[str, ...] = ()):
    def deco(fn):
        _REGISTRY[type_name] = _Entry(fn, param_keys)
        return fn
    return deco


def register_layer(type_name: str, fn, *, param_keys: tuple[str, ...] = ()):
    """Public layer-extension point (REGISTER_LAYER_CLASS /
    layer_factory.hpp:56-141, and the PythonLayer's raison d'être).

    ``fn(ctx, node, bottoms) -> top(s)``: ``bottoms`` is the list of
    bottom arrays; return one array, or a list matching the layer's
    tops.  ``node.cfg`` is the raw (upgraded) prototxt layer message;
    learnable blobs come from ``ctx.param(node, key, make)`` for each
    key in ``param_keys`` (order = the blob order caffe would see);
    per-step randomness from ``ctx.step_key()``.  The function must be
    jax-traceable — it runs inside ``jit``."""
    if type_name in _REGISTRY:
        raise ValueError(f"layer type {type_name!r} already registered")
    _REGISTRY[type_name] = _Entry(fn, tuple(param_keys))


def layer_type_list() -> list[str]:
    """Registered layer type strings, sorted — pycaffe's
    ``caffe.layer_type_list()`` (LayerRegistry::LayerTypeList,
    layer_factory.hpp:110-120; bound in _caffe.cpp)."""
    return sorted(_REGISTRY)


def _p(node: LayerNode, msg: str) -> dict:
    v = node.cfg.get(msg, {})
    if isinstance(v, list):
        v = v[-1]
    return v if isinstance(v, dict) else {}


# -- data ------------------------------------------------------------------

def _external(ctx, node, bottoms):  # handled in _walk; never called
    raise AssertionError


for _t in DATA_TYPES:
    _REGISTRY[_t] = _Entry(_external)


@_register("DummyData")
def _dummy_data(ctx, node, bottoms):
    """dummy_data_layer.cpp: one filler-generated top per shape entry;
    a single data_filler spec applies to all tops.  4-D shape
    declarations are caffe NCHW and permute to this framework's NHWC
    layout, matching declared_input_shapes."""
    p = _p(node, "dummy_data_param")
    shapes = []
    for sh in _as_list(p.get("shape")):
        shapes.append(tuple(int(d) for d in _as_list(sh.get("dim"))))
    if not shapes:  # legacy num/channels/height/width fields
        nums = [_as_list(p.get(f)) for f in
                ("num", "channels", "height", "width")]
        count = max(len(x) for x in nums)
        for i in range(count):
            shapes.append(tuple(int(x[i if len(x) > 1 else 0])
                                for x in nums if x))
    shapes = [(s[0], s[2], s[3], s[1]) if len(s) == 4 else s
              for s in shapes]
    if len(shapes) == 1 and len(node.tops) > 1:
        # ONE shape declaration replicates across every top, like the
        # filler below (dummy_data_layer.cpp CHECKs 1-or-num_top)
        shapes = shapes * len(node.tops)
    fill = _as_list(p.get("data_filler"))
    outs = []
    for i, sh in enumerate(shapes[:len(node.tops)]):
        f = fill[i] if i < len(fill) else (fill[0] if fill else None)
        t = str(_one((f or {}).get("type"), "constant")).lower()
        if t in ("constant",):
            outs.append(_filler(f, None, sh, dtype=ctx.dtype))
        else:  # random fillers draw fresh each pass (dummy_data_layer.cpp:19)
            key = ctx.init_key() if ctx.initializing else ctx.step_key()
            outs.append(_filler(f, key, sh, dtype=ctx.dtype))
    return outs


@_register("Python")
def _python(ctx, node, bottoms):
    """PythonLayer (python_layer.hpp, layer_factory.cpp:236-260):
    ``python_param { module: "m" layer: "f" param_str: "..." }`` resolves
    ``m.f`` and applies it to the bottoms.  The target must be
    jax-traceable (it runs inside jit): either a function
    ``f(*bottoms) -> top(s)`` or a class whose instance is callable /
    has ``forward`` — the JAX-native reading of the reference's
    setup/forward protocol (state lives in closures or params, not
    mutable self).  ``param_str`` is passed as a keyword when the
    callable accepts it."""
    import importlib
    import inspect

    p = _p(node, "python_param")
    module = str(_one(p.get("module"), ""))
    layer = str(_one(p.get("layer"), ""))
    if not module or not layer:
        raise ValueError(f"Python layer {node.name!r} needs python_param "
                         f"module and layer")
    target = getattr(importlib.import_module(module), layer)
    param_str = _one(p.get("param_str"))
    if isinstance(target, type):
        try:
            inst = (target(param_str) if param_str is not None
                    else target())
        except TypeError:
            inst = target()
        target = getattr(inst, "forward", inst)
        param_str = None  # consumed by construction
    kwargs = {}
    if param_str is not None:
        try:
            sig = inspect.signature(target)
            if "param_str" in sig.parameters:
                kwargs["param_str"] = param_str
        except (TypeError, ValueError):
            pass
    return target(*bottoms, **kwargs)


@_register("Parameter", param_keys=("w",))
def _parameter(ctx, node, bottoms):
    """parameter_layer.cpp: expose a learnable blob as a top."""
    p = _p(node, "parameter_param")
    sh = _one(p.get("shape"), {})
    shape = tuple(int(d) for d in _as_list(sh.get("dim"))) if sh else ()
    w = ctx.param(node, "w",
                  lambda k: _filler(None, k, shape, dtype=ctx.dtype))
    return w


@_register("Silence")
def _silence(ctx, node, bottoms):
    return []


@_register("Split")
def _split(ctx, node, bottoms):
    return [bottoms[0] for _ in node.tops]


# -- learnable compute -----------------------------------------------------

@_register("Convolution", param_keys=("w", "b"))
def _convolution(ctx, node, bottoms):
    """conv_layer.cpp / base_conv_layer.cpp over NHWC.  Weights stored
    HWIO (kh, kw, Cin/group, Cout); utils/caffemodel.py owns the NCHW
    blob permutation for interop."""
    p = _p(node, "convolution_param")
    x, = bottoms
    cout = int(_one(p.get("num_output")))
    kh, kw = _spatial2(p, "kernel_size", 0, "kernel_h", "kernel_w")
    sh_, sw = _spatial2(p, "stride", 1, "stride_h", "stride_w")
    ph, pw = _spatial2(p, "pad", 0, "pad_h", "pad_w")
    dh, dw = _spatial2(p, "dilation", 1, None, None)
    group = int(_one(p.get("group"), 1))
    bias_term = bool(_one(p.get("bias_term"), True))
    cin = x.shape[-1]
    if cin % group or cout % group:
        raise ValueError(f"channels ({cin}->{cout}) not divisible by "
                         f"group {group} (layer {node.name})")
    fan_in = (cin // group) * kh * kw
    w = ctx.param(node, "w", lambda k: _filler(
        p.get("weight_filler"), k, (kh, kw, cin // group, cout),
        fan_in=fan_in, dtype=ctx.dtype))
    outs = []
    cig, cog = cin // group, cout // group
    for g in range(group):
        outs.append(jax.lax.conv_general_dilated(
            x[..., g * cig:(g + 1) * cig],
            w[..., g * cog:(g + 1) * cog],
            window_strides=(sh_, sw), padding=[(ph, ph), (pw, pw)],
            rhs_dilation=(dh, dw),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=jax.lax.Precision.HIGHEST))
    y = outs[0] if group == 1 else jnp.concatenate(outs, axis=-1)
    if bias_term:
        b = ctx.param(node, "b", lambda k: _filler(
            p.get("bias_filler"), k, (cout,), dtype=ctx.dtype))
        y = y + b
    return y


@_register("Deconvolution", param_keys=("w", "b"))
def _deconvolution(ctx, node, bottoms):
    """deconv_layer.cpp via zoo.deconv2d (caffe blob layout)."""
    p = _p(node, "convolution_param")
    x, = bottoms
    cout = int(_one(p.get("num_output")))
    kh, kw = _spatial2(p, "kernel_size", 0, "kernel_h", "kernel_w")
    if kh != kw:
        raise ValueError("deconv2d supports square kernels")
    st, st_w = _spatial2(p, "stride", 1, "stride_h", "stride_w")
    pd, pd_w = _spatial2(p, "pad", 0, "pad_h", "pad_w")
    dil, dil_w = _spatial2(p, "dilation", 1, None, None)
    if (st, pd, dil) != (st_w, pd_w, dil_w):
        raise ValueError("deconv2d supports square stride/pad/dilation")
    group = int(_one(p.get("group"), 1))
    bias_term = bool(_one(p.get("bias_term"), True))
    cin = x.shape[-1]
    fan_in = (cin // group) * kh * kw
    w = ctx.param(node, "w", lambda k: _filler(
        p.get("weight_filler"), k, (cin, cout // group, kh, kw),
        fan_in=fan_in, dtype=ctx.dtype))
    b = ctx.param(node, "b", lambda k: _filler(
        p.get("bias_filler"), k, (cout,), dtype=ctx.dtype)) \
        if bias_term else None
    return zoo.deconv2d(x, w, b, stride=st, pad=pd, dilation=dil,
                        group=group)


@_register("InnerProduct", param_keys=("w", "b"))
def _inner_product(ctx, node, bottoms):
    """inner_product_layer.cpp: flatten from ``axis`` (default 1), dense
    to num_output.  Weights stored (in, out)."""
    p = _p(node, "inner_product_param")
    x, = bottoms
    n_out = int(_one(p.get("num_output")))
    ax = int(_one(p.get("axis"), 1)) % max(x.ndim, 1)
    bias_term = bool(_one(p.get("bias_term"), True))
    lead = x.shape[:ax]
    d_in = int(math.prod(x.shape[ax:]))
    x2 = x.reshape((-1, d_in))
    w = ctx.param(node, "w", lambda k: _filler(
        p.get("weight_filler"), k, (d_in, n_out), fan_in=d_in,
        dtype=ctx.dtype))
    y = x2 @ w
    if bias_term:
        b = ctx.param(node, "b", lambda k: _filler(
            p.get("bias_filler"), k, (n_out,), dtype=ctx.dtype))
        y = y + b
    return y.reshape(lead + (n_out,))


@_register("Embed", param_keys=("w", "b"))
def _embed(ctx, node, bottoms):
    """embed_layer.cpp incl. the fork's weight_source preload
    (embed_layer.cpp:52-105): rows [0, n) of the table come from the
    vector file at init."""
    p = _p(node, "embed_param")
    ids, = bottoms
    vocab = int(_one(p.get("input_dim")))
    dim = int(_one(p.get("num_output")))
    bias_term = bool(_one(p.get("bias_term"), True))
    source = _one(p.get("weight_source"))

    def make_w(k):
        w = _filler(p.get("weight_filler"), k, (vocab, dim), fan_in=vocab,
                    dtype=ctx.dtype)
        if source:
            _, vecs = load_pretrained_vectors(str(source), dim)
            if vecs.shape[0] > vocab:
                raise ValueError(
                    f"weight_source rows {vecs.shape[0]} > input_dim "
                    f"{vocab} (layer {node.name})")
            w = w.at[:vecs.shape[0]].set(jnp.asarray(vecs, w.dtype))
        return w

    w = ctx.param(node, "w", make_w)
    params = {"w": w}
    if bias_term:
        params["b"] = ctx.param(node, "b", lambda k: _filler(
            p.get("bias_filler"), k, (dim,), dtype=ctx.dtype))
    if not jnp.issubdtype(ids.dtype, jnp.integer):
        # caffe blobs are float; EmbedLayer static_casts each value to an
        # index (embed_layer.cpp:107) — accept float id blobs the same way
        ids = ids.astype(jnp.int32)
    return embed_lookup(params, ids)


@_register("PReLU", param_keys=("slopes",))
def _prelu(ctx, node, bottoms):
    p = _p(node, "prelu_param")
    x, = bottoms
    shared = bool(_one(p.get("channel_shared"), False))
    n = 1 if shared else x.shape[-1]
    filler = p.get("filler") or {"type": "constant", "value": 0.25}
    s = ctx.param(node, "slopes",
                  lambda k: _filler(filler, k, (n,), dtype=ctx.dtype))
    return zoo.prelu(x, s)


def _caffe_axis_broadcast(x, s, caffe_axis: int):
    """Broadcast operand ``s`` against ``x`` starting at caffe axis
    ``caffe_axis`` (Scale/Bias semantics, scale_layer.cpp:55-77: s's
    dims align with x's caffe axes [axis, axis + s.ndim)).  Caffe axes
    are NCHW; on a 4-D NHWC blob each aligned axis maps through the
    layout permutation (and s's dims reorder to NHWC ascending order)."""
    s = jnp.asarray(s)
    if s.ndim == 0:
        return s
    if s.ndim == x.ndim:
        # full-rank operand: already in this framework's layout (it
        # flowed through the same NHWC graph) — elementwise as-is
        return s
    nd = x.ndim
    a = caffe_axis % nd
    if nd == 4:
        pos = [_axis(a + i, 4) for i in range(s.ndim)]
    else:
        pos = list(range(a, a + s.ndim))
    order = sorted(range(len(pos)), key=lambda i: pos[i])
    if order != list(range(len(pos))):
        s = jnp.transpose(s, tuple(order))
    shape = [1] * nd
    for p_, d in zip(sorted(pos), s.shape):
        shape[p_] = d
    return jnp.reshape(s, shape)


@_register("Scale", param_keys=("scale", "bias"))
def _scale(ctx, node, bottoms):
    """scale_layer.cpp: learned (or second-bottom) per-channel multiplier
    + optional fused bias."""
    p = _p(node, "scale_param")
    x = bottoms[0]
    bias_term = bool(_one(p.get("bias_term"), False))
    if len(bottoms) > 1:
        s = bottoms[1]
    else:
        n = x.shape[-1]
        filler = p.get("filler") or {"type": "constant", "value": 1.0}
        s = ctx.param(node, "scale",
                      lambda k: _filler(filler, k, (n,), dtype=ctx.dtype))
    b = None
    if bias_term:
        b = ctx.param(node, "bias", lambda k: _filler(
            p.get("bias_filler"), k, (x.shape[-1],), dtype=ctx.dtype))
    axis = int(_one(p.get("axis"), 1))
    y = x * _caffe_axis_broadcast(x, s, axis)
    if b is not None:
        y = y + _caffe_axis_broadcast(x, b, axis)
    return y


@_register("Bias", param_keys=("bias",))
def _bias(ctx, node, bottoms):
    p = _p(node, "bias_param")
    x = bottoms[0]
    if len(bottoms) > 1:
        b = bottoms[1]
    else:
        b = ctx.param(node, "bias", lambda k: _filler(
            p.get("filler"), k, (x.shape[-1],), dtype=ctx.dtype))
    return x + _caffe_axis_broadcast(x, b, int(_one(p.get("axis"), 1)))


@_register("BN", param_keys=("scale", "shift"))
def _bn(ctx, node, bottoms):
    """The fork's BN layer (bn_layer.cpp): BN-v0 semantics — biased
    variance, eps 1e-9, EMA (bn_memory, default 0.9) updated during the
    TRAINING forward; running stats live in state (blobs 2/3 of the
    reference layer, pinned lr_mult 0 by the recipes)."""
    p = _p(node, "bn_param")
    x, = bottoms
    c = x.shape[-1]
    momentum = float(_one(p.get("bn_memory"), 0.9))
    scale = ctx.param(node, "scale", lambda k: _filler(
        p.get("scale_filler") or {"type": "constant", "value": 1.0},
        k, (c,), dtype=ctx.dtype))
    shift = ctx.param(node, "shift", lambda k: _filler(
        p.get("shift_filler") or {"type": "constant", "value": 0.0},
        k, (c,), dtype=ctx.dtype))
    st = ctx.layer_state(node, lambda: {
        "mean": jnp.zeros((c,), ctx.dtype),
        "var": jnp.zeros((c,), ctx.dtype)})
    y, new_st = bn_apply({"scale": scale, "shift": shift}, st, x,
                         train=ctx.train, momentum=momentum)
    ctx.new_state[node.name] = new_st
    return y


@_register("BatchNorm")
def _batch_norm(ctx, node, bottoms):
    """Upstream BatchNorm (batch_norm_layer.cpp): NO learned scale/shift
    (pair with a Scale layer); stats blobs are mean, variance and a
    moving-average scale factor; eval divides the accumulated stats by
    the factor (batch_norm_layer.cpp:60-80)."""
    p = _p(node, "batch_norm_param")
    x, = bottoms
    c = x.shape[-1]
    eps = float(_one(p.get("eps"), 1e-5))
    frac = float(_one(p.get("moving_average_fraction"), 0.999))
    use_global = _one(p.get("use_global_stats"))
    use_global = (not ctx.train) if use_global is None else bool(use_global)
    st = ctx.layer_state(node, lambda: {
        "mean": jnp.zeros((c,), ctx.dtype),
        "var": jnp.zeros((c,), ctx.dtype),
        "factor": jnp.zeros((), ctx.dtype)})
    axes = tuple(range(x.ndim - 1))
    if use_global:
        f = 1.0 / jnp.maximum(st["factor"], 1e-30)
        mean, var = st["mean"] * f, st["var"] * f
        ctx.new_state[node.name] = st
    else:
        mean = jnp.mean(x, axis=axes)
        var = jnp.mean(jnp.square(x - mean), axis=axes)
        m = math.prod(x.shape[:-1])
        unbias = m / max(m - 1, 1)  # :71 stores the UNBIASED var
        ctx.new_state[node.name] = {
            "mean": st["mean"] * frac + mean,
            "var": st["var"] * frac + unbias * var,
            "factor": st["factor"] * frac + 1.0}
    return (x - mean) / jnp.sqrt(var + eps)


@_register("SimCross", param_keys=("w", "b"))
def _sim_cross(ctx, node, bottoms):
    """sim_cross_layer.cpp: dist_mode default 1 (inv-euclidean,
    caffe.proto:472); mode 2 learns M (D, D) metric matrices (default
    constant-0 filler — the recipe relies on this, CLAUDE.md numerics)."""
    p = _p(node, "sim_cross_param")
    q, a = bottoms
    mode = int(_one(p.get("dist_mode"), 1))
    if mode == 0:
        return sim_cross_cosine(q, a)
    if mode == 1:
        return sim_cross_inv_euclidean(q, a)
    m = int(_one(p.get("mesure_count"), 1))
    d = q.shape[-1]
    w = ctx.param(node, "w", lambda k: _filler(
        p.get("weight_filler"), k, (m, d, d), fan_in=d * d, dtype=ctx.dtype))
    b = None
    if bool(_one(p.get("bias_term"), True)):
        w1, w2 = q.shape[1], a.shape[1]
        b = ctx.param(node, "b", lambda k: _filler(
            p.get("bias_filler"), k, (m, w1, w2), dtype=ctx.dtype))
    return sim_cross_bilinear(q, a, w, b)


@_register("SimMatrix", param_keys=("w",))
def _sim_matrix(ctx, node, bottoms):
    """sim_matrix_layer.cpp:52-65: s_n = x_n^T W y_n."""
    p = _p(node, "sim_matrix_param")
    x, y = bottoms
    k1, k2 = x.shape[-1], y.shape[-1]
    w = ctx.param(node, "w", lambda k: _filler(
        p.get("weight_filler"), k, (k1, k2), fan_in=k1, dtype=ctx.dtype))
    return sim_matrix(x, y, w)


@_register("FM", param_keys=("b",))
def _fm(ctx, node, bottoms):
    p = _p(node, "fm_param")
    x, = bottoms
    b = None
    if bool(_one(p.get("bias_term"), True)):
        b = ctx.param(node, "b",
                      lambda k: _filler(None, k, (), dtype=ctx.dtype))
    return fm_pool(x, b)


@_register("LSTM", param_keys=("wx", "wh", "b"))
def _lstm(ctx, node, bottoms):
    """recurrent_layer.cpp + lstm_layer.cpp: bottoms x (T, N, D) and
    cont (T, N); top (T, N, H)."""
    p = _p(node, "recurrent_param")
    x = bottoms[0]
    cont = bottoms[1] if len(bottoms) > 1 else None
    h = int(_one(p.get("num_output")))
    d = x.shape[-1]
    wf = p.get("weight_filler")
    wx = ctx.param(node, "wx", lambda k: _filler(
        wf, k, (d, 4 * h), fan_in=d, dtype=ctx.dtype))
    wh = ctx.param(node, "wh", lambda k: _filler(
        wf, k, (h, 4 * h), fan_in=h, dtype=ctx.dtype))
    b = ctx.param(node, "b", lambda k: _filler(
        p.get("bias_filler"), k, (4 * h,), dtype=ctx.dtype))
    out, _ = lstm_apply({"wx": wx, "wh": wh, "b": b}, x, cont=cont)
    return out


@_register("LSTMUnit")
def _lstm_unit(ctx, node, bottoms):
    """lstm_unit_layer.cpp: ONE parameter-free LSTM cell step.  Bottoms:
    c_prev (1, N, H), gate pre-activations X (1, N, 4H) in i,f,o,g
    order, cont (1, N) sequence-continuation flags; tops c (1, N, H)
    and h (1, N, H):
        c = cont * sigmoid(f) * c_prev + sigmoid(i) * tanh(g)
        h = sigmoid(o) * tanh(c)
    (the building block LSTM's unrolled net instantiates per step;
    standalone prototxts name it directly, e.g. caffe-LSTM examples)."""
    c_prev, x = bottoms[0], bottoms[1]
    cont = bottoms[2] if len(bottoms) > 2 else None
    i, f, o, g = jnp.split(x, 4, axis=-1)
    forget = jax.nn.sigmoid(f) * c_prev
    if cont is not None:
        forget = forget * cont[..., None].astype(forget.dtype)
    c = forget + jax.nn.sigmoid(i) * jnp.tanh(g)
    h = jax.nn.sigmoid(o) * jnp.tanh(c)
    return [c, h]


@_register("RNN", param_keys=("wx", "b", "wh", "wo", "bo"))
def _rnn(ctx, node, bottoms):
    """rnn_layer.cpp: FIVE blobs (W_xh, b_h, W_hh, W_ho, b_o); the top
    is the projected o_t = tanh(W_ho h_t + b_o)."""
    p = _p(node, "recurrent_param")
    x = bottoms[0]
    cont = bottoms[1] if len(bottoms) > 1 else None
    h = int(_one(p.get("num_output")))
    d = x.shape[-1]
    wf = p.get("weight_filler")
    wx = ctx.param(node, "wx", lambda k: _filler(
        wf, k, (d, h), fan_in=d, dtype=ctx.dtype))
    wh = ctx.param(node, "wh", lambda k: _filler(
        wf, k, (h, h), fan_in=h, dtype=ctx.dtype))
    b = ctx.param(node, "b", lambda k: _filler(
        p.get("bias_filler"), k, (h,), dtype=ctx.dtype))
    wo = ctx.param(node, "wo", lambda k: _filler(
        wf, k, (h, h), fan_in=h, dtype=ctx.dtype))
    bo = ctx.param(node, "bo", lambda k: _filler(
        p.get("bias_filler"), k, (h,), dtype=ctx.dtype))
    out, _ = rnn_apply({"wx": wx, "wh": wh, "b": b, "wo": wo, "bo": bo},
                       x, cont=cont)
    return out


# -- stateless compute -----------------------------------------------------

@_register("Pooling")
def _pooling(ctx, node, bottoms):
    p = _p(node, "pooling_param")
    x, = bottoms
    mode = _pool_mode(p.get("pool"))
    if bool(_one(p.get("global_pooling"), False)):
        kh, kw = x.shape[1], x.shape[2]
    else:
        ks = int(_one(p.get("kernel_size"), 0))
        kh = int(_one(p.get("kernel_h"), ks))
        kw = int(_one(p.get("kernel_w"), ks))
    st = int(_one(p.get("stride"), 1))
    sh_, sw = int(_one(p.get("stride_h"), st)), int(_one(p.get("stride_w"), st))
    pd = int(_one(p.get("pad"), 0))
    ph, pw = int(_one(p.get("pad_h"), pd)), int(_one(p.get("pad_w"), pd))
    if mode == "stochastic":
        return stochastic_pool2d(
            x, kh, kw, stride_h=sh_, stride_w=sw,
            rng=ctx.step_key() if ctx.train else None, train=ctx.train)
    return pool2d_padded(x, kh, kw, stride_h=sh_, stride_w=sw, pad_h=ph,
                         pad_w=pw, mode=mode)


@_register("SPP")
def _spp(ctx, node, bottoms):
    p = _p(node, "spp_param")
    x, = bottoms
    return spatial_pyramid_pool(x, int(_one(p.get("pyramid_height"))),
                                mode=_pool_mode(p.get("pool")))


@_register("LRN")
def _lrn(ctx, node, bottoms):
    p = _p(node, "lrn_param")
    x, = bottoms
    region = str(_one(p.get("norm_region"), "ACROSS_CHANNELS"))
    kw = dict(local_size=int(_one(p.get("local_size"), 5)),
              alpha=float(_one(p.get("alpha"), 1.0)),
              beta=float(_one(p.get("beta"), 0.75)))
    if region in ("WITHIN_CHANNEL", "1", 1):
        return zoo.lrn_within_channel(x, **kw)
    return zoo.lrn_across_channels(x, k=float(_one(p.get("k"), 1.0)), **kw)


@_register("Dropout")
def _dropout(ctx, node, bottoms):
    p = _p(node, "dropout_param")
    ratio = float(_one(p.get("dropout_ratio"), 0.5))
    x, = bottoms
    if not ctx.train or ratio <= 0:
        return x
    return dropout(ctx.step_key(), x, ratio, train=True)


@_register("ReLU")
def _relu(ctx, node, bottoms):
    p = _p(node, "relu_param")
    return zoo.relu(bottoms[0],
                    negative_slope=float(_one(p.get("negative_slope"), 0.0)))


@_register("Sigmoid")
def _sigmoid(ctx, node, bottoms):
    return zoo.sigmoid(bottoms[0])


@_register("TanH")
def _tanh(ctx, node, bottoms):
    return zoo.tanh(bottoms[0])


@_register("ELU")
def _elu(ctx, node, bottoms):
    p = _p(node, "elu_param")
    return zoo.elu(bottoms[0], alpha=float(_one(p.get("alpha"), 1.0)))


@_register("BNLL")
def _bnll(ctx, node, bottoms):
    return zoo.bnll(bottoms[0])


@_register("AbsVal")
def _absval(ctx, node, bottoms):
    return zoo.absval(bottoms[0])


@_register("Power")
def _power(ctx, node, bottoms):
    p = _p(node, "power_param")
    return zoo.power(bottoms[0], power=float(_one(p.get("power"), 1.0)),
                     scale=float(_one(p.get("scale"), 1.0)),
                     shift=float(_one(p.get("shift"), 0.0)))


@_register("Exp")
def _exp(ctx, node, bottoms):
    p = _p(node, "exp_param")
    return zoo.exp(bottoms[0], base=float(_one(p.get("base"), -1.0)),
                   scale=float(_one(p.get("scale"), 1.0)),
                   shift=float(_one(p.get("shift"), 0.0)))


@_register("Log")
def _log(ctx, node, bottoms):
    p = _p(node, "log_param")
    return zoo.log(bottoms[0], base=float(_one(p.get("base"), -1.0)),
                   scale=float(_one(p.get("scale"), 1.0)),
                   shift=float(_one(p.get("shift"), 0.0)))


@_register("Threshold")
def _threshold(ctx, node, bottoms):
    p = _p(node, "threshold_param")
    return zoo.threshold(bottoms[0],
                         threshold=float(_one(p.get("threshold"), 0.0)))


@_register("MVN")
def _mvn(ctx, node, bottoms):
    p = _p(node, "mvn_param")
    return zoo.mvn(bottoms[0],
                   normalize_variance=bool(
                       _one(p.get("normalize_variance"), True)),
                   across_channels=bool(
                       _one(p.get("across_channels"), False)),
                   eps=float(_one(p.get("eps"), 1e-9)))


@_register("Softmax")
def _softmax(ctx, node, bottoms):
    p = _p(node, "softmax_param")
    x, = bottoms
    ax = _axis(int(_one(p.get("axis"), 1)), x.ndim)
    return jax.nn.softmax(x, axis=ax)


@_register("Flatten")
def _flatten(ctx, node, bottoms):
    p = _p(node, "flatten_param")
    x, = bottoms
    ax = int(_one(p.get("axis"), 1)) % x.ndim
    end = int(_one(p.get("end_axis"), -1)) % x.ndim
    mid = int(math.prod(x.shape[ax:end + 1]))
    return x.reshape(x.shape[:ax] + (mid,) + x.shape[end + 1:])


@_register("Reshape")
def _reshape(ctx, node, bottoms):
    """reshape_layer.cpp: dim 0 copies the bottom dim, -1 infers."""
    p = _p(node, "reshape_param")
    x, = bottoms
    sh = _one(p.get("shape"), {})
    dims = [int(d) for d in _as_list(sh.get("dim"))]
    ax = int(_one(p.get("axis"), 0)) % (x.ndim + 1)
    num_axes = int(_one(p.get("num_axes"), -1))
    end = x.ndim if num_axes == -1 else ax + num_axes
    out = list(x.shape[:ax])
    for i, d in enumerate(dims):
        out.append(x.shape[ax + i] if d == 0 else d)
    out += list(x.shape[end:])
    return x.reshape([d if d != -1 else -1 for d in out])


@_register("Concat")
def _concat(ctx, node, bottoms):
    p = _p(node, "concat_param")
    legacy = _one(p.get("concat_dim"))
    ax = int(_one(p.get("axis"), 1)) if legacy is None else int(legacy)
    return jnp.concatenate(bottoms, axis=_axis(ax, bottoms[0].ndim))


@_register("Slice")
def _slice(ctx, node, bottoms):
    p = _p(node, "slice_param")
    x, = bottoms
    legacy = _one(p.get("slice_dim"))
    ax = int(_one(p.get("axis"), 1)) if legacy is None else int(legacy)
    ax = _axis(ax, x.ndim)
    points = [int(v) for v in _as_list(p.get("slice_point"))]
    if not points:
        n = len(node.tops)
        if x.shape[ax] % n:
            raise ValueError(f"Slice {node.name}: dim {x.shape[ax]} not "
                             f"divisible by {n} tops")
        step = x.shape[ax] // n
        points = [step * i for i in range(1, n)]
    return jnp.split(x, points, axis=ax)


@_register("Eltwise")
def _eltwise(ctx, node, bottoms):
    p = _p(node, "eltwise_param")
    op = _one(p.get("operation"), "SUM")
    if isinstance(op, int):
        op = {0: "prod", 1: "sum", 2: "max"}[op]
    coeffs = [float(c) for c in _as_list(p.get("coeff"))] or None
    return zoo.eltwise(bottoms, operation=str(op).lower(), coeffs=coeffs)


@_register("Tile")
def _tile(ctx, node, bottoms):
    p = _p(node, "tile_param")
    x, = bottoms
    ax = _axis(int(_one(p.get("axis"), 1)), x.ndim)
    reps = [1] * x.ndim
    reps[ax] = int(_one(p.get("tiles")))
    return jnp.tile(x, reps)


@_register("Reduction")
def _reduction(ctx, node, bottoms):
    """reduction_layer.cpp: reduce every TRAILING caffe axis from
    ``axis`` on.  Caffe axes are NCHW; on a 4-D NHWC blob the trailing
    set {a..3} maps through the layout permutation (axis 2 means
    {H, W}, i.e. NHWC axes {1, 2})."""
    p = _p(node, "reduction_param")
    op = _one(p.get("operation"), "SUM")
    if isinstance(op, int):
        op = {1: "sum", 2: "asum", 3: "sumsq", 4: "mean"}[op]
    x = bottoms[0]
    a = int(_one(p.get("axis"), 0)) % max(x.ndim, 1)
    if x.ndim == 4:
        axes = sorted(_axis(c, 4) for c in range(a, 4))
    else:
        axes = range(a, x.ndim)
    return zoo.reduction(x, operation=str(op).lower(), axes=axes,
                         coeff=float(_one(p.get("coeff"), 1.0)))


@_register("ArgMax")
def _argmax(ctx, node, bottoms):
    """argmax_layer.cpp: with axis, top-k replaces that axis (values
    when out_max_val, indices otherwise); without axis, per-row over
    the FLATTENED caffe (NCHW) trailing dims — 4-D blobs permute back
    so index values mean what the reference's do."""
    p = _p(node, "argmax_param")
    x, = bottoms
    ax = _one(p.get("axis"))
    if ax is None and x.ndim == 4:
        x = jnp.transpose(x, (0, 3, 1, 2))  # indices in NCHW flat order
    return zoo.argmax(x, top_k=int(_one(p.get("top_k"), 1)),
                      out_max_val=bool(_one(p.get("out_max_val"), False)),
                      axis=_axis(int(ax), x.ndim) if ax is not None
                      else None)


@_register("BatchReindex")
def _batch_reindex(ctx, node, bottoms):
    return zoo.batch_reindex(bottoms[0], bottoms[1])


@_register("Filter")
def _filter(ctx, node, bottoms):
    """filter_layer.cpp: last bottom is the selector.  XLA needs static
    shapes, so tops are front-COMPACTED full-size arrays; the true row
    count is exposed as blob '<layer>_count' (zoo.filter_rows parity)."""
    *xs, selector = bottoms
    outs, count = zoo.filter_rows(tuple(xs), selector)
    # an extra declared top (beyond caffe's one-per-filtered-bottom)
    # receives the true row count
    return list(outs) + ([count] if len(node.tops) > len(xs) else [])


@_register("Im2col")
def _im2col(ctx, node, bottoms):
    """im2col_layer.cpp exposed as a layer: patch extraction.  Here this
    exists only for graph compatibility — convolution never goes through
    it (ops/conv.py docstring)."""
    p = _p(node, "convolution_param")
    x, = bottoms
    ks = int(_one(p.get("kernel_size"), 0))
    kh = int(_one(p.get("kernel_h"), ks))
    kw = int(_one(p.get("kernel_w"), ks))
    st = int(_one(p.get("stride"), 1))
    pd = int(_one(p.get("pad"), 0))
    return jax.lax.conv_general_dilated_patches(
        x, (kh, kw), window_strides=(st, st), padding=[(pd, pd), (pd, pd)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


@_register("HDF5Output")
def _hdf5_output(ctx, node, bottoms):
    """hdf5_output_layer.cpp writes bottoms to disk per pass — a side
    effect a pure traced graph cannot perform.  The blobs are already in
    apply()'s returned dict; dump them with utils/hdf5_compat outside the
    jit boundary.  In-graph this is Silence."""
    return []


@_register("Crop")
def _crop(ctx, node, bottoms):
    """crop_layer.cpp: crop bottom 0 to bottom 1's shape starting at
    ``offset`` along axes >= ``axis``."""
    p = _p(node, "crop_param")
    x, ref = bottoms
    offsets = [int(v) for v in _as_list(p.get("offset"))] or [0]
    first = int(_one(p.get("axis"), 2)) % x.ndim
    # offsets are declared per caffe (NCHW) axis starting at ``axis``
    # (crop_layer.cpp:30-48; one offset broadcasts to all cropped axes)
    start_by_dim = {}
    for j, a in enumerate(range(first, x.ndim)):
        off = offsets[j] if j < len(offsets) else offsets[0]
        start_by_dim[_axis(a, x.ndim)] = off
    starts = [start_by_dim.get(d, 0) for d in range(x.ndim)]
    sizes = [ref.shape[d] if d in start_by_dim else x.shape[d]
             for d in range(x.ndim)]
    return jax.lax.dynamic_slice(x, starts, sizes)


# -- losses & metrics ------------------------------------------------------

@_register("SoftmaxWithLoss")
def _softmax_loss(ctx, node, bottoms):
    p = _p(node, "loss_param")
    logits, labels = bottoms[0], bottoms[1]
    ig = _one(p.get("ignore_label"))
    return losses_ops.softmax_cross_entropy(
        logits, labels.astype(jnp.int32).reshape(-1),
        ignore_label=None if ig is None else int(ig))


@_register("EuclideanLoss")
def _euclidean_loss(ctx, node, bottoms):
    return losses_ops.euclidean_loss(bottoms[0], bottoms[1])


@_register("HingeLoss")
def _hinge_loss(ctx, node, bottoms):
    p = _p(node, "hinge_loss_param")
    norm = _one(p.get("norm"), "L1")
    if isinstance(norm, int):
        norm = {1: "L1", 2: "L2"}[norm]
    return losses_ops.hinge_loss(bottoms[0],
                                 bottoms[1].astype(jnp.int32).reshape(-1),
                                 norm=str(norm))


@_register("SigmoidCrossEntropyLoss")
def _sce_loss(ctx, node, bottoms):
    return losses_ops.sigmoid_cross_entropy(bottoms[0], bottoms[1])


@_register("ContrastiveLoss")
def _contrastive_loss(ctx, node, bottoms):
    p = _p(node, "contrastive_loss_param")
    return losses_ops.contrastive_loss(
        bottoms[0], bottoms[1], bottoms[2].reshape(-1),
        margin=float(_one(p.get("margin"), 1.0)),
        legacy=bool(_one(p.get("legacy_version"), False)))


@_register("InfogainLoss")
def _infogain_loss(ctx, node, bottoms):
    if len(bottoms) < 3:
        raise ValueError(
            "GraphNet InfogainLoss takes the infogain matrix as a third "
            "bottom (use a Parameter/DummyData layer for a file-sourced "
            "H; binaryproto loading is utils/caffemodel.py's job)")
    return losses_ops.infogain_loss(
        bottoms[0], bottoms[1].astype(jnp.int32).reshape(-1), bottoms[2])


@_register("MultinomialLogisticLoss")
def _mll(ctx, node, bottoms):
    return losses_ops.multinomial_logistic_loss(
        bottoms[0], bottoms[1].astype(jnp.int32).reshape(-1))


@_register("PairRankLoss")
def _pair_rank_loss(ctx, node, bottoms):
    p = _p(node, "pair_rank_loss_param")
    return losses_ops.pair_rank_loss(
        bottoms[0], bottoms[1], bottoms[2],
        margin=float(_one(p.get("margin"), 1.0)))


@_register("Accuracy")
def _accuracy(ctx, node, bottoms):
    p = _p(node, "accuracy_param")
    ig = _one(p.get("ignore_label"))
    return zoo.accuracy(bottoms[0],
                        bottoms[1].astype(jnp.int32).reshape(-1),
                        top_k=int(_one(p.get("top_k"), 1)),
                        ignore_label=None if ig is None else int(ig))


def _pos_scores(prob, fixed_axis: int):
    """MRR/MAP layers read the positive-class column of a (N, 2) prob
    blob (mrr_layer.cpp fixed_axis, default 1)."""
    return prob[:, fixed_axis] if prob.ndim > 1 else prob


@_register("MRR")
def _mrr(ctx, node, bottoms):
    p = _p(node, "mrr_param")
    prob, label, group = bottoms
    s = _pos_scores(prob, int(_one(p.get("fixed_axis"), 1)))
    return ir_metrics.mean_reciprocal_rank_jax(
        s, label.astype(jnp.int32).reshape(-1),
        group.astype(jnp.int32).reshape(-1))


@_register("MAP")
def _map(ctx, node, bottoms):
    p = _p(node, "map_param")
    prob, label, group = bottoms
    s = _pos_scores(prob, int(_one(p.get("fixed_axis"), 1)))
    return ir_metrics.mean_average_precision_jax(
        s, label.astype(jnp.int32).reshape(-1),
        group.astype(jnp.int32).reshape(-1))


@_register("AUC")
def _auc(ctx, node, bottoms):
    p = _p(node, "auc_param")
    prob, label = bottoms[0], bottoms[1]
    s = _pos_scores(prob, 1)
    labels = label.astype(jnp.int32).reshape(-1)
    ig = _one(p.get("ignore_label"))
    valid = None if ig is None else (labels != int(ig))
    return ir_metrics.auc_jax(s, labels, valid=valid)


@_register("RankAccuracy")
def _rank_accuracy(ctx, node, bottoms):
    a, b, label = bottoms
    return ir_metrics.rank_accuracy_jax(a.reshape(-1), b.reshape(-1),
                                        label.reshape(-1))
