"""GraphSolver: the generic ``caffe train --solver=...`` loop.

The reference's primary UX is: write a ``solver.prototxt`` pointing at a
``NetParameter`` prototxt, run ``caffe train`` (tools/caffe.cpp:157-252),
and the Solver drives everything — net construction for both phases
(solver.cpp:InitTrainNet/InitTestNets:87-185), the Step loop with
smoothed-loss display (solver.cpp:193-290, UpdateSmoothedLoss:482-495),
periodic test passes that average every output-blob element over
``test_iter`` batches (solver.cpp:334-404), snapshots of learned weights
+ solver history (solver.cpp:406-457), and restore (solver.cpp:470-481).
The typed-config ``Trainer`` covers the fork's QA recipes; this module
covers the *generality*: any prototxt a reference user has trains here
with the same solver semantics.

JAX-first design, not a Solver translation:

* The net is a ``GraphNet`` — the whole per-iteration computation
  (forward, ``jax.grad`` backward, the solver update, and ``iter_size``
  gradient accumulation via ``lax.scan``) is ONE jitted function; XLA
  fuses across what the reference executes as dozens of per-layer
  kernel launches with explicit diff buffers.
* Data layers declare *inputs* (models/graph_net.py DATA_TYPES); the
  host-side feed is built once per data layer from its prototxt message
  (HDF5Data reads the reference's list-file + chunk layout via
  ``data/hdf5_compat.py``; DummyData generates in-graph; anything else
  accepts caller-provided arrays through ``feeds=``) instead of the
  reference's per-layer prefetch threads (base_data_layer.cpp).
* Test nets share trained layers by layer name — params are dicts keyed
  by layer name, so ``ShareTrainedLayersWith`` (net.cpp:744-768) is a
  dict merge, not blob pointer surgery.

Reproducible resume: the reference does NOT checkpoint data-layer
cursors, so a restored run replays different batches.  Here ``restore``
fast-forwards every feed by ``iter * iter_size`` batches, making
resumed trajectories bit-identical to uninterrupted ones (pinned by
tests) — a strict superset of the reference's behavior.
"""

from __future__ import annotations

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..models.graph_net import DATA_TYPES, GraphNet
from ..utils.prototxt import parse_prototxt, solver_config_from_prototxt
from .optim import learning_rate, make_solver

log = logging.getLogger("mms.graph_solver")


def _as_list(v):
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _pbool(v, default=False):
    """Protobuf text bools: ``true``/``false`` parse to Python bools,
    but ``0``/``1`` are equally legal wire text (and common in
    reference prototxts) and arrive as ints — both must read
    correctly."""
    v = _one(v, default)
    if isinstance(v, str):
        return v.strip().lower() in ("true", "1")
    return bool(v)


def _one(v, default=None):
    if isinstance(v, list):
        return v[-1] if v else default
    return default if v is None else v


def _read(path_or_text: str) -> str:
    """Accept a path or raw prototxt text (text contains a newline or
    brace; filenames don't)."""
    if os.path.exists(path_or_text):
        with open(path_or_text) as f:
            return f.read()
    if "{" in path_or_text or "\n" in path_or_text:
        return path_or_text
    raise FileNotFoundError(path_or_text)


class _Feed:
    """Host-side batch source for one data layer: each ``next()`` yields
    {top: array} for the layer's tops."""

    def __init__(self, it, tops):
        self.it = it
        self.tops = tops

    def __next__(self):
        batch = next(self.it)
        return {t: batch[t] for t in self.tops}

    def skip(self, n: int):
        for _ in range(n):
            next(self.it)


def _build_feed(node_cfg: dict, phase: str, seed: int, base_dir: str,
                feeds: dict | None):
    """One data layer -> _Feed or None (in-graph DummyData).

    HDF5Data maps each top to the equally-named dataset across the
    source list's chunk files (hdf5_data_layer.cpp:30-83); shuffle is
    epoch-wise like the layer's ``shuffle: true``.  Everything else
    (Data/ImageData/MemoryData/Input/...) must arrive via ``feeds=``
    {layer_name: {top: array, ...}, "batch_size": n} — the reference
    binds those sources inside the layer; here the host pipeline is the
    caller's (SURVEY §7's decoupling stance).
    """
    from ..data.loader import ArrayDataset, BatchIterator

    t = str(node_cfg.get("type", ""))
    name = str(node_cfg.get("name", ""))
    tops = [str(s) for s in _as_list(node_cfg.get("top"))]
    if t == "DummyData":
        return None
    if feeds and name in feeds:
        spec = dict(feeds[name])
        bs = int(spec.pop("batch_size", 0))
        shuffle = bool(spec.pop("shuffle", phase == "train"))
        ds = ArrayDataset(spec)
        it = BatchIterator(ds, bs or len(ds), seed=seed, shuffle=shuffle)
        return _Feed(it, tops)
    if t == "HDF5Data":
        from ..data.hdf5_compat import load_hdf5_list

        p = _one(node_cfg.get("hdf5_data_param"), {}) or {}
        source = _one(p.get("source"))
        if source is None:
            raise ValueError(f"HDF5Data layer {name!r} has no source")
        if not os.path.isabs(source):
            cand = os.path.join(base_dir, source)
            source = cand if os.path.exists(cand) else source
        arrays = load_hdf5_list(source)
        missing = [top for top in tops if top not in arrays]
        if missing:
            raise KeyError(f"HDF5Data {name!r}: datasets {missing} not in "
                           f"{source} (tops read equally-named datasets)")
        bs = int(_one(p.get("batch_size"), 1))
        shuffle = _pbool(p.get("shuffle"))
        ds = ArrayDataset({top: arrays[top] for top in tops})
        return _Feed(BatchIterator(ds, bs, seed=seed, shuffle=shuffle), tops)
    if t in ("ImageData", "PairImageData"):
        from ..data.pair_image import ImageListDataset, PairImageDataset

        pkey = ("image_data_param" if t == "ImageData"
                else "pair_image_data_param")
        p = _one(node_cfg.get(pkey), {}) or {}
        tf = _one(node_cfg.get("transform_param"), {}) or {}
        source = _one(p.get("source"))
        if source is None:
            raise ValueError(f"{t} layer {name!r} has no source")
        if not os.path.isabs(source):
            cand = os.path.join(base_dir, source)
            source = cand if os.path.exists(cand) else source
        root = str(_one(p.get("root_folder"), "")) or os.path.dirname(source)
        mv = _as_list(tf.get("mean_value")) or None
        mf = _one(tf.get("mean_file"))
        if mv is not None and mf:
            # data_transformer.cpp:25-28 CHECKs exactly this exclusivity
            raise ValueError(f"{t} layer {name!r}: transform_param sets "
                             f"both mean_file and mean_value")
        mean = None if mv is None else np.asarray(mv, np.float32)
        if mf:
            from ..data.pair_image import load_mean_hwc

            mf = str(mf)
            if not os.path.isabs(mf):
                cand = os.path.join(base_dir, mf)
                mf = cand if os.path.exists(cand) else mf
            mean = load_mean_hwc(mf)
        kw = dict(
            root=root, seed=seed,
            shuffle=_pbool(p.get("shuffle")),
            rand_skip=int(_one(p.get("rand_skip"), 0)),
            new_height=int(_one(p.get("new_height"), 0)),
            new_width=int(_one(p.get("new_width"), 0)),
            # TransformationParameter wins over the layer's deprecated
            # copies (data_transformer.cpp owns these knobs)
            scale=float(_one(tf.get("scale"), _one(p.get("scale"), 1.0))),
            mean=mean,
            crop_size=int(_one(tf.get("crop_size"),
                               _one(p.get("crop_size"), 0))),
            mirror=_pbool(tf.get("mirror"), _pbool(p.get("mirror"))),
            train=phase == "train")
        bs = int(_one(p.get("batch_size"), 1))
        if t == "ImageData":
            kw["is_color"] = _pbool(p.get("is_color"), True)
            ds = ImageListDataset(source, bs, **kw)

            def gen(ds=ds, tops=tops):
                for b in ds:
                    yield {tops[0]: b["data"], tops[1]: b["label"]}
        else:
            ds = PairImageDataset(source, bs, **kw)

            def gen(ds=ds, tops=tops):
                for b in ds:
                    # the layer stacks the pair on the channel axis
                    # (pair_image_data_layer.cpp:26-178); NHWC here
                    yield {tops[0]: np.concatenate([b["img1"], b["img2"]],
                                                   axis=-1),
                           tops[1]: b["label"]}
        return _Feed(gen(), tops)
    if t == "WindowData":
        from ..data.window_data import WindowListDataset

        p = _one(node_cfg.get("window_data_param"), {}) or {}
        tf = _one(node_cfg.get("transform_param"), {}) or {}
        source = _one(p.get("source"))
        if source is None:
            raise ValueError(f"WindowData layer {name!r} has no source")
        if not os.path.isabs(source):
            cand = os.path.join(base_dir, source)
            source = cand if os.path.exists(cand) else source
        mean = None
        mv = _as_list(tf.get("mean_value"))
        mf = _one(tf.get("mean_file"))
        if mv and mf:
            raise ValueError(f"WindowData layer {name!r}: transform_param "
                             f"sets both mean_file and mean_value")
        if mv:
            mean = np.asarray(mv, np.float32)
        elif mf:
            from ..data.pair_image import load_mean_hwc

            mf = str(mf)
            if not os.path.isabs(mf):
                cand = os.path.join(base_dir, mf)
                mf = cand if os.path.exists(cand) else mf
            mean = load_mean_hwc(mf)
        ds = WindowListDataset(
            source, int(_one(p.get("batch_size"), 1)),
            crop_size=int(_one(tf.get("crop_size"), 0)),
            root=str(_one(p.get("root_folder"), "")),
            fg_threshold=float(_one(p.get("fg_threshold"), 0.5)),
            bg_threshold=float(_one(p.get("bg_threshold"), 0.5)),
            fg_fraction=float(_one(p.get("fg_fraction"), 0.25)),
            context_pad=int(_one(p.get("context_pad"), 0)),
            crop_mode=str(_one(p.get("crop_mode"), "warp")),
            mirror=_pbool(tf.get("mirror")),
            mean=mean,
            scale=float(_one(p.get("scale"), 1.0)),
            cache_images=_pbool(p.get("cache_images")),
            seed=seed)

        def gen(ds=ds, tops=tops):
            for b in ds:
                yield {tops[0]: b["data"], tops[1]: b["label"]}
        return _Feed(gen(), tops)
    if t == "Data":
        from ..data.lmdb_data import open_datum_dataset

        p = _one(node_cfg.get("data_param"), {}) or {}
        tf = _one(node_cfg.get("transform_param"), {}) or {}
        source = _one(p.get("source"))
        if source is None:
            raise ValueError(f"Data layer {name!r} has no source")
        if not os.path.isabs(source):
            cand = os.path.join(base_dir, source)
            source = cand if os.path.exists(cand) else source
        # backend declarations may be names or wire enum ints
        # (caffe.proto DataParameter.DB: LEVELDB=0, LMDB=1); the actual
        # reader is sniffed from the artifact (data.mdb vs CURRENT) like
        # db.cpp:41 GetDB — both paths are native here
        # (utils/lmdb_io.py, utils/leveldb_io.py)
        has_mdb = os.path.exists(
            source if source.endswith(".mdb")
            else os.path.join(source, "data.mdb"))
        has_current = os.path.exists(os.path.join(source, "CURRENT"))
        if not has_mdb and not has_current:
            raise ValueError(
                f"Data layer {name!r}: {source!r} is neither an LMDB "
                f"environment (data.mdb) nor a LevelDB directory "
                f"(CURRENT)")
        mean = None
        mv = _as_list(tf.get("mean_value"))
        mf = _one(tf.get("mean_file"), _one(p.get("mean_file")))
        if mv and mf:
            raise ValueError(f"Data layer {name!r}: transform_param sets "
                             f"both mean_file and mean_value")
        if mv:
            mean = np.asarray(mv, np.float32)
        elif mf:
            from ..data.pair_image import load_mean_hwc

            mf = str(mf)
            if not os.path.isabs(mf):
                cand = os.path.join(base_dir, mf)
                mf = cand if os.path.exists(cand) else mf
            mean = load_mean_hwc(mf)
        ds = open_datum_dataset(
            source, int(_one(p.get("batch_size"), 1)),
            scale=float(_one(tf.get("scale"), _one(p.get("scale"), 1.0))),
            mean=mean,
            crop_size=int(_one(tf.get("crop_size"),
                               _one(p.get("crop_size"), 0))),
            mirror=_pbool(tf.get("mirror"), _pbool(p.get("mirror"))),
            rand_skip=int(_one(p.get("rand_skip"), 0)),
            train=phase == "train", seed=seed)

        def gen(ds=ds, tops=tops):
            for b in ds:
                yield {tops[0]: b["data"], tops[1]: b["label"]}
        return _Feed(gen(), tops)
    raise ValueError(
        f"data layer {name!r} (type {t}) needs a feeds= entry: "
        f"feeds={{{name!r}: {{top: array, ..., 'batch_size': n}}}} — only "
        f"Data (LMDB), HDF5Data, ImageData, PairImageData, WindowData "
        f"and DummyData sources are read from the prototxt")


class GraphSolver:
    """Drive any prototxt net through the reference solver loop.

    >>> gs = GraphSolver("solver.prototxt")
    >>> gs.solve()                       # caffe train --solver=...
    >>> gs.test()                        # one TestAll pass
    >>> gs.restore("x.solverstate.h5")   # caffe train --snapshot=...
    >>> gs.copy_weights("w.caffemodel")  # caffe train --weights=...
    """

    def __init__(self, solver: str, *, base_dir: str | None = None,
                 feeds: dict | None = None, seed: int = 0,
                 on_display=None, mesh=None):
        text = _read(solver)
        self.base_dir = base_dir or (
            os.path.dirname(os.path.abspath(solver))
            if os.path.exists(solver) else ".")
        d = parse_prototxt(text)
        self.cfg, self.extras = solver_config_from_prototxt(text)
        self.raw = d
        self.test_interval = int(_one(d.get("test_interval"), 0))
        self.test_iters = [int(v) for v in _as_list(d.get("test_iter"))]
        self.test_initialization = _one(d.get("test_initialization"), True)
        if isinstance(self.test_initialization, str):
            self.test_initialization = (
                self.test_initialization.lower() == "true")
        self.average_loss = int(_one(d.get("average_loss"), 1))
        self.display = int(_one(d.get("display"), 0))
        self.snapshot_every = int(_one(d.get("snapshot"), 0))
        self.snapshot_prefix = _one(d.get("snapshot_prefix"), "graph")
        fmt = str(_one(d.get("snapshot_format"), "BINARYPROTO")).upper()
        self.snapshot_h5 = fmt == "HDF5"
        sat = _one(d.get("snapshot_after_train"), True)
        self.snapshot_after_train = (str(sat).lower() == "true"
                                     if isinstance(sat, str) else bool(sat))
        self.max_iter = int(_one(d.get("max_iter"), 0))
        rs = _one(d.get("random_seed"))
        self.seed = int(rs) if rs is not None else seed
        self.on_display = on_display
        self.mesh = mesh  # data-parallel over the mesh's 'dp' axis

        # -- nets (solver.cpp:87-185 field precedence) --------------------
        train_src, test_srcs = self._net_sources(d)
        self.net = GraphNet(train_src, phase="train")
        self.test_nets = [GraphNet(s, phase="test") for s in test_srcs]
        if self.test_nets and len(self.test_iters) < len(self.test_nets):
            raise ValueError(
                f"{len(self.test_nets)} test nets need test_iter each "
                f"(solver.cpp:106-109); got {self.test_iters}")

        # -- feeds ---------------------------------------------------------
        self._user_feeds = feeds  # retained: restore() rebuilds from 0
        self._feeds = self._phase_feeds(self.net, "train", feeds)
        self._test_feeds = [self._phase_feeds(n, "test", feeds, salt=i + 1)
                            for i, n in enumerate(self.test_nets)]

        # -- init ----------------------------------------------------------
        key = jax.random.PRNGKey(self.seed)
        example = self._next_batch(self._feeds)
        self.params, self.state = self.net.init(key, example)
        self.solver = make_solver(self.cfg, self.net.param_spec(self.params))
        self.opt_state = self.solver.init(self.params)
        self._test_shadow = []  # params/state of test-only layers
        for i, tnet in enumerate(self.test_nets):
            ex = self._next_batch(self._test_feeds[i])
            p, s = tnet.init(jax.random.fold_in(key, 100 + i), ex)
            self._test_shadow.append((p, s))
        # init consumed batches for shape inference; caffe's setup only
        # PEEKS at the prefetch queue (base_data_layer.cpp), so iteration
        # 0 trains on batch 0 — rebuild the feeds to restore that
        self._feeds = self._phase_feeds(self.net, "train", feeds)
        self._test_feeds = [self._phase_feeds(n, "test", feeds, salt=i + 1)
                            for i, n in enumerate(self.test_nets)]
        self.iter_ = 0
        self._losses: list[float] = []
        self._smoothed = 0.0
        self._start_iter = 0
        self.history: list[dict] = []
        self.last_outs: dict = {}  # train-net output blobs of last step
        # Solver::Callback pairs (solver.hpp:78-89): fired on the host
        # around each fused device step — on_start before the dispatch
        # (solver.cpp:215), on_gradients_ready after it (solver.cpp:251;
        # the parameter update happens INSIDE the fused step here, so
        # "gradients ready" and "applied" coincide at the host boundary)
        self.callbacks: list = []
        self._early_exit = False
        self._step_fn = None
        self._test_fns = {}

    # ------------------------------------------------------------------
    def _net_sources(self, d):
        def load_net(v):
            if isinstance(v, dict):
                return v
            path = str(v)
            if not os.path.isabs(path):
                path = os.path.join(self.base_dir, path)
            with open(path) as f:
                return f.read()

        train = None
        for field in ("train_net_param", "train_net", "net_param", "net"):
            if field in d:
                train = load_net(_one(d.get(field)))
                break
        if train is None:
            raise ValueError("solver prototxt names no net "
                             "(net/train_net/net_param/train_net_param)")
        tests = [load_net(v) for v in _as_list(d.get("test_net_param"))]
        tests += [load_net(v) for v in _as_list(d.get("test_net"))]
        if not tests and ("net" in d or "net_param" in d) \
                and (self.test_interval or self.test_iters):
            # the generic net serves as its own test net, phase-filtered
            # (solver.cpp:140-151)
            tests.append(load_net(_one(d.get("net_param", d.get("net")))))
        return train, tests

    def _phase_feeds(self, net, phase, feeds, *, salt=0):
        out = []
        for node in net.layers:
            if node.type in DATA_TYPES:
                f = _build_feed(node.cfg, phase, self.seed + salt,
                                self.base_dir, feeds)
                if f is not None:
                    out.append(f)
        return out

    def _next_batch(self, feed_list):
        """Merge every data layer's next batch into one inputs dict."""
        batch = {}
        for f in feed_list:
            batch.update(next(f))
        return {k: jnp.asarray(v) for k, v in batch.items()}

    # ------------------------------------------------------------------
    def _build_step(self):
        net, solver, iter_size = self.net, self.solver, self.cfg.iter_size

        def one_grad(params, state, batch, rng):
            (loss, (blobs, new_state)), grads = jax.value_and_grad(
                net.loss, has_aux=True)(params, state, batch, rng=rng)
            outs = {t: blobs[t] for t in net.output_blob_names()}
            return loss, grads, new_state, outs

        if iter_size == 1:
            def step(params, state, opt_state, it, batch, rng):
                loss, grads, state, outs = one_grad(params, state, batch,
                                                    rng)
                params, opt_state = solver.apply(params, grads, opt_state,
                                                 it)
                return params, state, opt_state, loss, outs
        else:
            def step(params, state, opt_state, it, batches, rng):
                # grads accumulate over iter_size micro-batches; the
                # solver divides by iter_size (optim.py step 3), matching
                # Net::ForwardBackward x iter_size + Normalize
                def body(carry, xs):
                    state, acc, total = carry
                    batch, i = xs
                    loss, grads, state, outs = one_grad(
                        params, state, batch, jax.random.fold_in(rng, i))
                    acc = jax.tree.map(jnp.add, acc, grads)
                    return (state, acc, total + loss), outs

                zeros = jax.tree.map(jnp.zeros_like, params)
                (state, grads, total), outs = jax.lax.scan(
                    body, (state, zeros, jnp.zeros((), jnp.float32)),
                    (batches, jnp.arange(iter_size)))
                params, opt_state = solver.apply(params, grads, opt_state,
                                                 it)
                outs = {k: v[-1] for k, v in outs.items()}
                return params, state, opt_state, total / iter_size, outs

        if self.mesh is None:
            return jax.jit(step, donate_argnums=(0, 1, 2))
        # -- data-parallel over the mesh (P2PSync's role, parallel.cpp) --
        # params/state/opt replicated, batch split over 'dp'; XLA inserts
        # the gradient all-reduce where the shardings demand it.  The key
        # is replicated and iter-folded, so the trajectory is
        # bit-comparable across mesh layouts (tests pin 1-vs-N).
        from jax.sharding import NamedSharding, PartitionSpec as P

        rep = NamedSharding(self.mesh, P())
        batch_ax = P("dp") if iter_size == 1 else P(None, "dp")
        batch_sh = NamedSharding(self.mesh, batch_ax)
        tree_rep = lambda t: jax.tree.map(lambda _: rep, t)  # noqa: E731
        return jax.jit(
            step,
            in_shardings=(tree_rep(self.params), tree_rep(self.state),
                          tree_rep(self.opt_state), None,
                          batch_sh, rep),  # prefix: every batch leaf
            out_shardings=(tree_rep(self.params), tree_rep(self.state),
                           tree_rep(self.opt_state), None, None),
            donate_argnums=(0, 1, 2))

    def _pull_train_batch(self):
        if self.cfg.iter_size == 1:
            return self._next_batch(self._feeds)
        micro = [self._next_batch(self._feeds)
                 for _ in range(self.cfg.iter_size)]
        return {k: jnp.stack([m[k] for m in micro]) for k in micro[0]}

    # ------------------------------------------------------------------
    def step(self, iters: int, *, action_fn=None):
        """Solver::Step (solver.cpp:193-290).  ``action_fn`` is the
        SolverAction poll (signal_handler.cpp via caffe.cpp:44-49):
        return Action.SNAPSHOT to checkpoint-and-continue, Action.STOP
        to checkpoint-and-break — polled once per iteration like
        solver.cpp:259-272."""
        from .signals import Action

        if self._step_fn is None:
            self._step_fn = self._build_step()
        stop = self.iter_ + iters
        self._losses.clear()
        self._smoothed = 0.0
        self._start_iter = self.iter_
        key = jax.random.PRNGKey(self.seed ^ 0x5EED)
        while self.iter_ < stop:
            if action_fn is not None:
                act = action_fn()
                if act == Action.SNAPSHOT:
                    self.snapshot()
                elif act == Action.STOP:
                    # solver.cpp:262-271: STOP breaks WITHOUT its own
                    # snapshot; Solve's snapshot_after_train covers it
                    log.info("Optimization stopped early (signal).")
                    self._early_exit = True
                    break
            if (self.test_interval
                    and self.iter_ % self.test_interval == 0
                    and (self.iter_ > 0 or self.test_initialization)):
                self.test_all()
            for cb in self.callbacks:
                cb[0]()  # on_start
            batch = self._pull_train_batch()
            rng = jax.random.fold_in(key, self.iter_)
            (self.params, self.state, self.opt_state, loss,
             outs) = self._step_fn(self.params, self.state, self.opt_state,
                                   self.iter_, batch, rng)
            self._update_smoothed(float(loss))
            self.last_outs = outs
            for cb in self.callbacks:
                cb[1]()  # on_gradients_ready
            if self.display and self.iter_ % self.display == 0:
                self._display_outputs("Train", outs)
                # sgd_solver.cpp:105's companion line; parse_log reads it
                log.info("Iteration %d, lr = %g", self.iter_,
                         learning_rate(self.cfg, self.iter_))
            self.iter_ += 1
            if (self.snapshot_every
                    and self.iter_ % self.snapshot_every == 0):
                self.snapshot()
        return self._smoothed

    def solve(self, *, action_fn=None):
        """Solver::Solve via caffe.cpp train(): run to max_iter, final
        snapshot, final test pass (solver.cpp:293-324); an early exit
        (STOP action) snapshots via snapshot_after_train and skips the
        final display/test, like solver.cpp:304-310."""
        self._early_exit = False
        self.step(self.max_iter - self.iter_, action_fn=action_fn)
        if self.snapshot_after_train and (
                self._early_exit
                or not self.snapshot_every
                or self.iter_ % self.snapshot_every != 0):
            self.snapshot()
        if self._early_exit:
            return self._smoothed
        if self.display:
            log.info("Iteration %d, loss = %g", self.iter_, self._smoothed)
        if self.test_interval and self.iter_ % self.test_interval == 0:
            self.test_all()
        return self._smoothed

    def _update_smoothed(self, loss):
        """UpdateSmoothedLoss (solver.cpp:482-495)."""
        if len(self._losses) < self.average_loss:
            self._losses.append(loss)
            n = len(self._losses)
            self._smoothed = (self._smoothed * (n - 1) + loss) / n
        else:
            idx = (self.iter_ - self._start_iter) % self.average_loss
            self._smoothed += (loss - self._losses[idx]) / self.average_loss
            self._losses[idx] = loss

    def _display_outputs(self, tag, outs, *, weights=None, net=None,
                         log_tag=None):
        """``tag`` keys the history record; ``log_tag`` (default = tag)
        is what the LOG LINE says — test passes "Test" so the output
        lines match caffe's `Test net output #k:` shape byte-for-byte
        (solver.cpp:397) and tools/extra/parse_log regexes apply."""
        net = net or self.net
        weights = weights if weights is not None else net.blob_loss_weights()
        log.info("Iteration %d, loss = %g", self.iter_, self._smoothed)
        rec = {"iter": self.iter_, "loss": self._smoothed, "phase": tag}
        score = 0
        for name in outs:
            vec = np.ravel(np.asarray(outs[name]))
            w = weights.get(name, 0.0)
            for v in vec:
                msg = (f"    {log_tag or tag} net output #{score}: "
                       f"{name} = {v}")
                if w:
                    msg += f" (* {w} = {w * v} loss)"
                log.info("%s", msg)
                score += 1
            rec[name] = float(vec[0]) if vec.size == 1 else vec
        self.history.append(rec)
        if self.on_display:
            self.on_display(rec)
        return rec

    # ------------------------------------------------------------------
    def _shared_test_trees(self, i):
        """ShareTrainedLayersWith by layer name (net.cpp:744-768): the
        train net's params/state win wherever names match."""
        shadow_p, shadow_s = self._test_shadow[i]
        p = {**shadow_p, **self.params}
        s = {**shadow_s, **self.state}
        return p, s

    def test_all(self):
        return [self.test(i) for i in range(len(self.test_nets))]

    def test(self, test_net_id: int = 0):
        """Solver::Test (solver.cpp:334-404): average every output-blob
        element over test_iter batches; returns {blob: mean array}."""
        i = test_net_id
        tnet = self.test_nets[i]
        if i not in self._test_fns:
            outs_names = tnet.output_blob_names()

            @jax.jit
            def fwd(p, s, batch, rng):
                # rng: stochastic layers run at test too where the
                # reference's would (non-constant DummyData fillers
                # refill every Forward, dummy_data_layer.cpp:72-90;
                # Dropout itself is a train-phase no-op inside apply)
                blobs, _ = tnet.apply(p, s, batch, train=False, rng=rng)
                return {t: blobs[t].astype(jnp.float32)
                        for t in outs_names}

            self._test_fns[i] = fwd
        p, s = self._shared_test_trees(i)
        total = None
        n = self.test_iters[i] if i < len(self.test_iters) else 1
        tkey = jax.random.fold_in(
            jax.random.PRNGKey(self.seed ^ 0x7E57), self.iter_ * 131 + i)
        for t_i in range(n):
            batch = self._next_batch(self._test_feeds[i])
            out = self._test_fns[i](p, s, batch,
                                    jax.random.fold_in(tkey, t_i))
            total = out if total is None else jax.tree.map(jnp.add, total,
                                                           out)
        mean = {k: np.asarray(v) / n for k, v in total.items()}
        # solver.cpp:330's announce line, so the log parses like caffe's
        log.info("Iteration %d, Testing net (#%d)", self.iter_, i)
        self._display_outputs(f"Test#{i}", mean, net=tnet,
                              weights=tnet.blob_loss_weights(),
                              log_tag="Test")
        return mean

    # ------------------------------------------------------------------
    def _snapshot_name(self, ext):
        base = os.path.join(self.base_dir, self.snapshot_prefix) \
            if not os.path.isabs(str(self.snapshot_prefix)) \
            else self.snapshot_prefix
        return f"{base}_iter_{self.iter_}{ext}"

    def snapshot(self):
        """Solver::Snapshot: learned net + solver state, named
        ``{prefix}_iter_{N}`` (solver.cpp:406-457), in the solver's
        snapshot_format."""
        from ..utils.caffemodel import (save_caffemodel_binaryproto,
                                        save_caffemodel_h5,
                                        save_solverstate_binaryproto,
                                        save_solverstate_h5)

        specs = self.net.caffemodel_specs(self.params, self.state)
        if self.snapshot_h5:
            model = self._snapshot_name(".caffemodel.h5")
            save_caffemodel_h5(model, self.params, self.state, specs=specs)
            st = self._snapshot_name(".solverstate.h5")
            save_solverstate_h5(st, self.params, self.state, self.opt_state,
                                self.iter_,
                                learned_net=os.path.basename(model),
                                specs=specs)
        else:
            model = self._snapshot_name(".caffemodel")
            save_caffemodel_binaryproto(model, self.params, self.state,
                                        specs=specs)
            st = self._snapshot_name(".solverstate")
            save_solverstate_binaryproto(st, self.params, self.state,
                                         self.opt_state, self.iter_,
                                         learned_net=os.path.basename(model),
                                         specs=specs)
        log.info("Snapshotting to %s", model)
        return model, st

    def restore(self, solverstate_path: str):
        """caffe train --snapshot=... (Solver::Restore:470-481): solver
        history + iter from the state file, learned weights from its
        ``learned_net``; feeds fast-forward so the batch stream continues
        where the snapshotted run left off (see module docstring)."""
        from ..utils.caffemodel import load_solverstate

        specs = self.net.caffemodel_specs(self.params, self.state)
        (self.opt_state, it, _cur, learned,
         _rep) = load_solverstate(solverstate_path, self.params, self.state,
                                  self.opt_state, specs=specs)
        self.iter_ = int(it)
        if learned:
            path = learned if os.path.isabs(learned) else os.path.join(
                os.path.dirname(os.path.abspath(solverstate_path)), learned)
            self.copy_weights(path)
        # rebuild EVERY feed from position 0 (restore may be called on a
        # solver that has already stepped — skipping from the current
        # position would double-advance), then fast-forward to the
        # snapshot's exact stream positions: train feeds by consumed
        # batches, test feeds by test passes already run (snapshots fire
        # AFTER the iter increments, so the pass at iter_ itself has not
        # run yet — it replays after restore, like the uninterrupted run)
        self._feeds = self._phase_feeds(self.net, "train", self._user_feeds)
        self._test_feeds = [
            self._phase_feeds(n, "test", self._user_feeds, salt=i + 1)
            for i, n in enumerate(self.test_nets)]
        for f in self._feeds:
            f.skip(self.iter_ * self.cfg.iter_size)
        if self.test_interval and self.iter_ >= 1:
            passes = (self.iter_ - 1) // self.test_interval \
                + (1 if self.test_initialization else 0)
            for tid, tfeeds in enumerate(self._test_feeds):
                ti = self.test_iters[tid] if tid < len(self.test_iters) \
                    else 0
                for f in tfeeds:
                    f.skip(passes * ti)
        return self.iter_

    def copy_weights(self, caffemodel_path: str):
        """caffe train --weights=... (CopyTrainedLayersFrom, by layer
        name; magic-dispatched like Solver::Restore)."""
        from ..utils.caffemodel import (load_caffemodel_binaryproto,
                                        load_caffemodel_h5)

        specs = self.net.caffemodel_specs(self.params, self.state)
        with open(caffemodel_path, "rb") as f:
            is_h5 = f.read(4) == b"\x89HDF"
        loader = load_caffemodel_h5 if is_h5 else load_caffemodel_binaryproto
        self.params, self.state, report = loader(
            caffemodel_path, self.params, self.state, specs=specs)
        return report
