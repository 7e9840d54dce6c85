"""Training loop: the Solver::Solve/Step + driver-script replacement.

Reproduces the control flow of the reference's hot loop (solver.cpp:194-323)
and of the QA driver (do_trec_qa_clean.py:782-845):

* jitted train step = forward + backward + solver update in ONE compiled
  XLA program (vs. the reference's per-layer host loop) -- on a mesh this is
  where data-parallel gradient psum happens, replacing P2PSync entirely
* eval every ``test_interval`` steps over full splits with the in-graph
  MAP/MRR/AUC metrics (metrics-as-net-outputs, do_trec_qa_clean.py:817-824)
* epoch-granular early stopping with patience on dev MAP
  (do_trec_qa_clean.py:826-838, including its quirk of counting the first
  epoch boundary immediately because ``epoch`` starts at -1)
* snapshot every ``snapshot_interval`` to <dir>/qa_iter_<N>/ and final
  scoring of the best-dev-MAP snapshot (do_trec_qa_clean.py:840)
* deterministic per-epoch reshuffling of the training set, the
  HDF5DataLayer shuffle equivalent (hdf5_data_layer.cpp:55-68) driven by a
  seeded PRNG chain instead of global RNG state.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..metrics import (
    auc_jax,
    auc_jax_sorted,
    mean_average_precision_jax,
    mean_average_precision_jax_sorted,
    mean_reciprocal_rank_jax,
    mean_reciprocal_rank_jax_sorted,
)

# above this eval-split size the O(N^2) pairwise-rank metrics give way to
# the O(N log N) sorted forms (identical numerics, same tie rule)
_SORTED_METRICS_THRESHOLD = 2048
from ..models.mms_qa import MMSQAConfig, mms_qa_apply, mms_qa_init, param_spec
from .checkpoint import (
    CKPT_FILE,
    latest_checkpoint,
    load_checkpoint,
    load_weights_into,
    save_checkpoint,
)
from .optim import SolverConfig, make_solver

log = logging.getLogger("mms.trainer")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Driver-script hyperparameters (do_trec_qa_clean.py:48-73)."""
    solver: SolverConfig = SolverConfig()
    max_iter: int = 40001
    batch_size: int = 50
    test_interval: int = 100
    snapshot_interval: int = 100
    display: int = 50
    train_loss_record_interval: int = 20
    early_stop_patience: int = 5      # epochs without dev-MAP improvement
    seed: int = 22
    snapshot_dir: str | None = None
    snapshot_prefix: str = "qa"


class Trainer:
    """Couples a model config with a solver into jitted train/eval steps.

    ``mesh``: optional jax.sharding.Mesh with a 'dp' axis.  When given,
    batches are sharded over 'dp' and parameters replicated -- XLA inserts
    the gradient all-reduce (the P2PSync tree, done right).
    """

    def __init__(self, model_cfg: MMSQAConfig, cfg: TrainerConfig,
                 *, mesh=None, apply_fn: Callable = mms_qa_apply,
                 init_fn: Callable = mms_qa_init, donate: bool = True):
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.mesh = mesh
        self.apply_fn = apply_fn
        self.init_fn = init_fn
        self.donate = donate  # False keeps step inputs alive (benchmarking)
        self.solver = None  # built in init() when the spec exists
        self._build_steps()

    # ------------------------------------------------------------------ init
    def init(self, *, pretrained=None):
        key = jax.random.PRNGKey(self.cfg.seed)
        params, state = self.init_fn(key, self.model_cfg,
                                     pretrained=pretrained)
        self.solver = make_solver(self.cfg.solver,
                                  param_spec(params, self.model_cfg))
        opt_state = self.solver.init(params)
        if self.mesh is not None:
            replicated = jax.sharding.NamedSharding(
                self.mesh, jax.sharding.PartitionSpec())
            params, state, opt_state = jax.device_put(
                (params, state, opt_state), replicated)
        return params, state, opt_state

    # ----------------------------------------------------------------- steps
    def _build_steps(self):
        model_cfg, cfg = self.model_cfg, self.cfg

        iter_size = cfg.solver.iter_size

        def train_step(params, state, opt_state, batch, step, rng):
            def loss_and_grads(state_in, batch_i, rng_i):
                def loss_fn(p):
                    out, new_state = self.apply_fn(p, state_in, batch_i,
                                                   model_cfg, train=True,
                                                   rng=rng_i)
                    return out["loss"], new_state

                return jax.value_and_grad(loss_fn, has_aux=True)(params)

            if iter_size == 1:
                (loss, new_state), grads = loss_and_grads(state, batch, rng)
            else:
                # gradient accumulation over iter_size micro-batches
                # (solver.cpp:221-223); the solver's Normalize divides the
                # summed gradient by iter_size.  BN state threads through
                # the micro-steps sequentially, as the reference's repeated
                # Forward calls do.
                def body(carry, xs):
                    state_c, acc = carry
                    batch_i, i = xs
                    (loss_i, state_n), g = loss_and_grads(
                        state_c, batch_i, jax.random.fold_in(rng, i))
                    acc = jax.tree.map(jnp.add, acc, g)
                    return (state_n, acc), loss_i

                zero = jax.tree.map(jnp.zeros_like, params)
                (new_state, grads), losses = jax.lax.scan(
                    body, (state, zero),
                    (batch, jnp.arange(iter_size)))
                loss = jnp.mean(losses)
            params, opt_state = self.solver.apply(params, grads, opt_state,
                                                  step)
            return params, new_state, opt_state, loss

        def eval_step(params, state, batch):
            out, _ = self.apply_fn(params, state, batch, model_cfg,
                                   train=False)
            scores = out["prob"][:, 1]
            labels = batch["label"]
            res = {"prob": out["prob"], "loss": out.get("loss")}
            big = scores.shape[0] > _SORTED_METRICS_THRESHOLD
            if "group" in batch:
                groups = batch["group"].astype(jnp.int32)
                map_fn = mean_average_precision_jax_sorted if big \
                    else mean_average_precision_jax
                mrr_fn = mean_reciprocal_rank_jax_sorted if big \
                    else mean_reciprocal_rank_jax
                res["map"] = map_fn(scores, labels, groups)
                res["mrr"] = mrr_fn(scores, labels, groups)
            res["auc"] = (auc_jax_sorted if big else auc_jax)(scores, labels)
            return res

        self._train_step_fn = train_step   # unjitted: scan_train_steps
        self._scan_steps_jit = None        # built lazily on first use
        donate = (0, 2) if self.donate else ()  # params/opt reused in place
        if self.mesh is not None:
            # iter_size > 1 batches carry a LEADING micro-batch axis:
            # the SAMPLE axis is the one that shards over dp
            bspec = jax.sharding.PartitionSpec("dp") if iter_size == 1 \
                else jax.sharding.PartitionSpec(None, "dp")
            dp = jax.sharding.NamedSharding(self.mesh, bspec)
            rep = jax.sharding.NamedSharding(
                self.mesh, jax.sharding.PartitionSpec())
            self._train_step = jax.jit(
                train_step,
                in_shardings=(rep, rep, rep, dp, None, None),
                donate_argnums=donate)
            # eval splits have any size: shard the rows over dp when they
            # divide evenly, else replicate them
            eval_sharded = jax.jit(
                eval_step,
                in_shardings=(rep, rep, jax.sharding.NamedSharding(
                    self.mesh, jax.sharding.PartitionSpec("dp"))))
            eval_replicated = jax.jit(eval_step,
                                      in_shardings=(rep, rep, rep))
            n_dp = self.mesh.shape["dp"]

            def eval_dispatch(params, state, batch):
                rows = batch["label"].shape[0]
                fn = eval_sharded if rows % n_dp == 0 else eval_replicated
                return fn(params, state, batch)

            self._eval_step = eval_dispatch
        else:
            self._train_step = jax.jit(train_step, donate_argnums=donate)
            self._eval_step = jax.jit(eval_step)

    # ------------------------------------------------------- fused multi-step
    def scan_train_steps(self, params, state, opt_state, batches, step0,
                         root_key):
        """Run K training steps in ONE compiled dispatch via lax.scan.

        batches: dict of (K, batch_size, ...) stacked arrays (K consecutive
        batches along a leading axis).  step0: int index of the first step.
        root_key: the SAME root PRNGKey ``fit`` uses -- each step i draws
        fold_in(root_key, step0+i), so K fused steps run the exact rng/
        data chain of K sequential ``_train_step`` calls; values agree to
        float tolerance (XLA fuses the scan body differently than the
        standalone step program -- ~1 ULP reassociation; tested).

        This is the dispatch-amortized training path: per-step host
        round-trips (the reference pays a full per-layer host loop per
        iteration, solver.cpp:194-323) drop to one per K steps.  Returns
        (params, state, opt_state, losses (K,)).
        """
        if self._scan_steps_jit is None:
            train_step = self._train_step_fn

            def many(params, state, opt_state, batches, step0, root_key):
                def body(carry, i):
                    p, s, o = carry
                    b = jax.tree.map(lambda x: x[i], batches)
                    p, s, o, loss = train_step(
                        p, s, o, b, step0 + i,
                        jax.random.fold_in(root_key, step0 + i))
                    return (p, s, o), loss

                k = jax.tree.leaves(batches)[0].shape[0]
                (params, state, opt_state), losses = jax.lax.scan(
                    body, (params, state, opt_state), jnp.arange(k))
                return params, state, opt_state, losses

            donate = (0, 2) if self.donate else ()
            if self.mesh is not None:
                # stacked batches are (K, [iter_size,] B, ...): the
                # sample axis shards over dp, whichever position it's in
                bspec = jax.sharding.PartitionSpec(None, "dp") \
                    if self.cfg.solver.iter_size == 1 \
                    else jax.sharding.PartitionSpec(None, None, "dp")
                dp = jax.sharding.NamedSharding(self.mesh, bspec)
                rep = jax.sharding.NamedSharding(
                    self.mesh, jax.sharding.PartitionSpec())
                self._scan_steps_jit = jax.jit(
                    many, in_shardings=(rep, rep, rep, dp, None, None),
                    donate_argnums=donate)
            else:
                self._scan_steps_jit = jax.jit(many, donate_argnums=donate)
        return self._scan_steps_jit(params, state, opt_state, batches,
                                    jnp.asarray(step0), root_key)

    # ----------------------------------------------------- chunked dispatch
    @staticmethod
    def _plan_chunk(it: int, k: int, limit: int, intervals) -> int:
        """Length of the next fused chunk starting at step ``it``: at most
        ``k`` and ``limit`` steps, and always ending exactly at the next
        multiple of any bookkeeping interval (so eval/snapshot steps are a
        chunk's LAST step, where params on the host are the post-that-step
        state)."""
        k_plan = min(k, limit)
        for interval in intervals:
            nb = it + (-it) % interval  # next multiple >= it
            k_plan = min(k_plan, nb - it + 1)
        return max(1, k_plan)

    def _run_chunk(self, params, state, opt_state, chunk, it, root_key):
        """Dispatch one chunk: a single _train_step for length 1, the
        fused scan for longer.  Returns (params, state, opt_state,
        per-step host losses)."""
        if len(chunk) == 1:
            params, state, opt_state, loss = self._train_step(
                params, state, opt_state, chunk[0], jnp.asarray(it),
                jax.random.fold_in(root_key, it))
            return params, state, opt_state, [loss]
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *chunk)
        params, state, opt_state, fused = self.scan_train_steps(
            params, state, opt_state, stacked, it, root_key)
        return params, state, opt_state, list(np.asarray(fused))

    # ------------------------------------------------------------------ data
    def _epoch_batches(self, data: dict, epoch_key, start_batch: int = 0):
        """Deterministic reshuffle each epoch; fixed-size batches with
        wrap-around so every jitted step sees the same shapes.  With
        iter_size > 1 each yield carries iter_size stacked micro-batches.
        ``start_batch`` skips the first batches of the pass without
        materializing them (mid-epoch resume)."""
        n = len(data["label"])
        perm = np.asarray(jax.random.permutation(epoch_key, n))
        iter_size = self.cfg.solver.iter_size
        bs = self.cfg.batch_size * iter_size
        for start in range(start_batch * bs, n, bs):
            idx = perm[start: start + bs]
            if len(idx) < bs:  # wrap (HDF5DataLayer-style continuous stream)
                reps = np.concatenate([perm] * (bs // n + 1))
                idx = np.concatenate([idx, reps[: bs - len(idx)]])
            batch = {k: jnp.asarray(v[idx]) for k, v in data.items()
                     if k != "group"}
            if iter_size > 1:
                batch = {k: v.reshape((iter_size, self.cfg.batch_size)
                                      + v.shape[1:])
                         for k, v in batch.items()}
            yield batch

    @staticmethod
    def _full_batch(data: dict):
        return {k: jnp.asarray(v) for k, v in data.items()}

    # --------------------------------------------------------------- restore
    def _resolve_ckpt(self, path: str) -> str:
        """Accept either a concrete checkpoint dir or a snapshot root
        (-> its latest checkpoint), like `caffe train -snapshot`."""
        if os.path.exists(os.path.join(path, CKPT_FILE)):
            return path
        latest = latest_checkpoint(path, prefix=self.cfg.snapshot_prefix)
        if latest is None and self.cfg.snapshot_prefix != "qa":
            latest = latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
        return latest

    def _load_weights(self, params, state, weights: str):
        """The `caffe train -weights` finetune load: name+shape-checked
        partial restore from our checkpoint format (a directory), or —
        when the path is a FILE — from a reference caffemodel,
        h5-vs-binaryproto dispatched by content magic
        (Net::CopyTrainedLayersFrom, net.cpp:741-844)."""
        if os.path.isfile(weights):  # .caffemodel[.h5], by content magic
            from ..utils.caffemodel import load_caffemodel_auto
            params, state, report = load_caffemodel_auto(weights, params,
                                                         state)
            loaded = sum(1 for v in report.values() if v == "loaded")
            log.info("finetune: %d tensors from caffemodel %s", loaded,
                     weights)
        else:
            params, state, report = load_weights_into(
                params, state, self._resolve_ckpt(weights))
            skipped = {k: v for k, v in report.items() if v != "loaded"}
            log.info("finetune: loaded %d/%d leaves from %s%s",
                     len(report) - len(skipped), len(report), weights,
                     f", skipped {sorted(skipped)}" if skipped else "")
        return self._replicate(params, state)

    def _replicate(self, *trees):
        if self.mesh is None:
            return trees if len(trees) > 1 else trees[0]
        rep = jax.sharding.NamedSharding(self.mesh,
                                         jax.sharding.PartitionSpec())
        out = jax.device_put(trees, rep)
        return out if len(trees) > 1 else out[0]

    # ------------------------------------------------------------------- fit
    def fit(self, train_data: dict, dev_data: dict, *, test_data: dict = None,
            pretrained=None, log_every: int | None = None,
            callback: Callable[[dict], None] | None = None,
            handle_signals: bool = False, resume_from: str | None = None,
            weights: str | None = None, steps_per_dispatch: int = 1):
        """Run the full training recipe.  Returns a history dict with the
        best params (by dev MAP) and metric curves.

        handle_signals: install SIGINT->snapshot+stop, SIGHUP->snapshot+
        continue handlers polled once per step (the reference's
        SignalHandler contract, util/signal_handler.cpp + solver.cpp:259-272).

        resume_from: checkpoint dir (or snapshot root -> latest) to restore
        params + BN state + optimizer history + iteration + epoch/early-stop
        counters from, continuing the run exactly where it left off -- the
        `caffe train -snapshot` path (Solver::Restore, solver.cpp:470-481 +
        sgd_solver.cpp:305-347).  A run resumed from iteration k reproduces
        the uninterrupted run bit-for-bit (same permutations, same rng
        folds, same solver history).

        weights: checkpoint dir to partial-load params/state from by
        name+shape before training -- the `caffe train -weights` finetune
        path (tools/caffe.cpp:211-213, net.cpp:741-777).  Mutually exclusive
        with resume_from.

        steps_per_dispatch: fuse up to K training steps into one compiled
        dispatch (scan_train_steps), one host round-trip per K steps.
        Chunks always end at eval/snapshot/pass boundaries, so the
        recorded history is step-identical to K=1 (values agree to float
        tolerance; XLA fuses the scan body differently).  Choose K dividing test_interval to
        minimize distinct chunk lengths (each length compiles once).
        Signals are polled per chunk; a mid-chunk early-stop takes effect
        at the chunk boundary.
        """
        from .signals import Action, SignalHandler
        if resume_from and weights:
            raise ValueError("resume_from and weights are mutually exclusive "
                             "(tools/caffe.cpp:208-210 has the same CHECK)")
        cfg = self.cfg
        params, state, opt_state = self.init(pretrained=pretrained)
        if weights:
            params, state = self._load_weights(params, state, weights)
        root_key = jax.random.PRNGKey(cfg.seed)
        dev_batch = self._full_batch(dev_data)
        test_batch = self._full_batch(test_data) if test_data else None

        history = {"train_loss_record_interval":
                   cfg.train_loss_record_interval,
                   "train_loss": [], "dev_map": [], "dev_mrr": [],
                   "dev_auc": [], "test_map": [], "test_mrr": [],
                   "test_auc": [], "steps": []}
        best = {"dev_map": -1.0, "step": 0, "params": None, "state": None}
        train_size = len(train_data["label"])
        iter_size = cfg.solver.iter_size
        samples_per_step = cfg.batch_size * iter_size
        steps_per_pass = max(1, -(-train_size // samples_per_step))
        epoch, wait_epoch = -1, 0
        stop = False
        it = 0

        if resume_from and resume_from.endswith((".solverstate",
                                                 ".solverstate.h5")):
            # resume a REFERENCE training run: restore solver history +
            # iteration from the .solverstate and weights from its
            # learned_net (Solver::Restore, solver.cpp:470-481 +
            # sgd_solver.cpp:305-322).  The reference stores no epoch/
            # early-stop counters, so the epoch index is re-derived from
            # the iteration and the patience clock restarts.
            from ..utils.caffemodel import load_solverstate
            opt_state, it, _cur, learned, report = load_solverstate(
                resume_from, params, state, opt_state)
            if learned:
                lp = learned if os.path.isabs(learned) else os.path.join(
                    os.path.dirname(resume_from) or ".", learned)
                if os.path.exists(lp):
                    params, state = self._load_weights(params, state, lp)
                else:
                    log.warning("solverstate names learned_net %s which "
                                "does not exist; weights stay at init",
                                learned)
            opt_state = self._replicate(opt_state)
            epoch = (it * samples_per_step) // max(train_size, 1)
            loaded = sum(1 for v in report.values() if v == "loaded")
            log.info("resumed from reference solverstate %s: iter %d, "
                     "%d history tensors", resume_from, it, loaded)
        elif resume_from:
            ckpt = self._resolve_ckpt(resume_from)
            bundle, meta = load_checkpoint(
                ckpt, template={"params": params, "state": state,
                                "opt_state": opt_state})
            params, state, opt_state = self._replicate(
                bundle["params"], bundle["state"], bundle["opt_state"])
            it = int(meta.get("step", -1)) + 1
            epoch = int(meta.get("epoch", -1))
            wait_epoch = int(meta.get("wait_epoch", 0))
            best["dev_map"] = float(meta.get("best_dev_map", -1.0))
            best["step"] = int(meta.get("best_step", 0))
            for k, v in (meta.get("history") or {}).items():
                if k in history:
                    history[k] = v
            # the best-so-far params live in their own snapshot; reload them
            # so the returned history carries the true best, not just the
            # post-resume best (the reference driver reloads the best
            # snapshot post-hoc the same way, do_trec_qa_clean.py:840)
            if cfg.snapshot_dir and best["step"] >= 0:
                bp = os.path.join(
                    cfg.snapshot_dir,
                    f"{cfg.snapshot_prefix}_iter_{best['step']}")
                if os.path.exists(os.path.join(bp, CKPT_FILE)):
                    bb, _ = load_checkpoint(bp)
                    best["params"] = bb.get("params")
                    best["state"] = bb.get("state")
            log.info("resumed from %s: iter %d, epoch %d, best dev MAP %.4f "
                     "@ %d", ckpt, it, epoch, best["dev_map"], best["step"])

        def snap(tag_meta=None):
            save_checkpoint(
                cfg.snapshot_dir, it,
                {"params": params, "state": state, "opt_state": opt_state},
                prefix=cfg.snapshot_prefix,
                meta={"dev_map": history["dev_map"][-1]
                      if history["dev_map"] else None,
                      "epoch": epoch, "wait_epoch": wait_epoch,
                      "best_step": best["step"],
                      "best_dev_map": best["dev_map"],
                      "history": history, **(tag_meta or {})})

        t0 = time.time()
        sig_ctx = SignalHandler() if handle_signals else None
        if sig_ctx is not None:
            sig_ctx.__enter__()
        def batch_stream(start_it):
            """Continuous batch stream across permutation passes.  Passes
            are steps_per_pass long; each pass's shuffle seed uses the
            sample-count epoch index at the pass start (identical to the
            pre-resume formula when entering at a pass boundary).  A
            continuous stream (rather than per-pass loops) lets fused
            chunks cross pass boundaries, so only eval/snapshot boundaries
            shape chunk lengths -- each distinct length compiles its own
            scan program."""
            s_it = start_it
            while True:
                pass_start = (s_it // steps_per_pass) * steps_per_pass
                epoch_index = (pass_start * samples_per_step) \
                    // max(train_size, 1)
                for b in self._epoch_batches(
                        train_data,
                        jax.random.fold_in(root_key, 1000 + epoch_index),
                        start_batch=s_it - pass_start):
                    yield b
                    s_it += 1

        intervals = [cfg.test_interval] if cfg.test_interval else []
        if cfg.snapshot_dir and cfg.snapshot_interval:
            intervals.append(cfg.snapshot_interval)
        stream = batch_stream(it)
        while it < cfg.max_iter and not stop:
            k_plan = self._plan_chunk(it, steps_per_dispatch,
                                      cfg.max_iter - it, intervals)
            chunk = [b for _, b in zip(range(k_plan), stream)]
            params, state, opt_state, losses = self._run_chunk(
                params, state, opt_state, chunk, it, root_key)
            # per-step bookkeeping, replayed over the chunk's losses;
            # the chunk planner guarantees any eval/snapshot step is the
            # chunk's LAST step, where `params` is exactly the
            # post-that-step state
            last_j = len(losses) - 1
            for j, loss in enumerate(losses):
                if it % cfg.train_loss_record_interval == 0:
                    history["train_loss"].append(float(loss))
                if log_every and it % log_every == 0:
                    log.info("iter %d loss %.4f (%.1fs)", it,
                             float(loss), time.time() - t0)

                if cfg.test_interval and it % cfg.test_interval == 0:
                    assert j == last_j, "chunk planner missed a boundary"
                    dev = self._eval_step(params, state, dev_batch)
                    dev_map = float(dev["map"])
                    history["dev_map"].append(dev_map)
                    history["dev_mrr"].append(float(dev["mrr"]))
                    history["dev_auc"].append(float(dev["auc"]))
                    history["steps"].append(it)
                    if test_batch is not None:
                        te = self._eval_step(params, state, test_batch)
                        history["test_map"].append(float(te["map"]))
                        history["test_mrr"].append(float(te["mrr"]))
                        history["test_auc"].append(float(te["auc"]))
                    if dev_map > best["dev_map"]:
                        wait_epoch = 0
                        best = {"dev_map": dev_map, "step": it,
                                "params": jax.device_get(params),
                                "state": jax.device_get(state)}
                    if callback:
                        callback({"step": it, "dev_map": dev_map,
                                  "loss": float(loss)})

                # epoch accounting + early stop (driver semantics
                # :832-838); counts samples actually consumed per step,
                # including iter_size micro-batches (solver.cpp:221-223).
                # With steps_per_dispatch > 1 a mid-chunk stop takes
                # effect at the chunk boundary (the extra steps are
                # already applied; evals/best are unaffected).
                if it * samples_per_step >= epoch * train_size:
                    epoch += 1
                    wait_epoch += 1
                    # early stop needs a dev signal; with test_interval 0
                    # ("never test", the proto default) train to max_iter
                    if cfg.test_interval \
                            and wait_epoch > cfg.early_stop_patience:
                        log.info("Epoch-%d [%d] early stop", epoch, it)
                        stop = True

                # snapshots come AFTER the epoch bookkeeping so their
                # meta makes `resume_from` exact; signals are polled at
                # chunk boundaries (== once per iteration when
                # steps_per_dispatch is 1, the solver.cpp:259-272
                # contract)
                if sig_ctx is not None and j == last_j:
                    action = sig_ctx.get_requested_action()
                    if action != Action.NONE and cfg.snapshot_dir:
                        snap({"signal": action.name})
                    if action == Action.STOP:
                        log.info("SIGINT: snapshot + stop at iter %d",
                                 it)
                        stop = True
                if (cfg.snapshot_dir and cfg.snapshot_interval
                        and it % cfg.snapshot_interval == 0):
                    assert j == last_j, "chunk planner missed a boundary"
                    snap()

                it += 1
                if it >= cfg.max_iter or stop:
                    break
            if it >= cfg.max_iter or stop:
                break

        if sig_ctx is not None:
            sig_ctx.__exit__(None, None, None)
        history["best_step"] = best["step"]
        history["best_dev_map"] = best["dev_map"]
        history["params"] = best["params"] if best["params"] is not None \
            else jax.device_get(params)
        history["state"] = best["state"] if best["state"] is not None \
            else jax.device_get(state)
        return history

    # ---------------------------------------------------------------- stream
    def fit_stream(self, batches, dev_data: dict, *, steps: int,
                   test_data: dict = None,
                   params=None, state=None, opt_state=None, pretrained=None,
                   eval_interval: int | None = None,
                   patience_evals: int | None = None,
                   handle_signals: bool = False,
                   resume_from: str | None = None,
                   weights: str | None = None,
                   log_every: int | None = None,
                   callback: Callable[[dict], None] | None = None,
                   steps_per_dispatch: int = 1):
        """Train from a batch iterator (BatchIterator / NativePrefetcher /
        any ``__next__``-able yielding dicts of arrays) instead of in-memory
        split arrays -- the streaming path for pools that do not fit host
        memory.  Early stopping counts evals without dev-MAP improvement
        (``patience_evals``) rather than epochs (an iterator has no epoch).

        First-class like ``fit``: test-split scoring, SIGINT/SIGHUP signal
        polling, interval snapshots, resume_from (restores params/solver
        history/step/best -- the stream's position is the caller's to
        restore, matching the reference, whose .solverstate does not record
        data-layer cursors either), and `-weights` finetune loading.

        steps_per_dispatch: fuse up to K stream steps per compiled
        dispatch (scan_train_steps), chunks ending at eval/snapshot
        boundaries exactly as in ``fit``; an exhausted iterator ends the
        run after the partial chunk.

        Returns the same history dict shape as ``fit``."""
        from .signals import Action, SignalHandler
        if resume_from and weights:
            raise ValueError("resume_from and weights are mutually exclusive")
        cfg = self.cfg
        if params is None:
            params, state, opt_state = self.init(pretrained=pretrained)
        if weights:
            params, state = self._load_weights(params, state, weights)
        eval_interval = eval_interval or cfg.test_interval
        dev_batch = self._full_batch(dev_data)
        test_batch = self._full_batch(test_data) if test_data else None
        root_key = jax.random.PRNGKey(cfg.seed)
        history = {"train_loss_record_interval":
                   cfg.train_loss_record_interval,
                   "train_loss": [], "dev_map": [], "dev_mrr": [],
                   "dev_auc": [], "test_map": [], "test_mrr": [],
                   "test_auc": [], "steps": []}
        best = {"dev_map": -1.0, "step": 0, "params": None, "state": None}
        waited = 0
        it_start = 0

        if resume_from:
            ckpt = self._resolve_ckpt(resume_from)
            bundle, meta = load_checkpoint(
                ckpt, template={"params": params, "state": state,
                                "opt_state": opt_state})
            params, state, opt_state = self._replicate(
                bundle["params"], bundle["state"], bundle["opt_state"])
            it_start = int(meta.get("step", -1)) + 1
            waited = int(meta.get("wait_epoch", 0))
            best["dev_map"] = float(meta.get("best_dev_map", -1.0))
            best["step"] = int(meta.get("best_step", 0))
            for k, v in (meta.get("history") or {}).items():
                if k in history:
                    history[k] = v
            if cfg.snapshot_dir:
                bp = os.path.join(
                    cfg.snapshot_dir,
                    f"{cfg.snapshot_prefix}_iter_{best['step']}")
                if os.path.exists(os.path.join(bp, CKPT_FILE)):
                    bb, _ = load_checkpoint(bp)
                    best["params"] = bb.get("params")
                    best["state"] = bb.get("state")
            log.info("stream resumed from %s at iter %d", ckpt, it_start)

        def snap(it, tag_meta=None):
            save_checkpoint(
                cfg.snapshot_dir, it,
                {"params": params, "state": state, "opt_state": opt_state},
                prefix=cfg.snapshot_prefix,
                meta={"dev_map": history["dev_map"][-1]
                      if history["dev_map"] else None,
                      "wait_epoch": waited, "best_step": best["step"],
                      "best_dev_map": best["dev_map"],
                      "history": history, "stream": True,
                      **(tag_meta or {})})

        t0 = time.time()
        sig_ctx = SignalHandler() if handle_signals else None
        if sig_ctx is not None:
            sig_ctx.__enter__()
        stop = False
        # the native prefetcher can hand batches straight from its ring slot
        # to the device (zero host copies after the gather); plain iterators
        # go through jnp.asarray
        direct = hasattr(batches, "next_device")

        iter_size = cfg.solver.iter_size

        def pull_one():
            if direct:
                raw = batches.next_device()
                b = {k: v for k, v in raw.items() if k != "group"}
            else:
                raw = next(batches)
                b = {k: jnp.asarray(v) for k, v in raw.items()
                     if k != "group"}
            if "label" in b and b["label"].ndim == 2:
                b["label"] = b["label"][:, 0]
            return b

        def pull():
            if iter_size == 1:
                return pull_one()
            # gradient accumulation: iter_size consecutive stream
            # batches stack on a leading micro-batch axis, exactly the
            # shape fit()'s _epoch_batches yields (solver.cpp:221-223)
            micro = [pull_one() for _ in range(iter_size)]
            return jax.tree.map(lambda *xs: jnp.stack(xs), *micro)

        intervals = [eval_interval] if eval_interval else []
        if cfg.snapshot_dir and cfg.snapshot_interval:
            intervals.append(cfg.snapshot_interval)
        it = it_start
        exhausted = False
        while it < steps and not stop and not exhausted:
            # same boundary-aligned chunking as fit(): fuse up to K steps
            # per dispatch, always ending where bookkeeping needs params
            k_plan = self._plan_chunk(it, steps_per_dispatch, steps - it,
                                      intervals)
            chunk = []
            for _ in range(k_plan):
                try:
                    chunk.append(pull())
                except StopIteration:
                    exhausted = True
                    break
            if not chunk:
                break
            params, state, opt_state, losses = self._run_chunk(
                params, state, opt_state, chunk, it, root_key)
            last_j = len(losses) - 1
            for j, loss in enumerate(losses):
                if it % cfg.train_loss_record_interval == 0:
                    history["train_loss"].append(float(loss))
                if log_every and it % log_every == 0:
                    log.info("stream iter %d loss %.4f (%.1fs)", it,
                             float(loss), time.time() - t0)
                if eval_interval and it % eval_interval == 0:
                    assert j == last_j, "chunk planner missed a boundary"
                    dev = self._eval_step(params, state, dev_batch)
                    dev_map = float(dev["map"])
                    history["dev_map"].append(dev_map)
                    history["dev_mrr"].append(float(dev["mrr"]))
                    history["dev_auc"].append(float(dev["auc"]))
                    history["steps"].append(it)
                    if test_batch is not None:
                        te = self._eval_step(params, state, test_batch)
                        history["test_map"].append(float(te["map"]))
                        history["test_mrr"].append(float(te["mrr"]))
                        history["test_auc"].append(float(te["auc"]))
                    if dev_map > best["dev_map"]:
                        waited = 0
                        best = {"dev_map": dev_map, "step": it,
                                "params": jax.device_get(params),
                                "state": jax.device_get(state)}
                    else:
                        waited += 1
                        if patience_evals is not None \
                                and waited > patience_evals:
                            stop = True
                    if callback:
                        callback({"step": it, "dev_map": dev_map,
                                  "loss": float(loss)})
                if sig_ctx is not None and j == last_j:
                    action = sig_ctx.get_requested_action()
                    if action != Action.NONE and cfg.snapshot_dir:
                        snap(it, {"signal": action.name})
                    if action == Action.STOP:
                        log.info("SIGINT: snapshot + stop at stream iter %d",
                                 it)
                        stop = True
                if (cfg.snapshot_dir and cfg.snapshot_interval
                        and it % cfg.snapshot_interval == 0):
                    snap(it)
                it += 1
                if it >= steps or stop:
                    break
        if sig_ctx is not None:
            sig_ctx.__exit__(None, None, None)
        history["best_step"] = best["step"]
        history["best_dev_map"] = best["dev_map"]
        history["params"] = best["params"] if best["params"] is not None \
            else jax.device_get(params)
        history["state"] = best["state"] if best["state"] is not None \
            else jax.device_get(state)
        return history

    # ------------------------------------------------------------- inference
    def evaluate(self, params, state, data: dict):
        """Full-split eval (the `caffe test` path, tools/caffe.cpp:229-296):
        one batch, in-graph metrics + probabilities back to host."""
        out = self._eval_step(params, state, self._full_batch(data))
        return {k: (np.asarray(v) if hasattr(v, "shape") else v)
                for k, v in out.items() if v is not None}
