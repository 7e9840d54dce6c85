"""The solver family: SGD / Nesterov / AdaGrad / RMSProp / AdaDelta / Adam.

Pure-pytree reimplementation of the reference's Solver machinery
(src/caffe/solver.cpp + src/caffe/solvers/*.cpp) as one jittable update
function.  The whole per-parameter loop of blobs the reference runs on the
host becomes a handful of fused XLA element-wise passes over the parameter
pytree -- the JAX-native equivalent of the reference's fused ``*_update_gpu``
kernels (e.g. adadelta_update_gpu, solvers/adadelta_solver.cu).

Semantics reproduced exactly, in the reference's order
(SGDSolver::ApplyUpdate, sgd_solver.cpp:102-116):

  1. learning-rate policy          (GetLearningRate, sgd_solver.cpp:27-63)
  2. global L2 gradient clipping   (ClipGradients, sgd_solver.cpp:81-99) --
     over the *raw summed* gradient, before normalization
  3. iter_size normalization       (Normalize, sgd_solver.cpp:119-142)
  4. L2/L1 weight decay folded into the gradient with per-param decay_mult
                                   (Regularize, sgd_solver.cpp:145-204)
  5. per-solver update rule with per-param lr_mult (ComputeUpdateValue)
  6. params -= update              (Net::Update / Blob::Update)

Update rules (diff == value subtracted from params):
  SGD      h = m*h + lr*g;                        diff = h
           (sgd_solver.cpp:213-243)
  Nesterov h' = m*h + lr*g;                       diff = (1+m)*h' - m*h
           (nesterov_solver.cpp:13-60)
  AdaGrad  h += g^2;                              diff = lr * g/(sqrt(h)+eps)
           (adagrad_solver.cpp:14-66)
  RMSProp  h = (1-rd)*g^2 + rd*h;                 diff = lr * g/(sqrt(h)+eps)
           (rmsprop_solver.cpp:15-68)
  AdaDelta h  = (1-m)*g^2 + m*h
           u  = g * sqrt((h2+eps)/(h+eps))
           h2 = (1-m)*u^2 + m*h2;                 diff = lr * u
           (adadelta_solver.cpp:26-107 -- note eps=delta added to BOTH
            accumulators before the ratio, not sqrt-then-add)
  Adam     m_t = (1-b1)*g + b1*m; v_t = (1-b2)*g^2 + b2*v
           c = sqrt(1-b2^t)/(1-b1^t), t = step+1
           diff = lr*c * m_t/(sqrt(v_t)+eps)      (adam_solver.cpp:25-92)

The QA recipe (BASELINE.md): AdaDelta, base_lr=1.0, momentum=0.95,
delta=5e-7, weight_decay=5e-4, fixed LR; clip_gradients is left at the
disabled default (-1) -- the driver sets but never writes the clip field
into the solver proto (do_trec_qa_clean.py:54 vs :336).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """The SolverParameter subset that affects optimization
    (caffe.proto:102-242)."""
    solver_type: str = "adadelta"   # sgd|nesterov|adagrad|rmsprop|adadelta|adam
    base_lr: float = 1.0
    lr_policy: str = "fixed"        # fixed|step|exp|inv|multistep|poly|sigmoid
    gamma: float = 0.1
    power: float = 1.0
    stepsize: int = 1
    stepvalues: Sequence[int] = ()
    max_iter: int = 40001
    momentum: float = 0.95
    momentum2: float = 0.999        # adam beta2
    rms_decay: float = 0.99
    delta: float = 5e-7             # numerical guard (adadelta/adagrad/adam)
    weight_decay: float = 5e-4
    regularization_type: str = "L2"
    clip_gradients: float = -1.0    # < 0 disables (proto default)
    iter_size: int = 1


def learning_rate(cfg: SolverConfig, step):
    """LR policies (sgd_solver.cpp:27-63).  ``step`` may be traced."""
    step = jnp.asarray(step, jnp.float32)
    p = cfg.lr_policy
    if p == "fixed":
        return jnp.asarray(cfg.base_lr, jnp.float32)
    if p == "step":
        if cfg.stepsize <= 0:
            # the reference crashes on iter_ / stepsize; silently
            # returning lr=0 (gamma**inf) would freeze training
            raise ValueError("lr_policy 'step' needs stepsize > 0")
        return cfg.base_lr * cfg.gamma ** jnp.floor(step / cfg.stepsize)
    if p == "exp":
        return cfg.base_lr * cfg.gamma ** step
    if p == "inv":
        return cfg.base_lr * (1.0 + cfg.gamma * step) ** (-cfg.power)
    if p == "multistep":
        boundaries = jnp.asarray(list(cfg.stepvalues) or [jnp.inf],
                                 jnp.float32)
        current = jnp.sum((step >= boundaries).astype(jnp.float32))
        return cfg.base_lr * cfg.gamma ** current
    if p == "poly":
        return cfg.base_lr * (1.0 - step / cfg.max_iter) ** cfg.power
    if p == "sigmoid":
        return cfg.base_lr / (1.0 + jnp.exp(-cfg.gamma * (step - cfg.stepsize)))
    raise ValueError(f"unknown lr_policy {p}")


def _tree_sq_norm(tree):
    return jax.tree.reduce(
        lambda acc, g: acc + jnp.sum(jnp.square(g.astype(jnp.float32))),
        tree, jnp.asarray(0.0, jnp.float32))


class Solver:
    """make_solver() product: .init(params) -> opt_state;
    .apply(params, grads, opt_state, step) -> (new_params, new_opt_state).
    Both are pure and jittable."""

    def __init__(self, cfg: SolverConfig, spec=None):
        self.cfg = cfg
        self.spec = spec  # pytree of (lr_mult, decay_mult), or None for (1,1)

    # -- state ---------------------------------------------------------------
    def init(self, params):
        zeros = jax.tree.map(jnp.zeros_like, params)
        t = self.cfg.solver_type
        if t in ("sgd", "nesterov", "adagrad", "rmsprop"):
            return {"h": zeros}
        if t in ("adadelta", "adam"):
            return {"h": zeros, "h2": jax.tree.map(jnp.zeros_like, params)}
        raise ValueError(f"unknown solver_type {t}")

    # -- multiplier trees ----------------------------------------------------
    def _mults(self, params):
        if self.spec is None:
            ones = jax.tree.map(lambda p: 1.0, params)
            return ones, ones
        is_pair = lambda x: isinstance(x, tuple) and len(x) == 2  # noqa: E731
        lr = jax.tree.map(lambda s: s[0], self.spec, is_leaf=is_pair)
        dc = jax.tree.map(lambda s: s[1], self.spec, is_leaf=is_pair)
        return lr, dc

    # -- one ApplyUpdate -----------------------------------------------------
    def apply(self, params, grads, opt_state, step):
        cfg = self.cfg
        lr_mult, decay_mult = self._mults(params)

        # 2. global L2 clip on raw gradients
        # the reference clips for ANY value >= 0 (sgd_solver.cpp:83
        # returns only when clip_gradients < 0): 0 legitimately freezes
        # training by scaling every gradient to zero
        if cfg.clip_gradients >= 0:
            gnorm = jnp.sqrt(_tree_sq_norm(grads))
            scale = jnp.where(gnorm > cfg.clip_gradients,
                              cfg.clip_gradients / gnorm, 1.0)
            grads = jax.tree.map(lambda g: g * scale, grads)

        # 3. iter_size normalization
        if cfg.iter_size != 1:
            grads = jax.tree.map(lambda g: g / cfg.iter_size, grads)

        # 4. weight decay into the gradient
        if cfg.weight_decay:
            if cfg.regularization_type == "L2":
                grads = jax.tree.map(
                    lambda g, p, d: g + (cfg.weight_decay * d) * p,
                    grads, params, decay_mult)
            elif cfg.regularization_type == "L1":
                grads = jax.tree.map(
                    lambda g, p, d: g + (cfg.weight_decay * d) * jnp.sign(p),
                    grads, params, decay_mult)
            else:
                raise ValueError(cfg.regularization_type)

        # 1./5. rate and update rule
        rate = learning_rate(cfg, step)
        t = cfg.solver_type
        if t == "sgd":
            h = jax.tree.map(lambda h_, g, l: cfg.momentum * h_ + rate * l * g,
                             opt_state["h"], grads, lr_mult)
            diff, new_state = h, {"h": h}
        elif t == "nesterov":
            h = jax.tree.map(lambda h_, g, l: cfg.momentum * h_ + rate * l * g,
                             opt_state["h"], grads, lr_mult)
            diff = jax.tree.map(
                lambda hn, ho: (1 + cfg.momentum) * hn - cfg.momentum * ho,
                h, opt_state["h"])
            new_state = {"h": h}
        elif t == "adagrad":
            h = jax.tree.map(lambda h_, g: h_ + g * g, opt_state["h"], grads)
            diff = jax.tree.map(
                lambda g, h_, l: rate * l * g / (jnp.sqrt(h_) + cfg.delta),
                grads, h, lr_mult)
            new_state = {"h": h}
        elif t == "rmsprop":
            rd = cfg.rms_decay
            h = jax.tree.map(lambda h_, g: (1 - rd) * g * g + rd * h_,
                             opt_state["h"], grads)
            diff = jax.tree.map(
                lambda g, h_, l: rate * l * g / (jnp.sqrt(h_) + cfg.delta),
                grads, h, lr_mult)
            new_state = {"h": h}
        elif t == "adadelta":
            m, eps = cfg.momentum, cfg.delta
            h = jax.tree.map(lambda h_, g: (1 - m) * g * g + m * h_,
                             opt_state["h"], grads)
            u = jax.tree.map(
                lambda g, h_, h2: g * jnp.sqrt((h2 + eps) / (h_ + eps)),
                grads, h, opt_state["h2"])
            h2 = jax.tree.map(lambda h2_, u_: (1 - m) * u_ * u_ + m * h2_,
                              opt_state["h2"], u)
            diff = jax.tree.map(lambda u_, l: rate * l * u_, u, lr_mult)
            new_state = {"h": h, "h2": h2}
        elif t == "adam":
            b1, b2, eps = cfg.momentum, cfg.momentum2, cfg.delta
            tt = jnp.asarray(step, jnp.float32) + 1.0
            corr = jnp.sqrt(1.0 - b2 ** tt) / (1.0 - b1 ** tt)
            m_t = jax.tree.map(lambda m_, g: (1 - b1) * g + b1 * m_,
                               opt_state["h"], grads)
            v_t = jax.tree.map(lambda v_, g: (1 - b2) * g * g + b2 * v_,
                               opt_state["h2"], grads)
            diff = jax.tree.map(
                lambda m_, v_, l: rate * corr * l * m_ / (jnp.sqrt(v_) + eps),
                m_t, v_t, lr_mult)
            new_state = {"h": m_t, "h2": v_t}
        else:
            raise ValueError(t)

        # 6. data -= diff
        new_params = jax.tree.map(lambda p, d: p - d, params, diff)
        return new_params, new_state


def make_solver(cfg: SolverConfig, spec=None) -> Solver:
    """spec: optional pytree (same structure as params) of
    (lr_mult, decay_mult) tuples -- the ParamSpec equivalent
    (net.cpp:440-533 semantics, e.g. 2x lr on biases, 0 decay on
    embeddings/BN/fc as produced by ``models.param_spec``)."""
    return Solver(cfg, spec)
