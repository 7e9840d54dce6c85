"""Sharded train / eval step builders (the Solver+P2PSync hot path).

One jitted XLA program per step: forward, backward, solver update, BN-state
EMA -- with the batch sharded over 'dp' and the large tensors over 'tp'.
XLA inserts the gradient all-reduce where the shardings demand it;
this subsumes the reference's entire on_start/on_gradients_ready machinery
(parallel.cpp:287-380) and its 1/N gradient scaling (the mean over the
global batch is already the mean -- no post-hoc rescale).

Solver-equivalence across mesh sizes (1 device vs N at the same global
batch) is asserted in tests/test_parallel.py, the
test_gradient_based_solver.cpp:459-488 pattern.
"""

from __future__ import annotations

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..models.mms_qa import mms_qa_apply
from .mesh import params_pspec


def build_sharded_train_step(model_cfg, solver, mesh, *, apply_fn=mms_qa_apply,
                             donate: bool = True):
    """Returns step(params, state, opt_state, batch, it, rng) jitted over
    the mesh.  Parameters follow params_pspec; batch is sharded over dp."""

    def train_step(params, state, opt_state, batch, it, rng):
        def loss_fn(p):
            out, new_state = apply_fn(p, state, batch, model_cfg,
                                      train=True, rng=rng)
            return out["loss"], new_state

        (loss, new_state), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        params2, opt_state2 = solver.apply(params, grads, opt_state, it)
        return params2, new_state, opt_state2, loss

    def shardings_for(params_like):
        pp = params_pspec(params_like, mesh)
        to_ns = lambda t: jax.tree.map(  # noqa: E731
            lambda s: NamedSharding(mesh, s), t,
            is_leaf=lambda x: isinstance(x, P))
        return to_ns(pp)

    def jit_with(params, state, opt_state):
        p_sh = shardings_for(params)
        s_sh = jax.tree.map(lambda _: NamedSharding(mesh, P()), state)
        o_sh = {k: p_sh for k in opt_state}  # history mirrors params layout
        batch_sh = NamedSharding(mesh, P("dp"))
        return jax.jit(
            train_step,
            in_shardings=(p_sh, s_sh, o_sh, batch_sh, None, None),
            out_shardings=(p_sh, s_sh, o_sh, None),
            donate_argnums=(0, 1, 2) if donate else (),
        )

    return jit_with


def build_sharded_eval_step(model_cfg, mesh, *, apply_fn=mms_qa_apply):
    """Eval forward over a dp-sharded batch; probabilities gathered."""

    def eval_step(params, state, batch):
        out, _ = apply_fn(params, state, batch, model_cfg, train=False)
        return out["prob"]

    batch_sh = NamedSharding(mesh, P("dp"))
    return jax.jit(eval_step, in_shardings=(None, None, batch_sh),
                   out_shardings=NamedSharding(mesh, P("dp")))
