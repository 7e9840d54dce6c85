"""Recurrent layers: LSTM / vanilla RNN via lax.scan.

The reference implements recurrence by unrolling an inner Net through time
(src/caffe/layers/recurrent_layer.cpp builds T copies of a step subgraph;
lstm_layer.cpp / rnn_layer.cpp fill in the step).  In JAX the idiomatic
form is ``jax.lax.scan`` over a single step function -- one compiled step
body, sequential execution, no T-times graph blowup.

Semantics matched to the reference:
* LSTM step (lstm_layer.cpp FillUnrolledNet): gates from one fused
  (4H) linear of [x_t, h_{t-1}] with input/forget/output sigmoid and
  tanh candidate; c_t = f⊙c + i⊙g; h_t = o⊙tanh(c_t).  Gate order i,f,o,g.
* RNN step (rnn_layer.cpp): h_t = tanh(W_x x_t + W_h h_{t-1} + b).
* ``cont`` (the reference's sequence-continuation indicator input,
  recurrent_layer.cpp bottom[1]): zeros reset the state at sequence
  starts; multiplied into the carried state exactly as the unrolled net's
  scale layer does.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils import fillers


def lstm_init(key, input_dim: int, hidden_dim: int, *, dtype=jnp.float32):
    """{'wx': (D, 4H), 'wh': (H, 4H), 'b': (4H,)}; gate order i,f,o,g."""
    k1, k2 = jax.random.split(key)
    return {
        "wx": fillers.xavier(k1, (input_dim, 4 * hidden_dim),
                             fan_in=input_dim, dtype=dtype),
        "wh": fillers.xavier(k2, (hidden_dim, 4 * hidden_dim),
                             fan_in=hidden_dim, dtype=dtype),
        "b": jnp.zeros((4 * hidden_dim,), dtype),
    }


def lstm_apply(params, x, *, cont=None, h0=None, c0=None):
    """x: (T, N, D) time-major -> (outputs (T, N, H), (h_T, c_T)).

    cont: optional (T, N) 0/1 flow indicators; 0 resets state before the
    step (recurrent_layer.cpp's h = h * cont semantics)."""
    t_len, n, _ = x.shape
    h_dim = params["wh"].shape[0]
    h = jnp.zeros((n, h_dim), x.dtype) if h0 is None else h0
    c = jnp.zeros((n, h_dim), x.dtype) if c0 is None else c0
    if cont is None:
        cont = jnp.ones((t_len, n), x.dtype)

    def step(carry, inputs):
        h, c = carry
        x_t, cont_t = inputs
        h = h * cont_t[:, None]
        c = c * cont_t[:, None]
        gates = x_t @ params["wx"] + h @ params["wh"] + params["b"]
        i, f, o, g = jnp.split(gates, 4, axis=-1)
        c_new = jax.nn.sigmoid(f) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
        h_new = jax.nn.sigmoid(o) * jnp.tanh(c_new)
        return (h_new, c_new), h_new

    (h, c), outputs = jax.lax.scan(step, (h, c), (x, cont))
    return outputs, (h, c)


def rnn_init(key, input_dim: int, hidden_dim: int, *, dtype=jnp.float32):
    """{'wx': (D, H), 'b': (H,), 'wh': (H, H), 'wo': (H, H),
    'bo': (H,)} — the reference RNN's FIVE blobs: W_xh, b_h, W_hh,
    W_ho, b_o (rnn_layer.cpp:98-226)."""
    k1, k2, k3 = jax.random.split(key, 3)
    return {
        "wx": fillers.xavier(k1, (input_dim, hidden_dim), fan_in=input_dim,
                             dtype=dtype),
        "wh": fillers.xavier(k2, (hidden_dim, hidden_dim),
                             fan_in=hidden_dim, dtype=dtype),
        "b": jnp.zeros((hidden_dim,), dtype),
        "wo": fillers.xavier(k3, (hidden_dim, hidden_dim),
                             fan_in=hidden_dim, dtype=dtype),
        "bo": jnp.zeros((hidden_dim,), dtype),
    }


def rnn_apply(params, x, *, cont=None, h0=None):
    """Vanilla tanh RNN (rnn_layer.cpp:98-226):
    h_t = tanh(W_xh x_t + b_h + W_hh (cont_t * h_{t-1})),
    o_t = tanh(W_ho h_t + b_o)  — the TOP is the projected o_t, not the
    raw hidden state.  x (T, N, D) -> (outputs (T, N, H), h_T)."""
    t_len, n, _ = x.shape
    h_dim = params["wh"].shape[0]
    h = jnp.zeros((n, h_dim), x.dtype) if h0 is None else h0
    if cont is None:
        cont = jnp.ones((t_len, n), x.dtype)

    def step(h, inputs):
        x_t, cont_t = inputs
        h = h * cont_t[:, None]
        h_new = jnp.tanh(x_t @ params["wx"] + h @ params["wh"] + params["b"])
        o_t = jnp.tanh(h_new @ params["wo"] + params["bo"])
        return h_new, o_t

    h, outputs = jax.lax.scan(step, h, (x, cont))
    return outputs, h
