"""Word-by-word and sentence-level similarity ops (the MMS value-add).

Reference semantics (all cited against /root/reference):

* ``sim_cross_*`` -- the SimCross layer family
  (src/caffe/layers/sim_cross_layer.cpp).  Given a question batch
  Q: (N, W1, D) and an answer batch A: (N, W2, D) it produces the dense
  all-pairs word-word similarity map:

  - mode 1 (inv-euclidean, cpp:96-111):  1 / (1 + ||q_i - a_j||_2)
  - mode 0 (cosine, cpp:112-139):        <q_i, a_j> / (||q_i|| ||a_j||)
  - mode 2 (learned bilinear metric, cpp:140-161):
        out[n, m, i, j] = q_i^T W_m a_j (+ bias[m, i, j])
    with M = ``mesure_count`` learned (D, D) matrices.

  Layout note: the reference emits NCHW (N, M|1, W1, W2); this framework
  uses NHWC throughout, so these functions return (N, W1, W2, M|1).  The
  values are identical.

  The reference's backward is a hand-written 6-GEMM loop per (sample,
  measure) (cpp:280-305) that falls back to CPU on GPU builds (.cu:187-189).
  Here the einsum formulation lets XLA batch all of it into a few large
  matrix products, and the fused retrieval kernels live in
  ``sim_cross_pallas.py``.

* ``sim_matrix`` -- the SimMatrix layer (src/caffe/layers/sim_matrix_layer
  .cpp:52-65): sentence-level bilinear score s_n = x_n^T M y_n.

* ``fm_pool`` -- the FM layer (src/caffe/layers/fm_layer.cpp:32-62):
  factorization-machine pooling with channel 0 of the last axis treated as
  the linear term.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# f32 parity with the reference's cBLAS/cuBLAS GEMMs requires full-precision
# products; DEFAULT would allow TF32 on the GPU.  Callers on the serving fast
# path pass bf16 *inputs* instead, which keeps the tensor cores fast without
# silently degrading f32 training.
_PREC = jax.lax.Precision.HIGHEST


def sim_cross_inv_euclidean(q, a, *, keep_measure_axis: bool = True):
    """Inverse-euclidean similarity map: 1/(1+||q_i - a_j||).

    q: (N, W1, D), a: (N, W2, D) -> (N, W1, W2, 1) (or (N, W1, W2)).
    Reference: sim_cross_layer.cpp:96-111 (dist_mode=1, the proto default).
    """
    # ||q-a||^2 = ||q||^2 + ||a||^2 - 2<q,a>; clamp for sqrt safety.
    qq = jnp.sum(q * q, axis=-1)  # (N, W1)
    aa = jnp.sum(a * a, axis=-1)  # (N, W2)
    qa = jnp.einsum("nid,njd->nij", q, a, precision=_PREC)  # (N, W1, W2)
    d2 = qq[:, :, None] + aa[:, None, :] - 2.0 * qa
    dist = jnp.sqrt(jnp.maximum(d2, 0.0))
    out = 1.0 / (1.0 + dist)
    return out[..., None] if keep_measure_axis else out


def sim_cross_cosine(q, a, *, eps: float = 0.0, keep_measure_axis: bool = True):
    """Cosine similarity map: <q_i,a_j> / (||q_i|| ||a_j||).

    Reference: sim_cross_layer.cpp:112-139 (dist_mode=0).  The reference has
    no epsilon guard (norms are non-zero in practice because even pad rows of
    the embedding table are randomly initialized); ``eps`` defaults to 0 to
    match, pass a small value for numerically-safe use on arbitrary inputs.
    """
    qn = jnp.sqrt(jnp.sum(q * q, axis=-1))  # (N, W1)
    an = jnp.sqrt(jnp.sum(a * a, axis=-1))  # (N, W2)
    qa = jnp.einsum("nid,njd->nij", q, a, precision=_PREC)
    out = qa / (qn[:, :, None] * an[:, None, :] + eps)
    return out[..., None] if keep_measure_axis else out


def sim_cross_bilinear(q, a, w, bias=None):
    """Learned bilinear metric map: out[n,i,j,m] = q_i^T W_m a_j (+ b[m,i,j]).

    q: (N, W1, D), a: (N, W2, D), w: (M, D, D), bias: (M, W1, W2) or None.
    Returns (N, W1, W2, M) [NHWC; reference NCHW equivalent is (N, M, W1, W2),
    sim_cross_layer.cpp:140-161].

    The reference computes this as 2 GEMMs per (n, m) in a Python-visible
    loop and accumulates the backward with 6 more (cpp:282-300); a single
    einsum lets XLA emit batched matmuls for forward and backward alike.
    """
    out = jnp.einsum("nid,mde,nje->nijm", q, w, a, precision=_PREC)
    if bias is not None:
        out = out + jnp.transpose(bias, (1, 2, 0))[None]
    return out


def sim_matrix(x, y, w):
    """Sentence-level bilinear similarity s_n = x_n^T W y_n.

    x: (N, K1), y: (N, K2), w: (K1, K2) -> (N, 1).
    Reference: sim_matrix_layer.cpp:52-65 (forward), 67-95 (backward --
    rank-1 ``ger`` accumulation that autodiff of this einsum reproduces).
    """
    s = jnp.einsum("ni,ij,nj->n", x, w, y, precision=_PREC)
    return s[:, None]


def fm_pool(x, bias=None):
    """Factorization-machine pooling over (N, C, D) inputs.

    out_n = sum_{j>=1} [ (sum_k x[n,k,j])^2 - sum_k x[n,k,j]^2 ] / 2
            + sum_k x[n,k,0]  (+ bias)

    i.e. the pairwise-interaction pooling of an FM with the first position of
    the last axis as the linear term and a scalar bias blob.
    Reference: fm_layer.cpp:32-62 (forward), 64-98 (backward).
    Returns (N, 1).
    """
    linear = jnp.sum(x[:, :, 0], axis=1)  # (N,)
    rest = x[:, :, 1:]
    s = jnp.sum(rest, axis=1)  # (N, D-1)
    interactions = 0.5 * jnp.sum(s * s - jnp.sum(rest * rest, axis=1), axis=-1)
    out = interactions + linear
    if bias is not None:
        out = out + jnp.reshape(bias, ())
    return out[:, None]
