"""2-D convolution in NHWC layout.

The reference builds conv from im2col + GEMM in NCHW
(src/caffe/layers/base_conv_layer.cpp, util/im2col.cpp); here that whole
machinery is one XLA op -- ``lax.conv_general_dilated``, which XLA hands to
cuDNN on the GPU with fused layout handling, so there is deliberately no
im2col here.

Initialization matches the recipe: xavier weights with fan_in = Cin*kh*kw
(filler.hpp XavierFiller over a (Cout, Cin, kh, kw) blob), constant-0 bias
(do_trec_qa_clean.py:352-356).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils import fillers

_DIMSPEC = ("NHWC", "HWIO", "NHWC")


def conv_init(key, in_channels: int, out_channels: int, kh: int, kw: int,
              *, bias_value: float = 0.0, dtype=jnp.float32):
    """Returns {'w': (kh, kw, Cin, Cout), 'b': (Cout,)}."""
    fan_in = in_channels * kh * kw
    w = fillers.xavier(key, (kh, kw, in_channels, out_channels), fan_in=fan_in,
                       dtype=dtype)
    b = jnp.full((out_channels,), bias_value, dtype)
    return {"w": w, "b": b}


def conv2d(params, x, *, stride: int = 1, padding="VALID",
           preferred_dtype=jnp.float32,
           precision=jax.lax.Precision.HIGHEST):
    """x: (N, H, W, Cin) -> (N, H', W', Cout).  VALID + stride 1 matches the
    pad=0 stride=1 convs of every QA recipe (do_trec_qa_clean.py:352-369).

    precision defaults to HIGHEST for f32 parity with the reference's BLAS
    path; the serving fast path casts inputs to bf16 instead of lowering the
    accumulation precision."""
    y = jax.lax.conv_general_dilated(
        x, params["w"],
        window_strides=(stride, stride),
        padding=padding,
        dimension_numbers=_DIMSPEC,
        preferred_element_type=preferred_dtype,
        precision=precision,
    )
    return y + params["b"]
