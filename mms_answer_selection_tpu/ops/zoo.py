"""Stock layer zoo: the reference's generic layer vocabulary as jnp ops.

Caffe ships ~70 generic layers (SURVEY.md §2.2); in JAX most are single
fused XLA expressions, not framework components.  This module pins down the
ones with nontrivial *semantics* (exact parameterizations cited per
function) so recipes built from the reference's vocabulary translate
one-to-one.  Structural layers (Flatten/Reshape/Concat/Slice/Split/Tile/
Crop) are jnp built-ins and appear here only where Caffe adds semantics.

Everything is a pure function; learnable variants (PReLU, Scale/Bias)
take their parameter explicitly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# ----------------------------------------------------------------- neurons


def relu(x, *, negative_slope: float = 0.0):
    """ReLULayer with leaky slope (relu_layer.cpp; negative_slope param)."""
    return jnp.where(x > 0, x, negative_slope * x)


def sigmoid(x):
    return jax.nn.sigmoid(x)


def tanh(x):
    return jnp.tanh(x)


def elu(x, *, alpha: float = 1.0):
    """ELULayer: x if x>0 else alpha*(exp(x)-1) (elu_layer.cpp)."""
    return jnp.where(x > 0, x, alpha * jnp.expm1(x))


def prelu(x, slopes, *, channel_axis: int = -1):
    """PReLULayer: per-channel learnable negative slopes
    (prelu_layer.cpp; channel_shared collapses slopes to a scalar)."""
    shape = [1] * x.ndim
    shape[channel_axis] = -1
    return jnp.where(x > 0, x, jnp.reshape(slopes, shape) * x)


def bnll(x):
    """BNLLLayer: log(1 + exp(x)), computed stably (bnll_layer.cpp uses the
    x>0 split for overflow safety)."""
    return jnp.maximum(x, 0) + jnp.log1p(jnp.exp(-jnp.abs(x)))


def power(x, *, power: float = 1.0, scale: float = 1.0, shift: float = 0.0):
    """PowerLayer: (shift + scale*x)^power (power_layer.cpp)."""
    return (shift + scale * x) ** power


def exp(x, *, base: float = -1.0, scale: float = 1.0, shift: float = 0.0):
    """ExpLayer: base^(shift + scale*x); base=-1 means e (exp_layer.cpp)."""
    y = shift + scale * x
    return jnp.exp(y) if base <= 0 else base ** y


def log(x, *, base: float = -1.0, scale: float = 1.0, shift: float = 0.0):
    """LogLayer: log_base(shift + scale*x) (log_layer.cpp)."""
    y = jnp.log(shift + scale * x)
    return y if base <= 0 else y / jnp.log(base)


def threshold(x, *, threshold: float = 0.0):
    """ThresholdLayer: 1 if x > t else 0 (threshold_layer.cpp)."""
    return (x > threshold).astype(x.dtype)


def absval(x):
    return jnp.abs(x)


# ------------------------------------------------------------ normalization


def mvn(x, *, normalize_variance: bool = True, across_channels: bool = False,
        eps: float = 1e-9, channel_axis: int = -1):
    """MVNLayer: per-sample mean (and optionally variance) normalization
    (mvn_layer.cpp).  across_channels=False normalizes each channel's
    spatial field separately."""
    axes = tuple(i for i in range(1, x.ndim)
                 if across_channels or i != (channel_axis % x.ndim))
    mu = jnp.mean(x, axis=axes, keepdims=True)
    y = x - mu
    if normalize_variance:
        # the reference divides by stddev + eps (not sqrt(var + eps))
        std = jnp.sqrt(jnp.mean(y * y, axis=axes, keepdims=True))
        y = y / (std + eps)
    return y


def lrn_across_channels(x, *, local_size: int = 5, alpha: float = 1.0,
                        beta: float = 0.75, k: float = 1.0):
    """LRNLayer ACROSS_CHANNELS mode over NHWC
    (lrn_layer.cpp): y = x / (k + alpha/n * sum_window x^2)^beta."""
    c = x.shape[-1]
    sq = x * x
    pad = local_size // 2
    padded = jnp.pad(sq, [(0, 0)] * (x.ndim - 1) + [(pad, pad)])
    window = sum(padded[..., i: i + c] for i in range(local_size))
    return x / (k + (alpha / local_size) * window) ** beta


def lrn_within_channel(x, *, local_size: int = 5, alpha: float = 1.0,
                       beta: float = 0.75):
    """LRNLayer WITHIN_CHANNEL mode over NHWC (lrn_layer.cpp:17-67):
    y = x * (1 + alpha * avepool(x^2))^-beta, with an AVE pool of kernel
    local_size, stride 1, pad (local_size-1)/2.  Two reference quirks
    reproduced: ``k`` is IGNORED in this mode (the internal PowerLayer's
    shift is hardcoded to 1, lrn_layer.cpp:53) and alpha is NOT divided by
    the window size (the AVE pool's divisor supplies the /N^2, :47-54,
    including its count-padded-cells boundary behavior)."""
    if local_size % 2 != 1:
        raise ValueError("LRN only supports odd local_size "
                         "(lrn_layer.cpp:12 CHECKs the same)")
    from .pooling import pool2d_padded
    pre_pad = (local_size - 1) // 2
    pooled = pool2d_padded(x * x, local_size, local_size, stride_h=1,
                           stride_w=1, pad_h=pre_pad, pad_w=pre_pad,
                           mode="ave")
    return x * (1.0 + alpha * pooled) ** (-beta)


def scale(x, scale_param, bias_param=None, *, channel_axis: int = -1):
    """ScaleLayer (+ fused bias): per-channel learned multiplier
    (scale_layer.cpp)."""
    shape = [1] * x.ndim
    shape[channel_axis] = -1
    y = x * jnp.reshape(scale_param, shape)
    if bias_param is not None:
        y = y + jnp.reshape(bias_param, shape)
    return y


# ------------------------------------------------------------- convolution


def deconv2d(x, weight, bias=None, *, stride: int = 1, pad: int = 0,
             dilation: int = 1, group: int = 1):
    """DeconvolutionLayer (deconv_layer.cpp): a convolution's backward-data
    pass run as the forward -- output spatial size
    ``stride*(in-1) + dilation*(k-1) + 1 - 2*pad`` (compute_output_shape,
    deconv_layer.cpp:8-22).

    x: (N, H, W, Cin) NHWC.  weight: the caffe blob layout
    (Cin, Cout//group, kh, kw) -- the FORWARD conv's weights with the
    reversed in/out roles (base_conv_layer.cpp reverse_dimensions(), so a
    reference .caffemodel deconv blob drops in unchanged).  Expressed as
    one ``conv_general_dilated`` with lhs_dilation=stride (fractional
    stride) and the spatially-flipped, IO-swapped kernel -- XLA lowers it
    like any conv; no col2im machinery."""
    cin, og, kh, kw = weight.shape
    if x.shape[-1] != cin:
        raise ValueError(f"x channels {x.shape[-1]} != weight Cin {cin}")
    if cin % group:
        raise ValueError(f"Cin {cin} not divisible by group {group}")
    # (Cin, Og, kh, kw) -> HWIO of the equivalent fractionally-strided
    # conv: spatial-flip + swap I/O => (kh, kw, Cin/group per group, Og)
    k = jnp.transpose(weight, (2, 3, 0, 1))[::-1, ::-1]
    pads = [(dilation * (kh - 1) - pad,) * 2, (dilation * (kw - 1) - pad,) * 2]
    outs = []
    cig = cin // group
    for gi in range(group):  # tiny static loop; XLA fuses the concat
        y = jax.lax.conv_general_dilated(
            x[..., gi * cig:(gi + 1) * cig],
            k[:, :, gi * cig:(gi + 1) * cig, :],
            window_strides=(1, 1), padding=pads,
            lhs_dilation=(stride, stride), rhs_dilation=(dilation, dilation),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=jax.lax.Precision.HIGHEST)
        outs.append(y)
    out = outs[0] if group == 1 else jnp.concatenate(outs, axis=-1)
    if bias is not None:
        out = out + jnp.reshape(bias, (1, 1, 1, -1))
    return out


# -------------------------------------------------------------- reductions


def eltwise(inputs, *, operation: str = "sum", coeffs=None):
    """EltwiseLayer: PROD / SUM (with coeffs) / MAX (eltwise_layer.cpp)."""
    if operation == "prod":
        out = inputs[0]
        for x in inputs[1:]:
            out = out * x
        return out
    if operation == "sum":
        if coeffs and len(coeffs) != len(inputs):
            # eltwise_layer.cpp CHECKs coeff count == bottom count (or 0);
            # zip would silently DROP the uncovered inputs
            raise ValueError(f"Eltwise SUM got {len(coeffs)} coeffs for "
                             f"{len(inputs)} bottoms")
        coeffs = coeffs or [1.0] * len(inputs)
        out = coeffs[0] * inputs[0]
        for c, x in zip(coeffs[1:], inputs[1:]):
            out = out + c * x
        return out
    if operation == "max":
        out = inputs[0]
        for x in inputs[1:]:
            out = jnp.maximum(out, x)
        return out
    raise ValueError(operation)


def reduction(x, *, operation: str = "sum", axis: int = 0,
              coeff: float = 1.0, axes=None):
    """ReductionLayer: SUM/ASUM/SUMSQ/MEAN over trailing axes starting at
    ``axis`` (reduction_layer.cpp; negative axes canonicalize like
    CanonicalAxisIndex).  ``axes`` overrides with an explicit axis set
    (the caller owns layout mapping, e.g. NCHW trailing sets on NHWC
    blobs)."""
    if axes is None:
        a = axis % x.ndim if x.ndim else 0
        axes = tuple(range(a, x.ndim)) if x.ndim > a else ()
    else:
        axes = tuple(axes)
    if operation == "sum":
        r = jnp.sum(x, axis=axes)
    elif operation == "asum":
        r = jnp.sum(jnp.abs(x), axis=axes)
    elif operation == "sumsq":
        r = jnp.sum(x * x, axis=axes)
    elif operation == "mean":
        r = jnp.mean(x, axis=axes)
    else:
        raise ValueError(operation)
    return coeff * r


def argmax(x, *, top_k: int = 1, out_max_val: bool = False,
           axis: int | None = None):
    """ArgMaxLayer (argmax_layer.cpp) semantics:

    * ``axis`` set: top-k along that axis, the k dim REPLACING it; with
      ``out_max_val`` the output is the max VALUES, else the indices.
    * no ``axis``: flatten per row (the reference argmaxes over
      C*H*W), output (N, 1, k) indices — or (N, 2, k) with
      ``out_max_val``: indices row then values row.
    """
    if axis is not None:
        vals, idx = jax.lax.top_k(jnp.moveaxis(x, axis, -1), top_k)
        out = vals if out_max_val else idx.astype(jnp.float32)
        return jnp.moveaxis(out, -1, axis % x.ndim)
    flat = x.reshape(x.shape[0], -1)
    vals, idx = jax.lax.top_k(flat, top_k)
    idxf = idx.astype(jnp.float32)[:, None, :]
    if out_max_val:
        return jnp.concatenate([idxf, vals[:, None, :]], axis=1)
    return idxf


def accuracy(scores, labels, *, top_k: int = 1,
             ignore_label: int | None = None):
    """AccuracyLayer (accuracy_layer.cpp): fraction of rows whose label is
    within the top-k scores; ignore_label rows excluded."""
    _, idx = jax.lax.top_k(scores, top_k)
    hit = jnp.any(idx == labels[:, None].astype(idx.dtype),
                  axis=1).astype(jnp.float32)
    if ignore_label is not None:
        valid = (labels != ignore_label).astype(jnp.float32)
        return jnp.sum(hit * valid) / jnp.maximum(jnp.sum(valid), 1.0)
    return jnp.mean(hit)


def batch_reindex(x, permutation):
    """BatchReindexLayer: gather rows (batch_reindex_layer.cpp)."""
    return jnp.take(x, permutation.astype(jnp.int32), axis=0)


def filter_rows(x, selector, *, capacity: int | None = None):
    """FilterLayer (filter_layer.cpp:15-67): keep the rows whose selector
    entry is nonzero, preserving input order.  Dynamic output shapes don't
    exist under XLA, so the kept rows are COMPACTED to the front of a
    fixed-``capacity`` result (default: the full batch -- the layer's own
    upper bound) and the true row count is returned alongside.

    Returns (filtered, count): ``filtered[:count]`` equals the reference
    layer's output exactly; rows at and past ``count`` are zeroed.  Pass a
    tuple of arrays to filter several bottoms by one selector (the layer's
    multi-bottom form)."""
    multi = isinstance(x, (tuple, list))
    xs = tuple(x) if multi else (x,)
    selector = jnp.reshape(jnp.asarray(selector), (-1,))
    keep = selector != 0
    n = keep.shape[0]
    cap = n if capacity is None else capacity
    # stable argsort keeps the kept rows in input order (the layer copies
    # them in selector order, filter_layer.cpp:56-66)
    order = jnp.argsort(jnp.logical_not(keep).astype(jnp.int8),
                        stable=True)[:cap]
    count = jnp.minimum(jnp.sum(keep.astype(jnp.int32)), cap)
    valid = jnp.arange(cap) < count

    def one(a):
        y = jnp.take(a, order, axis=0)
        mask = valid.reshape((-1,) + (1,) * (a.ndim - 1))
        return jnp.where(mask, y, jnp.zeros((), a.dtype))

    out = tuple(one(a) for a in xs)
    return (out if multi else out[0]), count


def filter_reduce(x, selector, *, operation: str = "mean"):
    """Reduce over only the rows FilterLayer would keep -- the fused form
    of Filter -> Reduction that skips the compaction entirely (the common
    reason the reference inserts a FilterLayer before a metric/loss).
    operation: sum | mean | max.  An all-zero selector yields 0 for
    sum/mean and the dtype's lowest value for max."""
    selector = jnp.reshape(jnp.asarray(selector), (-1,))
    keep = selector != 0
    mask = keep.reshape((-1,) + (1,) * (x.ndim - 1))
    if operation == "sum":
        return jnp.sum(jnp.where(mask, x, 0), axis=0)
    if operation == "mean":
        n = jnp.maximum(jnp.sum(keep.astype(x.dtype)), 1)
        return jnp.sum(jnp.where(mask, x, 0), axis=0) / n
    if operation == "max":
        lowest = jnp.finfo(x.dtype).min \
            if jnp.issubdtype(x.dtype, jnp.floating) \
            else jnp.iinfo(x.dtype).min
        return jnp.max(jnp.where(mask, x, lowest), axis=0)
    raise ValueError(operation)
