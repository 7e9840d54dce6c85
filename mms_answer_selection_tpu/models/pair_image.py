"""Siamese image-pair metric model (multimodal path, configs[4]).

The reference's image side is assembled from generic layers: PairImageData
input (both images), a conv net scoring each, PairRankLoss on the two
scores + label, RankAccuracy for eval (SURVEY.md §2.1).  Here it is a
first-class model: a shared conv encoder (conv -> BN -> max-pool -> tanh
blocks, same block vocabulary as the QA model) runs over img1 ⧺ img2
concatenated on the BATCH axis (one big conv pass instead of the
reference's channel-stacking), a linear head produces one scalar score per
image, and training uses the margin-rank + similarity-hinge loss
(pair_rank_loss_layer.cpp:26-52).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp

from ..metrics import rank_accuracy_jax
from ..ops import bn_apply, bn_init, conv2d, conv_init, pair_rank_loss
from ..ops.pooling import _out_size, max_pool2d
from ..utils import fillers
from .mms_qa import ConvBlock


@dataclasses.dataclass(frozen=True)
class PairImageConfig:
    height: int = 16
    width: int = 16
    channels: int = 1
    blocks: Sequence[ConvBlock] = (
        ConvBlock(3, 3, 8, "max", 2, 2),
        ConvBlock(3, 3, 16, "max", 2, 2),
    )
    fc_dim: int = 16
    margin: float = 1.0   # PairRankLossParameter.margin (caffe.proto:480)


def _spatial(cfg: PairImageConfig):
    import math
    h, w, c = cfg.height, cfg.width, cfg.channels
    for b in cfg.blocks:
        h, w = h - b.kh + 1, w - b.kw + 1
        h = _out_size(h, b.pool_k, b.pool_stride)
        w = _out_size(w, b.pool_k, b.pool_stride)
        c = b.out_channels
    return h, w, c


def pair_image_init(key, cfg: PairImageConfig, *, dtype=jnp.float32):
    keys = jax.random.split(key, len(cfg.blocks) + 2)
    params, state = {}, {}
    in_ch = cfg.channels
    for i, b in enumerate(cfg.blocks):
        params[f"conv{i}"] = conv_init(keys[i], in_ch, b.out_channels,
                                       b.kh, b.kw, dtype=dtype)
        bn_p, bn_s = bn_init(b.out_channels, dtype=dtype)
        params[f"bn{i}"] = bn_p
        state[f"bn{i}"] = bn_s
        in_ch = b.out_channels
    h, w, c = _spatial(cfg)
    flat = h * w * c
    params["fc"] = {"w": fillers.xavier(keys[-2], (flat, cfg.fc_dim),
                                        fan_in=flat, dtype=dtype),
                    "b": jnp.zeros((cfg.fc_dim,), dtype)}
    params["score"] = {"w": fillers.xavier(keys[-1], (cfg.fc_dim, 1),
                                           fan_in=cfg.fc_dim, dtype=dtype),
                       "b": jnp.zeros((1,), dtype)}
    return params, state


def encode(params, state, x, cfg: PairImageConfig, *, train: bool):
    """Shared encoder: (N, H, W, C) -> (N,) scalar scores.
    Returns (scores, new_state)."""
    new_state = dict(state)
    for i, b in enumerate(cfg.blocks):
        x = conv2d(params[f"conv{i}"], x)
        x, new_state[f"bn{i}"] = bn_apply(params[f"bn{i}"], state[f"bn{i}"],
                                          x, train=train)
        x = max_pool2d(x, b.pool_k, b.pool_k, stride_h=b.pool_stride,
                       stride_w=b.pool_stride)
        x = jnp.tanh(x)
    flat = x.reshape(x.shape[0], -1)
    h = jnp.tanh(flat @ params["fc"]["w"] + params["fc"]["b"])
    return (h @ params["score"]["w"] + params["score"]["b"])[:, 0], new_state


def pair_image_apply(params, state, batch, cfg: PairImageConfig, *,
                     train: bool, rng=None):
    """batch: {'img1','img2': (N,H,W,C), 'label': (N,)} ->
    ({'score1','score2','loss','rank_accuracy'}, new_state).

    Both images run through the encoder in ONE batched pass (weight sharing
    by construction; the reference shares via named ParamSpecs)."""
    n = batch["img1"].shape[0]
    stacked = jnp.concatenate([batch["img1"], batch["img2"]], axis=0)
    scores, new_state = encode(params, state, stacked, cfg, train=train)
    s1, s2 = scores[:n], scores[n:]
    label = batch["label"].astype(s1.dtype)
    out = {
        "score1": s1,
        "score2": s2,
        "loss": pair_rank_loss(s1, s2, label, margin=cfg.margin),
        "rank_accuracy": rank_accuracy_jax(s1, s2, label),
    }
    return out, new_state
