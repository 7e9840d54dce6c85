"""The MMS answer-selection model family (network_v3 / v4 / v4_2 / v5).

Reference: examples/trec_qa_w2v_mms/do_trec_qa_clean.py:377-605.  Every
variant is: shared embedding table applied to question and answer, a
SimCross word-word similarity map, optional dropout on the map, a stack of
[conv -> BN -> pool -> tanh] blocks, flatten ⧺ overlap features, a
tanh+dropout MLP head to 2 logits, and softmax cross-entropy.

This framework expresses the family as one config (``MMSQAConfig``) with a
block list instead of four prototxt generators; ``V3/V4/V4_2/V5`` constants
reproduce the reference variants exactly.  Weight sharing that the reference
got from named ParamSpecs (``w2v-weights`` shared across the two Embed
layers, do_trec_qa_clean.py:461-466) falls out naturally from using one
params entry twice.

Layout: NHWC end-to-end (XLA's preferred conv layout), so the sim map is
(N, W1, W2, M)
rather than the reference's (N, M, W1, W2); values are identical.

Functional API:
    params, state = mms_qa_init(key, cfg, pretrained=glove_rows)
    out, new_state = mms_qa_apply(params, state, batch, cfg, train=True,
                                  rng=step_key)
``state`` carries the BN running statistics (optimizer-invisible, the
lr_mult=0 blobs of the reference).  ``param_spec`` returns the per-parameter
(lr_mult, decay_mult) tree matching the recipe's ParamSpecs.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp

from ..ops import (
    bn_apply,
    bn_init,
    conv2d,
    conv_init,
    dropout,
    embed_init,
    embed_lookup,
    sim_cross_bilinear,
    sim_cross_cosine,
    sim_cross_inv_euclidean,
    softmax_cross_entropy,
)
from ..utils import fillers


@dataclasses.dataclass(frozen=True)
class ConvBlock:
    """conv(kh×kw, out_ch) -> BN -> pool(pk×pk, stride ps) -> tanh."""
    kh: int
    kw: int
    out_channels: int
    pool: str  # "max" | "ave"
    pool_k: int
    pool_stride: int


@dataclasses.dataclass(frozen=True)
class MMSQAConfig:
    vocab_size: int = 100
    embed_dim: int = 50          # w2v_dim (do_trec_qa_clean.py:73)
    question_len: int = 40       # question_max_word_len (:71)
    answer_len: int = 40         # answer_max_word_len (:72)
    sim_mode: int = 2            # SimCross dist_mode (0 cos / 1 euc / 2 bilinear)
    sim_measures: int = 4        # mesure_count (v4: 4, do_trec_qa_clean.py:468)
    sim_bias: bool = True
    sim_dropout: float = 0.1     # v4 (:470)
    blocks: Sequence[ConvBlock] = (
        ConvBlock(5, 5, 32, "ave", 4, 4),   # conv0/bn0/pool0 (:472-474)
        ConvBlock(5, 5, 64, "ave", 5, 1),   # conv1/bn1/pool1 (:475-477)
    )
    overlap_features: int = 2    # overlap_feat width (:178)
    fc1_dim: int = 32            # v4 (:481)
    fc1_dropout: float = 0.5     # (:485)
    num_classes: int = 2
    # init details
    embed_init_range: float = 0.08          # uniform(-.08,.08) (:462)
    sim_weight_init: str = "zeros"          # default constant filler (!)
    bn_shift_init: float = 1e-3             # (:357)

    def sim_channels(self) -> int:
        return self.sim_measures if self.sim_mode == 2 else 1


def _v(blocks, **kw):
    return dataclasses.replace(MMSQAConfig(), blocks=tuple(blocks), **kw)


# The four reference variants (do_trec_qa_clean.py:377-605), data-shape
# fields (vocab size etc.) to be overridden per dataset.
V3 = _v([ConvBlock(5, 5, 64, "max", 4, 4), ConvBlock(5, 5, 64, "max", 5, 1)],
        sim_mode=0, sim_measures=1, sim_bias=False, sim_dropout=0.0, fc1_dim=64)
V4 = MMSQAConfig()
V4_2 = _v([ConvBlock(5, 5, 32, "ave", 2, 2), ConvBlock(5, 5, 32, "ave", 2, 2),
           ConvBlock(5, 5, 32, "ave", 3, 3)],
          sim_measures=2, sim_bias=False, sim_dropout=0.0, fc1_dim=64)
V5 = _v([ConvBlock(3, 3, 32, "max", 2, 2), ConvBlock(4, 4, 32, "max", 2, 2),
         ConvBlock(3, 3, 32, "max", 6, 6)],
        sim_measures=2, sim_bias=True, sim_dropout=0.2, fc1_dim=32)
# BASELINE configs[1]: GloVe-300d + wider conv encoder (accuracy-stress)
V4_WIDE = _v([ConvBlock(5, 5, 64, "ave", 4, 4), ConvBlock(5, 5, 128, "ave", 5, 1)],
             embed_dim=300, fc1_dim=64)


def _spatial_after_blocks(cfg: MMSQAConfig) -> tuple[int, int, int]:
    import math
    h, w = cfg.question_len, cfg.answer_len
    c = cfg.sim_channels()
    for b in cfg.blocks:
        h, w = h - b.kh + 1, w - b.kw + 1  # VALID conv
        h = int(math.ceil((h - b.pool_k) / b.pool_stride)) + 1
        w = int(math.ceil((w - b.pool_k) / b.pool_stride)) + 1
        c = b.out_channels
    return h, w, c


def mms_qa_init(key, cfg: MMSQAConfig, *, pretrained=None, dtype=jnp.float32):
    """Build (params, state)."""
    keys = jax.random.split(key, 4 + len(cfg.blocks))
    params: dict = {}
    state: dict = {}

    params["embed"] = embed_init(
        keys[0], cfg.vocab_size, cfg.embed_dim, pretrained=pretrained,
        minval=-cfg.embed_init_range, maxval=cfg.embed_init_range, dtype=dtype)

    if cfg.sim_mode == 2:
        m, d = cfg.sim_measures, cfg.embed_dim
        if cfg.sim_weight_init == "zeros":
            w = jnp.zeros((m, d, d), dtype)
        elif cfg.sim_weight_init == "xavier":
            w = fillers.xavier(keys[1], (m, d, d), fan_in=d * d, dtype=dtype)
        else:
            raise ValueError(cfg.sim_weight_init)
        params["sim"] = {"w": w}
        if cfg.sim_bias:
            params["sim"]["b"] = jnp.zeros(
                (m, cfg.question_len, cfg.answer_len), dtype)

    in_ch = cfg.sim_channels()
    for i, b in enumerate(cfg.blocks):
        params[f"conv{i}"] = conv_init(keys[2 + i], in_ch, b.out_channels,
                                       b.kh, b.kw, dtype=dtype)
        bn_p, bn_s = bn_init(b.out_channels, shift_value=cfg.bn_shift_init,
                             dtype=dtype)
        params[f"bn{i}"] = bn_p
        state[f"bn{i}"] = bn_s
        in_ch = b.out_channels

    h, w, c = _spatial_after_blocks(cfg)
    feat_dim = h * w * c + cfg.overlap_features
    k1, k2 = keys[-2], keys[-1]
    params["fc1"] = {
        "w": fillers.xavier(k1, (feat_dim, cfg.fc1_dim), fan_in=feat_dim,
                            dtype=dtype),
        "b": jnp.zeros((cfg.fc1_dim,), dtype),
    }
    params["fc2"] = {
        "w": fillers.xavier(k2, (cfg.fc1_dim, cfg.num_classes),
                            fan_in=cfg.fc1_dim, dtype=dtype),
        "b": jnp.zeros((cfg.num_classes,), dtype),
    }
    return params, state


def sim_map(params, q_emb, a_emb, cfg: MMSQAConfig):
    """The SimCross stage: (N,W1,D),(N,W2,D) -> (N,W1,W2,M|1)."""
    if cfg.sim_mode == 0:
        return sim_cross_cosine(q_emb, a_emb)
    if cfg.sim_mode == 1:
        return sim_cross_inv_euclidean(q_emb, a_emb)
    sim = params["sim"]
    return sim_cross_bilinear(q_emb, a_emb, sim["w"], sim.get("b"))


def mms_qa_apply(params, state, batch, cfg: MMSQAConfig, *, train: bool,
                 rng=None, compute_dtype=None, q_emb=None, a_emb=None):
    """Forward pass.

    batch: {'question': int (N, W1), 'answer': int (N, W2),
            'overlap_feat': (N, F), optional 'label': int (N,)}
    Returns (out, new_state) with out = {'logits', 'prob'[, 'loss']}.

    q_emb/a_emb: optional precomputed (N, W, D) embedding activations that
    REPLACE the table lookups -- differentiating the loss w.r.t. these is
    exactly the reference's embedding-output backprop (the saliency path,
    do_trec_qa_clean.py:654-779) without duplicating the forward chain.
    """
    if train and rng is None:
        raise ValueError("training forward needs a dropout rng")
    if q_emb is None:
        q_emb = embed_lookup(params["embed"], batch["question"])
    if a_emb is None:
        a_emb = embed_lookup(params["embed"], batch["answer"])
    x = sim_map(params, q_emb, a_emb, cfg)
    if compute_dtype is not None:
        x = x.astype(compute_dtype)

    drop_i = 0

    def next_key():
        nonlocal drop_i
        drop_i += 1
        return jax.random.fold_in(rng, drop_i) if rng is not None else None

    if cfg.sim_dropout > 0:
        x = dropout(next_key(), x, cfg.sim_dropout, train=train) \
            if train else x

    new_state = dict(state)
    from ..ops import avg_pool2d, max_pool2d  # local to avoid cycle at import
    for i, b in enumerate(cfg.blocks):
        x = conv2d(params[f"conv{i}"], x)
        x, new_state[f"bn{i}"] = bn_apply(params[f"bn{i}"], state[f"bn{i}"], x,
                                          train=train)
        pool = max_pool2d if b.pool == "max" else avg_pool2d
        x = pool(x, b.pool_k, b.pool_k, stride_h=b.pool_stride,
                 stride_w=b.pool_stride)
        x = jnp.tanh(x)

    flat = x.reshape(x.shape[0], -1)
    feat = jnp.concatenate(
        [flat, batch["overlap_feat"].astype(flat.dtype)], axis=1)

    h = jnp.tanh(feat @ params["fc1"]["w"] + params["fc1"]["b"])
    if train and cfg.fc1_dropout > 0:
        h = dropout(next_key(), h, cfg.fc1_dropout, train=True)
    logits = (h @ params["fc2"]["w"] + params["fc2"]["b"]).astype(jnp.float32)

    out = {"logits": logits, "prob": jax.nn.softmax(logits, axis=-1)}
    if "label" in batch:
        out["loss"] = softmax_cross_entropy(logits, batch["label"])
    return out, new_state


def param_spec(params, cfg: MMSQAConfig):
    """Per-parameter (lr_mult, decay_mult) tree matching the recipe.

    Reference ParamSpecs (do_trec_qa_clean.py):
      embed w (1, 0) / embed b (2, 0)              (:461-466)
      sim_cross W (1, 1); bias defaults to (1, 1)  (:468)
      conv w (1, 1) / conv b (2, 0)                (:352-356)
      bn scale (1, 0) / shift (1, 0)               (:357-359; running stats
                                                    live in `state`, lr 0)
      fc w (1, 0) / fc b (2, 0)                    (:481-488)
    """
    spec = {}
    for name, sub in params.items():
        if name == "embed":
            spec[name] = {"w": (1.0, 0.0)}
            if "b" in sub:
                spec[name]["b"] = (2.0, 0.0)
        elif name == "sim":
            spec[name] = {k: (1.0, 1.0) for k in sub}
        elif name.startswith("conv"):
            spec[name] = {"w": (1.0, 1.0), "b": (2.0, 0.0)}
        elif name.startswith("bn"):
            spec[name] = {"scale": (1.0, 0.0), "shift": (1.0, 0.0)}
        elif name.startswith("fc"):
            spec[name] = {"w": (1.0, 0.0), "b": (2.0, 0.0)}
        else:
            spec[name] = jax.tree.map(lambda _: (1.0, 1.0), sub)
    return spec
