"""Deployment export (deploy.py): the inference program + weights
serialize to ONE StableHLO artifact that replays without the model
code — the rebuild's analog of the reference's frozen .caffemodel +
deploy-prototxt pair (tools/caffe.cpp:229-296 test path)."""

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mms_answer_selection_tpu import deploy
from mms_answer_selection_tpu.models.mms_qa import (ConvBlock, MMSQAConfig,
                                                    mms_qa_apply,
                                                    mms_qa_init)

CFG = MMSQAConfig(
    vocab_size=40, embed_dim=16, question_len=8, answer_len=8,
    sim_measures=2,
    blocks=(ConvBlock(3, 3, 4, "ave", 2, 2), ConvBlock(2, 2, 4, "ave", 1, 1)),
    fc1_dim=4)

rng = np.random.default_rng(3)


@pytest.fixture(scope="module")
def model():
    params, state = mms_qa_init(jax.random.PRNGKey(0), CFG)
    params["sim"]["w"] = jnp.asarray(
        rng.normal(size=params["sim"]["w"].shape).astype(np.float32) * 0.2)
    return params, state


def _batch(n):
    return (rng.integers(0, CFG.vocab_size, (n, CFG.question_len)),
            rng.integers(0, CFG.vocab_size, (n, CFG.answer_len)),
            rng.random((n, CFG.overlap_features)).astype(np.float32))


class TestRoundTrip:
    def test_matches_live_model(self, model, tmp_path):
        params, state = model
        path = str(tmp_path / "m.mmsx")
        header = deploy.save_scorer(path, params, state, CFG,
                                    platforms=("cpu",))
        assert header["question_len"] == CFG.question_len
        scorer = deploy.load_scorer(path)
        q, a, o = _batch(5)
        logits, prob = scorer(q, a, o)
        out, _ = mms_qa_apply(
            params, state,
            {"question": jnp.asarray(q, jnp.int32),
             "answer": jnp.asarray(a, jnp.int32),
             "overlap_feat": jnp.asarray(o)},
            CFG, train=False)
        np.testing.assert_allclose(logits, np.asarray(out["logits"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(prob, np.asarray(out["prob"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(scorer.score(q, a, o), prob[:, 1],
                                   rtol=0)

    def test_symbolic_batch_serves_any_size(self, model, tmp_path):
        params, state = model
        path = str(tmp_path / "sym.mmsx")
        deploy.save_scorer(path, params, state, CFG, platforms=("cpu",))
        scorer = deploy.load_scorer(path)
        for n in (1, 3, 17):
            logits, prob = scorer(*_batch(n))
            assert logits.shape == (n, 2) and prob.shape == (n, 2)
            np.testing.assert_allclose(prob.sum(-1), 1.0, rtol=1e-5)

    def test_pinned_batch(self, model, tmp_path):
        params, state = model
        path = str(tmp_path / "b4.mmsx")
        header = deploy.save_scorer(path, params, state, CFG, batch=4,
                                    platforms=("cpu",))
        assert header["batch"] == 4
        scorer = deploy.load_scorer(path)
        logits, _ = scorer(*_batch(4))
        assert logits.shape == (4, 2)
        with pytest.raises(Exception):  # noqa: B017 — shape mismatch
            scorer(*_batch(3))

    def test_multi_platform_artifact_loads(self, model, tmp_path):
        # the cuda lowering is baked alongside cpu; the artifact must
        # still deserialize and run on the cpu backend
        params, state = model
        path = str(tmp_path / "mp.mmsx")
        header = deploy.save_scorer(path, params, state, CFG)
        assert header["platforms"] == ["cpu", "cuda"]
        scorer = deploy.load_scorer(path)
        logits, _ = scorer(*_batch(2))
        assert np.isfinite(logits).all()


class TestFileFormat:
    def test_bad_magic_rejected(self, tmp_path):
        p = tmp_path / "x.mmsx"
        p.write_bytes(b"NOTMAGIC" + b"\0" * 32)
        with pytest.raises(ValueError, match="magic"):
            deploy.load_scorer(str(p))

    def test_truncated_rejected(self, model, tmp_path):
        params, state = model
        path = str(tmp_path / "t.mmsx")
        deploy.save_scorer(path, params, state, CFG, platforms=("cpu",))
        blob = open(path, "rb").read()
        open(path, "wb").write(blob[:-20])
        with pytest.raises(ValueError, match="truncated"):
            deploy.load_scorer(path)

    def test_header_readable_without_program(self, model, tmp_path):
        params, state = model
        path = str(tmp_path / "h.mmsx")
        deploy.save_scorer(path, params, state, CFG, platforms=("cpu",))
        with open(path, "rb") as f:
            assert f.read(8) == deploy.MAGIC
            (hlen,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(hlen))
        assert header["vocab_size"] == CFG.vocab_size
