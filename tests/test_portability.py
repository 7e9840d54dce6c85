"""What the program needs from its installation, and the one-device smoke
test at tiny size.

The machines that run the program on a GPU are only sure to have JAX (with
its CUDA plugin), numpy, scipy, optax, chex and einops.  These tests run
the main path -- ``chip_smoke.py --rehearse``: ``qa prep/train/eval``,
the engines, rerank, IVF, the HTTP server and the exported scorer -- in a
subprocess where every other installed package fails to import.
"""

import importlib.metadata as md
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALLOWED = ("jax", "jaxlib", "numpy", "scipy", "optax", "chex", "einops")


def _norm(name: str) -> str:
    return name.lower().replace("_", "-")


def _allowed_closure() -> set:
    """The allowed distributions and everything they require."""
    seen, stack = set(), list(ALLOWED)
    while stack:
        name = _norm(stack.pop())
        if name in seen:
            continue
        seen.add(name)
        try:
            reqs = md.distribution(name).requires or []
        except md.PackageNotFoundError:
            continue
        stack += [re.split(r"[ ;<>=!~\[(]", r)[0] for r in reqs
                  if "extra ==" not in r]
    return seen


def _blocked_modules() -> list:
    """Top-level import names provided only by packages outside the
    allowed closure."""
    closure = _allowed_closure()
    blocked = []
    for top, dists in md.packages_distributions().items():
        if top.startswith("_") or top in sys.stdlib_module_names:
            continue
        if not any(_norm(d) in closure for d in dists):
            blocked.append(top)
    return sorted(blocked)


_BLOCKER = """
import importlib.abc, sys
BLOCKED = set({blocked!r})
class _Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"blocked: {{name}}", name=name)
        return None
sys.meta_path.insert(0, _Blocker())
"""


def _run_blocked(code: str, timeout: int = 600) -> subprocess.CompletedProcess:
    blocker = _BLOCKER.format(blocked=_blocked_modules())
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "-c", blocker + code], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_blocklist_covers_the_usual_suspects():
    blocked = set(_blocked_modules())
    for name in ("flax", "msgpack", "flatbuffers", "h5py", "matplotlib"):
        try:
            md.distribution(name)
        except md.PackageNotFoundError:
            continue
        assert name in blocked
    assert not blocked & {"jax", "numpy", "scipy", "optax", "chex"}


def test_smoke_rehearsal_runs_on_the_allowed_packages():
    """Every phase of chip_smoke.py at tiny size, kernels interpreted."""
    proc = _run_blocked(
        "import sys, runpy; sys.argv = ['chip_smoke.py', '--rehearse']; "
        "runpy.run_path('chip_smoke.py', run_name='__main__')")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "cpu", "kind": "cpu", "count": 1}}
    for phase in ("[kernels] int8", "[train] qa eval", "[serve] query_ivf",
                  "[serve] QAServer", "[serve] exported scorer"):
        assert any(line.startswith(phase) for line in lines), phase


def test_entry_points_import_without_optional_packages():
    proc = _run_blocked(
        "import mms_answer_selection_tpu.training, "
        "mms_answer_selection_tpu.serve, mms_answer_selection_tpu.cli, "
        "mms_answer_selection_tpu.deploy, bench; print('ok')", timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


class TestSmokeHelpers:
    """The pieces of chip_smoke.py that decide pass or fail."""

    @pytest.fixture(scope="class")
    def smoke(self):
        sys.path.insert(0, ROOT)
        import chip_smoke
        return chip_smoke

    def test_topk_check_accepts_near_ties(self, smoke):
        ref = np.array([[10.0, 9.99, 9.98, 1.0, 0.5]])
        # a near-tie swap of the 3rd and 4th best is within tolerance
        idx = np.array([[0, 1, 2]])
        vals = ref[:, [0, 1, 2]]
        assert smoke.check_topk("t", vals, idx, ref, 0.01, k=3) <= 0.01

    def test_topk_check_rejects_a_wrong_index(self, smoke):
        ref = np.array([[10.0, 9.0, 8.0, 1.0, 0.5]])
        with pytest.raises(AssertionError, match="off the reference"):
            smoke.check_topk("t", ref[:, [0, 1, 3]], np.array([[0, 1, 3]]),
                             ref, 0.01, k=3)

    def test_topk_check_rejects_padding(self, smoke):
        ref = np.array([[3.0, 2.0, 1.0]])
        with pytest.raises(AssertionError, match="padding"):
            smoke.check_topk("t", np.array([[3.0, -1e30]]),
                             np.array([[0, -1]]), ref, 0.01, k=2)

    def test_sizes_keep_the_recipe_widths(self, smoke):
        full = smoke.FULL
        assert (full.d, full.w, full.m) == (50, 40, 4)
        assert full.pool == 262144 and full.full_model
        assert full.kernel_queries >= 8 and full.kernel_pool >= 4096
        assert full.four_batch % 4 == 0 and smoke.TINY.four_batch % 4 == 0


class TestCheckpointFormat:
    """Checkpoints are numpy-only: one ``ckpt.npz`` array per pytree leaf,
    keyed by the leaf's path."""

    @staticmethod
    def _bundle():
        import collections

        import optax
        State = collections.namedtuple("State", "count mu")
        params = {"embed": {"w": np.arange(6.0, dtype=np.float32)
                            .reshape(2, 3)},
                  "fc": {"b": np.ones(4, np.float32)}}
        opt = optax.adam(1e-3).init(params)
        return {"params": params, "opt_state": opt,
                "extra": (State(np.int32(3), np.zeros(2, np.float32)),
                          [np.float32(1.5)])}

    def test_round_trip_with_template(self, tmp_path):
        import jax
        from mms_answer_selection_tpu.training.checkpoint import (
            CKPT_FILE, load_checkpoint, save_checkpoint)
        bundle = self._bundle()
        path = save_checkpoint(str(tmp_path), 7, bundle, meta={"x": 1})
        assert os.path.exists(os.path.join(path, CKPT_FILE))
        loaded, meta = load_checkpoint(path, template=bundle)
        assert meta == {"step": 7, "x": 1}
        assert (jax.tree.structure(loaded) == jax.tree.structure(bundle))
        for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(bundle)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_raw_load_nests_by_path(self, tmp_path):
        from mms_answer_selection_tpu.training.checkpoint import (
            load_checkpoint, save_checkpoint)
        path = save_checkpoint(str(tmp_path), 1, self._bundle())
        raw, _ = load_checkpoint(path)
        np.testing.assert_array_equal(raw["params"]["embed"]["w"],
                                      self._bundle()["params"]["embed"]["w"])
        # sequences come back keyed by index, named tuples by field
        assert raw["extra"]["0"]["count"] == 3
        assert float(raw["extra"]["1"]["0"]) == 1.5

    def test_file_holds_no_pickles(self, tmp_path):
        from mms_answer_selection_tpu.training.checkpoint import (
            CKPT_FILE, save_checkpoint)
        path = save_checkpoint(str(tmp_path), 2, self._bundle())
        with np.load(os.path.join(path, CKPT_FILE),
                     allow_pickle=False) as z:
            assert "params/embed/w" in z.files

    @pytest.mark.parametrize("change,error", [
        ("shape", ValueError), ("missing", KeyError)])
    def test_template_mismatch_raises(self, tmp_path, change, error):
        from mms_answer_selection_tpu.training.checkpoint import (
            load_checkpoint, save_checkpoint)
        path = save_checkpoint(str(tmp_path), 3, self._bundle())
        template = self._bundle()
        if change == "shape":
            template["params"]["fc"]["b"] = np.ones(5, np.float32)
        else:
            template["params"]["fc"]["w"] = np.ones(2, np.float32)
        with pytest.raises(error):
            load_checkpoint(path, template=template)
