"""The port's host utilities held to patent_tpu on the CPU: the mapping
helpers, n-pair batching, early stopping (and its snapshot, which must
not alias tensors that an optimizer updates in place), the profiling and
finite-check helpers, and ``EmbeddingIndex``'s feature pickle."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from patent_tpu.data import graph_build as jax_graph
from patent_tpu.data import mappings as jax_mappings
from patent_tpu.input import npair as jax_npair
from patent_tpu.retrieval.index import EmbeddingIndex as JaxIndex
from patent_tpu.train.early_stopping import EarlyStopping as JaxStopping
from patent_tpu.utils import profiling as jax_profiling
from patent_tpu_torch.data import graph_build as torch_graph
from patent_tpu_torch.data import mappings
from patent_tpu_torch.data import synthetic
from patent_tpu_torch.input import npair
from patent_tpu_torch.retrieval.index import EmbeddingIndex
from patent_tpu_torch.train import early_stopping
from patent_tpu_torch.train.early_stopping import EarlyStopping
from patent_tpu_torch.utils import profiling


@pytest.fixture(scope="module")
def records():
    return synthetic.synthetic_records(num_patents=7, figures_per_patent=3,
                                       seed=0)


def test_mappings_equal_jax(records, tmp_path):
    names = [r.figure_id for r in records] + ["garbage.png"]
    for fn in ("figure_to_patent_map", "image_index"):
        assert getattr(mappings, fn)(names) == getattr(jax_mappings, fn)(
            names)
    for fn in ("patent_to_label_map", "positive_figure_pairs_by_patent"):
        assert getattr(mappings, fn)(records) == getattr(jax_mappings, fn)(
            records)
    assert len(mappings.positive_figure_pairs_by_patent(records)) == 7 * 3
    got = mappings.mappings_from_graph(torch_graph.build_hetero_graph(
        records))
    want = jax_mappings.mappings_from_graph(jax_graph.build_hetero_graph(
        records))
    assert got == want
    assert got["figure_to_patent"][records[0].figure_id] == \
        records[0].patent_id
    paths = [str(tmp_path / "torch.json"), str(tmp_path / "jax.json")]
    mappings.save_mappings(got, paths[0])
    jax_mappings.save_mappings(want, paths[1])
    with open(paths[0]) as a, open(paths[1]) as b:
        assert json.load(a) == json.load(b)


@pytest.mark.parametrize("shuffle,drop", [(True, False), (False, True)])
def test_npair_batches_equal_jax(shuffle, drop):
    pairs = [(0, 1), (0, 2), (3, 4), (5, 6), (7, 8), (7, 9), (10, 11)]
    a2p = npair.build_anchor_positives(pairs)
    assert a2p == jax_npair.build_anchor_positives(pairs)
    got = list(npair.npair_batches(a2p, 3, np.random.default_rng(4),
                                   shuffle=shuffle, drop_remainder=drop))
    want = list(jax_npair.npair_batches(a2p, 3, np.random.default_rng(4),
                                        shuffle=shuffle, drop_remainder=drop))
    assert len(got) == len(want) == (1 if drop else 2)   # 5 anchors
    for (a, p), (b, q) in zip(got, want):
        assert np.array_equal(a, b) and np.array_equal(p, q)
        assert all(int(pi) in a2p[int(ai)] for ai, pi in zip(a, p))
    x, y = np.array([1, 2]), np.array([10, 20])
    assert np.array_equal(npair.interleave(x, y), jax_npair.interleave(x, y))
    assert np.array_equal(npair.stacked(x, y), [1, 2, 10, 20])


def test_early_stopping_decisions_equal_jax():
    losses = [1.0, 0.9, 0.95, 0.9, 0.89, 0.91, 0.92, 0.93]
    ours, ref = EarlyStopping(patience=3, delta=0.005), JaxStopping(
        patience=3, delta=0.005)
    for i, v in enumerate(losses):
        assert ours(v, {"step": i}) == ref(v, {"step": i})
        assert (ours.counter, ours.best_score) == (ref.counter,
                                                   ref.best_score)
    assert ours.early_stop and ours.best_state == {"step": 4}


def test_early_stopping_best_state_survives_in_place_steps(monkeypatch):
    """The trap of the JAX class's ``tree.map(lambda x: x)``: on tensors it
    keeps references, which an in-place optimizer step rewrites.  The
    port's snapshot clones; with an aliasing snapshot the check fails."""

    def run():
        model = torch.nn.Linear(4, 2)
        opt = torch.optim.SGD(model.parameters(), lr=0.5)
        stop = EarlyStopping(patience=2)
        stop(1.0, {"model": model.state_dict(), "extra": [model.bias]})
        kept = {k: v.clone() for k, v in model.state_dict().items()}
        model(torch.ones(3, 4)).sum().backward()
        opt.step()
        stop(2.0, model.state_dict())
        best = stop.best_state
        return (all(torch.equal(best["model"][k], kept[k]) for k in kept)
                and torch.equal(best["extra"][0], kept["bias"])
                and not torch.equal(best["model"]["weight"], model.weight))

    assert run()
    monkeypatch.setattr(early_stopping, "snapshot", lambda state: state)
    assert not run()


def test_profile_trace_writes_a_trace(tmp_path):
    with profiling.profile_trace(str(tmp_path / "trace")) as trace:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert os.path.dirname(trace.path) == str(tmp_path / "trace")
    with open(trace.path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert trace.launches() == 0            # no card here
    assert trace.profiler.key_averages()


def test_step_timer_equals_jax_in_kind():
    ours, ref = profiling.StepTimer(warmup=1), jax_profiling.StepTimer(
        warmup=1)
    for _ in range(5):
        ours.mark()
        ref.mark()
    got, want = ours.summary(), ref.summary()
    assert set(got) == set(want) and got["steps"] == want["steps"] == 3
    assert got["mean_ms"] >= 0 and got["p95_ms"] >= got["p50_ms"] >= 0
    assert profiling.StepTimer().summary() == {"steps": 0}


def test_assert_all_finite_names_the_path():
    good = {"a": np.ones(3), "b": [torch.zeros(2), (torch.arange(3),)],
            "sd": torch.nn.Linear(2, 2).state_dict()}
    profiling.assert_all_finite(good, "good")
    bad = {"a": np.ones(3), "b": [torch.zeros(2),
                                  (torch.tensor([1.0, float("nan"),
                                                 float("inf")]),)]}
    with pytest.raises(FloatingPointError,
                       match=r"bad\['b'\]\[1\]\[0\]: 2 non-finite"):
        profiling.assert_all_finite(bad, "bad")
    sd = torch.nn.Linear(2, 2).state_dict()
    sd["weight"][0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match=r"sd\['weight'\]: 1 "):
        profiling.assert_all_finite(sd, "sd")
    with pytest.raises(FloatingPointError, match=r"x\['a'\]: 1 non-finite"):
        profiling.assert_all_finite({"a": np.array([np.nan, 1.0])}, "x")
    with pytest.raises(FloatingPointError):
        jax_profiling.assert_all_finite({"a": np.array([np.nan, 1.0])}, "x")


def test_debug_nan_guard_zeroes_and_warns():
    x = torch.tensor([1.0, float("nan"), -float("inf"), 2.0])
    with pytest.warns(RuntimeWarning, match="2 non-finite in grads"):
        y = profiling.debug_nan_guard(x, "grads")
    assert torch.equal(y, torch.tensor([1.0, 0.0, 0.0, 2.0]))
    clean = torch.ones(3)
    assert torch.equal(profiling.debug_nan_guard(clean), clean)


def test_feature_pickle_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    gallery = rng.standard_normal((12, 16)).astype(np.float32)
    names = [f"/abs/path/img_{i:03d}.png" for i in range(12)]
    ours = EmbeddingIndex(gallery, names, device="cpu")
    ref = JaxIndex(gallery, names)
    for base in (True, False):
        got, want = ours.to_feature_dict(base), ref.to_feature_dict(base)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == np.float32 and np.array_equal(got[k],
                                                                 want[k])
    paths = [str(tmp_path / "torch.pkl"), str(tmp_path / "jax.pkl")]
    ours.save_feature_pickle(paths[0])
    ref.save_feature_pickle(paths[1])
    loaded = []
    for p in paths:
        with open(p, "rb") as f:
            loaded.append(pickle.load(f))
    assert list(loaded[0]) == [f"img_{i:03d}.png" for i in range(12)]
    assert all(type(v) is np.ndarray and v.dtype == np.float32
               and np.array_equal(v, loaded[1][k])
               for k, v in loaded[0].items())


def test_port_quickstart_runs_without_jax(tmp_path):
    """examples/quickstart_torch.py on the CPU, in a process that never
    loads JAX or patent_tpu: every stage runs and training lifts the
    label-retrieval mAP."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import runpy, sys\n"
            "sys.argv = ['quickstart_torch.py', '--cpu', '--epochs', '8',\n"
            f"            '--workdir', {str(tmp_path)!r}]\n"
            "runpy.run_path('examples/quickstart_torch.py',\n"
            "               run_name='__main__')\n"
            "assert 'jax' not in sys.modules\n"
            "assert not [m for m in sys.modules if m == 'patent_tpu'\n"
            "            or m.startswith('patent_tpu.')]\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "== quickstart complete" in proc.stdout
    assert "in the patent and CPC rows" in proc.stdout
