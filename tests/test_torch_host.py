"""The port's own copies of the JAX package's host modules (corpus,
ground truth, metrics, decode, decoded-u8 cache) held to the originals.

The parity tests of the slice rely on these: the synthetic corpus must
come out byte for byte the same from both packages for a seed.
"""

import json
import os

import numpy as np
import pytest

from patent_tpu.data import ground_truth as jax_gt
from patent_tpu.data import schema as jax_schema
from patent_tpu.data import synthetic as jax_synth
from patent_tpu.input import cache as jax_cache
from patent_tpu.input import pipeline as jax_pipeline
from patent_tpu.metrics import retrieval_metrics as jax_metrics
from patent_tpu_torch.data import ground_truth as torch_gt
from patent_tpu_torch.data import schema as torch_schema
from patent_tpu_torch.data import synthetic as torch_synth
from patent_tpu_torch.input import cache as torch_cache
from patent_tpu_torch.input import pipeline as torch_pipeline
from patent_tpu_torch.metrics import retrieval_metrics as torch_metrics
from patent_tpu_torch.retrieval.cli_actions import write_synthetic_split


def _records(mod_synth, **kw):
    return [tuple(vars(r).values()) for r in mod_synth.synthetic_records(**kw)]


@pytest.mark.parametrize("seed,per_patent", [(0, 6), (3, 4), (5, 0)],
                         ids=["seed0x6", "seed3x4", "seed5-random"])
def test_synthetic_records_and_split_equal_jax(seed, per_patent):
    kw = dict(num_patents=25, figures_per_patent=per_patent, seed=seed)
    assert _records(torch_synth, **kw) == _records(jax_synth, **kw)
    jrec = jax_synth.synthetic_records(**kw)
    trec = torch_synth.synthetic_records(**kw)
    jq, jg = jax_gt.split_query_gallery(jrec, seed=42)
    tq, tg = torch_gt.split_query_gallery(trec, seed=42)
    assert [r.figure_id for r in tq] == [r.figure_id for r in jq]
    assert [r.figure_id for r in tg] == [r.figure_id for r in jg]
    for max_month in (None, 5):
        assert torch_gt.build_ground_truth(tq, tg, max_month) == \
            jax_gt.build_ground_truth(jq, jg, max_month)


@pytest.mark.parametrize("hard", [True, False], ids=["hard", "easy"])
def test_synthetic_png_bytes_equal_jax(tmp_path, hard):
    """The same PNG files, byte for byte, for the same records and seed."""
    recs = jax_synth.synthetic_records(num_patents=6, figures_per_patent=4,
                                       seed=1)
    jpaths = jax_synth.write_synthetic_images(recs, str(tmp_path / "j"),
                                              image_size=32, seed=2,
                                              hard=hard)
    trecs = torch_synth.synthetic_records(num_patents=6, figures_per_patent=4,
                                          seed=1)
    tpaths = torch_synth.write_synthetic_images(trecs, str(tmp_path / "t"),
                                                image_size=32, seed=2,
                                                hard=hard)
    assert [os.path.basename(p) for p in tpaths] == \
        [os.path.basename(p) for p in jpaths]
    for a, b in zip(tpaths, jpaths):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a


def test_cli_synthetic_split_equals_the_jax_clis(tmp_path):
    """write_synthetic_split gives the corpus the JAX CLI writes: the same
    files, bytes and ground truth."""
    write_synthetic_split(str(tmp_path / "t"), 32)
    recs = jax_synth.synthetic_records(num_patents=40, figures_per_patent=6,
                                       seed=0)
    q, g = jax_gt.split_query_gallery(recs, seed=42)
    for recs_, sub in ((g, "test_gallery"), (q, "test_query")):
        jax_synth.write_synthetic_images(recs_, str(tmp_path / "j" / sub),
                                         image_size=32, seed=0, hard=True)
        names = sorted(os.listdir(tmp_path / "j" / sub))
        assert sorted(os.listdir(tmp_path / "t" / sub)) == names
        for n in names:
            assert (tmp_path / "t" / sub / n).read_bytes() == \
                (tmp_path / "j" / sub / n).read_bytes()
    with open(tmp_path / "t" / "ground_truth.json") as f:
        assert json.load(f) == jax_gt.build_ground_truth(q, g, max_month=None)


def test_metadata_records_equal_jax():
    meta = jax_synth.synthetic_metadata(num_patents=8, seed=4)
    meta += [{"subfigure_file": "bad-name.png", "cpc": ["A01G"]},
             {"subfigure_file": "USD0000001-20180701-D00001_1.png"},
             {"figure_id": "USD0000002-20180301-D00001_1.png",
              "main_cpc": "B60R 1/00"}]
    for max_month in (None, 5):
        assert torch_schema.records_from_metadata(meta, max_month) == [
            torch_schema.FigureRecord(*vars(r).values())
            for r in jax_schema.records_from_metadata(meta, max_month)]


def test_metric_battery_equals_jax():
    rng = np.random.default_rng(0)
    gallery = [f"g{i}.png" for i in range(60)]
    gt = {f"q{i}.png": {"patent_positives": list(rng.choice(gallery, 3)),
                        "cpc_positives": list(rng.choice(gallery, 9))}
          for i in range(20)}
    rankings = {q: list(rng.permutation(gallery)) for q in list(gt)[:18]}
    rankings["stray.png"] = gallery
    for key in ("patent_positives", "cpc_positives"):
        want = jax_metrics.evaluate_rankings(rankings, gt, key)
        got = torch_metrics.evaluate_rankings(rankings, gt, key)
        assert got.detailed_dict() == want.detailed_dict()
        assert (got.num_queries, got.num_skipped, got.num_missing_rankings) \
            == (want.num_queries, want.num_skipped, want.num_missing_rankings)
        assert str(got) == str(want)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp("imgs")
    recs = jax_synth.synthetic_records(num_patents=5, figures_per_patent=3,
                                       seed=0)
    paths = jax_synth.write_synthetic_images(recs, str(root), image_size=48)
    (root / "broken.png").write_bytes(b"not a png")
    return sorted(paths + [str(root / "broken.png")])


@pytest.mark.parametrize("out_dtype,native", [("u8", False), ("f32", False),
                                              ("u8", None), ("f32", None)],
                         ids=["u8-pil", "f32-pil", "u8-auto", "f32-auto"])
def test_image_batcher_equals_jax(images, out_dtype, native):
    """Same batches, names and counts (the undecodable file skipped), from
    PIL or from the native decoder when it is built."""
    kw = dict(batch_size=4, image_size=32, num_workers=2,
              out_dtype=out_dtype, use_native=native)
    want = list(jax_pipeline.ImageBatcher(images, **kw))
    got = list(torch_pipeline.ImageBatcher(images, **kw))
    assert len(got) == len(want) == 4
    for (gb, gn, gv), (wb, wn, wv) in zip(got, want):
        assert (gn, gv) == (wn, wv)
        np.testing.assert_array_equal(gb, wb)
    assert sum(v for _b, _n, v in got) == len(images) - 1
    assert torch_pipeline.list_images(os.path.dirname(images[0])) == \
        jax_pipeline.list_images(os.path.dirname(images[0]))


def test_decoded_cache_shares_files_with_jax(images, tmp_path):
    """Rows the JAX cache wrote are hits for the port's, and the other way
    round; batches through either cache equal the uncached ones."""
    with jax_cache.DecodedU8Cache(str(tmp_path), 32) as jc:
        list(jax_pipeline.ImageBatcher(images[:6], batch_size=4,
                                       image_size=32, out_dtype="u8",
                                       use_native=False, cache=jc))
    plain = list(torch_pipeline.ImageBatcher(images, batch_size=4,
                                             image_size=32, out_dtype="u8",
                                             use_native=False))
    with torch_cache.DecodedU8Cache(str(tmp_path), 32) as tc:
        cached = list(torch_pipeline.ImageBatcher(
            images, batch_size=4, image_size=32, out_dtype="u8",
            use_native=False, cache=tc))
        assert tc.hits == 6 and len(tc) == len(images) - 1
    for (cb, cn, cv), (pb, pn, pv) in zip(cached, plain):
        assert (cn, cv) == (pn, pv)
        np.testing.assert_array_equal(cb, pb)
    with jax_cache.DecodedU8Cache(str(tmp_path), 32) as jc:
        for p in images:
            row = jc.get(p)
            assert (row is None) == p.endswith("broken.png")
        assert jc.misses == 1
