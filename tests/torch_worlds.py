"""Functions that every rank of a world runs
(``patent_tpu_torch.parallel.launch.run_world``) to check the sharded
paths against their one-process versions; each returns rank 0's numbers as
numpy, for the CPU tests (tests/test_torch_parallel.py,
test_torch_sharded_index.py, test_torch_sharded_train.py,
test_torch_gpu.py) and ``chip_smoke.py`` to judge.  This is a helper, not
a test module, and imports nothing of JAX: a spawned rank loads it by name
(``tests`` on ``sys.path``) with the port and nothing else.

``device`` is "cpu" or "cuda"; meshes are one-dimensional over ``data``
unless a function says otherwise.
"""

from __future__ import annotations

import json
import os
import urllib.request

import numpy as np
import torch
import torch.distributed as dist

from patent_tpu_torch.parallel.mesh import (
    RowBlocks, all_gather_rows, axis_group, axis_rank, axis_size,
    data_parallel_sharding, encode_sharded, label_table_sharding, make_mesh,
    mesh_device, shard_batch)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _gather_list(obj, group=None) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


# --------------------------------------------------------------- mesh + encode

def _towers(cfg_kwargs: dict, bf16_state: dict, int8_state: dict, device):
    from patent_tpu_torch.models.vit import VisionConfig, VisionTransformer
    from patent_tpu_torch.models.vit_int8 import Int8VisionTransformer

    cfg = VisionConfig(**cfg_kwargs)
    bf16 = VisionTransformer(cfg, device=device)
    bf16.load_state_dict({k: torch.as_tensor(v) for k, v in
                          bf16_state.items()})
    int8 = Int8VisionTransformer(cfg, device=device)
    int8.load_state_dict({k: torch.as_tensor(v) for k, v in
                          int8_state.items()})
    return bf16.eval(), int8.eval()


def encode_world(device: str, cfg_kwargs: dict, bf16_state: dict,
                 int8_state: dict, batches: dict) -> dict:
    """Mesh helpers, then ``encode_sharded`` with both towers over every
    rank for each global batch in ``batches`` ({name: [B, H, W, 3] f32}):
    the sharded features (padded to the global batch's dispatch), the
    one-rank encode of the global batch, and the one-rank encode of each
    rank's block alone (the control: the blocks' function)."""
    mesh = make_mesh(device=device)
    dev = mesh_device(mesh)
    n = dist.get_world_size()
    out = {"mesh_shape": tuple(mesh.shape),
           "names": tuple(mesh.mesh_dim_names),
           "sizes": (axis_size(mesh, "data"), axis_size(mesh, "model")),
           "bounds10": _gather_list(RowBlocks("data").bounds(mesh, 10)),
           "rules": {k: v.axis for k, v in
                     data_parallel_sharding(mesh).items()},
           "table_rule": label_table_sharding(mesh).axis,
           "shard_batch": _gather_list(_np(shard_batch(
               mesh, np.arange(2 * n))).tolist())}
    try:
        shard_batch(mesh, np.arange(2 * n + 1))
        out["shard_batch_odd"] = "accepted"
    except ValueError as e:
        out["shard_batch_odd"] = str(e)
    towers = dict(zip(("bf16", "int8"),
                      _towers(cfg_kwargs, bf16_state, int8_state, dev)))
    for name, px in batches.items():
        x = torch.as_tensor(px)
        per = -(-x.shape[0] // n)
        for tname, tower in towers.items():
            key = f"{tname}_{name}"
            out[key] = _np(encode_sharded(mesh, tower)(px))
            with torch.inference_mode():
                out[key + "_one"] = _np(tower(x.to(dev)))
                out[key + "_blocks"] = np.concatenate(
                    [_np(tower(x[s:s + per].to(dev)))
                     for s in range(0, x.shape[0], per)])
    return out


# ---------------------------------------------------------------- the index

def _search(fn, *args, **kw):
    vals, idx = fn(*args, **kw)
    return _np(vals), _np(idx)


def index_world(device: str, cases: dict, tmp: str | None = None) -> dict:
    """The four sharded searches and ``EmbeddingIndex(mesh=...)`` over
    every rank (each case a dict of numpy inputs, see the tests and
    ``chip_smoke.py``), and a "service" case: the follower-loop service
    over HTTP and the index's save from rank 0 into ``tmp``."""
    from patent_tpu_torch.ops.topk_kernel import (
        prepare_cosine_gallery_bf16, prepare_poincare_gallery,
        quantize_gallery)
    from patent_tpu_torch.retrieval import index as ix

    mesh = make_mesh((dist.get_world_size(),), ("data",), device=device)
    dev = mesh_device(mesh)
    out = {}
    for name, case in cases.items():
        kind, g, q = case["kind"], case["gallery"], case["queries"]
        k, bs = case.get("k"), case.get("block_size", 8192)
        if kind == "service":
            out[name] = _service(mesh, dev, case, tmp)
        elif kind == "scan":
            out[name] = _search(ix.sharded_topk_search, mesh, q, g, k=k,
                                similarity=case.get("similarity", "cosine"),
                                c=case.get("c", 1.0), block_size=bs)
        elif kind == "cosine_fast":
            gal16, valid = prepare_cosine_gallery_bf16(torch.as_tensor(g))
            if "valid" in case:
                valid = torch.as_tensor(case["valid"])
            out[name] = _search(ix.sharded_topk_search_cosine_fast, mesh, q,
                                gal16, valid, g, k=k, block_size=bs)
        elif kind == "quantized":
            i8, scale = quantize_gallery(g)
            out[name] = _search(ix.sharded_topk_search_quantized, mesh, q,
                                i8, scale, g, k=k, block_size=bs)
        elif kind == "poincare_fast":
            gal = prepare_poincare_gallery(torch.as_tensor(g), case["c"])
            out[name] = _search(ix.sharded_topk_search_poincare_fast, mesh,
                                q, gal, g, k=k, c=case["c"], block_size=bs)
        elif kind == "hyp_engine":
            out[name] = _hyp_engine(mesh, dev, case)
        elif kind == "index":
            kw = dict(similarity=case.get("similarity", "cosine"),
                      c=case.get("c", 1.0),
                      quantized=case.get("quantized", False))
            names = [f"g{i}" for i in range(len(g))]
            sharded = ix.EmbeddingIndex(g, names, mesh=mesh, **kw)
            single = ix.EmbeddingIndex(g, names, device=dev, **kw)
            res = {"bf16_before": sharded._gal16 is not None}
            for kk in case["ks"]:
                res[kk] = (sharded.search(q, k=kk), single.search(q, k=kk),
                           sharded._gal16 is not None)
            res["local_rows"] = _gather_list(
                (int(sharded.embeddings.shape[0]),
                 int(getattr(sharded, "emb_i8", sharded.embeddings).shape[0])))
            whole = torch.as_tensor(g, device=dev)
            res["held"] = _gather_list(
                [_held(ix.EmbeddingIndex(src, names, mesh=mesh, **kw), src)
                 for src in (g, whole)])
            res["row5"] = sharded.row(5)
            res["features"] = sharded.to_feature_dict()["g7"]
            out[name] = res
    return out


def _held(index, src) -> tuple[int, bool]:
    """(bytes of the storage behind the index's f32 rows, whether it lies
    in the memory of ``src``, the gallery the index was built from)."""
    store = index.embeddings.untyped_storage()
    base = torch.as_tensor(src).untyped_storage()
    lo, hi = base.data_ptr(), base.data_ptr() + base.nbytes()
    return store.nbytes(), lo <= store.data_ptr() < hi


def _hyp_engine(mesh, dev, case: dict) -> dict:
    """``HyperbolicRetrievalEngine(mesh=...)`` against one process's engine
    over the same features and seeded model: the answers of ``retrieve``,
    and the bytes of each rank's stored rows."""
    from patent_tpu_torch.models.hyperbolic import HyperbolicEmbeddingModel
    from patent_tpu_torch.retrieval.hyperbolic_engine import \
        HyperbolicRetrievalEngine

    f, q = case["gallery"], case["queries"]
    model = HyperbolicEmbeddingModel(
        feature_dim=f.shape[1], embed_dim=case["embed_dim"], label_num=5,
        hidden_dims=(case["hidden"],), c=case["c"],
        generator=torch.Generator().manual_seed(3))
    names = [f"f{i}" for i in range(len(f))]
    res = {}
    for quantized in (False, True):
        kw = dict(batch_size=case["batch_size"], quantized=quantized)
        sharded = HyperbolicRetrievalEngine(model, f, names, dev, mesh=mesh,
                                            **kw)
        single = HyperbolicRetrievalEngine(model, f, names, dev, **kw)
        res[quantized] = {
            "sharded": sharded.retrieve(q, k=case["k"]),
            "single": single.retrieve(q, k=case["k"]),
            "bytes": _gather_list(sharded.index.embeddings.untyped_storage()
                                  .nbytes())}
    return res


def _http(url: str, payload=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data)
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _service(mesh, dev, case: dict, tmp: str) -> dict:
    """Rank 0 serves a sharded index over HTTP (features and name
    searches, /stats) while the others follow; then the index is saved
    from rank 0 and every rank reports how many requests it served."""
    from patent_tpu_torch.retrieval.engine import RetrievalEngine
    from patent_tpu_torch.retrieval.index import EmbeddingIndex
    from patent_tpu_torch.retrieval.server import follow, serve

    g, q = case["gallery"], case["queries"]
    names = [f"figs/g{i}.png" for i in range(len(g))]
    engine = RetrievalEngine(lambda b: b, dev, batch_size=32, image_size=32,
                             mesh=mesh)
    engine.index = EmbeddingIndex(g, names, mesh=mesh)
    res = {}
    if axis_rank(mesh, "data") == 0:
        server = serve(engine, port=0, block=False)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            res["stats"] = _http(base + "/stats")
            res["features"] = _http(base + "/search",
                                    {"features": q.tolist(), "k": 5})
            res["name"] = _http(base + "/search", {"name": names[9], "k": 4})
        finally:
            server.shutdown()
            server.server_close()
            server.service.close()
        served = -1
    else:
        served = follow(engine)
    res["served"] = _gather_list(served)
    engine.index.save(os.path.join(tmp, "sharded"))
    return res


# ------------------------------------------------------------- training

def _gather_table(block: torch.Tensor, mesh) -> np.ndarray:
    """A row-sharded table, whole (on every rank)."""
    return _np(all_gather_rows(block.detach().contiguous(),
                               axis_group(mesh, "model")))


def _hyp_batch(arrays, device) -> tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(np.asarray(a)).to(
        device, torch.float32 if i >= 4 else torch.long)
        for i, a in enumerate(arrays))


def hyp_train_world(device: str, data: dict, state: dict, model_kwargs: dict,
                    cfg_kwargs: dict, cases: tuple) -> dict:
    """One train_hyp step from ``state`` on the batch ``data["batch"]``
    (six arrays, ``train_hyp.BATCH_FIELDS`` order) in one process and
    sharded, for each case (name, model_dim, use_dropout): the metrics,
    the updated parameters (the table whole, padded rows included) and
    the sharded table's row counts; and the refusal of an unpadded table
    over ``model`` = 2."""
    from patent_tpu_torch.models.hyperbolic import HyperbolicEmbeddingModel
    from patent_tpu_torch.parallel.sharded_train import (
        make_hyp_mesh, make_sharded_train_step, pad_label_table,
        shard_hyp_state)
    from patent_tpu_torch.train import train_hyp as th
    from patent_tpu_torch.train.optim import RiemannianAdam
    from patent_tpu_torch.utils.config import HypTrainConfig

    dev = torch.device(device, torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    x = torch.as_tensor(data["x_figures"]).to(dev)
    impl = torch.as_tensor(data["implication"]).long().to(dev)
    excl = torch.as_tensor(data["exclusion"]).long().to(dev)
    lr = cfg_kwargs["learning_rate"]

    def fresh():
        model = HyperbolicEmbeddingModel(**model_kwargs).to(dev)
        model.load_state_dict({k: torch.as_tensor(v) for k, v in
                               state.items()})
        opt = RiemannianAdam(dict(model.named_parameters()), lr,
                             c=model_kwargs["c"])
        return model, opt

    out = {}
    for name, model_dim, use_dropout in cases:
        cfg = HypTrainConfig(**cfg_kwargs, use_dropout=use_dropout)
        model, opt = fresh()
        gen = torch.Generator(device=dev).manual_seed(7)
        grads, single = th.step_grads(model, opt, th.make_loss_fn(model, cfg),
                                      _hyp_batch(data["batch"], dev), x, impl,
                                      excl, gen if use_dropout else None)
        opt.step(grads)
        mesh = make_hyp_mesh(model_dim=model_dim, device=device)
        smodel, sopt = fresh()
        _m, _o, real, padded = pad_label_table(smodel, sopt, model_dim)
        step, place_batch, place_static = make_sharded_train_step(
            mesh, smodel, sopt, cfg, num_real_labels=real)
        shard_hyp_state(mesh, smodel, sopt)
        gen = torch.Generator(device=dev).manual_seed(7)
        sharded = step(place_batch(data["batch"]),
                       *place_static(data["x_figures"], data["implication"],
                                     data["exclusion"]),
                       gen if use_dropout else None)
        params = {k: _np(v) for k, v in smodel.state_dict().items()}
        params["label_emb"] = _gather_table(smodel.label_emb, mesh)
        out[name] = {
            "single": _np(single), "sharded": _np(sharded),
            "single_params": {k: _np(v) for k, v in
                              model.state_dict().items()},
            "sharded_params": params, "real": real, "padded": padded,
            "block_rows": _gather_list(int(smodel.label_emb.shape[0]))}
    mesh = make_hyp_mesh(model_dim=2, device=device)
    model, opt = fresh()
    try:
        shard_hyp_state(mesh, model, opt)
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    return out


def finetune_world(device: str, vc_kwargs: dict, cfg_kwargs: dict,
                   vgae: np.ndarray, state: dict, images: np.ndarray,
                   node_idx: np.ndarray, alpha: float, model_dim: int,
                   steps: int = 1) -> dict:
    """``steps`` fine-tune steps from ``state`` on one global batch in one
    process (rank 0) and sharded over a (data, model_dim) mesh: the
    metrics of each step, the updated state dicts (the graph table whole,
    padded rows included), and the batch guard's refusal of 3 pairs."""
    from patent_tpu_torch.models.vit import VisionConfig
    from patent_tpu_torch.train import finetune_clip as ft
    from patent_tpu_torch.utils.config import ClipFinetuneConfig

    dev = torch.device(device, torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    vc, cfg = VisionConfig(**vc_kwargs), ClipFinetuneConfig(**cfg_kwargs)

    def fresh():
        model, opt = ft.init_finetune_state(vc, cfg, vgae, device=dev)
        model.load_state_dict({k: torch.as_tensor(v) for k, v in
                               state.items()})
        return model, opt

    out = {}
    if dist.get_rank() == 0:
        model, opt = fresh()
        step, _ev = ft.make_finetune_step(model, opt)
        imgs = torch.as_tensor(images).to(dev)
        nodes = torch.as_tensor(node_idx).to(dev)
        out["single"] = [{k: float(v) for k, v in step(imgs, nodes,
                                                        alpha).items()}
                         for _ in range(steps)]
        out["single_params"] = {k: _np(v) for k, v in
                                model.state_dict().items()}
        del model, opt
    mesh = make_mesh((dist.get_world_size() // model_dim, model_dim),
                     device=device)
    model, opt = fresh()
    _m, _o, real, padded = ft.pad_graph_table(model, opt, model_dim)
    step, eval_step, place_batch = ft.make_sharded_finetune_step(mesh, model,
                                                                 opt)
    ft.shard_finetune_state(mesh, model, opt)
    imgs, nodes = place_batch(images, node_idx)
    out["eval"] = {k: float(v) for k, v in eval_step(imgs, nodes,
                                                     alpha).items()}
    out["sharded"] = [{k: float(v) for k, v in step(imgs, nodes,
                                                     alpha).items()}
                      for _ in range(steps)]
    params = {k: _np(v) for k, v in model.state_dict().items()}
    params["head.graph_embedding"] = _gather_table(
        model.head.graph_embedding, mesh)
    out.update(sharded_params=params, real=real, padded=padded,
               block_rows=_gather_list(int(
                   model.head.graph_embedding.shape[0])))
    try:
        place_batch(images[:6], node_idx[:3])
        out["guard"] = None
    except ValueError as e:
        out["guard"] = str(e)
    return out


# ------------------------------------------------------------- on the card

def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _counted(counters, fn):
    """(fn(), {kernel: launches during fn}): each counter set to 0 just
    before and read just after."""
    for c in counters:
        c.launches = 0
    out = fn()
    _sync()
    return out, {c.__name__: c.launches for c in counters}


def _ball(n, d, c, gen, dev, r_lo=0.05, r_hi=0.95):
    v = torch.randn(n, d, generator=gen, device=dev)
    r = r_lo + (r_hi - r_lo) * torch.rand(n, 1, generator=gen, device=dev)
    return (v / v.norm(dim=-1, keepdim=True) * r / float(np.sqrt(c))
            ).contiguous()


def _search_checks(mesh, dev, sizes: dict, direct: bool) -> dict:
    """Each sharded candidate path against the one-process index over the
    same gallery (made on each rank from one seed): the cosine bf16 path
    (row 3), the quantized path (row 3′) and the quantized Poincaré path
    (row 4) through ``EmbeddingIndex(mesh=...)``, and with ``direct``
    also the four sharded functions.  Returns, for each, whether the
    indices equal the one-process index's, the launches on every rank and
    the seconds of one sharded and one one-process search."""
    import time

    from patent_tpu_torch.ops import topk_kernel as tk
    from patent_tpu_torch.retrieval import index as ix

    n, d, pd, nq, k, c = (sizes[key] for key in
                          ("n", "d", "poincare_d", "queries", "k", "c"))
    gen = torch.Generator(device=dev).manual_seed(sizes.get("seed", 19))
    g = torch.randn(n, d, generator=gen, device=dev)
    q = g[:nq] + 0.3 * torch.randn(nq, d, generator=gen, device=dev)
    ball = _ball(n, pd, c, gen, dev)
    pq = _ball(nq, pd, c, gen, dev)
    names = [str(i) for i in range(n)]
    counters = (tk.bucket_topk_bf16, tk.bucket_topk_int8,
                tk.bucket_topk_poincare)
    lead = dist.get_rank() == 0
    out = {}

    def timed(fn):
        _sync()
        t0 = time.perf_counter()
        res = fn()
        _sync()
        return res, time.perf_counter() - t0

    modes = {"cosine": (g, q, {}), "quantized": (g, q, {"quantized": True}),
             "poincare": (ball, pq, {"quantized": True,
                                     "similarity": "poincare", "c": c})}
    for mode, (gal, qq, kw) in modes.items():
        want = one_s = None
        if lead:
            single = ix.EmbeddingIndex(gal, names, device=dev, **kw)
            single.search(qq, k=k)
            (_v, want), one_s = timed(lambda: single.search(qq, k=k))
            del single
        sharded = ix.EmbeddingIndex(gal, names, mesh=mesh, **kw)
        sharded.search(qq, k=k)
        ((_v, got), s), counts = _counted(counters, lambda: timed(
            lambda: sharded.search(qq, k=k)))
        del sharded
        out[mode] = {"equal": None if want is None else
                     bool(np.array_equal(got, want)),
                     "launches": _gather_list(counts),
                     "sharded_s": s, "one_s": one_s}
    if direct:
        def ref(kw, gal, qq):
            return ix.EmbeddingIndex(gal, names, device=dev, **kw).search(
                qq, k=k)[1]

        gal16, valid = tk.prepare_cosine_gallery_bf16(g)
        i8, scale = tk.quantize_gallery(g.cpu().numpy())
        pgal = tk.prepare_poincare_gallery(ball, c)
        calls = {
            "sharded_topk_search": (
                lambda: ix.sharded_topk_search(mesh, q, g, k=k),
                lambda: ix.topk_search(q, g, k=k)[1].cpu().numpy()),
            "sharded_topk_search_cosine_fast": (
                lambda: ix.sharded_topk_search_cosine_fast(
                    mesh, q, gal16, valid, g, k=k),
                lambda: ref({}, g, q)),
            "sharded_topk_search_quantized": (
                lambda: ix.sharded_topk_search_quantized(
                    mesh, q, i8, scale, g, k=k),
                lambda: ref({"quantized": True}, g, q)),
            "sharded_topk_search_poincare_fast": (
                lambda: ix.sharded_topk_search_poincare_fast(
                    mesh, pq, pgal, ball, k=k, c=c),
                lambda: ref(modes["poincare"][2], ball, pq))}
        for name, (run, one) in calls.items():
            (_v, got), counts = _counted(counters, run)
            out[name] = {"equal": bool(np.array_equal(_np(got), one())),
                         "launches": _gather_list(counts)}
    return out


def _encode_checks(mesh, dev, vc, batches=(128, 6), seed: int = 5) -> dict:
    """``encode_sharded`` of the towers of ``vc`` (bf16 fused-layer and
    int8, seeded weights) at each global batch against the one-process
    encode on rank 0: equal in bits, else the largest relative error and
    the least row cosine; the launches of the towers' kernels on every
    rank (the int8 entries' fast-form launches also apart, ``<entry>_fast``)."""
    from patent_tpu_torch.models.vit import VisionTransformer
    from patent_tpu_torch.models.vit_int8 import Int8VisionTransformer
    from patent_tpu_torch.ops import bf16_layer
    from patent_tpu_torch.ops import quant_matmul as qm

    bf16 = VisionTransformer(vc, generator=torch.Generator()
                             .manual_seed(seed)).to(dev).eval()
    towers = {"bf16": (bf16, (bf16_layer.fused_layer_block_bf16,
                              bf16_layer.fused_layer_cls_bf16)),
              "int8": (Int8VisionTransformer.from_float(bf16).eval(),
                       tuple(c for fn in (qm.quant_attention_block,
                                          qm.quant_attention_cls,
                                          qm.quant_mlp_block,
                                          qm.quant_layer_block)
                             for c in (fn, fn.fast)))}
    rng = np.random.default_rng(seed)
    out = {}
    for b in batches:
        px = rng.standard_normal((b, vc.image_size, vc.image_size, 3)
                                 ).astype(np.float32)
        for name, (tower, counters) in towers.items():
            got, counts = _counted(counters,
                                   lambda: encode_sharded(mesh, tower)(px))
            res = {"launches": _gather_list(counts)}
            if dist.get_rank() == 0:
                with torch.inference_mode():
                    want = tower(torch.from_numpy(px).to(dev))
                got, want = got.float(), want.float()
                res["bits"] = bool(torch.equal(got, want))
                res["max_rel"] = float(((got - want).norm(dim=-1)
                                        / want.norm(dim=-1)).max())
                res["min_cos"] = float(torch.nn.functional.cosine_similarity(
                    got, want, dim=-1).min())
            out[f"{name}_B{b}"] = res
    return out


def _finetune_checks(mesh, dev, vc, pairs: int, nodes: int = 257) -> dict:
    """The sharded fine-tune step of the tower ``vc``, ``pairs`` pairs a
    rank, against one process at the global batch from the same state,
    compared on rank 0: the metrics, and for each trained tower leaf the
    largest gap in units of lr_clip and the cosine between the two
    updates; the launches of rows 12, 13, 15 and 16 on every rank."""
    from patent_tpu_torch.ops import bf16_mlp_grad as mm
    from patent_tpu_torch.ops import flash_attention as fa
    from patent_tpu_torch.train import finetune_clip as ft
    from patent_tpu_torch.utils.config import ClipFinetuneConfig

    ranks = axis_size(mesh, "data")
    big = pairs * ranks
    cfg = ClipFinetuneConfig(batch_size=big, image_size=vc.image_size,
                             trainable_blocks=min(9, vc.num_layers))
    rng = np.random.default_rng(23)
    vgae = rng.standard_normal((nodes, 64)).astype(np.float32)
    images = rng.integers(0, 256, (2 * big, vc.image_size, vc.image_size,
                                   3), dtype=np.uint8)
    node_idx = rng.integers(0, nodes, big).astype(np.int64)
    alpha = 0.05
    out, single, before = {}, None, None
    if dist.get_rank() == 0:
        model, opt = ft.init_finetune_state(vc, cfg, vgae, device=dev)
        before = {k: v.detach().clone() for k, v in
                  model.vit.named_parameters() if v.requires_grad}
        step, _ev = ft.make_finetune_step(model, opt)
        out["single"] = {k: float(v) for k, v in step(
            torch.from_numpy(images).to(dev), torch.from_numpy(node_idx).to(
                dev), alpha).items()}
        single = {k: v.detach().clone() for k, v in
                  model.vit.named_parameters() if v.requires_grad}
        del model, opt, step
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    model, opt = ft.init_finetune_state(vc, cfg, vgae, device=dev)
    _m, _o, real, padded = ft.pad_graph_table(model, opt,
                                              axis_size(mesh, "model"))
    step, _ev, place = ft.make_sharded_finetune_step(mesh, model, opt)
    ft.shard_finetune_state(mesh, model, opt)
    imgs, nidx = place(images, node_idx)
    metrics, counts = _counted(
        (fa.fused_attention_fwd, fa.fused_attention_bwd, mm.fused_mlp_fwd,
         mm.fused_mlp_bwd), lambda: step(imgs, nidx, alpha))
    out["sharded"] = {k: float(v) for k, v in metrics.items()}
    out["launches"] = _gather_list(counts)
    if single is not None:
        gaps, coss = {}, {}
        for k, p in model.vit.named_parameters():
            if k not in single:
                continue
            a, b0 = p.detach() - before[k], single[k] - before[k]
            gaps[k] = float((p.detach() - single[k]).abs().max()) / cfg.lr_clip
            coss[k] = float(torch.nn.functional.cosine_similarity(
                a.flatten(), b0.flatten(), dim=0))
        out["gap_lr"] = max(gaps.values())
        out["gap_leaf"] = max(gaps, key=gaps.get)
        out["min_update_cos"] = min(coss.values())
        out["min_cos_leaf"] = min(coss, key=coss.get)
    return out


def multi_gpu_world(device: str, parts: dict) -> dict:
    """The multi-GPU phase's checks on the card (``chip_smoke.py``), each
    part by its key: "searches" (sizes, ``_search_checks``), "direct"
    (with the four sharded functions), "encode", "finetune" (pairs a
    rank), "hyp" ({setting: ``hyp_train_world``'s arguments}); "vision":
    the towers' ``VisionConfig`` fields (ViT-B/16 by default)."""
    import time

    from patent_tpu_torch.models.vit import VIT_B16, VisionConfig

    vc = VisionConfig(**parts["vision"]) if "vision" in parts else VIT_B16
    mesh = make_mesh((dist.get_world_size(),), ("data",), device=device)
    dev = mesh_device(mesh)
    out = {"backend": dist.get_backend(), "ranks": dist.get_world_size()}
    for part in ("searches", "encode", "finetune", "hyp"):
        if part not in parts:
            continue
        t0 = time.perf_counter()
        if part == "searches":
            out[part] = _search_checks(mesh, dev, parts[part],
                                       parts.get("direct", False))
        elif part == "encode":
            out[part] = _encode_checks(mesh, dev, vc)
        elif part == "finetune":
            out[part] = _finetune_checks(
                make_mesh((dist.get_world_size(), 1), device=device), dev,
                vc, parts[part])
        else:
            out[part] = {name: hyp_train_world(device, *args)
                         for name, args in parts[part].items()}
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        out[part + "_s"] = time.perf_counter() - t0
    return out
