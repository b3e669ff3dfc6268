"""The multi-rank dry run (port of ``dryrun_multichip`` in
__graft_entry__.py): one joint CLIP + hyperbolic training step with its
state sharded over a (data, model) mesh, then every sharded path of the
port once, with the reference's checks in its order and at its sizes:

1. the joint ``train_end`` step: images over ``data``; the ViT's ``qkv``
   and MLP-in matrices kept as column blocks and MLP-out as row blocks on
   each ``model`` rank (with their AdamW moments), gathered whole before
   the forward so the tower's kernels (rows 12, 13, 15, 16 on the card)
   run unchanged, their gradients cut back to each block after the
   ``data`` all-reduce; the label table row-sharded over ``model``; the
   loss equal to the one-process step's;
2. ``sharded_topk_search`` (256 x 32);
3. the int8 ``encode_sharded``, full and keep-tokens 3 of 4;
4. the sharded train_hyp step, its label table padded from an odd size
   and row-sharded over ``model`` = 4 (where 4 divides the world);
5. the quantized, Poincaré-fast and cosine-fast sharded searches equal to
   the one-process searches on 301 / 203 / 317 rows;
6. the row-distributed gallery: each rank holds ceil(317 / n) rows;
7. the sharded fine-tune step (21 graph nodes padded over ``model``);
8. the 2-host path split.

On the card the towers' heads are 16 wide (the attention kernels take
head_dim 16, 32 or 64; the reference's dry run uses 8): the same widths
with half the heads.

    python -m patent_tpu_torch.parallel.dryrun --world 4 --device cpu
    python -m patent_tpu_torch.parallel.dryrun --world 2 --device cuda \\
        --backend gloo          # two ranks on one card
    torchrun --nproc-per-node 2 -m patent_tpu_torch.parallel.dryrun \\
        --world 2 --device cuda
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from .launch import run_world, under_torchrun
from .mesh import (RowBlocks, all_gather_rows, axis_group, axis_rank,
                   axis_size, encode_sharded, gather_rows_grad, make_mesh,
                   mesh_device, take_owned_rows)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"multichip dryrun: {what}")


# the tensor-parallel placement of the reference's dry run: (name suffix,
# the axis of its block) for the ViT's qkv, MLP-in and MLP-out matrices
_TP_BLOCKS = ((".wqkv", 1), (".w1", 1), (".w2", 0))


class _TensorBlocks:
    """The ViT matrices held as blocks over ``model`` (with their AdamW
    moments), gathered whole around a step."""

    def __init__(self, mesh, model, optimizer):
        self.group = axis_group(mesh, "model")
        self.size, self.rank = axis_size(mesh, "model"), axis_rank(mesh,
                                                                   "model")
        self.items = []
        clip = optimizer.groups["clip"]
        for name, p in model.named_parameters():
            axis = next((a for s, a in _TP_BLOCKS if name.endswith(s)), None)
            if axis is None:
                continue
            _check(p.shape[axis] % self.size == 0,
                   f"{name} does not divide the model axis")
            self.items.append((p, axis))
            for store in (clip.mu, clip.nu):
                if name in store:
                    store[name] = self._block(store[name], axis).clone()
            p.data = self._block(p.data, axis).clone()

    def _block(self, t, axis):
        n = t.shape[axis] // self.size
        return t.narrow(axis, self.rank * n, n)

    def gather(self) -> list:
        blocks = []
        for p, axis in self.items:
            blocks.append(p.data)
            parts = [torch.empty_like(p.data) for _ in range(self.size)]
            dist.all_gather(parts, p.data.contiguous(), group=self.group)
            p.data = torch.cat(parts, dim=axis)
        return blocks

    def scatter(self, blocks) -> None:
        for (p, axis), block in zip(self.items, blocks):
            grad = None if p.grad is None else \
                self._block(p.grad, axis).contiguous()
            p.grad = None
            p.data = block
            p.grad = grad


def _joint_step(mesh, device, n, heads) -> tuple[float, float]:
    """Check 1: (sharded loss, one-process loss)."""
    from ..losses.contrastive import (hyperbolic_info_nce,
                                      multi_positive_nt_xent)
    from ..losses.hierarchy import hierarchical_margin_losses, instance_band
    from ..models.vit import VisionConfig
    from ..ops import poincare
    from ..train.train_end import init_end_to_end, make_end_to_end_step
    from ..utils.config import EndToEndConfig
    from .sharded_train import shard_table_rows, table_band_mean

    model_dim = axis_size(mesh, "model")
    cfg = EndToEndConfig(batch_size=n, image_size=16, embed_dim=16)
    vc = VisionConfig(image_size=16, patch_size=8, hidden_dim=32,
                      num_layers=2, num_heads=heads(32, 4), mlp_dim=64,
                      projection_dim=32)
    label_num = 64
    rng = np.random.default_rng(0)
    b = cfg.batch_size
    images = rng.standard_normal((2 * b, 16, 16, 3)).astype(np.float32)
    pos = rng.integers(0, label_num, (b,)).astype(np.int64)
    neg = rng.integers(0, label_num, (b, 2)).astype(np.int64)
    implication = torch.as_tensor(rng.integers(0, label_num, (16, 2))
                                  ).to(device)
    c = cfg.curvature

    one = None
    if dist.get_rank() == 0:
        model, opt = init_end_to_end(vc, cfg, label_num, seed=0,
                                     device=device)
        model.train()
        step, _loss = make_end_to_end_step(model, opt, cfg)
        one = float(step(torch.as_tensor(images).to(device),
                         torch.as_tensor(pos).to(device),
                         torch.as_tensor(neg).to(device), implication,
                         torch.Generator(device=device).manual_seed(0)
                         )["total_loss"])
        del model, opt

    model, opt = init_end_to_end(vc, cfg, label_num, seed=0, device=device)
    model.train()
    tp = _TensorBlocks(mesh, model, opt)
    shard_table_rows(mesh, model, opt, "label_emb", "pad_label_table")
    data_g, model_g = axis_group(mesh, "data"), axis_group(mesh, "model")
    local = RowBlocks("data").local(mesh, images)
    table = model.hyp.label_emb
    start = axis_rank(mesh, "model") * table.shape[0]

    def take(t, idx):
        return take_owned_rows(t, idx, start, model_g)

    opt.zero_grad()
    blocks = tp.gather()
    feats = gather_rows_grad(model.vit(torch.as_tensor(local).to(device)),
                             data_g)
    clip_loss = multi_positive_nt_xent(feats, 1.0 / 0.07)
    enc = model.hyp(feats, torch.Generator(device=device).manual_seed(0))
    anchors = enc[:b]
    pos_d = poincare.dist(anchors, take(table, torch.as_tensor(pos).to(
        device)), c)
    neg_d = poincare.dist(anchors[:, None, :], take(table, torch.as_tensor(
        neg).to(device)), c).mean(1)
    retrieval = torch.relu(pos_d - neg_d + 0.1).mean()
    inside, disjoint = hierarchical_margin_losses(table, implication, None,
                                                  c, take=take)
    label_reg = table_band_mean(table, start, label_num, None, c, model_g)
    hyp_loss = (retrieval + 3.0 * (inside + disjoint)
                + 0.01 * (label_reg + instance_band(anchors, c))
                + hyperbolic_info_nce(anchors, enc[b:], c))
    total = cfg.clip_weight * clip_loss + (1 - cfg.clip_weight) * hyp_loss
    total.backward()
    for p in model.vit.parameters():
        if p.grad is not None:
            dist.all_reduce(p.grad, group=data_g)
    tp.scatter(blocks)
    opt.step()
    _check(all(p.shape[a] * model_dim == full for (p, a), full in zip(
        tp.items, [32 * 3, 64, 64] * vc.num_layers)),
        "ViT blocks are not sharded over `model`")
    return float(total.detach()), one


def _rank(n: int, device_name: str) -> str | None:
    from ..data import synthetic
    from ..data.graph_build import build_feature_matrix, build_hetero_graph
    from ..data.prep import figure_pair_maps, prepare_training_data
    from ..input.pipeline import shard_paths_per_host
    from ..models.hyperbolic import HyperbolicEmbeddingModel
    from ..models.vit import VisionConfig
    from ..models.vit_int8 import Int8VisionTransformer
    from ..models.vit import TrainableVisionTransformer
    from ..ops.topk_kernel import (pad_columns, prepare_cosine_gallery_bf16,
                                   prepare_poincare_gallery,
                                   quantize_gallery)
    from ..retrieval import index as ix
    from ..train import finetune_clip as ft
    from ..train.optim import RiemannianAdam
    from ..train.train_hyp import BATCH_FIELDS, make_batches
    from ..utils.config import ClipFinetuneConfig, HypTrainConfig
    from .sharded_train import (make_hyp_mesh, make_sharded_train_step,
                                pad_label_table, shard_hyp_state)

    cuda = device_name == "cuda"

    def heads(width, reference):
        return width // 16 if cuda else reference

    model_dim = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = make_hyp_mesh(n, model_dim=model_dim, device=device_name)
    mesh1d = make_mesh((n,), ("data",), device=device_name)
    device = mesh_device(mesh)
    rng = np.random.default_rng(0)

    # 1. the joint step
    loss, one = _joint_step(mesh, device, n, heads)
    _check(np.isfinite(loss), f"non-finite loss: {loss}")
    if one is not None:
        _check(abs(loss - one) <= 1e-4 * abs(one),
               f"sharded joint loss {loss} != one-process {one}")

    # 2. sharded top-k
    gallery = rng.standard_normal((256, 32)).astype(np.float32)
    queries = rng.standard_normal((4, 32)).astype(np.float32)
    _vals, idx = ix.sharded_topk_search(mesh1d, queries, gallery, k=5)

    # 3. int8 data-parallel encode, full and keep-tokens
    vc = VisionConfig(image_size=16, patch_size=8, hidden_dim=32,
                      num_layers=2, num_heads=heads(32, 4), mlp_dim=64,
                      projection_dim=32)
    float_tower = TrainableVisionTransformer(
        vc, generator=torch.Generator().manual_seed(0)).to(device)
    for keep in (None, 3):
        vit8 = Int8VisionTransformer.from_float(float_tower)
        vit8.keep_tokens = keep
        feats8 = encode_sharded(mesh1d, vit8)(rng.standard_normal(
            (2 * n, 16, 16, 3)).astype(np.float32))
        _check(bool(torch.isfinite(feats8).all()),
               f"non-finite int8 sharded encode (keep_tokens={keep})")

    # 4. the sharded hyp step, the table padded from an odd size
    records = synthetic.synthetic_records(num_patents=12,
                                          figures_per_patent=3, seed=0)
    graph = build_hetero_graph(records)
    x = build_feature_matrix(graph, synthetic.synthetic_features(
        records, dim=16, seed=0), feature_dim=16)
    td = prepare_training_data(graph, x, neg_ratio=3, fig_pair_ratio=2,
                               seed=0)
    hcfg = HypTrainConfig(embed_dim=8, hidden_dims=(16,), curvature=1.0,
                          batch_size=2 * n, num_neg_samples=1,
                          use_dropout=False)
    hyp_model_dim = 4 if n % 4 == 0 else model_dim
    hyp_mesh = make_hyp_mesh(n, model_dim=hyp_model_dim, device=device_name)
    label_num = td.num_labels | 1
    hmodel = HyperbolicEmbeddingModel(
        feature_dim=16, embed_dim=8, label_num=label_num, hidden_dims=(16,),
        c=1.0, generator=torch.Generator().manual_seed(0)).to(device)
    hopt = RiemannianAdam(dict(hmodel.named_parameters()), 1e-2, c=1.0)
    _m, _o, real, padded = pad_label_table(hmodel, hopt, hyp_model_dim)
    _check(padded % hyp_model_dim == 0
           and (padded > real or hyp_model_dim == 1),
           "label table not padded")
    hstep, place_batch, place_static = make_sharded_train_step(
        hyp_mesh, hmodel, hopt, hcfg, num_real_labels=real)
    shard_hyp_state(hyp_mesh, hmodel, hopt)
    _check(hmodel.label_emb.shape[0] * hyp_model_dim == padded,
           "label table is not row-sharded over `model`")
    maps = figure_pair_maps(td)
    batch = next(make_batches(td, np.asarray(sorted(maps[0])),
                              hcfg.batch_size, 1, np.random.default_rng(0),
                              maps))
    sx, simp, sexc = place_static(td.x_figures, td.implication,
                                  np.zeros((0, 2), np.int32))
    data_rows = -(-td.x_figures.shape[0] // axis_size(hyp_mesh, "data"))
    _check(sx.shape[0] == data_rows,
           "x_figures is not row-sharded over `data`")
    hmetrics = hstep(place_batch(tuple(getattr(batch, f)
                                       for f in BATCH_FIELDS)),
                     sx, simp, sexc)
    hyp_loss = float(hmetrics[0])
    _check(np.isfinite(hyp_loss), f"non-finite sharded hyp loss: {hyp_loss}")

    # 5. the sharded searches equal the one-process ones
    def dev(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype).to(device)

    qgal = rng.standard_normal((301, 32)).astype(np.float32)
    qq = rng.standard_normal((6, 32)).astype(np.float32)
    gi8, gsc = quantize_gallery(qgal)
    v1, i1 = ix.topk_search_quantized(dev(qq), pad_columns(dev(gi8)),
                                      dev(gsc), dev(qgal), k=5,
                                      block_size=64)
    vs, is_ = ix.sharded_topk_search_quantized(mesh1d, qq, gi8, gsc, qgal,
                                               k=5, block_size=64)
    _check(torch.equal(i1, is_) and torch.allclose(v1, vs, atol=1e-6),
           f"sharded quantized top-k != single-device: {i1} vs {is_}")
    pgal = rng.standard_normal((203, 16))
    pgal = (pgal / np.linalg.norm(pgal, axis=-1, keepdims=True)
            * rng.uniform(0.1, 0.8, (203, 1))).astype(np.float32)
    pg = prepare_poincare_gallery(dev(pgal), 1.0)
    pv1, pi1 = ix.topk_search_poincare_fast(
        dev(pgal[:5] * 0.99), pg._replace(gal_i8=pad_columns(pg.gal_i8)),
        dev(pgal), k=5, c=1.0, block_size=64)
    pvs, pis = ix.sharded_topk_search_poincare_fast(
        mesh1d, pgal[:5] * 0.99, pg, pgal, k=5, c=1.0, block_size=64)
    _check(torch.equal(pi1, pis) and torch.allclose(pv1, pvs, atol=1e-6),
           f"sharded poincaré fast top-k != single-device: {pi1} vs {pis}")
    cgal = rng.standard_normal((317, 32)).astype(np.float32)
    cq = rng.standard_normal((6, 32)).astype(np.float32)
    cg16, cvalid = prepare_cosine_gallery_bf16(dev(cgal))
    cv1, ci1 = ix.topk_search(dev(cq), dev(cgal), k=5, block_size=64)
    cvs, cis = ix.sharded_topk_search_cosine_fast(mesh1d, cq, cg16, cvalid,
                                                  cgal, k=5, block_size=64)
    _check(torch.equal(ci1, cis) and torch.allclose(cv1, cvs, atol=1e-6),
           f"sharded cosine-fast top-k != scan oracle: {ci1} vs {cis}")

    # 6. the gallery is row-distributed: the candidate copy ceil(N / n)
    # rows a rank, the f32 rows a copy of the rank's block (built from the
    # whole gallery on the device, which a slice would keep alive)
    index = ix.EmbeddingIndex(dev(cgal), [str(i) for i in range(len(cgal))],
                              mesh=mesh1d)
    index.search(cq, k=5)
    per = -(-cgal.shape[0] // n)
    held = all_gather_rows(torch.tensor(
        [[index._gal16.shape[0],
          index.embeddings.untyped_storage().nbytes()]], device=device),
        axis_group(mesh1d, "data"))
    _check(set(held[:, 0].tolist()) == {per}
           and held[:, 1].max().item() <= per * cgal.shape[1] * 4,
           f"sharded gallery not row-distributed: per-shard rows and f32 "
           f"bytes {held.tolist()}, want {per} rows")

    # 7. the sharded fine-tune step
    fcfg = ClipFinetuneConfig(batch_size=n, image_size=16, trainable_blocks=1,
                              graph_proj_dim=8)
    fvc = VisionConfig(image_size=16, patch_size=8, hidden_dim=16,
                       num_layers=2, num_heads=heads(16, 2), mlp_dim=32,
                       projection_dim=16)
    n_nodes = 21 if model_dim > 1 else 20
    fvgae = rng.standard_normal((n_nodes, 12)).astype(np.float32)
    fmodel, fopt = ft.init_finetune_state(fvc, fcfg, fvgae, seed=0,
                                          device=device)
    _m, _o, freal, fpadded = ft.pad_graph_table(fmodel, fopt, model_dim)
    fstep, _fev, fplace = ft.make_sharded_finetune_step(mesh, fmodel, fopt)
    ft.shard_finetune_state(mesh, fmodel, fopt)
    _check(fmodel.head.graph_embedding.shape[0] * model_dim == fpadded,
           "graph table is not row-sharded over `model`")
    fi, fn = fplace(rng.standard_normal((2 * n, 16, 16, 3)).astype(
        np.float32), rng.integers(0, freal, n).astype(np.int64))
    ft_loss = float(fstep(fi, fn, 0.5)["loss"])
    _check(np.isfinite(ft_loss), f"non-finite sharded finetune loss: "
                                 f"{ft_loss}")
    table = all_gather_rows(fmodel.head.graph_embedding.detach(),
                            axis_group(mesh, "model"))
    _check(fpadded == freal or bool((table[freal:] == 0).all()),
           "padded graph-table rows moved off zero")

    # 8. the 2-host path split is a partition
    all_paths = [f"img_{i:04d}.png" for i in range(31)]
    shards = [shard_paths_per_host(all_paths, h, 2) for h in range(2)]
    _check(sorted(shards[0] + shards[1]) == sorted(all_paths)
           and not set(shards[0]) & set(shards[1]),
           "per-host path sharding is not a partition")

    if dist.get_rank() != 0:
        return None
    return (f"dryrun_multichip({n}): e2e loss={loss:.4f}, "
            f"pruned+int8 sharded encode ok, "
            f"sharded hyp loss={hyp_loss:.4f} "
            f"(labels {real}→{padded} over model={hyp_model_dim}), "
            f"sharded finetune loss={ft_loss:.4f} "
            f"(graph table {freal}→{fpadded} over model={model_dim}), "
            f"topk idx sample={idx.cpu().numpy()[0][:3].tolist()}, "
            f"quantized-sharded==quantized-single over {gi8.shape[0]} rows, "
            f"poincaré-fast-sharded==single over {pgal.shape[0]} rows, "
            f"cosine-fast-sharded==scan-oracle over {cgal.shape[0]} rows, "
            f"gallery row-distributed {per * n}→{per}/shard "
            f"(capacity ×{n}), "
            f"2-host input shard sizes={[len(s) for s in shards]} — OK")


def dryrun_multichip(n: int, device: str = "cuda",
                     backend: str | None = None,
                     timeout: float = 900.0) -> str:
    """Run the dry run over an n-rank world (``run_world``; under
    ``torchrun`` this process's world) and print its line."""
    line = run_world(n, _rank, n, device, backend=backend, device=device,
                     timeout=timeout)
    if line is not None:
        print(line, flush=True)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: nccl on cuda, gloo on cpu)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.world, args.device, args.backend)
    if under_torchrun() and dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
