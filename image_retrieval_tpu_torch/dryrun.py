"""The port's multi-device dry run: every sharded path of the system over an
n-device mesh, once, at tiny shapes, each held against a plain answer.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``,
with its checks and its ``dryrun_multichip OK ...`` lines: the dp x tp
trainer step, the sharded index (search, filter, approximate selection, the
streamed tier, the journal's crash and replay, the int4 tier at two widths),
the cluster-sharded IVF, the screen, the (slice, data) merge, the pipelined
(data, pipe) step and the int8 serving tower over the data-sharded encoder.

The devices are the visible cards, repeated as virtual shards where there
are fewer than `n_devices` (a mesh may name a device more than once,
parallel/mesh.py); ``device="cpu"`` runs it on the host. Without a card and
without ``device=`` it raises: nothing falls back.

    python -m image_retrieval_tpu_torch.dryrun 4            # on the card(s)
    python -m image_retrieval_tpu_torch.dryrun 8 --device cpu
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
from typing import List, Optional

import numpy as np
import torch

from image_retrieval_tpu_torch.config import (
    Config,
    IndexConfig,
    MeshConfig,
    ModelConfig,
    serving_config,
)
from image_retrieval_tpu_torch.device import DeviceLike, resolve_device
from image_retrieval_tpu_torch.parallel.mesh import Mesh, make_mesh


def dryrun_devices(n_devices: int, device: Optional[DeviceLike] = None) -> List[torch.device]:
    """`n_devices` devices: the visible cards (or `device`) in turn."""
    if device is None:
        resolve_device("cuda")  # raises where there is no card
        have = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        have = [resolve_device(device)]
    return [have[i % len(have)] for i in range(n_devices)]


def dryrun_config() -> ModelConfig:
    """The dry run's model: the JAX dry run's tiny CLIP (f32)."""
    return ModelConfig(image_size=32, patch_size=8, vision_width=64, vision_layers=2,
                       vision_heads=4, text_width=32, text_layers=2, text_heads=2,
                       context_length=16, embed_dim=32, dtype="float32")


def _grid(devices, shape) -> np.ndarray:
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return grid.reshape(shape)


def _top(scores: np.ndarray, k: int) -> list:
    return list(np.argsort(-scores, kind="stable")[:k])


def dryrun_multichip(n_devices: int, device: Optional[DeviceLike] = None) -> None:
    """Run one step or one search of every sharded path over an
    `n_devices`-device mesh; raises on the first disagreement."""
    from image_retrieval_tpu_torch.index import ShardedVectorIndex
    from image_retrieval_tpu_torch.index.ivf import IVFIndex
    from image_retrieval_tpu_torch.index.screen import ScreenedSearch
    from image_retrieval_tpu_torch.models.clip import CLIP
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder
    from image_retrieval_tpu_torch.models.weights import init_params
    from image_retrieval_tpu_torch.parallel.collectives import multislice_search_topk
    from image_retrieval_tpu_torch.train import CLIPTrainer, PipelinedCLIPTrainer

    devices = dryrun_devices(n_devices, device)
    first = devices[0]
    model_axis = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(MeshConfig(data=n_devices // model_axis, model=model_axis),
                     devices=devices)
    cfg = dryrun_config()
    trainer = CLIPTrainer(cfg, mesh=mesh, learning_rate=1e-3)
    rng = np.random.default_rng(0)
    dp = n_devices // model_axis
    batch = ((max(n_devices, 8) + dp - 1) // dp) * dp  # divisible by the data axis
    pixels = rng.normal(size=(batch, 32, 32, 3)).astype(np.float32)
    tokens = rng.integers(1, 100, size=(batch, 16)).astype(np.int32)
    loss = trainer.train_step(pixels, tokens)
    assert np.isfinite(loss), loss
    print(f"dryrun_multichip OK: mesh={dict(mesh.shape)} loss={loss:.4f}", flush=True)
    del trainer

    # the sharded exact index: insert, cosine search and a filtered search
    # with the cross-shard top-k merge, against a numpy oracle
    step = max(64, n_devices)
    idx = ShardedVectorIndex(dim=64, mesh=mesh, config=IndexConfig(capacity_step=step))
    emb = rng.normal(size=(96, 64)).astype(np.float32)
    paths = [f"r{i}" for i in range(96)]
    idx.insert(paths, emb, attrs={"bucket": ["even" if i % 2 == 0 else "odd"
                                             for i in range(96)]})
    q = rng.normal(size=(64,)).astype(np.float32)
    vals, ids = idx.search(q, top_k=5)
    unit = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    cos_ref = unit @ (q / np.linalg.norm(q))
    ref_order = _top(cos_ref, 5)
    assert list(ids) == ref_order, (ids, ref_order)
    _, fids = idx.search(q, top_k=5, flt="bucket == 'even'")
    fref = _top(np.where(np.arange(96) % 2 == 0, cos_ref, -np.inf), 5)
    assert list(fids) == fref, (fids, fref)
    print(f"dryrun_multichip OK (index): {n_devices}-shard search + filtered-search parity",
          flush=True)

    a_vals, a_ids = idx.search(q, top_k=5, approx=True)
    assert list(a_ids) == ref_order, (a_ids, ref_order)
    np.testing.assert_allclose(a_vals, vals, rtol=1e-6)
    print(f"dryrun_multichip OK (approx-select): {n_devices}-shard approx candidate set, "
          "exact-ranking parity", flush=True)

    # the streamed tier (past stream_threshold_bytes) against the resident
    # int8 tier over the same rows
    res8 = ShardedVectorIndex(dim=64, mesh=mesh,
                              config=IndexConfig(capacity_step=step, dtype="int8"))
    str8 = ShardedVectorIndex(dim=64, mesh=mesh, config=IndexConfig(
        capacity_step=step, dtype="int8", stream_threshold_bytes=1))
    res8.insert(paths, emb)
    str8.insert(paths, emb)
    _, ri8 = res8.search(q, top_k=5)
    _, si8 = str8.search(q, top_k=5)
    assert set(si8.tolist()) == set(ri8.tolist()), (si8, ri8)
    print("dryrun_multichip OK (streamed): beyond-HBM chunked host gallery, resident-int8 "
          "parity", flush=True)

    # the journal: write, flush, drop without a checkpoint, reopen by replay
    jdir = tempfile.mkdtemp(prefix="dryrun_journal_")
    try:
        jidx = ShardedVectorIndex.open(jdir, mesh=mesh, config=IndexConfig(
            embedding_dim=64, capacity_step=step))
        jidx.insert(paths, emb)
        jidx.delete(["r3"])
        jidx.flush()
        del jidx
        re_idx = ShardedVectorIndex.open(jdir, mesh=mesh)
        assert len(re_idx) == 96 and re_idx.live_count == 95
        _, j_ids = re_idx.search(q, top_k=5)
        j_ref = _top(np.where(np.arange(96) != 3, cos_ref, -np.inf), 5)
        assert list(j_ids) == j_ref, (j_ids, j_ref)
        del re_idx
    finally:
        shutil.rmtree(jdir, ignore_errors=True)
    print("dryrun_multichip OK (journal): write->crash->reopen replay, tombstone-aware "
          "search parity", flush=True)

    # the int4 tier: a screen over every shard, the merged candidates,
    # the exact int8 rerank; with rerank_c covering the gallery it finds
    # the oracle's rows
    idx4 = ShardedVectorIndex(dim=64, mesh=mesh, config=IndexConfig(
        capacity_step=step, dtype="int4", rerank_c=96))
    idx4.insert(paths, emb)
    _, ids4 = idx4.search(q, top_k=5)
    assert set(ids4.tolist()) == set(ref_order), (ids4, ref_order)
    print(f"dryrun_multichip OK (int4): {n_devices}-shard two-phase screen+rerank parity",
          flush=True)

    # the int4 tier at the embedding width (512) in both rerank modes
    # against the resident int8 index's rows
    emb512 = rng.normal(size=(300, 512)).astype(np.float32)
    q512 = emb512[:2] + 0.01 * rng.normal(size=(2, 512)).astype(np.float32)
    p512 = [f"s{i}" for i in range(300)]
    got = {}
    for name, config in (
            ("int8", IndexConfig(embedding_dim=512, dtype="int8")),
            ("int4", IndexConfig(embedding_dim=512, dtype="int4", rerank_c=512,
                                 capacity_step=256 * n_devices)),
            ("latency", IndexConfig(embedding_dim=512, dtype="int4", rerank_c=512,
                                    capacity_step=256 * n_devices, rerank_device=True))):
        ix = ShardedVectorIndex(dim=512, mesh=mesh, config=config)
        ix.insert(p512, emb512)
        got[name] = ix.search(q512, top_k=5)[1]
    for name in ("int4", "latency"):
        assert np.array_equal(got[name], got["int8"]), (name, got[name], got["int8"])
    print(f"dryrun_multichip OK (int4-pallas): {n_devices}-shard int4 screen at D = 512, "
          "exact int8-index parity (host rerank + device rerank)", flush=True)

    # the cluster-sharded IVF against itself on one device; nlist 20 does not
    # divide most meshes, so the slabs pad with empty clusters
    flat = Mesh(devices, ("data",))
    ivf_emb = rng.normal(size=(512, 64)).astype(np.float32)
    ivf = IVFIndex(nlist=20, seed=0, dtype="int8", device=first).build(ivf_emb, replicas=2)
    ivf_q = ivf_emb[:4] + 0.01 * rng.normal(size=(4, 64)).astype(np.float32)
    _, si = ivf.search(ivf_q, top_k=5, nprobe=8)
    _, mi = ivf.sharded(flat)(ivf_q, top_k=5, nprobe=8)
    for a, b in zip(mi, si):
        assert set(a.tolist()) == set(b.tolist()), (a, b)
    print(f"dryrun_multichip OK (ivf): {n_devices}-shard int8 ANN parity", flush=True)

    scr = ScreenedSearch.from_index(idx, sketch_dims=16, candidates=96)
    _, s_ids = scr.search(q, top_k=5)
    assert list(s_ids) == ref_order, (s_ids, ref_order)
    print(f"dryrun_multichip OK (screen): {n_devices}-shard two-phase parity", flush=True)

    # the hierarchical merge over (slice, data) against the oracle
    if n_devices % 2 == 0 and n_devices >= 4:
        sl_mesh = Mesh(_grid(devices, (2, n_devices // 2)), ("slice", "data"))
        semb = rng.normal(size=(96, 64)).astype(np.float32)
        sunit = semb / np.linalg.norm(semb, axis=1, keepdims=True)
        _, midx = multislice_search_topk(
            torch.from_numpy(q[None]).to(first), torch.from_numpy(sunit).to(first),
            torch.ones(96, dtype=torch.bool, device=first), None, 5, mesh=sl_mesh)
        ms_order = _top(sunit @ (q / np.linalg.norm(q)), 5)
        assert midx[0].tolist() == ms_order, (midx, ms_order)
        print(f"dryrun_multichip OK (multislice): mesh=(slice=2, data={n_devices // 2}) "
              "hierarchical merge parity", flush=True)

    # the pipelined dp x pp step on the same devices
    if n_devices % 2 == 0 and n_devices >= 2:
        pp = PipelinedCLIPTrainer(cfg, Mesh(_grid(devices, (n_devices // 2, 2)),
                                            ("data", "pipe")), num_micro=2)
        chunk = (n_devices // 2) * 2  # data shards x microbatches
        pbatch = ((max(n_devices, 8) + chunk - 1) // chunk) * chunk
        p_pixels = rng.normal(size=(pbatch, 32, 32, 3)).astype(np.float32)
        p_tokens = rng.integers(1, 100, size=(pbatch, 16)).astype(np.int32)
        loss_pp = pp.train_step(p_pixels, p_tokens)
        assert np.isfinite(loss_pp), loss_pp
        print(f"dryrun_multichip OK (pipelined): mesh=(data={n_devices // 2}, pipe=2) "
              f"loss={loss_pp:.4f}", flush=True)
        del pp

    # the serving strategy (whole-layer int8 kernels) over the data-sharded
    # encoder against the plain tower on one device
    params = init_params(cfg, seed=0)
    srv = CLIPEncoder(Config(model=serving_config(cfg)), params=params, mesh=mesh)
    plain = CLIP(cfg)
    plain.load_state_dict(params)
    plain.to(first).eval()
    spx = rng.normal(size=(batch, 32, 32, 3)).astype(np.float32)
    b = srv.encode_pixels(spx).astype(np.float64)
    with torch.no_grad():
        a = plain.encode_image(torch.from_numpy(spx).to(first)).cpu().numpy().astype(np.float64)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    assert cos.min() > 0.99, cos.min()
    print(f"dryrun_multichip OK (serving): fused int8 whole-layer tower over the "
          f"{n_devices}-device data-sharded encoder, cos>={cos.min():.4f} vs parity", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--device", default=None, help="cpu, or one card (default: every card)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
