"""Ranks of ``lotus_tpu_torch.parallel`` for the CPU tests: processes started
as ``torchrun`` starts them, on gloo, with jax, pandas and lotus_tpu blocked.

``launch(io_dir, cases, world)`` runs ``world`` copies of this file; each
calls ``init_runtime()`` from the ``torchrun`` environment (a free port, so
test files running in parallel do not meet), builds ``serving_mesh`` on the
CPU and runs the named cases in order.  A case reads its inputs from
``io_dir`` and writes ``<case>.rank<r>.npz`` there; the tests hold those
outputs to ``lotus_tpu`` on the same inputs.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(io_dir: str, cases: list[str], world: int = 4, timeout: float = 240.0) -> list[str]:
    """Run the cases on ``world`` ranks; returns each rank's output and
    raises when a rank fails or the ranks outlast ``timeout`` seconds."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
               LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), io_dir, *cases],
                         env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=io_dir,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)
    ]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} failed:\n" + "\n".join(outs[r][-4000:] for r in bad))
    return outs


# --------------------------------------------------------------------------
# The rank side: nothing below imports jax, pandas or lotus_tpu.
# --------------------------------------------------------------------------


def _meta(path):
    from lotus_tpu_torch.ops import io as index_io

    return index_io.read_meta(path)


def _state(path, dtype):
    from lotus_tpu_torch.ops.ivf import load_ivf_state

    meta = _meta(path)
    state = load_ivf_state(path, meta, dtype, device="cpu")
    state.setdefault("meta", meta)
    return state


def _save(io, case, mesh, **arrays):
    import numpy as np

    np.savez(os.path.join(io, f"{case}.rank{mesh.slot}.npz"),
             **{k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v)) for k, v in arrays.items()})


def case_flat(io, mesh):
    import numpy as np
    import torch

    from lotus_tpu_torch.parallel import shard_rows, sharded_flat_search

    z = np.load(os.path.join(io, "flat.npz"))
    xb, xq = torch.from_numpy(z["xb"]), torch.from_numpy(z["xq"])
    out = {}
    for metric in ("ip", "l2"):
        local, n = shard_rows(xb, mesh, block_rows=64)
        out[f"d_{metric}"], out[f"i_{metric}"] = sharded_flat_search(
            local, xq, 10, n_rows=n, metric=metric, mesh=mesh, block_rows=64)
    z = np.load(os.path.join(io, "flat_mask.npz"))
    xb = torch.from_numpy(z["xb"])
    local, n = shard_rows(xb, mesh, block_rows=16)
    valid = np.zeros(local.shape[0] * mesh.size, bool)
    valid[: xb.shape[0]] = z["valid"]
    valid_local, _ = shard_rows(torch.from_numpy(valid), mesh, block_rows=16)
    out["d_mask"], out["i_mask"] = sharded_flat_search(
        local, torch.from_numpy(z["xq"]), 5, n_rows=n, mesh=mesh, valid=valid_local, block_rows=16)
    _save(io, "flat", mesh, **out)


def case_kmeans(io, mesh):
    import numpy as np
    import torch

    from lotus_tpu_torch.parallel import shard_rows, sharded_kmeans_fit
    from lotus_tpu_torch.parallel.kmeans import lloyd_step

    z = np.load(os.path.join(io, "kmeans.npz"))
    x_local, n = shard_rows(torch.from_numpy(z["x"]), mesh, block_rows=8)
    n_local = min(max(n - mesh.slot * x_local.shape[0], 0), x_local.shape[0])
    k = z["c0"].shape[0]
    (sums, counts, score), _ = lloyd_step(x_local, torch.from_numpy(z["c0"]), n_local=n_local, k=k,
                                          metric="l2", mesh=mesh, block_rows=128)
    res = sharded_kmeans_fit(x_local, k, n_rows=n, mesh=mesh, iters=10, block_rows=128,
                             init_centroids=torch.from_numpy(z["init"]))
    seeded = sharded_kmeans_fit(x_local, k, n_rows=n, mesh=mesh, iters=10, seed=0, block_rows=128)
    _save(io, "kmeans", mesh, sums=sums, counts=counts, score=score, assign=res.assignments,
          centroids=res.centroids, inertia=res.inertia, seeded_inertia=seeded.inertia,
          seeded_assign=seeded.assignments, x_local=x_local, n_local=n_local)


def case_window(io, mesh):
    """The sharded window probe over the stores the fixture built."""
    import numpy as np
    import torch

    from lotus_tpu_torch.parallel import shard_ivf_state, sharded_ivf_search

    z = np.load(os.path.join(io, "window.npz"))
    out = {}
    for name, dtype, nprobe, k, rescore in (
        ("ivf_full", torch.float32, 32, 10, None), ("ivf_partial", torch.float32, 6, 5, None),
        ("ivf8", torch.float32, 16, 5, None), ("ivf8", torch.int8, 16, 5, None),
        ("wrsc", torch.int8, 8, 5, None), ("wrsc", torch.int8, 8, 5, 32), ("scale", torch.float32, 16, 10, None),
    ):
        state = _state(os.path.join(io, name), dtype)
        sharded = shard_ivf_state(state, mesh)
        tag = f"{name}_{str(dtype).split('.')[-1]}_{rescore}"
        out[f"d_{tag}"], out[f"i_{tag}"] = sharded_ivf_search(
            sharded, torch.from_numpy(z[name]), k, nprobe=nprobe, metric="ip", rescore=rescore)
        out[f"owned_{tag}"] = sharded["owned"]
    _save(io, "window", mesh, **out)


def case_grouped(io, mesh):
    """The sharded grouped probe (K1's plain version on the CPU)."""
    import numpy as np
    import torch

    from lotus_tpu_torch.parallel import shard_ivf_state, sharded_ivf_search_pallas
    from lotus_tpu_torch.parallel.ivf import local_grouped_probe

    z = np.load(os.path.join(io, "grouped.npz"))
    out = {}
    for name, dtype, k, kw in (
        ("blk", torch.float32, 10, {}), ("blk8", torch.int8, 5, {}),
        ("blk8", torch.int8, 5, dict(int8_queries=True)),
        ("rsc", torch.int8, 5, dict(rescore=32)), ("rsc", torch.int8, 5, dict(rescore=32, query_chunk=3)),
        ("rsc", torch.int8, 5, dict(rescore=32, int8_queries=True)),
        ("spill", torch.float32, 10, {}),
    ):
        state = _state(os.path.join(io, name), dtype)
        sharded = shard_ivf_state(state, mesh)
        tag = f"{name}_" + "_".join(f"{a}{b}" for a, b in kw.items())
        xq = torch.from_numpy(z[name])
        out[f"d_{tag}"], out[f"i_{tag}"] = sharded_ivf_search_pallas(
            sharded, xq, k, nprobe=8, metric="ip", **kw)
        local_kw = {a: b for a, b in kw.items() if a != "query_chunk"}
        _, out[f"local_{tag}"], rows = local_grouped_probe(sharded, xq, k, nprobe=8, metric="ip", **local_kw)
        live = out[f"local_{tag}"] >= 0
        out[f"owned_ok_{tag}"] = bool(sharded["owned"][sharded["row_list"][rows[live].long()].long()].all())
    _save(io, "grouped", mesh, **out)


def case_roundtrip(io, mesh):
    """Shards written by either package load in the port; a mesh of the
    wrong size is refused."""
    import numpy as np
    import torch

    from lotus_tpu_torch.parallel import (
        ShardMesh, load_sharded_ivf_state, save_ivf_shards, shard_ivf_state, sharded_ivf_search,
    )

    xq = torch.from_numpy(np.load(os.path.join(io, "roundtrip.npz"))["xq"])
    out = {}
    state = _state(os.path.join(io, "rt_port"), torch.float32)
    out["d_mem"], out["i_mem"] = sharded_ivf_search(shard_ivf_state(state, mesh), xq, 5, nprobe=8, metric="ip")
    if mesh.slot == 0:
        save_ivf_shards(os.path.join(io, "rt_port"), state, mesh.size)
    mesh.barrier()
    for name in ("rt_port", "rt_jax"):
        path = os.path.join(io, name)
        disk = load_sharded_ivf_state(path, _meta(path), mesh)
        out[f"d_{name}"], out[f"i_{name}"] = sharded_ivf_search(disk, xq, 5, nprobe=8, metric="ip")
    half = ShardMesh(None, list(range(mesh.size // 2)), 0, "cpu")
    try:
        load_sharded_ivf_state(os.path.join(io, "rt_jax"), _meta(os.path.join(io, "rt_jax")), half)
        out["refused"] = False
    except ValueError as e:
        out["refused"] = "shards" in str(e)
    _save(io, "roundtrip", mesh, **out)


def case_store(io, mesh):
    """The config-5 lifecycle through ``TorchVS(mesh=...)``, beside a
    single-device store over the same files; an int8 Flat store."""
    import numpy as np

    from lotus_tpu_torch import TorchVS

    z = np.load(os.path.join(io, "store.npz"))
    emb, xq, allowed = z["emb"], z["xq"], z["allowed"].tolist()
    idx_dir = os.path.join(io, "cfg5")
    kw = dict(index_type="ivf", metric="ip", device_dtype="int8")
    TorchVS(nlist=8, mesh=mesh, **kw).index([f"doc {i}" for i in range(len(emb))], emb, idx_dir)
    server = TorchVS(nprobe=8, rescore=8, mesh=mesh, **kw)
    server.load_index(idx_dir)
    out = {"ids": server(xq, 5).indices}
    st = server._state
    out["shard_only"] = "ivf_sharded" in st and "ivf_vectors" not in st and "row_list" in st["ivf_sharded"]
    out["routes"] = [server.stats["routes"][r] for r in ("grouped_probe", "window_probe", "scan")]
    out["ids_bf16"] = server(xq, 5, int8_queries=False).indices
    solo = TorchVS(nprobe=8, rescore=8, device="cpu", **kw)
    solo.load_index(idx_dir)
    out["solo"] = solo(xq, 5).indices
    out["sub"] = server(xq, 5, ids=allowed).indices
    out["sub_d"] = server(xq, 5, ids=allowed).distances
    out["no_flat_copy"] = "xb" not in server._state
    cal = server.calibrate_nprobe(0.9, k=5, nq=16)
    out["cal"] = [cal["nprobe"], cal["recall"]]
    # An unaligned store under the mesh: B 1 through the window probe, a
    # batch whose B * nprobe reaches nlist through the sharded scan.
    wdir = os.path.join(io, "cfg5_window")
    TorchVS(nlist=64, mesh=mesh, index_type="ivf", metric="ip").index([], emb, wdir)
    win = TorchVS(nprobe=4, mesh=mesh, index_type="ivf", metric="ip")
    win.load_index(wdir)
    out["win_one"] = win(xq[:1], 5).indices
    out["win_many"] = win(xq, 5, nprobe=8).indices
    out["win_routes"] = [win.stats["routes"][r] for r in ("grouped_probe", "window_probe", "scan")]
    # tests/test_autotune.py::test_calibrate_on_sharded_store on the port.
    sh = TorchVS(index_type="ivf", nlist=16, nprobe=1, mesh=mesh)
    sh.index([], z["auto_emb"], os.path.join(io, "auto_sharded"))
    res = sh.calibrate_nprobe(0.95, k=10, nq=64)
    out["auto"] = [res["nprobe"], res["recall"], sh.nprobe]
    flat = TorchVS(device_dtype="int8", mesh=mesh, block_rows=32)
    flat.index([], z["flat_emb"], os.path.join(io, "flat_int8"))
    out["flat"] = flat(z["flat_xq"], 5).indices
    out["flat_sub"] = flat(z["flat_xq"], 5, ids=z["flat_allowed"].tolist()).indices
    _save(io, "store", mesh, **out)


def case_import(io, mesh):
    """One search from the ``torchrun`` environment, jax never imported."""
    import numpy as np
    import torch

    from lotus_tpu_torch.parallel import shard_rows, sharded_flat_search

    rng = np.random.default_rng(0)
    xb = rng.standard_normal((300, 16)).astype(np.float32)
    local, n = shard_rows(torch.from_numpy(xb), mesh, block_rows=8)
    _, ids = sharded_flat_search(local, torch.from_numpy(xb[:4]), 3, n_rows=n, mesh=mesh, block_rows=8)
    want = np.argsort(-(xb[:4] @ xb.T), axis=1)[:, :3]
    assert (ids.numpy() == want).all(), (ids, want)
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "pandas", "lotus_tpu") and sys.modules[m] is not None]
    assert not bad, bad
    _save(io, "import", mesh, ids=ids, world=mesh.size)


def main(argv: list[str]) -> int:
    for name in ("jax", "jaxlib", "pandas", "pydantic", "lotus_tpu"):
        sys.modules[name] = None  # any import of them raises ImportError
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    from lotus_tpu_torch.parallel import init_runtime, serving_mesh

    io, cases = argv[0], argv[1:]
    assert init_runtime(), "no torchrun environment"
    mesh = serving_mesh(device="cpu")
    for case in cases:
        globals()[f"case_{case}"](io, mesh)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
