"""Which ``torch.distributed`` collectives the gloo backend takes for CUDA
tensors, on the installed PyTorch.

On a machine with one card, NCCL refuses two ranks on one device, so the
sequence-parallel ranks of ``chip_smoke.py`` run as processes sharing
``cuda:0`` over a gloo group. This script runs each collective the
sequence-parallel attention could use, on CUDA tensors in fp32 and bf16,
in a group of its own (two ranks on ``cuda:0``, a ``FileStore`` under a
temporary directory), and prints one JSON line per case: whether the ranks
exited cleanly and whether the result was right. A case that crashes a
rank takes down only its own group.

    python3 scripts/torch_gloo_cuda_probe.py

Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

CASES = (
    "all_gather", "all_gather_into_tensor", "reduce_scatter", "reduce_scatter_tensor",
    "all_reduce", "batch_isend_irecv", "isend_irecv", "all_to_all_single", "broadcast",
    "device_mesh",
)
W = 2


def _run_case(rank: int, case: str, dtype_name: str, store: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(store, W), rank=rank, world_size=W)
    dev = torch.device("cuda", 0)
    dt = getattr(torch, dtype_name)
    x = torch.full((4,), float(rank + 1), dtype=dt, device=dev)
    got = want = None
    if case == "all_gather":
        lst = [torch.empty_like(x) for _ in range(W)]
        dist.all_gather(lst, x)
        got, want = torch.cat(lst), torch.cat([torch.full_like(x, i + 1) for i in range(W)])
    elif case == "all_gather_into_tensor":
        o = torch.empty(W * 4, dtype=dt, device=dev)
        dist.all_gather_into_tensor(o, x)
        got, want = o, torch.cat([torch.full_like(x, i + 1) for i in range(W)])
    elif case == "reduce_scatter":
        o = torch.empty_like(x)
        dist.reduce_scatter(o, [torch.full_like(x, i + 1) for i in range(W)])
        got, want = o, torch.full_like(x, W * (rank + 1))
    elif case == "reduce_scatter_tensor":
        o = torch.empty_like(x)
        dist.reduce_scatter_tensor(o, torch.cat([torch.full_like(x, i + 1) for i in range(W)]))
        got, want = o, torch.full_like(x, W * (rank + 1))
    elif case == "all_reduce":
        dist.all_reduce(x)
        got, want = x, torch.full_like(x, sum(range(1, W + 1)))
    elif case in ("batch_isend_irecv", "isend_irecv"):
        r = torch.empty_like(x)
        nxt, prv = (rank + 1) % W, (rank - 1) % W
        if case == "batch_isend_irecv":
            works = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, nxt), dist.P2POp(dist.irecv, r, prv)])
        else:
            works = [dist.isend(x, nxt), dist.irecv(r, prv)]
        for w in works:
            w.wait()
        got, want = r, torch.full_like(x, prv + 1)
    elif case == "all_to_all_single":
        inp = torch.tensor([10 * rank + j for j in range(W)], dtype=dt, device=dev)
        o = torch.empty_like(inp)
        dist.all_to_all_single(o, inp)
        got, want = o, torch.tensor([10 * j + rank for j in range(W)], dtype=dt, device=dev)
    elif case == "broadcast":
        dist.broadcast(x, src=0)
        got, want = x, torch.full_like(x, 1)
    elif case == "device_mesh":
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cuda", (1, W), mesh_dim_names=("data", "seq"))
        g = mesh.get_group("seq")
        dist.all_reduce(x, group=g)
        got, want = x, torch.full_like(x, sum(range(1, W + 1)))
    torch.cuda.synchronize()
    ok = bool(torch.equal(got.cpu(), want.cpu()))
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"ok": ok, "got": got.float().cpu().tolist()}, f)
    dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="gloo_probe_")
    runs = []
    for case in CASES:
        for dtype_name in ("float32", "bfloat16"):
            tag = f"{case}_{dtype_name}"
            store, out = os.path.join(tmp, tag + ".store"), os.path.join(tmp, tag + ".json")
            procs = [ctx.Process(target=_run_case, args=(r, case, dtype_name, store, out)) for r in range(W)]
            for p in procs:
                p.start()
            runs.append((case, dtype_name, out, procs))
    for case, dtype_name, out, procs in runs:
        for p in procs:
            p.join(timeout=120)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        res = {"case": case, "dtype": dtype_name, "exitcodes": [p.exitcode for p in procs],
               "hung": bool(alive)}
        if os.path.exists(out):
            with open(out) as f:
                res.update(json.load(f))
        else:
            res["ok"] = False
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
