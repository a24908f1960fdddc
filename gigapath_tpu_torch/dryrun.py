"""Top-level entry points of the port (counterpart of the JAX package's
``__graft_entry__.py``): a one-device forward check and a multi-rank dry
run.

- :func:`entry` returns ``(fn, args)``: the flagship slide encoder
  (``gigapath_slide_enc12l768d``) in bf16 on 2048 synthetic tile
  embeddings, ``fn(*args)`` its final embedding.
- :func:`dryrun_multichip` runs, over ``n`` rank processes, the JAX
  package's two stages on the same meshes, models and shapes:

  1. one train step (``parallel/spmd.py:make_train_step``, AdamW) of a
     depth-2, 768-wide ``ClassificationHead`` on ``factorize(n, ("data",
     "seq", "model"))``: the batch over ``data``, the tokens over ``seq``
     (gathered at the step's entry), the attention and FFN weights over
     ``model`` (tensor-parallel, ``parallel/tensor.py``), dropout 0.1;
  2. one forward and backward of a 2-layer MoE encoder (``moe_freq=2``,
     top-1, ``2 * expert`` experts) on ``factorize(n, ("data",
     "expert"))``, the experts spread over ``expert`` (the single-device
     function, ``ops/moe/expert_parallel.py:experts_gathered``), the
     balance loss in the objective.

  Each stage prints one line with its mesh and its loss, which must be
  finite. The ranks (forked from a forkserver that has imported torch and
  the port) join a gloo group over a ``FileStore`` in a temporary
  directory; on the card every rank runs on ``cuda:0`` (NCCL refuses two
  ranks on one device), with ``device="cpu"`` on the CPU. A rank that
  fails, or a deadline passed, makes the call raise.

Run it as ``python -m gigapath_tpu_torch.dryrun [n] [--device cpu]``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile
import time
import traceback
from typing import Optional

import numpy as np

DRYRUN_TIMEOUT_S = 900
# what the rank processes' forkserver imports once (imports only: nothing
# here starts a thread or touches CUDA), so a rank costs a fork, not a
# torch import
RANK_PRELOAD = ["torch", "torch.distributed", "gigapath_tpu_torch.dryrun",
                "gigapath_tpu_torch.models.classification_head", "gigapath_tpu_torch.models.longnet",
                "gigapath_tpu_torch.ops.moe", "gigapath_tpu_torch.parallel.spmd"]


def start_ranks(target, n: int, workdir: str, args: tuple = (), preload=()) -> list:
    """Start ``n`` processes of ``target(rank, workdir, *args)`` and return
    them. They fork from a forkserver (a fresh interpreter that imports
    ``RANK_PRELOAD`` and ``preload`` once), never from the caller, which
    may hold a CUDA context or threads. A rank writes its traceback to
    ``{workdir}/rank{rank}.err`` when it fails. The forkserver is one a
    process: the preload of the first call that starts it holds."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(RANK_PRELOAD + [m for m in preload if m not in RANK_PRELOAD])
    procs = [ctx.Process(target=target, args=(r, workdir, *args), daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    return procs


def join_ranks(procs, workdir: str, timeout: float, what: str = "ranks") -> None:
    """Wait for ``procs``: as soon as one has failed, or ``timeout`` seconds
    from now, kill every one still running, and raise ``RuntimeError``
    with the exit codes and the ranks' ``rank{r}.err`` texts."""
    deadline = time.monotonic() + timeout
    timed_out = False
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() >= deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        killed = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    errors = [f"rank {r}:\n" + open(os.path.join(workdir, f"rank{r}.err")).read() for r in range(len(procs))
              if os.path.exists(os.path.join(workdir, f"rank{r}.err"))]
    codes = [p.exitcode for p in procs]
    if killed or errors or any(c != 0 for c in codes):
        why = f"the {timeout} s deadline passed" if timed_out else "a rank failed"
        raise RuntimeError(f"{what} failed ({why}; exit codes {codes}, rank(s) {killed} killed):\n"
                           + "\n".join(errors))


def run_ranks(target, n: int, workdir: str, args: tuple = (), timeout: float = DRYRUN_TIMEOUT_S,
              what: str = "ranks") -> None:
    """:func:`start_ranks`, then :func:`join_ranks`."""
    join_ranks(start_ranks(target, n, workdir, args), workdir, timeout, what)


def entry(device=None):
    """``(fn, args)``: ``fn(model, x, coords)`` is the flagship slide
    encoder's final embedding (bf16, random weights from a seeded
    generator) on ``N = 2048`` synthetic tiles, which segments the
    schedule's first branch twice and gives every branch its own sparse
    length."""
    import torch

    from gigapath_tpu_torch.models import slide_encoder
    from gigapath_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model = slide_encoder.create_model("", "gigapath_slide_enc12l768d", in_chans=1536, device=dev)
    model = model.to(torch.bfloat16)
    n = 2048
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, n, 1536)).astype(np.float32))
    coords = torch.from_numpy(np.random.default_rng(1).uniform(0, 250000, size=(1, n, 2)).astype(np.float32))

    def fn(model, x, coords):
        with torch.no_grad():
            return model(x, coords)[0]

    return fn, (model, x.to(dev, torch.bfloat16), coords.to(dev))


def _stage_train_step(n: int, device, device_type: str) -> str:
    """Stage 1 on this rank; rank 0's line, else ''."""
    import torch
    import torch.distributed as dist

    from gigapath_tpu_torch.models.classification_head import ClassificationHead
    from gigapath_tpu_torch.parallel.mesh import factorize, make_mesh
    from gigapath_tpu_torch.parallel.spmd import make_train_step
    from gigapath_tpu_torch.parallel.tensor import shard_state_dict

    axes = factorize(n, ("data", "seq", "model"))
    mesh = make_mesh(n, axis_sizes=axes, device_type=device_type)
    model_group = mesh.get_group("model") if axes["model"] > 1 else None
    B, N, C = 2 * axes["data"], 64, 6
    head = dict(input_dim=1536, latent_dim=768, feat_layer="1-2", n_classes=C, embed_dim=768, depth=2,
                segment_length=[16, 64], dilated_ratio="[1, 2]", dropout=0.1, drop_path_rate=0.0)
    torch.manual_seed(0)  # the classifier's init: the same whole weights on every rank
    full = ClassificationHead(**head)
    full.slide_encoder.init_weights(torch.Generator().manual_seed(0))
    state = full.state_dict()
    with torch.device("meta"):
        model = ClassificationHead(**head, model_group=model_group)
    model.load_state_dict(shard_state_dict(state, mesh.get_local_rank("model"), axes["model"]), strict=True,
                          assign=True)
    model.to(device)
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-4)
    step = make_train_step(model, optimizer, mesh=mesh, seed=1)

    d, s = mesh.get_local_rank("data"), mesh.get_local_rank("seq")
    rows = slice(d * B // axes["data"], (d + 1) * B // axes["data"])
    toks = slice(s * N // axes["seq"], (s + 1) * N // axes["seq"])
    x = np.random.default_rng(0).normal(size=(B, N, 1536)).astype(np.float32)
    coords = np.random.default_rng(1).uniform(0, 250000, (B, N, 2)).astype(np.float32)
    batch = {"images": torch.from_numpy(x[rows, toks]).to(device),
             "coords": torch.from_numpy(coords[rows, toks]).to(device),
             "labels": torch.from_numpy(np.arange(B)[rows] % C).to(device)}
    loss = float(step(batch))
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip({n}): non-finite train-step loss {loss}")
    dist.barrier()
    return (f"dryrun_multichip({n}): one sharded train step done, mesh={axes}, loss={loss:.4f}"
            if dist.get_rank() == 0 else "")


def _stage_moe(n: int, device, device_type: str) -> str:
    """Stage 2 on this rank; rank 0's line, else ''."""
    import torch
    import torch.distributed as dist

    from gigapath_tpu_torch.architecture.config import EncoderConfig
    from gigapath_tpu_torch.architecture.encoder import Encoder
    from gigapath_tpu_torch.parallel.mesh import factorize, make_mesh
    from gigapath_tpu_torch.parallel.spmd import collect_moe_l_aux
    from gigapath_tpu_torch.parallel.tensor import shard_state_dict

    axes = factorize(n, ("data", "expert"))
    mesh = make_mesh(n, axis_sizes=axes, device_type=device_type)
    n_experts = 2 * max(1, axes["expert"])
    cfg = dict(encoder_embed_dim=16, encoder_attention_heads=2, encoder_ffn_embed_dim=32, encoder_layers=2,
               moe_freq=2, moe_expert_count=n_experts, moe_top1_expert=True)
    torch.manual_seed(3)
    state = Encoder(EncoderConfig(**cfg)).state_dict()
    ecfg = EncoderConfig(**cfg)
    expert_group = mesh.get_group("expert") if axes["expert"] > 1 else None
    ecfg.extras.update(expert_group=expert_group, expert_parallel="gather")
    with torch.device("meta"):
        enc = Encoder(ecfg)
    enc.load_state_dict(shard_state_dict(state, mesh.get_local_rank("expert"), axes["expert"], axis="expert"),
                        strict=True, assign=True)
    enc.to(device).eval()  # the JAX stage applies it deterministically: eval capacity, no noise
    B = 2 * axes["data"]
    d = mesh.get_local_rank("data")
    x = np.random.default_rng(2).normal(size=(B, 16, 16)).astype(np.float32)
    x = torch.from_numpy(x[d * B // axes["data"]:(d + 1) * B // axes["data"]]).to(device)
    out = enc(token_embeddings=x)
    loss = out["encoder_out"].var(correction=0) + 0.01 * collect_moe_l_aux(enc).to(device)
    loss.backward()
    reduced = torch.stack([loss.detach()] + [p.grad.detach().abs().sum() for p in
                                            enc.layers[1].moe_layer.parameters() if p.grad is not None])
    if axes["data"] > 1:
        dist.all_reduce(reduced, group=mesh.get_group("data"))
        reduced[0] /= axes["data"]
    loss = float(reduced[0])
    if not bool(torch.isfinite(reduced).all()):
        raise RuntimeError(f"dryrun_multichip({n}): non-finite MoE loss or gradients {reduced.tolist()}")
    dist.barrier()
    return (f"dryrun_multichip({n}): MoE expert-parallel step done, mesh={axes}, experts={n_experts}, "
            f"loss={loss:.4f}" if dist.get_rank() == 0 else "")


def _rank(rank: int, workdir: str, n: int, device_type: str) -> None:
    """One rank process: the gloo group, both stages, rank 0's lines to
    ``lines.json``; a traceback to ``rank{rank}.err``."""
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        if device_type == "cuda":
            torch.cuda.set_device(0)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        device = torch.device("cuda", 0) if device_type == "cuda" else torch.device("cpu")
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(workdir, "store"), n), rank=rank,
                                world_size=n, timeout=datetime.timedelta(seconds=DRYRUN_TIMEOUT_S))
        lines = [_stage_train_step(n, device, device_type), _stage_moe(n, device, device_type)]
        if rank == 0:
            with open(os.path.join(workdir, "lines.json"), "w") as f:
                json.dump(lines, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def dryrun_multichip(n_devices: int, device: Optional[str] = None, timeout: float = DRYRUN_TIMEOUT_S) -> list:
    """Both stages over ``n_devices`` rank processes (the module docstring)
    on the card (``cuda:0``, shared) unless ``device="cpu"``. Prints and
    returns the stages' lines; raises if a rank fails or the deadline
    passes (every rank still running is killed)."""
    from gigapath_tpu_torch.utils.device import resolve_device

    device_type = resolve_device(device).type
    with tempfile.TemporaryDirectory(prefix="dryrun_") as work:
        run_ranks(_rank, n_devices, work, (n_devices, device_type), timeout, f"dryrun_multichip({n_devices})")
        with open(os.path.join(work, "lines.json")) as f:
            lines = json.load(f)
    for line in lines:
        print(line, flush=True)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=4)
    ap.add_argument("--device", default=None, help="'cpu' to run the ranks on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
