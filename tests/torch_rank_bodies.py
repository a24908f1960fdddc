"""Rank processes of the port's distributed CPU tests.

The test modules start these functions with ``torch.multiprocessing``
(:func:`start_ranks`): each rank joins a gloo group over a ``FileStore`` in
the test's temporary directory, runs every case of its module, and writes
its results to ``rank{r}.npz`` there. A rank's process imports this module
afresh, so it imports torch, numpy and the port only, never JAX: the JAX
side of each comparison runs in the test process.
"""

from __future__ import annotations

import json
import os
import traceback

import numpy as np

# tests/test_torch_seq_parallel.py: the seq group, the sizes and the cases
SEQ_WORLD = 4
SEQ_N, SEQ_H, SEQ_DH = 32, 4, 8
SEQ_SCHEDULE = ([4, 16, 32], [1, 2, 4])  # 16 and 32 exceed the 8-token shard: rps 2 (sub-rings) and 4
# a local branch whose ratio does not divide H = 4: the generic local route
HEADMAJOR_SCHEDULE = ([8, 16, 32], [3, 2, 4])
SEQ_VALID = 20  # the ragged cut falls inside rank 2 (tokens 16..23)
# name -> (schedule, ring, causal, ragged)
SEQ_CASES = {
    "gather": (SEQ_SCHEDULE, False, False, False),
    "ring": (SEQ_SCHEDULE, True, False, False),
    "causal_gather": (SEQ_SCHEDULE, False, True, False),
    "causal_ring": (SEQ_SCHEDULE, True, True, False),  # warns once and takes the gather path
    "ragged_gather": (SEQ_SCHEDULE, False, False, True),
    "ragged_ring": (SEQ_SCHEDULE, True, False, True),
    "headmajor_ragged": (HEADMAJOR_SCHEDULE, False, False, True),
}
# the 2-layer encoder: name -> (ring, ragged)
SEQ_ENCODER = dict(layers=2, embed_dim=32, heads=4, ffn=64)
SEQ_ENCODER_CASES = {"encoder_gather": (False, False), "encoder_ragged_ring": (True, True)}

# tests/test_torch_parallel.py: the data-parallel step
DATA_WORLD = 2
DATA_HEAD = dict(input_dim=32, latent_dim=64, feat_layer="1", n_classes=3)
DATA_SLIDE = dict(embed_dim=64, depth=1, segment_length=[8, 16], dilated_ratio="[1, 2]",
                  dropout=0.0, drop_path_rate=0.0)
DATA_B, DATA_N = 2, 16
DATA_LR = 0.1


def _init(rank: int, world: int, workdir: str):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
                            rank=rank, world_size=world)
    return torch, dist


def _refusal(fn) -> str:
    """The name of the exception ``fn`` raises, or ``"ok"``."""
    try:
        fn()
    except Exception as e:  # the test compares the type with the JAX package's
        return type(e).__name__
    return "ok"


def _seq_attention_cases(torch, dist, rank: int, inputs) -> dict:
    from gigapath_tpu_torch.ops.dilated_attention import dilated_attention
    from gigapath_tpu_torch.ops.dilated_kernels import PipelineFlags

    L = SEQ_N // SEQ_WORLD
    mine = slice(rank * L, (rank + 1) * L)
    q, k, v = (torch.from_numpy(inputs[n]) for n in ("q", "k", "v"))
    vmask = torch.ones(1, SEQ_N, 1, 1)
    vmask[:, SEQ_VALID:] = 0
    out = {}
    for name, ((sls, drs), ring, causal, ragged) in SEQ_CASES.items():
        flags = PipelineFlags(ring_attn=ring)
        weight = vmask if ragged else torch.ones_like(vmask)
        local = [x[:, mine].clone().requires_grad_(True) for x in (q, k, v)]
        valid = torch.tensor([min(max(SEQ_VALID - rank * L, 0), L)], dtype=torch.int32) if ragged else None
        o = dilated_attention(*local, sls, drs, is_causal=causal, valid_len=valid, flags=flags,
                              seq_group=dist.group.WORLD)
        ((o * weight[:, mine]) ** 2).sum().backward()
        out[name] = o.detach().numpy()
        for g, x in zip(("dq", "dk", "dv"), local):
            out[f"{name}_{g}"] = x.grad.numpy()
        if rank == 0:  # the port's single-device op on the whole sequence
            full = [x.clone().requires_grad_(True) for x in (q, k, v)]
            vfull = torch.tensor([SEQ_VALID], dtype=torch.int32) if ragged else None
            o = dilated_attention(*full, sls, drs, is_causal=causal, valid_len=vfull, flags=flags)
            ((o * weight) ** 2).sum().backward()
            out[f"single_{name}"] = o.detach().numpy()
            for g, x in zip(("dq", "dk", "dv"), full):
                out[f"single_{name}_{g}"] = x.grad.numpy()
    return out


def _seq_encoder_cases(torch, dist, rank: int, inputs, workdir: str) -> dict:
    from gigapath_tpu_torch.models.longnet import make_longnet_from_name

    L = SEQ_N // SEQ_WORLD
    mine = slice(rank * L, (rank + 1) * L)
    sls, drs = SEQ_SCHEDULE
    state = torch.load(os.path.join(workdir, "encoder_state.pt"))
    x = torch.from_numpy(inputs["x"])
    pad = torch.zeros(1, SEQ_N, dtype=torch.bool)
    pad[:, SEQ_VALID:] = True
    out = {}
    for name, (ring, ragged) in SEQ_ENCODER_CASES.items():
        model, _ = make_longnet_from_name(
            f"LongNet_{SEQ_ENCODER['layers']}_layers_{SEQ_ENCODER['embed_dim']}_dim",
            dilated_ratio=drs, segment_length=sls, drop_path_rate=0.0, dropout=0.0,
            encoder_attention_heads=SEQ_ENCODER["heads"], encoder_ffn_embed_dim=SEQ_ENCODER["ffn"],
            seq_parallel=True, seq_group=dist.group.WORLD,
        )
        model.load_state_dict(state, strict=True)
        model.eval()
        os.environ["GIGAPATH_RING_ATTN"] = "1" if ring else "0"
        try:
            with torch.no_grad():
                o = model(x[:, mine], encoder_padding_mask=pad[:, mine] if ragged else None)["encoder_out"]
        finally:
            del os.environ["GIGAPATH_RING_ATTN"]
        out[name] = o.numpy()
        if rank == 0:  # the same weights on one device, the whole sequence
            single, _ = make_longnet_from_name(
                f"LongNet_{SEQ_ENCODER['layers']}_layers_{SEQ_ENCODER['embed_dim']}_dim",
                dilated_ratio=drs, segment_length=sls, drop_path_rate=0.0, dropout=0.0,
                encoder_attention_heads=SEQ_ENCODER["heads"], encoder_ffn_embed_dim=SEQ_ENCODER["ffn"],
            )
            single.load_state_dict(state, strict=True)
            with torch.no_grad():
                o = single.eval()(x, encoder_padding_mask=pad if ragged else None)["encoder_out"]
            out[f"single_{name}"] = o.numpy()
    return out


def _seq_refusals(torch, dist, rank: int, refusals) -> dict:
    from gigapath_tpu_torch.ops.dilated_attention import dilated_attention
    from gigapath_tpu_torch.ops.dilated_kernels import PipelineFlags

    out = {}
    for case in refusals:
        shape = (1, case["n"] // case["world"], case["heads"], case["dh"])
        dev = "meta" if case.get("meta") else "cpu"
        q = torch.zeros(shape, device=dev)
        kv = torch.zeros((1, shape[1] + case.get("offset", 0)) + shape[2:], device=dev)
        valid = case.get("valid_len")
        if isinstance(valid, list):
            valid = torch.tensor([valid[rank]], dtype=torch.int32)
        out[f"refusal_{case['name']}"] = np.array(_refusal(lambda: dilated_attention(
            q, kv, kv, case["sls"], case["drs"], is_causal=case.get("causal", False), valid_len=valid,
            flags=PipelineFlags(ring_attn=case.get("ring", False)), seq_group=dist.group.WORLD,
            offset=case.get("offset", 0),
        )))
    return out


def seq_parallel_rank(rank: int, workdir: str) -> None:
    """One rank of tests/test_torch_seq_parallel.py: the attention cases,
    the encoder cases and the refusals, into ``rank{rank}.npz``."""
    try:
        torch, dist = _init(rank, SEQ_WORLD, workdir)
        inputs = dict(np.load(os.path.join(workdir, "inputs.npz")))
        with open(os.path.join(workdir, "refusals.json")) as f:
            refusals = json.load(f)
        out = _seq_attention_cases(torch, dist, rank, inputs)
        out.update(_seq_encoder_cases(torch, dist, rank, inputs, workdir))
        out.update(_seq_refusals(torch, dist, rank, refusals))
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
        dist.destroy_process_group()
    except Exception:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def data_parallel_rank(rank: int, workdir: str) -> None:
    """One rank of tests/test_torch_parallel.py: the mesh helpers, the
    layout of a state dict over a ``model`` dim, the refusal of a ``seq``
    dim in the train step, and one data-parallel train step on this rank's
    half of the batch, into ``rank{rank}.npz``."""
    try:
        torch, dist = _init(rank, DATA_WORLD, workdir)
        from gigapath_tpu_torch.models.classification_head import ClassificationHead
        from gigapath_tpu_torch.parallel import mesh as pmesh
        from gigapath_tpu_torch.parallel import sharding, spmd

        out = {}
        data = pmesh.make_mesh(axis_sizes={"data": DATA_WORLD}, device_type="cpu")
        out["data_mesh"] = np.array([data.size(0), pmesh.axis_size(data, "data"), pmesh.axis_size(data, "seq")])
        out["shard_batch_seq"] = np.array([repr(p) for p in pmesh.shard_batch_seq(data)])
        model_mesh = pmesh.make_mesh(axis_sizes={"model": DATA_WORLD}, device_type="cpu")
        seq_mesh = pmesh.make_mesh(axis_sizes={"seq": DATA_WORLD}, device_type="cpu")
        out["refusal_bad_size"] = np.array(_refusal(
            lambda: pmesh.make_mesh(axis_sizes={"data": 3}, device_type="cpu")))

        state = torch.load(os.path.join(workdir, "head_state.pt"))
        laid = sharding.apply_shardings(state, model_mesh)
        for name in ("slide_encoder.encoder.layers.0.ffn.fc1.weight",
                     "slide_encoder.encoder.layers.0.self_attn.out_proj.weight",
                     "slide_encoder.encoder.layers.0.ffn.fc1.bias"):
            out[f"local_{name}"] = laid[name].to_local().numpy()

        model = ClassificationHead(**DATA_HEAD, **DATA_SLIDE)
        model.load_state_dict(state, strict=True)
        opt = torch.optim.SGD(model.parameters(), lr=DATA_LR)
        out["refusal_seq_step"] = np.array(_refusal(lambda: spmd.make_train_step(model, opt, mesh=seq_mesh)))
        batch = dict(np.load(os.path.join(workdir, "batch.npz")))
        part = slice(rank * DATA_B // DATA_WORLD, (rank + 1) * DATA_B // DATA_WORLD)
        step = spmd.make_train_step(model, opt, mesh=data)
        loss = step({"images": torch.from_numpy(batch["images"][part]),
                     "coords": torch.from_numpy(batch["coords"][part]),
                     "labels": torch.from_numpy(batch["labels"][part])})
        out["loss"] = loss.numpy()
        for name, p in model.named_parameters():
            if p.grad is not None:
                out[f"grad_{name}"] = p.grad.numpy()
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
        dist.destroy_process_group()
    except Exception:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


# what the forkserver imports once for every rank it forks (imports only:
# nothing here starts a thread)
PRELOAD = ["torch", "torch.distributed", "torch_rank_bodies", "gigapath_tpu_torch.ops.dilated_attention",
           "gigapath_tpu_torch.models.longnet", "gigapath_tpu_torch.models.classification_head"]


def start_ranks(target, world: int, workdir: str):
    """Start ``world`` processes of ``target(rank, workdir)``; returns them.

    They fork from a forkserver: a fresh interpreter (no thread of the test
    process, JAX's among them, is inherited) that imports ``PRELOAD`` once,
    so a rank costs a fork, not a torch import."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(PRELOAD)
    procs = [ctx.Process(target=target, args=(r, workdir), daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join_ranks(procs, workdir: str, timeout: float = 120.0) -> list:
    """Wait for the ranks (killing any still running after ``timeout``
    seconds) and return each rank's results; raises with the ranks'
    tracebacks if one failed."""
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    errors = []
    for r, p in enumerate(procs):
        path = os.path.join(workdir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
        elif p.exitcode != 0:
            errors.append(f"rank {r}: exit code {p.exitcode}")
    if alive or errors:
        raise RuntimeError(f"{len(alive)} rank(s) timed out\n" + "\n".join(errors))
    return [dict(np.load(os.path.join(workdir, f"rank{r}.npz"))) for r in range(len(procs))]
