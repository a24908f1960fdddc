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

# tests/test_torch_tensor_parallel.py: the tensor-parallel steps. The head
# is JAX's test head at 16 heads with two branches: r = 16 exceeds H/T for
# T = 2 and 4 (a rank's heads span several phases), r = 1 does not
TP_WORLD = 8
TP_HEAD = dict(input_dim=32, latent_dim=64, feat_layer="1", n_classes=3)
TP_SLIDE = dict(embed_dim=64, depth=1, segment_length=[8, 32], dilated_ratio="[1, 16]",
                dropout=0.0, drop_path_rate=0.0)
TP_B, TP_N = 2, 32
TP_LR = 0.1
# name -> (mesh axes, whether every data rank takes the whole batch)
TP_MESHES = {
    "model2": ({"data": 4, "model": 2}, True),
    "model4": ({"data": 2, "model": 4}, True),
    "data2_seq2_model2": ({"data": 2, "seq": 2, "model": 2}, False),
}
TP_DROPOUT = 0.25

# tests/test_torch_moe.py: the expert-parallel cases
MOE_WORLD = 4
MOE_LAYER = dict(embed_dim=16, ffn_dim=32, num_experts=8, top1=True)  # JAX's GSPMD test's layer
MOE_X_SHAPE = (2, 16, 16)
# JAX's shard_map test: E experts over D ranks, S_loc tokens a rank
MOE_E, MOE_S_LOC, MOE_M, MOE_F = 8, 8, 16, 32
MOE_AUX_WEIGHT = 0.1
MOE_DROPOUT = 0.25  # the dropout case of variant (a)


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
    layout of a state dict over a ``model`` dim, one train step over a
    ``seq`` dim on this rank's half of the tokens, and one data-parallel
    train step on this rank's half of the batch, into ``rank{rank}.npz``."""
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

        batch = dict(np.load(os.path.join(workdir, "batch.npz")))
        # a seq dim: each rank passes half of the tokens, the step gathers them
        seq_model = ClassificationHead(**DATA_HEAD, **DATA_SLIDE)
        seq_model.load_state_dict(state, strict=True)
        seq_opt = torch.optim.SGD(seq_model.parameters(), lr=DATA_LR)
        seq_step = {}
        out["refusal_seq_step"] = np.array(_refusal(
            lambda: seq_step.setdefault("fn", spmd.make_train_step(seq_model, seq_opt, mesh=seq_mesh))))
        toks = slice(rank * DATA_N // DATA_WORLD, (rank + 1) * DATA_N // DATA_WORLD)
        out["seq_step_loss"] = seq_step["fn"]({"images": torch.from_numpy(batch["images"][:, toks]),
                                               "coords": torch.from_numpy(batch["coords"][:, toks]),
                                               "labels": torch.from_numpy(batch["labels"])}).numpy()
        model = ClassificationHead(**DATA_HEAD, **DATA_SLIDE)
        model.load_state_dict(state, strict=True)
        opt = torch.optim.SGD(model.parameters(), lr=DATA_LR)
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


def _tp_step(torch, dist, pmesh, name: str, state, batch) -> dict:
    """One SGD step of the tensor-parallel head on mesh ``name``: the
    averaged loss, and (on global rank 0) the gradients gathered over the
    model group, by parameter name."""
    from gigapath_tpu_torch.models.classification_head import ClassificationHead
    from gigapath_tpu_torch.parallel import spmd
    from gigapath_tpu_torch.parallel.tensor import gather_state_dict, shard_state_dict

    axes, whole = TP_MESHES[name]
    mesh = pmesh.make_mesh(axis_sizes=axes, device_type="cpu")
    group = mesh.get_group("model")
    model = ClassificationHead(**TP_HEAD, **TP_SLIDE, model_group=group)
    model.load_state_dict(shard_state_dict(state, mesh.get_local_rank("model"), axes["model"]), strict=True)
    step = spmd.make_train_step(model, torch.optim.SGD(model.parameters(), lr=TP_LR), mesh=mesh)
    part = {k: torch.from_numpy(v) for k, v in batch.items()}
    if not whole:
        d, sq = mesh.get_local_rank("data"), mesh.get_local_rank("seq")
        rows = slice(d * TP_B // axes["data"], (d + 1) * TP_B // axes["data"])
        toks = slice(sq * TP_N // axes["seq"], (sq + 1) * TP_N // axes["seq"])
        part = {"images": part["images"][rows, toks], "coords": part["coords"][rows, toks],
                "labels": part["labels"][rows]}
    out = {f"{name}_loss": step(part).numpy()}
    # a parameter the loss does not reach (the encoder's final norm under
    # feat_layer "1") has no .grad; JAX's gradient there is 0
    grads = gather_state_dict({n: torch.zeros_like(p) if p.grad is None else p.grad
                               for n, p in model.named_parameters()}, group=group)
    if dist.get_rank() == 0:
        out.update({f"{name}_grad_{n}": g.numpy() for n, g in grads.items()})
    return out


def _tp_dropout(torch, dist, pmesh, state, batch) -> dict:
    """The head with dropout in training mode on a model group of 2 and on
    one device, each after ``torch.manual_seed(7)``: the logits."""
    from gigapath_tpu_torch.models.classification_head import ClassificationHead
    from gigapath_tpu_torch.parallel.tensor import shard_state_dict

    mesh = pmesh.make_mesh(axis_sizes={"data": TP_WORLD // 2, "model": 2}, device_type="cpu")
    slide = dict(TP_SLIDE, dropout=TP_DROPOUT)
    out = {}
    for name, group in (("dropout_tp", mesh.get_group("model")), ("dropout_single", None)):
        model = ClassificationHead(**TP_HEAD, **slide, model_group=group)
        local = state if group is None else shard_state_dict(state, mesh.get_local_rank("model"), 2)
        model.load_state_dict(local, strict=True)
        model.train()
        torch.manual_seed(7)
        out[name] = model(torch.from_numpy(batch["images"]), torch.from_numpy(batch["coords"])).detach().numpy()
    return out


def _tp_refusals(torch, dist) -> dict:
    from gigapath_tpu_torch.models.longnet import make_longnet_from_name
    from gigapath_tpu_torch.ops.attention import MultiheadAttention
    from gigapath_tpu_torch.ops.dilated_attention import DilatedAttention, dilated_attention
    from gigapath_tpu_torch.ops.feedforward import FeedForwardNetwork

    world = dist.group.WORLD
    q = torch.zeros(1, 16, 2, 4)
    cases = {
        "seq_and_model": lambda: DilatedAttention(64, 16, [8], [1], seq_parallel=True, seq_group=world,
                                                  model_group=world),
        "op_seq_and_heads": lambda: dilated_attention(q, q, q, [16], [1], head_offset=2, num_heads=16,
                                                      seq_group=world),
        "heads_not_divisible": lambda: MultiheadAttention(48, 12, model_group=world),
        "ffn_not_divisible": lambda: FeedForwardNetwork(64, 100, model_group=world),
        "moe_and_model": lambda: make_longnet_from_name(
            "LongNet_2_layers_64_dim", dilated_ratio=[1], segment_length=[16], moe_freq=2, moe_expert_count=8,
            model_group=world),
    }
    return {f"refusal_{n}": np.array(_refusal(fn)) for n, fn in cases.items()}


def tensor_parallel_rank(rank: int, workdir: str) -> None:
    """One rank of tests/test_torch_tensor_parallel.py: the steps on every
    ``TP_MESHES`` mesh, the dropout check and the refusals, into
    ``rank{rank}.npz``."""
    try:
        torch, dist = _init(rank, TP_WORLD, workdir)
        from gigapath_tpu_torch.parallel import mesh as pmesh

        state = torch.load(os.path.join(workdir, "head_state.pt"))
        batch = dict(np.load(os.path.join(workdir, "batch.npz")))
        out = {}
        for name in TP_MESHES:
            out.update(_tp_step(torch, dist, pmesh, name, state, batch))
        out.update(_tp_dropout(torch, dist, pmesh, state, batch))
        out.update(_tp_refusals(torch, dist))
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
        dist.destroy_process_group()
    except Exception:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _moe_gathered(torch, dist, rank: int, inputs, workdir: str) -> dict:
    """Variant (a): the layer's experts over the group, every rank on the
    same tokens: the output, l_aux, and the gradients of ``sum(out * ct)
    + MOE_AUX_WEIGHT * l_aux`` (the experts' gathered)."""
    from gigapath_tpu_torch.ops.moe import MOELayer
    from gigapath_tpu_torch.parallel.tensor import gather_state_dict, shard_state_dict

    world = dist.group.WORLD
    layer = MOELayer(**MOE_LAYER, expert_group=world, expert_parallel="gather")
    state = torch.load(os.path.join(workdir, "moe_state.pt"))
    layer.load_state_dict(shard_state_dict(state, rank, MOE_WORLD, axis="expert"), strict=True)
    layer.eval()
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    out, l_aux = layer(x)
    ((out * torch.from_numpy(inputs["ct"])).sum() + MOE_AUX_WEIGHT * l_aux).backward()
    grads = gather_state_dict({n: p.grad for n, p in layer.named_parameters()}, group=world, axis="expert")
    res = {"gathered_out": out.detach().numpy(), "gathered_l_aux": l_aux.detach().numpy(),
           "gathered_dx": x.grad.numpy()}
    res.update({f"gathered_grad_{n}": g.numpy() for n, g in grads.items()})
    return res


def _moe_gathered_dropout(torch, dist, rank: int, inputs, workdir: str) -> dict:
    """Variant (a) in training mode with dropout, the one-device layer on
    the same weights, and that layer without dropout, each after
    ``torch.manual_seed(11)``: the outputs and the gradients of ``sum(out *
    ct)`` (the experts' gathered)."""
    from gigapath_tpu_torch.ops.moe import MOELayer
    from gigapath_tpu_torch.parallel.tensor import gather_state_dict, shard_state_dict

    world = dist.group.WORLD
    state = torch.load(os.path.join(workdir, "moe_state.pt"))
    out = {}
    for name, group, p in (("dropout_gathered", world, MOE_DROPOUT), ("dropout_single", None, MOE_DROPOUT),
                           ("dropout_none", None, 0.0)):
        layer = MOELayer(**MOE_LAYER, dropout=p, activation_dropout=p, expert_group=group)
        layer.load_state_dict(state if group is None else shard_state_dict(state, rank, MOE_WORLD, axis="expert"),
                              strict=True)
        layer.train()
        torch.manual_seed(11)
        x = torch.from_numpy(inputs["x"]).requires_grad_(True)
        y, _ = layer(x)
        (y * torch.from_numpy(inputs["ct"])).sum().backward()
        grads = {n: p.grad for n, p in layer.named_parameters()}
        if group is not None:
            grads = gather_state_dict(grads, group=group, axis="expert")
        out[f"{name}_out"] = y.detach().numpy()
        out[f"{name}_dx"] = x.grad.numpy()
        out.update({f"{name}_grad_{n}": g.numpy() for n, g in grads.items()})
    return out


def _moe_all_to_all(torch, dist, rank: int, inputs) -> dict:
    """Variant (b), JAX's shard_map test's function: this rank's tokens and
    experts, per-shard gating; the output slice, l_aux, and the gradients
    of ``sum(out * ct) + MOE_AUX_WEIGHT * l_aux`` (wg's summed over the
    ranks)."""
    import torch.nn.functional as F

    from gigapath_tpu_torch.ops.moe.expert_parallel import moe_expert_parallel
    from gigapath_tpu_torch.ops.moe.routing import top1_gating

    world = dist.group.WORLD
    el = MOE_E // MOE_WORLD
    mine = slice(rank * MOE_S_LOC, (rank + 1) * MOE_S_LOC)
    tokens = torch.from_numpy(inputs["tokens"][mine]).requires_grad_(True)
    wg = torch.from_numpy(inputs["wg"]).requires_grad_(True)
    w1 = torch.from_numpy(inputs["w1"][rank * el:(rank + 1) * el]).requires_grad_(True)
    w2 = torch.from_numpy(inputs["w2"][rank * el:(rank + 1) * el]).requires_grad_(True)

    def gate_fn(t):
        return top1_gating(t @ wg)

    def expert_fn(d):
        return torch.bmm(F.gelu(torch.bmm(d, w1), approximate="tanh"), w2)

    out, l_aux, _ = moe_expert_parallel(gate_fn, expert_fn, tokens, world)
    ((out * torch.from_numpy(inputs["tokens_ct"][mine])).sum() + MOE_AUX_WEIGHT * l_aux).backward()
    dwg = wg.grad.clone()
    dist.all_reduce(dwg)
    return {"a2a_out": out.detach().numpy(), "a2a_l_aux": l_aux.detach().numpy(), "a2a_dtokens": tokens.grad.numpy(),
            "a2a_dw1": w1.grad.numpy(), "a2a_dw2": w2.grad.numpy(), "a2a_dwg": dwg.numpy()}


def moe_rank(rank: int, workdir: str) -> None:
    """One rank of tests/test_torch_moe.py: both expert-parallel variants
    and variant (a)'s dropout case, into ``rank{rank}.npz``."""
    try:
        torch, dist = _init(rank, MOE_WORLD, workdir)
        inputs = dict(np.load(os.path.join(workdir, "inputs.npz")))
        out = _moe_gathered(torch, dist, rank, inputs, workdir)
        out.update(_moe_gathered_dropout(torch, dist, rank, inputs, workdir))
        out.update(_moe_all_to_all(torch, dist, rank, inputs))
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
        dist.destroy_process_group()
    except Exception:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


# tests/test_torch_dist.py: the stage meshes
STAGE_WORLD = 4
STAGE_HEAD = dict(input_dim=16, latent_dim=32, feat_layer="1", n_classes=2, model_arch="gigapath_slide_enc_tiny")


def stagemesh_rank(rank: int, workdir: str) -> None:
    """One rank of tests/test_torch_dist.py's stage meshes: two stages on
    disjoint rank halves, the slide stage's placements at {seq: 2, model:
    2}, a one-rank mesh's, and the refused axis, into ``rank{rank}.npz``
    (meshes as JSON, placements as their reprs)."""
    try:
        torch, dist = _init(rank, STAGE_WORLD, workdir)
        from gigapath_tpu_torch.dist.stagemesh import stage_mesh, stage_param_shardings
        from gigapath_tpu_torch.models.classification_head import get_model

        def desc(mesh):
            return json.dumps({"axes": list(mesh.mesh_dim_names), "ranks": mesh.mesh.tolist()})

        out = {}
        tile = stage_mesh("tile_encoder", ranks=[0, 1], device_type="cpu")
        slide = stage_mesh("slide_encoder", ranks=[2, 3], device_type="cpu")
        out["tile_mesh"], out["slide_mesh"] = np.array(desc(tile)), np.array(desc(slide))
        out["refusal_unknown_axis"] = np.array(_refusal(
            lambda: stage_mesh("tile_encoder", ranks=[0, 1], axis_sizes={"seq": 2}, device_type="cpu")))
        head = get_model(**STAGE_HEAD, device="cpu")
        full = stage_mesh("slide_encoder", axis_sizes={"seq": 2, "model": 2}, device_type="cpu")
        one = stage_mesh("slide_encoder", ranks=[0], device_type="cpu")
        out["full_mesh"], out["one_mesh"] = np.array(desc(full)), np.array(desc(one))
        for label, mesh in (("full", full), ("one", one)):
            placements = stage_param_shardings("slide_encoder", head, mesh)
            out[f"{label}_placements"] = np.array(json.dumps({k: [repr(p) for p in v]
                                                              for k, v in placements.items()}))
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
        dist.destroy_process_group()
    except Exception:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


# what the forkserver imports for the ranks besides the port's own
# preload (``dryrun.RANK_PRELOAD``)
PRELOAD = ["torch_rank_bodies", "gigapath_tpu_torch.ops.dilated_attention", "torch.distributed.tensor"]


def start_ranks(target, world: int, workdir: str):
    """Start ``world`` processes of ``target(rank, workdir)``; returns them
    (``dryrun.start_ranks``: forked from a forkserver, a fresh interpreter
    that inherits no thread of the test process, JAX's among them, and
    imports the port once)."""
    from gigapath_tpu_torch import dryrun

    return dryrun.start_ranks(target, world, workdir, preload=PRELOAD)


def join_ranks(procs, workdir: str, timeout: float = 120.0) -> list:
    """Wait for the ranks (``dryrun.join_ranks``: any still running are
    killed ``timeout`` seconds from now, or as soon as one rank has failed,
    and the call raises with the ranks' tracebacks) and return each rank's
    results."""
    from gigapath_tpu_torch import dryrun

    dryrun.join_ranks(procs, workdir, timeout)
    return [dict(np.load(os.path.join(workdir, f"rank{r}.npz"))) for r in range(len(procs))]
