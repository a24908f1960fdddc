"""The port's disaggregated two-stage pipeline (``gigapath_tpu_torch/dist``)
against the JAX package's (``gigapath_tpu/dist``) on the CPU.

- the boundary protocol (chunk digests, the chunk plan, the memory and
  directory channels, the assembler, leases and reassignment): one scenario
  per class run on both packages, outputs and run-log events compared;
- the per-stage sharding rules over the port's ``state_dict`` names against
  the JAX rules on the flax paths, with the torch transpose applied;
- the two worker encoders: the numpy dryrun bit for bit, the quantized ViT
  on the JAX package's weights at 1e-5;
- one two-worker fleet of real processes (dryrun encoder, tiny consumer on
  ``device="cpu"``): the clean run and ``kill_worker@K`` bit-equal, the
  dense embedding against the JAX consumer's forward on the same weights
  and the same assembled sequence, the streaming consumer against the dense
  one, and a SIGKILLed consumer's checkpoint resume bit-exact.
"""

import glob
import json
import os
import types

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)

import gigapath_tpu.dist.boundary as jax_boundary
import gigapath_tpu.dist.membership as jax_membership
import gigapath_tpu.obs.runlog as jax_runlog
import gigapath_tpu.resilience.chaos as jax_chaos
import gigapath_tpu_torch.dist.boundary as port_boundary
import gigapath_tpu_torch.dist.membership as port_membership
import gigapath_tpu_torch.obs.runlog as port_runlog
import gigapath_tpu_torch.resilience.chaos as port_chaos

FLAVORS = {
    "jax": types.SimpleNamespace(b=jax_boundary, m=jax_membership, log=jax_runlog, chaos=jax_chaos),
    "port": types.SimpleNamespace(b=port_boundary, m=port_membership, log=port_runlog, chaos=port_chaos),
}
# run-log fields that differ between any two runs (stamps, ids, measured
# seconds), dropped before comparing
VOLATILE = {"v", "run", "t", "blocked_s", "offset_s", "rtt_s", "uncertainty_s", "t_send",
            "t_recv", "t_reply", "t_ack", "wall_s", "expired_by_s", "sample_offset_s"}


def _chunk(ns, cid, start, stop, dim=4, coords=True, **kw):
    rng = np.random.default_rng([3, cid])
    payload = rng.standard_normal((stop - start, dim), dtype=np.float32)
    xy = rng.uniform(0, 100, (stop - start, 2)).astype(np.float32) if coords else None
    return ns.b.EmbeddingChunk.build("s0", cid, start, stop, payload, coords=xy, **kw)


def _normalize(value, root):
    if isinstance(value, dict):
        return {k: _normalize(v, root) for k, v in sorted(value.items()) if k not in VOLATILE}
    if isinstance(value, (list, tuple)):
        return [_normalize(v, root) for v in value]
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, str):
        return value.replace(root, "<root>")
    return value


def _events(path):
    with open(path, encoding="utf-8") as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _scenario_digest(ns, root, log):
    chunks = [_chunk(ns, 0, 0, 4), _chunk(ns, 1, 4, 7, coords=False), _chunk(ns, 2, 7, 9, digest=False)]
    tampered = _chunk(ns, 3, 9, 12)
    tampered.payload[0, 0] += 1.0
    return {"checksums": [c.checksum for c in chunks],
            "verify": [c.verify() for c in chunks + [tampered]],
            "direct": ns.b.chunk_checksum("s1", 5, 0, 2, np.ones((2, 3), np.float32), None)}


def _scenario_plan(ns, root, log):
    out = {"plans": [ns.b.plan_chunks(n, c) for n, c in ((1, 4), (16, 8), (41, 8), (5, 16))],
           "assign": [ns.b.assign_chunks(list(range(n)), w)
                      for n, w in ((8, ["w1", "w0"]), (5, ["c", "a", "b"]), (3, ["w0"]))]}
    errors = []
    for call in (lambda: ns.b.plan_chunks(0, 4), lambda: ns.b.assign_chunks([1], [])):
        try:
            call()
        except ValueError:
            errors.append("ValueError")
    out["errors"] = errors
    return out


def _scenario_memory(ns, root, log):
    channel = ns.b.MemoryChannel(ns.b.BoundaryConfig(capacity=2, poll_s=0.005), runlog=log, name="mem")
    channel.send(_chunk(ns, 0, 0, 4))
    channel.send(_chunk(ns, 1, 4, 8))
    timeouts = 0
    for _ in range(2):  # one blocking episode, retried: one event
        try:
            channel.send(_chunk(ns, 2, 8, 12), timeout=0.02)
        except TimeoutError:
            timeouts += 1
    first = channel.recv(timeout=1)
    channel.ack(first.seq)
    channel.send(_chunk(ns, 2, 8, 12))
    got = [first.seq]
    while True:
        chunk = channel.recv(timeout=0.05)
        if chunk is None:
            break
        got.append(chunk.seq)
        channel.ack(chunk.seq)
    # a duplicate of a delivered seq is dropped by dedup
    channel.send(_chunk(ns, 0, 0, 4))
    dup = channel.recv(timeout=0.05)
    channel.close()
    return {"timeouts": timeouts, "got": got, "dup": dup, "unacked": channel.unacked_seqs(),
            "stats": channel.stats.as_dict()}


def _scenario_dir(ns, root, log):
    cfg = ns.b.BoundaryConfig(capacity=4, poll_s=0.005, retransmit_s=0.5)
    chaos = ns.chaos.ChaosInjector("drop_chunk@1,dup_chunk@2")
    producer = ns.b.DirChannelProducer(root, cfg, producer="w0", runlog=log, chaos=chaos)
    consumer = ns.b.DirChannelConsumer(root, cfg, runlog=log)
    for cid in range(3):
        producer.send(_chunk(ns, cid, 4 * cid, 4 * cid + 4))
    first = []
    while True:
        chunk = consumer.recv(timeout=0.05)
        if chunk is None:
            break
        first.append(chunk.seq)
        consumer.ack(chunk.seq)
    resent = producer.pump_retransmits(now=1e12)  # the dropped seq 1 is re-sent
    second = []
    while True:
        chunk = consumer.recv(timeout=0.05)
        if chunk is None:
            break
        second.append((chunk.seq, chunk.payload, chunk.coords))
        consumer.ack(chunk.seq)
    producer.pump_retransmits(now=2e12)  # every seq acked: nothing to re-send
    return {"first": sorted(first), "resent": resent, "second": second,
            "credits": producer.credits(), "unacked": producer.unacked_seqs(),
            "producer": producer.stats.as_dict(), "consumer": consumer.stats.as_dict()}


def _scenario_assembler(ns, root, log):
    asm = ns.b.SlideAssembler(10, 4)
    asm.expect([0, 1, 2])
    added = [asm.add(c) for c in (_chunk(ns, 2, 8, 10), _chunk(ns, 0, 0, 4), _chunk(ns, 2, 8, 10))]
    mid = {"missing": asm.missing(), "complete": asm.complete()}
    added.append(asm.add(_chunk(ns, 1, 4, 8)))
    tracker = ns.b.ChunkTracker()
    tracker.expect([0, 1, 2, 3])
    tracker.seed_received([1, 3])
    return {"added": added, "mid": mid, "complete": asm.complete(), "embeds": asm.embeds,
            "coords": asm.coords, "tracker": [tracker.missing(), sorted(tracker.received)]}


def _scenario_leases(ns, root, log):
    leases = {w: ns.m.WorkerLease(root, w, stage="tile", lease_s=1.0) for w in ("w0", "w1", "w2")}
    for lease in leases.values():
        lease.register(now=100.0)
    leases["w1"].renew(now=100.9)
    leases["w2"].retire()
    membership = ns.m.Membership(root, runlog=log)
    alive = membership.alive(now=100.5)
    lost = membership.poll_lost(now=101.5)
    again = membership.poll_lost(now=101.6)
    direct = [membership.report_lost("w1", reason="process_exit", exit_code=-9),
              membership.report_lost("w1")]
    path = ns.m.write_reassignment(root, lost_worker="w0", assignments={"w1": [3, 1]}, runlog=log)
    seen = set()
    return {"alive": alive, "lost": lost, "again": again, "direct": direct,
            "members": membership.lost(), "path": os.path.basename(path),
            "reassigned": [ns.m.reassignments_for(root, "w1", seen), ns.m.reassignments_for(root, "w1", seen)],
            "lease": ns.m.read_lease(root, "w1")}


SCENARIOS = {
    "digest": _scenario_digest,
    "plan_assign": _scenario_plan,
    "memory_channel": _scenario_memory,
    "dir_channel": _scenario_dir,
    "assembler": _scenario_assembler,
    "leases": _scenario_leases,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_protocol_matches_jax(name, tmp_path):
    """The same scenario on both packages gives the same outputs and the
    same run-log events (stamps and measured seconds aside)."""
    results = {}
    for flavor, ns in FLAVORS.items():
        root = str(tmp_path / flavor)
        os.makedirs(root)
        log = ns.log.RunLog(os.path.join(root, "obs", "run.jsonl"), driver="dist-test", echo=False)
        out = SCENARIOS[name](ns, root, log)
        log.close()
        events = [ev for ev in _events(log.path) if ev["kind"] != "metrics"]
        results[flavor] = _normalize({"out": out, "events": events}, root)
    assert results["port"] == results["jax"]
    if name in ("memory_channel", "leases"):
        assert results["port"]["events"], "the scenario emits events"


# ---------------------------------------------------------------------------
# the sharding rules
# ---------------------------------------------------------------------------

def _flax_named_specs(rules, params):
    """The JAX rules on the flax tree: ``{flax path: spec over the flax
    axes, padded to the rank}``."""
    import jax

    from gigapath_tpu.dist.stagemesh import match_partition_rules

    specs = match_partition_rules(rules, params)
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    spec_flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    for (path, leaf), (_, spec) in zip(flat, spec_flat):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        out[name] = (tuple(spec) + (None,) * leaf.ndim)[:leaf.ndim] if len(spec) else ()
    return out


def _flax_to_torch_name(name: str) -> str:
    """A flax param path as its ``state_dict`` name (utils/convert.py's
    renaming)."""
    import re

    parts = name.split("/")
    if parts[-1] in ("kernel", "scale"):
        parts[-1] = "weight"
    return re.sub(r"\b(layers|blocks)_(\d+)\b", r"\1.\2", ".".join(parts))


HEAD_KW = dict(input_dim=8, latent_dim=32, feat_layer="1", n_classes=2, model_arch="gigapath_slide_enc_tiny")


@pytest.fixture(scope="module")
def jax_head():
    """The JAX package's tiny consumer head and its params (built once,
    through one jitted init: the eager trace takes several times longer)."""
    import jax
    import jax.numpy as jnp

    from gigapath_tpu.models.classification_head import ClassificationHead

    model = ClassificationHead(dtype=None, **HEAD_KW)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4, 8)), jnp.zeros((1, 4, 2)))
    return model, params["params"]


@pytest.mark.parametrize("stage,arch", [("slide_encoder", "gigapath_slide_enc_tiny"),
                                        ("tile_encoder", "vit_tile_enc_test")])
def test_partition_rules_match_jax_with_the_torch_transpose(stage, arch, jax_head):
    import jax

    from gigapath_tpu.dist.stagemesh import get_stage as jax_get_stage
    from gigapath_tpu_torch.dist.stagemesh import match_partition_rules, place_stage, stage_param_specs

    if stage == "slide_encoder":
        from gigapath_tpu_torch.models.classification_head import get_model

        params = jax_head[1]
        module = get_model(device="cpu", **HEAD_KW)
    else:
        import gigapath_tpu.models.tile_encoder as jax_tile
        import gigapath_tpu_torch.models.tile_encoder  # noqa: F401
        from gigapath_tpu.utils.registry import create_model_from_registry as jax_create
        from gigapath_tpu_torch.utils.registry import create_model_from_registry

        tile = jax_create(arch)
        params = jax.eval_shape(lambda: jax_tile.init_params(tile))
        module = create_model_from_registry(arch)
    expected = {}
    for name, spec in _flax_named_specs(jax_get_stage(stage).rules, params).items():
        if name.endswith("/kernel") and spec:  # the torch weight's axis order
            perm = (1, 0) if len(spec) == 2 else (3, 2, 0, 1)
            spec = tuple(spec[j] for j in perm)
        expected[_flax_to_torch_name(name)] = spec
    got = stage_param_specs(stage, module)
    assert set(got) == set(expected)
    for name, spec in got.items():
        ndim = module.state_dict()[name].ndim
        padded = (tuple(spec) + (None,) * ndim)[:ndim] if spec else ()
        assert padded == expected[name], name
    assert any(spec and spec[0] == "model" for spec in got.values())  # a column-parallel weight
    # an uncovered param still raises; one device places, more refuse
    with pytest.raises(ValueError, match="no partition rule"):
        match_partition_rules([(r"\.bias$", ())], module)
    assert place_stage(stage, module, ["cpu"]) is module
    with pytest.raises(NotImplementedError, match="a stage runs on one device"):
        place_stage(stage, module, ["cpu", "cpu"])


# ---------------------------------------------------------------------------
# the worker encoders
# ---------------------------------------------------------------------------

def _plan(**kw):
    from gigapath_tpu_torch.dist.pipeline import default_plan

    base = dict(n_tiles=40, chunk_tiles=8, lease_s=1.5, credits=4, retransmit_s=0.5)
    base.update(kw)
    return default_plan(**base)


def test_dryrun_encoder_is_bit_equal_to_jax():
    from gigapath_tpu.dist import worker as jax_worker
    from gigapath_tpu_torch.dist import worker

    plan = _plan(n_tiles=41)
    assert np.array_equal(worker.encoder_weights(plan), jax_worker.encoder_weights(plan))
    ours, theirs = worker.make_encoder(plan), jax_worker.make_encoder(plan)
    for start, stop in ((0, 8), (32, 40), (40, 41)):
        for a, b in zip(ours(start, stop), theirs(start, stop)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(worker.chunk_images(plan, 8, 16), jax_worker.chunk_images(plan, 8, 16)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="unknown plan encoder"):
        worker.make_encoder(dict(plan, encoder="quantvit"))


def test_quant_vit_chunks_match_jax_on_bridged_weights(monkeypatch):
    """The quantized ViT arm (``int8+attn``, the kernels' plain versions on
    the CPU) on the JAX worker's own weights, at 1e-5 and on the bf16
    grid; the seeded arm re-encodes a ragged tail to the same bits."""
    import gigapath_tpu.models.tile_encoder as jax_tile
    from gigapath_tpu.dist import worker as jax_worker
    from gigapath_tpu_torch.dist import worker
    from gigapath_tpu_torch.utils.convert import state_dict_from_flax_params

    # the JAX worker's weights, as its make_encoder draws them (through a
    # jitted init: the eager one traces the interpret-mode kernels for
    # many seconds)
    import jax

    drawn = []

    def init_params(model, rng):
        x = jax.numpy.zeros((1, model.img_size, model.img_size, 3), jax.numpy.float32)
        drawn.append(jax.jit(model.init)(rng, x)["params"])
        return drawn[-1]

    monkeypatch.setattr(jax_tile, "init_params", init_params)
    plan = _plan(n_tiles=8, dim_in=16, dim_out=8, encoder="quant_vit", quant="int8+attn")
    theirs = jax_worker.make_encoder(plan)
    ours = worker.make_encoder(plan, device="cpu", state_dict=state_dict_from_flax_params(drawn[0]))
    (a, ca), (b, cb) = ours(0, 8), theirs(0, 8)
    assert a.shape == (8, 8) and np.array_equal(ca, cb)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert np.array_equal(a, torch.as_tensor(a).to(torch.bfloat16).float().numpy())
    # the seeded arm, with a ragged tail chunk: re-encoding gives the same bits
    seeded = worker.make_encoder(dict(plan, n_tiles=12), device="cpu")
    tail = seeded(8, 12)[0]
    assert tail.shape == (4, 8) and np.isfinite(tail).all() and np.array_equal(tail, seeded(8, 12)[0])


# ---------------------------------------------------------------------------
# one fleet of real processes
# ---------------------------------------------------------------------------

def _run_events(root):
    events = []
    for path in glob.glob(os.path.join(str(root), "obs", "*.jsonl")):
        if os.path.basename(path).startswith("flight-"):
            continue
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    continue  # a SIGKILLed process can die mid-line
    return events


def _of(events, kind, **match):
    return [ev for ev in events if ev.get("kind") == kind and all(ev.get(k) == v for k, v in match.items())]


@pytest.fixture(scope="module")
def bridged(jax_head):
    """The JAX tiny consumer head's params, and builders of the port's
    dense and streaming slide stage on those same weights."""
    from gigapath_tpu_torch.dist.pipeline import _default_forward
    from gigapath_tpu_torch.models.classification_head import get_model
    from gigapath_tpu_torch.models.streaming_encoder import StreamingEncoderSession
    from gigapath_tpu_torch.serve.streaming import streaming_head_logits
    from gigapath_tpu_torch.utils.convert import state_dict_from_flax_params

    jax_model, params = jax_head
    head = get_model(device="cpu", **HEAD_KW)
    head.load_state_dict(state_dict_from_flax_params(params))
    head.eval()
    forward = _default_forward("cpu")(8)[0]

    def dense_builder(dim_in):
        return forward, head

    def streaming_builder(dim_in):
        def open_session(n_tiles, chunk_tiles, runlog=None):
            return StreamingEncoderSession(head.slide_encoder, n_tiles, chunk_tiles=chunk_tiles,
                                           all_layer_embed=True)
        return open_session, lambda embeds: streaming_head_logits(head, embeds)[0]

    return types.SimpleNamespace(jax_model=jax_model, params=params, dense=dense_builder,
                                 streaming=streaming_builder)


@pytest.fixture(scope="module")
def clean_run(tmp_path_factory, bridged):
    from gigapath_tpu_torch.dist.pipeline import run_disaggregated

    root = tmp_path_factory.mktemp("clean")
    result = run_disaggregated(str(root), plan=_plan(), deadline_s=60, device="cpu",
                               forward_builder=bridged.dense)
    return result


def test_clean_run_matches_the_jax_consumer(clean_run, bridged):
    from gigapath_tpu.dist.worker import encode_chunk, encoder_weights

    plan = _plan()
    assert clean_run["lost"] == [] and clean_run["reassignments"] == 0
    assert all(rc == 0 for rc in clean_run["worker_exit_codes"].values())
    weights = encoder_weights(plan)
    expected = np.concatenate([encode_chunk(plan, weights, a, a + 8)[0] for a in range(0, 40, 8)])
    assert np.array_equal(clean_run["assembled"], expected)
    import jax

    apply = jax.jit(lambda p, x, c: bridged.jax_model.apply({"params": p}, x, c, deterministic=True))
    logits = np.asarray(apply(bridged.params, clean_run["assembled"][None], clean_run["coords"][None]),
                        np.float32)[0]
    np.testing.assert_allclose(clean_run["embedding"], logits, rtol=0, atol=1e-5)


def test_killed_worker_run_is_bit_equal(clean_run, bridged, tmp_path):
    from gigapath_tpu_torch.dist.pipeline import run_disaggregated

    chaos = run_disaggregated(str(tmp_path), plan=_plan(), worker_chaos={"w0": "kill_worker@1"},
                              deadline_s=60, device="cpu", forward_builder=bridged.dense)
    assert chaos["worker_exit_codes"] == {"w0": -9, "w1": 0}
    assert chaos["lost"] == ["w0"] and chaos["reassignments"] >= 1
    np.testing.assert_array_equal(chaos["assembled"], clean_run["assembled"])
    np.testing.assert_array_equal(chaos["embedding"], clean_run["embedding"])
    events = _run_events(tmp_path)
    assert _of(events, "worker_lost", worker="w0")
    reassigns = _of(events, "recovery", action="reassign")
    assert reassigns and reassigns[0]["worker"] == "w0"
    assert not [ev for ev in _of(events, "compile") if ev.get("unexpected")]


def test_streaming_consumer_matches_dense(clean_run, bridged, tmp_path):
    from gigapath_tpu_torch.dist.pipeline import run_disaggregated

    stream = run_disaggregated(str(tmp_path), plan=_plan(chunked_prefill=True, transport="tcp"),
                               deadline_s=60, device="cpu", streaming_builder=bridged.streaming)
    assert stream["streaming"] and stream["assembled"] is None
    np.testing.assert_allclose(stream["embedding"], clean_run["embedding"], rtol=0, atol=1e-5)
    events = _run_events(tmp_path)
    assert _of(events, "stream_open") and _of(events, "stream_finalize")


def test_killed_consumer_resumes_bit_exact(tmp_path):
    """The consumer in its own process (streaming fold, TCP, checkpoint
    every 2 chunks) is SIGKILLed after 3 chunks; its restart resumes from
    the checkpoint watermark and ends bit-equal to an uninterrupted fold of
    the same chunks by the same default slide stage."""
    from gigapath_tpu_torch.dist.boundary import plan_chunks
    from gigapath_tpu_torch.dist.pipeline import _default_streaming_forward, run_disaggregated
    from gigapath_tpu_torch.dist.worker import encode_chunk, encoder_weights

    plan = _plan(lease_s=2.0, chunked_prefill=True, transport="tcp", consumer_ckpt_every=2)
    chaos = run_disaggregated(str(tmp_path / "kill"), plan=plan, consumer_chaos="kill_consumer@3",
                              deadline_s=60, device="cpu")
    assert chaos["consumer_exit_codes"][0] == -9 and chaos["consumer_exit_codes"][-1] == 0
    open_session, head = _default_streaming_forward("cpu")(plan["dim_out"])
    session = open_session(plan["n_tiles"], plan["chunk_tiles"])
    weights = encoder_weights(plan)
    for cid, start, stop in plan_chunks(plan["n_tiles"], plan["chunk_tiles"]):
        session.feed(cid, *encode_chunk(plan, weights, start, stop))
    np.testing.assert_array_equal(np.asarray(head(session.finalize()), np.float32), chaos["embedding"])
    events = _run_events(tmp_path / "kill")
    lost = _of(events, "consumer_lost")
    assert lost and lost[0]["reason"] == "checkpoint_found"
    resumes = _of(events, "recovery", action="consumer_resume")
    assert resumes and resumes[0]["chunks"] >= 1
    assert len(glob.glob(str(tmp_path / "kill" / "consumer-ckpt" / "ckpt-*"))) <= 2  # keep=2


# ---------------------------------------------------------------------------
# the stage meshes (one gloo group of four CPU ranks)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stage_ranks(tmp_path_factory):
    """Every rank's results of ``torch_rank_bodies.stagemesh_rank``."""
    import torch_rank_bodies as rb

    work = str(tmp_path_factory.mktemp("stagemesh"))
    return rb.join_ranks(rb.start_ranks(rb.stagemesh_rank, rb.STAGE_WORLD, work), work)


def test_stage_mesh_axes_and_disjoint_ranks(stage_ranks):
    """Each stage's mesh carries its registry axes on the ranks it was
    given (the JAX ``devices=`` slice), the two stages' ranks disjoint; an
    axis the stage lacks is refused."""
    for res in stage_ranks:
        tile, slide = json.loads(str(res["tile_mesh"])), json.loads(str(res["slide_mesh"]))
        assert tile["axes"] == ["data", "model"] and slide["axes"] == ["data", "seq", "model"]
        tile_ranks, slide_ranks = set(np.ravel(tile["ranks"])), set(np.ravel(slide["ranks"]))
        assert tile_ranks == {0, 1} and slide_ranks == {2, 3} and tile_ranks.isdisjoint(slide_ranks)
        assert json.loads(str(res["full_mesh"])) == {"axes": ["seq", "model"], "ranks": [[0, 1], [2, 3]]}
        assert str(res["refusal_unknown_axis"]) == "ValueError"


def test_stage_param_shardings_cover_the_slide_encoder(stage_ranks):
    """Every parameter of the tiny slide encoder gets one placement per mesh
    dim, at least one weight ``Shard``ed over ``model`` and none over
    ``seq`` (the rules name no seq axis)."""
    head = __import__("torch_rank_bodies").STAGE_HEAD
    from gigapath_tpu_torch.models.classification_head import get_model

    names = set(get_model(**head, device="cpu").state_dict())
    for res in stage_ranks:
        placements = json.loads(str(res["full_placements"]))
        assert set(placements) == names
        assert all(len(p) == 2 and p[0] == "Replicate()" for p in placements.values())
        sharded = [n for n, p in placements.items() if p[1].startswith("Shard")]
        assert sharded and all(n.endswith(".weight") for n in sharded)


def test_stage_param_shardings_degrade_on_one_rank(stage_ranks):
    """A one-rank mesh has no live axis: every placement degrades to
    ``Replicate``."""
    for res in stage_ranks:
        assert json.loads(str(res["one_mesh"]))["axes"] == ["data", "seq", "model"]
        placements = json.loads(str(res["one_placements"]))
        assert placements and all(p == ["Replicate()"] * 3 for p in placements.values())


def _jax_placements(mesh, params):
    """The JAX package's ``stage_param_shardings`` on the flax tree, each
    spec moved to the torch weight's axis order and read as one placement
    per mesh axis: ``{state_dict name: [placement repr]}``."""
    import jax

    from gigapath_tpu.dist.stagemesh import stage_param_shardings as jax_shardings

    shardings = jax_shardings("slide_encoder", params, mesh)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    sh_flat = jax.tree_util.tree_flatten_with_path(
        shardings, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    out = {}
    for (path, leaf), (_, sharding) in zip(flat, sh_flat):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        spec = (tuple(sharding.spec) + (None,) * leaf.ndim)[:leaf.ndim]
        if name.endswith("/kernel"):  # the torch weight's axis order
            spec = tuple(spec[j] for j in ((1, 0) if leaf.ndim == 2 else (3, 2, 0, 1)))
        placements = []
        for axis in mesh.axis_names:
            dims = [i for i, e in enumerate(spec) if e == axis or (isinstance(e, tuple) and axis in e)]
            placements.append(f"Shard(dim={dims[0]})" if dims else "Replicate()")
        out[_flax_to_torch_name(name)] = placements
    return out


@pytest.mark.parametrize("label", ["full", "one"])
def test_stage_param_shardings_match_jax(label, stage_ranks, jax_head):
    """The port's placements on each rank are the JAX package's shardings
    of the same head, moved to the torch layout: at {seq: 2, model: 2} on
    four devices, and degraded on one."""
    import jax

    from gigapath_tpu.dist.stagemesh import stage_mesh as jax_stage_mesh

    if label == "full":
        mesh = jax_stage_mesh("slide_encoder", devices=jax.devices()[:4], axis_sizes={"seq": 2, "model": 2})
    else:
        mesh = jax_stage_mesh("slide_encoder", devices=jax.devices()[:1])
    expected = _jax_placements(mesh, jax_head[1])
    assert any(p != ["Replicate()"] * len(p) for p in expected.values()) == (label == "full")
    for res in stage_ranks:
        assert json.loads(str(res[f"{label}_mesh"]))["axes"] == list(mesh.axis_names)
        assert json.loads(str(res[f"{label}_placements"])) == expected
