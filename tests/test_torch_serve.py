"""The port's serving stack held against the JAX package's on the CPU.

The host-side modules (bucket ladder, batch assembly, request queue,
content-hash cache, circuit breaker) give the same rungs, arrays, dispatch
order, evictions and states as the JAX modules; the port's
``SlideService`` serves the tiny fp32 head with the JAX fixture's weights
to the JAX ``SlideService``'s logits and counts; the bucketed CLI path
writes the exact path's verdicts; and the attention's per-row valid-length
path, which a CUDA-graph capture takes, equals the eager arm.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)

from gigapath_tpu_torch import serve as port_serve
from gigapath_tpu.serve import buckets as jax_buckets
from gigapath_tpu.serve import cache as jax_cache
from gigapath_tpu.serve import health as jax_health
from gigapath_tpu.serve import queue as jax_queue
from gigapath_tpu_torch.serve import buckets as port_buckets
from gigapath_tpu_torch.serve import cache as port_cache
from gigapath_tpu_torch.serve import health as port_health
from gigapath_tpu_torch.serve import queue as port_queue

LENGTHS = [1, 5, 16, 17, 31, 32]


# ---------------------------------------------------------------------------
# host-side modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(n_min=16, growth=2.0, n_max=64, align=16),
    dict(n_min=1024, growth=2.0, n_max=1 << 20),
    dict(n_min=1000, growth=1.5, n_max=50000, align=128),
    dict(n_min=10240, growth=2.0, n_max=1 << 20),
])
def test_bucket_ladder_matches_jax(kw):
    jl, pl = jax_buckets.BucketLadder(**kw), port_buckets.BucketLadder(**kw)
    assert pl.rungs == jl.rungs and len(pl) == len(jl)
    for n in sorted({1, 2, kw["n_min"] - 1, kw["n_min"], kw["n_min"] + 1, *jl.rungs,
                     *(r + 1 for r in jl.rungs[:-1]), jl.rungs[-1] // 3}):
        if 1 <= n <= jl.rungs[-1]:
            assert pl.bucket_for(n) == jl.bucket_for(n)
    for bad in (0, jl.rungs[-1] + 1):
        with pytest.raises(ValueError):
            pl.bucket_for(bad)


@pytest.mark.parametrize("capacity", [1, 3])
def test_assemble_batch_and_pad_slide_bit_equal_to_jax(capacity):
    rng = np.random.default_rng(capacity)
    slides = [(rng.normal(size=(n, 8)).astype(np.float32),
               None if n == 7 else rng.uniform(0, 1e4, (n, 2)).astype(np.float32))
              for n in (3, 7, 16)[:capacity]]
    for got, want in zip(port_buckets.assemble_batch(slides, 16, capacity, feature_dim=8),
                         jax_buckets.assemble_batch(slides, 16, capacity, feature_dim=8)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    for got, want in zip(port_buckets.pad_slide(*slides[0], 16), jax_buckets.pad_slide(*slides[0], 16)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        port_buckets.assemble_batch(slides * 2, 16, capacity)


def _queue_trace(queue_mod):
    """A fixed arrival schedule through the coalescer; the batches popped,
    as (time, [slide ids]), with per-bucket capacities."""
    q = queue_mod.RequestQueue(max_batch=3, max_wait_s=0.05,
                               capacity_for=lambda b: 1 if b >= 64 else 3)
    arrivals = [("a", 16, 0.0), ("b", 32, 0.001), ("c", 16, 0.002), ("d", 64, 0.003), ("e", 16, 0.004),
                ("f", 32, 0.03), ("g", 16, 0.031), ("h", 32, 0.2)]
    out, i = [], 0
    for now in np.arange(0.0, 0.4, 0.005):
        while i < len(arrivals) and arrivals[i][2] <= now:
            sid, b, t = arrivals[i]
            q.submit(queue_mod.SlideRequest(sid, np.zeros((4, 2), np.float32), None, bucket_n=b, t_submit=t))
            i += 1
        batch = q.pop_ready(now=float(now))
        if batch:
            out.append((round(float(now), 3), [r.slide_id for r in batch]))
    rest = q.pop_ready(now=1.0, drain=True)
    out.append(("drain", [r.slide_id for r in rest]))
    return out


def test_queue_dispatch_order_matches_jax():
    assert _queue_trace(port_queue) == _queue_trace(jax_queue)


def test_cache_keys_and_eviction_order_match_jax():
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(5, 4)).astype(np.float32)
    coords = rng.uniform(0, 10, (5, 2)).astype(np.float32)
    for extra in ("", "model-a"):
        assert port_cache.content_key(feats, coords, extra=extra) == jax_cache.content_key(feats, coords, extra=extra)
    assert port_cache.content_key(feats, None) == jax_cache.content_key(feats, None)
    caches = {"jax": jax_cache.EmbeddingCache(budget_bytes=400), "port": port_cache.EmbeddingCache(budget_bytes=400)}
    seen = {}
    for side, cache in caches.items():
        log = []
        for i, op in enumerate("ppgpppgpgpPp"):
            key = f"k{i % 5}"
            if op == "g":
                log.append(("get", key, cache.get(key) is not None))
            else:
                log.append(("put", key, cache.put(key, np.zeros(10 if op == "p" else 100, np.float64))))
            log.append(list(cache._entries))  # LRU order, oldest first
        seen[side] = (log, cache.stats())
    assert seen["port"] == seen["jax"]


def test_circuit_breaker_states_match_jax():
    seen = {}
    for side, mod in (("jax", jax_health), ("port", port_health)):
        br = mod.CircuitBreaker(failures=2, cooldown_s=10.0)
        log = []
        for now, event in [(0, "admit"), (1, "fail"), (2, "fail"), (3, "admit"), (12, "admit"), (12, "fail"),
                           (13, "admit"), (23, "admit"), (23, "ok"), (24, "admit"), (25, "fail"), (26, "ok")]:
            if event == "admit":
                log.append(("admit", br.admit(1024, now=float(now)), br.state(1024)))
            elif event == "fail":
                log.append(("fail", br.record_failure(1024, now=float(now)), br.state(1024)))
            else:
                log.append(("ok", br.record_success(1024), br.state(1024)))
        seen[side] = (log, br.trips, br.state(2048))
    assert seen["port"] == seen["jax"]


# ---------------------------------------------------------------------------
# the service end to end, on the JAX fixture's tiny fp32 head
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def heads(serve_tiny_model):
    """(jax model, jax params, port head with the same weights)."""
    from gigapath_tpu_torch.models.classification_head import ClassificationHead
    from gigapath_tpu_torch.utils.convert import state_dict_from_flax_params

    model, params = serve_tiny_model
    head = ClassificationHead(input_dim=16, latent_dim=32, feat_layer="1", n_classes=2,
                              model_arch="gigapath_slide_enc_tiny")
    head.load_state_dict(state_dict_from_flax_params(params), strict=True)
    return model, params, head.eval()


def _jax_forward(model):
    def forward(p, embeds, coords, pad_mask):
        return model.apply({"params": p}, embeds, coords, pad_mask=pad_mask, deterministic=True)

    return forward


def _port_forward(m, embeds, coords, pad_mask):
    return m(embeds, coords, pad_mask=pad_mask)


def _config(mod, **overrides):
    base = dict(max_batch=3, max_wait_s=0.01, bucket_min=16, bucket_growth=2.0, bucket_max=64,
                bucket_align=16, feature_dim=16, artifact_dir=None)
    base.update(overrides)
    return mod.ServeConfig(**base)


def _slides(seed, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    return [(f"s{i}_n{n}", rng.normal(size=(n, 16)).astype(np.float32),
             rng.uniform(0, 25000, (n, 2)).astype(np.float32)) for i, n in enumerate(lengths)]


def _exact_port(head, feats, coords):
    with torch.no_grad():
        return head(torch.from_numpy(feats[None]), torch.from_numpy(coords[None])).numpy()[0]


def test_service_matches_jax_service_and_exact_path(heads, tmp_path, monkeypatch):
    from gigapath_tpu import serve as jax_serve

    monkeypatch.delenv("GIGAPATH_OBS", raising=False)
    model, params, head = heads
    slides = _slides(11)
    results, stats = {}, {}
    for side, mod, forward, p in (("jax", jax_serve, _jax_forward(model), params),
                                  ("port", port_serve, _port_forward, head)):
        service = mod.SlideService(forward, p, config=_config(mod), out_dir=str(tmp_path / side),
                                   identity="tiny")
        futs = [service.submit(*s) for s in slides]
        service.drain()
        futs.append(service.submit("dup", slides[1][1], slides[1][2]))  # served from the cache
        service.drain()
        results[side] = [np.asarray(f.result(timeout=60), np.float32) for f in futs]
        st = service.stats()
        stats[side] = {k: st[k] for k in ("dispatches", "slides_served", "inflight_joins", "buckets_used",
                                          "per_bucket_dispatches", "compiled_executables",
                                          "loaded_executables", "unexpected_retraces")}
        stats[side]["cache_hits"] = st["cache"]["hits"]
        assert set(service.aot.sources) == {(3, 16), (3, 32)}
        service.close()
    assert stats["port"] == stats["jax"]
    assert stats["port"]["cache_hits"] == 1 and stats["port"]["compiled_executables"] == 2
    for (sid, feats, coords), got, want in zip(slides + [slides[1]], results["port"], results["jax"]):
        assert got.shape == (2,)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=sid)
        np.testing.assert_allclose(got, _exact_port(head, feats, coords), atol=1e-5, rtol=0, err_msg=sid)
    assert not results["port"][-1].flags.writeable  # the cached row is shared read-only


def test_service_logits_do_not_depend_on_batch_row(heads):
    from gigapath_tpu_torch.serve.aot import AotExecutableCache

    _, _, head = heads
    (_, a, ca), (_, b, cb) = _slides(12, [7, 12])
    aot = AotExecutableCache(_port_forward, head, feature_dim=16)
    alone = aot(*port_buckets.assemble_batch([(a, ca)], 16, capacity=3)).numpy()
    together = aot(*port_buckets.assemble_batch([(b, cb), (b, cb), (a, ca)], 16, capacity=3)).numpy()
    np.testing.assert_allclose(together[2], alone[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(together[0], together[1], atol=1e-6, rtol=0)
    assert np.isfinite(alone).all()  # the two dummy rows too
    assert aot.sources == {(3, 16): "eager"} and aot.compiled_count == 1 and aot.loaded_count == 0


def test_service_close_releases_the_executables(heads, tmp_path):
    """Closing the service drops every executable (on the card: the graphs
    and their memory) at once, keeps the counts the run end reports, and a
    closed key's executable raises."""
    _, _, head = heads
    service = port_serve.SlideService(_port_forward, head, config=_config(port_serve), out_dir=str(tmp_path),
                                      identity="tiny")
    for s in _slides(15, [3, 20]):
        service.submit(*s)
    service.drain()
    service.close()
    aot = service.aot
    assert aot.compiled_count == 2 and service.stats()["compiled_executables"] == 2
    assert aot.graphs == {} and aot._staging == {} and aot._pool is None
    ((_, f, c),) = _slides(16, [3])
    with pytest.raises(RuntimeError, match="closed"):
        aot(*port_buckets.assemble_batch([(f, c)], 16, capacity=3))


def test_concurrent_submitters_through_worker_thread(heads, tmp_path):
    from concurrent.futures import ThreadPoolExecutor

    _, _, head = heads
    slides = _slides(13, [1, 5, 9, 17, 20, 30, 12, 3])
    config = _config(port_serve, max_batch=2, bucket_max=32)
    with port_serve.SlideService(_port_forward, head, config=config, out_dir=str(tmp_path), identity="tiny") as service:
        with ThreadPoolExecutor(max_workers=4) as pool:
            futs = list(pool.map(lambda s: service.submit(*s), slides))
        results = [f.result(timeout=60) for f in futs]
        assert all(np.isfinite(r).all() for r in results)
        assert service.watchdog.unexpected_retraces == []
        assert service.aot.compiled_count == 2  # buckets {16, 32}
        assert service.slides_served == len(slides)
    for (sid, f, c), res in zip(slides, results):
        np.testing.assert_allclose(res, _exact_port(head, f, c), atol=1e-5, rtol=0, err_msg=sid)


def test_service_run_log_reads_as_the_jax_one(heads, tmp_path, monkeypatch):
    """The serving events carry the JAX schema's fields, so
    scripts/obs_report.py's serving fold reads the port's run log."""
    import glob
    import json

    monkeypatch.delenv("GIGAPATH_OBS", raising=False)
    _, _, head = heads
    service = port_serve.SlideService(_port_forward, head, config=_config(port_serve), out_dir=str(tmp_path),
                                      identity="tiny")
    for s in _slides(14, [3, 20]):
        service.submit(*s)
    service.drain()
    service.close()
    (path,) = glob.glob(str(tmp_path / "obs" / "*.jsonl"))
    events = [json.loads(line) for line in open(path)]
    kinds = [e["kind"] for e in events]
    assert kinds[0] == "run_start" and {"compile", "serve_dispatch", "span", "step", "metrics", "trace",
                                        "run_end"} <= set(kinds)
    dispatch = [e for e in events if e["kind"] == "serve_dispatch"]
    assert {d["bucket"] for d in dispatch} == {16, 32}
    assert set(dispatch[0]) == {"v", "run", "kind", "t", "bucket", "slides", "capacity", "occupancy",
                                "queue_wait_s", "wall_s", "source"}
    assert dispatch[0]["source"] == "eager"
    (end,) = [e for e in events if e["kind"] == "run_end"]
    assert end["compiled_executables"] == 2 and end["loaded_executables"] == 0 and end["dispatches"] == 2

    import io
    import os

    monkeypatch.syspath_prepend(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
    import obs_report

    buf = io.StringIO()
    assert obs_report.render(events, out=buf) == 0
    text = buf.getvalue()
    assert "== serving ==" in text and "per-bucket dispatch table" in text and "[eager]" in text


# ---------------------------------------------------------------------------
# the CLI's bucketed default path
# ---------------------------------------------------------------------------


def test_cli_bucketed_path_writes_the_exact_paths_verdicts(tmp_path, monkeypatch):
    from gigapath_tpu_torch import inference
    from gigapath_tpu_torch.models.classification_head import get_model

    rng = np.random.default_rng(15)
    lengths = [1, 5, 16, 17, 31, 70, 5]  # 70 is above the top rung: the exact path
    for i, n in enumerate(lengths):
        f = rng.normal(size=(n, 16)).astype(np.float32)
        c = rng.uniform(0, 25000, (n, 2)).astype(np.float32)
        if i == len(lengths) - 1:
            f, c = dup
        elif i == 1:
            dup = (f, c)
        torch.save({"features": torch.from_numpy(f), "coords": torch.from_numpy(c)}, tmp_path / f"s{i}_features.pt")
    for name, value in (("BUCKET_MIN", "16"), ("BUCKET_MAX", "64"), ("BUCKET_ALIGN", "16")):
        monkeypatch.setenv(f"GIGAPATH_SERVE_{name}", value)
    head = get_model(input_dim=16, latent_dim=32, feat_layer="1", n_classes=2, model_arch="gigapath_slide_enc_tiny",
                     device="cpu", seed=3).eval()
    bucketed = inference.run_inference(head, str(tmp_path), str(tmp_path / "b.csv"), batch_size=3)
    exact = inference.run_inference(head, str(tmp_path), str(tmp_path / "e.csv"), use_buckets=False)
    assert list(bucketed["slide_id"]) == list(exact["slide_id"]) == [f"s{i}" for i in range(len(lengths))]
    assert list(bucketed["predicted_label"]) == list(exact["predicted_label"])
    np.testing.assert_allclose(bucketed["confidence"], exact["confidence"], atol=1e-5, rtol=0)
    # --prefetch 2 (a loader thread through the dist boundary's memory
    # channel) gives the synchronous loads' verdicts, bit for bit
    prefetched = inference.run_inference(head, str(tmp_path), str(tmp_path / "p.csv"), batch_size=3, prefetch=2)
    assert prefetched.equals(bucketed)


@pytest.mark.parametrize("path", ["bucketed", "exact", "stream"])
def test_prefetch_gives_the_synchronous_verdicts(path, tmp_path, monkeypatch):
    """``prefetch=2`` against ``prefetch=0`` on each path of the CLI: the
    same slide order, labels and confidences, bit for bit, and the loader's
    channel on the run log."""
    import glob
    import json

    from gigapath_tpu_torch import inference
    from gigapath_tpu_torch.models.classification_head import get_model

    rng = np.random.default_rng(21)
    for i, n in enumerate([3, 12, 20, 7, 12]):
        torch.save({"features": torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32)),
                    "coords": torch.from_numpy(rng.uniform(0, 25000, (n, 2)).astype(np.float32))},
                   tmp_path / f"s{i}_features.pt")
    for name, value in (("BUCKET_MIN", "16"), ("BUCKET_MAX", "64"), ("BUCKET_ALIGN", "16")):
        monkeypatch.setenv(f"GIGAPATH_SERVE_{name}", value)
    head = get_model(input_dim=16, latent_dim=32, feat_layer="1", n_classes=2, model_arch="gigapath_slide_enc_tiny",
                     device="cpu", seed=4).eval()
    kw = {"bucketed": dict(batch_size=2), "exact": dict(use_buckets=False),
          "stream": dict(stream=True, stream_chunk=8)}[path]
    out = {}
    for prefetch in (0, 2):
        out_dir = tmp_path / f"out{prefetch}"
        out_dir.mkdir()
        out[prefetch] = inference.run_inference(head, str(tmp_path), str(out_dir / "p.csv"), prefetch=prefetch, **kw)
    assert list(out[2]["slide_id"]) == [f"s{i}" for i in range(5)]
    assert out[2].equals(out[0])
    events = [json.loads(line) for f in glob.glob(str(tmp_path / "out2" / "obs" / "*.jsonl")) for line in open(f)]
    start = next(e for e in events if e["kind"] == "run_start")
    assert start["config"]["prefetch"] == 2
    assert [e["status"] for e in events if e["kind"] == "run_end"] == ["ok"]


# ---------------------------------------------------------------------------
# the attention's capture path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("valid", [[45, 45, 45], [45, 30, 1]], ids=["equal_counts", "ragged"])
def test_per_row_valid_len_path_equals_the_eager_arm(valid):
    """Under per_row_valid_len (what a capture takes) the masked attention
    keeps the [B] counts on the device; on equal counts the eager arm turns
    them into one int. Both give the same output."""
    from gigapath_tpu_torch.ops import dilated_attention as da

    torch.manual_seed(0)
    attn = da.DilatedAttention(64, 4, segment_length=[16, 32, 64], dilated_ratio=[1, 2, 4], subln=True).eval()
    L = 64
    x = torch.randn(3, L, 64)
    pad = torch.arange(L)[None, :] >= torch.tensor(valid)[:, None]  # True = pad
    calls = []
    real = da.dilated_attention

    def spy(*a, **kw):
        calls.append(kw["valid_len"])
        return real(*a, **kw)

    da.dilated_attention = spy
    try:
        with torch.no_grad():
            eager = attn(x, x, x, key_padding_mask=pad)
            with da.per_row_valid_len():
                per_row = attn(x, x, x, key_padding_mask=pad)
    finally:
        da.dilated_attention = real
    assert isinstance(calls[1], torch.Tensor) and calls[1].tolist() == valid
    assert isinstance(calls[0], int) == (len(set(valid)) == 1)
    np.testing.assert_allclose(per_row.numpy(), eager.numpy(), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the graph cache's shared static inputs, and the launch counts it reads
# ---------------------------------------------------------------------------


def test_static_inputs_share_buffers_by_power_of_two_class():
    """Keys whose token counts round up to one power of two take views of
    the same buffers, so the inputs total under twice the largest key's;
    each view starts as an all-valid zero batch."""
    from gigapath_tpu_torch.serve.aot import AotExecutableCache

    cache = AotExecutableCache(lambda m, *a: a[0], torch.zeros(1), feature_dim=8)
    keys = [(4, 1024), (2, 2048), (3, 1000), (1, 1024), (16, 65536 // 16), (8, 8192)]
    views = {key: cache._static_inputs(*key) for key in keys}
    for (cap, n), (e, c, m) in views.items():
        assert e.shape == (cap, n, 8) and c.shape == (cap, n, 2) and m.shape == (cap, n)
        assert e.dtype == c.dtype == torch.float32 and m.dtype == torch.bool
        assert not e.any() and not c.any() and m.all()
    ptr = {key: views[key][0].data_ptr() for key in keys}
    assert ptr[(4, 1024)] == ptr[(2, 2048)] == ptr[(3, 1000)]  # 4096, 4096, 3000 -> 4096
    assert ptr[(16, 4096)] == ptr[(8, 8192)]  # 65536 each
    assert len({ptr[(1, 1024)], ptr[(4, 1024)], ptr[(16, 4096)]}) == 3
    assert sorted(cache._staging) == [1024, 4096, 65536]
    total = sum(buf.numel() * buf.element_size() for bufs in cache._staging.values() for buf in bufs)
    largest = max(cap * n for cap, n in keys) * (8 * 4 + 2 * 4 + 1)
    assert total < 2 * largest


def test_all_launch_counts_reads_every_kernel_module():
    from gigapath_tpu_torch import ops
    from gigapath_tpu_torch.ops import dilated_kernels, flash_kernels, streaming_kernels
    from gigapath_tpu_torch.quant import qflash, qmatmul

    mods = (dilated_kernels, flash_kernels, streaming_kernels, qmatmul, qflash)
    saved = [dict(mod.LAUNCHES) for mod in mods]
    try:
        for i, mod in enumerate(mods):
            for name in mod.LAUNCHES:
                mod.LAUNCHES[name] = i + 1
        counts = ops.all_launch_counts()
        for i, mod in enumerate(mods):
            assert set(mod.LAUNCHES) <= set(counts) and all(counts[k] == i + 1 for k in mod.LAUNCHES)
        assert len(counts) == sum(len(mod.LAUNCHES) for mod in mods)
        ops.reset_all_launch_counts()
        assert not any(ops.all_launch_counts().values())
    finally:
        for mod, old in zip(mods, saved):
            mod.LAUNCHES.update(old)
