"""Per-bucket CUDA-graph cache: the port's counterpart of
``gigapath_tpu/serve/aot.py``.

The JAX package compiles one static-shape executable per ``(capacity,
bucket_n)`` key (and persists it). Here the same key gets one captured
``torch.cuda.CUDAGraph`` of the forward, so a dispatch is one graph replay
instead of the forward's hundreds of launches from the host:

1. **warm-up**: on the first use of a key, one eager forward at the padded
   shape under ``torch.inference_mode()`` on the cache's stream. It builds
   every kernel the forward launches (a kernel builds at its first launch)
   and resolves the dispatch plans, so nothing is built or loaded while
   the stream captures;
2. **capture**: the forward again, recorded into a graph whose inputs are
   static ``[capacity, bucket_n, D]`` fp32 / ``[capacity, bucket_n, 2]``
   fp32 / ``[capacity, bucket_n]`` bool tensors on the device. Both runs
   take the attention's per-row valid-length path whatever the mask's
   counts (:func:`~gigapath_tpu_torch.ops.dilated_attention.per_row_valid_len`):
   a count read on the host would bake the capture batch's lengths into
   the graph. A capture that fails raises; there is no eager fallback;
3. **replay**: each call copies the numpy batch into the static inputs on
   the cache's stream, replays the graph there, makes the caller's stream
   wait for it, and returns the graph's output tensors. They are
   overwritten by the next replay of any key: the caller copies them to
   the host first (the service's ``_tree_np``).

**Memory.** A graph keeps the memory it ran in for as long as it lives,
where an XLA executable holds its temporaries only while it runs. So every
key's warm-up and capture allocate from one pool that the cache owns
(``torch.cuda.MemPool``): a key's working set reuses the blocks the earlier
keys freed, and the pool grows to the largest key's, not to the sum over
keys. Sharing is safe because one stream runs every replay, so no two
overlap, and each output is read before the next replay. The static inputs
are shared the same way: keys whose token counts (``capacity * bucket_n``)
round up to the same power of two use views of one set of buffers (each
replay copies its batch in first), so they total under twice the largest
key's.

When the parameters are on the CPU, :meth:`executable` returns the eager
forward under ``inference_mode`` (the kernels' plain versions run there),
chosen by the device as every kernel wrapper chooses.

A graph cannot be serialised, so nothing is persisted: ``artifact_dir`` is
accepted for the JAX signature and names no file, every process captures
its own graphs, and :attr:`loaded_count` stays 0.

Observability: the :class:`~gigapath_tpu_torch.obs.watchdog.CompileWatchdog`
probes :meth:`_cache_size` (one per built key), so a capture on a key that
was already seen is an unexpected retrace; the perf ledger adopts each
capture (input signature, capture seconds, the bytes the shared pool grew
by for it, the launches recorded per kernel) with the profile of its
warm-up forward (op mix, cost, memory).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np


def _param_device(params: Any):
    """The device of ``params`` (a module's first parameter, or a tensor);
    the CPU when it holds none."""
    import torch

    if isinstance(params, torch.nn.Module):
        params = next(params.parameters(), None)
    return params.device if isinstance(params, torch.Tensor) else torch.device("cpu")


class AotExecutableCache:
    """Per-bucket executables for ``forward(params, embeds, coords,
    pad_mask)`` (``params`` a module; embeds ``[B, N, D]`` f32, coords
    ``[B, N, 2]`` f32, mask ``[B, N]`` bool, True = valid; tensors on the
    parameters' device),
    returning a tensor or a dict/list/tuple of tensors with a leading batch
    axis. An executable takes the numpy batch and returns the output."""

    def __init__(self, forward: Callable, params: Any, *,
                 feature_dim: int, artifact_dir: Optional[str] = None,
                 identity: str = "", name: str = "serve.forward",
                 runlog=None, watchdog=None, ledger=None):
        from gigapath_tpu_torch.obs.runlog import NullRunLog

        self.name = name
        self.params = params
        self.feature_dim = int(feature_dim)
        self.artifact_dir = artifact_dir
        self.identity = identity
        self.runlog = runlog if runlog is not None else NullRunLog()
        self.watchdog = watchdog
        self.ledger = ledger
        self._forward = forward
        self.device = _param_device(params)
        self._executables: Dict[Tuple[int, int], Callable] = {}
        # provenance per key: "captured" (a CUDA graph) | "eager" (the CPU)
        self.sources: Dict[Tuple[int, int], str] = {}
        self.compile_seconds: Dict[Tuple[int, int], float] = {}
        # per captured key: launches recorded per kernel, and the growth of
        # the device's reserved bytes across its warm-up and capture (what
        # the shared pool had to add for it)
        self.capture_launches: Dict[Tuple[int, int], Dict[str, int]] = {}
        self.pool_bytes: Dict[Tuple[int, int], int] = {}
        self.graphs: Dict[Tuple[int, int], Any] = {}  # the captured torch.cuda.CUDAGraph per key
        self._pool = None  # the torch.cuda.MemPool every warm-up and capture allocates from
        self._stream = None  # the stream every warm-up, capture and replay runs on
        self._staging: Dict[int, Tuple] = {}  # static input buffers per power-of-two token count
        if artifact_dir:
            self.runlog.echo(
                f"[serve] artifact_dir={artifact_dir!r}: CUDA graphs cannot be "
                "serialised, so nothing is persisted there (each process "
                "captures its own)"
            )
        if self.watchdog is not None:
            self.watchdog.attach(self)

    # -- watchdog cache-size surface (one per built key) -----------------
    def _cache_size(self) -> int:
        return len(self._executables)

    @property
    def compiled_count(self) -> int:
        return self._cache_size()

    @property
    def loaded_count(self) -> int:
        return 0

    # -- the executables ---------------------------------------------------
    def _eager(self) -> Callable:
        """The CPU executable: the eager forward under inference mode."""
        import torch

        def run(embeds, coords, mask):
            with torch.inference_mode():
                return self._forward(self.params, *(torch.from_numpy(a) for a in (embeds, coords, mask)))

        return run

    def _static_inputs(self, capacity: int, bucket_n: int) -> Tuple:
        """Views of the shared input buffers of ``capacity * bucket_n``
        tokens' power-of-two class (allocated at the class's first key),
        set to an all-valid zero batch."""
        import torch

        tokens = capacity * bucket_n
        size = 1 << (tokens - 1).bit_length()
        bufs = self._staging.get(size)
        if bufs is None:
            bufs = self._staging[size] = (
                torch.empty(size * self.feature_dim, dtype=torch.float32, device=self.device),
                torch.empty(size * 2, dtype=torch.float32, device=self.device),
                torch.empty(size, dtype=torch.bool, device=self.device),
            )
        embeds, coords, mask = bufs
        views = (embeds[: tokens * self.feature_dim].view(capacity, bucket_n, self.feature_dim),
                 coords[: tokens * 2].view(capacity, bucket_n, 2),
                 mask[:tokens].view(capacity, bucket_n))
        views[0].zero_()
        views[1].zero_()
        views[2].fill_(True)
        return views

    def _capture(self, capacity: int, bucket_n: int) -> Tuple[Callable, Tuple, Optional[dict]]:
        """Warm up and capture the forward for one key in the shared pool;
        returns the replay callable, the static inputs and the ledger's
        profile of the warm-up (None without a ledger)."""
        import torch

        from gigapath_tpu_torch.ops import all_launch_counts
        from gigapath_tpu_torch.ops.dilated_attention import per_row_valid_len

        dev = self.device
        with torch.cuda.device(dev):
            if self._pool is None:
                self._pool = torch.cuda.MemPool()
                self._stream = torch.cuda.Stream(dev)
            pool, stream = self._pool, self._stream
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                inputs = self._static_inputs(capacity, bucket_n)
            stream.synchronize()
            # what the shared pool adds for this key: the growth of the
            # reserved bytes once the default pool's cached blocks are freed
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            with torch.inference_mode(), per_row_valid_len():
                with torch.cuda.use_mem_pool(pool), torch.cuda.stream(stream):
                    # warm-up: builds and resolves; the ledger profiles it
                    # (op mix, cost, memory) for the key's entry
                    profile = None
                    if self.ledger is not None:
                        _, profile = self.ledger.run_profiled(self.name, self._forward, self.params, *inputs)
                    else:
                        self._forward(self.params, *inputs)
                stream.synchronize()
                before = all_launch_counts()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=pool.id, stream=stream, capture_error_mode="thread_local"):
                    outputs = self._forward(self.params, *inputs)
            after = all_launch_counts()
            key = (capacity, bucket_n)
            self.capture_launches[key] = {k: after[k] - before.get(k, 0) for k in after
                                          if after[k] != before.get(k, 0)}
            self.pool_bytes[key] = int(torch.cuda.memory_reserved(dev) - reserved)
            self.graphs[key] = graph

        def replay(embeds, coords, mask):
            caller = torch.cuda.current_stream(dev)
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                stream.wait_stream(caller)
                for static, host in zip(inputs, (embeds, coords, mask)):
                    static.copy_(torch.from_numpy(np.ascontiguousarray(host)))
                graph.replay()
            caller.wait_stream(stream)
            return outputs

        return replay, inputs, profile

    def executable(self, capacity: int, bucket_n: int) -> Callable:
        """The executable for ``[capacity, bucket_n, feature_dim]`` batches:
        in memory, else captured now (on the CPU: the eager forward)."""
        key = (int(capacity), int(bucket_n))
        exe = self._executables.get(key)
        if exe is not None:
            return exe
        t0 = time.time()
        if self.device.type == "cpu":
            exe, inputs, profile, source = self._eager(), None, None, "eager"
        else:
            exe, inputs, profile = self._capture(*key)
            source = "captured"
        seconds = time.time() - t0
        self._executables[key] = exe
        self.sources[key] = source
        self.compile_seconds[key] = seconds
        if self.watchdog is not None:
            # files the capture (and the kernel builds of its warm-up);
            # cache growth on a seen key would be an unexpected retrace
            self.watchdog.record(key, seconds)
        if self.ledger is not None and inputs is not None:
            self.ledger.adopt_compiled(
                self.name, key,
                {"capture_s": round(seconds, 6), "pool_bytes": self.pool_bytes[key],
                 "launches": self.capture_launches[key]},
                *inputs, profile=profile,
            )
        return exe

    def close(self) -> None:
        """Release every graph, its outputs, the static inputs and the
        shared pool now, so ``torch.cuda.empty_cache()`` can hand their
        memory back at once. The cache and its watchdog refer to each
        other, so without this the memory would wait for the garbage
        collector. The counts and provenance stay; a closed key's
        executable raises."""

        def closed(*_):
            raise RuntimeError(f"{self.name}: the graph cache is closed")

        self._executables = dict.fromkeys(self._executables, closed)
        self.graphs.clear()
        self._staging.clear()
        self._pool = self._stream = None

    def __call__(self, embeds, coords, mask):
        """Dispatch one assembled numpy batch; shapes pick the executable."""
        key = (int(embeds.shape[0]), int(embeds.shape[1]))
        known = key in self._executables
        exe = self.executable(*key)
        if self.watchdog is not None and known:
            self.watchdog.record(key, None)
        return exe(embeds, coords, mask)
