"""Disaggregated two-stage pipeline (counterpart of ``gigapath_tpu/dist``):
the fault-tolerant boundary between the tile-encoder fleet and the slide
encoder.

The production shape is two fleets at very different scales — a 1.13B-param
ViT-G tile encoder fanning out over 10^5-10^6 tiles per slide, streaming
embeddings into a LongNet slide encoder (PAPER.md §0) — joined by a
*boundary* that survives what a single program never sees: a dead tile
worker, a straggler, a dropped or duplicated chunk, a consumer that falls
behind or is killed.

- :mod:`gigapath_tpu_torch.dist.boundary` — the bounded, credit-based
  embedding channel between the stages: per-chunk sequence numbers and
  content checksums, a producer that blocks (and emits a ``backpressure``
  event) when consumer credits run out, acks, so unacked chunks are
  requeued on failure, and dedup of duplicates and out-of-order arrivals
  by seq;
- :mod:`gigapath_tpu_torch.dist.membership` — lease-based worker liveness
  (renew + expiry -> ``worker_lost``) and elastic degradation: a lost tile
  worker's unacked tile range is re-assigned across survivors through the
  same deterministic chunk plan, so the slide completes bit-equal to the
  clean run;
- :mod:`gigapath_tpu_torch.dist.stagemesh` — the per-stage sharding-rule
  registry (``match_partition_rules`` over ``state_dict`` names) and the
  stage placement (one device: ``module.to(device)``);
- :mod:`gigapath_tpu_torch.dist.transport` — the TCP transport:
  length-prefixed sha256-digested frames, reconnect with capped
  exponential backoff and full jitter, a handshake carrying the
  consumer's ack watermark, and the frame-layer chaos injectors; selected
  by ``GIGAPATH_DIST_TRANSPORT`` through ``make_producer`` /
  ``make_consumer``;
- :mod:`gigapath_tpu_torch.dist.worker` / :mod:`gigapath_tpu_torch.dist.pipeline`
  — the runnable harness: tile-worker *processes* (the numpy ``dryrun``
  encoder or the quantized ViT tile encoder on the card) and the slide
  consumer (dense or chunked prefill; its own SIGKILLable process when
  asked, with checkpointed fold state and bit-exact resume —
  ``GIGAPATH_DIST_CONSUMER_CKPT_EVERY``), chaos-injectable through the
  ``GIGAPATH_CHAOS`` ``kill_worker`` / ``kill_consumer`` / ``slow_worker`` /
  ``drop_chunk`` / ``dup_chunk`` injectors.

The protocol modules (boundary, membership, transport, the chunk plan) are
numpy and stdlib only: nothing in them can launch a kernel or change an
embedding's bits.
"""

from gigapath_tpu_torch.dist.boundary import (  # noqa: F401
    BoundaryConfig,
    DirChannelConsumer,
    DirChannelProducer,
    EmbeddingChunk,
    MemoryChannel,
    SlideAssembler,
    assign_chunks,
    chunk_checksum,
    plan_chunks,
)
from gigapath_tpu_torch.dist.membership import (  # noqa: F401
    Membership,
    WorkerLease,
    write_reassignment,
)
from gigapath_tpu_torch.dist.transport import (  # noqa: F401
    TcpChannelConsumer,
    TcpChannelProducer,
    make_consumer,
    make_producer,
    transport_name,
)
