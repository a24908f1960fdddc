"""Chunk-granular ``LongNetViT`` forward, the model half of streaming
chunked prefill (counterpart of ``gigapath_tpu/models/streaming_encoder.py``).

:class:`StreamingEncoderSession` takes a slide as a stream of tile chunks
instead of a dense ``[B, L, D]`` array: each chunk is patch-embedded and
position-embedded when it arrives, and layer 0's q/k/v projections and
dilated-branch folds run during ingest; ``finalize()`` runs the remaining
layers chunk by chunk, through one
:class:`~gigapath_tpu_torch.ops.streaming_prefill.StreamingPrefillState` per
layer. The residual stream is a list of per-chunk blocks from ingest to
readout, and the readout (cls row, or the global-pool mean) folds across the
blocks by summation.

The layer math calls the model's own submodules (``self_attn_layer_norm``,
``self_attn.q_proj``/``k_proj``/``v_proj``/``inner_attn_ln``/``out_proj``,
``final_layer_norm``, ``ffn.fc1``/``act``/``ffn_layernorm``/``fc2``), so one
``state_dict`` serves the dense and the streaming path; dropout and
drop-path are left out, as in eval mode. :func:`check_streamable` refuses
the encoder features this math does not cover (multiway, MoE, xPos,
deepnorm, post-LN, relative-position bias, an embedding LayerNorm, an
output projection); every registry slide-encoder arch passes.

``feed`` takes chunks in any order: those ahead of the fold frontier are
held and folded when their predecessors arrive, so the fold sequence, and
the result bit for bit, depends on the slide's geometry alone.

Left out: the JAX session's run log and per-stage compile watchdogs (there
is no jit cache to watch; the compile-side obs is ``ROADMAP.md`` Queue A
item 8) and its fold-plan
resolution (the kernels fix their own tiles). Each session method runs
without autograd.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gigapath_tpu_torch.obs.runlog import env_number
from gigapath_tpu_torch.ops.pos_embed import pos_embed_for_coords
from gigapath_tpu_torch.ops.streaming_prefill import StreamingPrefillState, _to_host, chunk_bounds

DEFAULT_CHUNK_TILES = 2048


def prefill_chunk_tiles(default: int = DEFAULT_CHUNK_TILES) -> int:
    """``GIGAPATH_PREFILL_CHUNK``: tiles per streaming-prefill chunk, read
    when a session or submitter is built."""
    return int(env_number("GIGAPATH_PREFILL_CHUNK", default))


def encoder_config(model):
    """The ``EncoderConfig`` the model's dense encoder was built from (the
    one factory-built config: the two paths cannot read different
    hyperparameters)."""
    return model.encoder.args


def _field(cfg, name: str, default):
    extras = getattr(cfg, "extras", None) or {}
    return getattr(cfg, name, extras.get(name, default))


def check_streamable(cfg) -> None:
    """Raise NotImplementedError for encoder features the streaming layer
    math does not implement, so an unsupported config never gives
    near-miss numbers."""
    unsupported = []
    if _field(cfg, "multiway", False):
        unsupported.append("multiway")
    if _field(cfg, "moe_freq", 0):
        unsupported.append("moe")
    if _field(cfg, "model_group", None) is not None:
        unsupported.append("tensor_parallel")
    if _field(cfg, "xpos_rel_pos", False):
        unsupported.append("xpos_rel_pos")
    if _field(cfg, "deepnorm", False):
        unsupported.append("deepnorm")
    if not _field(cfg, "encoder_normalize_before", True):
        unsupported.append("post-LN")
    if _field(cfg, "rel_pos_buckets", 0) or _field(cfg, "max_rel_pos", 0):
        unsupported.append("relative_position_bias")
    if _field(cfg, "layernorm_embedding", False):
        unsupported.append("layernorm_embedding")
    if _field(cfg, "vocab_size", -1) > 0 and not _field(cfg, "no_output_layer", True):
        unsupported.append("output_projection")
    if unsupported:
        raise NotImplementedError(
            f"streaming prefill does not cover encoder features {unsupported}; "
            "use the dense path (the fallback and oracle)"
        )


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x)


class StreamingEncoderSession:
    """One slide's streaming ``LongNetViT`` forward.

    ``feed(idx, tile_embeds [c, in_chans], coords [c, 2])`` takes the chunks
    of the plan ``chunk_bounds(n_tiles, chunk_tiles)`` in any order;
    ``finalize()`` returns the same list of ``[1, embed_dim]`` outputs as
    ``model(x, coords, all_layer_embed=...)``. The cls token is its own
    one-row block at token 0, so no chunk is concatenated with anything.
    The session computes in the model's parameter dtype on its device.
    """

    def __init__(
        self,
        model,
        n_tiles: int,
        *,
        chunk_tiles: Optional[int] = None,
        all_layer_embed: bool = False,
    ):
        cfg = encoder_config(model)
        check_streamable(cfg)
        param = next(model.parameters())
        self.model = model
        self.device, self.dtype = param.device, param.dtype
        self.all_layer_embed = bool(all_layer_embed)
        self.n_tiles = int(n_tiles)
        self.chunk_tiles = int(chunk_tiles or prefill_chunk_tiles())
        self.tile_bounds = chunk_bounds(self.n_tiles, self.chunk_tiles)
        # token space: block 0 is the cls token; tile chunk i is token block
        # i+1, shifted by one position. Every tile block, the ragged final
        # chunk included, is padded to chunk_tiles rows, and valid_len masks
        # the padded suffix out of every branch's keys and of the readout:
        # the JAX package's block geometry, so both fold the same plan.
        self.token_bounds = ((0, 1),) + tuple(
            (1 + i * self.chunk_tiles, 1 + (i + 1) * self.chunk_tiles)
            for i in range(len(self.tile_bounds))
        )
        self.valid_tokens = 1 + self.n_tiles  # cls + the real tiles
        self.segment_lengths = [int(s) for s in cfg.segment_length]
        self.dilated_ratios = [int(r) for r in cfg.dilated_ratio]
        self.num_heads = int(cfg.encoder_attention_heads)
        self.head_dim = int(cfg.encoder_embed_dim) // self.num_heads
        self.depth = int(cfg.encoder_layers)
        self.folds = 0  # folds of the last finalize(), every layer
        self._h_blocks: List[Optional[torch.Tensor]] = [None] * len(self.token_bounds)
        self._layer0 = self._new_state()
        self._held: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._next_tile_chunk = 0
        # the cls token is resident from the start: fold it now
        with torch.no_grad():
            cls = self.model.cls_token.to(self.dtype).reshape(1, 1, -1)
            self._ingest_block(0, self.model.encoder.embed_scale * cls)

    # -- plumbing -------------------------------------------------------------

    def _new_state(self, n_blocks: Optional[int] = None,
                   valid: Optional[int] = None) -> StreamingPrefillState:
        """A fold state over the first ``n_blocks`` token blocks (all by
        default). ``total_len`` stays the full slide's, so the branches'
        ``g = min(sl, L)`` clamp is the final pass's."""
        return StreamingPrefillState(
            self.token_bounds[:n_blocks], self.segment_lengths, self.dilated_ratios,
            total_len=self.token_bounds[-1][1],
            valid_len=self.valid_tokens if valid is None else valid,
        )

    def _layer(self, depth: int):
        return self.model.encoder.layers[depth]

    def _qkv(self, layer, h: torch.Tensor):
        """Pre-LN and the q/k/v projections of one residual block ->
        ``[B, c, H, Dh]`` triples."""
        B, c, _ = h.shape
        xn = layer.self_attn_layer_norm(h)
        sa = layer.self_attn
        return tuple(
            proj(xn).view(B, c, self.num_heads, self.head_dim)
            for proj in (sa.q_proj, sa.k_proj, sa.v_proj)
        )

    def _post(self, layer, h: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        """Everything after the attention core for one block: sub-LN, out
        projection, residual, the FFN (fc1, fp32 activation, sub-LN, fc2),
        residual."""
        B, c, E = h.shape
        sa = layer.self_attn
        a = attn.to(h.dtype).reshape(B, c, E)
        if sa.inner_attn_ln is not None:
            a = sa.inner_attn_ln(a)
        h = h + sa.out_proj(a)
        ffn = layer.ffn
        f = ffn.fc1(layer.final_layer_norm(h))
        f = ffn.act(f.float()).to(f.dtype)
        if ffn.ffn_layernorm is not None:
            f = ffn.ffn_layernorm(f)
        return h + ffn.fc2(f)

    def _embed(self, embeds: np.ndarray, coords: np.ndarray) -> torch.Tensor:
        """[c, in_chans] + [c, 2] -> [1, c, E]: patch embed plus the
        positional embedding of the coords."""
        model = self.model
        x = torch.as_tensor(embeds, dtype=torch.float32, device=self.device)[None].to(self.dtype)
        x = model.patch_embed(x)
        c = torch.as_tensor(coords, dtype=torch.float32, device=self.device)[None]
        x = x + pos_embed_for_coords(model.embed_dim, c, model.tile_size, model.slide_ngrids).to(x.dtype)
        return model.encoder.embed_scale * x

    def _ingest_block(self, block_idx: int, h_blk: torch.Tensor) -> None:
        """Keep the residual block and fold it into layer 0, the part of
        the stack that runs during ingest."""
        self._h_blocks[block_idx] = h_blk
        self._layer0.ingest(block_idx, *self._qkv(self._layer(0), h_blk))

    # -- the public surface ---------------------------------------------------

    @property
    def n_chunks(self) -> int:
        return len(self.tile_bounds)

    @torch.no_grad()
    def feed(self, idx: int, tile_embeds, coords) -> int:
        """Deliver tile chunk ``idx`` (any order; a duplicate of a chunk
        already folded or held is dropped). Chunks ahead of the frontier
        are held until their predecessors arrive. Returns how many chunks
        are folded so far."""
        idx = int(idx)
        if not 0 <= idx < self.n_chunks:
            raise ValueError(f"chunk {idx} outside the plan of {self.n_chunks}")
        a, b = self.tile_bounds[idx]
        tile_embeds = _as_numpy(tile_embeds)
        if tile_embeds.shape[0] != b - a:
            raise ValueError(f"chunk {idx}: {tile_embeds.shape[0]} rows != tile range [{a}, {b})")
        if idx < self._next_tile_chunk or idx in self._held:
            return self._next_tile_chunk
        if coords is None:
            # no coords: zeros, one grid cell for every tile (the dense
            # path's fallback)
            coords = np.zeros((b - a, 2), np.float32)
        coords = _as_numpy(coords).astype(np.float32)
        if coords.shape[0] != b - a:
            raise ValueError(f"chunk {idx}: {coords.shape[0]} coord rows != tile range [{a}, {b})")
        pad = self.chunk_tiles - (b - a)
        if pad:  # the ragged final chunk: its padded rows are masked out
            tile_embeds = np.pad(tile_embeds, ((0, pad), (0, 0)))
            coords = np.pad(coords, ((0, pad), (0, 0)))
        self._held[idx] = (tile_embeds, coords)
        while self._next_tile_chunk in self._held:
            i = self._next_tile_chunk
            self._ingest_block(i + 1, self._embed(*self._held.pop(i)))
            self._next_tile_chunk += 1
        return self._next_tile_chunk

    def pending(self) -> List[int]:
        """Chunk indices not folded yet (missing or held)."""
        missing = [i for i in range(self._next_tile_chunk, self.n_chunks) if i not in self._held]
        return missing + sorted(self._held)

    def export_state(self) -> dict:
        """The session's recovery state as a string-keyed dict of host numpy
        arrays: the ingest frontier, the residual blocks (as fp32), the held
        raw chunks and layer 0's fold partials. Restored into a session
        built with the same (model, n_tiles, chunk_tiles), the remaining
        feeds run the same fold sequence and the result is bit-exact."""
        state: dict = {"next_tile_chunk": np.int64(self._next_tile_chunk)}
        for i, blk in enumerate(self._h_blocks):
            if blk is not None:
                state[f"h_{i}"] = _to_host(blk)
        for i, (embeds, coords) in self._held.items():
            state[f"held_{i}"] = {"embeds": np.array(embeds), "coords": np.array(coords)}
        state["layer0"] = self._layer0.export_state()
        return state

    def restore_state(self, state: dict) -> None:
        """Inverse of :meth:`export_state`, onto this session's device and
        dtype; what the constructor folded (the cls block) is replaced."""
        self._next_tile_chunk = int(state["next_tile_chunk"])
        self._h_blocks = [None] * len(self.token_bounds)
        self._held = {}
        for key, value in state.items():
            if key.startswith("h_"):
                self._h_blocks[int(key[2:])] = torch.as_tensor(value).to(self.device, self.dtype)
            elif key.startswith("held_"):
                self._held[int(key[len("held_"):])] = (
                    np.asarray(value["embeds"]), np.asarray(value["coords"], np.float32))
        self._layer0.restore_state(state["layer0"], device=self.device)

    def complete(self) -> bool:
        return self._next_tile_chunk == self.n_chunks

    def _run_layer(self, depth: int, h_blocks: List[torch.Tensor],
                   state: StreamingPrefillState) -> Tuple[List[torch.Tensor], int]:
        """One layer over the blocks: fold every block not yet in ``state``,
        fuse, then the post-attention math per block; returns the new blocks
        and the state's fold count."""
        layer = self._layer(depth)
        for i in range(state.next_index, len(h_blocks)):
            state.ingest(i, *self._qkv(layer, h_blocks[i]))
        attn_blocks = state.finalize()
        return [self._post(layer, h, a) for h, a in zip(h_blocks, attn_blocks)], state.folds

    def _readout(self, h_blocks: List[torch.Tensor]) -> torch.Tensor:
        """The cls row, or the global-pool mean over the real tiles (summed
        block by block in fp32), then the model's norm."""
        model = self.model
        if model.global_pool:
            total, count = 0.0, 0
            for i, blk in enumerate(h_blocks[1:]):
                a, b = self.tile_bounds[i]  # the padded rows are left out
                total = total + blk[:, : b - a].float().sum(dim=1)
                count += b - a
            return model.norm((total / max(count, 1)).to(self.dtype))
        return model.norm(h_blocks[0][:, 0])

    def _forward(self, h_blocks: List[torch.Tensor], layer0_blocks: List[torch.Tensor],
                 n_blocks: int, valid: int) -> Tuple[List[torch.Tensor], int]:
        """Layers 1.. over ``n_blocks`` token blocks after layer 0's output
        ``layer0_blocks``, then the readout; returns the embeddings and the
        folds of layers 1.."""
        states = [h_blocks] if self.all_layer_embed else []
        h_blocks = layer0_blocks
        if self.all_layer_embed:
            states.append(h_blocks)
        folds = 0
        for depth in range(1, self.depth):
            h_blocks, n = self._run_layer(depth, h_blocks, self._new_state(n_blocks, valid))
            folds += n
            if self.all_layer_embed:
                states.append(h_blocks)
        if not self.all_layer_embed:
            # encoder_out carries the encoder's final LN; the all-layer
            # list does not (the dense path's encoder_states)
            final_ln = self.model.encoder.layer_norm
            states = [[final_ln(b) if final_ln is not None else b for b in h_blocks]]
        return [self._readout(blocks) for blocks in states], folds

    @torch.no_grad()
    def finalize(self) -> List[torch.Tensor]:
        """Run the remaining layers chunk by chunk and read out: the same
        output list as the model's dense forward. Sets :attr:`folds` to the
        folds of every layer."""
        if not self.complete():
            raise RuntimeError(f"finalize with chunks still missing: {self.pending()}")
        h_blocks = list(self._h_blocks)
        layer0, folds0 = self._run_layer(0, h_blocks, self._layer0)
        embeds, folds = self._forward(h_blocks, layer0, len(h_blocks), self.valid_tokens)
        self.folds = folds0 + folds
        return embeds

    @torch.no_grad()
    def peek(self) -> List[torch.Tensor]:
        """Provisional embeddings from the chunks folded so far. Layer 0
        reads the live running partials (nothing recomputed or changed);
        layers 1.. run over the folded blocks with the valid horizon at the
        frontier. Same output list as :meth:`finalize`; with every chunk
        folded the two are bit-exact."""
        f = self._next_tile_chunk
        if f < 1:
            raise RuntimeError("peek before any tile chunk folded")
        n_blocks = 1 + f  # cls + the folded tile chunks
        valid = 1 + min(self.n_tiles, f * self.chunk_tiles)
        h_blocks = self._h_blocks[:n_blocks]
        layer = self._layer(0)
        layer0 = [self._post(layer, h, a) for h, a in zip(h_blocks, self._layer0.peek_blocks())]
        return self._forward(h_blocks, layer0, n_blocks, valid)[0]

    def lse_spread(self) -> float:
        """Layer 0's per-branch lse spread off the live partials;
        synchronises with the device."""
        return self._layer0.lse_spread()


def embeds_to_outputs(embeds: List[torch.Tensor]) -> Dict[str, np.ndarray]:
    """A session's per-layer embedding list -> the ``layer_{i}_embed`` /
    ``last_layer_embed`` dict of ``pipeline.run_inference_with_slide_encoder``
    (fp32 numpy)."""
    outputs = {f"layer_{i}_embed": e.float().cpu().numpy() for i, e in enumerate(embeds)}
    outputs["last_layer_embed"] = outputs[f"layer_{len(embeds) - 1}_embed"]
    return outputs


def streaming_forward(
    model,
    tile_embeds,
    coords,
    *,
    chunk_tiles: Optional[int] = None,
    all_layer_embed: bool = False,
) -> List[torch.Tensor]:
    """Dense-array convenience over the session: ``[N, in_chans]`` or
    ``[1, N, in_chans]`` tile embeddings with their coords -> the model's
    output list."""
    tile_embeds, coords = _as_numpy(tile_embeds), _as_numpy(coords)
    if tile_embeds.ndim == 3:
        if tile_embeds.shape[0] != 1:
            raise ValueError("streaming prefill folds B = 1 slides")
        tile_embeds, coords = tile_embeds[0], coords[0]
    session = StreamingEncoderSession(
        model, tile_embeds.shape[0], chunk_tiles=chunk_tiles, all_layer_embed=all_layer_embed,
    )
    for i, (a, b) in enumerate(session.tile_bounds):
        session.feed(i, tile_embeds[a:b], coords[a:b])
    return session.finalize()
