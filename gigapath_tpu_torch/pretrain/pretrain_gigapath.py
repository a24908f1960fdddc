"""Two-stage pretraining driver (counterpart of
``gigapath_tpu/pretrain/pretrain_gigapath.py``).

- **Stage 1, a simplified-MAE tile pretrain** (:func:`pretrain_tile_encoder`):
  random pixel-position zero-masking (ratio 0.75), the ViT tile encoder, an
  MLP decoder reconstructing the full image, MSE over *all* pixels; AdamW
  with a cosine schedule; best and periodic checkpoints.
- **Stage 2, a contrastive slide pretrain** (:func:`pretrain_slide_encoder`):
  frozen tile-encoder features per slide, the mean-pool MLP
  :class:`SimpleSlideEncoder`, InfoNCE at temperature 0.07 on the
  self-similarity logits, one optimizer step per epoch over the stacked
  slide features.
- :func:`main` tiles the slides (skipping processed ones), runs stage 1,
  loads its best checkpoint's ``encoder.*`` into the tile encoder and runs
  stage 2.

Numerics follow flax's defaults, not torch's: ``gelu`` is the tanh
approximation, LayerNorm's eps is 1e-6, AdamW decays at 1e-4 (optax's
``adamw`` default), the tile encoder computes in its ``dtype`` (bf16 by
default, fp32 parameters) and the MAE decoder in fp32. The learning rate
of update ``t`` is set before it from
:func:`~gigapath_tpu_torch.finetune.utils.cosine_decay_schedule`. The mask
noise is drawn from a ``torch.Generator`` seeded with ``seed`` on the
device, and the tile order from ``numpy.random.default_rng(seed)``, as in
the JAX driver. The encoder passed in trains in place from its own weights
(a flax module carries none; the JAX driver draws them from its seed).

Each stage writes a run log under ``<output_dir>/obs/`` (fenced ``step``
spans, ``pretrain_tile.step_wall_s`` / ``pretrain_slide.step_wall_s``
histograms, compile events, heartbeats, ``run_end``); a failure runs
``fail_run`` with an emergency checkpoint. Checkpoints are
:mod:`~gigapath_tpu_torch.utils.checkpoint` files of
``{"params": state_dict, ...}`` whose keys are ``encoder.<timm names>`` and
``dec1``/``dec2``/``dec3`` (stage 1), ``fc1``/``fc2``/``fc3``/``norm``
(stage 2).
"""

from __future__ import annotations

import glob
import os
import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gigapath_tpu_torch.finetune.utils import cosine_decay_schedule, set_lr
from gigapath_tpu_torch.models.tile_encoder import VisionTransformer
from gigapath_tpu_torch.obs import (
    CompileWatchdog,
    Heartbeat,
    console,
    get_ledger,
    get_metrics,
    get_run_log,
    span,
)
from gigapath_tpu_torch.obs.runlog import fail_run
from gigapath_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from gigapath_tpu_torch.utils.device import resolve_device

Device = Optional[Union[str, torch.device]]


def masking_noise(generator: Optional[torch.Generator], batch: int, length: int,
                  device: Union[str, torch.device]) -> torch.Tensor:
    """U[0, 1) fp32 ``[batch, length]``: the draw that orders the pixel
    positions of :func:`random_masking`."""
    return torch.rand((batch, length), generator=generator, device=device)


def random_masking(generator: Optional[torch.Generator], imgs: torch.Tensor, mask_ratio: float, *,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zero a random ``mask_ratio`` of pixel positions per image ([B, H, W,
    C]): the ``int(H * W * (1 - mask_ratio))`` positions of lowest noise
    are kept, by the rank of each position in a stable sort of the noise
    (``noise`` [B, H * W] when given, else drawn from ``generator``)."""
    B, H, W, C = imgs.shape
    L = H * W
    len_keep = int(L * (1 - mask_ratio))
    if noise is None:
        noise = masking_noise(generator, B, L, imgs.device)
    ranks = torch.argsort(torch.argsort(noise, dim=1, stable=True), dim=1, stable=True)
    keep = ranks < len_keep
    return imgs * keep.reshape(B, H, W, 1).to(imgs.dtype)


def _init_linear(layer: nn.Linear, generator: torch.Generator) -> None:
    """Weight ~ N(0, 1/fan_in), zero bias."""
    layer.weight.normal_(0.0, layer.in_features**-0.5, generator=generator)
    layer.bias.zero_()


class MaskedAutoencoder(nn.Module):
    """Simplified MAE: the tile encoder and an MLP pixel decoder (fp32)."""

    def __init__(self, encoder: VisionTransformer, decoder_dim: int = 512, mask_ratio: float = 0.75):
        super().__init__()
        self.encoder = encoder
        self.mask_ratio = mask_ratio
        size = encoder.img_size
        self.dec1 = nn.Linear(encoder.embed_dim, decoder_dim)
        self.dec2 = nn.Linear(decoder_dim, decoder_dim)
        self.dec3 = nn.Linear(decoder_dim, 3 * size * size)

    def init_decoder(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for layer in (self.dec1, self.dec2, self.dec3):
                _init_linear(layer, generator)

    def forward(self, imgs: torch.Tensor, noise: Optional[torch.Tensor] = None):
        """``(loss, pred [B, S, S, 3])``; the images are masked by ``noise``
        (:func:`masking_noise`) when it is given."""
        masked = imgs if noise is None else random_masking(None, imgs, self.mask_ratio, noise=noise)
        latent = self.encoder(masked).float()
        h = F.gelu(self.dec1(latent), approximate="tanh")
        h = F.gelu(self.dec2(h), approximate="tanh")
        size = self.encoder.img_size
        pred = self.dec3(h).reshape(imgs.shape[0], size, size, 3)
        loss = torch.mean((pred.float() - imgs.float()) ** 2)
        return loss, pred


def make_adamw(params, lr: float) -> torch.optim.AdamW:
    """``optax.adamw(lr)`` with its defaults: betas (0.9, 0.999), eps 1e-8,
    weight decay 1e-4 scaled by the learning rate."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def mae_step(mae: MaskedAutoencoder, optimizer: torch.optim.Optimizer, imgs: torch.Tensor,
             noise: torch.Tensor, lr: float) -> torch.Tensor:
    """One stage-1 update at ``lr`` on ``imgs`` masked by ``noise``;
    returns the loss (on the device, detached)."""
    set_lr(optimizer, lr)
    loss, _ = mae(imgs, noise=noise)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


def _load_tile_batch(paths: Sequence[str], img_size: int) -> np.ndarray:
    from PIL import Image

    from gigapath_tpu_torch.data.transforms import preprocess_tile

    return np.stack([preprocess_tile(Image.open(p), crop_size=img_size) for p in paths])


def collect_image_paths(data_dir: str, extensions=(".png", ".jpg", ".jpeg")) -> List[str]:
    image_paths: List[str] = []
    for ext in extensions:
        image_paths.extend(glob.glob(os.path.join(data_dir, f"**/*{ext}"), recursive=True))
    return sorted(image_paths)


def _default_encoder(dev: torch.device, seed: int) -> VisionTransformer:
    """``gigapath_tile_enc`` in bf16 compute (fp32 parameters), no quant
    tier (it has no backward), random weights from ``seed``."""
    from gigapath_tpu_torch.models.tile_encoder import create_tile_encoder

    return create_tile_encoder("", "gigapath_tile_enc", device=dev, quant="", dtype=torch.bfloat16,
                               generator=torch.Generator(device=dev).manual_seed(seed))


def pretrain_tile_encoder(
    image_paths: Sequence[str],
    output_dir: str,
    *,
    encoder: Optional[VisionTransformer] = None,
    batch_size: int = 64,
    num_epochs: int = 100,
    learning_rate: float = 1e-4,
    mask_ratio: float = 0.75,
    checkpoint_every: int = 10,
    seed: int = 0,
    device: Device = None,
) -> str:
    """Stage 1 on ``device`` (``cuda`` unless the caller passes ``cpu``):
    trains ``encoder`` (default :func:`_default_encoder`) in place inside
    the MAE; returns the best-epoch checkpoint's path."""
    dev = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    encoder = (encoder or _default_encoder(dev, seed)).to(dev)
    with torch.device(dev):
        mae = MaskedAutoencoder(encoder, mask_ratio=mask_ratio)
    mae.init_decoder(torch.Generator(device=dev).manual_seed(seed))
    mae.train()

    steps_per_epoch = max(len(image_paths) // batch_size, 1)
    schedule = cosine_decay_schedule(learning_rate, num_epochs * steps_per_epoch)
    optimizer = make_adamw(mae.parameters(), learning_rate)
    mask_gen = torch.Generator(device=dev).manual_seed(seed)

    def step(imgs: torch.Tensor, noise: torch.Tensor, lr: float) -> torch.Tensor:
        return mae_step(mae, optimizer, imgs, noise, lr)

    runlog = get_run_log(
        "pretrain_tile", out_dir=output_dir,
        config={"batch_size": batch_size, "num_epochs": num_epochs,
                "learning_rate": learning_rate, "mask_ratio": mask_ratio,
                "n_images": len(image_paths), "seed": seed, "device": str(dev)},
    )
    ledger = get_ledger(runlog)
    watchdog = CompileWatchdog("pretrain_tile.step", runlog, ledger=ledger)
    instrumented_step = watchdog.wrap(step)
    metrics = get_metrics(runlog)
    step_walls = metrics.histogram("pretrain_tile.step_wall_s")
    order_rng = np.random.default_rng(seed)
    best_loss = float("inf")
    best_path = os.path.join(output_dir, "best_tile_encoder.pt")
    size = encoder.img_size
    try:
        with Heartbeat(runlog, name="pretrain_tile") as heartbeat:
            global_step = 0
            for epoch in range(num_epochs):
                order = order_rng.permutation(len(image_paths))
                epoch_loss, n_steps = 0.0, 0
                t_epoch = time.time()
                for start in range(0, steps_per_epoch * batch_size, batch_size):
                    idx = order[start : start + batch_size]
                    if len(idx) == 0:
                        break
                    imgs = torch.from_numpy(_load_tile_batch([image_paths[i] for i in idx], size)).to(dev)
                    noise = masking_noise(mask_gen, imgs.shape[0], size * size, dev)
                    with span("step", runlog, fence=True) as sp:
                        loss = instrumented_step(imgs, noise, schedule(global_step))
                        sp.fence(loss)
                    loss = float(loss)
                    epoch_loss += loss
                    n_steps += 1
                    runlog.step(global_step, wall_s=sp.dur_s, synced=True, epoch=epoch, loss=loss)
                    if sp.dur_s is not None:
                        step_walls.observe(sp.dur_s)
                    metrics.maybe_flush()
                    heartbeat.beat(global_step)
                    global_step += 1
                epoch_loss /= max(n_steps, 1)
                epoch_sec = time.time() - t_epoch
                runlog.echo(
                    "Epoch: {}, Loss: {:.6f}, Epoch time: {:.1f}s ({:.3f} sec/it)".format(
                        epoch, epoch_loss, epoch_sec, epoch_sec / max(n_steps, 1)
                    ),
                    step=max(global_step - 1, 0),
                )
                if epoch_loss < best_loss:
                    best_loss = epoch_loss
                    save_checkpoint(best_path, {"params": mae.state_dict(), "epoch": epoch, "loss": epoch_loss})
                if (epoch + 1) % checkpoint_every == 0:
                    save_checkpoint(os.path.join(output_dir, f"tile_encoder_epoch_{epoch + 1}.pt"),
                                    {"params": mae.state_dict(), "epoch": epoch})
    except Exception as e:
        emergency = os.path.join(output_dir, "emergency_tile_encoder.pt")
        fail_run(runlog, "pretrain_tile_encoder", e,
                 emergency=lambda: save_checkpoint(emergency, {"params": mae.state_dict()}) or emergency)
        raise
    runlog.echo(f"Pretraining done. Best loss: {best_loss:.6f}")
    runlog.run_end(
        status="ok", best_loss=best_loss,
        compile_seconds_total=watchdog.compile_seconds_total(),
        ledger_path=ledger.path,
    )
    return best_path


class SimpleSlideEncoder(nn.Module):
    """Mean-pool MLP slide-encoder stand-in: ONE ``norm`` applied after
    both hidden layers (tied parameters, as the reference declares a single
    norm and calls it twice)."""

    def __init__(self, in_dim: int = 1536, hidden_dim: int = 768, out_dim: int = 768):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim)
        self.fc3 = nn.Linear(hidden_dim, out_dim)
        self.norm = nn.LayerNorm(hidden_dim, eps=1e-6)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for layer in (self.fc1, self.fc2, self.fc3):
                _init_linear(layer, generator)
            self.norm.weight.fill_(1.0)
            self.norm.bias.zero_()

    def forward(self, x: torch.Tensor, coords=None) -> torch.Tensor:
        x = x.mean(dim=1)
        x = self.norm(F.gelu(self.fc1(x), approximate="tanh"))
        x = self.norm(F.gelu(self.fc2(x), approximate="tanh"))
        return self.fc3(x)


def contrastive_loss(features: torch.Tensor, temperature: float = 0.07) -> torch.Tensor:
    """InfoNCE on the self-similarity matrix; one sample gives the
    reference's 0.1 sentinel (with a zero gradient, as under JAX)."""
    if features.shape[0] <= 1:
        return features.sum() * 0.0 + 0.1
    features = features / torch.clamp(torch.linalg.norm(features, dim=1, keepdim=True), min=1e-8)
    sim = features @ features.T
    labels = torch.arange(features.shape[0], device=features.device)
    return F.cross_entropy(sim / temperature, labels)


@torch.inference_mode()
def extract_slide_features(tile_encoder: VisionTransformer, slide_dirs: Sequence[str],
                           batch_size: int = 64) -> List[np.ndarray]:
    """Frozen tile-encoder features [n_tiles, E] fp32 per slide directory,
    on the encoder's device; directories without tiles are skipped."""
    device = next(tile_encoder.parameters()).device
    all_feats = []
    for slide_dir in slide_dirs:
        image_paths = collect_image_paths(slide_dir)
        if not image_paths:
            continue
        feats = []
        for start in range(0, len(image_paths), batch_size):
            imgs = _load_tile_batch(image_paths[start : start + batch_size], tile_encoder.img_size)
            feats.append(tile_encoder(torch.from_numpy(imgs).to(device)).float().cpu().numpy())
        all_feats.append(np.concatenate(feats))
    return all_feats


def pretrain_slide_encoder(
    tile_encoder: VisionTransformer,
    image_dirs: Sequence[str],
    output_dir: str,
    *,
    num_epochs: int = 50,
    learning_rate: float = 1e-4,
    max_tiles: int = 256,
    seed: int = 0,
    device: Device = None,
) -> str:
    """Stage 2 on ``device``: contrastive training of a
    :class:`SimpleSlideEncoder` over the frozen ``tile_encoder``'s features
    (the first ``min(max_tiles, fewest tiles)`` of each slide), one
    optimizer step per epoch; returns the best checkpoint's path."""
    dev = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    slide_feats = extract_slide_features(tile_encoder, image_dirs)
    if not slide_feats:
        raise ValueError("no slides with tiles found")
    n = min(min(f.shape[0] for f in slide_feats), max_tiles)
    batch = torch.from_numpy(np.stack([f[:n] for f in slide_feats])).to(dev)  # [S, n, D]

    with torch.device(dev):
        model = SimpleSlideEncoder(in_dim=batch.shape[-1])
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    schedule = cosine_decay_schedule(learning_rate, num_epochs)
    optimizer = make_adamw(model.parameters(), learning_rate)

    def step(lr: float) -> torch.Tensor:
        set_lr(optimizer, lr)
        loss = contrastive_loss(model(batch))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    runlog = get_run_log(
        "pretrain_slide", out_dir=output_dir,
        config={"num_epochs": num_epochs, "learning_rate": learning_rate,
                "max_tiles": max_tiles, "n_slides": int(batch.shape[0]),
                "seed": seed, "device": str(dev)},
    )
    ledger = get_ledger(runlog)
    watchdog = CompileWatchdog("pretrain_slide.step", runlog, ledger=ledger)
    instrumented_step = watchdog.wrap(step)
    metrics = get_metrics(runlog)
    step_walls = metrics.histogram("pretrain_slide.step_wall_s")
    best_loss = float("inf")
    best_path = os.path.join(output_dir, "best_slide_encoder.pt")
    try:
        with Heartbeat(runlog, name="pretrain_slide") as heartbeat:
            for epoch in range(num_epochs):
                with span("step", runlog, fence=True) as sp:
                    loss = instrumented_step(schedule(epoch))
                    sp.fence(loss)
                loss = float(loss)
                runlog.step(epoch, wall_s=sp.dur_s, synced=True, loss=loss)
                if sp.dur_s is not None:
                    step_walls.observe(sp.dur_s)
                metrics.maybe_flush()
                heartbeat.beat(epoch)
                runlog.echo(f"Epoch: {epoch}, Contrastive loss: {loss:.6f}", step=epoch)
                if loss < best_loss:
                    best_loss = loss
                    save_checkpoint(best_path, {"params": model.state_dict(), "loss": loss})
    except Exception as e:
        emergency = os.path.join(output_dir, "emergency_slide_encoder.pt")
        fail_run(runlog, "pretrain_slide_encoder", e,
                 emergency=lambda: save_checkpoint(emergency, {"params": model.state_dict()}) or emergency)
        raise
    runlog.echo(f"Slide pretraining done. Best loss: {best_loss:.6f}")
    runlog.run_end(
        status="ok", best_loss=best_loss,
        compile_seconds_total=watchdog.compile_seconds_total(),
        ledger_path=ledger.path,
    )
    return best_path


def preprocess_slides(slide_files: Sequence[str], output_dir: str, tile_size: int = 256) -> List[str]:
    """Tile raw slides into ``<output_dir>/output/<slide>/``, skipping
    already-processed ones; returns the tile directories."""
    from gigapath_tpu_torch import pipeline

    slide_dirs = []
    for slide_file in slide_files:
        slide_id = os.path.basename(slide_file)
        out = os.path.join(output_dir, "output", slide_id)
        if os.path.isdir(out) and glob.glob(os.path.join(out, "*.png")):
            console(f"Skipping {slide_id} - already processed")
        else:
            pipeline.tile_one_slide(slide_file, output_dir, level=0, tile_size=tile_size)
        slide_dirs.append(out)
    return slide_dirs


def main(
    slide_files: Sequence[str],
    output_dir: str,
    *,
    encoder: Optional[VisionTransformer] = None,
    tile_size: int = 256,
    tile_epochs: int = 100,
    slide_epochs: int = 50,
    batch_size: int = 64,
    device: Device = None,
):
    """The two stages on ``device`` (``cuda`` unless the caller passes
    ``cpu``): tile, stage 1 under ``<output_dir>/tile_pretrain``, the best
    stage-1 checkpoint's ``encoder.*`` loaded into ``encoder``, stage 2
    under ``<output_dir>/slide_pretrain``. Returns both best checkpoints'
    paths."""
    dev = resolve_device(device)
    slide_dirs = preprocess_slides(slide_files, output_dir, tile_size)
    image_paths = [p for d in slide_dirs for p in collect_image_paths(d)]
    encoder = encoder or _default_encoder(dev, 0)
    best_tile = pretrain_tile_encoder(
        image_paths,
        os.path.join(output_dir, "tile_pretrain"),
        encoder=encoder,
        batch_size=batch_size,
        num_epochs=tile_epochs,
        device=dev,
    )
    tile_state = restore_checkpoint(best_tile)["params"]
    prefix = "encoder."
    encoder.load_state_dict({k[len(prefix):]: v for k, v in tile_state.items() if k.startswith(prefix)}, strict=True)
    del tile_state
    best_slide = pretrain_slide_encoder(
        encoder,
        slide_dirs,
        os.path.join(output_dir, "slide_pretrain"),
        num_epochs=slide_epochs,
        device=dev,
    )
    return best_tile, best_slide
