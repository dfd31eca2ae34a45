"""Training recipes for the synthesis pipeline's learned estimators (port of
``spatialrgpt_tpu/synth/train_calibration.py``).

1. ``train_camera_net``: ``synth/calibration.py::CameraNet`` fit on
   virtual-camera warps of upright photos (``warp_virtual_camera``: each
   photo rendered through a camera rotated by a sampled (roll, pitch) with
   a sampled vfov, the sample being the label), with ``calib_loss``.
2. ``train_metric_depth``: the Depth-Anything metric head
   (``models/depth_anything.py`` with ``metric=True``) fine-tuned on an
   RGBD manifest toward canonical-camera targets (``canonicalize_depth``,
   the inverse of the serving wrapper's de-canonicalization) with the SiLog
   loss; ``freeze_backbone`` trains the DPT head alone.

The warp and batch streams are numpy, copied from the reference, so the same
seed gives the same arrays.  The optimizer is the reference's
``optax.adamw(warmup_cosine_decay_schedule(0, lr, warmup, max(steps, warmup
+ 1)), weight_decay)``: ``train/optimizer.py::AdamW`` with one group of every
parameter, no clipping, and that schedule.  Its decoupled weight decay
reaches every parameter, also those ``freeze_backbone`` stops: a frozen
parameter has no gradient, which counts as a zero gradient, so it shrinks by
lr * weight_decay * p each step, as the reference's stop-gradient leaves it.

``save_params`` / ``load_params`` read and write the reference's flat npz
keys (``layers/0/attn/wq/kernel``), so checkpoints carry across both ways.
The trainers and the CLI run on the card unless given a device.
"""

from __future__ import annotations

import json
import math
import os
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from spatialrgpt_tpu_torch.models import depth_anything as da
from spatialrgpt_tpu_torch.models.ram import IMAGENET_MEAN, IMAGENET_STD
from spatialrgpt_tpu_torch.synth import calibration as calib
from spatialrgpt_tpu_torch.train.optimizer import AdamW, OptimizerConfig
from spatialrgpt_tpu_torch.utils.device import card_device

# ---------------------------------------------------------------------------
# Virtual-camera warp (the self-supervision data path)
# ---------------------------------------------------------------------------


def _k_matrix(size: int, vfov_deg: float) -> np.ndarray:
    f = 0.5 * size / math.tan(math.radians(vfov_deg) / 2)
    c = (size - 1) / 2.0
    return np.array([[f, 0, c], [0, f, c], [0, 0, 1.0]])


def _rotation(roll_deg: float, pitch_deg: float) -> np.ndarray:
    r, p = math.radians(roll_deg), math.radians(pitch_deg)
    rz = np.array(
        [[math.cos(r), -math.sin(r), 0], [math.sin(r), math.cos(r), 0], [0, 0, 1.0]]
    )
    rx = np.array(
        [[1, 0, 0], [0, math.cos(p), -math.sin(p)], [0, math.sin(p), math.cos(p)]]
    )
    return rz @ rx  # roll about the optical axis, pitch about x


def warp_virtual_camera(
    image: np.ndarray,
    roll_deg: float,
    pitch_deg: float,
    src_vfov_deg: float,
    dst_vfov_deg: float,
    out_size: int,
) -> np.ndarray:
    """Render ``image`` (assumed upright, square, ``src_vfov_deg``) through a
    virtual camera rotated by (roll, pitch) with ``dst_vfov_deg``.

    Inverse bilinear warp through H = K_src @ R^-1 @ K_dst^-1 (edge clamp);
    pixels are float32 in the image's own range."""
    img = np.asarray(image, np.float32)
    s = img.shape[0]
    k_src = _k_matrix(s, src_vfov_deg)
    k_dst = _k_matrix(out_size, dst_vfov_deg)
    hmat = k_src @ _rotation(roll_deg, pitch_deg).T @ np.linalg.inv(k_dst)

    xs, ys = np.meshgrid(np.arange(out_size), np.arange(out_size))
    rays = np.stack([xs.ravel(), ys.ravel(), np.ones(out_size * out_size)])
    src = hmat @ rays
    u = src[0] / src[2]
    v = src[1] / src[2]
    u = np.clip(u, 0, s - 1)
    v = np.clip(v, 0, s - 1)
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    u1 = np.minimum(u0 + 1, s - 1)
    v1 = np.minimum(v0 + 1, s - 1)
    fu = (u - u0)[:, None]
    fv = (v - v0)[:, None]
    flat = img.reshape(s * s, -1)
    out = (
        flat[v0 * s + u0] * (1 - fu) * (1 - fv)
        + flat[v0 * s + u1] * fu * (1 - fv)
        + flat[v1 * s + u0] * (1 - fu) * fv
        + flat[v1 * s + u1] * fu * fv
    )
    return out.reshape(out_size, out_size, img.shape[2]).astype(np.float32)


def warp_batches(
    images: Sequence[np.ndarray],
    cfg: calib.CameraNetConfig,
    batch_size: int,
    seed: int = 0,
    src_vfov_deg: float = 70.0,
    roll_range: float = 25.0,
    pitch_range: float = 30.0,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless (pixels, targets) batches: pixels normalized to [-1, 1] like
    ``calibration._prep``; targets (roll_deg, pitch_deg, vfov_deg)."""
    rng = np.random.default_rng(seed)
    sq = []
    for im in images:
        im = np.asarray(im, np.float32)
        s = min(im.shape[:2])
        im = im[: s or 1, : s or 1]
        sq.append(im)
    lo = cfg.vfov_min_deg + 0.1 * (cfg.vfov_max_deg - cfg.vfov_min_deg)
    hi = min(src_vfov_deg - 5.0, cfg.vfov_max_deg)
    while True:
        px = np.empty((batch_size, cfg.image_size, cfg.image_size, 3), np.float32)
        tg = np.empty((batch_size, 3), np.float32)
        for i in range(batch_size):
            im = sq[int(rng.integers(len(sq)))]
            roll = float(rng.uniform(-roll_range, roll_range))
            pitch = float(rng.uniform(-pitch_range, pitch_range))
            vfov = float(rng.uniform(lo, hi))
            w = warp_virtual_camera(im, roll, pitch, src_vfov_deg, vfov, cfg.image_size)
            if w.max() > 1.5:  # uint8-range input
                w = w / 255.0
            px[i] = (w - 0.5) / 0.5
            tg[i] = (roll, pitch, vfov)
        yield px, tg


def _load_image_dir(image_dir: str) -> List[np.ndarray]:
    from PIL import Image

    paths = sorted(
        os.path.join(image_dir, f)
        for f in os.listdir(image_dir)
        if f.lower().endswith((".jpg", ".jpeg", ".png", ".webp"))
    )
    if not paths:
        raise ValueError(f"no images under {image_dir}")
    return [np.asarray(Image.open(p).convert("RGB"), np.float32) for p in paths]


# ---------------------------------------------------------------------------
# the optimizer: optax.adamw over warmup_cosine_decay_schedule
# ---------------------------------------------------------------------------


class _WarmupCosineAdamW(AdamW):
    """``AdamW`` over one group of every parameter, unclipped, at the
    reference's ``warmup_cosine_decay_schedule(0, lr, warmup, max(steps,
    warmup + 1))``: linear from 0 over ``warmup`` updates, then a cosine to
    0 at ``max(steps, warmup + 1)``."""

    def __init__(self, model: nn.Module, lr: float, weight_decay: float, warmup: int, steps: int):
        super().__init__([{"params": list(model.parameters()), "label": "all", "peak_lr": lr}],
                         OptimizerConfig(learning_rate=lr, weight_decay=weight_decay, max_grad_norm=math.inf))
        self.warmup, self.decay = warmup, max(steps, warmup + 1) - warmup

    def learning_rate(self, group, count: int) -> float:
        peak = group["peak_lr"]
        if count < self.warmup:
            return peak * count / self.warmup
        t = min(count - self.warmup, self.decay)
        return peak * 0.5 * (1 + math.cos(math.pi * t / self.decay))


def _fit(model: nn.Module, loss_of, batches, steps, lr, weight_decay, warmup, log_every) -> List[float]:
    """``steps`` updates of ``loss_of(batch)``; the loss of every
    ``log_every``-th step and of the last, as floats."""
    opt = _WarmupCosineAdamW(model, lr, weight_decay, warmup, steps)
    history: List[float] = []
    for i in range(steps):
        model.zero_grad(set_to_none=True)
        loss = loss_of(next(batches))
        loss.backward()
        opt.step()
        if i % log_every == 0 or i == steps - 1:
            history.append(float(loss.detach()))
    return history


# ---------------------------------------------------------------------------
# CameraNet trainer
# ---------------------------------------------------------------------------


def train_camera_net(
    images: Union[Sequence[np.ndarray], str],
    cfg: Optional[calib.CameraNetConfig] = None,
    steps: int = 20000,
    batch_size: int = 64,
    lr: float = 3e-4,
    weight_decay: float = 0.05,
    warmup: int = 500,
    seed: int = 0,
    ckpt_path: Optional[str] = None,
    log_every: int = 100,
    model: Optional[calib.CameraNet] = None,
    batches: Optional[Iterator] = None,
    device=None,
) -> Tuple[calib.CameraNet, List[float]]:
    """Fit CameraNet on virtual-camera warps of ``images`` (a directory path
    or in-memory arrays), in place on ``model`` (default: a random f32 one
    from ``seed`` on ``device``, the card unless given).  Returns (model,
    loss history)."""
    from spatialrgpt_tpu_torch.utils.weights import init_random_camera_net

    cfg = cfg or calib.CameraNetConfig()
    if batches is None:
        if isinstance(images, str):
            images = _load_image_dir(images)
        batches = warp_batches(images, cfg, batch_size, seed=seed)
    if model is None:
        model = init_random_camera_net(cfg, card_device(device, "train_camera_net"), torch.float32, seed)
    model.requires_grad_(True)
    dev = model.head.weight.device

    def loss_of(batch):
        px, tg = (torch.as_tensor(a, device=dev) for a in batch)
        return calib.calib_loss(model, cfg, px, tg)

    history = _fit(model, loss_of, batches, steps, lr, weight_decay, warmup, log_every)
    if ckpt_path:
        save_params(model, ckpt_path)
    return model, history


# ---------------------------------------------------------------------------
# Metric-depth head trainer (canonical-camera SiLog)
# ---------------------------------------------------------------------------


def silog_loss(pred: torch.Tensor, target: torch.Tensor, valid: torch.Tensor, lam: float = 0.5) -> torch.Tensor:
    """Scale-invariant log loss (Eigen et al.; Metric3D lambda=0.5) over
    valid (target > 0) pixels."""
    d = (torch.log(pred.clamp(min=1e-6)) - torch.log(target.clamp(min=1e-6))) * valid
    n = valid.sum().clamp(min=1.0)
    return torch.sqrt((d * d * valid).mean() * (d.numel() / n) - lam * (d.sum() / n) ** 2)


def canonicalize_depth(
    depth_m: np.ndarray, fx: float, model_size: int, canonical_focal: float = 1000.0
) -> np.ndarray:
    """Map metric GT into the canonical camera the network predicts in —
    the inverse of make_metric_depth_model's de-canonicalization."""
    h, w = depth_m.shape[:2]
    scale = model_size / max(h, w)
    return depth_m * canonical_focal / (fx * scale)


def rgbd_batches(
    manifest_path: str,
    cfg,
    batch_size: int,
    canonical_focal: float = 1000.0,
    seed: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(pixels, canonical_target, valid) batches from a JSONL manifest of
    {"image": path, "depth": .npy path (meters), "fx": focal px}.  Images
    keep-ratio resize + center-pad to the model square exactly like the
    serving wrapper; invalid/missing depth pixels get valid=0."""
    from PIL import Image

    entries = [json.loads(l) for l in open(manifest_path) if l.strip()]  # noqa: E741
    if not entries:
        raise ValueError(f"empty manifest {manifest_path}")
    rng = np.random.default_rng(seed)
    S = cfg.image_size
    while True:
        px = np.zeros((batch_size, S, S, 3), np.float32)
        tg = np.zeros((batch_size, S, S), np.float32)
        va = np.zeros((batch_size, S, S), np.float32)
        for i in range(batch_size):
            e = entries[int(rng.integers(len(entries)))]
            img = np.asarray(Image.open(e["image"]).convert("RGB"), np.float32)
            dep = np.load(e["depth"]).astype(np.float32)
            h, w = img.shape[:2]
            scale = S / max(h, w)
            nh, nw = max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)
            rimg = np.asarray(Image.fromarray(img.astype(np.uint8)).resize((nw, nh), Image.BILINEAR), np.float32)
            rdep = np.asarray(Image.fromarray(dep).resize((nw, nh), Image.NEAREST), np.float32)
            pt, plft = (S - nh) // 2, (S - nw) // 2
            px[i, pt : pt + nh, plft : plft + nw] = (rimg / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
            canon = canonicalize_depth(rdep, float(e["fx"]), S, canonical_focal)
            tg[i, pt : pt + nh, plft : plft + nw] = canon
            va[i, pt : pt + nh, plft : plft + nw] = (rdep > 0).astype(np.float32)
        yield px, tg, va


def train_metric_depth(
    manifest_or_batches,
    cfg: da.DepthAnythingConfig,
    model: Optional[da.DepthAnythingModel] = None,
    steps: int = 10000,
    batch_size: int = 8,
    lr: float = 5e-5,
    weight_decay: float = 0.01,
    warmup: int = 200,
    seed: int = 0,
    canonical_focal: float = 1000.0,
    ckpt_path: Optional[str] = None,
    log_every: int = 50,
    freeze_backbone: bool = False,
    device=None,
) -> Tuple[da.DepthAnythingModel, List[float]]:
    """Fine-tune the Depth-Anything metric head (``cfg.metric``) toward
    canonical-camera GT with SiLog, in place on ``model`` (default: a
    random f32 one from ``seed`` on ``device``, the card unless given).
    ``freeze_backbone`` trains the DPT head only (the reference keeps the
    gradients of its ``head`` entry alone: the backbone and the neck are
    stopped), and the weight decay still shrinks what it stops.

    The reference's ``init_params`` tree carries a zero bias on the neck's
    convs, which the HF layout (this model's) lacks, and its trainer trains
    it: each neck conv without one gets a zero bias parameter first, in
    place, so the same parameters train."""
    from spatialrgpt_tpu_torch.utils.weights import init_random_depth_anything

    if isinstance(manifest_or_batches, str):
        batches = rgbd_batches(manifest_or_batches, cfg, batch_size, canonical_focal, seed)
    else:
        batches = manifest_or_batches
    if model is None:
        model = init_random_depth_anything(cfg, card_device(device, "train_metric_depth"), torch.float32, seed)
    for conv in model.neck.convs:
        if conv.bias is None:
            w = conv.weight
            conv.bias = nn.Parameter(torch.zeros(w.shape[0], dtype=w.dtype, device=w.device))
    model.requires_grad_(True)
    if freeze_backbone:
        model.backbone.requires_grad_(False)
        model.neck.requires_grad_(False)
    dev = model.head.conv3.weight.device

    def loss_of(batch):
        px, tg, va = (torch.as_tensor(a, device=dev) for a in batch)
        return silog_loss(da.forward_depth(model, px, cfg), tg, va)

    history = _fit(model, loss_of, batches, steps, lr, weight_decay, warmup, log_every)
    if ckpt_path:
        save_params(model, ckpt_path)
    return model, history


# ---------------------------------------------------------------------------
# Checkpoint helpers: the reference's flat npz keys
# ---------------------------------------------------------------------------


def _reference_tree(model: nn.Module) -> dict:
    from spatialrgpt_tpu_torch.utils import weights

    if isinstance(model, calib.CameraNet):
        return weights.camera_net_tree(model)
    if isinstance(model, da.DepthAnythingModel):
        return weights.depth_anything_tree(model, model.cfg)
    raise TypeError(f"save_params: no reference layout for {type(model).__name__}")


def _flatten(tree, prefix: str = "") -> dict:
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for key, v in items:
        name = f"{prefix}{key}"
        out.update(_flatten(v, name + "/") if isinstance(v, (dict, list)) else {name: np.asarray(v)})
    return out


def _unflatten(flat: dict):
    """Flat "a/0/b" keys -> nested dicts, a dict of keys 0..n-1 a list."""
    root: dict = {}
    for key, v in flat.items():
        node = root
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(root)


def save_params(model: nn.Module, path: str) -> None:
    """A CameraNet's or a Depth-Anything's weights as the reference's flat
    npz (f32, its ``init_params`` tree's keys joined by "/")."""
    np.savez(path, **_flatten(_reference_tree(model)))


@torch.no_grad()
def load_params(path: str, model: nn.Module) -> nn.Module:
    """Load an npz saved by ``save_params`` (this package's or the
    reference's) into ``model``, in place, keeping its dtype and device."""
    from spatialrgpt_tpu_torch.utils import weights

    with np.load(path) as data:
        tree = _unflatten({k: data[k] for k in data.files})
    if isinstance(model, calib.CameraNet):
        sd = {}
        weights._export_tree(sd, tree, "")
    elif isinstance(model, da.DepthAnythingModel):
        # a neck bias (the reference's init tree's, or one train_metric_depth
        # added) goes to a model that holds one; the HF layout has none
        biases = [c.pop("bias", None) for c in tree["neck_convs"]]
        sd = weights.export_depth_anything(tree, model.cfg)
        for i, (conv, b) in enumerate(zip(model.neck.convs, biases)):
            if conv.bias is not None:
                sd[f"neck.convs.{i}.bias"] = np.zeros(conv.weight.shape[0], np.float32) if b is None else b
            elif b is not None and np.any(b != 0):
                raise ValueError(f"{path}: neck conv {i} has a bias and the model's has none")
    else:
        raise TypeError(f"load_params: no reference layout for {type(model).__name__}")
    own = model.state_dict()
    if sorted(sd) != sorted(own):
        raise ValueError(f"{path}: its keys do not match {type(model).__name__}'s")
    for name, t in own.items():
        t.copy_(torch.from_numpy(np.asarray(sd[name], np.float32)))
    return model


def main(argv=None) -> List[float]:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="the card unless given (e.g. cpu)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("camera", help="fit CameraNet on an image folder")
    c.add_argument("image_dir")
    c.add_argument("--steps", type=int, default=20000)
    c.add_argument("--batch", type=int, default=64)
    c.add_argument("--lr", type=float, default=3e-4)
    c.add_argument("--out", default="camera_net.npz")
    d = sub.add_parser("depth", help="fine-tune the metric-depth head")
    d.add_argument("manifest")
    d.add_argument("--steps", type=int, default=10000)
    d.add_argument("--batch", type=int, default=8)
    d.add_argument("--lr", type=float, default=5e-5)
    d.add_argument("--freeze-backbone", action="store_true")
    d.add_argument("--out", default="metric_depth.npz")
    args = ap.parse_args(argv)
    device = card_device(args.device, "train_calibration")
    if args.cmd == "camera":
        _, hist = train_camera_net(
            args.image_dir, steps=args.steps, batch_size=args.batch, lr=args.lr, ckpt_path=args.out, device=device,
        )
    else:
        _, hist = train_metric_depth(
            args.manifest, da.DepthAnythingConfig(metric=True), steps=args.steps, batch_size=args.batch, lr=args.lr,
            ckpt_path=args.out, freeze_backbone=args.freeze_backbone, device=device,
        )
    print(f"final loss {hist[-1]:.4f} (from {hist[0]:.4f})")
    return hist


if __name__ == "__main__":
    main()
