"""YAML graph compiler + DetectionModel executor.

Counterpart of ``xlstm_yolo_tpu/nn/tasks.py`` (``yaml_model_load``,
``parse_model_specs``, ``build_module``, ``DetectionModel``,
``build_detection_model``, and the test-time augmentation helpers
``scale_img``, ``descale_pred``, ``clip_augmented`` and ``predict_augment``)
for the module set of the shipped ViL models (the detectors, and the
segment, pose, OBB and classify heads of ``vil-det-tiny-{seg,pose,obb}.yaml``
and ``vil-cls-tiny.yaml``).  The same
``[from, n, module, args]`` YAML DSL compiles to layer specs; the model
runs them with savelist routing.
"""

from __future__ import annotations

import ast
import math
from pathlib import Path
from typing import Any, Sequence

import torch
import yaml
from torch import nn

from xlstm_yolo_tpu_torch.nn import blocks as B
from xlstm_yolo_tpu_torch.nn import head as H
from xlstm_yolo_tpu_torch.nn.layers import reset_parameters, resolve_seqlens
from xlstm_yolo_tpu_torch.ops.backend import V2_KERNEL, get_mlstm_kernel
from xlstm_yolo_tpu_torch.utils.resize import resize
from xlstm_yolo_tpu_torch.utils.torch_utils import select_device

CFG_MODELS = Path(__file__).resolve().parents[1] / "cfg" / "models"
DEFAULT_CHUNKWISE_KERNEL = "auto"


def resolve_chunkwise_kernel(name: str) -> str:
    """``"auto"`` is the v2 kernels (``chunkwise--pallas_xl_chunk_siging_v2``)
    on every device; any other name is checked against the registry and
    kept.  The JAX package resolves ``"auto"`` by platform (v2 on a TPU,
    ``chunkwise--native_autograd`` elsewhere), a choice made for the TPU:
    the port never picks a kernel by device."""
    if name == "auto":
        return V2_KERNEL
    get_mlstm_kernel(name)
    return name


def yaml_model_load(path_or_dict) -> dict:
    """Load a model YAML (a path, or a dict passed through)."""
    if isinstance(path_or_dict, dict):
        return dict(path_or_dict)
    p = Path(path_or_dict)
    with open(p) as fh:
        d = yaml.safe_load(fh)
    d["yaml_file"] = str(p)
    return d


_HEADS = {"Detect", "v10Detect", "Segment", "Pose", "OBB"}
# heads that JAX builds without ``fused`` (its Proto and Classify): JAX's fused
# model of them cannot take its own folded variables, so the port refuses it
UNFUSABLE_HEADS = {"Segment", "Classify"}


def parse_model_specs(d: dict, ch: int = 3):
    """YAML dict -> (specs, savelist, per-layer channels).

    Each spec is a plain dict: layer index ``i``, source(s) ``f``,
    ``module`` name, resolved ``args``, ``kwargs``, input channels ``c1``
    and output channels ``c2``.  Heads also get ``ch`` and ``tokens`` (the
    token count of each input level, which fixes its nominal stride).
    """
    nc = d.get("nc", 80)
    ch_list = [ch]
    tok_list: list[int | None] = [None]
    specs, save = [], []
    for i, (f, n, m, args) in enumerate(list(d["backbone"]) + list(d["head"])):
        args = list(args)
        for j, a in enumerate(args):
            if isinstance(a, str):
                if a == "nc":
                    args[j] = nc
                else:
                    try:
                        args[j] = ast.literal_eval(a)
                    except (ValueError, SyntaxError):
                        pass
        name = m.replace("nn.", "")
        if n != 1:
            raise NotImplementedError(f"layer {i}: repeats (n={n}) are not ported yet")
        if isinstance(f, int):
            f = f if f == -1 or f >= 0 else i + f
        else:
            f = [j if j == -1 or j >= 0 else i + j for j in f]
        c1 = ch_list[f] if isinstance(f, int) else None
        kwargs: dict[str, Any] = {}
        tin = tok_list[f] if isinstance(f, int) else None
        tok = tin
        if name == "Conv":
            c2 = args[0]
            if tin is not None and args[2:3] and args[2] > 1:
                tok = tin // (args[2] * args[2])
        elif name == "VitPatchEmbedBlock":
            c1, c2 = args[0], args[1]
            res, patch = args[2], args[3]
            tok = (res[0] // patch[0]) * (res[1] // patch[1])
        elif name in {"VitPosEmbedBlock", "ViLBlockPairBlock", "ViLFusionBlock"}:
            c2 = args[1]
            if name == "VitPosEmbedBlock":
                tok = args[2][0] * args[2][1]
            else:
                sl = args[-1].get("seqlens")
                tok = sl[0] * sl[1] if sl else tin
        elif name == "PatchMerger":
            c2 = ch_list[f]
            kwargs["base_tokens_in"] = tin  # rescales its query grid at other sizes
            tok = args[1]
        elif name == "SequenceToImage":
            c2 = ch_list[f]
        elif name == "Upsample":
            c2 = ch_list[f]
            scale = args[1] if len(args) > 1 else 2
            tok = tin * scale * scale if tin is not None else None
        elif name == "Concat":
            c2 = sum(ch_list[x] for x in f)
            tok = tok_list[f[0]]
        elif name in _HEADS:
            kwargs["ch"] = tuple(ch_list[x] for x in f)
            kwargs["tokens"] = tuple(tok_list[x] for x in f)
            c2 = None
        elif name == "Classify":
            c2 = args[0]
        else:
            raise NotImplementedError(f"module {m!r} (layer {i}) is not ported yet")
        specs.append(dict(i=i, f=f, module=name, args=args, kwargs=kwargs, c1=c1, c2=c2))
        save.extend(x % i for x in ([f] if isinstance(f, int) else f) if x != -1)
        if i == 0:
            ch_list, tok_list = [], []
        ch_list.append(c2 if c2 is not None else (c1 or ch))
        tok_list.append(tok)
    return specs, sorted(set(save)), ch_list


def _vil_config(cfg: dict) -> dict:
    return dict(
        seqlens=tuple(cfg["seqlens"]),
        chunk_size=int(cfg.get("chunk_size", 256)),
        qkv_block_size=int(cfg.get("qkv_block_size", 16)),
        conv_kind=cfg.get("conv_kind", "2d"),
        drop_path=float(cfg.get("drop_path", 0.0)),
    )


def build_module(spec: dict, nc: int, compute_dtype, img_size: int,
                 decode_only: bool = False, chunkwise_kernel: str = V2_KERNEL,
                 fused: bool = False) -> nn.Module:
    """Instantiate the module of one layer spec (``fused``: the eval-only
    modules with folded BatchNorms, :mod:`xlstm_yolo_tpu_torch.utils.fuse`)."""
    name, args, kw = spec["module"], spec["args"], spec["kwargs"]
    cd = compute_dtype
    if name == "VitPatchEmbedBlock":
        c1, c2, _resolution, patch = args
        return B.VitPatchEmbedBlock(c1, c2, tuple(patch), compute_dtype=cd)
    if name == "VitPosEmbedBlock":
        _, c2, seqlens = args
        return B.VitPosEmbedBlock(c2, tuple(seqlens))
    if name == "ViLBlockPairBlock":
        _, c2, cfg = args
        return B.ViLBlockPairBlock(c2, **_vil_config(cfg), chunkwise_kernel=chunkwise_kernel,
                                   compute_dtype=cd)
    if name == "ViLFusionBlock":
        c1, c2, cfg = args
        cfg = dict(cfg)
        mlp_ratio = float(cfg.pop("mlp_ratio", 4.0))
        return B.ViLFusionBlock(c1, c2, mlp_ratio=mlp_ratio, **_vil_config(cfg),
                                chunkwise_kernel=chunkwise_kernel, compute_dtype=cd,
                                fused=fused)
    if name == "PatchMerger":
        dim, m_out = args
        return B.PatchMerger(dim, m_out, kw.get("base_tokens_in"))
    if name == "SequenceToImage":
        (seqlens,) = args
        return B.SequenceToImage(tuple(seqlens))
    if name == "Upsample":
        return B.Upsample(int(args[1]) if len(args) > 1 else 2)
    if name == "Concat":
        return B.Concat()
    if name == "Conv":
        # yaml args mirror Conv(c2, k, s, p, g, d, act)
        c2 = args[0]
        k = args[1] if len(args) > 1 else 1
        s = args[2] if len(args) > 2 else 1
        p = args[3] if len(args) > 3 else None
        g = args[4] if len(args) > 4 else 1
        d = args[5] if len(args) > 5 else 1
        act = "silu" if (len(args) < 7 or args[6] is True) else (
            args[6] if isinstance(args[6], str) else None)
        return B.ConvBNAct(spec["c1"], c2, k, s, p, g, d, act, compute_dtype=cd, fused=fused)
    if name == "Classify":
        return H.Classify(spec["c1"], c2=args[0] if args else nc,
                          k=args[1] if len(args) > 1 else 1, s=args[2] if len(args) > 2 else 1,
                          compute_dtype=cd)
    if name in _HEADS:
        strides = tuple(img_size / math.sqrt(t) for t in kw["tokens"])
        common = dict(nc=args[0] if args else nc, ch=kw["ch"], strides=strides,
                      img_size=img_size, compute_dtype=cd, fused=fused)
        if name == "Segment":
            return H.Segment(nm=args[1] if len(args) > 1 else 32,
                             npr=args[2] if len(args) > 2 else 256, **common)
        if name == "Pose":
            return H.Pose(kpt_shape=tuple(args[1]) if len(args) > 1 else (17, 3), **common)
        if name == "OBB":
            return H.OBB(ne=args[1] if len(args) > 1 else 1, **common)
        cls = H.v10Detect if name == "v10Detect" else H.Detect
        return cls(decode_only=decode_only, **common)
    raise NotImplementedError(f"no builder for module {name!r}")


def token_grids(specs: Sequence[dict], img_hw: tuple[int, int]) -> list[tuple]:
    """Each layer's output at input size ``img_hw``: ``("img", h, w)`` or
    ``("seq", S)``, or the ValueError a layer would raise at that size (a
    patch size that does not divide it, a grid that does not rescale
    integrally, a PatchMerger query grid that is not square), found before
    the model runs."""
    out: list[tuple] = []
    for spec in specs:
        f, name, args = spec["f"], spec["module"], spec["args"]
        prev = ("img", *img_hw) if not out else out[-1]
        src = prev if f == -1 else out[f] if isinstance(f, int) else None
        if name == "VitPatchEmbedBlock":
            (ph, pw), (_, h, w) = args[3], src
            if h % ph or w % pw:
                raise ValueError(f"input {h}x{w} not divisible by patch {(ph, pw)}")
            grid = ("img", h // ph, w // pw)
        elif name == "VitPosEmbedBlock":
            grid = ("seq", src[1] * src[2])
        elif name == "ViLBlockPairBlock":
            S = src[1] * src[2] if src[0] == "img" else src[1]
            resolve_seqlens(S, args[-1]["seqlens"])
            grid = ("seq", S)
        elif name == "PatchMerger":
            grid = ("seq", B.merged_tokens(src[1], args[1], spec["kwargs"]["base_tokens_in"]))
        elif name == "SequenceToImage":
            grid = ("img", *resolve_seqlens(src[1], args[0]))
        elif name == "ViLFusionBlock":
            resolve_seqlens(src[1] * src[2], args[-1]["seqlens"])
            grid = src
        elif name == "Upsample":
            scale = int(args[1]) if len(args) > 1 else 2
            grid = ("img", src[1] * scale, src[2] * scale)
        elif name == "Concat":
            grids = {out[-1] if j == -1 else out[j] for j in f}
            if len(grids) != 1:
                raise ValueError(f"layer {spec['i']} concatenates grids {sorted(grids)}")
            grid = grids.pop()
        elif name == "Conv":
            k = args[1] if len(args) > 1 else 1
            s = args[2] if len(args) > 2 else 1
            p = args[3] if len(args) > 3 and args[3] is not None else k // 2
            grid = ("img", *((n + 2 * p - k) // s + 1 for n in src[1:]))
        else:  # the head
            grid = ()
        out.append(grid)
    return out


class DetectionModel(nn.Module):
    """Graph executor over compiled layer specs (savelist routing).

    Input: NHWC float images in [0, 1], at the YAML's size or any size at
    which every layer's grid rescales (:func:`token_grids`, checked once per
    size before the first layer runs).  Output at inference:
    (decoded (B, max_det, 6) or, with ``decode_only``, (B, A, 4+nc);
    dict of the head's level maps); a task head's pair (``nn.head``).  In
    training (``train()``): the head's raw level maps, ``{"one2many": [...],
    "one2one": [...]}``, or a task head's training output.
    """

    def __init__(self, specs: Sequence[dict], save: Sequence[int], nc: int = 80,
                 compute_dtype: torch.dtype | None = None, img_size: int = 640,
                 decode_only: bool = False, chunkwise_kernel: str = V2_KERNEL,
                 fused: bool = False):
        super().__init__()
        self.specs, self.save, self.nc = list(specs), set(save), nc
        self.compute_dtype, self.img_size = compute_dtype, img_size
        self.model = nn.ModuleList(
            build_module(s, nc, compute_dtype, img_size, decode_only, chunkwise_kernel, fused)
            for s in self.specs)
        self._sizes_checked: set[tuple[int, int]] = set()

    def forward(self, x):
        img_hw = (x.shape[1], x.shape[2])
        if img_hw not in self._sizes_checked:
            token_grids(self.specs, img_hw)
            self._sizes_checked.add(img_hw)
        saved: dict[int, Any] = {}
        out = x
        for spec, layer in zip(self.specs, self.model):
            f = spec["f"]
            inp = (out if f == -1 else saved[f]) if isinstance(f, int) else [
                out if j == -1 else saved[j] for j in f]
            out = layer(inp, img_hw=img_hw) if spec["module"] in _HEADS else layer(inp)
            if spec["i"] in self.save:
                saved[spec["i"]] = out
        return out


def build_detection_model(cfg, ch: int = 3, nc: int | None = None,
                          compute_dtype: torch.dtype | None = None,
                          decode_only: bool = False, device: str | torch.device = "cuda",
                          generator: torch.Generator | None = None, training: bool = False,
                          chunkwise_kernel: str = DEFAULT_CHUNKWISE_KERNEL,
                          fused: bool = False, kpt_shape: Sequence[int] | None = None):
    """Compile a model YAML into a DetectionModel on ``device``, in eval
    mode, or in train mode with ``training``, initialised from
    ``generator`` (default: seed 0), its mLSTM cells on ``chunkwise_kernel``
    (:func:`resolve_chunkwise_kernel`).  The parameters do not depend on the
    kernel.  ``fused`` builds the eval-only model whose convs carry their
    folded BatchNorms, for the state dict of
    :func:`xlstm_yolo_tpu_torch.utils.fuse.fuse_state_dict` (training it
    raises; a Segment or Classify head raises a ValueError, see
    ``UNFUSABLE_HEADS``).  ``kpt_shape`` rewrites the Pose row's keypoint shape
    (from a dataset YAML, as JAX's).  Returns (model, resolved cfg dict)."""
    dev = select_device(device)
    p = Path(cfg) if not isinstance(cfg, dict) else None
    if p is not None and not p.exists() and (CFG_MODELS / p.name).exists():
        p = CFG_MODELS / p.name
    d = yaml_model_load(cfg if p is None else p)
    if nc is not None:
        d["nc"] = nc
    if kpt_shape is not None and "head" in d:
        d["head"] = [[*row[:3], [*row[3][:1], list(kpt_shape), *row[3][2:]]]
                     if row[2] == "Pose" else row for row in d["head"]]
    specs, save, _ = parse_model_specs(d, ch=ch)
    unfusable = sorted({s["module"] for s in specs} & UNFUSABLE_HEADS)
    if fused and unfusable:
        raise ValueError(f"fused=True: the {unfusable[0]} head is built without folded "
                         "BatchNorms (as in JAX, whose fused model of it cannot load its "
                         "own folded variables); use the unfused model")
    model = DetectionModel(specs, save, nc=d.get("nc", 80), compute_dtype=compute_dtype,
                           img_size=int(d.get("imgsz", 640)), decode_only=decode_only,
                           chunkwise_kernel=resolve_chunkwise_kernel(chunkwise_kernel),
                           fused=fused)
    reset_parameters(model, generator if generator is not None
                     else torch.Generator().manual_seed(0))
    return model.to(dev).train(training), d


_END2END_HEADS = {"v10Detect", "RTDETRDecoder"}


def scale_img(x: torch.Tensor, ratio: float, gs: int = 32, pad_value: float = 0.447):
    """An NHWC batch resized by ``ratio`` (``jax.image.resize`` bilinear,
    antialiased: ``utils.resize``) and padded with ``pad_value`` to a ``gs``
    multiple, as JAX's ``scale_img``."""
    if ratio == 1.0:
        return x
    b, h, w, c = x.shape
    sh, sw = int(h * ratio), int(w * ratio)
    y = resize(x, (b, sh, sw, c), "bilinear")
    ph, pw = math.ceil(h * ratio / gs) * gs, math.ceil(w * ratio / gs) * gs
    return nn.functional.pad(y, (0, 0, 0, pw - sw, 0, ph - sh), value=pad_value)


def descale_pred(p: torch.Tensor, flip: int | None, scale: float, img_hw: tuple[int, int]):
    """Undo a TTA pass's scale and flip (2: up-down, 3: left-right) on decoded
    (B, A, 4+nc) xywh predictions."""
    xy, wh, rest = p[..., :2] / scale, p[..., 2:4] / scale, p[..., 4:]
    if flip == 2:
        xy = torch.stack([xy[..., 0], img_hw[0] - xy[..., 1]], -1)
    elif flip == 3:
        xy = torch.stack([img_hw[1] - xy[..., 0], xy[..., 1]], -1)
    return torch.cat([xy, wh, rest], -1)


def clip_augmented(ys: list) -> list:
    """Drop the largest pass's P5 anchors and the smallest pass's P3 anchors
    (anchors run P3 -> P5; 3 levels, g = 1 + 4 + 16)."""
    g = 21
    y0, y2 = ys[0], ys[-1]
    ys[0] = y0[:, : y0.shape[1] - y0.shape[1] // g]
    ys[-1] = y2[:, (y2.shape[1] // g) * (g - 5):]
    return ys


def predict_augment(model: DetectionModel, x: torch.Tensor):
    """Test-time augmentation: scales (1, 0.83, 0.67), the middle pass
    flipped left-right, merged along the anchor axis -> (y, None).  A model
    with an end2end head (every shipped detector: ``v10Detect``) returns its
    plain forward, as JAX's ``predict_augment`` does."""
    if any(s["module"] in _END2END_HEADS for s in model.specs):
        return model(x)
    img_hw = (x.shape[1], x.shape[2])
    ys = []
    for scale, flip in ((1.0, None), (0.83, 3), (0.67, None)):
        xi = scale_img(torch.flip(x, dims=(2,)) if flip == 3 else x, scale)
        yi, _ = model(xi)
        ys.append(descale_pred(yi, flip, scale, img_hw))
    return torch.cat(clip_augmented(ys), dim=1), None
